"""The port's sharded device decode on the CPU over gloo: the counterpart of
tests/test_sharded_decode.py, on its 13-word world and 8 utterances.

One group of 4 ranks runs every case once (the module fixture): the
"data" axis of mesh (4, 1) (D = 4) and of mesh (2, 2) (D = 2, two data
groups side by side). ``sharded_decode_batch`` must equal the port's
``decode_batch`` bit for bit, and the JAX package's sharded decode on
conftest's 8 virtual devices within the searchers' 1e-4 with the same
n-best sentences. JAX is imported inside the fixtures only."""

import numpy as np
import pytest

from b2txt_tpu_torch.data.synthetic import ctc_logprobs
from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.parallel import make_mesh, spawn
from b2txt_tpu_torch.utils.config import DecodeConfig

LEX = {
    "the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
    "mat": ["M", "AE", "T"], "on": ["AA", "N"], "dog": ["D", "AO", "G"],
    "a": ["AH"], "and": ["AE", "N", "D"], "saw": ["S", "AO"],
    "their": ["DH", "EH", "R"], "there": ["DH", "EH", "R"],
    "rug": ["R", "AH", "G"], "is": ["IH", "Z"],
}
CORPUS = [
    "the cat sat on the mat".split(),
    "the dog sat on the rug".split(),
    "a cat and a dog is there".split(),
    "the cat saw their dog".split(),
    "there is a dog on the mat".split(),
] * 3
SENTS = [
    "the cat sat on the mat", "there is a dog on the mat",
    "the cat saw their dog", "a cat and a dog is there",
    "the dog sat on the rug", "the cat sat on the rug",
    "there is a dog", "a dog saw the cat",
]
KNOBS = dict(acoustic_scale=0.325, blank_penalty=9.0, nbest=10, beam_width=48,
             first_beam_size=8, sum_mode=False)
WORLD = 4
SPAWN_DEADLINE_S = 120


def _utterances():
    """tests/test_sharded_decode.py:44-63's 8 utterances, padded."""
    lexicon = Lexicon.from_words(LEX)
    rng = np.random.default_rng(3)
    utts = [ctc_logprobs(rng, lexicon.sentence_to_phonemes(s), hot=10.0, noise=0.3)
            for s in SENTS]
    T = max(lp.shape[0] for lp in utts)
    arr = np.full((len(utts), T, 41), -20.0, np.float32)
    lens = np.zeros(len(utts), np.int32)
    for i, lp in enumerate(utts):
        arr[i, : lp.shape[0]] = lp
        lens[i] = lp.shape[0]
    return arr, lens


def _nbest(results):
    return [[(x.sentence, x.ac_score, x.lm_score) for x in r] for r in results]


def _searcher(case: str) -> DeviceLexiconBeamSearch:
    """The max-mode searcher, or it in sum mode, or with the pool rescore
    of an unpruned 4-gram attached."""
    knobs = {"sum_mode": True} if case == "sum_mode" else {}
    return DeviceLexiconBeamSearch(
        Lexicon.from_words(LEX), train_ngram(CORPUS, order=3),
        DecodeConfig(**{**KNOBS, **knobs}), device="cpu",
        rescore_lm=train_ngram(CORPUS, order=4) if case == "rescore" else None)


CASES = [("max", 4), ("max", 2), ("sum_mode", 4), ("rescore", 4)]


def _rank_cases(arr, lens):
    out = {}
    for name, D in CASES:
        mesh = make_mesh(WORLD, model_parallel=WORLD // D)
        dev = _searcher(name)
        got = dev.sharded_decode_batch(arr, lens, mesh=mesh, axis="data")
        out[(name, D)] = {"sharded": _nbest(got),
                          "block_rows": dev.sharded_lm.table[0].shape[0],
                          "n_buckets": dev.dev_lm.table[0].shape[0]}
        if (name, D) == ("max", 4):
            try:
                dev.sharded_decode_batch(arr[:6], lens[:6], mesh=mesh, axis="data")
                out["uneven"] = None
            except ValueError as e:
                out["uneven"] = str(e)
    return out


@pytest.fixture(scope="module")
def utterances():
    return _utterances()


@pytest.fixture(scope="module")
def ranks(utterances):
    return spawn(_rank_cases, WORLD, args=utterances, timeout_s=SPAWN_DEADLINE_S)


@pytest.fixture(scope="module")
def single(utterances):
    """The port's decode_batch in one process, per searcher."""
    return {name: _nbest(_searcher(name).decode_batch(*utterances))
            for name in ("max", "sum_mode", "rescore")}


@pytest.fixture(scope="module")
def jax_sharded(utterances):
    """The JAX package's sharded decode on the 8-device mesh, merging and
    windowing its beams as the host searchers do (tests/torch_host_merge.py)."""
    import jax
    from jax.sharding import Mesh

    from b2txt_tpu.decode.lmbeam_jax import DeviceLexiconBeamSearch as JaxSearch
    from b2txt_tpu.lm import Lexicon as JaxLexicon
    from b2txt_tpu.lm import train_ngram as jax_train_ngram
    from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig

    from torch_host_merge import host_semantics

    arr, lens = utterances
    dev = JaxSearch(JaxLexicon.from_words(LEX), jax_train_ngram(CORPUS, order=3),
                    JaxDecodeConfig(**KNOBS))
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    with host_semantics():
        return _nbest(dev.sharded_decode_batch(arr, lens, mesh=mesh, axis="data"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-D{c[1]}")
def test_sharded_equals_decode_batch_bit_for_bit(ranks, single, case):
    """Same n-best sentences, ac and lm scores equal, on every rank."""
    assert all(single[case[0]])
    for r in ranks:
        assert r[case]["sharded"] == single[case[0]]


def test_sharded_equals_jax_sharded_decode(ranks, jax_sharded):
    ours = ranks[0][("max", 4)]["sharded"]
    assert len(ours) == len(jax_sharded)
    for o, j in zip(ours, jax_sharded):
        assert [x[0] for x in o] == [x[0] for x in j]
        np.testing.assert_allclose([x[1] for x in o], [x[1] for x in j], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose([x[2] for x in o], [x[2] for x in j], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [4, 2])
def test_table_actually_shards(ranks, D):
    """Each rank decodes against n_buckets / D rows of the table."""
    for r in ranks:
        case = r[("max", D)]
        assert case["block_rows"] * D == case["n_buckets"]


def test_uneven_batch_rejected(ranks):
    for r in ranks:
        assert r["uneven"] is not None and "not divisible" in r["uneven"]
