"""The port's native C++ searcher (``b2txt_tpu_torch.runtime``): built from its
own copies of the sources into ``b2txt_tpu_torch/_build/``, it gives the JAX
package's native n-best exactly (same sources, same g++ flags), the port's
python searcher's sentences and scores (at tests/test_native_decoder.py's
tolerances), and the python n-gram trainer's ARPA."""

import math
import shutil

import numpy as np
import pytest

from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.runtime import NativeLexiconBeamSearch as JaxNative
from b2txt_tpu.runtime import train_ngram_native as jax_train_ngram_native
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch import runtime
from b2txt_tpu_torch.decode.lmbeam import LexiconBeamSearch
from b2txt_tpu_torch.lm import EOS, UNK, Lexicon, NGramLM, train_ngram
from b2txt_tpu_torch.runtime import NativeLexiconBeamSearch, train_ngram_native
from b2txt_tpu_torch.serve import DecoderService
from b2txt_tpu_torch.utils.config import DecodeConfig

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")

LEX = {
    "the": ["DH", "AH"],
    "cat": ["K", "AE", "T"],
    "sat": ["S", "AE", "T"],
    "mat": ["M", "AE", "T"],
    "on": ["AA", "N"],
    "their": ["DH", "EH", "R"],
    "there": ["DH", "EH", "R"],
    "is": ["IH", "Z"],
    "hat": ["HH", "AE", "T"],
}
CORPUS = [
    "the cat sat on the mat".split(),
    "there is the cat".split(),
    "the cat is there".split(),
    "there is the mat".split(),
    "the cat sat on the hat".split(),
] * 4
SENTS = ["the cat sat on the mat", "there is the cat", "the mat"]


def write_lexicon(path, lex):
    with open(path, "w") as f:
        for w, pron in lex.items():
            f.write(f"{w.upper()}  {' '.join(pron)}\n")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    lm = train_ngram(CORPUS, order=3)
    arpa = str(tmp / "lm.arpa")
    lm.to_arpa(arpa)
    lex_path = str(tmp / "lexicon.txt")
    write_lexicon(lex_path, LEX)
    return arpa, lex_path, Lexicon.from_words(LEX), lm


def clean_logprobs(ids, n_classes=41, frames_per=3, hot=8.0, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for pid in ids:
        for _ in range(frames_per):
            row = np.full(n_classes, -hot, np.float32)
            row[pid] = 0.0
            rows.append(row)
        blank = np.full(n_classes, -hot, np.float32)
        blank[0] = 0.0
        rows.append(blank)
    lp = np.stack(rows)
    if noise:
        lp = lp + noise * rng.standard_normal(lp.shape).astype(np.float32)
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def nbest(searcher, lp, chunk=0):
    searcher.reset()
    for i in range(0, lp.shape[0], chunk or lp.shape[0]):
        searcher.decode(lp[i : i + (chunk or lp.shape[0])])
    return [(r.sentence, r.ac_score, r.lm_score) for r in searcher.finish_decoding()]


def test_library_lands_in_the_port_build_dir(artifacts):
    arpa, lex_path, _, _ = artifacts
    s = NativeLexiconBeamSearch(arpa, lex_path)
    path = runtime.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "b2txt_tpu_torch"
    assert path.exists() and path.name.startswith("native_decoder-")
    assert s.lm_entries > 0


# (knobs, logits) cases: clean, noisy with a high blank penalty, blank
# skipping, Viterbi merge, chunked streaming, lattice n-best
NBEST_CASES = [
    ("clean", dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=64, beam=0.0),
     dict(), 0),
    ("noisy", dict(acoustic_scale=0.5, blank_penalty=30.0, nbest=5, beam_width=64, beam=0.0),
     dict(hot=2.5, noise=0.8, seed=3), 0),
    ("blank_skip", dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=3, beam_width=64,
                        ctc_blank_skip_threshold=0.9), dict(), 0),
    ("viterbi", dict(acoustic_scale=0.325, blank_penalty=9.0, nbest=10, beam_width=32,
                     first_beam_size=8, sum_mode=False), dict(hot=4.0, noise=0.6, seed=5), 0),
    ("chunked", dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=64),
     dict(hot=4.0, noise=0.4, seed=7), 6),
    ("lattice", dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=64,
                     sum_mode=False, lattice_nbest=True, lattice_beam=8.0),
     dict(hot=4.0, noise=0.6, seed=9), 0),
]


@pytest.mark.parametrize("sentence", SENTS)
@pytest.mark.parametrize("case", NBEST_CASES, ids=[c[0] for c in NBEST_CASES])
def test_native_nbest_equals_the_jax_packages_exactly(artifacts, case, sentence):
    """Same sources, same flags: every n-best row, sentence and scores, is
    the same float."""
    arpa, lex_path, lexicon, _ = artifacts
    _, knobs, lp_kw, chunk = case
    state_key = "ngram" if knobs.get("lattice_nbest") else "history"
    ours = NativeLexiconBeamSearch(arpa, lex_path, DecodeConfig(**knobs), state_key=state_key)
    theirs = JaxNative(arpa, lex_path, JaxDecodeConfig(**knobs), state_key=state_key)
    lp = clean_logprobs(lexicon.sentence_to_phonemes(sentence), **lp_kw)
    got = nbest(ours, lp, chunk)
    assert got and got == nbest(theirs, lp, chunk)


@pytest.mark.parametrize("sentence", SENTS)
def test_native_matches_python(artifacts, sentence):
    arpa, lex_path, lexicon, lm = artifacts
    cfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=64, beam=0.0)
    lp = clean_logprobs(lexicon.sentence_to_phonemes(sentence))
    host = LexiconBeamSearch(lexicon, lm, cfg)
    host.decode(lp)
    r_host = host.finish_decoding()
    native = NativeLexiconBeamSearch(arpa, lex_path, cfg)
    native.decode(lp)
    r_nat = native.finish_decoding()

    assert r_nat[0].sentence == r_host[0].sentence == sentence
    np.testing.assert_allclose(r_nat[0].ac_score, r_host[0].ac_score, rtol=1e-4)
    np.testing.assert_allclose(r_nat[0].lm_score, r_host[0].lm_score, rtol=1e-4)
    host_map = {r.sentence: r for r in r_host}
    for r in r_nat[:5]:
        assert r.sentence in host_map
        np.testing.assert_allclose(r.lm_score, host_map[r.sentence].lm_score,
                                   rtol=1e-3, atol=1e-3)


def test_native_streaming_partials(artifacts):
    arpa, lex_path, lexicon, _ = artifacts
    native = NativeLexiconBeamSearch(
        arpa, lex_path, DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=5,
                                     beam_width=64))
    native.reset()
    lp = clean_logprobs(lexicon.sentence_to_phonemes("the cat sat"))
    partials = []
    for i in range(0, lp.shape[0], 6):
        native.decode(lp[i : i + 6])
        res = native.result()
        if res:
            partials.append(res[0].sentence)
    assert partials[-1].startswith("the cat")
    assert native.finish_decoding()[0].sentence == "the cat sat"


def test_sum_mode_guard(artifacts):
    """The native searcher refuses sum_mode with ngram keying or lattice n-best."""
    arpa, lex_path, _, _ = artifacts
    with pytest.raises(ValueError, match="sum_mode"):
        NativeLexiconBeamSearch(arpa, lex_path, DecodeConfig(sum_mode=True), state_key="ngram")
    s = NativeLexiconBeamSearch(arpa, lex_path, DecodeConfig(sum_mode=True))
    with pytest.raises(ValueError, match="sum_mode"):
        s.set_opt(DecodeConfig(sum_mode=True, lattice_nbest=True))


def test_native_service_dumps_the_in_memory_world(artifacts):
    """DecoderService(searcher_backend="native") with no files writes the LM
    and lexicon for the C++ loader and decodes like the files would."""
    arpa, lex_path, lexicon, lm = artifacts
    cfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=10)
    lp = clean_logprobs(lexicon.sentence_to_phonemes("the cat sat")) * 3.0
    dumped = DecoderService(lexicon, lm, cfg, channel_order="model", searcher_backend="native")
    files = DecoderService(lexicon, lm, cfg, channel_order="model", searcher_backend="native",
                           arpa_path=arpa, lexicon_path=lex_path)
    assert isinstance(dumped.searcher, NativeLexiconBeamSearch)
    a, b = dumped.decode_utterance(lp), files.decode_utterance(lp)
    assert a.sentence == "the cat sat"
    assert a.nbest == b.nbest


@pytest.mark.parametrize("order", [1, 2, 3])
def test_native_ngram_trainer_matches_python(tmp_path, order):
    """C++ KN trainer == the python trainer (same estimator, exact scores),
    and the port's ARPA is the JAX package's native ARPA byte for byte."""
    cpath = str(tmp_path / "corpus.txt")
    with open(cpath, "w") as f:
        f.write("\n".join(" ".join(s) for s in CORPUS) + "\n")
    apath = str(tmp_path / f"lm{order}.arpa")
    train_ngram_native(cpath, apath, order=order)
    jpath = str(tmp_path / f"jax{order}.arpa")
    jax_train_ngram_native(cpath, jpath, order=order)
    assert open(apath, "rb").read() == open(jpath, "rb").read()
    nat = NGramLM.from_arpa(apath)
    py = train_ngram(CORPUS, order=order)
    assert py.tables == jax_train_ngram(CORPUS, order=order).tables
    for ctx in ([], ["the"], ["the", "cat"], ["there", "is"], ["zz"]):
        for w in ["cat", "mat", "is", "the", EOS, UNK]:
            np.testing.assert_allclose(nat.logp(ctx, w), py.logp(ctx, w), rtol=1e-5, atol=1e-5)
    total = sum(math.exp(nat.logp(["the"], w)) for w in py.vocab if w not in (EOS, UNK))
    total += math.exp(nat.logp(["the"], EOS)) + math.exp(nat.logp(["the"], UNK))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_native_trainer_vocab_limit(tmp_path):
    cpath = str(tmp_path / "c.txt")
    with open(cpath, "w") as f:
        f.write("the cat sat\nthe dog ran\n")
    vpath = str(tmp_path / "v.txt")
    with open(vpath, "w") as f:
        f.write("the\ncat\nsat\n")
    apath = str(tmp_path / "lm.arpa")
    train_ngram_native(cpath, apath, order=2, vocab_path=vpath)
    lm = NGramLM.from_arpa(apath)
    assert "dog" not in lm.vocab
    assert lm.logp([], "dog") == lm.logp([], "<unk>")


def test_native_unpruned_rescore(tmp_path):
    """n-best rescoring with a second (unpruned) ARPA == each sentence's LM
    score recomputed with NGramLM.sentence_logp; clearing it restores the
    base n-best."""
    lex = {"the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
           "mat": ["M", "AE", "T"], "hat": ["HH", "AE", "T"], "on": ["AA", "N"]}
    corpus = ["the cat sat on the mat".split(), "the cat sat".split(), "the hat".split()] * 3
    lexicon = Lexicon.from_words(lex)
    unpruned = train_ngram(corpus + ["the mat sat on the hat".split()] * 2, order=3)
    arpa = str(tmp_path / "lm.arpa")
    train_ngram(corpus, order=2).to_arpa(arpa)
    arpa_big = str(tmp_path / "lm_unpruned.arpa")
    unpruned.to_arpa(arpa_big)
    lexp = str(tmp_path / "lexicon.txt")
    write_lexicon(lexp, lex)
    cfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=64, beam=0.0)
    lp = clean_logprobs(lexicon.sentence_to_phonemes("the cat sat"), frames_per=2, hot=4.0)

    r_base = NativeLexiconBeamSearch(arpa, lexp, cfg)
    r_base.decode(lp)
    r_base = r_base.finish_decoding()
    resc = NativeLexiconBeamSearch(arpa, lexp, cfg, rescore_arpa=arpa_big)
    resc.decode(lp)
    r_resc = resc.finish_decoding()
    assert len(r_resc) > 1
    for r in r_resc:
        np.testing.assert_allclose(r.lm_score, unpruned.sentence_logp(r.sentence.split()),
                                   rtol=1e-4, atol=1e-4)
    totals = [cfg.acoustic_scale * r.ac_score + r.lm_score for r in r_resc]
    assert totals == sorted(totals, reverse=True)
    assert r_resc[0].sentence == "the cat sat"

    jax_resc = JaxNative(arpa, lexp, JaxDecodeConfig(**cfg.to_dict()), rescore_arpa=arpa_big)
    assert nbest(jax_resc, lp) == [(r.sentence, r.ac_score, r.lm_score) for r in r_resc]

    resc.set_rescore_lm(None)
    assert [r[0] for r in nbest(resc, lp)] == [r.sentence for r in r_base]


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses raises with its message."""
    bad = tmp_path / "decoder.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "_SRCS", [bad])
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime._build()
    assert not list((tmp_path / "_build").glob("*.tmp"))
