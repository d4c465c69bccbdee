"""The port's LLM rescore on the CPU against the JAX package's: the
byte-level rescorer (decode/device_lm.py against decode/jax_lm.py, the cases
of tests/test_llm_rescorer.py), the α-blend, the grouped finalize with the
port's tiny OPT (tests/test_llm_group.py), and DecoderService(do_opt=True)
with the port's OPT against the JAX service with the JAX OPT on the same
weights, per utterance and grouped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b2txt_tpu.decode import jax_lm as JL
from b2txt_tpu.decode import opt_lm as JO
from b2txt_tpu.decode.rescore import llm_rescore as jax_llm_rescore
from b2txt_tpu_torch.decode import device_lm as DL
from b2txt_tpu_torch.decode import opt_lm as PO
from b2txt_tpu_torch.decode.rescore import (llm_rescore, llm_rescore_async,
                                            llm_rescore_group_async)

TEXTS = ["hello world", "a", "the quick brown fox jumps over the lazy dog", "the cat sat"]
NBEST = [("the cat sat", -10.0, -3.0), ("the bat sat", -11.0, -2.5),
         ("the mat sat", -12.0, -2.0)]
LEX = {"the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
       "mat": ["M", "AE", "T"], "on": ["AA", "N"]}


@pytest.fixture(scope="module")
def byte_pair():
    """(JAX rescorer, the port's rescorer on its weights)."""
    ref = JL.JaxCausalLMRescorer(seed=3)
    port = DL.DeviceCausalLMRescorer(
        params=DL.params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params), "cpu"),
        device="cpu")
    return ref, port


def test_byte_lm_score_matches_manual_sum_and_jax(byte_pair):
    """score() == Σ_t log P(tok_t | tok_<t) − length_penalty · n_tokens, from
    the port's own forward logits, and equal to the JAX rescorer's."""
    ref, port = byte_pair
    [score] = port.score(["the cat sat"], length_penalty=0.7)
    ids = DL.encode_bytes("the cat sat", 256)
    with torch.no_grad():
        lp = torch.log_softmax(DL.forward(port.params, torch.tensor([ids])), -1)[0].double()
    manual = sum(float(lp[t, ids[t + 1]]) for t in range(len(ids) - 1)) - 0.7 * len(ids)
    np.testing.assert_allclose(score, manual, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        logits = DL.forward(port.params, torch.tensor([ids])).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(JL.forward(ref.params, jnp.asarray([ids]), n_heads=4)),
        rtol=1e-4, atol=1e-4)
    for pen in (0.0, 0.7):
        np.testing.assert_allclose(port.score(TEXTS, pen), ref.score(TEXTS, pen),
                                   rtol=1e-4, atol=1e-4)


def test_byte_lm_batching_invariance(byte_pair):
    _, port = byte_pair
    np.testing.assert_allclose(port.score(TEXTS), [port.score([t])[0] for t in TEXTS],
                               rtol=1e-3, atol=1e-3)


def test_byte_lm_alpha_blend_matches_jax(byte_pair):
    """llm_rescore's totals follow acoustic_scale·ac + (1−α)·ngram + α·llm
    (standalone :233), row for row the JAX package's."""
    ref, port = byte_pair
    got = llm_rescore(port, NBEST, acoustic_scale=0.3, alpha=0.6)
    want = jax_llm_rescore(ref, NBEST, acoustic_scale=0.3, alpha=0.6)
    assert got.best == want.best and [r[0] for r in got.nbest] == [r[0] for r in want.nbest]
    np.testing.assert_allclose([r[1:] for r in got.nbest], [r[1:] for r in want.nbest],
                               rtol=1e-4, atol=1e-4)
    llm = dict(zip([s for s, _, _ in NBEST], port.score([s for s, _, _ in NBEST])))
    for s, a, lm in NBEST:
        row = next(r for r in got.nbest if r[0] == s)
        np.testing.assert_allclose(row[4], 0.3 * a + 0.4 * lm + 0.6 * llm[s], rtol=1e-4)
    assert got.confidence == pytest.approx(want.confidence, abs=1e-5)


@pytest.fixture(scope="module")
def opt_pair():
    """(JAX OPTRescorer, the port's OPTRescorer on its weights), tiny, f32."""
    cfg = JO.OPTConfig.tiny()
    params = JO.init_params(jax.random.PRNGKey(7), cfg)
    sd = PO.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return (JO.OPTRescorer(cfg, params=params, max_len=24),
            PO.OPTRescorer(PO.OPTConfig.tiny(), params=sd, device="cpu", max_len=24))


def _nbests(n_utts: int, per: int = 4):
    words = ["the", "cat", "sat", "mat", "on"]
    out = []
    for u in range(n_utts):
        nb = []
        for c in range(per):
            sent = " ".join(words[(u + c + k) % len(words)] for k in range(2 + (u + c) % 3))
            nb.append((sent, -1.0 - u - 0.1 * c, -2.0 - 0.2 * c))
        out.append(nb)
    return out


def test_group_matches_per_utterance_tiny_opt(opt_pair):
    """Grouped scoring through the port's packed OPT equals per-utterance
    llm_rescore_async (and the JAX package's per-utterance outputs)."""
    ref, port = opt_pair
    nbests = _nbests(5)
    grouped = [f() for f in llm_rescore_group_async(
        port, nbests, acoustic_scale=0.3, alpha=0.5, length_penalty=0.1)]
    single = [llm_rescore_async(port, nb, 0.3, 0.5, length_penalty=0.1)() for nb in nbests]
    jax_single = [jax_llm_rescore(ref, nb, 0.3, 0.5, length_penalty=0.1) for nb in nbests]
    for g, s, j in zip(grouped, single, jax_single):
        assert g.best == s.best == j.best
        assert g.confidence == pytest.approx(s.confidence, abs=1e-6)
        for rg, rs, rj in zip(g.nbest, s.nbest, j.nbest):
            assert rg[0] == rs[0] == rj[0]
            np.testing.assert_allclose(rg[1:], rs[1:], atol=1e-4)
            np.testing.assert_allclose(rg[1:], rj[1:], atol=1e-4)


def _clean_logits(phoneme_ids, frames_per=3, hot=6.0):
    rows = []
    for pid in phoneme_ids:
        for _ in range(frames_per):
            r = np.full(41, -hot, np.float32)
            r[pid] = hot
            rows.append(r)
        blank = np.full(41, -hot, np.float32)
        blank[0] = hot
        rows.append(blank)
    return np.stack(rows)


@pytest.mark.parametrize("group", [0, 12], ids=["per_utterance", "grouped"])
def test_service_do_opt_matches_jax_service(opt_pair, group):
    """DecoderService(do_opt=True) with the port's OPT against the JAX
    service with the JAX OPT on the same weights (python searchers): the
    same sentences and n-best, scores within 1e-4; grouped equals
    per-utterance."""
    from b2txt_tpu.lm import Lexicon as JLexicon, train_ngram as jax_train
    from b2txt_tpu.serve import DecoderService as JService
    from b2txt_tpu.utils.config import DecodeConfig as JConfig
    from b2txt_tpu_torch.lm import Lexicon, train_ngram
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.config import DecodeConfig

    ref, port = opt_pair
    corpus = [s.split() for s in ["the cat sat on the mat", "the cat sat", "the mat"]] * 5
    knobs = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, do_opt=True, alpha=0.5)
    sents = ["the cat", "the mat", "the cat sat", "the mat on the cat"]
    lex = Lexicon.from_words(LEX)
    logits = [_clean_logits(lex.sentence_to_phonemes(s)) for s in sents]
    ours = DecoderService(lex, train_ngram(corpus, order=3), DecodeConfig(**knobs), llm=port,
                          channel_order="model", llm_group_candidates=group)
    theirs = JService(JLexicon.from_words(LEX), jax_train(corpus, order=3), JConfig(**knobs),
                      llm=ref, channel_order="model", llm_group_candidates=group)
    got, want = ours.decode_utterances(logits), theirs.decode_utterances(logits)
    per_utt = DecoderService(lex, train_ngram(corpus, order=3), DecodeConfig(**knobs),
                             llm=port, channel_order="model").decode_utterances(logits)
    assert [o.sentence for o in got] == sents == [o.sentence for o in want]
    for a, b, c in zip(got, want, per_utt):
        assert [r[0] for r in a.nbest] == [r[0] for r in b.nbest] == [r[0] for r in c.nbest]
        assert any(r[3] != 0.0 for r in a.nbest)     # the LLM scored
        np.testing.assert_allclose([r[1:] for r in a.nbest], [r[1:] for r in b.nbest],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose([r[1:] for r in a.nbest], [r[1:] for r in c.nbest],
                                   rtol=1e-4, atol=1e-4)


def test_service_context_takes_the_prefix_path(opt_pair):
    """With a conversational context the service scores context+hypothesis
    through the port's prefix-KV path, as the JAX service does through its."""
    from b2txt_tpu.lm import Lexicon as JLexicon, train_ngram as jax_train
    from b2txt_tpu.serve import DecoderService as JService
    from b2txt_tpu.utils.config import DecodeConfig as JConfig
    from b2txt_tpu_torch.lm import Lexicon, train_ngram
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.config import DecodeConfig

    ref, port = opt_pair
    # room for the context and a hypothesis in one row
    ref = JO.OPTRescorer(ref.cfg, params=ref.params, max_len=64)
    port = PO.OPTRescorer(port.cfg, params=port.model.state_dict(), device="cpu", max_len=64)
    corpus = [["the", "cat", "sat"]] * 4
    knobs = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=32, beam=0.0,
                 do_opt=True, alpha=0.5)
    lex = Lexicon.from_words(LEX)
    logits = _clean_logits(lex.sentence_to_phonemes("the cat sat"), frames_per=2)
    outs = []
    for svc in (DecoderService(lex, train_ngram(corpus, order=2), DecodeConfig(**knobs),
                               llm=port, channel_order="model"),
                JService(JLexicon.from_words(LEX), jax_train(corpus, order=2), JConfig(**knobs),
                         llm=ref, channel_order="model")):
        svc.set_context("we were talking about pets")
        outs.append(svc.decode_utterance(logits))
    got, want = outs
    assert got.sentence == want.sentence == "the cat sat"
    assert port.prefix_runs > 0
    np.testing.assert_allclose([r[1:] for r in got.nbest], [r[1:] for r in want.nbest],
                               rtol=1e-4, atol=1e-4)


def test_byte_lm_score_async_waits_only_in_the_fetch(byte_pair, monkeypatch):
    _, port = byte_pair
    want = port.score(TEXTS, 0.3)

    def refuse(*a, **k):
        raise AssertionError("host read before the fetch")

    with monkeypatch.context() as m:
        for name in ("cpu", "item", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        thunk = port.score_async(TEXTS, 0.3)
    np.testing.assert_allclose(thunk(), want, rtol=1e-6)
