"""The port's device searcher (b2txt_tpu_torch.decode.lmbeam_device, built on
the CPU) against the JAX package's DeviceLexiconBeamSearch on the same numpy
log-probs: the same n-best sentences with ac/lm scores within 1e-4, across
the knob sweep of tests/test_searcher_crosscheck.py, both merge modes, both
state keys, close_probe_top, lower-order LMs, the batched and the streaming
paths, and the on-device pool rescore.

Only real hypotheses are compared: beams at the NEG score floor fill the
beam when fewer than K real candidates exist, and which payloads they carry
depends on how each top-k orders ties."""

import numpy as np
import pytest
import torch

from b2txt_tpu.decode import lmbeam_jax as jlb
from b2txt_tpu.decode.lmbeam import LexiconBeamSearch as JaxOracle
from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch.decode import lmbeam_device as lb
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.utils.config import DecodeConfig
from torch_host_merge import host_viterbi_merge  # noqa: F401  (autouse)
from torch_search_world import (  # noqa: F401  (shared with the files that import them here)
    CORPUS, LEX, SENTENCES, batch_of, noisy_logprobs,
)

# the knob sweep of tests/test_searcher_crosscheck.py:77
CONFIGS = [
    dict(acoustic_scale=0.5, blank_penalty=1.0, first_beam_size=0,
         ctc_blank_skip_threshold=1.0, length_penalty=0.0, beam=0.0),
    dict(acoustic_scale=0.325, blank_penalty=9.0, first_beam_size=0,
         ctc_blank_skip_threshold=1.0, length_penalty=0.0, beam=0.0),
    dict(acoustic_scale=0.5, blank_penalty=1.0, first_beam_size=6,
         ctc_blank_skip_threshold=1.0, length_penalty=0.0, beam=0.0),
    dict(acoustic_scale=1.0, blank_penalty=3.0, first_beam_size=10,
         ctc_blank_skip_threshold=1.0, length_penalty=-0.4, beam=0.0),
    dict(acoustic_scale=0.5, blank_penalty=1.0, first_beam_size=0,
         ctc_blank_skip_threshold=0.95, length_penalty=0.0, beam=0.0),
    dict(acoustic_scale=0.325, blank_penalty=2.0, first_beam_size=8,
         ctc_blank_skip_threshold=0.9, length_penalty=0.2, beam=17.0),
    dict(acoustic_scale=0.5, blank_penalty=1.0, first_beam_size=0,
         ctc_blank_skip_threshold=1.0, length_penalty=0.0, beam=0.0, sum_mode=False),
    dict(acoustic_scale=0.325, blank_penalty=9.0, first_beam_size=8,
         ctc_blank_skip_threshold=1.0, length_penalty=0.0, beam=0.0, sum_mode=False),
]


def real(results):
    return [r for r in results if r.ac_score > lb.NEG / 2]


def assert_same_nbest(got, want, tol=1e-4):
    got, want = real(got), real(want)
    assert want and [r.sentence for r in got] == [r.sentence for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose([a.ac_score, a.lm_score], [b.ac_score, b.lm_score],
                                   rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def world():
    lexicon = Lexicon.from_words(LEX)
    lps = [noisy_logprobs(lexicon.sentence_to_phonemes(s), seed=100 + i)
           for i, s in enumerate(SENTENCES)]
    return (lexicon, train_ngram(CORPUS, order=3), JaxLexicon.from_words(LEX),
            jax_train_ngram(CORPUS, order=3), lps)


@pytest.fixture(scope="module")
def jax_searchers(world):
    """JAX searchers by knob set, shared across the tests of this module."""
    _, _, jlex, jlm, _ = world
    cache = {}

    def get(knobs, **kw):
        key = (tuple(sorted(knobs.items())), tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jlb.DeviceLexiconBeamSearch(
                jlex, jlm, JaxDecodeConfig(nbest=10, beam_width=64, **knobs), **kw)
        return cache[key]

    return get


@pytest.mark.parametrize("knobs", CONFIGS)
def test_batched_knob_sweep_matches_jax(world, jax_searchers, knobs):
    lexicon, lm, jlex, jlm, lps = world
    batch, lens = batch_of(lps)
    want = jax_searchers(knobs).decode_batch(batch, lens)
    port = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(nbest=10, beam_width=64, **knobs),
                                      device="cpu")
    got = port.decode_batch(batch, lens)
    for g, w in zip(got, want):
        assert_same_nbest(g, w)
    # the python oracle's top-1, at the JAX searcher's own oracle tolerance
    # (tests/test_searcher_crosscheck.py:134-137)
    for lp, g in zip(lps, got):
        host = JaxOracle(jlex, jlm, JaxDecodeConfig(nbest=10, beam_width=64, **knobs))
        host.decode(lp)
        h = host.finish_decoding()[0]
        assert g[0].sentence == h.sentence
        np.testing.assert_allclose([g[0].ac_score, g[0].lm_score], [h.ac_score, h.lm_score],
                                   rtol=1e-3, atol=1e-3)


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(3)
    lp = np.log(rng.dirichlet(np.ones(41) * 0.3, size=(3, 40))).astype(np.float32)
    lp[:, ::3, 0] = -1e-4                                  # blank-dominated frames
    lens = np.array([40, 25, 7], np.int32)
    for thresh, bp in ((0.9, 1.0), (0.5, 2.0)):
        got = lb.compact_blank_skip(lp, lens, 0, thresh, np.log(bp))
        want = jlb.compact_blank_skip(lp, lens, 0, thresh, np.log(bp))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    traces = np.where(rng.random((30, 2, 5)) < 0.2, rng.integers(0, 9, (30, 2, 5)), -1)
    for a, b in zip(lb._compress_traces(traces.astype(np.int32)),
                    jlb._compress_traces(traces.astype(np.int32))):
        np.testing.assert_array_equal(a, b)
    parents = rng.integers(0, 5, (30, 2, 5))
    np.testing.assert_array_equal(lb._backtrace_all(parents, traces),
                                  jlb._backtrace_all(parents, traces))


def test_searcher_wants_the_card(world, monkeypatch):
    lexicon, lm, _, _, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig())


def test_lazy_constructor_builds_the_searcher(world, jax_searchers):
    """``decode.device_lexicon_beam_search`` builds the class itself, as the
    JAX package's lazy constructor does: the same n-best as a searcher built
    directly, and as JAX's."""
    from b2txt_tpu.decode import device_lexicon_beam_search as jax_lazy
    from b2txt_tpu_torch.decode import device_lexicon_beam_search

    lexicon, lm, jlex, jlm, lps = world
    knobs = CONFIGS[1]
    made = device_lexicon_beam_search(lexicon, lm, DecodeConfig(nbest=10, beam_width=64, **knobs),
                                      device="cpu")
    direct = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(nbest=10, beam_width=64,
                                                                  **knobs), device="cpu")
    jax_made = jax_lazy(jlex, jlm, JaxDecodeConfig(nbest=10, beam_width=64, **knobs))
    assert type(made) is lb.DeviceLexiconBeamSearch
    assert type(jax_made) is jlb.DeviceLexiconBeamSearch
    batch, lens = batch_of(lps)
    for got, same, want in zip(made.decode_batch(batch, lens), direct.decode_batch(batch, lens),
                               jax_searchers(knobs).decode_batch(batch, lens)):
        assert [(r.sentence, r.ac_score, r.lm_score) for r in got] == \
            [(r.sentence, r.ac_score, r.lm_score) for r in same]
        assert_same_nbest(got, want)


@pytest.mark.parametrize("state_key", ["history", "ngram"])
def test_viterbi_merge_keeps_each_paths_own_acoustic(world, state_key):
    """Viterbi merge: each score component keeps its best path and that
    path's acoustic score, as the host searchers' per-component merge does
    (the benchmark's reference is one), not the largest acoustic score
    among the merged paths. The smallest case seen: three random frames,
    K = 8, where "is" is reached by two paths whose better-ranked one has
    the lower acoustic score (the per-column max read -12.7009 for it, the
    host searchers -12.7631)."""
    lexicon, lm, jlex, jlm, _ = world
    knobs = dict(nbest=10, beam_width=8, acoustic_scale=0.5, blank_penalty=1.0,
                 first_beam_size=0, ctc_blank_skip_threshold=1.0, length_penalty=0.0,
                 beam=0.0, sum_mode=False)
    rng = np.random.default_rng(81)
    lp = (2.0 * rng.standard_normal((3, 41))).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    port = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(**knobs), state_key=state_key,
                                      device="cpu")
    got = real(port.decode_batch(lp[None], np.array([3], np.int32))[0])
    host = JaxOracle(jlex, jlm, JaxDecodeConfig(**knobs), state_key=state_key)
    host.decode(lp)
    want = host.finish_decoding()
    assert "is" in [r.sentence for r in got]
    assert_same_nbest(got, want)


def test_first_beam_keeps_every_phone_tied_at_its_threshold(world):
    """The first beam extends by every phone at or above the frame's
    first_beam-th best log-prob, ties included, as the host searchers
    threshold it (K6 alike). The smallest case seen: two frames of
    log-probs rounded to whole nats before normalizing, first beam 2,
    where a phone tied with the second best starts "is"; a cut at exactly
    two phones never reached it."""
    lexicon, lm, jlex, jlm, _ = world
    knobs = dict(nbest=10, beam_width=64, acoustic_scale=0.5, blank_penalty=1.0,
                 first_beam_size=2, ctc_blank_skip_threshold=1.0, length_penalty=0.0,
                 beam=0.0, sum_mode=True)
    rng = np.random.default_rng(6)
    lp = np.round(rng.standard_normal((2, 41)) * 1.5).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    masked = np.delete(lp, [0, 40], axis=1)
    assert (masked >= np.sort(masked, 1)[:, -2:-1]).sum(1).max() > 2     # a tie at the cut
    port = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(**knobs), device="cpu")
    got = real(port.decode_batch(lp[None], np.array([2], np.int32))[0])
    host = JaxOracle(jlex, jlm, JaxDecodeConfig(**knobs))
    host.decode(lp)
    assert [r.sentence for r in got] == ["is"]
    assert_same_nbest(got, host.finish_decoding())


def test_beam_window_drops_the_beams_the_host_searchers_drop(world):
    """Each frame drops the beams more than ``beam`` below the row's best,
    as the host searchers do. The smallest case seen: two random frames,
    K = 8, beam 3, where a path the window drops would otherwise merge into
    "a" and lift its acoustic score (-7.757 against the host's -7.777)."""
    lexicon, lm, jlex, jlm, _ = world
    knobs = dict(nbest=10, beam_width=8, acoustic_scale=0.5, blank_penalty=1.0,
                 first_beam_size=0, ctc_blank_skip_threshold=1.0, length_penalty=0.0,
                 beam=3.0, sum_mode=True)
    rng = np.random.default_rng(3)
    lp = (rng.standard_normal((2, 41)) * 2).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    port = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(**knobs), device="cpu")
    got = real(port.decode_batch(lp[None], np.array([2], np.int32))[0])
    host = JaxOracle(jlex, jlm, JaxDecodeConfig(**knobs))
    host.decode(lp)
    assert "a" in [r.sentence for r in got]
    assert_same_nbest(got, host.finish_decoding())
