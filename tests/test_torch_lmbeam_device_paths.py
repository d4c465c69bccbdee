"""The port's device searcher against the JAX package's, on the paths
beside the batched knob sweep (tests/test_torch_lmbeam_device.py): the
streaming path in chunks, state_key="ngram", lower-order LMs, and the
on-device pool rescore with and without close_probe_top. Same comparison:
the n-best sentences, ac/lm scores within 1e-4, real hypotheses only."""

import numpy as np
import pytest

from b2txt_tpu.decode import lmbeam_jax as jlb
from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch.decode import lmbeam_device as lb
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.utils.config import DecodeConfig

from test_torch_lmbeam_device import (  # noqa: F401  (fixtures)
    CONFIGS, CORPUS, assert_same_nbest, batch_of, host_viterbi_merge, jax_searchers,
    noisy_logprobs, world,
)


@pytest.mark.parametrize("knobs", [CONFIGS[0], CONFIGS[4], CONFIGS[7]])
def test_streaming_in_chunks_matches_jax(world, jax_searchers, knobs):
    """reset / decode chunk by chunk / result / finish_decoding. Chunks of 7
    frames divide both utterances (56 and 84 frames): one JAX compile."""
    lexicon, lm, _, _, lps = world
    jdev = jax_searchers(knobs)
    port = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(nbest=10, beam_width=64, **knobs),
                                      device="cpu")
    for lp in lps[:2]:
        jdev.reset()
        port.reset()
        for i in range(0, lp.shape[0], 7):
            jdev.decode(lp[i : i + 7])
            port.decode(lp[i : i + 7])
            assert port.result()[0].sentence == jdev.result()[0].sentence
        assert port.decoded_something()
        assert_same_nbest(port.finish_decoding(), jdev.finish_decoding())


def test_ngram_state_key_matches_jax(world, jax_searchers):
    lexicon, lm, _, _, lps = world
    knobs = CONFIGS[6]
    batch, lens = batch_of(lps)
    want = jax_searchers(knobs, state_key="ngram").decode_batch(batch, lens)
    port = lb.DeviceLexiconBeamSearch(lexicon, lm, DecodeConfig(nbest=10, beam_width=64, **knobs),
                                      state_key="ngram", device="cpu")
    for g, w in zip(port.decode_batch(batch, lens), want):
        assert_same_nbest(g, w)
    with pytest.raises(ValueError, match="sum_mode"):
        port.set_opt(DecodeConfig(sum_mode=True))


@pytest.mark.parametrize("order", [1, 2])
def test_lower_order_lms_match_jax(world, order):
    lexicon, _, jlex, _, lps = world
    knobs = CONFIGS[2]
    cfg = dict(nbest=10, beam_width=64, **knobs)
    batch, lens = batch_of(lps[:2])
    jdev = jlb.DeviceLexiconBeamSearch(jlex, jax_train_ngram(CORPUS, order=order),
                                       JaxDecodeConfig(**cfg))
    port = lb.DeviceLexiconBeamSearch(lexicon, train_ngram(CORPUS, order=order),
                                      DecodeConfig(**cfg), device="cpu")
    for g, w in zip(port.decode_batch(batch, lens), jdev.decode_batch(batch, lens)):
        assert_same_nbest(g, w)


# the pool-rescore world of tests/test_rescore_equivalence.py: the pruned
# decode LM misranks "the sun rises", only the unpruned LM rescues it
RLEX = {
    "the": ["DH", "AH"], "cat": ["K", "AE", "T"], "bat": ["B", "AE", "T"],
    "sat": ["S", "AE", "T"], "mat": ["M", "AE", "T"], "sea": ["S", "IY"],
    "see": ["S", "IY"], "son": ["S", "AH", "N"], "sun": ["S", "AH", "N"],
    "rises": ["R", "AY", "Z", "IH", "Z"], "sleeps": ["S", "L", "IY", "P", "S"],
    "on": ["AA", "N"],
}
PRUNED = (["the son rises".split()] * 8 + ["see the cat".split()] * 8
          + ["the cat sat on the mat".split()] * 4 + ["the son sleeps".split()] * 2)
UNPRUNED = (["the sun rises".split()] * 10 + ["the sea".split()] * 6
            + ["the cat sat on the mat".split()] * 4 + ["the son sleeps".split()] * 1
            + ["see the cat".split()] * 1)
TRUTHS = ["the sun rises", "the cat sat on the mat"]


@pytest.mark.parametrize("close_top", [None, 1])
def test_pool_rescore_matches_jax(close_top):
    """On-device unpruned pool rescore, batched and streaming; with
    close_probe_top=1 the tail homophones take the backoff-chain score."""
    lexicon = Lexicon.from_words(RLEX)
    lps = [noisy_logprobs(lexicon.sentence_to_phonemes(t), seed=10 + i, hot=4.0, noise=0.5,
                          frames_per=3) for i, t in enumerate(TRUTHS)]
    batch, lens = batch_of(lps)
    knobs = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=96, beam=0.0,
                 length_penalty=0.3)
    jlex = JaxLexicon.from_words(RLEX)
    jdev = jlb.DeviceLexiconBeamSearch(
        jlex, jax_train_ngram(PRUNED, order=2), JaxDecodeConfig(**knobs),
        rescore_lm=jax_train_ngram(UNPRUNED, order=3), close_probe_top=close_top)
    port = lb.DeviceLexiconBeamSearch(
        lexicon, train_ngram(PRUNED, order=2), DecodeConfig(**knobs),
        rescore_lm=train_ngram(UNPRUNED, order=3), close_probe_top=close_top, device="cpu")
    got, want = port.decode_batch(batch, lens), jdev.decode_batch(batch, lens)
    for i, truth in enumerate(TRUTHS):
        assert got[i][0].sentence == truth
        assert_same_nbest(got[i], want[i])
        port.reset()
        jdev.reset()
        port.decode(lps[i])
        jdev.decode(lps[i])
        assert_same_nbest(port.finish_decoding(), jdev.finish_decoding())
