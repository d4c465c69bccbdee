"""The served slice as a whole: the same numpy features through the JAX
package (smoothing → GRU forward → DecoderService) and through the port give
the same sentences and the same n-best scores, with the python searcher and
with the device searcher (built on the CPU here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from b2txt_tpu.data.synthetic import phoneme_code, sentence_corpus, word_pronunciations
from b2txt_tpu.evaluate.harness import _batched_inference as jax_batched_inference
from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.models.planted import plant_frame_labels
from b2txt_tpu.models.planted import planted_params as jax_planted_params
from b2txt_tpu.serve import DecoderService as JaxDecoderService
from b2txt_tpu.utils import TrainConfig as JaxTrainConfig
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch.data import synthetic as port_synthetic
from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
from b2txt_tpu_torch.evaluate.harness import _batched_inference
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.models import GRUDecoder
from b2txt_tpu_torch.models.planted import planted_params
from b2txt_tpu_torch.serve import DecoderService
from b2txt_tpu_torch.utils import TrainConfig
from b2txt_tpu_torch.utils.config import DecodeConfig
from torch_host_merge import host_viterbi_merge  # noqa: F401  (autouse)

D, H, LAYERS, N_DAYS = 64, 64, 2, 4
SENTENCES = ["hello world day", "good brain text", "day good hello", "brain text good world"]
DECODE = dict(acoustic_scale=0.325, blank_penalty=90.0, nbest=100)


def _small(cfg):
    cfg.model.n_input_features, cfg.model.n_units, cfg.model.n_layers = D, H, LAYERS
    return cfg


@pytest.fixture(scope="module")
def requests():
    lexicon = JaxLexicon.from_words(word_pronunciations())
    code = phoneme_code(D)
    rng = np.random.default_rng(11)
    feats = []
    for i, s in enumerate(SENTENCES):
        ids = lexicon.sentence_to_phonemes(s)
        labels, n = plant_frame_labels(rng, ids, 200 + 16 * i)
        assert n == len(ids)
        x = np.where((labels >= 0)[:, None], code[np.clip(labels, 0, None)], 0.0)
        feats.append((x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32))
    return code, feats


def test_synthetic_world_matches_jax():
    assert port_synthetic.word_pronunciations() == word_pronunciations()
    assert port_synthetic.sentence_corpus() == sentence_corpus()
    np.testing.assert_array_equal(port_synthetic.phoneme_code(D), phoneme_code(D))


def test_served_slice_matches_jax(requests):
    code, feats = requests

    jcfg = _small(JaxTrainConfig())
    jparams = jax_planted_params(jcfg.model, N_DAYS, code)
    jlogits = jax_batched_inference(jparams, feats, 1, jcfg, jnp.float32)
    jservice = JaxDecoderService(
        JaxLexicon.from_words(word_pronunciations()),
        jax_train_ngram(sentence_corpus(), order=3),
        JaxDecodeConfig(**DECODE), channel_order="model")
    jouts = jservice.decode_utterances(jlogits)

    cfg = _small(TrainConfig())
    model = GRUDecoder(cfg.model, N_DAYS, 41, device="cpu")
    model.load_state_dict(planted_params(cfg.model, N_DAYS, code))
    logits = _batched_inference(model, feats, 1, cfg, torch.float32)
    service = DecoderService(
        Lexicon.from_words(port_synthetic.word_pronunciations()),
        train_ngram(port_synthetic.sentence_corpus(), order=3),
        DecodeConfig(**DECODE), searcher_backend="python", channel_order="model")
    outs = service.decode_utterances(logits)

    for a, b in zip(logits, jlogits):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert [o.sentence for o in outs] == SENTENCES
    for o, j in zip(outs, jouts):
        assert o.sentence == j.sentence
        assert [r[0] for r in o.nbest] == [r[0] for r in j.nbest]
        np.testing.assert_allclose(
            np.array([r[1:] for r in o.nbest], np.float64),
            np.array([r[1:] for r in j.nbest], np.float64), rtol=0, atol=1e-4)


def test_unported_backends_raise(requests):
    """Every backend of the JAX package is ported: "native" builds the C++
    searcher (its in-memory LM and lexicon dumped for the loader) and gives
    the JAX package's native n-best on the same logits; a backend neither
    package has raises."""
    code, feats = requests
    lexicon = Lexicon.from_words(port_synthetic.word_pronunciations())
    lm = train_ngram(port_synthetic.sentence_corpus(), order=3)
    with pytest.raises(ValueError, match="searcher_backend"):
        DecoderService(lexicon, lm, searcher_backend="tpu")

    cfg = _small(TrainConfig())
    model = GRUDecoder(cfg.model, N_DAYS, 41, device="cpu")
    model.load_state_dict(planted_params(cfg.model, N_DAYS, code))
    logits = _batched_inference(model, feats, 1, cfg, torch.float32)
    service = DecoderService(lexicon, lm, DecodeConfig(**DECODE), searcher_backend="native",
                             channel_order="model")
    jservice = JaxDecoderService(
        JaxLexicon.from_words(word_pronunciations()), jax_train_ngram(sentence_corpus(), order=3),
        JaxDecodeConfig(**DECODE), searcher_backend="native", channel_order="model")
    outs = service.decode_utterances(logits)
    assert [o.sentence for o in outs] == SENTENCES
    assert [o.nbest for o in outs] == [j.nbest for j in jservice.decode_utterances(logits)]


# the device backend: canonical search settings at a small beam
DEVICE_DECODE = dict(DECODE, beam_width=32, first_beam_size=8, sum_mode=False)


def _real_rows(out):
    """A FinalOutput's n-best rows of real hypotheses (beams at the NEG
    score floor carry payloads that depend on top-k tie order)."""
    return [r for r in out.nbest if r[1] > -1e29]


def _assert_same_outputs(outs, jouts):
    assert len(outs) == len(jouts)
    for o, j in zip(outs, jouts):
        assert o.sentence == j.sentence
        rows, jrows = _real_rows(o), _real_rows(j)
        assert [r[0] for r in rows] == [r[0] for r in jrows]
        np.testing.assert_allclose(np.array([r[1:] for r in rows], np.float64),
                                   np.array([r[1:] for r in jrows], np.float64),
                                   rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def device_services(requests):
    """Logits of the served slice, and the JAX and port DecoderServices with
    the device backend and an unpruned rescore LM."""
    code, feats = requests
    cfg = _small(TrainConfig())
    model = GRUDecoder(cfg.model, N_DAYS, 41, device="cpu")
    model.load_state_dict(planted_params(cfg.model, N_DAYS, code))
    logits = _batched_inference(model, feats, 1, cfg, torch.float32)
    corpus = port_synthetic.sentence_corpus()
    jservice = JaxDecoderService(
        JaxLexicon.from_words(word_pronunciations()), jax_train_ngram(corpus, order=2),
        JaxDecodeConfig(**DEVICE_DECODE, rescore=True), channel_order="model",
        rescore_lm=jax_train_ngram(corpus, order=3), searcher_backend="device")
    lexicon, lm = Lexicon.from_words(port_synthetic.word_pronunciations()), train_ngram(corpus, order=2)
    cfg = DecodeConfig(**DEVICE_DECODE, rescore=True)
    service = DecoderService(
        lexicon, lm, cfg, channel_order="model", rescore_lm=train_ngram(corpus, order=3),
        searcher_backend="device", searcher=DeviceLexiconBeamSearch(lexicon, lm, cfg, device="cpu"))
    return logits, service, jservice


def test_device_backend_decode_utterances_matches_jax(device_services):
    logits, service, jservice = device_services
    outs = service.decode_utterances(logits, batch_size=3)
    assert [o.sentence for o in outs] == SENTENCES
    assert service._internal_rescore and service.searcher.rescore_lm is not None
    _assert_same_outputs(outs, jservice.decode_utterances(logits, batch_size=3))


def test_device_backend_batched_utterances_and_rescore_toggle(device_services):
    """decode_batched_utterances on tensors, then update_params turning the
    on-device pool rescore off (host list rescore off too) and on again."""
    logits, service, jservice = device_services
    B, T = len(logits), max(a.shape[0] for a in logits)
    lp = np.full((B, T, 41), -30.0, np.float32)
    lens = np.zeros(B, np.int32)
    for i, a in enumerate(logits):
        x = a - a.max(-1, keepdims=True)
        lp[i, : a.shape[0]] = x - np.log(np.exp(x).sum(-1, keepdims=True))
        lens[i] = a.shape[0]
    try:
        for rescore in (False, True):
            service.update_params(rescore=rescore)
            jservice.update_params(rescore=rescore)
            assert (service.searcher.rescore_lm is not None) == rescore
            outs = service.decode_batched_utterances([(torch.from_numpy(lp), lens)], [B])
            jouts = jservice.decode_batched_utterances([(jnp.asarray(lp), lens)], [B])
            assert [o.sentence for o in outs] == SENTENCES
            _assert_same_outputs(outs, jouts)
    finally:
        service.update_params(rescore=True)
        jservice.update_params(rescore=True)


def test_device_backend_streaming_matches_jax(device_services):
    """decode_chunk (partial sentence per chunk) then finalize."""
    logits, service, jservice = device_services
    for a in logits[:2]:
        service.reset()
        jservice.reset()
        for i in range(0, a.shape[0], 16):
            assert service.decode_chunk(a[i : i + 16]) == jservice.decode_chunk(a[i : i + 16])
        _assert_same_outputs([service.finalize()], [jservice.finalize()])
