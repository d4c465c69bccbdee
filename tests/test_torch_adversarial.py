"""The port on the homophone-dense adversarial fixture
(``data/adversarial.py``: CMUdict collision statistics and a Zipfian corpus)
against the JAX package on the same fixture: the counterparts of
tests/test_adversarial_decode.py's three tests. The port's python, device
(on the CPU) and native searchers against the JAX device searcher; the
pool-rescue statistics of the native searcher; and the close-probe
approximation of the device searcher with the on-card pool rescore."""

import os

import numpy as np
import pytest

from b2txt_tpu.data import adversarial as jax_adversarial
from b2txt_tpu.decode.lmbeam_jax import DeviceLexiconBeamSearch as JaxDeviceSearch
from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm.ngram import NGramLM as JaxNGramLM
from b2txt_tpu.runtime import NativeLexiconBeamSearch as JaxNative
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch.data.adversarial import homophone_lexicon, lexicon_stats, zipf_corpus
from b2txt_tpu_torch.data.synthetic import ctc_logprobs
from b2txt_tpu_torch.decode.lmbeam import LexiconBeamSearch
from b2txt_tpu_torch.decode.lmbeam_device import NEG, DeviceLexiconBeamSearch
from b2txt_tpu_torch.decode.rescore import rescore_nbest_with_ngram, results_to_nbest
from b2txt_tpu_torch.lm import Lexicon, NGramLM, train_ngram
from b2txt_tpu_torch.runtime import NativeLexiconBeamSearch
from b2txt_tpu_torch.utils.config import DecodeConfig
from torch_host_merge import host_viterbi_merge  # noqa: F401  (autouse)

VOCAB = 3000
H = 6
CFG = dict(acoustic_scale=0.325, blank_penalty=90.0, nbest=100,
           beam_width=96, beam=17.0, first_beam_size=8, sum_mode=False)
TOL = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_adversarial_decode.py's world, drawn with the port's copy
    of the fixture; the JAX package reads the same files."""
    rng = np.random.default_rng(7)
    words, by_freq = homophone_lexicon(rng, VOCAB)
    ref_words, ref_by_freq = jax_adversarial.homophone_lexicon(np.random.default_rng(7), VOCAB)
    assert words == ref_words and by_freq == ref_by_freq
    stats = lexicon_stats(words)
    assert stats == jax_adversarial.lexicon_stats(words)
    assert stats["homophone_word_frac"] > 0.15 and stats["prefix_pron_frac"] > 0.10
    lexicon = Lexicon.from_words(words)
    corpus = zipf_corpus(rng, by_freq, 4000) + [[w] for w in words]
    lm_full = train_ngram(corpus, order=3)
    lm = lm_full.prune(3e-8)

    tmp = tmp_path_factory.mktemp("adversarial")
    arpa, arpa_full, lexp = (str(tmp / n) for n in ("lm.arpa", "lm_full.arpa", "lexicon.txt"))
    lm.to_arpa(arpa)
    lm_full.to_arpa(arpa_full)
    with open(lexp, "w") as f:
        for w, p in words.items():
            f.write(f"{w.upper()}  {' '.join(p)}\n")

    draw_rng = np.random.default_rng(40)
    utts = []
    for _ in range(24):
        ws = [by_freq[r] for r in np.random.default_rng(draw_rng.integers(1 << 31)).choice(
            min(800, VOCAB), size=5)]
        ids = lexicon.sentence_to_phonemes(" ".join(ws))
        utts.append((" ".join(ws), ctc_logprobs(draw_rng, ids, hot=12.0, noise=0.3)))
    jlm = JaxNGramLM.from_arpa(arpa)
    jax_world = (JaxLexicon.from_file(lexp, vocab=jlm.vocab), jlm)
    return (lexicon, NGramLM.from_arpa(arpa), NGramLM.from_arpa(arpa_full), arpa, arpa_full,
            lexp, utts, jax_world)


def batch_of(utts):
    lens = np.array([lp.shape[0] for _, lp in utts], np.int32)
    batch = np.full((len(utts), int(lens.max()), 41), -20.0, np.float32)
    for i, (_, lp) in enumerate(utts):
        batch[i, : lp.shape[0]] = lp
    return batch, lens


def real(results):
    return [r for r in results if r.ac_score > NEG / 2]


def total(r):
    return CFG["acoustic_scale"] * r.ac_score + r.lm_score


def assert_same_nbest(got, want):
    """The same candidates with the same scores (1e-4); candidates whose
    scores tie exactly (homophones with equal backed-off LM scores) may
    stand in either order."""
    got, want = real(got), real(want)
    assert want and len(got) == len(want)
    np.testing.assert_allclose([total(r) for r in got], [total(r) for r in want],
                               rtol=TOL, atol=TOL)
    by_sentence = {r.sentence: r for r in want}
    assert {r.sentence for r in got} == set(by_sentence)
    for r in got:
        w = by_sentence[r.sentence]
        np.testing.assert_allclose([r.ac_score, r.lm_score], [w.ac_score, w.lm_score],
                                   rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def jax_device_nbest(world):
    *_, utts, (jlex, jlm) = world
    searcher = JaxDeviceSearch(jlex, jlm, JaxDecodeConfig(**CFG), max_homophones=H)
    return searcher.decode_batch(*batch_of(utts[:8]))


@pytest.mark.parametrize("backend", ["python", "device", "native"])
def test_backends_match_the_jax_device_searcher(world, jax_device_nbest, backend):
    """Each of the port's searchers gives the JAX device searcher's n-best
    on the first 8 utterances."""
    lexicon, lm, lm_full, arpa, arpa_full, lexp, utts, _ = world
    cfg = DecodeConfig(**CFG)
    if backend == "device":
        got = DeviceLexiconBeamSearch(lexicon, lm, cfg, max_homophones=H,
                                      device="cpu").decode_batch(*batch_of(utts[:8]))
    else:
        searcher = (LexiconBeamSearch(lexicon, lm, cfg, max_homophones=H) if backend == "python"
                    else NativeLexiconBeamSearch(arpa, lexp, cfg, max_homophones=H))
        got = []
        for _, lp in utts[:8]:
            searcher.reset()
            searcher.decode(lp)
            got.append(searcher.finish_decoding())
    for g, w in zip(got, jax_device_nbest):
        assert_same_nbest(g, w)


def pool_stats(searcher, lexicon, lm_full, utts):
    """tests/test_adversarial_decode.py::test_decode_quality_and_pool_rescue's
    counts: exact, truth in the pool, rescued by the unpruned rescore,
    search errors, misses that are homophone substitutions only."""
    exact = rescued = in_pool = search_errors = homophone_misses = 0
    pron_of = {w: tuple(lexicon.prons[lexicon.word_ids[w]][0]) for w in lexicon.words}
    for sent, lp in utts:
        searcher.reset()
        searcher.decode(lp)
        res = searcher.finish_decoding()
        assert res
        top1 = res[0].sentence
        if top1 == sent:
            exact += 1
            in_pool += 1
            continue
        pool = {r.sentence: r for r in res}
        if sent in pool:
            in_pool += 1
            if total(pool[sent]) > total(res[0]) + 1e-3:
                search_errors += 1
            nbest = rescore_nbest_with_ngram(results_to_nbest(res), lm_full)
            best = max(nbest, key=lambda t: CFG["acoustic_scale"] * t[1] + t[2])
            rescued += best[0] == sent
        tw, ow = sent.split(), top1.split()
        homophone_misses += len(tw) == len(ow) and all(
            a == b or pron_of.get(a) == pron_of.get(b) for a, b in zip(tw, ow))
    return dict(exact=exact, in_pool=in_pool, rescued=rescued, search_errors=search_errors,
                homophone_misses=homophone_misses)


def test_decode_quality_and_pool_rescue(world):
    """The port's native searcher and its rescore give the JAX package's
    counts on all 24 utterances, and hold that test's bounds."""
    lexicon, lm, lm_full, arpa, arpa_full, lexp, utts, (jlex, _) = world
    ours = pool_stats(NativeLexiconBeamSearch(arpa, lexp, DecodeConfig(**CFG), max_homophones=H),
                      lexicon, lm_full, utts)
    ref = pool_stats(JaxNative(arpa, lexp, JaxDecodeConfig(**CFG), max_homophones=H),
                     jlex, lm_full, utts)
    assert ours == ref
    n, misses = len(utts), len(utts) - ours["exact"]
    assert ours["in_pool"] >= int(0.9 * n) and ours["search_errors"] == 0
    assert ours["homophone_misses"] >= int(0.8 * misses) and ours["exact"] >= int(0.3 * n)


def test_close_probe_top_guard(world):
    """The port's device searcher with the unpruned pool rescore: probing
    only the top 2 homophones gives exact probing's top-1 (or an exact
    tie) and the same scores for shared candidates."""
    lexicon, lm, lm_full, arpa, arpa_full, lexp, utts, _ = world
    cfg = DecodeConfig(**CFG)
    batch = batch_of(utts)
    exact = DeviceLexiconBeamSearch(lexicon, lm, cfg, max_homophones=H, rescore_lm=lm_full,
                                    device="cpu").decode_batch(*batch)
    capped = DeviceLexiconBeamSearch(lexicon, lm, cfg, max_homophones=H, rescore_lm=lm_full,
                                     close_probe_top=2, device="cpu").decode_batch(*batch)
    for i, (e, c) in enumerate(zip(exact, capped)):
        assert e and c
        assert e[0].sentence == c[0].sentence or abs(total(e[0]) - total(c[0])) < 1e-3, i
        de, dc = {r.sentence: total(r) for r in e}, {r.sentence: total(r) for r in c}
        for s in set(de) & set(dc):
            assert abs(de[s] - dc[s]) < 1e-3, (i, s)
