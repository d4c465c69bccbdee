"""Three-way cross-check of the port's searcher backends, as
tests/test_searcher_crosscheck.py does for the JAX package: the python oracle
(decode/lmbeam.py), the native C++ decoder (runtime/decoder.cc) and the
device searcher (decode/lmbeam_device.py, on the CPU here) over the same
logits and randomized DecodeConfig knobs; the native lattice n-best against
the python oracle; and DecoderService called with the JAX package's
signature (``arpa_path``, ``lexicon_path``) in both packages."""

import shutil

import numpy as np
import pytest

from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.serve import DecoderService as JaxDecoderService
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch.data.synthetic import ctc_logprobs
from b2txt_tpu_torch.decode.lattice import forced_rank
from b2txt_tpu_torch.decode.lmbeam import LexiconBeamSearch
from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.runtime import NativeLexiconBeamSearch, write_lexicon
from b2txt_tpu_torch.serve import DecoderService
from b2txt_tpu_torch.utils.config import DecodeConfig
from b2txt_tpu_torch.utils.phonemes import LOGIT_TO_PHONEME

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
    "a": ["AH"],
}
CORPUS = [
    "the cat sat on the mat".split(),
    "there is the cat".split(),
    "the cat is there".split(),
    "there is a mat".split(),
    "the cat sat on the hat".split(),
    "a hat is on the mat".split(),
] * 3


def write_world(tmp, lexicon, lm):
    """The LM as ARPA and the lexicon as the C++ loader reads it."""
    arpa, lexp = str(tmp / "lm.arpa"), str(tmp / "lexicon.txt")
    lm.to_arpa(arpa)
    write_lexicon(lexicon, lexp)
    return arpa, lexp


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    lexicon = Lexicon.from_words(LEX)
    lm = train_ngram(CORPUS, order=3)
    arpa, lexp = write_world(tmp_path_factory.mktemp("xcheck"), lexicon, lm)
    return lexicon, lm, arpa, lexp


def noisy_logprobs(ids, seed, hot=4.0, noise=0.6, frames_per=3):
    rng = np.random.default_rng(seed)
    rows = []
    for pid in ids:
        for _ in range(frames_per):
            row = np.full(41, -hot, np.float32)
            row[pid] = 0.0
            rows.append(row)
        blank = np.full(41, -hot, np.float32)
        blank[0] = 0.0
        rows.append(blank)
    lp = np.stack(rows) + noise * rng.standard_normal((len(rows), 41)).astype(np.float32)
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


# the knob sweep of tests/test_searcher_crosscheck.py
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


@pytest.mark.parametrize("knobs", CONFIGS)
def test_three_way_agreement(setup, knobs):
    lexicon, lm, arpa, lexp = setup
    cfg = DecodeConfig(nbest=5, beam_width=64, **knobs)
    native = NativeLexiconBeamSearch(arpa, lexp, cfg)
    device = DeviceLexiconBeamSearch(lexicon, lm, cfg, device="cpu")
    for si, sent in enumerate(["there is the cat", "the cat sat on the mat"]):
        lp = noisy_logprobs(lexicon.sentence_to_phonemes(sent), seed=100 + si)
        host = LexiconBeamSearch(lexicon, lm, cfg)
        host.decode(lp)
        r_host = host.finish_decoding()
        native.reset()
        native.decode(lp)
        r_native = native.finish_decoding()
        device.reset()
        device.decode(lp)
        r_device = device.finish_decoding()

        assert r_host and r_native and r_device
        assert r_native[0].sentence == r_host[0].sentence
        assert r_device[0].sentence == r_host[0].sentence
        np.testing.assert_allclose(r_native[0].lm_score, r_host[0].lm_score, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r_native[0].ac_score, r_host[0].ac_score, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r_device[0].lm_score, r_host[0].lm_score, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(r_device[0].ac_score, r_host[0].ac_score, rtol=1e-3, atol=1e-3)


def test_homophone_cap_drop_policy_crosschecked(tmp_path):
    """A homophone class larger than max_homophones: all three backends drop
    the same members, the least likely by unigram."""
    lex_words = {"vfreq": ["V", "IY"], "vmid1": ["V", "IY"], "vmid2": ["V", "IY"],
                 "vrare": ["V", "IY"], "the": ["DH", "AH"], "cat": ["K", "AE", "T"]}
    corpus = (["the vfreq cat".split()] * 12 + ["the vmid1 cat".split()] * 6
              + ["the vmid2 cat".split()] * 3 + ["the vrare cat".split()] * 1
              + ["the cat".split()] * 2)
    lexicon = Lexicon.from_words(lex_words)
    lm = train_ngram(corpus, order=2)
    arpa, lexp = write_world(tmp_path, lexicon, lm)
    cfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=48,
                       beam=0.0, sum_mode=False)
    searchers = {"host": LexiconBeamSearch(lexicon, lm, cfg, max_homophones=2),
                 "native": NativeLexiconBeamSearch(arpa, lexp, cfg, max_homophones=2),
                 "device": DeviceLexiconBeamSearch(lexicon, lm, cfg, max_homophones=2,
                                                   device="cpu")}
    lp = noisy_logprobs(lexicon.sentence_to_phonemes("the vfreq cat"), seed=5, noise=0.3)
    outs = {}
    for name, s in searchers.items():
        s.reset()
        s.decode(lp)
        outs[name] = s.finish_decoding()
    sents = {name: [r.sentence for r in rs] for name, rs in outs.items()}
    assert sents["host"] == sents["native"] == sents["device"], sents
    joined = " ".join(sents["host"])
    assert "vfreq" in joined and "vmid1" in joined
    assert "vrare" not in joined and "vmid2" not in joined
    for name in ("native", "device"):
        np.testing.assert_allclose([r.lm_score for r in outs[name][:3]],
                                   [r.lm_score for r in outs["host"][:3]], rtol=1e-4, atol=1e-4)


def test_finalize_length_penalty_open_word(setup):
    """length_penalty != 0 with the utterance cut mid-word: the closing word
    gets length_penalty in all three backends."""
    lexicon, lm, arpa, lexp = setup
    cfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=48, beam=0.0,
                       length_penalty=0.7, sum_mode=False)
    lp = noisy_logprobs(lexicon.sentence_to_phonemes("the cat")[:-1], seed=9, noise=0.2)
    searchers = {"host": LexiconBeamSearch(lexicon, lm, cfg),
                 "native": NativeLexiconBeamSearch(arpa, lexp, cfg),
                 "device": DeviceLexiconBeamSearch(lexicon, lm, cfg, device="cpu")}
    outs = {}
    for name, s in searchers.items():
        s.reset()
        s.decode(lp)
        outs[name] = s.finish_decoding()
    assert outs["host"][0].sentence == "the cat"
    for name in ("native", "device"):
        assert [r.sentence for r in outs[name][:3]] == [r.sentence for r in outs["host"][:3]]
        np.testing.assert_allclose([r.lm_score for r in outs[name][:3]],
                                   [r.lm_score for r in outs["host"][:3]], rtol=1e-4, atol=1e-4)


def _rank(cfg, c):
    return cfg.acoustic_scale * c.ac_score + c.lm_score


def test_native_lattice_matches_python_oracle(tmp_path):
    """The C++ lattice n-best (the production deep-nbest path) gives the
    python oracle's list: same depth, same sentences, ranks within float32
    tolerance, and no candidate above its forced-alignment oracle."""
    rng = np.random.default_rng(0)
    phones = LOGIT_TO_PHONEME[1:40]
    words = {}
    while len(words) < 500:
        pron = [phones[i] for i in rng.integers(0, 39, rng.integers(3, 8))]
        words["w" + "".join(p.lower() for p in pron)] = pron
    wl = list(words)
    lex = Lexicon.from_words(words)
    sents = [" ".join(wl[i] for i in rng.integers(0, 500, 4)) for _ in range(40)]
    lm = train_ngram([s.split() for s in sents], order=3)
    wid = {w: i for i, w in enumerate(lex.words)}
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=40, beam_width=256,
                       lattice_beam=10.0, first_beam_size=8, sum_mode=False, lattice_nbest=True)
    py = LexiconBeamSearch(lex, lm, cfg, max_homophones=4, state_key="ngram")
    arpa, lexp = write_world(tmp_path, lex, lm)
    nat = NativeLexiconBeamSearch(arpa, lexp, cfg, max_homophones=4, state_key="ngram")
    for sent in sents[:3]:
        lp = ctc_logprobs(rng, lex.sentence_to_phonemes(sent), noise=2.0)
        py.reset()
        py.decode(lp)
        rp = py.finish_decoding()
        nat.reset()
        nat.decode(lp)
        rn = nat.finish_decoding()
        assert rp[0].sentence == rn[0].sentence
        assert len(rp) == len(rn)
        pd = {c.sentence: _rank(cfg, c) for c in rp}
        nd = {c.sentence: _rank(cfg, c) for c in rn}
        assert set(pd) == set(nd)
        for s in pd:
            assert abs(pd[s] - nd[s]) < 1e-4, (s, pd[s], nd[s])
        for c in rn[:10]:
            f = forced_rank(lp, [wid[w] for w in c.sentence.split()], lex, lm, cfg)
            assert _rank(cfg, c) <= f + 1e-4


def test_service_lattice_mode_refuses_sum_mode_and_the_device_searcher(setup):
    lexicon, lm, arpa, lexp = setup
    cfg = DecodeConfig(nbest=10, beam_width=64, sum_mode=False, lattice_nbest=True)
    svc = DecoderService(lexicon, lm, cfg, searcher_backend="native",
                         arpa_path=arpa, lexicon_path=lexp)
    assert svc.searcher.state_key == "ngram"
    with pytest.raises(ValueError, match="lattice_nbest"):
        DecoderService(lexicon, lm, cfg, searcher_backend="device")
    with pytest.raises(ValueError, match="sum_mode"):
        DecoderService(lexicon, lm, cfg.replace(sum_mode=True), searcher_backend="native",
                       arpa_path=arpa, lexicon_path=lexp)


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_reference_signature_in_both_packages(setup, backend, call):
    """DecoderService(lexicon, lm, config, rescore_lm, llm, channel_order,
    searcher_backend, arpa_path, lexicon_path, ...) — the JAX package's
    argument order — gives the same FinalOutput in both packages, and the
    native searcher reads the files it was given."""
    lexicon, lm, arpa, lexp = setup
    knobs = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=64, rescore=True)
    jlex, jlm = JaxLexicon.from_words(LEX), jax_train_ngram(CORPUS, order=3)
    rescore, jrescore = train_ngram(CORPUS, order=2), jax_train_ngram(CORPUS, order=2)
    if call == "positional":
        svc = DecoderService(lexicon, lm, DecodeConfig(**knobs), rescore, None, "model",
                             backend, arpa, lexp)
        jsvc = JaxDecoderService(jlex, jlm, JaxDecodeConfig(**knobs), jrescore, None, "model",
                                 backend, arpa, lexp)
    else:
        svc = DecoderService(lexicon, lm, config=DecodeConfig(**knobs), rescore_lm=rescore,
                             channel_order="model", searcher_backend=backend,
                             arpa_path=arpa, lexicon_path=lexp)
        jsvc = JaxDecoderService(jlex, jlm, config=JaxDecodeConfig(**knobs),
                                 rescore_lm=jrescore, channel_order="model",
                                 searcher_backend=backend, arpa_path=arpa, lexicon_path=lexp)
    assert type(svc.searcher).__name__ == type(jsvc.searcher).__name__
    for si, sent in enumerate(["there is the cat", "the cat sat on the mat"]):
        lp = noisy_logprobs(lexicon.sentence_to_phonemes(sent), seed=200 + si)
        out, jout = svc.decode_utterance(lp, chunk=5), jsvc.decode_utterance(lp, chunk=5)
        assert out.sentence == jout.sentence == sent
        if backend == "native":
            assert vars(out) == vars(jout)
        else:
            assert [r[0] for r in out.nbest] == [r[0] for r in jout.nbest]
            np.testing.assert_allclose(np.array([r[1:] for r in out.nbest]),
                                       np.array([r[1:] for r in jout.nbest]), atol=1e-6)
