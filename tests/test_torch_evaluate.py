"""Session evaluation in the port (``evaluate/harness.py``) against the JAX
package's: the same synthetic HDF5 sessions (written once, in this process)
and the same random-init weights (carried across with ``params_from_jax``,
no training) give the same greedy ids, logits within 1e-4 in f32, and the
same greedy PER, day PER and WER with the python and the native searchers;
plus the device-resident mode, single-trial decoding, the competition CSV,
the day index of a session subset and g2p references."""

import shutil

import jax
import numpy as np
import pytest

from b2txt_tpu.data import synthetic as jax_synthetic
from b2txt_tpu.evaluate import evaluate_sessions as jax_evaluate_sessions
from b2txt_tpu.evaluate import run_single_decoding_step as jax_run_single_decoding_step
from b2txt_tpu.evaluate import write_competition_csv as jax_write_competition_csv
from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.models import init_params_from_config
from b2txt_tpu.serve import DecoderService as JaxDecoderService
from b2txt_tpu.utils import TrainConfig as JaxTrainConfig
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu.utils.g2p import sentence_to_phoneme_ids as jax_sentence_to_phoneme_ids
from b2txt_tpu_torch.data import synthetic
from b2txt_tpu_torch.data.hdf5_store import load_session_file
from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
from b2txt_tpu_torch.evaluate import (evaluate_session_data, evaluate_sessions,
                                      run_single_decoding_step, write_competition_csv)
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.models import GRUDecoder, params_from_jax
from b2txt_tpu_torch.serve import DecoderService
from b2txt_tpu_torch.utils import TrainConfig
from b2txt_tpu_torch.utils.config import DecodeConfig
from b2txt_tpu_torch.utils.g2p import sentence_to_phoneme_ids

SESSIONS = ["t15.2023.08.11", "t15.2023.08.13", "t15.2023.08.18"]
TRIALS = 8
DECODE = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=32)


def small(cfg):
    cfg.model.n_input_features = cfg.dataset.neural_dim = 16
    cfg.model.n_units, cfg.model.n_layers = 64, 2
    cfg.dataset.sessions = list(SESSIONS)
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Sessions on disk, both packages' models with the same weights, and
    the LM world as objects and as files for the native searcher."""
    tmp = tmp_path_factory.mktemp("eval")
    jax_synthetic.write_synthetic_sessions(str(tmp), SESSIONS, trials_per_session=TRIALS,
                                           neural_dim=16)
    jcfg, cfg = small(JaxTrainConfig()), small(TrainConfig())
    jparams = init_params_from_config(jax.random.PRNGKey(3), jcfg.model, n_days=3, n_classes=41)
    # make the day layers differ, so a wrong day index shows
    jparams["day_w"] = jparams["day_w"].at[1].multiply(1.7).at[2].multiply(-0.6)
    model = GRUDecoder(cfg.model, 3, 41, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    lexicon = Lexicon.from_words(synthetic.word_pronunciations())
    lm = train_ngram(synthetic.sentence_corpus(100), order=3)
    arpa, lexp = str(tmp / "lm.arpa"), str(tmp / "lexicon.txt")
    lm.to_arpa(arpa)
    with open(lexp, "w") as f:
        for w, pron in synthetic.word_pronunciations().items():
            f.write(f"{w.upper()}  {' '.join(p.rstrip('012') for p in pron)}\n")
    return dict(data_dir=str(tmp), jcfg=jcfg, cfg=cfg, jparams=jparams, model=model,
                lexicon=lexicon, lm=lm, arpa=arpa, lexp=lexp)


def services(w, backend):
    files = dict(arpa_path=w["arpa"], lexicon_path=w["lexp"]) if backend == "native" else {}
    svc = DecoderService(w["lexicon"], w["lm"], DecodeConfig(**DECODE), channel_order="model",
                         searcher_backend=backend, **files)
    jsvc = JaxDecoderService(
        JaxLexicon.from_words(jax_synthetic.word_pronunciations()),
        jax_train_ngram(jax_synthetic.sentence_corpus(100), order=3),
        JaxDecodeConfig(**DECODE), channel_order="model", searcher_backend=backend, **files)
    return svc, jsvc


def assert_same_trials(trials, jtrials, n_sessions=len(SESSIONS)):
    assert len(trials) == len(jtrials) == n_sessions * TRIALS
    for t, j in zip(trials, jtrials):
        assert (t.session, t.day_idx, t.block_num, t.trial_num) == (
            j.session, j.day_idx, j.block_num, j.trial_num)
        assert t.decoded_ids == j.decoded_ids
        assert t.true_ids == j.true_ids and t.sentence_label == j.sentence_label
        assert t.logits.shape == j.logits.shape
        np.testing.assert_allclose(t.logits, j.logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batched", [True, False])
def test_greedy_eval_matches_jax(world, batched):
    """Batched (all sessions) and one trial at a time (one session: the JAX
    package compiles its forward for every trial length)."""
    w = world
    sessions = SESSIONS if batched else SESSIONS[1:2]
    out = evaluate_sessions(w["model"], w["cfg"], w["data_dir"], sessions=sessions,
                            batched=batched)
    jout = jax_evaluate_sessions(w["jparams"], w["jcfg"], w["data_dir"], sessions=sessions,
                                 batched=batched)
    assert_same_trials(out["trials"], jout["trials"], len(sessions))
    assert [t.day_idx for t in out["trials"][::TRIALS]] == [SESSIONS.index(s) for s in sessions]
    assert out["greedy_PER"] == jout["greedy_PER"]
    assert out["day_PER"] == jout["day_PER"] and set(out["day_PER"]) == set(sessions)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")
@pytest.mark.parametrize("backend", ["python", "native"])
def test_lm_decode_and_wer_match_jax(world, backend):
    w = world
    svc, jsvc = services(w, backend)
    out = evaluate_sessions(w["model"], w["cfg"], w["data_dir"], decoder=svc)
    jout = jax_evaluate_sessions(w["jparams"], w["jcfg"], w["data_dir"], decoder=jsvc)
    assert_same_trials(out["trials"], jout["trials"])
    assert [t.decoded_sentence for t in out["trials"]] == [t.decoded_sentence for t in jout["trials"]]
    assert all(t.decoded_sentence is not None for t in out["trials"])
    assert (out["greedy_PER"], out["day_PER"]) == (jout["greedy_PER"], jout["day_PER"])
    assert (out["WER"], out["WER_CI"]) == (jout["WER"], jout["WER_CI"])
    assert out["sentences_per_sec"] > 0


def test_device_resident_matches_host_path(world):
    """device_resident=True with the device searcher (on the CPU here): the
    posteriors stay on the model's device and give the host path's greedy
    ids and sentences."""
    w = world
    cfg = DecodeConfig(**DECODE)
    svc = DecoderService(w["lexicon"], w["lm"], cfg, channel_order="model",
                         searcher_backend="device",
                         searcher=DeviceLexiconBeamSearch(w["lexicon"], w["lm"], cfg, device="cpu"))
    a = evaluate_sessions(w["model"], w["cfg"], w["data_dir"], decoder=svc,
                          sessions=SESSIONS[:2], device_resident=True)
    b = evaluate_sessions(w["model"], w["cfg"], w["data_dir"], decoder=svc, sessions=SESSIONS[:2])
    assert len(a["trials"]) == len(b["trials"]) == 2 * TRIALS
    for ta, tb in zip(a["trials"], b["trials"]):
        assert ta.logits is None and tb.logits is not None
        assert ta.decoded_ids == tb.decoded_ids
        assert ta.decoded_sentence == tb.decoded_sentence
    assert a["greedy_PER"] == b["greedy_PER"] and a["WER"] == b["WER"]


def test_device_resident_requires_device_backend(world):
    w = world
    svc = DecoderService(w["lexicon"], w["lm"], DecodeConfig(nbest=5, beam_width=16),
                         channel_order="model")
    with pytest.raises(ValueError, match="device_resident"):
        evaluate_sessions(w["model"], w["cfg"], w["data_dir"], sessions=SESSIONS[:1],
                          decoder=svc, device_resident=True)


def test_run_single_decoding_step_matches_jax(world):
    w = world
    data = load_session_file(f"{w['data_dir']}/{SESSIONS[1]}/data_val.hdf5")
    for x in data["neural_features"][:3]:
        got = run_single_decoding_step(w["model"], x, 1, w["cfg"])
        want = jax_run_single_decoding_step(w["jparams"], x, 1, w["jcfg"])
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_competition_csv_is_byte_equal(world, tmp_path):
    w = world
    out = evaluate_sessions(w["model"], w["cfg"], w["data_dir"], sessions=SESSIONS[:1])
    jout = jax_evaluate_sessions(w["jparams"], w["jcfg"], w["data_dir"], sessions=SESSIONS[:1])
    for i, (t, j) in enumerate(zip(out["trials"], jout["trials"])):
        t.decoded_sentence = j.decoded_sentence = ("hello, world" if i % 3 else "") + f" {i}"
    write_competition_csv(out["trials"], str(tmp_path / "ours" / "submission.csv"))
    jax_write_competition_csv(jout["trials"], str(tmp_path / "jax" / "submission.csv"))
    ours = (tmp_path / "ours" / "submission.csv").read_bytes()
    assert ours == (tmp_path / "jax" / "submission.csv").read_bytes()
    assert len(ours.decode().splitlines()) == TRIALS + 1


def test_harness_day_index_uses_training_list(world):
    """Evaluating a subset feeds the model the session's training-day index,
    not its position in the subset."""
    w = world
    full = evaluate_sessions(w["model"], w["cfg"], w["data_dir"])
    sub = evaluate_sessions(w["model"], w["cfg"], w["data_dir"], sessions=[SESSIONS[2]])
    third = [t for t in full["trials"] if t.session == SESSIONS[2]]
    assert len(third) == len(sub["trials"]) == TRIALS
    for a, b in zip(third, sub["trials"]):
        assert b.day_idx == 2
        np.testing.assert_allclose(a.logits, b.logits, rtol=1e-5)


def test_session_data_in_memory_equals_the_file_read(world):
    """evaluate_session_data on the columns load_session_file returns gives
    evaluate_sessions' output; trials with a transcript only get a g2p
    phoneme reference, the JAX package's."""
    w = world
    data = {s: load_session_file(f"{w['data_dir']}/{s}/data_val.hdf5") for s in SESSIONS}
    mem = evaluate_session_data(w["model"], w["cfg"], data.items())
    disk = evaluate_sessions(w["model"], w["cfg"], w["data_dir"])
    for a, b in zip(mem["trials"], disk["trials"]):
        assert a.decoded_ids == b.decoded_ids and a.true_ids == b.true_ids
        np.testing.assert_array_equal(a.logits, b.logits)
    assert mem["greedy_PER"] == disk["greedy_PER"]

    data[SESSIONS[0]]["seq_class_ids"] = [None] * TRIALS
    g2p = evaluate_session_data(w["model"], w["cfg"], [(SESSIONS[0], data[SESSIONS[0]])])
    for t, label in zip(g2p["trials"], data[SESSIONS[0]]["sentence_label"]):
        assert t.true_ids == jax_sentence_to_phoneme_ids(label)


OOV_SENTENCES = [
    "The quixotic zebra's jumped, bewilderingly!",
    "hello world",
    "Xylophonists strengthened their photosynthesis-related hypotheses.",
    "",
    "schmoozing at brunchtime — overexplained",
]


@pytest.mark.parametrize("sentence", OOV_SENTENCES)
def test_sentence_to_phoneme_ids_matches_jax(sentence):
    assert sentence_to_phoneme_ids(sentence) == jax_sentence_to_phoneme_ids(sentence)
