"""Synthetic session generation for tests and benchmarks.

No real t15 data ships with this image (the reference downloads ~45 HDF5
sessions from Dryad — download_data.py:44-107), so tests and benches use
synthetic sessions written in the exact reference HDF5 layout. Features carry a
planted linear phoneme code so a small model can actually learn the mapping
(loss decreases, PER drops), which exercises the full train/eval path.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .hdf5_store import write_session_file

_WORDS = [
    ("hello", [16, 11, 21, 25]),          # HH EH L OW
    ("world", [36, 12, 21, 9]),           # W ER L D
    ("brain", [7, 28, 13, 23]),           # B R EY N
    ("text", [31, 11, 20, 29, 31]),       # T EH K S T
    ("good", [15, 33, 9]),                # G UH D
    ("day", [9, 13]),                     # D EY
]
SIL = 40


def word_pronunciations() -> Dict[str, List[str]]:
    """{word: phone strings} for the synthetic vocabulary (lexicon building)."""
    from ..utils.phonemes import LOGIT_TO_PHONEME

    return {w: [LOGIT_TO_PHONEME[i] for i in ids] for w, ids in _WORDS}


def sentence_corpus(n: int = 50, seed: int = 7) -> List[List[str]]:
    """Random sentences over the synthetic vocabulary (LM training corpus)."""
    rng = np.random.default_rng(seed)
    return [make_sentence(rng, int(rng.integers(2, 5)))[0].split() for _ in range(n)]


def make_sentence(rng: np.random.Generator, n_words: int = 3):
    """Random word sequence → (sentence string, phoneme id sequence with SIL
    at word ends, model output order)."""
    words = [_WORDS[i] for i in rng.integers(0, len(_WORDS), n_words)]
    text = " ".join(w for w, _ in words)
    ids: List[int] = []
    for _, ph in words:
        ids.extend(ph)
        ids.append(SIL)
    return text, ids


def ctc_logprobs(
    rng: np.random.Generator,
    phoneme_ids: Sequence[int],
    n_classes: int = 41,
    hot: float = 10.0,
    noise: float = 0.5,
    min_hot_frames: int = 1,
    max_hot_frames: int = 3,
    min_blank_run: int = 2,
    max_blank_run: int = 6,
    blank: int = 0,
) -> np.ndarray:
    """Synthetic CTC posteriors with *trained-model* temporal statistics.

    A trained CTC model emits a 1–2 frame spike per phoneme and blank
    everywhere else (~2/3 of frames blank-dominated at 20 ms bins) — that
    blank dominance is what makes the reference's blank-skip trick pay
    (ctc_wfst_beam_search.cc:86-95). Earlier bench fixtures used a fixed
    2-hot+1-blank pattern with no blank runs, which understates skipping and
    overstates per-sentence decode cost. Returns (T, n_classes) log-probs.
    """
    rows: List[np.ndarray] = []

    def blanks(n: int) -> None:
        for _ in range(n):
            r = np.full(n_classes, -hot, np.float32)
            r[blank] = 0.0
            rows.append(r)

    blanks(int(rng.integers(min_blank_run, max_blank_run + 1)))  # lead silence
    for pid in phoneme_ids:
        for _ in range(int(rng.integers(min_hot_frames, max_hot_frames + 1))):
            r = np.full(n_classes, -hot, np.float32)
            r[pid] = 0.0
            rows.append(r)
        blanks(int(rng.integers(min_blank_run, max_blank_run + 1)))
    lp = np.stack(rows)
    if noise:
        lp = lp + noise * rng.standard_normal(lp.shape).astype(np.float32)
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def synth_features(
    rng: np.random.Generator,
    phoneme_ids: Sequence[int],
    neural_dim: int = 64,
    frames_per_phoneme: int = 8,
    noise: float = 0.3,
    code: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Neural features = per-phoneme random code + white noise."""
    if code is None:
        code = phoneme_code(neural_dim)
    frames = []
    for p in phoneme_ids:
        frames.append(np.tile(code[p], (frames_per_phoneme, 1)))
    x = np.concatenate(frames, axis=0)
    return (x + noise * rng.standard_normal(x.shape)).astype(np.float32)


def phoneme_code(neural_dim: int, n_classes: int = 41, seed: int = 123) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_classes, neural_dim)).astype(np.float32)


def write_synthetic_sessions(
    root: str,
    sessions: Sequence[str],
    trials_per_session: int = 12,
    neural_dim: int = 64,
    seed: int = 0,
    splits: Sequence[str] = ("train", "val"),
    min_words: int = 2,
    max_words: int = 4,
    frames_per_phoneme: int = 8,
) -> Dict[str, str]:
    """Write data_{split}.hdf5 per session under root/<session>/, reference
    layout. min/max_words and frames_per_phoneme size the trials (the
    full-input training bench uses reference-length ~350-bin utterances at
    neural_dim=512)."""
    code = phoneme_code(neural_dim)
    paths = {}
    for si, session in enumerate(sessions):
        for split in splits:
            rng = np.random.default_rng(seed + 1000 * si + hash(split) % 997)
            trials = []
            for t in range(trials_per_session):
                text, ids = make_sentence(
                    rng, n_words=int(rng.integers(min_words, max_words + 1))
                )
                feats = synth_features(
                    rng, ids, neural_dim, code=code,
                    frames_per_phoneme=frames_per_phoneme,
                )
                transcription = np.zeros(500, np.uint8)
                raw = text.encode()[:499]
                transcription[: len(raw)] = np.frombuffer(raw, np.uint8)
                trials.append(
                    dict(
                        input_features=feats,
                        seq_class_ids=np.asarray(ids, np.int32),
                        transcription=transcription,
                        block_num=t // 4,
                        trial_num=t,
                        session=session,
                        sentence_label=text,
                    )
                )
            path = os.path.join(root, session, f"data_{split}.hdf5")
            write_session_file(path, trials)
            paths[f"{session}/{split}"] = path
    return paths


def synthetic_trials(
    sessions: Sequence[str],
    trials_per_session: int = 12,
    neural_dim: int = 64,
    seed: int = 0,
    split: str = "train",
    min_words: int = 2,
    max_words: int = 4,
    frames_per_phoneme: int = 8,
    max_bins: Optional[int] = None,
) -> Dict[int, list]:
    """In-memory sessions: {day: [Trial, ...]}, drawn as
    ``write_synthetic_sessions`` draws the trials of one split (no HDF5, so
    no h5py). ``max_bins`` redraws any trial longer than that many bins."""
    from .hdf5_store import Trial

    code = phoneme_code(neural_dim)
    out: Dict[int, list] = {}
    for si, session in enumerate(sessions):
        rng = np.random.default_rng(seed + 1000 * si + hash(split) % 997)
        trials = []
        while len(trials) < trials_per_session:
            t = len(trials)
            text, ids = make_sentence(rng, n_words=int(rng.integers(min_words, max_words + 1)))
            feats = synth_features(rng, ids, neural_dim, code=code,
                                   frames_per_phoneme=frames_per_phoneme)
            if max_bins is not None and feats.shape[0] > max_bins:
                continue
            transcription = np.zeros(500, np.uint8)
            raw = text.encode()[:499]
            transcription[: len(raw)] = np.frombuffer(raw, np.uint8)
            trials.append(Trial(
                input_features=feats, seq_class_ids=np.asarray(ids, np.int32),
                transcription=transcription, n_time_steps=feats.shape[0], seq_len=len(ids),
                block_num=t // 4, trial_num=t, session=session, sentence_label=text,
            ))
        out[si] = trials
    return out
