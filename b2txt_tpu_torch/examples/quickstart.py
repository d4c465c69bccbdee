#!/usr/bin/env python
"""First five minutes with b2txt_tpu_torch, end to end on synthetic data.

Counterpart of ``examples/quickstart.py``. Mirrors the reference's full user
flow (train_model.py → evaluate_model.py → language-model-standalone.py) in
one runnable file:

  1. write reference-layout HDF5 sessions (synthetic: no t15 data needed)
  2. train a small day-adapted GRU with CTC (``Trainer``)
  3. build a 3-gram LM + lexicon from the corpus
  4. decode the val split with the lexicon+n-gram beam search through
     ``DecoderService`` (the language-model-standalone equivalent)
  5. report greedy PER and decoded WER, write the competition CSV

    python -m b2txt_tpu_torch.examples.quickstart [--device cpu]

Training and the model forward run on the CUDA card unless ``--device cpu``
is given; the beam search runs on the host. Each step is a function
(``write_data`` → ``make_config`` → ``train`` → ``decode_and_score``), so a
caller can train elsewhere, or hold the sessions in memory where h5py is
absent (``memory_data``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..data import synthetic
from ..evaluate import evaluate_session_data, evaluate_sessions, write_competition_csv
from ..lm import Lexicon, train_ngram
from ..lm.lexicon import strip_stress
from ..serve import DecoderService
from ..train import Trainer
from ..utils import TrainConfig
from ..utils.config import DecodeConfig, ModelConfig

SESSIONS = ["t15.2023.08.11", "t15.2023.08.13"]
TRIALS_PER_SESSION = 24


def write_data(root: str, neural_dim: int = 16) -> None:
    """Reference-layout sessions (data_train.hdf5 + data_val.hdf5) under
    ``root``. Needs h5py."""
    synthetic.write_synthetic_sessions(
        root, SESSIONS, trials_per_session=TRIALS_PER_SESSION, neural_dim=neural_dim,
        splits=("train", "val"),
    )


def session_columns(trials_by_day, sessions: Sequence[str]) -> List:
    """{day: [Trial, ...]} as the (session, columns) pairs that
    ``evaluate_session_data`` reads (the columns of ``load_session_file``)."""
    columns = []
    for day, trials in sorted(trials_by_day.items()):
        columns.append((sessions[day], {
            "neural_features": [t.input_features for t in trials],
            "n_time_steps": [t.n_time_steps for t in trials],
            "seq_class_ids": [t.seq_class_ids for t in trials],
            "seq_len": [t.seq_len for t in trials],
            "transcriptions": [t.transcription for t in trials],
            "sentence_label": [t.sentence_label for t in trials],
            "session": [t.session for t in trials],
            "block_num": [t.block_num for t in trials],
            "trial_num": [t.trial_num for t in trials],
        }))
    return columns


def memory_data(neural_dim: int = 16):
    """The trials ``write_data`` writes, held in memory (no h5py): (train
    trials, val trials) as {day: [Trial, ...]} for ``Trainer``, and the val
    split as (session, columns) pairs for ``decode_and_score``."""
    train = synthetic.synthetic_trials(SESSIONS, TRIALS_PER_SESSION, neural_dim, split="train")
    val = synthetic.synthetic_trials(SESSIONS, TRIALS_PER_SESSION, neural_dim, split="val")
    return train, val, session_columns(val, SESSIONS)


def make_config(root: str, n_batches: int = 300,
                model: Optional[ModelConfig] = None) -> TrainConfig:
    """TrainConfig mirrors every rnn_args.yaml knob. Here: a small model
    (16 features, 2 × 48 GRU, optimizer epsilon 1e-8) so CPU training stays
    fast, unless ``model`` gives another (its feature count sets the data's;
    epsilon stays the reference's 0.1)."""
    cfg = TrainConfig()
    if model is None:
        cfg.model.n_input_features = 16
        cfg.model.n_units = 48
        cfg.model.n_layers = 2
        cfg.epsilon = 1e-8  # tiny-model tweak; keep the reference 0.1 at full size
    else:
        cfg.model = model
    cfg.model.rnn_dropout = 0.0
    cfg.model.input_network.input_layer_dropout = 0.0
    cfg.dataset.neural_dim = cfg.model.n_input_features
    cfg.dataset.sessions = list(SESSIONS)
    cfg.dataset.dataset_probability_val = [1] * len(SESSIONS)
    cfg.dataset.batch_size = 8
    cfg.dataset.days_per_batch = 2
    cfg.dataset.dataset_dir = root
    cfg.num_training_batches = n_batches
    cfg.lr_decay_steps = n_batches
    cfg.lr_decay_steps_day = n_batches
    cfg.lr_warmup_steps = 10
    cfg.lr_warmup_steps_day = 10
    cfg.batches_per_train_log = max(1, n_batches // 3)
    cfg.batches_per_val_step = max(1, n_batches // 2)
    cfg.use_amp = False
    cfg.output_dir = os.path.join(root, "out")
    cfg.checkpoint_dir = os.path.join(root, "out", "checkpoint")
    return cfg


def train(cfg: TrainConfig, device: Union[str, torch.device, None] = None,
          train_trials=None, val_trials=None) -> Tuple[Trainer, Dict]:
    """Train ``cfg.num_training_batches`` steps; returns the trainer and its
    statistics."""
    t0 = time.time()
    trainer = Trainer(cfg, device=device, train_trials=train_trials, val_trials=val_trials)
    stats = trainer.train()
    print(f"trained {cfg.num_training_batches} batches in "
          f"{time.time() - t0:.0f}s; best val PER "
          f"{min(stats['val_PERs']):.3f}")
    return trainer, stats


def build_decoder(root: str) -> DecoderService:
    """The LM + lexicon from the corpus (in place of SRILM + T∘L∘G) behind a
    ``DecoderService`` with the python searcher."""
    lexicon = Lexicon.from_words(synthetic.word_pronunciations())
    lm = train_ngram(synthetic.sentence_corpus(200), order=3)
    lm.to_arpa(os.path.join(root, "lm.arpa"))
    with open(os.path.join(root, "lexicon.txt"), "w") as f:
        for w, pron in synthetic.word_pronunciations().items():
            f.write(f"{w.upper()}  {' '.join(strip_stress(pron))}\n")
    # searcher_backend switches the same semantics between "python" (host
    # oracle), "native" (C++) and "device" (on the card)
    dcfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, nbest=10, beam_width=64)
    return DecoderService(lexicon, lm, dcfg, channel_order="model",
                          searcher_backend="python")


def decode_and_score(model, cfg: TrainConfig, root: str, decoder: DecoderService,
                     session_data: Optional[List] = None) -> dict:
    """Decode the val split (read from ``root``, or ``session_data``'s
    (session, columns) pairs), score it, and write ``root/submission.csv``."""
    kw = dict(eval_type="val", decoder=decoder, compute_dtype=torch.float32)
    if session_data is None:
        res = evaluate_sessions(model, cfg, root, **kw)
    else:
        res = evaluate_session_data(model, cfg, session_data, **kw)
    csv_path = os.path.join(root, "submission.csv")
    write_competition_csv(res["trials"], csv_path)
    print(f"val trials: {len(res['trials'])}  greedy PER: "
          f"{res['greedy_PER']:.3f}  decoded WER: {res['WER']:.3f}")
    print(f"competition CSV: {csv_path}")
    return {"n_trials": len(res["trials"]), "greedy_PER": res["greedy_PER"],
            "WER": res["WER"], "csv_path": csv_path, "trials": res["trials"]}


def main(n_batches: int = 300, device: Union[str, torch.device, None] = None) -> dict:
    root = tempfile.mkdtemp(prefix="b2t_quickstart_")
    write_data(root)
    cfg = make_config(root, n_batches)
    trainer, _ = train(cfg, device)
    return decode_and_score(trainer.model, cfg, root, build_decoder(root))


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.examples.quickstart",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="where training and the model run: the CUDA card by default, "
                        "'cpu' to run on the CPU")
    main(device=p.parse_args().device)
