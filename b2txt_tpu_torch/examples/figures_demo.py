#!/usr/bin/env python
"""Figure 2 / Figure 4 reproductions over harness outputs
(reference: analyses/figure_2.ipynb, figure_4.ipynb).

Counterpart of ``examples/figures_demo.py``, in two halves:

  * the data half (``figure_data``, no matplotlib): train on synthetic
    sessions, evaluate with the LM decode, then the papers' aggregate
    statistics (``figure_statistics``): per-day WER with bootstrap CIs by
    vocabulary condition (fig 2a/b), a logit raster (fig 2c), usage and WPM
    summaries (fig 4). Training and the model run on the CUDA card unless
    ``--device cpu`` is given;
  * the render half (``render``): the six ``plot_*`` panels as PNGs, which
    needs matplotlib.

    python -m b2txt_tpu_torch.examples.figures_demo [output_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Union

import numpy as np
import torch

from ..analysis import cumulative_usage, logit_raster, vocab_condition_comparison, words_per_minute
from ..data import synthetic
from ..evaluate import evaluate_session_data, evaluate_sessions
from ..lm import Lexicon, train_ngram
from ..serve import DecoderService
from ..train import Trainer
from ..utils import TrainConfig
from ..utils.config import DecodeConfig, ModelConfig
from ..utils.phonemes import rearrange_speech_logits, remove_punctuation
from .quickstart import session_columns

SESSIONS = ["t15.2023.08.11", "t15.2023.08.13", "t15.2023.08.18"]
TRIALS_PER_SESSION = 16


def make_config(data_dir: str, model_dir: str, n_batches: int = 120,
                model: Optional[ModelConfig] = None) -> TrainConfig:
    """The demo's training config: a small model (16 features, 2 × 48 GRU,
    optimizer epsilon 1e-8) unless ``model`` gives another (then epsilon
    stays the reference's 0.1)."""
    cfg = TrainConfig()
    if model is None:
        cfg.model.n_input_features = 16
        cfg.model.n_units = 48
        cfg.model.n_layers = 2
        cfg.epsilon = 1e-8
    else:
        cfg.model = model
    cfg.model.rnn_dropout = 0.0
    cfg.model.input_network.input_layer_dropout = 0.0
    cfg.dataset.neural_dim = cfg.model.n_input_features
    cfg.dataset.sessions = list(SESSIONS)
    cfg.dataset.dataset_probability_val = [1, 1, 1]
    cfg.dataset.batch_size = 8
    cfg.dataset.days_per_batch = 2
    cfg.dataset.dataset_dir = data_dir
    cfg.dataset.data_transforms.white_noise_std = 0.1
    cfg.dataset.data_transforms.random_cut = 0
    cfg.num_training_batches = n_batches
    cfg.lr_decay_steps = cfg.lr_decay_steps_day = n_batches
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 10
    cfg.batches_per_val_step = n_batches // 2
    cfg.use_amp = False
    cfg.output_dir = model_dir
    cfg.checkpoint_dir = os.path.join(model_dir, "ckpt")
    return cfg


def make_decoder() -> DecoderService:
    lexicon = Lexicon.from_words(synthetic.word_pronunciations())
    lm = train_ngram(synthetic.sentence_corpus(100), order=3)
    return DecoderService(
        lexicon, lm,
        DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=10, beam_width=48),
        channel_order="model",
    )


def figure_statistics(trials) -> dict:
    """The figures' statistics over evaluated trials (``TrialEval`` with
    logits and decoded sentences)."""
    trial_dicts = [{
        "day": t.session,
        "corpus": "50_word" if t.block_num % 2 == 0 else "125k_word",
        "reference": t.sentence_label or "",
        "decoded": t.decoded_sentence or "",
    } for t in trials]
    fig2 = vocab_condition_comparison(trial_dicts, n_resamples=1000)
    raster = logit_raster(trials[0].logits)
    usage = cumulative_usage([1.5, 2.0, 1.0], [40, 55, 30])
    wpm = words_per_minute(
        [len((t.decoded_sentence or "").split()) for t in trials],
        [t.logits.shape[0] * 0.08 for t in trials],  # 80 ms per frame
        [t.session for t in trials],
    )
    by_day = {}
    for t in trials:
        ok = (remove_punctuation(t.decoded_sentence or "")
              == remove_punctuation(t.sentence_label or ""))
        c, n = by_day.get(t.session, (0, 0))
        by_day[t.session] = (c + ok, n + 1)
    return {"fig2": fig2, "raster": raster, "usage": usage, "wpm": wpm, "by_day": by_day}


def figure_data(out_dir: str, device: Union[str, torch.device, None] = None,
                n_batches: int = 120, model: Optional[ModelConfig] = None,
                in_memory: bool = False, verbose: bool = True) -> dict:
    """The data half: synthetic sessions (HDF5 files under ``out_dir/data``,
    or held in memory with ``in_memory``, for hosts without h5py), training,
    the LM-decoded evaluation of the val split and ``figure_statistics``.
    Saves the raster's probabilities as ``fig2c_probs.npy``."""
    def say(*a):
        if verbose:
            print(*a)

    data_dir = os.path.join(out_dir, "data")
    cfg = make_config(data_dir, os.path.join(out_dir, "model"), n_batches, model)
    dim = cfg.dataset.neural_dim
    if in_memory:
        train = synthetic.synthetic_trials(SESSIONS, TRIALS_PER_SESSION, dim, split="train")
        val = synthetic.synthetic_trials(SESSIONS, TRIALS_PER_SESSION, dim, split="val")
        # no checkpoint: its args.yaml needs PyYAML, which such hosts lack too
        cfg.save_best_checkpoint = cfg.save_val_metrics = False
    else:
        synthetic.write_synthetic_sessions(data_dir, SESSIONS,
                                           trials_per_session=TRIALS_PER_SESSION,
                                           neural_dim=dim)
        train = val = None

    say("Training small model on synthetic sessions...")
    trainer = Trainer(cfg, device=device, train_trials=train, val_trials=val)
    trainer.train()

    say("Evaluating with LM decode...")
    if in_memory:
        res = evaluate_session_data(trainer.model, cfg, session_columns(val, SESSIONS),
                                    eval_type="val", decoder=make_decoder())
    else:
        res = evaluate_sessions(trainer.model, cfg, data_dir, eval_type="val",
                                decoder=make_decoder())
    say(f"greedy PER={res['greedy_PER']:.3f}  WER={res['WER']:.3f}")

    stats = figure_statistics(res["trials"])
    for corpus, days in stats["fig2"].items():
        for day, (rate, lo, hi) in sorted(days.items()):
            say(f"fig2  {corpus:10s} {day}: WER {rate:.3f} [{lo:.3f}, {hi:.3f}]")
    np.save(os.path.join(out_dir, "fig2c_probs.npy"), stats["raster"]["probs"])
    say("fig4  cumulative hours:", stats["usage"]["cumulative_hours"])
    say("fig4  WPM by day:", {k: round(v, 1) for k, v in stats["wpm"].items()})
    return {"res": res, **stats}


def render(data: dict, out_dir: str) -> list:
    """The render half: the six panels of figures 2 and 4 as PNGs in
    ``out_dir`` (analysis.plots, fig 2 cells 5/7/8, fig 4 3/5/7/8). Needs
    matplotlib. Returns the paths."""
    from ..analysis.plots import (
        plot_correctness_by_day,
        plot_correctness_pie,
        plot_cumulative_usage,
        plot_error_rates_by_day,
        plot_logit_raster,
        plot_wpm_by_day,
    )

    trials = data["res"]["trials"]
    t0 = trials[0]
    paths = [os.path.join(out_dir, name) for name in (
        "fig2c_logit_raster.png", "fig2ab_wer_by_day.png", "fig4ab_cumulative_use.png",
        "fig4c_correctness_pie.png", "fig4e_correctness_by_day.png", "fig4d_wpm_by_day.png")]
    plot_logit_raster(
        rearrange_speech_logits(t0.logits),
        title=f'{t0.session}, cue: "{t0.sentence_label}"',
        path=paths[0],
    )
    plot_error_rates_by_day(data["fig2"], metric="WER", path=paths[1])
    usage = data["usage"]
    plot_cumulative_usage([1, 2, 3], usage["cumulative_hours"], usage["cumulative_sentences"],
                          path=paths[2])
    by_day = data["by_day"]
    correct = sum(c for c, _ in by_day.values())
    plot_correctness_pie({"Fully correct": correct, "Incorrect": len(trials) - correct},
                         path=paths[3])
    days_sorted = sorted(by_day)
    plot_correctness_by_day(
        range(len(days_sorted)),
        {"Fully correct": [by_day[d][0] for d in days_sorted],
         "Incorrect": [by_day[d][1] - by_day[d][0] for d in days_sorted]},
        [by_day[d][1] for d in days_sorted],
        path=paths[4],
    )
    plot_wpm_by_day(data["wpm"], path=paths[5])
    return paths


def main(out_dir: Optional[str] = None, device: Union[str, torch.device, None] = None) -> list:
    out_dir = out_dir or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    paths = render(figure_data(out_dir, device), out_dir)
    print(f"Wrote {len(paths)} figure PNGs to {out_dir}")
    return paths


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.examples.figures_demo",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("output_dir", nargs="?", default=None)
    p.add_argument("--device", default=None,
                   help="where training and the model run: the CUDA card by default, "
                        "'cpu' to run on the CPU")
    args = p.parse_args()
    main(args.output_dir, args.device)
