"""Figure-notebook data formats: load/compute/render the paper's pickles.

The reference's analyses consume two pickled dicts
(``analyses/figure_2.ipynb`` cell 3: ``t15_copyTask.pkl`` with per-trial
cue/decoded sentences + phonemes, decoded logits, post-implant day and
vocab_size; ``figure_4.ipynb`` cell 3: ``t15_personalUse.pkl`` with
``trialized_info`` correctness ratings, ``total_use_time``,
``total_trial_count``). This module reproduces the notebooks' computations
over those exact schemas, renders every figure panel via ``analysis.plots``,
and exports harness results INTO the copy-task schema so our decode runs are
notebook-compatible.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..utils.metrics import calculate_aggregate_error_rate
from .figures import cumulative_usage


def load_pickle(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------- figure 2


def copy_task_error_rates(
    dat: Mapping, metric: str = "WER", n_resamples: int = 10000,
    seed: Optional[int] = 0,
) -> Dict[int, Dict[str, tuple]]:
    """Per-day, per-vocabulary aggregate error rate with bootstrap CI —
    figure_2.ipynb cell 7. metric='PER' compares cue vs raw decoded phonemes;
    'WER' compares word sequences. Returns {vocab_size: {day: (rate, lo, hi)}}."""
    days = np.asarray(dat["post_implant_day"])
    vocab = np.asarray(dat["vocab_size"])
    out: Dict[int, Dict[str, tuple]] = {}
    for vs in np.unique(vocab):
        day_rates = {}
        for day in np.sort(np.unique(days)):
            ind = np.where((days == day) & (vocab == vs))[0]
            if len(ind) == 0:
                continue
            if metric == "PER":
                refs = [dat["cue_sentence_phonemes"][i] for i in ind]
                hyps = [dat["decoded_phonemes_raw"][i] for i in ind]
            else:
                refs = [dat["cue_sentence"][i].split() for i in ind]
                hyps = [dat["decoded_sentence"][i].split() for i in ind]
            agg, lo, hi, _ = calculate_aggregate_error_rate(
                refs, hyps, n_resamples=n_resamples, seed=seed
            )
            day_rates[str(day)] = (agg, lo, hi)
        out[int(vs)] = day_rates
    return out


def render_figure_2(dat: Mapping, out_dir: str, trial: int = 0,
                    n_resamples: int = 2000) -> List[str]:
    """Figure 2 panels: logit raster for one trial (cell 5) + per-day WER and
    PER by vocabulary condition (cells 7/8). Returns written paths."""
    # matplotlib only where a figure is drawn: the rest imports without it
    from .plots import plot_error_rates_by_day, plot_logit_raster

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    p = os.path.join(out_dir, "fig2_logit_raster.png")
    plot_logit_raster(
        np.asarray(dat["decoded_logits"][trial]),
        title=(f'Post-implant day {dat["post_implant_day"][trial]}, '
               f'cue: "{dat["cue_sentence"][trial]}"'),
        path=p,
    )
    paths.append(p)
    for metric in ("WER", "PER"):
        rates = copy_task_error_rates(dat, metric, n_resamples=n_resamples)
        p = os.path.join(out_dir, f"fig2_{metric.lower()}_by_day.png")
        plot_error_rates_by_day(
            {f"{vs}_word_vocab": dr for vs, dr in rates.items()},
            metric=metric, path=p,
        )
        paths.append(p)
    return paths


def export_copy_task_pickle(
    trials: Sequence, path: str, vocab_size: int = 125000
) -> Dict:
    """Build the t15_copyTask.pkl schema from harness TrialEval results, so
    decode runs feed the reference notebooks unchanged."""
    from ..utils.g2p import sentence_to_phonemes
    from ..utils.phonemes import LOGIT_TO_PHONEME, rearrange_speech_logits

    def ids_to_phones(ids):
        return ["SIL" if i == 40 else LOGIT_TO_PHONEME[i] for i in ids]

    dat = {
        "post_implant_day": [t.day_idx for t in trials],
        "vocab_size": [vocab_size] * len(trials),
        "cue_sentence": [t.sentence_label or "" for t in trials],
        "cue_sentence_phonemes": [
            ids_to_phones(t.true_ids) if t.true_ids
            else sentence_to_phonemes(t.sentence_label or "")[0]
            for t in trials
        ],
        "decoded_sentence": [t.decoded_sentence or "" for t in trials],
        "decoded_sentence_phonemes": [
            sentence_to_phonemes(t.decoded_sentence or "")[0] for t in trials
        ],
        "decoded_phonemes_raw": [ids_to_phones(t.decoded_ids) for t in trials],
        "decoded_logits": [
            rearrange_speech_logits(t.logits) for t in trials
        ],
    }
    with open(path, "wb") as f:
        pickle.dump(dat, f)
    return dat


# --------------------------------------------------------------- figure 4

CORRECTNESS_CLASSES = [
    "correct", "mostly correct", "one word wrong", "incorrect",
    "blank trial", "response timeout", "no user rating",
]


def personal_use_summary(dat: Mapping) -> Dict:
    """figure_4.ipynb cells 3/7/8 statistics from the t15_personalUse.pkl
    schema: correctness counts (total + by day), cumulative use, WPM inputs."""
    info = dat["trialized_info"]
    ratings = np.asarray(info["correctness_rating"])
    days = np.asarray(info["post_implant_day"])
    uniq = np.sort(np.unique(days))
    counts = {c: int(np.sum(ratings == c)) for c in CORRECTNESS_CLASSES}
    by_day = {
        c: [int(np.sum(ratings[days == d] == c)) for d in uniq]
        for c in CORRECTNESS_CLASSES
    }
    n_by_day = [int(np.sum(days == d)) for d in uniq]
    return {
        "days": uniq.tolist(),
        "counts": counts,
        "counts_by_day": by_day,
        "n_trials_by_day": n_by_day,
        "total_use_time": dat.get("total_use_time"),
        "total_trial_count": dat.get("total_trial_count"),
    }


def render_figure_4(dat: Mapping, out_dir: str,
                    hours_by_day: Optional[Sequence[float]] = None) -> List[str]:
    """Figure 4 panels: cumulative use (cell 5), correctness pie (cell 7),
    correctness-by-day (cell 8). Returns written paths."""
    from .plots import plot_correctness_by_day, plot_correctness_pie, plot_cumulative_usage

    os.makedirs(out_dir, exist_ok=True)
    s = personal_use_summary(dat)
    paths = []

    if hours_by_day is None:
        total = float(s["total_use_time"] or 0.0)
        n = max(sum(s["n_trials_by_day"]), 1)
        hours_by_day = [total * k / n for k in s["n_trials_by_day"]]
    usage = cumulative_usage(hours_by_day, s["n_trials_by_day"])
    p = os.path.join(out_dir, "fig4_cumulative_use.png")
    plot_cumulative_usage(s["days"], usage["cumulative_hours"],
                          usage["cumulative_sentences"], path=p)
    paths.append(p)

    pie = {c: n for c, n in s["counts"].items() if n > 0}
    p = os.path.join(out_dir, "fig4_correctness_pie.png")
    plot_correctness_pie(pie, path=p)
    paths.append(p)

    series = {
        "Fully correct": s["counts_by_day"]["correct"],
        "Mostly correct": [
            a + b for a, b in zip(s["counts_by_day"]["mostly correct"],
                                  s["counts_by_day"]["one word wrong"])
        ],
        "Incorrect": s["counts_by_day"]["incorrect"],
    }
    p = os.path.join(out_dir, "fig4_correctness_by_day.png")
    plot_correctness_by_day(s["days"], series, s["n_trials_by_day"], path=p)
    paths.append(p)
    return paths
