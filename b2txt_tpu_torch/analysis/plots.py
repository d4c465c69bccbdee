"""Figure rendering: matplotlib reproductions of the paper's Figure 2 / 4
panels over harness outputs.

Parity targets: ``analyses/figure_2.ipynb`` cells 5/7/8 (logit line plot +
phoneme raster, per-day error rates for the 50-word vs 125k-word vocabulary
conditions) and ``figure_4.ipynb`` cells 3/5/7/8 (cumulative use, correctness
pie, correctness-by-day, words per minute). The statistics come from
``analysis.figures``; these functions draw and save PNGs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from ..utils.phonemes import LOGIT_PHONE_DEF
from .figures import logit_raster


def _strip_spines(ax) -> None:
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)


def plot_logit_raster(
    logits: np.ndarray,
    title: str = "",
    path: Optional[str] = None,
    lm_order: bool = True,
):
    """Figure 2 cell 5: per-frame logit traces + the phoneme raster heatmap.

    logits: (T, 41). ``lm_order`` labels rows with the LM channel order
    [BLANK, SIL, phones...] like the notebook's decoded_logits.
    """
    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(16, 10), gridspec_kw={"height_ratios": [1, 1.4]}
    )
    ax1.plot(logits, ".-", markersize=3, linewidth=1)
    ax1.set_xlim([0, logits.shape[0]])
    ax1.set_title(title)
    ax1.set_ylabel("logit")
    _strip_spines(ax1)

    im = ax2.imshow(
        logit_raster(logits)["probs"].T, aspect="auto", cmap="Blues",
        interpolation="none",
    )
    fig.colorbar(im, ax=ax2)
    labels = LOGIT_PHONE_DEF if lm_order else None
    if labels is not None:
        ax2.set_yticks(np.arange(len(labels)))
        ax2.set_yticklabels(labels, fontsize=8)
    ax2.grid(axis="y", alpha=0.5)
    ax2.set_xlabel("20 ms bin")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_error_rates_by_day(
    rates_by_condition: Mapping[str, Mapping[str, Tuple[float, float, float]]],
    metric: str = "WER",
    path: Optional[str] = None,
):
    """Figure 2 cells 7/8: per-day error rate with bootstrap 95% CI bars,
    one series per vocabulary condition (50-word vs 125k-word).

    rates_by_condition: {condition: {day: (rate, lo, hi)}} — the output of
    ``figures.vocab_condition_comparison``.
    """
    fig, ax = plt.subplots(figsize=(12, 5))
    colors = plt.cm.tab10.colors
    for ci, (cond, day_rates) in enumerate(sorted(rates_by_condition.items())):
        days = sorted(day_rates.keys())
        x = np.arange(len(days))
        rate = np.array([day_rates[d][0] for d in days]) * 100
        lo = np.array([day_rates[d][1] for d in days]) * 100
        hi = np.array([day_rates[d][2] for d in days]) * 100
        ax.errorbar(
            x, rate, yerr=[rate - lo, hi - rate], fmt=".-", linewidth=1,
            markersize=8, capsize=3, label=cond, color=colors[ci % 10],
        )
        ax.set_xticks(x)
        ax.set_xticklabels(days, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel(f"{metric} (%)")
    ax.set_xlabel("session")
    ax.grid(axis="y", alpha=0.3)
    ax.legend()
    _strip_spines(ax)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_cumulative_usage(
    post_implant_day: Sequence[float],
    cumulative_hours: Sequence[float],
    cumulative_sentences: Sequence[float],
    path: Optional[str] = None,
):
    """Figure 4 cell 5: cumulative use time and sentences over days."""
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    ax1.plot(post_implant_day, cumulative_hours, "b.-")
    ax1.set_ylabel("Total use time (hours)")
    ax1.grid(axis="y", alpha=0.3)
    _strip_spines(ax1)
    ax2.plot(post_implant_day, cumulative_sentences, "r.-")
    ax2.set_ylabel("Total sentences")
    ax2.set_xlabel("Post-implant day")
    ax2.grid(axis="y", alpha=0.3)
    _strip_spines(ax2)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_correctness_pie(
    counts: Mapping[str, int], path: Optional[str] = None
):
    """Figure 4 cell 7: sentence-correctness share pie.

    counts: {label: n}, e.g. fully correct / mostly correct / incorrect /
    no rating.
    """
    labels = list(counts.keys())
    sizes = [counts[k] for k in labels]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.pie(sizes, labels=labels, autopct="%1.1f%%", startangle=90)
    ax.axis("equal")
    ax.set_title(f"{sum(sizes)} total sentences")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_correctness_by_day(
    post_implant_day: Sequence[float],
    series: Mapping[str, Sequence[float]],
    n_trials_by_day: Sequence[int],
    path: Optional[str] = None,
):
    """Figure 4 cell 8 (top panel): per-day % of trials in each correctness
    class. series: {label: counts_by_day}."""
    fig, ax = plt.subplots(figsize=(10, 4))
    n = np.asarray(n_trials_by_day, float)
    styles = {"Fully correct": "g.-", "Mostly correct": "y.-", "Incorrect": "r.-"}
    for label, counts in series.items():
        ax.plot(
            post_implant_day, np.asarray(counts, float) / n * 100,
            styles.get(label, ".-"), label=label, linewidth=1,
        )
    ax.set_ylabel("% of sentences")
    ax.set_xlabel("Post-implant day")
    ax.grid(axis="y", alpha=0.3)
    ax.legend()
    _strip_spines(ax)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_wpm_by_day(
    wpm_by_day: Mapping[str, float], path: Optional[str] = None
):
    """Figure 4 cell 3/8 (bottom): words-per-minute by day."""
    days = sorted(wpm_by_day.keys())
    fig, ax = plt.subplots(figsize=(10, 4))
    x = np.arange(len(days))
    ax.plot(x, [wpm_by_day[d] for d in days], "b.-")
    ax.set_xticks(x)
    ax.set_xticklabels(days, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("Words per minute")
    ax.grid(axis="y", alpha=0.3)
    _strip_spines(ax)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig
