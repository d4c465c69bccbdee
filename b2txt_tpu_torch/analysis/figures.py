"""Analysis reproductions: the aggregate statistics behind the paper's
Figure 2 (copy-task error rates) and Figure 4 (personal use).

Parity target: ``analyses/figure_2.ipynb`` and ``figure_4.ipynb`` — per-day
PER/WER with bootstrap CIs for the 50-word vs 125k-word vocabulary conditions,
logit raster extraction, cumulative personal-use hours/sentences and WPM by
day. Plotting is left to the caller (matplotlib optional); these functions
return the plotted arrays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.metrics import calculate_aggregate_error_rate
from ..utils.phonemes import remove_punctuation


def per_day_error_rates(
    refs: Sequence[Sequence],
    hyps: Sequence[Sequence],
    days: Sequence[str],
    n_resamples: int = 10000,
    seed: Optional[int] = 0,
) -> Dict[str, Tuple[float, float, float]]:
    """Per-day aggregate error rate with bootstrap 95% CI
    (figure_2.ipynb cell 7 semantics). Returns {day: (rate, lo, hi)}."""
    by_day: Dict[str, List[int]] = defaultdict(list)
    for i, d in enumerate(days):
        by_day[d].append(i)
    out = {}
    for day, idxs in by_day.items():
        agg, lo, hi, _ = calculate_aggregate_error_rate(
            [refs[i] for i in idxs], [hyps[i] for i in idxs],
            n_resamples=n_resamples, seed=seed,
        )
        out[day] = (agg, lo, hi)
    return out


def vocab_condition_comparison(
    trials: Sequence[dict],
    n_resamples: int = 10000,
) -> Dict[str, Dict[str, Tuple[float, float, float]]]:
    """Fig 2a/2b: per-day WER for each vocabulary condition.

    Each trial dict needs: day, corpus ('50_word' / '125k' style labels),
    reference sentence, decoded sentence.
    """
    by_corpus: Dict[str, List[dict]] = defaultdict(list)
    for t in trials:
        by_corpus[t["corpus"]].append(t)
    out = {}
    for corpus, ts in by_corpus.items():
        refs = [remove_punctuation(t["reference"]).split() for t in ts]
        hyps = [remove_punctuation(t["decoded"]).split() for t in ts]
        days = [t["day"] for t in ts]
        out[corpus] = per_day_error_rates(refs, hyps, days, n_resamples)
    return out


def logit_raster(logits: np.ndarray) -> Dict[str, np.ndarray]:
    """Fig 2c raster data: per-frame phoneme probabilities + argmax path."""
    x = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(x) / np.exp(x).sum(axis=-1, keepdims=True)
    return {"probs": probs, "argmax": np.argmax(logits, axis=-1)}


def cumulative_usage(
    timestamps_h: Sequence[float], sentences_per_session: Sequence[int]
) -> Dict[str, np.ndarray]:
    """Fig 4a/b: cumulative hours and sentences over sessions."""
    return {
        "cumulative_hours": np.cumsum(np.asarray(timestamps_h, float)),
        "cumulative_sentences": np.cumsum(np.asarray(sentences_per_session, int)),
    }


def words_per_minute(
    word_counts: Sequence[int], durations_s: Sequence[float], days: Sequence[str]
) -> Dict[str, float]:
    """Fig 4d: WPM by day."""
    by_day: Dict[str, List[int]] = defaultdict(lambda: [0, 0.0])
    for w, d, day in zip(word_counts, durations_s, days):
        by_day[day][0] += w
        by_day[day][1] += d
    return {day: (w / (s / 60.0) if s > 0 else 0.0) for day, (w, s) in by_day.items()}
