"""Arithmetic the per-layer metrics' readers share."""

from __future__ import annotations

from typing import Optional

from .flops import H100_BF16_FLOPS, stage1_flops


def idle_percent(run) -> Optional[float]:
    """Share of the traced window in which nothing ran on the device."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def stage1_flops_done(run) -> float:
    """Stage 1's operations over the trials the window finished."""
    c = run.counters
    return stage1_flops(run.config["model"], c["trial_bins"], c["trial_frames"], c["trials"])


def percent_of_peak(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * H100_BF16_FLOPS)
