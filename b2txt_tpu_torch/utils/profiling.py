"""Profiling / tracing helpers.

Counterpart of ``b2txt_tpu/utils/profiling.py``: a stage timer that
aggregates into a stats dict (verbatim), and a device trace over
``torch.profiler`` in place of the JAX profiler. The trace records host
activity, plus the card's kernels when a CUDA card is present, and is
written into ``log_dir`` as a Chrome trace (``chrome://tracing``, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulates per-stage wall-clock totals/counts."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def log(self, logger) -> None:
        for name, s in sorted(self.summary().items()):
            logger.info(
                f"[timing] {name}: {s['total_s']:.3f}s total, "
                f"{s['mean_ms']:.2f}ms avg over {int(s['count'])}"
            )


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a profile (host ops, and the card's kernels when there is a
    CUDA card) to ``log_dir/trace.json``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the device trace (``record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield
