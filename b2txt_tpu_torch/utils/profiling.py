"""Profiling / tracing helpers.

Counterpart of ``b2txt_tpu/utils/profiling.py``: a stage timer that
aggregates into a stats dict (verbatim), and a device trace over
``torch.profiler`` in place of the JAX profiler. The trace records host
activity, plus the card's kernels when a CUDA card is present, and is
written into ``log_dir`` as a Chrome trace (``chrome://tracing``, Perfetto).
The measurement drivers (``scripts/bench*.py``, ``scripts/profile_*.py``)
time with ``seconds_per_call`` and read the kernels' counters with
``kernel_launches``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator

# dense bf16 tensor-core peak of an H100 SXM (flop/s), the MFU denominator
H100_BF16_PEAK_FLOPS = 989e12


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


def synchronize(device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seconds_per_call(fn: Callable[[], object], iters: int, device, warmup: int = 1) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls issued back to back
    after ``warmup`` calls: by CUDA events around the loop on the card, by
    the host clock around the loop (its work ends with it) on the CPU."""
    import torch

    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the GRU kernels' wrappers: K1
    (``gru_layer_forward``) and K2 (``gru_layer_backward``)."""
    from ..ops.gru import gru_layer_backward, gru_layer_forward

    return {"gru_fwd": gru_layer_forward.launches, "gru_bwd": gru_layer_backward.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before = kernel_launches()``."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}
