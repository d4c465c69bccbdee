"""The device trace of a bounded part of a run, read in memory.

``profile(work, device)`` runs ``work()`` under ``torch.profiler`` (host and
CUDA activity), waits for the card, and reduces the profiler's events to a
``TraceSummary``: the device's busy seconds (the union of every interval in
which a kernel, copy or set ran), the traced window's length on the host
clock, kernel counts and times by name, and the longest idle gaps labelled
by what the host was doing. No Chrome trace is written.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

Event = Tuple[str, int, int]   # name, start ns, end ns


def _events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) from the profiler's kineto results."""
    from torch.autograd import DeviceType

    dev: List[Event] = []
    host: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline
            # as an annotation: it covers work, it is none
            if not e.is_user_annotation():
                dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    return dev, host


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class TraceSummary:
    def __init__(self, dev: List[Event], host: List[Event], window_s: float):
        self.dev = sorted(dev, key=lambda e: e[1])
        self.host = host
        self.window_s = window_s
        self.busy_intervals = self._merge()
        self.busy_s = sum(b - a for a, b in self.busy_intervals) / 1e9

    def _merge(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for _, a, b in self.dev:
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    @property
    def n_kernels(self) -> int:
        return sum(1 for name, _, _ in self.dev if _is_kernel(name))

    def kernel_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed device seconds and count of the kernels ``match`` selects."""
        total, n = 0, 0
        for name, a, b in self.dev:
            if match(name):
                total += b - a
                n += 1
        return total / 1e9, n

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.dev:
            by_name[name] += (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        iv = self.busy_intervals
        for (a0, b0), (a1, _) in zip(iv, iv[1:]):
            gaps.append((a1 - b0, b0, a1))
        gaps.sort(reverse=True)
        gaps = gaps[:top]
        labelled = []
        if self.host and gaps:
            names = [h[0] for h in self.host]
            starts = np.fromiter((h[1] for h in self.host), np.int64, len(self.host))
            ends = np.fromiter((h[2] for h in self.host), np.int64, len(self.host))
            for dur, a, b in gaps:
                mid = (a + b) // 2
                idx = np.nonzero((starts <= mid) & (ends >= mid))[0]
                if len(idx):
                    spans = [i for i in idx if names[i].startswith("bench.")]
                    inner = min(idx, key=lambda i: ends[i] - starts[i])
                    outer = (max(spans, key=lambda i: ends[i] - starts[i])
                             if spans else None)
                    if outer is None:
                        label = names[inner]
                    elif outer == inner:
                        # inside a recorded call but in no operator: python
                        label = f"{names[outer]} > python between operators"
                    else:
                        label = f"{names[outer]} > {names[inner]}"
                else:
                    label = "host: outside any recorded call"
                labelled.append([label, dur / 1e9])
        else:
            labelled = [["host", dur / 1e9] for dur, _, _ in gaps]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}


def profile(work: Callable[[], None], device) -> TraceSummary:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    try:
        work()
        if device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        prof.stop()
    dev, host = _events(prof)
    return TraceSummary(dev, host, window_s)
