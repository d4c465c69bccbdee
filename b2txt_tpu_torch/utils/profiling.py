"""Tracing and timing of the port.

Counterpart of ``b2txt_tpu/utils/profiling.py``, with one tracer in place of
its stage timer and ``torch.profiler`` in place of the JAX profiler.

``span(name, rid=None, **attrs)`` marks a stretch of the program's work and
``count(name, n)`` counts at the same place. While tracing is off, each costs
one flag check and one query of the profiler's state, and a span is one
shared no-op object: no clock read, no ``record_function``. Tracing is on
inside ``tracing()``, and whenever a ``torch.profiler`` session records
(``device_trace`` below, a benchmark's traced run): a recording that starts
under the profiler clears what an earlier one kept, so the records cover the
profiled part. While on, a span

* opens ``torch.profiler.record_function(name)`` while a profiler records,
  so the range sits in the device trace beside the kernels it launched, and
  is the innermost host event over the stretches of Python it covers;
* keeps ``(name, start_ns, end_ns, parent, rid, attrs)`` in memory, read with
  ``records()``; ``parent`` is the index of the span open around it on the
  same thread, ``rid`` the request id it was given or else its parent's;
* reads ``time.perf_counter_ns()`` and never waits for the device.

Times are exported on the profiler's clock: kineto stamps host events in
nanoseconds since the epoch, and the offset between that clock and
``perf_counter_ns``, taken once when a recording starts, is added on export.
``summary()`` sums the spans by name as the JAX package's stage timer does.

The measurement drivers (``scripts/bench*.py``, ``scripts/profile_*.py``)
time with ``seconds_per_call`` and read the hand-written kernels' counters
with ``kernel_launches``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import namedtuple
from typing import Any, Callable, Dict, Iterator, List

import torch

# dense bf16 tensor-core peak of an H100 SXM (flop/s), the MFU denominator
H100_BF16_PEAK_FLOPS = 989e12

_profiler_enabled = torch._C._autograd._profiler_enabled

Record = namedtuple("Record", "name start_ns end_ns parent rid attrs")

_OFF, _ON, _PROFILED = 0, 1, 2   # tracing off; on by tracing(); on under the profiler


class _Tracer:
    """The process's records, counters and recording state."""

    def __init__(self):
        self.mode = _OFF
        self.records: List[list] = []
        self.counters: Dict[str, float] = {}
        self.offset_ns = 0
        self.generation = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def start(self, mode: int) -> None:
        """A new recording: the records and counters start empty."""
        self.records, self.counters = [], {}
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.generation += 1
        self.mode = mode

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_tracer = _Tracer()


def _recording() -> bool:
    t = _tracer
    if t.mode == _ON:
        return True
    if _profiler_enabled():
        if t.mode == _OFF:
            t.start(_PROFILED)
        return True
    if t.mode == _PROFILED:
        t.mode = _OFF    # the profiled recording ended; its records stay readable
    return False


class _NoSpan:
    """The span while tracing is off."""

    __slots__ = ()
    rid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "rid", "attrs", "_rec", "_gen", "_index", "_range")

    def __init__(self, name: str, rid: Any, attrs: Dict[str, Any]):
        self.name, self.rid, self.attrs = name, rid, attrs
        self._range = None

    def __enter__(self):
        t = _tracer
        stack = t.stack()
        parent = stack[-1] if stack else None
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._gen = t.generation
        parent_index = (parent._index if parent is not None and parent._gen == self._gen
                        else None)
        self._rec = [self.name, time.perf_counter_ns(), None, parent_index, self.rid, self.attrs]
        with t.lock:    # an index per span, whichever thread records it
            self._index = len(t.records)
            t.records.append(self._rec)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._rec[2] = time.perf_counter_ns()
        _tracer.stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, rid: Any = None, **attrs: Any):
    """A context manager over one stretch of work; ``as`` gives its ``rid``
    (None while tracing is off)."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, rid, attrs)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _recording():
        return
    t = _tracer
    with t.lock:
        t.counters[name] = t.counters.get(name, 0) + n


def current_rid() -> Any:
    """The request id of the innermost open span on this thread (None while
    tracing is off or outside every span)."""
    if _tracer.mode == _OFF:
        return None
    stack = _tracer.stack()
    return stack[-1].rid if stack else None


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans and counters inside the block, starting empty."""
    t = _tracer
    t.start(_ON)
    try:
        yield
    finally:
        # under a profiler still recording, the recording goes on as one
        t.mode = _PROFILED if _profiler_enabled() else _OFF


def records() -> List[Record]:
    """The spans of the last recording, in the order they opened, on the
    profiler's clock (``end_ns`` None while a span is open)."""
    t = _tracer
    off = t.offset_ns
    return [Record(name, a + off, None if b is None else b + off, parent, rid, attrs)
            for name, a, b, parent, rid, attrs in list(t.records)]


def counters() -> Dict[str, float]:
    """The counters of the last recording."""
    return dict(_tracer.counters)


def summary() -> Dict[str, Dict[str, float]]:
    """Closed spans by name (in the order each name first opened):
    ``total_s``, ``count`` and ``mean_ms``."""
    totals: Dict[str, List[float]] = {}
    for r in records():
        if r.end_ns is not None:
            s = totals.setdefault(r.name, [0.0, 0])
            s[0] += (r.end_ns - r.start_ns) / 1e9
            s[1] += 1
    return {name: {"total_s": tot, "count": n, "mean_ms": 1000.0 * tot / max(n, 1)}
            for name, (tot, n) in totals.items()}


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a profile (host ops and the spans, and the card's kernels when
    there is a CUDA card) to ``log_dir/trace.json``."""
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


def synchronize(device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seconds_per_call(fn: Callable[[], object], iters: int, device, warmup: int = 1) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls issued back to back
    after ``warmup`` calls: by CUDA events around the loop on the card, by
    the host clock around the loop (its work ends with it) on the CPU."""
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
    """The launch counters of the hand-written kernels' wrappers: K1
    (``gru_layer_forward``), K2 (``gru_layer_backward``), K3
    (``fused_preprocess``) and K4 (``row_gather``)."""
    from ..ops.gather import row_gather
    from ..ops.gru import gru_layer_backward, gru_layer_forward
    from ..ops.preprocess import fused_preprocess

    return {"gru_fwd": gru_layer_forward.launches, "gru_bwd": gru_layer_backward.launches,
            "preprocess": fused_preprocess.launches, "row_gather": row_gather.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before = kernel_launches()``."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}
