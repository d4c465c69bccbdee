"""CUDA graphs of a step the program repeats, captured once a key and
replayed: the one capture policy of the port, for each owner of a graph (the
device search's frame step, the DeepSeek rescorer's forward)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, NamedTuple, Optional

import torch

from .profiling import count


class Captured(NamedTuple):
    """A captured step: its graph, what the captured call returned (``out``,
    written anew by each replay), and its kernel's launches a replay."""

    graph: torch.cuda.CUDAGraph
    out: Any
    launches: int
    kernel: Any

    def replay(self, times: int = 1) -> None:
        """``times`` replays, counted as the kernel's launches."""
        for _ in range(times):
            self.graph.replay()
        self.kernel.launches += self.launches * times


class GraphCache:
    """An owner's captured steps by key, the most recently used last;
    ``kernel`` is the step's hand-written kernel (its ``launches`` count),
    ``counter`` names the count of captures."""

    def __init__(self, capacity: int, kernel, counter: str):
        self.capacity = capacity
        self.kernel = kernel
        self.counter = counter
        self.entries: Dict[Hashable, Any] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, key: Hashable, make: Callable[[], Any],
            fits: Optional[Callable[[Any], bool]] = None) -> Any:
        """``key``'s entry, now the most recently used: the cached one if
        ``fits`` it (None: any), else ``make()``'s, the old one dropped first
        so that its graph's memory pool is freed before the new capture.
        Past ``capacity`` the least recently used entry goes."""
        entry = self.entries.pop(key, None)
        if entry is None or (fits is not None and not fits(entry)):
            del entry   # the last reference to an entry that does not fit
            entry = make()
        self.entries[key] = entry
        if len(self.entries) > self.capacity:
            del self.entries[next(iter(self.entries))]
        return entry

    def capture(self, step: Callable[[], Any], device: torch.device, warmups: int = 1,
                reset: Optional[Callable[[], Any]] = None) -> Captured:
        """``warmups`` calls of ``step`` on a side stream (lazy
        initialisation), each after ``reset`` if given, then one captured;
        the capture runs nothing, so its launches count at each replay."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmups):
                if reset is not None:
                    reset()
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = self.kernel.launches
        # only this thread's calls are checked during the capture: another
        # thread of the program may be using the card at the time (the
        # training loader's prefetch thread uploads from one)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = step()
        launches, self.kernel.launches = self.kernel.launches - before, before
        count(self.counter)
        return Captured(graph, out, launches, self.kernel)
