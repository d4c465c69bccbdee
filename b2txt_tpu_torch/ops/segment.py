"""Segment sums that give the same bits on every call.

``index_add_`` on a CUDA tensor adds with atomics, in an order that varies
from call to call, so float sums differ in their last bits between runs.
Here each segment is summed by ``torch.segment_reduce`` over a contiguous
run of rows, in one fixed order: the same inputs give the same output.
"""

from __future__ import annotations

import torch


def sorted_segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Σ of ``values``' rows per segment id in [0, n), for ``seg`` (int64,
    one id per row) sorted ascending; 0 for an empty segment."""
    offsets = torch.searchsorted(seg, torch.arange(n + 1, dtype=seg.dtype, device=seg.device))
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0, unsafe=True,
                                initial=0.0)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Σ of ``values``' rows per segment id in [0, n), ids in any order:
    a stable sort by id, then :func:`sorted_segment_sum`."""
    seg_s, perm = torch.sort(seg, stable=True)
    return sorted_segment_sum(values[perm], seg_s, n)
