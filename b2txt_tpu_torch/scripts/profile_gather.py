"""Can a hand-written row gather beat PyTorch's for the device searcher?

Counterpart of ``scripts/profile_pallas_gather.py``: the device beam search
reads random single rows of its tables (n-gram buckets of 256 B, trie rows),
and this times K4 (``ops/gather.py``, ``csrc/row_gather.cu``) against
``table[idx]`` on that access pattern, at the script's three cases: 2^17
rows of 512 B, 4096 gathers, 8, 32 and 128 loads in flight.

Each case first checks the kernel bit for bit against its plain version
(``index_select``) and ``table[idx]``, then times the three with CUDA
events over 32 back-to-back calls each. The indices are
rotated by the call's number to defeat caching, as the original does, and
the 32 rotated index sets are made before the timed window, so only gathers
are timed. The original times inside one jit so that dispatch is not
counted; here the stream sleeps while the host queues the 32 calls, so the
events time the card running them back to back, not the host issuing them.
One JSON line per case.

    python -m b2txt_tpu_torch.scripts.profile_gather
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Sequence

import torch

from ..ops.gather import row_gather, row_gather_reference

REPS = 32
CASES = [(1 << 17, 128, 4096, 8), (1 << 17, 128, 4096, 32), (1 << 17, 128, 4096, 128)]
SLEEP_CYCLES = 1 << 27   # the stream's sleep before a timed window: ~70 ms at 1.98 GHz


def queued_ms(fn: Callable, args: Sequence) -> float:
    """Mean device time in ms of ``fn(a)`` for each ``a`` in ``args``, run
    back to back on the current stream after two warm-up calls. The stream
    sleeps while the host queues the calls, so the events around them time
    the card, not the host's issue rate; raises if the host took longer to
    queue them than the card slept."""
    for a in args[:2]:
        fn(a)
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for a in args:
        fn(a)
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    sleep_ms = slept.elapsed_time(start)
    if issue_ms >= sleep_ms:
        raise RuntimeError(f"queueing {len(args)} calls took {issue_ms:.3f} ms, longer than "
                           f"the stream slept ({sleep_ms:.3f} ms): the timing would count the host")
    return start.elapsed_time(end) / len(args)


def bench_gather(table: torch.Tensor, idx: torch.Tensor, w: int) -> dict:
    """Bit-for-bit check of K4 with ``w`` loads in flight against its plain
    version and ``table[idx]``, then ns per gathered row of each arm, every
    arm over the same ``REPS`` rotated index sets."""
    rows, rw = table.shape
    g = idx.shape[0]
    ixs = [((idx + c) % rows).to(torch.int32) for c in range(REPS)]
    ixs_long = [ix.long() for ix in ixs]

    out = {"rows": rows, "row_bytes": rw * 4, "gathers": g, "in_flight": w}
    got = row_gather(table, idx, in_flight=w).long()
    plain = row_gather_reference(table, idx).long()
    out["max_abs_err"] = float((got - plain).abs().max()) if g else 0.0
    if not (torch.equal(got, plain) and torch.equal(got, table[idx.long()].long())):
        raise RuntimeError(f"row_gather disagrees with its plain version or table[idx]: {out}")

    torch_ns = queued_ms(lambda ix: table[ix], ixs_long) * 1e6 / g
    plain_ns = queued_ms(lambda ix: row_gather_reference(table, ix), ixs) * 1e6 / g
    kernel_ns = queued_ms(lambda ix: row_gather(table, ix, in_flight=w), ixs) * 1e6 / g
    out.update(torch_ns_per_row=torch_ns, plain_ns_per_row=plain_ns,
               kernel_ns_per_row=kernel_ns, kernel_vs_torch=kernel_ns / torch_ns)
    return out


def bench_case(rows: int, rw: int, g: int, w: int, seed: int = 0) -> dict:
    """One case on the CUDA card: a random int32 table (rows, rw) and ``g``
    random indices, through ``bench_gather``."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gather needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(0, 1 << 20, (rows, rw), generator=gen, device="cuda",
                          dtype=torch.int32)
    idx = torch.randint(0, rows, (g,), generator=gen, device="cuda", dtype=torch.int32)
    return bench_gather(table, idx, w)


def main() -> None:
    argparse.ArgumentParser(
        description="A/B the hand-written row gather K4 against table[idx] on "
        "the device searcher's random-row pattern"
    ).parse_args()
    for rows, rw, g, w in CASES:
        print(json.dumps(bench_case(rows, rw, g, w)), flush=True)


if __name__ == "__main__":
    main()
