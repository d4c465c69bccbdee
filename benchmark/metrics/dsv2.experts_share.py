"""dsv2.experts_share: the device time of the grouped expert kernel (K5's
two kernels) over all device time (kernels, copies, sets) that ran while a
trial's forward was in flight, from the start of its ``dsv2.dispatch`` to
the end of its ``dsv2.fetch`` (the fetch waits for the forward; nothing
else is queued between), summed over the traced trials, in %."""

from benchmark.flops_moe import K5_KERNELS


def windows(records):
    """[start, end] ns from each request id's first dispatch to its last
    fetch, on the profiler's clock."""
    spans = {}
    for r in records:
        if r.name in ("dsv2.dispatch", "dsv2.fetch") and r.rid is not None \
                and r.end_ns is not None:
            a, b = spans.get(r.rid, (r.start_ns, r.end_ns))
            spans[r.rid] = (min(a, r.start_ns), max(b, r.end_ns))
    return sorted(spans.values())


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    if run.trace is None or not run.trace.dev:
        return None
    win = windows(records())
    k5, total = 0, 0
    for name, a, b in run.trace.dev:
        if any(lo <= a and b <= hi for lo, hi in win):
            total += b - a
            if any(k in name for k in K5_KERNELS):
                k5 += b - a
    return 100.0 * k5 / total if k5 and total else None
