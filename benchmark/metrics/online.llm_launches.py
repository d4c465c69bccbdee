"""online.llm_launches: the median, over the traced trials (one request id a
trial), of the kernels launched inside the program's spans ``opt.dispatch``
of the trial: the profiler's host events for the CUDA launch calls that
start inside a span's interval (the spans and the profiler's events share
its clock; the trial's host work is issued from one thread). Off the card
there are no launch calls, and nothing to read."""

import statistics

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    if run.trace is None:
        return None
    starts = np.sort(np.fromiter((a for name, a, _ in run.trace.host if name in LAUNCH_CALLS),
                                 np.int64))
    if not len(starts):
        return None
    per = {}
    for r in records():
        if r.name == "opt.dispatch" and r.rid is not None and r.end_ns is not None:
            n = int(np.searchsorted(starts, r.end_ns, "right")
                    - np.searchsorted(starts, r.start_ns, "left"))
            per[r.rid] = per.get(r.rid, 0) + n
    return float(statistics.median(per.values())) if per else None
