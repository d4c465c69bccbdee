"""train.step_launches: the median, over the traced steps, of the kernels
launched inside the program's span ``train.step``: the profiler's host
events for the CUDA launch calls that start inside the span's interval (the
spans and the profiler's events share its clock). Autograd's backward runs
on its own device thread inside the step's interval, and is counted. Off
the card there are no launch calls, and nothing to read."""

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
    n = [int(np.searchsorted(starts, r.end_ns, "right") - np.searchsorted(starts, r.start_ns))
         for r in records() if r.name == "train.step" and r.end_ns is not None]
    return float(statistics.median(n)) if n else None
