"""eval.kernels_per_frame: CUDA kernels in the traced evaluation call over
the frames the device search ran there (each batch to its longest trial)."""


def read(run):
    frames = getattr(run.cell, "traced_frames", 0)
    if run.trace is None or not frames or not run.trace.n_kernels:
        return None
    return run.trace.n_kernels / frames
