"""eval.search_frame_us: the device time of the device search's frame-step
kernel (K6, ``beam_step_kernel``) in the traced evaluation call over the
frames the search ran there (each batch to its longest trial), in
microseconds a frame. None where no such kernel ran (a program whose frame
step is issued op by op)."""


def read(run):
    frames = getattr(run.cell, "traced_frames", 0)
    if run.trace is None or not frames:
        return None
    seconds, n = run.trace.kernel_seconds(lambda name: "beam_step_kernel" in name)
    if not n:
        return None
    return 1e6 * seconds / frames
