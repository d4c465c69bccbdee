"""eval.search_wait_us_per_frame: the program's spans ``search.wait`` (the
host waiting on a batch's event for the device search to finish) summed
over the traced call, over its counter ``search.frames``, in us a frame.
Off the card there is no event to wait on, and nothing to read."""


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import counters, records
    except ImportError:
        return None
    ns = [r.end_ns - r.start_ns for r in records()
          if r.name == "search.wait" and r.end_ns is not None]
    frames = counters().get("search.frames", 0)
    return sum(ns) / 1e3 / frames if ns and frames else None
