"""eval.search_issue_us_per_frame: the program's spans ``search.issue`` (the
device search's host issue of a batch: its frames' kernels, the finalize
and the copies to pinned memory, with no wait) summed over the traced call,
over its counter ``search.frames`` (the frames the search scanned, each
batch to its longest trial), in us a frame."""


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import counters, records
    except ImportError:
        return None
    ns = sum(r.end_ns - r.start_ns for r in records()
             if r.name == "search.issue" and r.end_ns is not None)
    frames = counters().get("search.frames", 0)
    return ns / 1e3 / frames if ns and frames else None
