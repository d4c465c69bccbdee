"""online.native_ms: the median, over the traced trials (one request id a
trial), of the program's spans ``native.decode`` summed over the trial (the
native C++ search consuming its chunks, without the Python around it), in
ms."""

import statistics


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    per = {}
    for r in records():
        if r.name == "native.decode" and r.rid is not None and r.end_ns is not None:
            per[r.rid] = per.get(r.rid, 0) + r.end_ns - r.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
