"""eval.extract_ms: the median, over the traced call's batches, of the
program's span ``search.extract`` (a batch's backpointers and final scores
on the host: backtrace, the unpruned rescore of the pool, the n-best), in
ms."""

import statistics


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in records()
          if r.name == "search.extract" and r.end_ns is not None]
    return statistics.median(ms) if ms else None
