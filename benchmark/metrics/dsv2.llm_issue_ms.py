"""dsv2.llm_issue_ms: the median, over the traced trials (one request id a
trial), of the program's spans ``dsv2.dispatch`` summed over the trial
(DeepseekV2Rescorer.score_async: tokenize, pack, upload and issue the
forward, with no wait), in ms."""

import statistics


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    per = {}
    for r in records():
        if r.name == "dsv2.dispatch" and r.rid is not None and r.end_ns is not None:
            per[r.rid] = per.get(r.rid, 0) + r.end_ns - r.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
