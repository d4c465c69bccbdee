"""online.stage1_ms: the median, over the window's trials, of the benchmark's
host-clock span around the program's run_single_decoding_step (one trial's stage 1, ending in its logits on the host), in ms."""

import statistics


def read(run):
    s = run.spans.get("stage1")
    return 1e3 * statistics.median(s) if s else None
