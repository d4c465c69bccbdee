"""online.finalize_ms: the median, over the window's trials, of the benchmark's
host-clock span around DecoderService.finalize (the search's finish, the unpruned rescore, the augmentation, the OPT forward and the blend), in ms."""

import statistics


def read(run):
    s = run.spans.get("finalize")
    return 1e3 * statistics.median(s) if s else None
