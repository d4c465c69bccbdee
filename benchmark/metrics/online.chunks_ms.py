"""online.chunks_ms: the median, over the window's trials, of the benchmark's
host-clock span around one trial's DecoderService.decode_chunk calls (the native search), in ms."""

import statistics


def read(run):
    s = run.spans.get("chunks")
    return 1e3 * statistics.median(s) if s else None
