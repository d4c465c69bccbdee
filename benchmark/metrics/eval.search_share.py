"""eval.search_share: the harness's own LM-decode time (``lm_decode_time``,
the device search and finalize) over each evaluation call's wall, summed
over the window's calls, in %."""


def read(run):
    calls, search = run.spans.get("call"), run.spans.get("lm_decode")
    if not calls or not search:
        return None
    return 100.0 * sum(search) / sum(calls)
