"""eval.stage1_ms_per_trial: the program's spans ``eval.stage1`` (each
session's stage 1 inside ``evaluate_session_data``: the padded batches, the
GRU decoder, the log-softmax kept on the card) summed over the traced call,
over its counter ``eval.trials``, in ms a trial."""


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import counters, records
    except ImportError:
        return None
    ns = sum(r.end_ns - r.start_ns for r in records()
             if r.name == "eval.stage1" and r.end_ns is not None)
    trials = counters().get("eval.trials", 0)
    return ns / 1e6 / trials if ns and trials else None
