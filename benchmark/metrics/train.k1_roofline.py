"""train.k1_roofline: K1 (csrc/gru_fwd.cu), the forward recurrence, in the traced steps: the least time
the card could take for the work the batches' own rows and frames need
(the larger of operations over 989 TFLOP/s and bytes over 3.35 TB/s,
benchmark/flops.py) over the kernels' summed device time, in %. Each of the
5 layers a step is one launch over the batch."""

from benchmark.flops import gru_layer_fwd, roofline_seconds

NAMES = ("gru_fwd_kernel",)


def read(run):
    cell, trace = run.cell, run.trace
    if trace is None or not getattr(cell, "traced_steps", 0):
        return None
    secs, n = trace.kernel_seconds(lambda name: any(k in name for k in NAMES))
    if not n or secs <= 0:
        return None
    m = run.config["model"]
    H, L = m["n_units"], m["n_layers"]
    bound = 0.0
    for rows, frames in cell.work(cell.traced_first, cell.traced_steps)[3]:
        # the rows' own frames: a row of P frames needs P steps of its recurrence
        c = gru_layer_fwd(rows, sum(frames), H)
        bound += L * roofline_seconds(c["flops"], c["bytes"])
    return 100.0 * bound / secs
