"""train.mfu: the window's training operations over its time at the H100's
dense bf16 peak (989 TFLOP/s), in %. The forward's operations are counted
from the trials' own bins and frames ('same' smoothing, the day layer, the
GRU's products, the head), the step's as three times the forward."""

from benchmark.readers import percent_of_peak
from benchmark.flops import stage1_flops


def read(run):
    cell = run.cell
    if not getattr(cell, "attempted", 0):
        return None
    bins, frames, rows, _ = cell.work(int(run.traffic["check_steps"]), cell.attempted)
    fwd = stage1_flops(run.config["model"], bins, frames, rows, same=True)
    return percent_of_peak(3 * fwd, cell.window_s)
