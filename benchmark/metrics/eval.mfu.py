"""eval.mfu: stage 1's operations over the trials the window finished,
counted from their shapes, over the window's time at the H100's dense bf16
peak (989 TFLOP/s), in %. The search's work is not counted."""

from benchmark.readers import percent_of_peak, stage1_flops_done


def read(run):
    return percent_of_peak(stage1_flops_done(run), run.cell.window_s)
