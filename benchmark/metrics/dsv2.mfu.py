"""dsv2.mfu: the operations of the window's trials over the window's time at
the H100's dense bf16 peak (989 TFLOP/s), in %: stage 1's, counted from
each trial's bins and frames, and DeepSeek-V2's active forward over the
tokens of every candidate it scored (the k routed experts a token uses,
not the 64 it could; ``benchmark/flops_moe.dsv2_forward_flops``), counted
with the cell's tokenizer. The program's packing pads rows; the padding is
not counted."""

from benchmark.flops_moe import dsv2_forward_flops
from benchmark.readers import percent_of_peak, stage1_flops_done
from benchmark.reference.opt import word_hash_encode
from benchmark.reference.rescore import _clean_text


def read(run):
    cfg = run.config
    enc = word_hash_encode(cfg["llm"]["vocab_size"])
    max_len = int(cfg["rescorer"]["max_len"])
    lens = [len(enc(_clean_text(r[0].strip()), max_len))
            for _, _, final in run.cell.done for r in final.nbest]
    flops = stage1_flops_done(run) + dsv2_forward_flops(cfg["llm"], lens)
    return percent_of_peak(flops, run.cell.window_s)
