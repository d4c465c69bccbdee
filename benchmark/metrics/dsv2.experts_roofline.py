"""dsv2.experts_roofline: the grouped expert kernel's bound over its time,
in %: the bytes K5 moves over the traced trials (the weights of the experts
counted in ``moe.experts_touched``, each read once, plus the activations
for ``moe.tokens`` tokens; ``benchmark/flops_moe.k5_bytes``) at the H100's
3.35 TB/s, over the device time of K5's kernels in the same trace."""

from benchmark.flops import H100_HBM_BYTES_PER_S
from benchmark.flops_moe import K5_KERNELS, k5_bytes


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    if run.trace is None:
        return None
    c = counters()
    touched, tokens = c.get("moe.experts_touched"), c.get("moe.tokens")
    seconds, n = run.trace.kernel_seconds(lambda name: any(k in name for k in K5_KERNELS))
    if not touched or not tokens or not n or seconds <= 0:
        return None
    bound = k5_bytes(run.config["llm"], touched, tokens) / H100_HBM_BYTES_PER_S
    return 100.0 * bound / seconds
