"""Operation and byte counts of DeepSeek-V2's forward and of its grouped
expert kernel (the program's K5, ``ops/moe.py``), from the configuration's
config.json keys.

Counts are of what the inputs need, as in ``flops.py``: the real tokens of
each scored row (no padding), each matrix product 2 * m * n * k, each
input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Sequence

# K5's two kernels (``csrc/moe_grouped.cu``), by the names the device trace
# gives them
K5_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")


def dsv2_forward_flops(cfg: Dict, seq_lens: Sequence[int]) -> float:
    """The forward's active operations over sequences of the given token
    counts: per token the MLA projections (q, kv_a, kv_b, o) of every layer,
    the dense layers' SwiGLU, each MoE layer's router, its k routed experts
    and its shared experts, and the vocabulary head; per sequence the causal
    attention's scores ((nope + rope) wide) and weighted sums (v wide)."""
    D, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    dn, dr, dv, R = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    E, k, Fm = cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    S = cfg["n_shared_experts"] * Fm
    attn = 2 * (D * H * (dn + dr) + D * (R + dr) + R * H * (dn + dv) + H * dv * D)
    moe = 2 * D * E + k * 6 * D * Fm + 6 * D * S
    per_token = L * attn + dense * 6 * D * cfg["intermediate_size"] + (L - dense) * moe \
        + 2 * D * V
    scores = sum(L * 2 * H * (dn + dr + dv) * n * (n + 1) / 2 for n in seq_lens)
    return float(sum(seq_lens) * per_token + scores)


def k5_bytes(cfg: Dict, experts_touched: float, tokens: float, elem_bytes: int = 2) -> float:
    """K5's bytes over MoE layers that touched ``experts_touched`` experts
    in all for ``tokens`` tokens in all (both summed over layers): each
    touched expert's gate, up and down weights read once; each token's
    hidden row read; per (token, expert) pair the hidden product written
    and read back, and the weighted output row written in float32."""
    D, Fm, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    pairs = tokens * k
    return float(experts_touched * 3 * D * Fm * elem_bytes + tokens * D * elem_bytes
                 + pairs * 2 * Fm * elem_bytes + pairs * D * 4)
