"""Operation and byte counts from shapes, and the peaks they are held to.

Counts are of what the inputs need: a trial's own bins and frames (no
padding), each matrix product as 2 * m * n * k, each input byte read once
and each output byte written once.
"""

from __future__ import annotations

from typing import Dict

from .reference.gru import gaussian_kernel

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def kernel_taps(model: Dict) -> int:
    return len(gaussian_kernel(model["smooth_kernel_std"], model["smooth_kernel_size"]))


def stage1_flops(model: Dict, bins: int, frames: int, trials: int = 1,
                 same: bool = False) -> float:
    """Stage 1 over ``trials`` trials of ``bins`` bins and ``frames`` frames
    in all: smoothing and the day layer per smoothed bin ('valid' smoothing
    drops K - 1 bins a trial, ``same`` keeps them), the GRU's input and
    recurrent products and the head per frame."""
    D, H, C = model["n_input_features"], model["n_units"], model["n_classes"]
    L, ps = model["n_layers"], model["patch_size"]
    K = kernel_taps(model)
    smoothed = bins if same else bins - trials * (K - 1)
    per_bin = 2 * K * D + 2 * D * D
    per_frame = (2 * ps * D * 3 * H + (L - 1) * 2 * H * 3 * H   # input products
                 + L * 2 * H * 3 * H                           # recurrent products
                 + 2 * H * C)                                  # head
    return float(smoothed * per_bin + frames * per_frame)


def gru_layer_fwd(B: int, F: int, H: int, elem_bytes: int = 2) -> Dict[str, float]:
    """K1, one layer's recurrence over B rows of F frames in all:
    h_{t-1} W_hh^T a frame; reads x_proj (F, 3H), W_hh (3H, H), b_hh and h0
    (B, H), writes the outputs (F, H) and h_T (B, H)."""
    flops = 2.0 * F * H * 3 * H
    nbytes = elem_bytes * (F * 3 * H + 3 * H * H + 3 * H + B * H + F * H + B * H)
    return {"flops": flops, "bytes": float(nbytes)}


def gru_layer_bwd(B: int, F: int, H: int, elem_bytes: int = 2) -> Dict[str, float]:
    """K2's two kernels, one layer, B rows of F frames in all: the gates'
    rematerialization h_{t-1} W_hh^T and dh's product through W_hh, each
    2*F*H*3H (dW_hh is a separate cuBLAS product, neither counted nor timed
    here); reads x_proj (F, 3H), W_hh, b_hh, h0, the outputs and their
    gradient (F, H) and the final state's gradient (B, H, f32), writes
    dx_proj and dpre (F, 3H) and dh0 (B, H, f32)."""
    flops = 2 * 2.0 * F * H * 3 * H
    nbytes = (elem_bytes * (F * 3 * H + 3 * H * H + 3 * H + B * H + 2 * F * H + 2 * F * 3 * H)
              + 4 * B * H * 2)
    return {"flops": flops, "bytes": float(nbytes)}


def roofline_seconds(flops: float, nbytes: float, peak_flops: float = H100_BF16_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / H100_HBM_BYTES_PER_S)


def opt_forward_flops(cfg: Dict, seq_lens) -> float:
    """OPT's forward over sequences of the given token counts: per token
    the q, k, v, out, fc1, fc2 products and the vocabulary head; per
    sequence the causal attention's scores and weighted sums."""
    D, F, V, L = cfg["hidden_size"], cfg["ffn_dim"], cfg["vocab_size"], cfg["num_layers"]
    per_token = L * 2 * (4 * D * D + 2 * D * F) + 2 * D * V
    tokens = sum(seq_lens)
    attn = sum(L * 2 * 2 * D * n * (n + 1) / 2 for n in seq_lens)
    return float(tokens * per_token + attn)
