"""Routed experts: the router's top-k, and the grouped expert product (K5).

K5, ``csrc/moe_grouped.cu``, replaces no TPU kernel: the JAX package has
no expert layer. It was added for DeepSeek-V2's MoE layers
(``decode/deepseek_lm.py``), where each layer routes a forward's tokens to
k of E SwiGLU experts and sums their outputs with the router's weights.

On the card the (token, expert) pairs are sorted by expert and the group
offsets taken by a cumulative sum, all on the device. K5's two kernels then
run over a grid of (expert, output tile), which covers any routing without
a host sync: a CTA reads its expert's offsets, so an expert no token chose
does nothing.

* ``moe_gate_up_kernel``: gate and up in one pass over the expert's (2F,
  D) rows, silu(gate) · up in float32, stored in the working dtype;
* ``moe_down_kernel``: the (D, F) product, each row scaled by its router
  weight, stored in float32 in sorted order.

A gather by the pairs' inverse order and a sum over k bring the rows back
to their tokens; no atomics, so two calls give the same bits. At the
rescorer's shapes (~64 tokens, 64 experts, top-6) nearly every expert is
touched and sees ~6 rows: the product is bound by reading each touched
expert's weights once (3 · F · D · 2 bytes); the source says how its
design streams them.

``moe_experts`` launches the kernels for a CUDA tensor and runs the plain
version, ``moe_experts_plain`` (every expert over every token, weighted by
a dense (T, E) matrix of the router's weights), for a CPU tensor. Its
``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def route(h: torch.Tensor, gate: torch.Tensor, k: int, scaling: float,
          real: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router over ``h`` (T, D): logits in float32, softmax, a greedy
    top-k, weights not renormalized, times ``scaling``. Returns (weights
    (T, k) float32, experts (T, k) int64, tokens per expert (E + 1,)
    int64); a token with ``real`` False goes to expert E, which no kernel
    computes."""
    E = gate.shape[0]
    probs = F.linear(h.float(), gate.float()).softmax(-1)
    w, idx = torch.topk(probs, k, dim=-1)
    idx = torch.where(real[:, None], idx, E)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=h.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    return w * scaling, idx, counts


def moe_experts_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k · down_e(silu(gate_e x) · up_e x) for e = idx[:, k], in x's
    dtype: each expert over every token, weighted by the dense (T, E)
    matrix of router weights (0 where not chosen; expert E dropped)."""
    T, E, Fm = x.shape[0], gate_up.shape[0], down.shape[2]
    dense = torch.zeros(T, E + 1, dtype=torch.float32, device=x.device)
    dense.scatter_add_(1, idx, w.float())
    y = torch.zeros(T, down.shape[1], dtype=torch.float32, device=x.device)
    for e in range(E):
        g = x @ gate_up[e, :Fm].to(x.dtype).t()
        u = x @ gate_up[e, Fm:].to(x.dtype).t()
        h = (F.silu(g.float()) * u.float()).to(x.dtype)
        y += dense[:, e, None] * (h @ down[e].to(x.dtype).t()).float()
    return y.to(x.dtype)


def group(idx: torch.Tensor, counts: torch.Tensor):
    """The (token, expert) pairs sorted by expert, on the device: (token of
    each sorted pair (int32), the sort's order, its inverse, group offsets
    (E + 2,) int32)."""
    k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=idx.device)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = counts.cumsum(0)
    return (order // k).to(torch.int32), order, inv, offsets


def moe_experts(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, gate_up: torch.Tensor,
                down: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Σ_k w[:, k] · expert_{idx[:, k]}(x) for x (T, D); ``gate_up`` (E,
    2F, D) holds each expert's gate rows, then its up rows; ``down`` (E, D,
    F); ``counts`` (E + 1,) as :func:`route` gives it. A pair whose expert
    is E adds nothing. On a CUDA tensor K5's two kernels (bf16 on the
    tensor cores; float32 on the CUDA cores), with no host sync; on the CPU
    the plain version."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, idx, w, gate_up, down)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts runs on CUDA or CPU tensors, got {x.device}")
    T, D = x.shape
    E, F2, _ = gate_up.shape
    Fm = F2 // 2
    f32 = x.dtype == torch.float32
    if (x.dtype not in (torch.bfloat16, torch.float32) or gate_up.dtype != x.dtype
            or down.dtype != x.dtype or down.shape != (E, D, Fm) or gate_up.shape[2] != D
            or gate_up.stride()[1:] != (D, 1) or down.stride()[1:] != (Fm, 1)
            or not x.is_contiguous() or gate_up.device != x.device or down.device != x.device):
        raise ValueError(f"moe_experts: x {tuple(x.shape)} {x.dtype}, gate_up "
                         f"{tuple(gate_up.shape)} {gate_up.dtype}, down {tuple(down.shape)} "
                         f"{down.dtype}: one dtype (bf16 or float32), row-major experts on "
                         f"x's device")
    if not f32 and (D % 8 or Fm % 8 or gate_up.stride(0) % 8 or down.stride(0) % 8
                    or any(t.data_ptr() % 16 for t in (x, gate_up, down))):
        raise ValueError(f"moe_experts: bf16 needs D ({D}) and F ({Fm}) multiples of 8 and "
                         f"16-byte aligned rows (the kernel's 16-byte loads)")

    from ._build import moe_grouped_library

    lib = moe_grouped_library().lib
    rows, order, inv, offsets = group(idx, counts)
    n = rows.numel()
    w_sorted = w.reshape(-1)[order].float().contiguous()
    h = torch.empty((n, Fm), dtype=x.dtype, device=x.device)
    y = torch.zeros((n, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b2t_moe_experts(x.data_ptr(), rows.data_ptr(), offsets.data_ptr(),
                                  gate_up.data_ptr(), down.data_ptr(), w_sorted.data_ptr(),
                                  h.data_ptr(), y.data_ptr(), E, D, Fm, gate_up.stride(0),
                                  down.stride(0), int(f32), stream)
    if err != 0:
        msg = lib.b2t_cuda_error_string(err).decode()
        raise RuntimeError(f"moe_experts (T={T}, E={E}, D={D}, F={Fm}, {x.dtype}) kernel "
                           f"launch failed: cudaError {err}: {msg}")
    moe_experts.launches += 2
    return y[inv].view(T, -1, D).sum(1).to(x.dtype)


moe_experts.launches = 0
