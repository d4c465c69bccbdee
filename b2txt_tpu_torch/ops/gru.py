"""One GRU layer's recurrence, forward and backward: the CUDA kernels K1 and
K2, their plain versions, and the autograd Function that joins them.

Counterpart of ``b2txt_tpu/ops/pallas/gru.py``:

- K1, ``csrc/gru_fwd.cu``, replaces ``_gru_seq_kernel`` (:32, launched by
  ``_gru_fwd_call``, :79). A cooperative, persistent launch per layer: each
  CTA owns 16 hidden units, keeps their W_hh rows in registers as the
  operand of the bf16 tensor-core product (``mma.sync``) and ends every time
  step with a grid barrier. Same rounding points as the Pallas kernel:
  h·W_hhᵀ summed in f32, b_hh and x_proj added in f32, the gates in f32, h_t
  rounded to the compute dtype.
- K2, ``csrc/gru_bwd.cu``, replaces ``_gru_bwd_kernel`` (:122, launched by
  ``_gru_bwd_call``, :217). It first forms the rematerialized
  h_{t-1}·W_hhᵀ + b_hh for every step (a hand-written tensor-core product
  into an f32 scratch the wrapper allocates), then runs the recurrence in
  reverse time: r, z and n from that scratch and x_proj_t, dh carried in
  f32, d(x_proj) and d(pre-activation) written per step. dW_hh and db_hh are
  one f32 contraction outside the kernel, as in the JAX package (:266-272).

``gru_layer_forward`` and ``gru_layer_backward`` launch the kernels for CUDA
tensors and take the plain versions (``gru_layer_reference``,
``gru_layer_backward_reference``) only for CPU tensors. ``gru_layer`` is
``GRULayerFn.apply``: differentiable on both devices, as the JAX package's
custom VJP (:282-312) makes ``gru_layer_pallas``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gru_layer_reference(
    x_proj: torch.Tensor,   # (B, T, 3H): x @ W_ih^T + b_ih
    w_hh: torch.Tensor,     # (3H, H)
    b_hh: torch.Tensor,     # (3H,)
    h0: torch.Tensor,       # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch recurrence in the kernel's step order and precision.
    Returns (outputs (B, T, H), h_T (B, H)) in x_proj's dtype."""
    dtype = x_proj.dtype
    H = w_hh.shape[1]
    wt = w_hh.to(dtype).float().t()
    b = b_hh.to(dtype).float()
    h = h0.to(dtype)
    outs = []
    for t in range(x_proj.shape[1]):
        hh = h.float() @ wt + b
        xp = x_proj[:, t].float()
        r = torch.sigmoid(xp[:, :H] + hh[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hh[:, H : 2 * H])
        n = torch.tanh(xp[:, 2 * H :] + r * hh[:, 2 * H :])
        h = ((1.0 - z) * n + z * h.float()).to(dtype)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def _h_prev(h0: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """(B, T, H): h_{t-1} for every step t, h0 at t = 0."""
    return torch.cat([h0.to(out.dtype)[:, None], out[:, :-1]], dim=1)


def _weight_grads(dpre: torch.Tensor, h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW_hh (3H, H) and db_hh (3H,): one f32 contraction over (B, T)."""
    d = dpre.float().reshape(-1, dpre.shape[-1])
    return d.t() @ h_prev.float().reshape(-1, h_prev.shape[-1]), d.sum(dim=0)


def gru_layer_backward_reference(
    x_proj: torch.Tensor,   # (B, T, 3H)
    w_hh: torch.Tensor,     # (3H, H)
    b_hh: torch.Tensor,     # (3H,)
    h0: torch.Tensor,       # (B, H)
    out: torch.Tensor,      # (B, T, H): the forward's outputs
    g_out: torch.Tensor,    # (B, T, H): cotangent of out
    g_hf: torch.Tensor,     # (B, H): cotangent of h_T
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain reverse-time recurrence in K2's step order and rounding points
    (``_gru_bwd_kernel``, gru.py:167-196). Returns (d x_proj, d W_hh, d b_hh,
    d h0), each in its input's dtype."""
    dtype = x_proj.dtype
    B, T, H3 = x_proj.shape
    H = H3 // 3
    w = w_hh.to(dtype).float()
    wt = w.t()
    b = b_hh.to(dtype).float()
    g_out = g_out.to(dtype)
    h_prev = _h_prev(h0, out.to(dtype))
    dh = g_hf.float()
    dxp = torch.empty((B, T, H3), dtype=dtype, device=x_proj.device)
    dpre = torch.empty((B, T, H3), dtype=dtype, device=x_proj.device)
    for t in range(T - 1, -1, -1):
        hp = h_prev[:, t].float()
        hh = hp @ wt + b
        xp = x_proj[:, t].float()
        r = torch.sigmoid(xp[:, :H] + hh[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hh[:, H : 2 * H])
        hn = hh[:, 2 * H :]
        n = torch.tanh(xp[:, 2 * H :] + r * hn)
        g = g_out[:, t].float() + dh
        dz = g * (hp - n) * z * (1.0 - z)
        dn = g * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        dxp[:, t] = torch.cat([dr, dz, dn], dim=1).to(dtype)
        dp = torch.cat([dr, dz, dn * r], dim=1).to(dtype)
        dpre[:, t] = dp
        dh = g * z + dp.float() @ w
    dw, db = _weight_grads(dpre, h_prev)
    return dxp, dw.to(w_hh.dtype), db.to(b_hh.dtype), dh.to(h0.dtype)


def _check(x_proj, w_hh, b_hh, h0, **more) -> Tuple[int, int, int]:
    """Shapes, dtypes, devices and contiguity the kernels take. ``more``:
    further (B, T, H)-shaped tensors in x_proj's dtype, by name."""
    if x_proj.dim() != 3 or x_proj.shape[2] % 3:
        raise ValueError(f"x_proj must be (B, T, 3H), got {tuple(x_proj.shape)}")
    B, T, H3 = x_proj.shape
    H = H3 // 3
    want = {"w_hh": (w_hh, (H3, H)), "b_hh": (b_hh, (H3,)), "h0": (h0, (B, H))}
    want.update({name: (t, (B, T, H)) for name, t in more.items()})
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if x_proj.dtype not in _DTYPE_CODES:
        raise TypeError(f"gru_layer takes float32 or bfloat16, got {x_proj.dtype}")
    named = {"x_proj": x_proj, "w_hh": w_hh, "b_hh": b_hh, "h0": h0, **more}
    for name, t in named.items():
        if t.dtype != x_proj.dtype:
            raise TypeError(f"{name} is {t.dtype}, x_proj is {x_proj.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj is on {x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f"empty input: B={B}, T={T}, H={H}")
    return B, T, H


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.b2t_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}: {msg}")


def gru_layer_forward(
    x_proj: torch.Tensor,   # (B, T, 3H): x @ W_ih^T + b_ih
    w_hh: torch.Tensor,     # (3H, H)
    b_hh: torch.Tensor,     # (3H,)
    h0: torch.Tensor,       # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one GRU layer's recurrence, not differentiable: use ``gru_layer``
    for that. Returns (outputs (B, T, H), h_T (B, H)).

    On CUDA tensors this launches K1: all four inputs must share the device
    and the dtype (float32 or bfloat16) and be contiguous. CPU tensors go to
    ``gru_layer_reference``. ``gru_layer_forward.launches`` counts launches.
    """
    if x_proj.device.type == "cpu":
        return gru_layer_reference(x_proj, w_hh, b_hh, h0)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_layer runs on CUDA or CPU tensors, got {x_proj.device}")
    B, T, H = _check(x_proj, w_hh, b_hh, h0)

    from ._build import gru_fwd_library

    lib = gru_fwd_library().lib
    out = torch.empty((B, T, H), dtype=x_proj.dtype, device=x_proj.device)
    h_t = torch.empty((B, H), dtype=x_proj.dtype, device=x_proj.device)
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b2t_gru_fwd(
            x_proj.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            out.data_ptr(), h_t.data_ptr(), B, T, H, _DTYPE_CODES[x_proj.dtype],
            stream,
        )
    _raise_on(err, lib, f"gru_fwd (B={B}, T={T}, H={H}, {x_proj.dtype})")
    gru_layer_forward.launches += 1
    return out, h_t


gru_layer_forward.launches = 0


def gru_layer_backward(
    x_proj: torch.Tensor,   # (B, T, 3H)
    w_hh: torch.Tensor,     # (3H, H)
    b_hh: torch.Tensor,     # (3H,)
    h0: torch.Tensor,       # (B, H)
    out: torch.Tensor,      # (B, T, H): the forward's outputs
    g_out: torch.Tensor,    # (B, T, H): cotangent of out
    g_hf: torch.Tensor,     # (B, H): cotangent of h_T, any float dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's vector-Jacobian product. Returns (d x_proj, d W_hh,
    d b_hh, d h0).

    On CUDA tensors this launches K2 (the same dtype rules as the forward;
    g_out is cast to the dtype, g_hf to float32) and forms dW_hh and db_hh
    with one ``torch.matmul``. K2 keeps ~0.5 KB of shared memory per batch
    row beside its ~150 KB of dpre tiles (csrc/gru_bwd.cu), which caps one
    launch at about 150 rows; the rows are independent in the backward
    recurrence, so a larger batch runs as one launch per block of
    ``K2_MAX_ROWS`` rows, each row getting the values one launch would give
    it. CPU tensors go to ``gru_layer_backward_reference``.
    ``gru_layer_backward.launches`` counts K2 launches.
    """
    if x_proj.device.type == "cpu":
        return gru_layer_backward_reference(x_proj, w_hh, b_hh, h0, out, g_out, g_hf)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_layer runs on CUDA or CPU tensors, got {x_proj.device}")
    dtype = x_proj.dtype
    g_out = g_out.to(dtype).contiguous()
    g_hf = g_hf.float().contiguous()
    B, T, H = _check(x_proj, w_hh, b_hh, h0, out=out, g_out=g_out)
    if tuple(g_hf.shape) != (B, H) or g_hf.device != x_proj.device:
        raise ValueError(f"g_hf must be ({B}, {H}) on {x_proj.device}")

    from ._build import gru_bwd_library

    lib = gru_bwd_library().lib
    dxp = torch.empty((B, T, 3 * H), dtype=dtype, device=x_proj.device)
    dpre = torch.empty((B, T, 3 * H), dtype=dtype, device=x_proj.device)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=x_proj.device)
    # scratch: the rematerialized h_{t-1}·W_hhᵀ + b_hh for every step, in f32
    hh = torch.empty((B, T, 3 * H), dtype=torch.float32, device=x_proj.device)
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, B, K2_MAX_ROWS):
            rows = slice(lo, min(B, lo + K2_MAX_ROWS))
            n = rows.stop - lo
            err = lib.b2t_gru_bwd(
                x_proj[rows].data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                h0[rows].data_ptr(), out[rows].data_ptr(), g_out[rows].data_ptr(),
                g_hf[rows].data_ptr(), dxp[rows].data_ptr(), dpre[rows].data_ptr(),
                dh0[rows].data_ptr(), hh[rows].data_ptr(), n, T, H, _DTYPE_CODES[dtype], stream,
            )
            _raise_on(err, lib, f"gru_bwd (B={n} of {B}, T={T}, H={H}, {dtype})")
            gru_layer_backward.launches += 1
    dw, db = _weight_grads(dpre, _h_prev(h0, out))
    return dxp, dw.to(w_hh.dtype), db.to(b_hh.dtype), dh0.to(h0.dtype)


gru_layer_backward.launches = 0
K2_MAX_ROWS = 128   # batch rows of one K2 launch


class GRULayerFn(torch.autograd.Function):
    """K1 forward, K2 backward (the plain versions on the CPU). Saves x_proj,
    W_hh, b_hh, h0 and the outputs; no gate activations are stored, K2
    rematerializes them."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, h0):
        out, h_t = gru_layer_forward(x_proj, w_hh, b_hh, h0)
        ctx.save_for_backward(x_proj, w_hh, b_hh, h0, out)
        return out, h_t

    @staticmethod
    def backward(ctx, g_out: Optional[torch.Tensor], g_hf: Optional[torch.Tensor]):
        x_proj, w_hh, b_hh, h0, out = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        if g_hf is None:
            g_hf = torch.zeros(h0.shape, dtype=torch.float32, device=h0.device)
        return gru_layer_backward(x_proj, w_hh, b_hh, h0, out, g_out, g_hf)


def gru_layer(
    x_proj: torch.Tensor,   # (B, T, 3H): x @ W_ih^T + b_ih
    w_hh: torch.Tensor,     # (3H, H)
    b_hh: torch.Tensor,     # (3H,)
    h0: torch.Tensor,       # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one GRU layer's recurrence, differentiable with respect to all
    four inputs. Returns (outputs (B, T, H), h_T (B, H)). K1 runs once per
    call, in inference mode too; K2 once per backward."""
    return GRULayerFn.apply(x_proj, w_hh, b_hh, h0)
