"""Plain stage 1: 'valid' Gaussian smoothing, the day layer and softsign,
patching, a 5-layer GRU and the head, in float32 on one trial.

Written from the reference's description (``model_training/rnn_model.py``,
``evaluate_model_helpers.py:87-115``): torch.nn.GRU's gate order (r, z, n),
n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h = (1 - z) n + z h. It
imports nothing of the program and takes the benchmark's state dict. The
control computes every product's operands in float8 (e4m3), the precision
below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def gaussian_kernel(std: float, size: int, trunc_thresh: float = 0.01) -> np.ndarray:
    """The reference's smoothing kernel: a Gaussian impulse response of
    ``size`` taps (scipy's truncate 4.0), taps <= 0.01 dropped, renormalized."""
    radius = int(4.0 * std + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / std) ** 2)
    phi = phi / phi.sum()
    imp = np.zeros(size, dtype=np.float64)
    center = size // 2
    lo, hi = max(0, center - radius), min(size, center + radius + 1)
    imp[lo:hi] = phi[(lo - (center - radius)):(hi - (center - radius))]
    kern = imp[imp > trunc_thresh]
    return (kern / kern.sum()).astype(np.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(torch.float32)


def n_frames(model_cfg: Dict, n_bins: int) -> int:
    k = len(gaussian_kernel(model_cfg["smooth_kernel_std"], model_cfg["smooth_kernel_size"]))
    return (n_bins - k + 1 - model_cfg["patch_size"]) // model_cfg["patch_stride"] + 1


@torch.no_grad()
def log_posteriors(sd: Dict[str, torch.Tensor], x: np.ndarray, day: int, model_cfg: Dict,
                   device, control: bool = False) -> np.ndarray:
    """(T, D) features of one trial -> (P, C) float32 log-probs."""
    q = _fp8 if control else (lambda t: t)
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    kern = torch.from_numpy(gaussian_kernel(model_cfg["smooth_kernel_std"],
                                            model_cfg["smooth_kernel_size"])).to(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    K = kern.shape[0]
    T = xt.shape[0] - K + 1
    sm = torch.zeros((T, xt.shape[1]), device=device)
    for k in range(K):
        sm += kern[k] * xt[k: k + T]
    h = q(sm) @ q(f32(sd[f"day_weights.{day}"])) + f32(sd[f"day_biases.{day}"])[0]
    h = h / (1.0 + h.abs())
    ps, st = model_cfg["patch_size"], model_cfg["patch_stride"]
    h = h.unfold(0, ps, st).transpose(1, 2).reshape(-1, ps * h.shape[1])  # (P, ps*D)
    H = model_cfg["n_units"]
    for k in range(model_cfg["n_layers"]):
        xp = q(h) @ q(f32(sd[f"gru.weight_ih_l{k}"])).t() + f32(sd[f"gru.bias_ih_l{k}"])
        w_hh = q(f32(sd[f"gru.weight_hh_l{k}"])).t()
        b_hh = f32(sd[f"gru.bias_hh_l{k}"])
        hk = f32(sd["h0"]).reshape(H)
        outs = []
        for t in range(xp.shape[0]):
            gh = q(hk) @ w_hh + b_hh
            r = torch.sigmoid(xp[t, :H] + gh[:H])
            z = torch.sigmoid(xp[t, H: 2 * H] + gh[H: 2 * H])
            n = torch.tanh(xp[t, 2 * H:] + r * gh[2 * H:])
            hk = (1.0 - z) * n + z * hk
            outs.append(hk)
        h = torch.stack(outs)
    logits = q(h) @ q(f32(sd["out.weight"])).t() + f32(sd["out.bias"])
    return torch.log_softmax(logits, dim=-1).cpu().numpy()
