"""Gaussian temporal smoothing of neural features.

Counterpart of ``b2txt_tpu/ops/smoothing.py``. The kernel is built exactly as
the JAX package builds it (the reference's scipy impulse response, taps
<= 0.01 dropped, renormalized), and applied as a sum of shifted, scaled
copies with the multiply-adds fused as XLA fuses them, so the result equals
the JAX package's bit for bit. No ``F.conv1d``: a float32 convolution on the
card runs through cuDNN in TF32 by default, which would break exact parity.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def gaussian_kernel(std: float = 2.0, size: int = 100, trunc_thresh: float = 0.01) -> Tuple[float, ...]:
    """The truncated, renormalized smoothing kernel: an impulse at
    ``size // 2`` filtered with a Gaussian of ``std`` (scipy's default
    truncate=4.0), taps <= ``trunc_thresh`` removed, the rest renormalized to
    sum 1. Each tap is a float32 value."""
    radius = int(4.0 * std + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / std) ** 2)
    phi = phi / phi.sum()
    imp = np.zeros(size, dtype=np.float64)
    center = size // 2
    lo = max(0, center - radius)
    hi = min(size, center + radius + 1)
    imp[lo:hi] = phi[(lo - (center - radius)):(hi - (center - radius))]
    keep = imp > trunc_thresh
    kernel = imp[keep]
    kernel = kernel / kernel.sum()
    return tuple(float(v) for v in kernel.astype(np.float32))


def kernel_array(std: float = 2.0, size: int = 100) -> np.ndarray:
    return np.asarray(gaussian_kernel(std, size), dtype=np.float32)


def gauss_smooth(
    inputs: torch.Tensor,
    std: float = 2.0,
    size: int = 100,
    padding: str = "same",
) -> torch.Tensor:
    """Smooth ``inputs`` of shape (B, T, C) (or (T, C)) along the time axis.

    padding='same'  → output T matches input T, zero-padded at the edges.
    padding='valid' → output T = T - K + 1 (the inference path).
    """
    kern = gaussian_kernel(std, size)
    K = len(kern)
    squeeze = inputs.dim() == 2
    if squeeze:
        inputs = inputs[None]
    T = inputs.shape[1]

    if padding == "same":
        half = K // 2
        padded = F.pad(inputs, (0, 0, half, K - 1 - half))
        out_T = T
    elif padding == "valid":
        padded = inputs
        out_T = T - K + 1
    else:
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")

    # XLA compiles the JAX sum ``out + w * x`` into fused multiply-adds: the
    # zero start folds away and tap 0 fuses onto the rounded product of tap 1.
    # float64 holds a float32 product exactly, so a float64 sum rounded to
    # float32 is the fused multiply-add (but for a double rounding, which
    # needs the float64 sum to land exactly on a float32 tie).
    def fma(acc: torch.Tensor, k: int) -> torch.Tensor:
        return (acc.double() + kern[k] * padded[:, k : k + out_T].double()).to(inputs.dtype)

    if K == 1:
        out = kern[0] * padded[:, :out_T]
    else:
        out = fma(kern[1] * padded[:, 1 : 1 + out_T], 0)
        for k in range(2, K):
            out = fma(out, k)

    if squeeze:
        out = out[0]
    return out
