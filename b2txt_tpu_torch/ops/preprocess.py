"""Fused augmentation + smoothing: the CUDA kernel K3 and its plain version.

Counterpart of ``b2txt_tpu/ops/pallas/preprocess.py`` (``fused_preprocess``,
:109, kernel body from ``_make_kernel``, :51, launched at :166). K3,
``csrc/preprocess.cu``, takes each batch row's input rows after the random
cut, adds white noise (T, C), a constant offset (1, C) and, if on, a random
walk (cumsum along channels), then applies the truncated Gaussian smoothing
with 'same' zero padding, in one read and one write of (B, T, C). The static
gain (a per-row C×C product) stays outside the kernel, in PyTorch, as in the
JAX package (:130-135); the cut is read by the kernel from the device
integer drawn here, and the lengths are lowered in PyTorch.

Two noise modes, as in the JAX kernel:

- on-chip: normals from a counter-based Philox4x32-10 inside K3, keyed by a
  seed and each element's index. ``philox_noise`` computes the same normals
  in PyTorch, so the plain version reproduces the kernel's output (not the
  TPU's random bits: the two packages agree in distribution only);
- passed in: a (B, 2T+1, C) tensor of standard normals, consumed in the
  JAX kernel's order (:156-164): white (T rows), offset (1 row), walk (T
  rows), each only if its std is > 0.

What bounds K3 on the card: bytes (8 per element, 16 with the normals passed
in); its design is in the source's header.

``fused_preprocess`` launches K3 for CUDA tensors and takes the plain
version for CPU tensors, with the same Philox normals.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .augment import TransformArgs, apply_gain, shift_left_and_zero
from .smoothing import gauss_smooth, gaussian_kernel


def noise_rows(args: TransformArgs, T: int) -> Tuple[int, int, int]:
    """First row of white, offset and walk normals in the (B, 2T+1, C)
    noise layout; a row index is only read where its std is > 0."""
    row_white = 0
    row_offset = row_white + (T if args.white_noise_std > 0 else 0)
    row_walk = row_offset + (1 if args.constant_offset_std > 0 else 0)
    return row_white, row_offset, row_walk


def _needs_noise(args: TransformArgs, training: bool) -> bool:
    return training and (args.white_noise_std > 0 or args.constant_offset_std > 0
                         or args.random_walk_std > 0)


def preprocess_body_reference(
    x: torch.Tensor, args: TransformArgs, training: bool, noise: Optional[torch.Tensor],
) -> torch.Tensor:
    """The plain version of what K3 computes: noise adds, then 'same'
    smoothing. x: (B, T, C) float32; noise: (B, 2T+1, C) or None."""
    T = x.shape[1]
    if _needs_noise(args, training):
        rw, ro, rk = noise_rows(args, T)
        if args.white_noise_std > 0:
            x = x + args.white_noise_std * noise[:, rw : rw + T]
        if args.constant_offset_std > 0:
            x = x + args.constant_offset_std * noise[:, ro : ro + 1]
        if args.random_walk_std > 0:
            x = x + torch.cumsum(args.random_walk_std * noise[:, rk : rk + T], dim=-1)
    if args.smooth_data:
        x = gauss_smooth(x, std=args.smooth_kernel_std, size=args.smooth_kernel_size,
                         padding="same")
    return x


def fused_preprocess_reference(
    features: torch.Tensor,         # (B, T, C) float32
    n_time_steps: torch.Tensor,     # (B,) int
    args: TransformArgs,
    training: bool,
    noise: Optional[torch.Tensor] = None,   # (B, 2T+1, C) standard normals
    cut=0,                                  # int or 0-d tensor in [0, random_cut)
    gain: Optional[torch.Tensor] = None,    # (B, C, C) standard normals
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_preprocess`` with its random values given: gain and cut in
    PyTorch, then ``preprocess_body_reference``."""
    features = features.float()
    if training and args.static_gain_std > 0:
        features = apply_gain(features, gain, args.static_gain_std)
    if training and args.random_cut > 0:
        features = shift_left_and_zero(features, cut)
        n_time_steps = n_time_steps - cut
    return preprocess_body_reference(features, args, training, noise), n_time_steps


# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC 2011), the generator K3 runs; its constants are Random123's.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
TWO_PI_F32 = 6.2831855       # 2π rounded to float32, as the kernel's 6.2831855f
STREAMS = {"white": 0, "offset": 1, "walk": 2}
MAX_TAPS = 16                # the kernel's limits
MAX_WALK_CHANNELS = 1024


def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of m·a for 32-bit m and a (int64 tensors), with
    a split into 16-bit halves so that no product leaves int64."""
    p_lo, p_hi = m * (a & 0xFFFF), m * (a >> 16)
    return (p_hi + (p_lo >> 16)) >> 16, (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of ``counter`` (..., 4) under ``key`` (..., 2), both
    int64 tensors of 32-bit words; returns (..., 4) int64 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _stream_normals(seed: int, stream: int, n: int, device) -> torch.Tensor:
    """Normals of elements 0 .. n-1 of a stream, as K3 draws them: element e
    is word e & 3 of counter (j mod 2^32, j >> 32, stream, 0), j = e >> 2,
    key (seed, 0); Box-Muller on the word pairs (0, 1) and (2, 3) in float32."""
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    counter = torch.stack([j & _MASK32, j >> 32, torch.full_like(j, stream),
                           torch.zeros_like(j)], dim=-1)
    key = torch.tensor([seed & _MASK32, 0], dtype=torch.int64, device=device)
    w = philox4x32_10(counter, key.expand(j.shape[0], 2))
    u = ((w >> 9) * 2 + 1).to(torch.float32) * 2.0**-24   # odd multiples of 2^-24: exact
    r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
    theta = u[:, 1::2] * TWO_PI_F32
    normals = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return normals.reshape(-1)[:n]   # words 0, 1, 2, 3 of each counter in order


def philox_noise(seed: int, B: int, T: int, C: int, args: TransformArgs,
                 device="cpu") -> torch.Tensor:
    """The normals K3 draws on the card for ``seed``, in the (B, 2T+1, C)
    layout of ``noise_rows`` (rows of disabled draws stay 0): white element
    (b·T + t)·C + c of stream 0, offset b·C + c of stream 1, walk (b·T + t)·C
    + c of stream 2, t the row after the cut."""
    noise = torch.zeros((B, 2 * T + 1, C), dtype=torch.float32, device=device)
    rw, ro, rk = noise_rows(args, T)
    if args.white_noise_std > 0:
        noise[:, rw : rw + T] = _stream_normals(seed, STREAMS["white"], B * T * C,
                                                device).view(B, T, C)
    if args.constant_offset_std > 0:
        noise[:, ro] = _stream_normals(seed, STREAMS["offset"], B * C, device).view(B, C)
    if args.random_walk_std > 0:
        noise[:, rk : rk + T] = _stream_normals(seed, STREAMS["walk"], B * T * C,
                                                device).view(B, T, C)
    return noise


@functools.lru_cache(maxsize=16)
def _taps(args: TransformArgs) -> Tuple[int, ctypes.Array]:
    """The smoothing taps as a host float array (one tap of 1.0 with the
    smoothing off); K3 takes them by value."""
    taps = (gaussian_kernel(args.smooth_kernel_std, args.smooth_kernel_size)
            if args.smooth_data else (1.0,))
    if len(taps) > MAX_TAPS:
        raise ValueError(f"fused_preprocess takes at most {MAX_TAPS} smoothing taps, "
                         f"got {len(taps)} (smooth_kernel_std={args.smooth_kernel_std})")
    return len(taps), (ctypes.c_float * len(taps))(*taps)


def launch_preprocess(x: torch.Tensor, args: TransformArgs, training: bool, seed: int,
                      noise: Optional[torch.Tensor], cut: Optional[torch.Tensor]) -> torch.Tensor:
    """K3 on a contiguous (B, T, C) float32 CUDA tensor, the gain applied;
    ``cut`` a 0-d int64 tensor on x's device or None; ``noise`` (B, 2T+1, C)
    float32 contiguous or None (Philox normals keyed by ``seed``)."""
    from ._build import preprocess_library

    B, T, C = x.shape
    noisy = _needs_noise(args, training)
    flags = ((1 if noisy and args.white_noise_std > 0 else 0)
             | (2 if noisy and args.constant_offset_std > 0 else 0)
             | (4 if noisy and args.random_walk_std > 0 else 0)
             | (8 if noise is not None else 0))
    if flags & 4 and C > MAX_WALK_CHANNELS:
        raise ValueError(f"fused_preprocess takes the random walk over at most "
                         f"{MAX_WALK_CHANNELS} channels, got C={C}")
    K, taps = _taps(args)
    rw, ro, rk = noise_rows(args, T)
    out = torch.empty_like(x)
    lib = preprocess_library().lib
    with torch.cuda.device(x.device):
        err = lib.b2t_preprocess(
            x.data_ptr(), noise.data_ptr() if noise is not None else None,
            cut.data_ptr() if cut is not None else None, out.data_ptr(), taps,
            B, T, C, 2 * T + 1, rw, ro, rk, flags, K, seed,
            float(args.white_noise_std), float(args.constant_offset_std),
            float(args.random_walk_std), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.b2t_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_preprocess (B, T, C)={B, T, C} kernel launch failed: "
                           f"cudaError {err}: {msg}")
    return out


def fused_preprocess(
    features: torch.Tensor,          # (B, T, C) float32
    n_time_steps: torch.Tensor,      # (B,) int
    args: TransformArgs,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused replacement for ``ops.augment.transform_data``.

    Gain normals and the cut are drawn from ``generator`` (on features'
    device). The noise is ``noise`` (B, 2T+1, C) if given, else the Philox
    normals keyed by ``seed`` (inside K3 on the card, ``philox_noise`` on the
    CPU, the same numbers). CUDA tensors launch K3 (``fused_preprocess.
    launches`` counts them); CPU tensors take the plain version.
    """
    if features.dim() != 3:
        raise ValueError(f"features must be (B, T, C), got {tuple(features.shape)}")
    if args.random_walk_std > 0 and args.random_walk_axis not in (-1, 2):
        raise ValueError("fused_preprocess takes the random walk along channels only")
    B, T, C = features.shape
    dev = features.device
    seed = int(seed) & 0x7FFFFFFF
    gain = cut = None
    if training and args.static_gain_std > 0:
        gain = torch.randn((B, C, C), generator=generator, device=dev)
    if training and args.random_cut > 0:
        cut = torch.randint(0, args.random_cut, (), generator=generator, device=dev)
    if dev.type == "cpu":
        if noise is None and _needs_noise(args, training):
            noise = philox_noise(seed, B, T, C, args)
        return fused_preprocess_reference(features, n_time_steps, args, training,
                                          noise, cut, gain)
    if dev.type != "cuda":
        raise ValueError(f"fused_preprocess runs on CUDA or CPU tensors, got {dev}")
    if noise is not None and (tuple(noise.shape) != (B, 2 * T + 1, C) or noise.device != dev):
        raise ValueError(f"noise must be ({B}, {2 * T + 1}, {C}) on {dev}")

    x = features.float()
    if gain is not None:
        x = apply_gain(x, gain, args.static_gain_std)
    out = launch_preprocess(x.contiguous(), args, training, seed,
                            noise.float().contiguous() if noise is not None else None, cut)
    fused_preprocess.launches += 1
    if cut is not None:
        n_time_steps = n_time_steps - cut
    return out, n_time_steps


fused_preprocess.launches = 0
