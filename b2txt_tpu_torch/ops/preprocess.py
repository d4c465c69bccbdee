"""Fused augmentation + smoothing: the Triton kernel K3 and its plain version.

Counterpart of ``b2txt_tpu/ops/pallas/preprocess.py`` (``fused_preprocess``,
:109, kernel body from ``_make_kernel``, :51, launched at :166). Per batch
row the kernel adds white noise (T, C), a constant offset (1, C) and, if
on, a random walk (cumsum along channels), then applies the truncated
Gaussian smoothing with 'same' zero padding, in one read and one write of
(B, T, C). The static gain (a per-row C×C product) and the random cut stay
outside the kernel, in PyTorch, as in the JAX package (:130-145).

Two noise modes, as in the JAX kernel:

- on-chip: normals from Philox (``tl.randn``) keyed by a seed and the
  element's index; they are not the TPU's random bits, so the two agree in
  distribution only;
- passed in: a (B, 2T+1, C) tensor of standard normals, consumed in the
  JAX kernel's order (:156-164): white (T rows), offset (1 row), walk (T
  rows), each only if its std is > 0.

What bounds K3 on the card: bytes. It does ~2·9 flops per element against
8 bytes moved (or 16 with the noise passed in). Each program owns
BLOCK_T output rows of one batch row and every channel; for each of the 9
taps it reloads the shifted input rows (from L1/L2, not device memory) and
regenerates their noise from the same Philox counters, so every element
gets the same noise in every tap without a second pass.

``fused_preprocess`` launches K3 for CUDA tensors and takes the plain
version for CPU tensors, with normals drawn on the host (the JAX package's
interpret path does the same).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .augment import TransformArgs, apply_gain, shift_left_and_zero
from .smoothing import gauss_smooth, gaussian_kernel

BLOCK_T = 8


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


# The kernel's source. Triton reads these functions' text and compiles them
# when ``_kernel()`` wraps them with ``triton.jit`` at the first launch;
# ``tl`` and ``_noisy_rows`` are module globals bound at that moment, so the
# module imports where triton is not installed.
def _noisy_rows_src(x_ptr, noise_ptr, b, rows, c, T, C, NR, seed,
                    row_white, row_offset, row_walk, base_offset, base_walk,
                    white_std, offset_std, walk_std,
                    HAS_WHITE: tl.constexpr, HAS_OFFSET: tl.constexpr,
                    HAS_WALK: tl.constexpr, ON_CHIP: tl.constexpr):
    """Input rows ``rows`` ([BT, 1]) of batch row b with their noise added;
    zero outside 0 <= row < T (the smoothing's 'same' padding)."""
    m = (rows >= 0) & (rows < T) & (c < C)
    x = tl.load(x_ptr + (b * T + rows) * C + c, mask=m, other=0.0)
    if HAS_WHITE:
        if ON_CHIP:
            n = tl.randn(seed, (b * T + rows) * C + c)
        else:
            n = tl.load(noise_ptr + (b * NR + row_white + rows) * C + c, mask=m, other=0.0)
        x = x + white_std * n
    if HAS_OFFSET:
        if ON_CHIP:
            n1 = tl.randn(seed, base_offset + b * C + c)
        else:
            n1 = tl.load(noise_ptr + (b * NR + row_offset) * C + c, mask=c < C, other=0.0)
        x = x + offset_std * n1
    if HAS_WALK:
        if ON_CHIP:
            n2 = tl.randn(seed, base_walk + (b * T + rows) * C + c)
        else:
            n2 = tl.load(noise_ptr + (b * NR + row_walk + rows) * C + c, mask=m, other=0.0)
        x = x + tl.cumsum(tl.where(c < C, walk_std * n2, 0.0), axis=1)
    return tl.where(m, x, 0.0)


def _preprocess_kernel_src(x_ptr, noise_ptr, out_ptr, kern_ptr, seed, T, C, NR,
                           row_white, row_offset, row_walk, base_offset, base_walk,
                           white_std, offset_std, walk_std,
                           HAS_WHITE: tl.constexpr, HAS_OFFSET: tl.constexpr,
                           HAS_WALK: tl.constexpr, ON_CHIP: tl.constexpr,
                           SMOOTH: tl.constexpr, K: tl.constexpr,
                           BLOCK_T: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program (b, i): output rows [i*BLOCK_T, i*BLOCK_T + BLOCK_T) of batch
    row b, every channel. The taps are summed in the plain version's order
    (tap 1, then tap 0 fused onto it, then taps 2.. K-1), each a fused
    multiply-add."""
    b = tl.program_id(0)
    t = tl.program_id(1) * BLOCK_T + tl.arange(0, BLOCK_T)[:, None]
    c = tl.arange(0, BLOCK_C)[None, :]
    if SMOOTH and K > 1:
        acc = tl.load(kern_ptr + 1) * _noisy_rows(
            x_ptr, noise_ptr, b, t + 1 - K // 2, c, T, C, NR, seed, row_white, row_offset,
            row_walk, base_offset, base_walk, white_std, offset_std, walk_std,
            HAS_WHITE, HAS_OFFSET, HAS_WALK, ON_CHIP)
        acc = tl.fma(tl.load(kern_ptr), _noisy_rows(
            x_ptr, noise_ptr, b, t - K // 2, c, T, C, NR, seed, row_white, row_offset,
            row_walk, base_offset, base_walk, white_std, offset_std, walk_std,
            HAS_WHITE, HAS_OFFSET, HAS_WALK, ON_CHIP), acc)
        for k in tl.static_range(2, K):
            acc = tl.fma(tl.load(kern_ptr + k), _noisy_rows(
                x_ptr, noise_ptr, b, t + k - K // 2, c, T, C, NR, seed, row_white,
                row_offset, row_walk, base_offset, base_walk, white_std, offset_std,
                walk_std, HAS_WHITE, HAS_OFFSET, HAS_WALK, ON_CHIP), acc)
    else:
        acc = _noisy_rows(
            x_ptr, noise_ptr, b, t, c, T, C, NR, seed, row_white, row_offset, row_walk,
            base_offset, base_walk, white_std, offset_std, walk_std,
            HAS_WHITE, HAS_OFFSET, HAS_WALK, ON_CHIP)
        if SMOOTH:
            acc = tl.load(kern_ptr) * acc
    tl.store(out_ptr + (b * T + t) * C + c, acc, mask=(t < T) & (c < C))


@functools.lru_cache(maxsize=None)
def _kernel():
    """K3 as a ``triton.jit`` kernel, compiled by Triton at its first launch."""
    import triton
    import triton.language

    globals()["tl"] = triton.language
    globals()["_noisy_rows"] = triton.jit(_noisy_rows_src)
    return triton.jit(_preprocess_kernel_src)


def _launch(x: torch.Tensor, args: TransformArgs, training: bool, seed: int,
            noise: Optional[torch.Tensor]) -> torch.Tensor:
    """K3 on a contiguous (B, T, C) float32 CUDA tensor."""
    import triton

    B, T, C = x.shape
    if 2 * B * T * C + B * C >= 2**31:
        raise ValueError(f"fused_preprocess: (B, T, C)={B, T, C} overflows the 32-bit counters")
    kern = torch.tensor(gaussian_kernel(args.smooth_kernel_std, args.smooth_kernel_size),
                        dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    noisy = _needs_noise(args, training)
    rw, ro, rk = noise_rows(args, T)
    grid = (B, triton.cdiv(T, BLOCK_T))
    _kernel()[grid](
        x, noise if noise is not None else x, out, kern, seed, T, C,
        noise.shape[1] if noise is not None else 0, rw, ro, rk, B * T * C, B * T * C + B * C,
        float(args.white_noise_std), float(args.constant_offset_std),
        float(args.random_walk_std),
        HAS_WHITE=noisy and args.white_noise_std > 0,
        HAS_OFFSET=noisy and args.constant_offset_std > 0,
        HAS_WALK=noisy and args.random_walk_std > 0,
        ON_CHIP=noise is None, SMOOTH=bool(args.smooth_data),
        K=int(kern.numel()) if args.smooth_data else 1,
        BLOCK_T=BLOCK_T, BLOCK_C=triton.next_power_of_2(C), num_warps=4,
    )
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
    device). On CUDA tensors the noise comes from Philox inside K3, keyed by
    ``seed``, unless ``noise`` (B, 2T+1, C) is given; ``fused_preprocess.
    launches`` counts K3 launches. On CPU tensors the normals come from
    ``generator`` (or ``noise``) and the plain version runs.
    """
    if features.dim() != 3:
        raise ValueError(f"features must be (B, T, C), got {tuple(features.shape)}")
    if args.random_walk_std > 0 and args.random_walk_axis not in (-1, 2):
        raise ValueError("fused_preprocess takes the random walk along channels only")
    B, T, C = features.shape
    dev = features.device
    gain = cut = None
    if training and args.static_gain_std > 0:
        gain = torch.randn((B, C, C), generator=generator, device=dev)
    if training and args.random_cut > 0:
        cut = torch.randint(0, args.random_cut, (), generator=generator, device=dev)
    if dev.type == "cpu":
        if noise is None and _needs_noise(args, training):
            noise = torch.randn((B, 2 * T + 1, C), generator=generator)
        return fused_preprocess_reference(features, n_time_steps, args, training,
                                          noise, cut, gain)
    if dev.type != "cuda":
        raise ValueError(f"fused_preprocess runs on CUDA or CPU tensors, got {dev}")
    if noise is not None and (tuple(noise.shape) != (B, 2 * T + 1, C) or noise.device != dev):
        raise ValueError(f"noise must be ({B}, {2 * T + 1}, {C}) on {dev}")

    x = features.float()
    if gain is not None:
        x = apply_gain(x, gain, args.static_gain_std)
    if cut is not None:
        x = shift_left_and_zero(x, cut)
        n_time_steps = n_time_steps - cut
    out = _launch(x.contiguous(), args, training, int(seed) & 0x7FFFFFFF,
                  noise.float().contiguous() if noise is not None else None)
    fused_preprocess.launches += 1
    return out, n_time_steps


fused_preprocess.launches = 0
