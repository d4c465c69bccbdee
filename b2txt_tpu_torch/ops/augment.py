"""Training-time data augmentations.

Counterpart of ``b2txt_tpu/ops/augment.py`` (the reference's
rnn_trainer.py:436-484): in order, static gain, white noise, constant
offset, random walk, random time cut, then 'same' Gaussian smoothing.

The random cut shifts the sequence left by ``cut`` and zeroes the tail,
keeping T fixed, and lowers the time-step counts by ``cut``, as the JAX
package does; the cut stays a device tensor, so no step waits on the host.

The random values are drawn apart from their use (``draw_transform``), so a
test can hand ``transform_data`` the JAX package's own draws: with the same
draws and the default knobs (noise, offset, cut, smoothing) the result
equals the JAX package's ``transform_data`` bit for bit on the CPU, when
that runs op by op. The random walk's cumsum and the gain's product sum in
another order (a float32 ulp apart), and under ``jax.jit`` XLA's fusion may
move a sum by one ulp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.config import DataTransforms
from .smoothing import gauss_smooth


class TransformArgs(NamedTuple):
    """Hyperparameters of the augmentation pipeline."""

    white_noise_std: float = 1.0
    constant_offset_std: float = 0.2
    random_walk_std: float = 0.0
    random_walk_axis: int = -1
    static_gain_std: float = 0.0
    random_cut: int = 3
    smooth_data: bool = True
    smooth_kernel_std: float = 2.0
    smooth_kernel_size: int = 100

    @classmethod
    def from_config(cls, c: DataTransforms) -> "TransformArgs":
        return cls(
            white_noise_std=float(c.white_noise_std),
            constant_offset_std=float(c.constant_offset_std),
            random_walk_std=float(c.random_walk_std),
            random_walk_axis=int(c.random_walk_axis),
            static_gain_std=float(c.static_gain_std),
            random_cut=int(c.random_cut),
            smooth_data=bool(c.smooth_data),
            smooth_kernel_std=float(c.smooth_kernel_std),
            smooth_kernel_size=int(c.smooth_kernel_size),
        )


@dataclass
class TransformDraws:
    """The random values of one ``transform_data`` call; None where the
    augmentation is off. Normals are standard, unscaled."""

    gain: Optional[torch.Tensor] = None     # (B, C, C)
    white: Optional[torch.Tensor] = None    # (B, T, C)
    offset: Optional[torch.Tensor] = None   # (B, 1, C)
    walk: Optional[torch.Tensor] = None     # (B, T, C)
    cut: Optional[torch.Tensor] = None      # () int64, in [0, random_cut)


def draw_transform(
    features: torch.Tensor, args: TransformArgs, generator: Optional[torch.Generator] = None,
) -> TransformDraws:
    """Draw what ``transform_data(training=True)`` needs, on features'
    device, from ``generator`` (which must live on that device)."""
    B, T, C = features.shape
    kw = dict(generator=generator, device=features.device, dtype=torch.float32)

    def normal(shape, on):
        return torch.randn(shape, **kw) if on else None

    return TransformDraws(
        gain=normal((B, C, C), args.static_gain_std > 0),
        white=normal((B, T, C), args.white_noise_std > 0),
        offset=normal((B, 1, C), args.constant_offset_std > 0),
        walk=normal((B, T, C), args.random_walk_std > 0),
        cut=(torch.randint(0, args.random_cut, (), generator=generator, device=features.device)
             if args.random_cut > 0 else None),
    )


def shift_left_and_zero(features: torch.Tensor, cut) -> torch.Tensor:
    """features[:, t, :] := features[:, t + cut, :], zeros past T - cut.
    ``cut``: an int or a 0-d integer tensor on features' device."""
    T = features.shape[1]
    t = torch.arange(T, device=features.device)
    src = torch.clamp(t + cut, max=T - 1)
    keep = (t < T - cut)[None, :, None]
    return torch.where(keep, features[:, src], torch.zeros((), dtype=features.dtype,
                                                           device=features.device))


def apply_gain(features: torch.Tensor, gain: torch.Tensor, std: float) -> torch.Tensor:
    """Per-row channel mixing by (I + std · gain)."""
    C = features.shape[2]
    warp = torch.eye(C, dtype=features.dtype, device=features.device)[None] + gain * std
    return torch.bmm(features, warp)


def transform_data(
    features: torch.Tensor,
    n_time_steps: torch.Tensor,
    args: TransformArgs,
    training: bool,
    generator: Optional[torch.Generator] = None,
    draws: Optional[TransformDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augmentations (train only) + smoothing (always) of a (B, T, C) batch.

    Returns (features, n_time_steps); n_time_steps is lowered by the random
    cut. The random values come from ``draws`` or, if None, from
    ``draw_transform(features, args, generator)``.
    """
    if training:
        if draws is None:
            draws = draw_transform(features, args, generator)
        if args.static_gain_std > 0:
            features = apply_gain(features, draws.gain, args.static_gain_std)
        if args.white_noise_std > 0:
            features = features + draws.white * args.white_noise_std
        if args.constant_offset_std > 0:
            features = features + draws.offset * args.constant_offset_std
        if args.random_walk_std > 0:
            walk = torch.cumsum(draws.walk * args.random_walk_std, dim=args.random_walk_axis)
            features = features + walk
        if args.random_cut > 0:
            features = shift_left_and_zero(features, draws.cut)
            n_time_steps = n_time_steps - draws.cut

    if args.smooth_data:
        features = gauss_smooth(
            features, std=args.smooth_kernel_std, size=args.smooth_kernel_size, padding="same",
        )
    return features, n_time_steps
