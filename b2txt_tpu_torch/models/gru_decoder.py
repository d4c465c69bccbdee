"""Day-adapted GRU phoneme decoder.

Counterpart of ``b2txt_tpu/models/gru_decoder.py``: day-specific D×D input
layers (identity init) + softsign, optional input patching (14/4 → first-layer
input 7168), a unidirectional GRU stack (5×768) with a learnable shared h0,
and a linear head to 41 CTC classes.

Parameters carry the reference checkpoint's names (``day_weights.{i}``,
``day_biases.{i}``, ``gru.weight_ih_l{k}``, ``gru.weight_hh_l{k}``,
``gru.bias_ih_l{k}``, ``gru.bias_hh_l{k}``, ``out.weight``, ``out.bias``,
``h0``), so a reference ``state_dict`` loads with ``load_state_dict``.
The input projection and the head are ``torch.matmul``; each layer's
recurrence goes through ``ops.gru.gru_layer``, differentiable, with the CUDA
kernels K1 (forward) and K2 (backward) on the card. ``training=True`` adds
the reference's input dropout (after softsign, before patching) and
inter-layer dropout (not after the last layer), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..ops.gru import gru_layer
from ..utils.config import ModelConfig
from ..utils.device import resolve_device


def _xavier_uniform(shape, generator) -> torch.Tensor:
    fan_out, fan_in = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def _orthogonal(shape, generator) -> torch.Tensor:
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.t()


def _uniform_pm(shape, bound, generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as the JAX package applies it: keep with probability
    1 - p, scale the kept values by 1 / (1 - p), in x's dtype."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def extract_patches(x: torch.Tensor, patch_size: int, patch_stride: int) -> torch.Tensor:
    """(B, T, D) → (B, P, patch_size*D) sliding windows, feature-fastest order."""
    B, _, D = x.shape
    xp = x.unfold(1, patch_size, patch_stride)      # (B, P, D, patch_size)
    return xp.transpose(2, 3).reshape(B, xp.shape[1], patch_size * D)


class _GRUWeights(nn.Module):
    """Holds the stack's tensors under torch.nn.GRU's parameter names."""

    def __init__(self, input_size: int, n_units: int, n_layers: int, generator):
        super().__init__()
        kb = 1.0 / math.sqrt(n_units)
        for k in range(n_layers):
            in_dim = input_size if k == 0 else n_units
            self.register_parameter(
                f"weight_ih_l{k}", nn.Parameter(_xavier_uniform((3 * n_units, in_dim), generator)))
            self.register_parameter(
                f"weight_hh_l{k}", nn.Parameter(_orthogonal((3 * n_units, n_units), generator)))
            self.register_parameter(
                f"bias_ih_l{k}", nn.Parameter(_uniform_pm((3 * n_units,), kb, generator)))
            self.register_parameter(
                f"bias_hh_l{k}", nn.Parameter(_uniform_pm((3 * n_units,), kb, generator)))


class GRUDecoder(nn.Module):
    """``GRUDecoder(cfg, n_days, n_classes)`` with the reference's initial
    distributions, drawn from ``generator`` (a CPU ``torch.Generator``; the
    default is seeded with 0). ``device=None`` puts it on the CUDA card and
    raises if there is none."""

    def __init__(
        self,
        cfg: ModelConfig,
        n_days: int,
        n_classes: int,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        D, H = cfg.n_input_features, cfg.n_units
        self.cfg = cfg
        self.n_days = n_days
        self.n_classes = n_classes
        self.n_layers = cfg.n_layers
        self.patch_size = cfg.patch_size
        self.patch_stride = cfg.patch_stride
        input_size = D * cfg.patch_size if cfg.patch_size > 0 else D

        self.day_weights = nn.ParameterList([nn.Parameter(torch.eye(D)) for _ in range(n_days)])
        self.day_biases = nn.ParameterList([nn.Parameter(torch.zeros(1, D)) for _ in range(n_days)])
        self.gru = _GRUWeights(input_size, H, cfg.n_layers, generator)
        self.out = nn.Linear(H, n_classes)
        kb = 1.0 / math.sqrt(H)
        with torch.no_grad():
            self.out.weight.copy_(_xavier_uniform((n_classes, H), generator))
            self.out.bias.copy_(_uniform_pm((n_classes,), kb, generator))
        self.h0 = nn.Parameter(_xavier_uniform((1, H), generator).reshape(1, 1, H))
        self.to(device)

    def day_layer(self, x: torch.Tensor, day_idx: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Day-specific affine + softsign: (B, T, D) → (B, T, D)."""
        day_w = torch.stack(list(self.day_weights))[day_idx].to(compute_dtype)  # (B, D, D)
        day_b = torch.cat(list(self.day_biases))[day_idx].to(compute_dtype)     # (B, D)
        x = torch.bmm(x.to(compute_dtype), day_w) + day_b[:, None, :]
        return x / (1.0 + torch.abs(x))

    def forward(
        self,
        x: torch.Tensor,
        day_idx: torch.Tensor,
        states: Optional[torch.Tensor] = None,
        return_state: bool = False,
        skip_day_layer: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: (B, T, D) features, day_idx: (B,) int day indices.

        ``training=True`` applies input and inter-layer dropout with the
        config's rates, drawn from ``generator`` (on the model's device).

        ``skip_day_layer=True`` takes inputs already day-projected and patched
        (B, P, patch_size*D) — the streaming path, which feeds patch windows
        with carried GRU state. Returns logits (B, P, C), and the final hidden
        states (L, B, H) if ``return_state``.
        """
        B = x.shape[0]
        H = self.h0.shape[-1]
        if not skip_day_layer:
            x = self.day_layer(x, day_idx, compute_dtype)
            p_in = self.cfg.input_network.input_layer_dropout
            if training and p_in > 0:
                x = dropout(x, p_in, generator)
            if self.patch_size > 0:
                x = extract_patches(x, self.patch_size, self.patch_stride)
        x = x.to(compute_dtype)

        if states is None:
            h = self.h0.reshape(1, 1, H).to(compute_dtype).expand(self.n_layers, B, H)
        else:
            h = states.to(compute_dtype)

        finals = []
        for k in range(self.n_layers):
            w_ih = getattr(self.gru, f"weight_ih_l{k}").to(compute_dtype)
            b_ih = getattr(self.gru, f"bias_ih_l{k}").to(compute_dtype)
            x_proj = torch.matmul(x, w_ih.t()) + b_ih                 # (B, T, 3H)
            x, h_k = gru_layer(
                x_proj.contiguous(),
                getattr(self.gru, f"weight_hh_l{k}").to(compute_dtype).contiguous(),
                getattr(self.gru, f"bias_hh_l{k}").to(compute_dtype).contiguous(),
                h[k].contiguous(),
            )
            finals.append(h_k)
            if training and self.cfg.rnn_dropout > 0 and k < self.n_layers - 1:
                x = dropout(x, self.cfg.rnn_dropout, generator)

        logits = torch.matmul(x, self.out.weight.to(compute_dtype).t()) + self.out.bias.to(compute_dtype)
        if return_state:
            return logits, torch.stack(finals, dim=0)
        return logits
