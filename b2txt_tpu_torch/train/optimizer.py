"""Optimizer + LR schedules: 3-param-group AdamW with per-group cosine/linear
warmup decay, and clipping by global norm.

Counterpart of ``b2txt_tpu/train/optimizer.py`` (the reference's
rnn_trainer.py:259-363). Biases (gru.bias*, out.bias) get weight decay 0;
day parameters get their own lr/decay/warmup schedule and weight decay;
everything else (W_ih, W_hh, out.weight, h0) gets the main schedule. It is
``torch.optim.AdamW`` with one param group per label; ``set_learning_rates``
sets each group's lr from its schedule before every step, so step 0 runs at
the schedule's value at 0 (0 during warmup), as optax and the reference's
LambdaLR do.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch import nn

from ..utils.config import TrainConfig

Schedule = Callable[[int], float]


def lr_lambda(step: int, min_lr_ratio: float, decay_steps: int, warmup_steps: int) -> float:
    """The reference's cosine multiplier (rnn_trainer.py:306-326)."""
    if step >= decay_steps:
        return min_lr_ratio
    if step < warmup_steps:
        return step / max(1.0, float(warmup_steps))
    progress = (step - warmup_steps) / max(1.0, float(decay_steps - warmup_steps))
    cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
    return max(min_lr_ratio, min_lr_ratio + (1.0 - min_lr_ratio) * cosine)


def make_schedule(cfg: TrainConfig, day: bool) -> Schedule:
    if day:
        lr_max, lr_min = cfg.lr_max_day, cfg.lr_min_day
        decay, warmup = cfg.lr_decay_steps_day, cfg.lr_warmup_steps_day
    else:
        lr_max, lr_min = cfg.lr_max, cfg.lr_min
        decay, warmup = cfg.lr_decay_steps, cfg.lr_warmup_steps

    if cfg.lr_scheduler_type == "cosine":
        def sched(step: int) -> float:
            return lr_max * lr_lambda(step, lr_min / lr_max, decay, warmup)
        return sched
    if cfg.lr_scheduler_type == "linear":
        # torch LinearLR: factor interpolates 1.0 → end_factor over total_iters.
        end_factor = lr_min / lr_max

        def sched(step: int) -> float:
            frac = min(step / max(1, decay), 1.0)
            return lr_max * (1.0 + frac * (end_factor - 1.0))
        return sched
    raise ValueError(f"Invalid lr_scheduler_type: {cfg.lr_scheduler_type}")


def param_label(name: str) -> str:
    """A parameter's optimizer group (rnn_trainer.py:267-269)."""
    if name.startswith("day_"):
        return "day"
    if name.startswith("gru.bias") or name == "out.bias":
        return "bias"
    return "other"


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> Tuple[torch.optim.AdamW, Dict[str, Schedule]]:
    """AdamW over three param groups (each tagged with its ``label``) and
    the schedule of each label. Clipping is ``clip_by_global_norm_``."""
    groups: Dict[str, list] = {"bias": [], "day": [], "other": []}
    for name, p in model.named_parameters():
        groups[param_label(name)].append(p)
    decay = {"bias": 0.0, "day": cfg.weight_decay_day, "other": cfg.weight_decay}
    opt = torch.optim.AdamW(
        [{"params": ps, "label": label, "weight_decay": decay[label], "lr": 0.0}
         for label, ps in groups.items() if ps],
        betas=(cfg.beta0, cfg.beta1), eps=cfg.epsilon,
    )
    main, day = make_schedule(cfg, day=False), make_schedule(cfg, day=True)
    return opt, {"bias": main, "day": day, "other": main}


def set_learning_rates(opt: torch.optim.Optimizer, schedules: Dict[str, Schedule], step: int) -> None:
    for group in opt.param_groups:
        group["lr"] = schedules[group["label"]](step)


def trainability_mask(cfg: TrainConfig, model: nn.Module) -> Dict[str, bool]:
    """True where a parameter trains (rnn_trainer.py:249-254: only 'gru*'
    params freeze with rnn_trainable=False, only 'day*' params with
    input_trainable=False; the head and h0 always train)."""
    gru_on = bool(cfg.model.rnn_trainable)
    day_on = bool(cfg.model.input_network.input_trainable)
    return {
        name: gru_on if name.startswith("gru.") else day_on if name.startswith("day_") else True
        for name, _ in model.named_parameters()
    }


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """In place, as optax.clip_by_global_norm: g stays if norm < max_norm,
    else becomes (g / norm) * max_norm. No epsilon, no host sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
