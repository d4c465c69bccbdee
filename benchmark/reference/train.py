"""Plain training step of the 5-layer GRU decoder, in float32.

Written from the reference's ``rnn_trainer.py``: augmentation (white noise,
constant offset, a random cut of the first bins, then 'same' Gaussian
smoothing), the day layer and softsign, input dropout, patching, the GRU
with dropout between layers, the head, CTC over log-softmax (mean over the
batch), clipping by global norm, and AdamW in three groups (biases without
weight decay; day parameters on their own schedule; one step count for
every leaf) with the cosine-warmup schedule. Autograd computes the gradients. It imports nothing of the
program. The random values of each step (the augmentation's draws and the
dropout masks) are the program's, handed over: the reference follows the
program's draws and checks them apart.

``control="fp8"`` computes every product's operands in float8 (e4m3);
``control="half_batch"`` takes the loss's mean over the first half of the
rows only: the two faults whose readings bound the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .gru import gaussian_kernel


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(torch.float32)


def lr_at(step: int, lr_max: float, lr_min: float, decay: int, warmup: int) -> float:
    """The reference's cosine schedule with linear warmup."""
    ratio = lr_min / lr_max
    if step >= decay:
        return lr_max * ratio
    if step < warmup:
        return lr_max * step / max(1.0, float(warmup))
    progress = (step - warmup) / max(1.0, float(decay - warmup))
    return lr_max * max(ratio, ratio + (1.0 - ratio) * 0.5 * (1.0 + math.cos(math.pi * progress)))


def group_of(name: str) -> str:
    if name.startswith("day_"):
        return "day"
    if name.startswith("gru.bias") or name == "out.bias":
        return "bias"
    return "other"


def smooth_same(x: torch.Tensor, std: float, size: int) -> torch.Tensor:
    kern = torch.from_numpy(gaussian_kernel(std, size)).to(x.device)
    K = kern.shape[0]
    half = K // 2
    xp = F.pad(x, (0, 0, half, K - 1 - half))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + kern[k] * xp[:, k: k + x.shape[1]]
    return out


def loss_of(params: Dict[str, torch.Tensor], batch: Dict, draws: Dict, masks: List[torch.Tensor],
            cfg: Dict, control: str = "") -> torch.Tensor:
    q = _fp8 if control == "fp8" else (lambda t: t)
    m, tr = cfg["model"], cfg["train"]
    aug = tr["augment"]
    x = batch["features"].float()
    x = x + draws["white"] * aug["white_noise_std"] + draws["offset"] * aug["constant_offset_std"]
    cut = int(draws["cut"])
    T = x.shape[1]
    if cut:
        x = torch.cat([x[:, cut:], torch.zeros_like(x[:, :cut])], dim=1)
    n_time = batch["n_time_steps"] - cut
    x = smooth_same(x, m["smooth_kernel_std"], m["smooth_kernel_size"])
    day = batch["days"]
    W = torch.stack([params[f"day_weights.{int(d)}"] for d in day.tolist()])
    b = torch.stack([params[f"day_biases.{int(d)}"][0] for d in day.tolist()])
    x = torch.bmm(q(x), q(W)) + b[:, None, :]
    x = x / (1.0 + x.abs())
    p_in = tr["input_layer_dropout"]
    x = torch.where(masks[0], x / (1.0 - p_in), torch.zeros((), device=x.device))
    ps, st = m["patch_size"], m["patch_stride"]
    x = x.unfold(1, ps, st).transpose(2, 3).reshape(x.shape[0], -1, ps * x.shape[2])
    H, L = m["n_units"], m["n_layers"]
    B = x.shape[0]
    for k in range(L):
        xp = q(x) @ q(params[f"gru.weight_ih_l{k}"]).t() + params[f"gru.bias_ih_l{k}"]
        w_hh = q(params[f"gru.weight_hh_l{k}"]).t()
        b_hh = params[f"gru.bias_hh_l{k}"]
        h = params["h0"].reshape(1, H).expand(B, H)
        outs = []
        for t in range(xp.shape[1]):
            gh = q(h) @ w_hh + b_hh
            r = torch.sigmoid(xp[:, t, :H] + gh[:, :H])
            z = torch.sigmoid(xp[:, t, H: 2 * H] + gh[:, H: 2 * H])
            n = torch.tanh(xp[:, t, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            outs.append(h)
        x = torch.stack(outs, dim=1)
        if k < L - 1:
            p = tr["rnn_dropout"]
            x = torch.where(masks[1 + k], x / (1.0 - p), torch.zeros((), device=x.device))
    logits = q(x) @ q(params["out.weight"]).t() + params["out.bias"]
    lp = torch.log_softmax(logits, dim=-1)
    adjusted = (n_time - ps) // st + 1
    losses = F.ctc_loss(lp.transpose(0, 1), batch["labels"].long(), adjusted.long(),
                        batch["label_lens"].long(), blank=0, reduction="none")
    if control == "half_batch":
        return losses[: B // 2].mean()
    return losses.mean()


def train_steps(init: Dict[str, torch.Tensor], steps: Sequence[Dict], cfg: Dict,
                control: str = "") -> Dict:
    """Follow the program's first steps from ``init``. Each step is
    {"batch", "draws", "masks"}. Returns the losses, each step's clipped
    gradients' leaf norms, and the parameters after the last step."""
    tr = cfg["train"]
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in init.items()}
    names = list(params)
    groups = {"bias": [], "day": [], "other": []}
    for n in names:
        groups[group_of(n)].append(params[n])
    wd = {"bias": 0.0, "day": tr["weight_decay_day"], "other": tr["weight_decay"]}
    opt = torch.optim.AdamW([{"params": ps, "label": g, "weight_decay": wd[g], "lr": 0.0}
                             for g, ps in groups.items() if ps],
                            betas=(tr["beta0"], tr["beta1"]), eps=tr["epsilon"], foreach=False)
    losses, grad_norms = [], []
    for i, s in enumerate(steps):
        loss = loss_of(params, s["batch"], s["draws"], s["masks"], cfg, control)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        # every leaf steps every step (a leaf the batch does not reach with
        # a zero gradient), so AdamW's step count is one count for all, as
        # optax counts it
        for n in names:
            if params[n].grad is None:
                params[n].grad = torch.zeros_like(params[n])
        grads = [params[n].grad for n in names]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if norm >= tr["grad_norm_clip_value"]:
            for g in grads:
                g.mul_(tr["grad_norm_clip_value"] / norm.float())
        grad_norms.append({n: float(g.double().norm()) for n, g in zip(names, grads)})
        for grp in opt.param_groups:
            day = grp["label"] == "day"
            grp["lr"] = lr_at(i, tr["lr_max_day" if day else "lr_max"],
                              tr["lr_min_day" if day else "lr_min"],
                              tr["lr_decay_steps_day" if day else "lr_decay_steps"],
                              tr["lr_warmup_steps_day" if day else "lr_warmup_steps"])
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad_norms": grad_norms,
            "params": {n: p.detach() for n, p in params.items()}}
