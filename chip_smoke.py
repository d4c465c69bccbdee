#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (b2txt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the serving and training paths from
``b2txt_tpu_torch`` (the CUDA sources with nvcc, all at once; the Triton
kernel at its first launch), holds each kernel against its plain PyTorch
version on the card (and, for the GRU recurrence, measures how far two
correct versions drift apart by weight scale, against a float64 version),
then:

- serves 16 planted requests through the full-width model (512 features,
  5×768 GRU, patch 14/4, 45 days, bf16) and the host beam search over a
  1,000-word lexicon;
- trains the full-width model (``TrainConfig()`` defaults: bf16, dropout,
  augmentation, batch 64 over 4 days) for 20 steps with the augmentations in
  PyTorch and 5 with the fused kernel, on synthetic trials in memory, and
  holds one step's gradients through the kernels against the plain path.

Prints one JSON line per phase, then a line of kernel figures
(``{"kernels": [...]}``), the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero before the last line. Exits non-zero at once without a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor-core and
# f32 CUDA-core rates. Used only to state each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

GRU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |h - h_plain| over all steps
# K2 against its plain version: max |x - x_plain| / max(1, max |x_plain|) over
# each of dxp, dW_hh, db_hh and dh0. f32: summation order only (~1e-6 seen on
# the CPU against JAX). bf16: dxp and dpre round to bf16 each step, so a last-
# bit flip (2^-8 relative) moves a value and, through dh, later steps.
GRU_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K3 against its plain version with the same normals: the same float32 ops
# in the same order, so rounding only; the random walk's cumsum along 512
# channels sums in another order (a parallel scan), so it gets more room.
PREPROCESS_TOL = {"noise": 1e-5, "walk": 1e-4}
# The training step's parameter gradients, kernel path against plain path:
# ||g - g_plain|| / ||g_plain|| for each parameter. f32: summation order
# through 5 layers and 125 steps. bf16: the forward's h_t rounds to bf16 in
# both paths, so one-ulp differences in h move the loss and every gradient.
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# The same step's loss, |loss - loss_plain| / |loss_plain|: f32 sums in
# another order only; bf16 moves with the one-ulp differences in h above.
TRAIN_LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
TRAIN_SEED = 10
TRAIN_STEPS, FUSED_STEPS, TIMED_FROM = 20, 5, 5
TRAIN_SESSIONS, TRIALS_PER_SESSION = 8, 24
WARMUP_STEPS = 10   # TrainConfig() has 1000: a 25-step run would sit at lr ~0
# (B, T, H, W_hh): B=40 covers two batch chunks; "decoder_init" is the W_hh of
# GRUDecoder's own (orthogonal) init, at the serving shape
KERNEL_CASES = [(1, 7, 16, "contractive"), (5, 33, 40, "contractive"),
                (40, 11, 72, "contractive"), (32, 125, 768, "contractive")]
WITNESS_STEPS = (0, 4, 24, 49, 99, 124)
N_REQUESTS = 16
BINS = 520          # bins per request: 125 patch frames after smoothing and patching
VOCAB = 1000
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_bound(B: int, T: int, H: int, dtype: str):
    """Least time for one layer's recurrence: each input read once, each
    output written once, against the 2·B·T·H·3H multiply-adds of h·W_hhᵀ."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (B * T * 3 * H + 3 * H * H + 3 * H + B * H + B * T * H + B * H)
    flops = 2.0 * B * T * H * 3 * H
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    """Every CUDA source of the port, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from b2txt_tpu_torch.ops._build import gru_bwd_library, gru_fwd_library

    t0 = time.perf_counter()
    libs = {"gru_fwd.cu": gru_fwd_library, "gru_bwd.cu": gru_bwd_library}
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    wall = time.perf_counter() - t0
    for name, b in built.items():
        emit({"phase": "build", "source": f"b2txt_tpu_torch/csrc/{name}",
              "library": b.path.name, "nvcc_s": b.seconds, "wall_s_all": wall})
        print(b.ptxas_report.strip(), flush=True)


def gru_inputs(B, T, H, weights, gen):
    """One layer's f32 inputs on the card, with a non-zero W_hh of one kind:

    - "contractive": normal, scale 0.5/sqrt(H) (spectral radius ~0.5);
    - "random_0.3": normal, scale 0.3 (spectral radius ~0.3·sqrt(H), ~8 at
      H=768: a chaotic recurrence);
    - "decoder_init": layer 0 of a GRUDecoder at ``TrainConfig()`` defaults
      with its own init (orthogonal W_hh), x_proj its input projection of
      random features after the day layer and patching, h0 its learnable h0.
    """
    import torch

    kw = dict(generator=gen, device="cuda")
    if weights == "decoder_init":
        from b2txt_tpu_torch.models.gru_decoder import GRUDecoder, extract_patches
        from b2txt_tpu_torch.utils.config import TrainConfig

        mc = TrainConfig().model
        assert H == mc.n_units, (H, mc.n_units)
        model = GRUDecoder(mc, 1, 41, device="cuda",
                           generator=torch.Generator().manual_seed(SEED))
        bins = (T - 1) * mc.patch_stride + mc.patch_size
        feats = torch.randn((B, bins, mc.n_input_features), **kw)
        with torch.no_grad():
            x = model.day_layer(feats, torch.zeros((B,), dtype=torch.long, device="cuda"))
            x = extract_patches(x, mc.patch_size, mc.patch_stride)
            x_proj = x @ model.gru.weight_ih_l0.t() + model.gru.bias_ih_l0
            return [t.detach().contiguous() for t in (
                x_proj, model.gru.weight_hh_l0, model.gru.bias_hh_l0,
                model.h0.reshape(1, H).expand(B, H))]
    scale = {"contractive": 0.5 / H ** 0.5, "random_0.3": 0.3}[weights]
    x_proj = torch.randn((B, T, 3 * H), **kw)
    w_hh = torch.randn((3 * H, H), **kw) * scale
    b_hh = torch.randn((3 * H,), **kw) * 0.1
    h0 = torch.randn((B, H), **kw) * 0.5
    return [x_proj, w_hh, b_hh, h0]


def gru_plain_f64(x_proj, w_hh, b_hh, h0):
    """The plain recurrence in float64 on the same (already rounded) inputs,
    with no rounding of h between steps: the trajectory the f32 and bf16
    versions both approximate."""
    import torch

    x, wt, b, h = x_proj.double(), w_hh.double().t(), b_hh.double(), h0.double()
    H = wt.shape[0]
    outs = []
    for t in range(x.shape[1]):
        hh = h @ wt + b
        xp = x[:, t]
        r = torch.sigmoid(xp[:, :H] + hh[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hh[:, H : 2 * H])
        n = torch.tanh(xp[:, 2 * H :] + r * hh[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=1)


def phase_gru_witness(B, T, H):
    """How far apart two correct versions of one recurrence drift, by W_hh
    kind: the kernel against the plain version in the same dtype, and each
    against the plain version in float64. Max |difference| at a few steps."""
    import torch

    from b2txt_tpu_torch.ops.gru import gru_layer_forward, gru_layer_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    steps = [s for s in WITNESS_STEPS if s < T]

    def per_step(a, b):
        d = (a.double() - b.double()).abs().amax(dim=(0, 2))
        return [float(d[s]) for s in steps]

    for weights in ("random_0.3", "contractive", "decoder_init"):
        inputs = gru_inputs(B, T, H, weights, gen)
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype).contiguous() for t in inputs]
            kernel, _ = gru_layer_forward(*args)
            plain, _ = gru_layer_reference(*args)
            exact = gru_plain_f64(*args)
            emit({"phase": "gru_witness", "B": B, "T": T, "H": H, "weights": weights,
                  "dtype": str(dtype).replace("torch.", ""), "steps": steps,
                  "kernel_vs_plain": per_step(kernel, plain),
                  "plain_vs_f64": per_step(plain, exact),
                  "kernel_vs_f64": per_step(kernel, exact)})


def phase_kernel_gru_fwd(cases):
    """K1 against its plain version; returns {(B, T, H, W_hh, dtype): figures}."""
    import torch

    from b2txt_tpu_torch.ops.gru import gru_layer_forward, gru_layer_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    figures = {}
    for B, T, H, weights in cases:
        inputs = gru_inputs(B, T, H, weights, gen)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = [t.to(dtype).contiguous() for t in inputs]
            out, h_t = gru_layer_forward(*args)
            torch.cuda.synchronize()
            ref_out, ref_h = gru_layer_reference(*args)
            err = max((out.float() - ref_out.float()).abs().max().item(),
                      (h_t.float() - ref_h.float()).abs().max().item())
            ok = bool(torch.isfinite(out).all().item()) and err <= GRU_TOL[name]
            ms = cuda_ms(lambda: gru_layer_forward(*args), iters=20)
            plain_ms = cuda_ms(lambda: gru_layer_reference(*args), iters=3, warmup=1)
            # yardstick only: one cuDNN GRU layer at the same B, T, H (it also
            # does the input projection); the port never calls it
            lib = torch.nn.GRU(H, H, batch_first=True).to("cuda", dtype)
            lib.flatten_parameters()
            x = torch.randn((B, T, H), generator=gen, device="cuda").to(dtype)
            with torch.inference_mode():
                library_ms = cuda_ms(lambda: lib(x), iters=10)
            bound_ms, bound_by = gru_bound(B, T, H, name)
            fig = {"phase": "kernel_gru_fwd", "B": B, "T": T, "H": H, "weights": weights,
                   "dtype": name,
                   "max_abs_err": err, "tol": GRU_TOL[name], "ok": ok, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(fig)
            if not ok:
                raise RuntimeError(f"gru_fwd kernel disagrees with its plain version: {fig}")
            figures[(B, T, H, weights, name)] = fig
    return figures


def gru_bwd_bound(B: int, T: int, H: int, dtype: str):
    """Least time for one layer's backward as the port runs it (K2 and the
    dW_hh product): x_proj, out, g_out, W_hh, b_hh, h0 and g_hf read once;
    dxp, dW_hh, db_hh and dh0 written once; three products of
    2·B·T·H·3H flops (the gates' rematerialization, dh's product with W_hh,
    and dW_hh), all at the dtype's rate: dW_hh's operands are dpre and h in
    the dtype, so a bf16 product with f32 sums forms the same values."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (size * (B * T * 3 * H + 2 * B * T * H + 3 * H * H + 3 * H + B * H
                      + B * T * 3 * H + 3 * H * H + 3 * H)
              + 4 * (B * H + B * H))
    flops = 2.0 * B * T * H * 3 * H
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b) -> float:
    """max |a - b| / max(1, max |b|)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def cudnn_gru_bwd_ms(B, T, H, dtype, gen):
    """Yardstick only, never called by the port: one cuDNN GRU layer's
    backward at the same shape (input, weights and h0 gradients), as its
    forward+backward time minus its forward time. None if cuDNN refuses
    the dtype, with the reason."""
    import torch

    try:
        lib = torch.nn.GRU(H, H, batch_first=True).to("cuda", dtype)
        x = torch.randn((B, T, H), generator=gen, device="cuda").to(dtype).requires_grad_()
        g = torch.randn((B, T, H), generator=gen, device="cuda").to(dtype)

        def fwd():
            return lib(x)[0]

        def fwd_bwd():
            lib.zero_grad(set_to_none=True)
            fwd().backward(g)

        fwd_bwd()
        return cuda_ms(fwd_bwd, iters=10) - cuda_ms(fwd, iters=10), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def phase_kernel_gru_bwd(cases):
    """K2 against its plain version on the same forward outputs and
    cotangents; returns {(B, T, H, W_hh, dtype): figures}."""
    import torch

    from b2txt_tpu_torch.ops.gru import (gru_layer_backward, gru_layer_backward_reference,
                                         gru_layer_forward)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    figures = {}
    for B, T, H, weights in cases:
        inputs = gru_inputs(B, T, H, weights, gen)
        g_out32 = torch.randn((B, T, H), generator=gen, device="cuda")
        g_hf = torch.randn((B, H), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = [t.to(dtype).contiguous() for t in inputs]
            out, _ = gru_layer_forward(*args)
            bwd_args = args + [out, g_out32.to(dtype), g_hf]
            got = gru_layer_backward(*bwd_args)
            torch.cuda.synchronize()
            ref = gru_layer_backward_reference(*bwd_args)
            errs = {k: rel_err(a, b) for k, a, b in zip(("dxp", "dw_hh", "db_hh", "dh0"), got, ref)}
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            err = max(errs.values())
            ok = finite and err <= GRU_BWD_TOL[name]
            ms = cuda_ms(lambda: gru_layer_backward(*bwd_args), iters=10)
            plain_ms = cuda_ms(lambda: gru_layer_backward_reference(*bwd_args), iters=2, warmup=1)
            big = H >= 256
            library_ms, library_note = (cudnn_gru_bwd_ms(B, T, H, dtype, gen) if big
                                        else (None, "not timed at a toy shape"))
            bound_ms, bound_by = gru_bwd_bound(B, T, H, name)
            fig = {"phase": "kernel_gru_bwd", "B": B, "T": T, "H": H, "weights": weights,
                   "dtype": name, "rel_err": errs, "max_abs_err": err,
                   "tol": GRU_BWD_TOL[name], "ok": ok, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_note": library_note,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(fig)
            if not ok:
                raise RuntimeError(f"gru_bwd kernel disagrees with its plain version: {fig}")
            figures[(B, T, H, weights, name)] = fig
    return figures


def fused_against_plain(x, nt, args, training: bool, gen) -> float:
    """K3 with its normals passed in against its plain version on the same
    normals and cut: max |difference|, or inf if K3's output is not finite
    or its lengths differ."""
    import torch

    from b2txt_tpu_torch.ops.preprocess import fused_preprocess, fused_preprocess_reference

    B, T, C = x.shape
    noise = torch.randn((B, 2 * T + 1, C), generator=gen, device="cuda")
    seeds = [torch.Generator(device="cuda").manual_seed(7) for _ in range(2)]
    got, nt_got = fused_preprocess(x, nt, args, training, generator=seeds[0], noise=noise)
    torch.cuda.synchronize()
    cut = (torch.randint(0, args.random_cut, (), generator=seeds[1], device="cuda")
           if training else 0)
    ref, nt_ref = fused_preprocess_reference(x, nt, args, training, noise, cut)
    if not (bool(torch.isfinite(got).all()) and torch.equal(nt_got, nt_ref)):
        return float("inf")
    return float((got - ref).abs().max())


def phase_kernel_fused_preprocess(B: int, T: int, C: int):
    """K3 against its plain version on the same normals (train and eval),
    and its on-chip noise by statistics. Returns the figures of the default
    training knobs in the on-chip mode."""
    import torch

    from b2txt_tpu_torch.ops.augment import TransformArgs
    from b2txt_tpu_torch.ops.preprocess import fused_preprocess, fused_preprocess_reference
    from b2txt_tpu_torch.utils.config import DataTransforms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((B, T, C), generator=gen, device="cuda")
    nt = torch.full((B,), T, dtype=torch.long, device="cuda")
    defaults = TransformArgs.from_config(DataTransforms())
    worst = 0.0
    cases = [("train", defaults, True, "noise"), ("eval", defaults, False, "noise"),
             ("train_walk", defaults._replace(random_walk_std=0.1), True, "walk")]
    for label, args, training, tol_kind in cases:
        err = fused_against_plain(x, nt, args, training, gen)
        tol = PREPROCESS_TOL[tol_kind]
        ok = err <= tol
        emit({"phase": "kernel_fused_preprocess", "mode": f"noise passed in, {label}",
              "B": B, "T": T, "C": C, "max_abs_err": err, "tol": tol, "ok": ok})
        if not ok:
            raise RuntimeError(f"fused_preprocess ({label}) disagrees with its plain version")
        worst = max(worst, err)

    # on-chip Philox noise, held by its statistics
    zeros = torch.zeros((B, T, C), device="cuda")
    white = TransformArgs(white_noise_std=1.0, constant_offset_std=0.0, random_cut=0,
                          smooth_data=False)
    w, _ = fused_preprocess(zeros, nt, white, True, seed=1)
    offset = TransformArgs(white_noise_std=0.0, constant_offset_std=0.5, random_cut=0,
                           smooth_data=False)
    o, _ = fused_preprocess(zeros, nt, offset, True, seed=2)
    on_chip, _ = fused_preprocess(x, nt, defaults, True, generator=gen, seed=3)
    torch.cuda.synchronize()
    stats = {"white_mean": float(w.mean()), "white_std": float(w.std()),
             "white_row_corr": float(torch.corrcoef(torch.stack([w[0].flatten(),
                                                                 w[1].flatten()]))[0, 1]),
             "offset_std_along_T": float(o.std(dim=1).max()),
             "offset_std": float(o[:, 0, :].std()),
             "default_train_finite": bool(torch.isfinite(on_chip).all())}
    checks = [abs(stats["white_mean"]) < 0.01, abs(stats["white_std"] - 1.0) < 0.01,
              abs(stats["white_row_corr"]) < 0.05, stats["offset_std_along_T"] < 1e-6,
              abs(stats["offset_std"] - 0.5) < 0.02, stats["default_train_finite"]]
    emit({"phase": "kernel_fused_preprocess", "mode": "on-chip noise", **stats,
          "ok": all(checks)})
    if not all(checks):
        raise RuntimeError(f"fused_preprocess on-chip noise statistics are off: {stats}")

    ms = cuda_ms(lambda: fused_preprocess(x, nt, defaults, True, generator=gen, seed=4), iters=20)
    host_noise = torch.randn((B, 2 * T + 1, C), generator=gen, device="cuda")
    plain_ms = cuda_ms(lambda: fused_preprocess_reference(x, nt, defaults, True, host_noise, 1),
                       iters=5)
    nbytes = 2 * 4 * B * T * C   # one read and one write of (B, T, C) f32
    fig = {"phase": "kernel_fused_preprocess", "mode": "timing, on-chip noise, TrainConfig knobs",
           "B": B, "T": T, "C": C, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}
    emit(fig)
    return fig


def train_config():
    """``TrainConfig()`` at full width, with synthetic sessions and the
    warm-up shortened; returns (cfg, what was changed)."""
    import tempfile

    from b2txt_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig()
    cfg.dataset.sessions = [f"synthetic.{i:02d}" for i in range(TRAIN_SESSIONS)]
    cfg.dataset.dataset_probability_val = [1] * TRAIN_SESSIONS
    cfg.num_training_batches = TRAIN_STEPS + FUSED_STEPS
    reduced = {"lr_warmup_steps": [cfg.lr_warmup_steps, WARMUP_STEPS],
               "lr_warmup_steps_day": [cfg.lr_warmup_steps_day, WARMUP_STEPS]}
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = WARMUP_STEPS
    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg.output_dir, cfg.checkpoint_dir = out, out + "/checkpoint"
    cfg.seed = TRAIN_SEED
    return cfg, reduced


def step_grads(trainer, batch, dtype):
    """One step's loss and parameter gradients, with dropout and
    augmentation off (smoothing only), in ``dtype``; nothing is updated."""
    import torch

    saved = trainer.compute_dtype
    trainer.compute_dtype = dtype
    try:
        trainer.model.zero_grad(set_to_none=True)
        logits, adjusted = trainer._logits(batch, training=False)
        _, loss = trainer._loss(logits, adjusted, batch)
        loss.backward()
    finally:
        trainer.compute_dtype = saved
    grads = {n: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
             for n, p in trainer.model.named_parameters()}
    trainer.model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_train(counters):
    """The port's Trainer at full width: 20 steps with the augmentations in
    PyTorch, then 5 with K3; gradients of one step, kernel path against
    plain path, in f32 and bf16. Returns the figures and launch counts."""
    import torch

    from b2txt_tpu_torch.data.loader import batch_to_device
    from b2txt_tpu_torch.data.synthetic import synthetic_trials
    from b2txt_tpu_torch.ops import gru as gru_ops
    from b2txt_tpu_torch.train import Trainer

    cfg, reduced = train_config()
    t0 = time.perf_counter()

    def draw(split: str, offset: int, per_session: int):
        # synthetic_trials adds hash(split) % 997 to its seed, as the JAX
        # package's write_synthetic_sessions does. Python salts str hashes per
        # process, so that term is taken back out: every run draws the same trials.
        seed = TRAIN_SEED + offset + 997 - hash(split) % 997
        return synthetic_trials(cfg.dataset.sessions, trials_per_session=per_session,
                                neural_dim=cfg.dataset.neural_dim, seed=seed, split=split,
                                min_words=9, max_words=13, frames_per_phoneme=8, max_bins=512)

    train_trials = draw("train", 0, TRIALS_PER_SESSION)
    val_trials = draw("val", 500, 4)
    bins = [tr.n_time_steps for ts in train_trials.values() for tr in ts]
    trainer = Trainer(cfg, device="cuda", train_trials=train_trials, val_trials=val_trials)
    setup_s = time.perf_counter() - t0
    batches = [batch_to_device(trainer.train_loader.get_batch(i), "cuda")
               for i in range(TRAIN_STEPS + FUSED_STEPS)]
    torch.cuda.synchronize()

    # gradients of one step, kernel path against plain path (before any update)
    grad_check = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        loss_k, g_k = step_grads(trainer, batches[0], dtype)
        with mock.patch.object(gru_ops, "gru_layer_forward", gru_ops.gru_layer_reference), \
                mock.patch.object(gru_ops, "gru_layer_backward",
                                  gru_ops.gru_layer_backward_reference):
            loss_p, g_p = step_grads(trainer, batches[0], dtype)
        rel = {}
        for n in g_p:
            den = float(g_p[n].double().norm())
            num = float((g_k[n].double() - g_p[n].double()).norm())
            rel[n] = num / den if den > 0 else num
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        grad_check[name] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel_err": loss_rel, "loss_tol": TRAIN_LOSS_TOL[name],
                            "max_rel_err": rel[worst], "worst_param": worst,
                            "tol": TRAIN_GRAD_TOL[name],
                            "ok": rel[worst] <= TRAIN_GRAD_TOL[name]
                            and loss_rel <= TRAIN_LOSS_TOL[name]}

    runs = {}
    for label, fused, steps in (("transform_data", False, TRAIN_STEPS),
                                ("fused_preprocess", True, FUSED_STEPS)):
        cfg.use_fused_preprocess = fused
        todo = batches[:steps] if not fused else batches[TRAIN_STEPS:]
        losses, step_ms = [], []
        for fn in counters.values():
            fn.launches = 0
        for batch in todo:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, grad_norm = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
        launches = {name: fn.launches for name, fn in counters.items()}
        timed = step_ms[TIMED_FROM:] if len(step_ms) > TIMED_FROM else step_ms[1:]
        runs[label] = {"steps": steps, "losses": losses, "launches": launches,
                       "step_ms": step_ms, "ms_per_step": sum(timed) / len(timed),
                       "ms_per_step_over": f"steps {len(step_ms) - len(timed)}..{len(step_ms) - 1}"}

    # K3 against its plain version at the shape the fused run gave it
    fused_batch = batches[TRAIN_STEPS]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    fused_vs_plain = {
        "shape": list(fused_batch["input_features"].shape), "tol": PREPROCESS_TOL["noise"],
        **{label: fused_against_plain(fused_batch["input_features"].float(),
                                      fused_batch["n_time_steps"], trainer.transform_args,
                                      training, gen)
           for label, training in (("train", True), ("eval", False))}}

    cfg.use_fused_preprocess = False
    profile = profile_stage1(lambda: trainer.train_step(batches[1]), top=8)
    t1 = time.perf_counter()
    val = trainer.validation()
    val_s = time.perf_counter() - t1
    fig = {"phase": "train", "config": "TrainConfig() defaults", "reduced": reduced,
           "n_input_features": cfg.model.n_input_features, "n_units": cfg.model.n_units,
           "n_layers": cfg.model.n_layers, "patch": [cfg.model.patch_size, cfg.model.patch_stride],
           "batch_size": cfg.dataset.batch_size, "days_per_batch": cfg.dataset.days_per_batch,
           "sessions": TRAIN_SESSIONS, "use_amp": cfg.use_amp,
           "bins_min_max": [min(bins), max(bins)],
           "padded_bins": int(batches[0]["input_features"].shape[1]),
           "setup_s": setup_s, "runs": runs, "grad_check": grad_check,
           "fused_vs_plain": fused_vs_plain,
           "step_profile": profile, "val_PER": val["avg_PER"], "val_loss": val["avg_loss"],
           "val_s": val_s}
    emit(fig)
    return fig


def build_world(vocab_size: int, seed: int):
    """A synthetic decode world as the JAX package's bench builds it
    (bench.py build_world): 3-9-phone random words, a corpus covering every
    word, and a trigram trained with the port's python trainer."""
    from b2txt_tpu_torch.lm import Lexicon, train_ngram
    from b2txt_tpu_torch.utils.phonemes import LOGIT_TO_PHONEME

    rng = np.random.default_rng(seed)
    phones = LOGIT_TO_PHONEME[1:40]
    words = {}
    while len(words) < vocab_size:
        L = rng.integers(3, 10)
        pron = [phones[i] for i in rng.integers(0, 39, L)]
        words["w" + "".join(p.lower() for p in pron)] = pron
    wl = list(words)
    perm = rng.permutation(vocab_size)
    corpus = [[wl[j] for j in perm[i : i + 6]] for i in range(0, vocab_size, 6)]
    for _ in range(max(3000, vocab_size // 5)):
        corpus.append([wl[i] for i in rng.integers(0, vocab_size, rng.integers(3, 10))])
    return Lexicon.from_words(words), train_ngram(corpus, order=3), wl, rng


def plant_requests(lexicon, wl, rng, n: int, T: int):
    """n (sentence, (T,) frame labels) pairs, words drawn until the
    phone+SIL budget fills (bench.py make_planted_utts)."""
    from b2txt_tpu_torch.models.planted import plant_frame_labels

    budget = max(8, min(44, (T - 24) // 11))
    out = []
    while len(out) < n:
        sent, ids = [], []
        while True:
            w = wl[int(rng.integers(0, len(wl)))]
            pron = lexicon.prons[lexicon.word_ids[w]][0]
            if ids and len(ids) + len(pron) + 1 > budget:
                break
            sent.append(w)
            ids.extend(pron)
            ids.append(40)  # SIL at word end
        labels, n_planted = plant_frame_labels(rng, ids, T)
        if n_planted == len(ids):
            out.append((" ".join(sent), labels))
    return out


def phase_serve(cfg, device: str, compute_dtype, n_requests: int, bins: int,
                vocab: int, counters):
    """Planted requests → smoothing → GRUDecoder → DecoderService(python).
    ``counters`` maps kernel name → its wrapper; each count is set to 0
    just before the main path and read just after. Returns the figures,
    the launch counts and the run's logits and inputs for the checks."""
    import torch

    from b2txt_tpu_torch.data.synthetic import phoneme_code
    from b2txt_tpu_torch.evaluate.harness import _batched_inference
    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
    from b2txt_tpu_torch.models.planted import features_on_device, planted_params
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.config import DecodeConfig

    t0 = time.perf_counter()
    lexicon, lm, wl, rng = build_world(vocab, SEED)
    requests = plant_requests(lexicon, wl, rng, n_requests, bins)
    world_s = time.perf_counter() - t0

    code = phoneme_code(cfg.model.n_input_features)
    model = GRUDecoder(cfg.model, 45, 41, device=device)
    model.load_state_dict(planted_params(cfg.model, 45, code))
    labels = torch.from_numpy(np.stack([lab for _, lab in requests])).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    feats = features_on_device(torch.from_numpy(code).to(device), labels, gen, noise=0.3)
    feats_list = list(feats.cpu().numpy())
    service = DecoderService(
        lexicon, lm,
        DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=100),
        searcher_backend="python", channel_order="model",
    )
    # time_bucket=8 divides 520: requests are not padded, the GRU runs 125 frames
    infer = dict(day_idx=0, cfg=cfg, compute_dtype=compute_dtype, batch_size=32, time_bucket=8)

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits = _batched_inference(model, feats_list, **infer)
    t1 = time.perf_counter()
    outs = service.decode_utterances(logits)
    t2 = time.perf_counter()
    launches = {name: fn.launches for name, fn in counters.items()}

    n_batches = (n_requests + infer["batch_size"] - 1) // infer["batch_size"]
    exact = sum(o.sentence == s for o, (s, _) in zip(outs, requests))
    fig = {"phase": "serve", "requests": n_requests, "bins": bins,
           "frames": int(logits[0].shape[0]), "vocab": vocab, "batches": n_batches,
           "exact": exact, "world_build_s": world_s,
           "main_path_stage1_s": t1 - t0, "decode_s_per_request": (t2 - t1) / n_requests,
           "launches": launches}
    return fig, model, feats_list, infer, logits, outs, requests


def profile_stage1(run, top: int = 6):
    """One call (a stage-1 batch, a training step) under torch.profiler: device time by kernel name, the
    summed device time and the host wall time around the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    events = prof.key_averages()
    host_keys = {e.key for e in events if not str(getattr(e, "device_type", "")).endswith("CUDA")}
    for e in events:
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue  # operator rows; their kernels are rows of their own
        if e.key in host_keys:
            continue  # the device span of a host annotation (Optimizer.step): counted already
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_idle_share": 1 - device_ms / wall_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": n} for ms, k, n in rows[:top]]}


def check_serve(fig, logits, plain, cfg, main_shape) -> list:
    problems = []
    n_batches = fig["batches"]
    if fig["launches"]["gru_fwd"] != cfg.model.n_layers * n_batches:
        problems.append(f"gru_fwd launched {fig['launches']['gru_fwd']} times, "
                        f"expected {cfg.model.n_layers} per forward batch")
    if not fig["logits_finite"] or any(a.shape != (main_shape[1], 41) for a in logits):
        problems.append("logits are not finite (P, 41) arrays")
    if not fig["logits_argmax_equal"]:
        problems.append("kernel-path and plain-path logits differ in argmax")
    if not all(np.allclose(a, b, rtol=2e-2, atol=2e-2) for a, b in zip(logits, plain)):
        problems.append("kernel-path logits outside bf16 tolerance of the plain path")
    if fig["exact"] != N_REQUESTS:
        problems.append(f"{fig['exact']}/{N_REQUESTS} requests returned their planted sentence")
    return problems


def check_train(fig, n_layers) -> list:
    problems = []
    for label, run in fig["runs"].items():
        if not all(np.isfinite(run["losses"])):
            problems.append(f"train ({label}): a loss is not finite: {run['losses']}")
        fused = label == "fused_preprocess"
        want = {"gru_fwd": n_layers * run["steps"], "gru_bwd": n_layers * run["steps"],
                "fused_preprocess": run["steps"] if fused else 0}
        if run["launches"] != want:
            problems.append(f"train ({label}): launches {run['launches']}, expected {want}")
    for name, g in fig["grad_check"].items():
        if not g["ok"]:
            problems.append(f"train: {name} loss and gradients, kernel path vs plain path: {g}")
    fused = fig["fused_vs_plain"]
    if max(fused["train"], fused["eval"]) > fused["tol"]:
        problems.append(f"train: fused_preprocess disagrees with its plain version: {fused}")
    return problems


def kernel_entry(name, route, source, replaces, launches, launches_per, k, shape_keys):
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "launches_per": launches_per,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "shape": {key: k[key] for key in shape_keys}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from b2txt_tpu_torch.evaluate.harness import _batched_inference
    from b2txt_tpu_torch.models import gru_decoder
    from b2txt_tpu_torch.ops.gru import gru_layer_backward, gru_layer_forward, gru_layer_reference
    from b2txt_tpu_torch.ops.preprocess import fused_preprocess
    from b2txt_tpu_torch.utils.config import TrainConfig

    phase_build()

    cfg = TrainConfig()
    main_shape = (N_REQUESTS, (BINS - 8 - cfg.model.patch_size) // cfg.model.patch_stride + 1,
                  cfg.model.n_units)
    train_shape = (cfg.dataset.batch_size, main_shape[1], cfg.model.n_units)
    phase_gru_witness(*main_shape)
    fwd_figs = phase_kernel_gru_fwd(KERNEL_CASES + [main_shape + ("contractive",),
                                                    main_shape + ("decoder_init",)])
    bwd_figs = phase_kernel_gru_bwd(KERNEL_CASES + [train_shape + ("contractive",),
                                                    train_shape + ("decoder_init",)])
    pre_fig = phase_kernel_fused_preprocess(cfg.dataset.batch_size, BINS,
                                            cfg.model.n_input_features)

    fig, model, feats_list, infer, logits, outs, requests = phase_serve(
        cfg, "cuda", torch.bfloat16, N_REQUESTS, BINS, VOCAB, {"gru_fwd": gru_layer_forward})
    n_batches = fig["batches"]
    # stage-1 time per batch, host clock around work that ends in a sync
    for _ in range(2):
        _batched_inference(model, feats_list, **infer)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        _batched_inference(model, feats_list, **infer)
    torch.cuda.synchronize()
    fig["stage1_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / (reps * n_batches)
    fig["stage1_profile"] = profile_stage1(lambda: _batched_inference(model, feats_list, **infer))
    with mock.patch.object(gru_decoder, "gru_layer", gru_layer_reference):
        plain = _batched_inference(model, feats_list, **infer)
    fig["logits_max_abs_err"] = max(float(np.abs(a - b).max()) for a, b in zip(logits, plain))
    fig["logits_argmax_equal"] = all(
        np.array_equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(logits, plain))
    fig["logits_finite"] = all(bool(np.isfinite(a).all()) for a in logits)
    fig["logits_tol"] = "rtol=atol=2e-2 (bf16)"
    emit(fig)
    problems = check_serve(fig, logits, plain, cfg, main_shape)
    train_fig = phase_train({"gru_fwd": gru_layer_forward, "gru_bwd": gru_layer_backward,
                             "fused_preprocess": fused_preprocess})
    problems += check_train(train_fig, cfg.model.n_layers)
    if problems:
        raise RuntimeError("; ".join(problems))

    k_fwd = {**fwd_figs[main_shape + ("decoder_init", "bfloat16")], "weights": "decoder_init"}
    k_bwd = {**bwd_figs[train_shape + ("decoder_init", "bfloat16")], "weights": "decoder_init"}
    runs = train_fig["runs"]
    fused = train_fig["fused_vs_plain"]
    pre_fig = {**pre_fig, "max_abs_err": max(pre_fig["max_abs_err"], fused["train"], fused["eval"])}
    emit({"kernels": [
        kernel_entry("gru_fwd", "cuda", "b2txt_tpu_torch/csrc/gru_fwd.cu",
                     "b2txt_tpu/ops/pallas/gru.py:32", fig["launches"]["gru_fwd"],
                     f"serve run: {fig['batches']} forward batch of {N_REQUESTS} requests", k_fwd,
                     ("B", "T", "H", "dtype", "weights")),
        kernel_entry("gru_bwd", "cuda", "b2txt_tpu_torch/csrc/gru_bwd.cu",
                     "b2txt_tpu/ops/pallas/gru.py:122",
                     runs["transform_data"]["launches"]["gru_bwd"],
                     f"train run: {TRAIN_STEPS} steps", k_bwd,
                     ("B", "T", "H", "dtype", "weights")),
        kernel_entry("fused_preprocess", "triton", "b2txt_tpu_torch/ops/preprocess.py",
                     "b2txt_tpu/ops/pallas/preprocess.py:51",
                     runs["fused_preprocess"]["launches"]["fused_preprocess"],
                     f"fused train run: {FUSED_STEPS} steps", pre_fig,
                     ("B", "T", "C")),
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
