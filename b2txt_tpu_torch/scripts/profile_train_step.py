"""Ablate the full training step to locate its MFU ceiling.

Counterpart of ``scripts/profile_train_step.py``, with its stages and JSON
lines. It times each stage alone on synthetic batches made on the card:
the augmentations, the forward (with the GRU kernels and with their plain
versions, 1 and 5 layers), CTC, the optimizer update, the full gradient
step, and a batch sweep (64, 128, 256), the recurrence's amortization lever.
Each time is a loop of calls issued back to back between two CUDA events
(the best of 3 such loops); the full step's loop is 10 chained steps, each
taking the last one's weights.

    python -m b2txt_tpu_torch.scripts.profile_train_step
    python -m b2txt_tpu_torch.scripts.profile_train_step --device cpu --features 32 \\
        --units 32 --layers 2 --batches 4,8 --batch 4 --bins 128 --label_len 10 --iters 2

Where it differs from the JAX driver:

  * ``fwd_pallas`` / ``fwd_xla`` become ``fwd_kernel`` (K1, the CUDA C++
    GRU forward) and ``fwd_plain`` (its plain PyTorch version,
    ``ops.gru.gru_layer_reference``): ``plain`` is the counterpart of JAX's
    XLA arm, a correctness reference whose time is not a yardstick, and its
    line says so. ``fwd_layers1`` / ``fwd_layers5`` run the kernels;
  * ``mfu_pct`` is against the H100's dense bf16 peak
    (``utils.profiling.H100_BF16_PEAK_FLOPS``, 989 TFLOP/s), not the
    v5e's 197; the FLOPs are the JAX driver's formula (:102-104) in the
    model's widths (equal to it at full width);
  * new: ``--device`` (the CUDA card by default, an error without one;
    ``cpu`` on request); to cut the run, ``--features``, ``--units``,
    ``--layers`` (default ``TrainConfig()``'s 512, 768, 5), ``--batches``
    ("64,128,256"), ``--batch`` (64, the ablation's), ``--bins`` (512),
    ``--label_len`` (60),
    ``--iters`` (20) and ``--chain`` (10); each full-step line carries the
    K1/K2 launches of its loops.

``main(argv)`` returns the printed objects.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional
from unittest import mock


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m b2txt_tpu_torch.scripts.profile_train_step",
        description="Decompose the training step's device cost "
                    "(transform/forward/loss/backward) at production shapes")
    p.add_argument("--device", default=None,
                   help="where the stages run: the CUDA card by default, 'cpu' to run on "
                        "the CPU")
    p.add_argument("--features", type=int, default=None, help="input features (512)")
    p.add_argument("--units", type=int, default=None, help="GRU units (768)")
    p.add_argument("--layers", type=int, default=None, help="GRU layers (5)")
    p.add_argument("--batches", default="64,128,256", help="the full step's batch sweep")
    p.add_argument("--batch", type=int, default=64, help="the ablation stages' batch")
    p.add_argument("--bins", type=int, default=512)
    p.add_argument("--label_len", type=int, default=60, help="labels per synthetic trial")
    p.add_argument("--iters", type=int, default=20, help="calls per timed loop")
    p.add_argument("--chain", type=int, default=10, help="chained full steps per timed loop")
    return p


def step_flops(cfg, B: int, P: int) -> float:
    """Forward (1×) + backward (2×) matmul FLOPs of one step over P patch
    frames: the JAX driver's formula (125 · (7168 + 4·768 + 768·5) · 2304 · 2
    + 125 · 768 · 41 · 2, times 3B) in the model's widths."""
    m = cfg.model
    H = m.n_units
    in0 = m.n_input_features * max(m.patch_size, 1)
    return 3 * B * (P * (in0 + (m.n_layers - 1) * H + m.n_layers * H) * 3 * H * 2
                    + P * H * 41 * 2)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    args = build_parser().parse_args(argv)

    import torch

    from ..models import gru_decoder
    from ..models.gru_decoder import GRUDecoder
    from ..ops.augment import TransformArgs, transform_data
    from ..ops.ctc import ctc_loss
    from ..ops.gru import gru_layer_reference
    from ..utils.config import TrainConfig
    from ..utils.device import resolve_device
    from ..utils.profiling import (H100_BF16_PEAK_FLOPS, kernel_launches, launches_since,
                                   seconds_per_call)
    from .bench_training import make_synthetic_step

    device = resolve_device(args.device)
    lines: List[Dict[str, object]] = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    def timeit(fn: Callable[[], object], iters: int = args.iters, reps: int = 3) -> float:
        """The best of ``reps`` loops of ``iters`` calls, seconds per call."""
        fn()
        return min(seconds_per_call(fn, iters, device, warmup=0) for _ in range(reps))

    def report(name, s, extra=None):
        emit({"stage": name, "ms": round(s * 1e3, 4), **(extra or {})})

    emit({"backend": device.type})
    cfg = TrainConfig()
    for name, value in (("n_input_features", args.features), ("n_units", args.units),
                        ("n_layers", args.layers)):
        if value is not None:
            setattr(cfg.model, name, value)
    D, S, T = cfg.model.n_input_features, 128, args.bins
    P = (T - cfg.model.patch_size) // cfg.model.patch_stride + 1
    targs = TransformArgs.from_config(cfg.dataset.data_transforms)

    for B in (int(b) for b in args.batches.split(",")):
        flops = step_flops(cfg, B, P)
        one_step, _ = make_synthetic_step(cfg, device, B, T, label_len=args.label_len)

        def chained(n=args.chain):
            for _ in range(n):
                loss = one_step()
            return loss

        before = kernel_launches()
        s = timeit(chained, iters=1) / args.chain
        losses = [float(one_step()) for _ in range(2)]
        report(f"full_step_B{B}", s, {
            "steps_per_sec": round(1 / s, 2),
            "sentences_per_sec": round(B / s, 1),
            "mfu_pct": round(100 * flops / s / H100_BF16_PEAK_FLOPS, 2),
            "flops": flops, "losses": losses,
            "launches": launches_since(before),
        })
        del one_step
        if device.type == "cuda":
            torch.cuda.empty_cache()

    B = args.batch
    gen = torch.Generator(device=device).manual_seed(0)
    feats = torch.randn((B, T, D), generator=gen, device=device)
    labels = torch.randint(1, 41, (B, S), generator=gen, device=device)
    n_time = torch.full((B,), T, dtype=torch.long, device=device)

    report("augment_only", timeit(
        lambda: transform_data(feats, n_time, targs, True, generator=gen)[0].sum()))

    model = GRUDecoder(cfg.model, n_days=45, n_classes=41, device=device,
                       generator=torch.Generator().manual_seed(0))
    day_idx = torch.arange(B, device=device) % 45

    @torch.no_grad()
    def fwd(m):
        return m(feats, day_idx, compute_dtype=torch.bfloat16).sum()

    report("fwd_kernel", timeit(lambda: fwd(model)))
    with mock.patch.object(gru_decoder, "gru_layer", gru_layer_reference):
        report("fwd_plain", timeit(lambda: fwd(model)),
               {"note": "the GRU kernels' plain PyTorch versions (the XLA arm's "
                        "counterpart): a reference, not a yardstick"})

    # the forward with fewer GRU layers: the recurrence's share
    for nl in (1, 5):
        cfg_l = TrainConfig()
        cfg_l.model.n_input_features, cfg_l.model.n_units = D, cfg.model.n_units
        cfg_l.model.n_layers = nl
        m_l = GRUDecoder(cfg_l.model, n_days=45, n_classes=41, device=device,
                         generator=torch.Generator().manual_seed(0))
        report(f"fwd_layers{nl}", timeit(lambda: fwd(m_l)))
        del m_l

    # CTC alone on random log-probs
    lp = torch.log_softmax(torch.randn((B, 125, 41), generator=gen, device=device), -1)
    in_lens = torch.full((B,), 125, dtype=torch.long, device=device)
    lab_lens = torch.full((B,), args.label_len, dtype=torch.long, device=device)
    report("ctc_fwd_only", timeit(lambda: ctc_loss(lp, labels, in_lens, lab_lens).mean()))

    lp_leaf = lp.detach().requires_grad_(True)

    def ctc_grad():
        return torch.autograd.grad(ctc_loss(torch.log_softmax(lp_leaf, -1), labels, in_lens,
                                            lab_lens).mean(), lp_leaf)[0].sum()

    report("ctc_grad", timeit(ctc_grad))

    # the optimizer update alone, on zero gradients
    from ..train.optimizer import make_optimizer, set_learning_rates

    opt, schedules = make_optimizer(cfg, model)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)

    def opt_only():
        set_learning_rates(opt, schedules, 0)
        opt.step()

    report("optimizer_only", timeit(opt_only))
    return lines


if __name__ == "__main__":
    main()
