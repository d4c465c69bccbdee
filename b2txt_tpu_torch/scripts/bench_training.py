"""Training throughput at the reference's full configuration.

Counterpart of ``scripts/bench_training.py``, with its options and printed
lines. Reference baseline: 120k batches in ~3.5 h on an RTX 4090
(model_training/README.md:23) ≈ 9.5 steps/s at batch 64, INCLUDING its
4-worker HDF5 DataLoader (rnn_trainer.py:511-524). Two measurements:

  * the step rate (default): the train step (augmentations → bf16 forward
    with K1 → CTC → K2 backward → 3-group AdamW update) on synthetic batches
    made on the card. The canonical number is the chained rate: N steps
    issued back to back (each consumes the last one's weights), one sync at
    the end; the rate with a sync after every step is reported beside it.
  * ``--full_input``: the whole input pipeline, the reference's layout of
    HDF5 sessions on disk → the days-per-batch sampler → the host loader →
    the prefetch thread (pinned, non-blocking copies) → the ``Trainer``'s own
    step: like for like with the reference's 9.5 steps/s. It needs h5py
    (to write and read the sessions) and says so without it.

    python -m b2txt_tpu_torch.scripts.bench_training
    python -m b2txt_tpu_torch.scripts.bench_training --full_input [--bf16_transfer] [--steps 160]
    python -m b2txt_tpu_torch.scripts.bench_training --device cpu --features 32 --units 32 \\
        --layers 2 --batch_size 4 --bins 128 --label_len 10 --chained 3 --synced 2

New here: ``--device`` (the CUDA card by default, an error without one;
``cpu`` on request), and, to cut the run for a quick check, ``--features``,
``--units``, ``--layers``, ``--batch_size`` (default ``TrainConfig()``'s
512, 768, 5, 64), ``--bins`` (512), ``--label_len`` (60), ``--chained``
(40), ``--synced`` (10),
``--warm`` (20, the full-input run's untimed steps) and ``--trials`` (96 a
session, for ``--full_input``). The printed lines are the JAX driver's; a
last JSON line (new) carries the numbers and the K1/K2 launches, and
``main(argv)`` returns it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.bench_training",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--full_input", action="store_true")
    ap.add_argument("--bf16_transfer", action="store_true",
                    help="with --full_input: transfer input_features as bfloat16 (half the "
                         "host-link bytes)")
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="where the step runs: the CUDA card by default, 'cpu' to run on "
                         "the CPU")
    ap.add_argument("--features", type=int, default=None, help="input features (512)")
    ap.add_argument("--units", type=int, default=None, help="GRU units (768)")
    ap.add_argument("--layers", type=int, default=None, help="GRU layers (5)")
    ap.add_argument("--batch_size", type=int, default=None, help="batch (64)")
    ap.add_argument("--bins", type=int, default=512, help="bins per trial of the step rate")
    ap.add_argument("--label_len", type=int, default=60,
                    help="labels per synthetic trial of the step rate")
    ap.add_argument("--chained", type=int, default=40, help="chained steps timed")
    ap.add_argument("--synced", type=int, default=10, help="per-step-synced steps timed")
    ap.add_argument("--warm", type=int, default=20,
                    help="--full_input: untimed steps before the timed ones")
    ap.add_argument("--trials", type=int, default=96,
                    help="--full_input: trials per session written")
    return ap


def config(args):
    """``TrainConfig()`` with the run's cuts applied."""
    from ..utils.config import TrainConfig

    cfg = TrainConfig()
    for name, value in (("n_input_features", args.features), ("n_units", args.units),
                        ("n_layers", args.layers)):
        if value is not None:
            setattr(cfg.model, name, value)
    if args.batch_size is not None:
        cfg.dataset.batch_size = args.batch_size
    return cfg


def make_synthetic_step(cfg, device, B: int, T: int, S: int = 128, label_len: int = 60,
                        seed: int = 0):
    """A full training step on a synthetic batch made on ``device``: the
    JAX driver's ``one_step`` (augment → bf16 forward → CTC → backward →
    AdamW with clipping and schedules). Returns (step() → loss tensor, model)."""
    import torch

    from ..models.gru_decoder import GRUDecoder
    from ..ops.augment import TransformArgs, transform_data
    from ..ops.ctc import ctc_loss
    from ..train.optimizer import (clip_by_global_norm_, global_norm, make_optimizer,
                                   set_learning_rates)

    D = cfg.model.n_input_features
    model = GRUDecoder(cfg.model, n_days=45, n_classes=41, device=device,
                       generator=torch.Generator().manual_seed(seed))
    opt, schedules = make_optimizer(cfg, model)
    targs = TransformArgs.from_config(cfg.dataset.data_transforms)
    gen = torch.Generator(device=device).manual_seed(seed)
    lab_lens = torch.full((B,), label_len, dtype=torch.long, device=device)
    counter = {"step": 0}

    def one_step():
        feats = torch.randn((B, T, D), generator=gen, device=device)
        labels = torch.randint(1, 41, (B, S), generator=gen, device=device)
        n_time = torch.full((B,), T, dtype=torch.long, device=device)
        day_idx = torch.randint(0, 45, (B,), generator=gen, device=device)
        feats, n_time = transform_data(feats, n_time, targs, True, generator=gen)
        logits = model(feats, day_idx, compute_dtype=torch.bfloat16, training=True,
                       generator=gen)
        lp = torch.log_softmax(logits.float(), dim=-1)
        loss = ctc_loss(lp, labels, model.adjusted_lengths(n_time), lab_lens).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        if cfg.grad_norm_clip_value > 0:
            clip_by_global_norm_(grads, cfg.grad_norm_clip_value, global_norm(grads))
        set_learning_rates(opt, schedules, counter["step"])
        opt.step()
        counter["step"] += 1
        return loss.detach()

    return one_step, model


def full_input_rate(args, device) -> Dict[str, object]:
    """HDF5 → sampler → prefetch → Trainer step, at the run's shapes."""
    import torch

    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise SystemExit("--full_input writes and reads HDF5 sessions and needs h5py, "
                         "which is not installed") from e
    from ..data import synthetic
    from ..data.loader import batch_to_device, prefetch_iterator
    from ..train import Trainer
    from ..utils.profiling import synchronize

    n_steps = args.steps
    tmp = tempfile.mkdtemp(prefix="b2t_train_bench_")
    sessions = [f"t15.2024.01.{d:02d}" for d in range(1, 7)]
    cfg = config(args)
    t0 = time.perf_counter()
    # reference-length utterances: ~9 words x ~5 phones+SIL x 8 frames ≈ 380
    # bins at the full 512-feature width
    synthetic.write_synthetic_sessions(
        tmp, sessions, trials_per_session=args.trials, neural_dim=cfg.model.n_input_features,
        min_words=7, max_words=11,
    )
    write_s = time.perf_counter() - t0

    cfg.dataset.sessions = sessions
    cfg.dataset.dataset_probability_val = [1] * len(sessions)
    cfg.dataset.dataset_dir = tmp
    cfg.num_training_batches = n_steps + args.warm
    cfg.batches_per_val_step = 10 ** 9
    cfg.batches_per_train_log = 10 ** 9
    cfg.output_dir = tmp + "/out"
    cfg.checkpoint_dir = tmp + "/out/ckpt"
    cfg.save_best_checkpoint = False
    cfg.save_final_model = False
    if args.bf16_transfer:
        # half the host-link bytes of the largest buffer (features); the
        # step casts them back on the device (TrainConfig.feature_transfer_dtype)
        cfg.feature_transfer_dtype = "bfloat16"

    trainer = Trainer(cfg, device=device)

    # ---- where does the input path's time go?
    # (a) the host loader alone: HDF5 reads + bucket/pad, no device
    t0 = time.perf_counter()
    n_host = 24
    for i, _b in enumerate(trainer.train_loader):
        if i + 1 >= n_host:
            break
    host_rate = n_host / (time.perf_counter() - t0)
    # (b) the host → device copy alone
    b0 = trainer.train_loader.get_batch(0)
    mb = sum(v.nbytes for v in b0.values() if hasattr(v, "nbytes")) / 1e6
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(4):
        batch_to_device({"input_features": b0["input_features"]}, device,
                        trainer.train_loader.feature_dtype)
        synchronize(device)
    put_rate = 4 / (time.perf_counter() - t0)
    print(f"  input decomposition: host loader {host_rate:.1f} batches/s, "
          f"device copy {put_rate:.2f} batches/s ({mb:.0f} MB/batch)", flush=True)

    it = prefetch_iterator(trainer.train_loader, device)
    warm = args.warm
    losses: List[torch.Tensor] = []
    t_compile = time.perf_counter()
    t0 = None
    n0 = 0
    for i, batch in enumerate(it):
        loss, _ = trainer.train_step(batch)
        if i < warm:
            float(loss)  # a sync after each warm step
            if i == warm - 1:
                t0 = time.perf_counter()
                n0 = i + 1
            continue
        losses.append(loss)
        if len(losses) >= 64:   # chunked sync, as Trainer.train does
            torch.stack(losses).cpu()
            losses.clear()
    if losses:
        torch.stack(losses).cpu()
    dt = time.perf_counter() - t0
    n = cfg.num_training_batches - n0
    print(f"full-input-path train steps/s: {n / dt:.2f} "
          f"(B={cfg.dataset.batch_size}, HDF5+sampler+prefetch+copy+step;"
          f" reference w/ DataLoader: ~9.5 steps/s)")
    print(f"  warmup {time.perf_counter() - t_compile - dt:.1f}s, "
          f"session write {write_s:.1f}s, "
          f"projected 120k batches: {120000 / (n / dt) / 3600:.2f} h")
    return {"mode": "full_input", "steps_per_sec": n / dt, "timed_steps": n,
            "host_loader_batches_per_sec": host_rate, "device_copy_batches_per_sec": put_rate,
            "mb_per_batch": mb, "session_write_s": write_s, "batch": cfg.dataset.batch_size,
            "bf16_transfer": bool(args.bf16_transfer)}


def step_rate(args, device) -> Dict[str, object]:
    """The chained and per-step-synced rates of the synthetic step."""
    cfg = config(args)
    B, T = cfg.dataset.batch_size, args.bins
    D = cfg.model.n_input_features
    one_step, _ = make_synthetic_step(cfg, device, B, T, label_len=args.label_len)

    print(f"warming the train step (B={B}, T={T}, D={D})...", file=sys.stderr)
    loss = one_step()
    print("loss[0] =", float(loss), file=sys.stderr)

    # the sustained rate: N steps issued back to back, ONE sync at the end,
    # as the trainer runs (it fetches its metrics in chunks); the rate with
    # a sync after every step beside it
    n_steps = args.chained
    losses = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        losses.append(one_step())
    float(losses[-1])  # one sync at the end (the steps are chained)
    dt = time.perf_counter() - t0
    steps_per_sec = n_steps / dt

    t0 = time.perf_counter()
    for _ in range(args.synced):
        losses.append(one_step())
        float(losses[-1])
    synced_rate = args.synced / (time.perf_counter() - t0)

    print(f"train steps/s: {steps_per_sec:.2f} sustained "
          f"({synced_rate:.2f} with a per-step host sync; "
          f"reference RTX 4090: ~9.5 steps/s)")
    print(f"projected 120k-batch wall-clock: {120000 / steps_per_sec / 3600:.2f} h "
          f"(reference: ~3.5 h)")
    return {"mode": "step", "steps_per_sec": steps_per_sec, "synced_steps_per_sec": synced_rate,
            "ms_per_step": 1e3 / steps_per_sec, "chained_steps": n_steps,
            "synced_steps": args.synced, "batch": B, "bins": T,
            "losses": [float(v) for v in losses]}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)

    from ..utils.device import resolve_device
    from ..utils.profiling import kernel_launches, launches_since

    device = resolve_device(args.device)
    launches0 = kernel_launches()
    cfg = config(args)
    fig = full_input_rate(args, device) if args.full_input else step_rate(args, device)
    out = {"driver": "bench_training", "backend": device.type, **fig,
           "model": {"features": cfg.model.n_input_features, "units": cfg.model.n_units,
                     "layers": cfg.model.n_layers, "compute_dtype": "bfloat16"},
           "launches": launches_since(launches0),
           "clock": "host, around steps that end in a sync"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
