#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (b2txt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the serving and training paths from
``b2txt_tpu_torch`` (the four CUDA sources, one nvcc each, and the native
C++ decoder, one g++, all at once), holds each kernel against its plain PyTorch
version on the card (and, for the GRU recurrence, measures how far two
correct versions drift apart by weight scale, against a float64 version),
then:

- serves 16 planted requests through the full-width model (512 features,
  5×768 GRU, patch 14/4, 45 days, bf16) and the host beam search over a
  1,000-word lexicon, then decodes the same posteriors with the device
  searcher on the card and on the CPU (``search_parity``), and serves them
  over the Redis stream protocol (``redis``: ``RedisDecoderServer`` with the
  native searcher, in a thread over the in-process fake redis, driven by
  ``RemoteLMClient``);
- runs the connected pipeline at the JAX package's bench scale
  (``serve_connected``): a 125,000-word lexicon, a pruned trigram in bucket
  tables on the card with the unpruned one for the on-card pool rescore, 512
  planted requests in batches of 128 whose posteriors go from the GRU
  straight into the device beam search, then to the host through the native
  C++ searcher; and 32 rows of one batch (5 of them padding, the session
  evaluation's search shape) with the frames replayed from the search's
  captured CUDA graph against the same frames issued op by op, bit for bit,
  with each path's ms and launch calls a frame;
- evaluates three planted sessions of 64 trials held in memory over that
  world (``evaluate``: ``evaluate_session_data`` with the native searcher,
  device-resident with the device searcher, ``run_single_decoding_step``,
  the competition CSV);
- runs the user CLIs of ``b2txt_tpu_torch.scripts`` over that world
  (``cli``): ``build_lm --native`` on its corpus and 125,000-word
  dictionary, ``decode_logits`` on the connected posteriors (native on all
  512, the device backend on 16), ``convert_checkpoint`` there and back on
  the connected model, ``eval_45session_sim``'s path (45 sessions × 8
  trials in memory, full width, native and device-resident), and
  ``utils.profiling``'s trace of one stage-1 batch;
- holds the row gather K4 bit for bit against its plain version, runs its
  path (``b2txt_tpu_torch.scripts.profile_gather``'s three cases) and times
  it on the decode LM's own bucket table (``kernel_row_gather``);
- runs the CTC prefix beam searcher (``prefix_beam``) on the card over 8 of
  the connected batch's posteriors, against the numpy oracle on the host;
- draws OPT-6.7b's weights (bf16, random, from a seed) on the card and runs
  the full finalize on the connected world's first batch of 128 requests
  (``finalize_opt``: K1 → device searcher → augment_nbest → the OPT α-blend
  in ``DecoderService``, per utterance and grouped), then times the OPT
  forward at two shapes and holds it at full width and 2 layers against the
  CPU (``opt_forward``), and rescores 100-candidate n-best lists packed,
  unpacked, and with a 48-word context through the prefix-KV path and by
  concatenation (``opt_rescore``);
- runs the soft-posterior quality ladder on the connected world
  (``quality_ladder``: ``scripts.quality_ladder.run_ladder`` at head gains
  15-45, 128 planted utterances in batches of 64, the native and the device
  searchers on identical posteriors, the native lattice n-best on two gains),
  before the OPT weights are drawn;
- runs the user-facing examples (``examples``, after the OPT phases): the
  streaming demo at full width (carried-state hops, K1 at T = 1, against the
  offline forward in f32 and bf16; Part B through the python and the device
  searchers), the quickstart (training, the val split's decode, the CSV) and
  the figures demo's data half at full width on sessions in memory, the
  conversation demo's picks and its context scoring on the OPT-6.7b
  weights, and the host-only lattice and spelling demos;
- runs the measurement drivers of ``b2txt_tpu_torch.scripts`` through their
  ``main(argv)`` (``drivers``, after the examples, on the OPT weights still
  on the card): ``bench`` at full size without its LLM stage (both
  pipelines 512/512, WER 0, K1 5 a batch), ``bench_device_decode``,
  ``bench_streaming`` (the hop under 80 ms), ``bench_training`` (and its
  ``--full_input`` refusing without h5py), ``profile_train_step`` (K1 and K2
  at B = 64, 128, 256), ``profile_device_step``'s four modes, ``bench_opt``'s
  stages A, B and D (B's scores those of ``OPTRescorer.score``) and
  ``drive_large_lm`` at 1M entries (native and device top-1 equal);
- trains the full-width model (``TrainConfig()`` defaults: bf16, dropout,
  augmentation, batch 64 over 4 days) for 20 steps with the augmentations in
  PyTorch and 5 with the fused kernel, on synthetic trials in memory, and
  holds one step's gradients through the kernels against the plain path;
- runs the sharded paths (``b2txt_tpu_torch.parallel``) over a 1-rank NCCL
  group joined in this process (one card: NCCL refuses two ranks on one
  GPU): ``sharded_decode`` (the connected world's 512 posteriors through
  ``sharded_decode_batch``, bit for bit against ``decode_batch``),
  ``opt_tp`` (``OPTRescorer(mesh=...)`` on the 6.7b weights against the
  unsharded rescorer), ``parallel_forward`` (``build_sharded_forward`` at
  full width, B = 128, bit for bit against ``GRUDecoder``) and
  ``parallel_train`` (5 steps of ``Trainer(mesh=...)`` beside 5 unsharded
  ones, within 1e-6); then ``parallel_two_ranks``: two ranks on the card
  over gloo at the CPU tests' tiny width (the sharded step at model = 2, the
  13-word world's sharded decode at D = 2).

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
# K3 with its own Philox noise against the plain version fed philox_noise:
# the same counters and uniforms, but the kernel's logf/sincosf and PyTorch's
# float32 log/cos/sin differ by a few ulps on normals of size <= ~6, and the
# walk's cumsum sums in another order.
PREPROCESS_PHILOX_TOL = {"noise": 1e-5, "walk": 1e-4}
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
                (40, 11, 72, "contractive"), (32, 125, 768, "contractive"),
                # not multiples of the mma tiles (16 rows, k16); H % 8 != 0 takes
                # the kernels' element loads instead of 16-byte copies
                (17, 9, 40, "contractive"), (1, 9, 40, "contractive"),
                (3, 6, 13, "contractive"), (17, 125, 768, "contractive")]
WITNESS_STEPS = (0, 4, 24, 49, 99, 124)
N_REQUESTS = 16
BINS = 520          # bins per request: 125 patch frames after smoothing and patching
VOCAB = 1000
SEED = 0
# the connected pipeline at bench.py's reference scale (BENCH_r05.json)
CONNECTED_VOCAB, CONNECTED_REQUESTS, CONNECTED_BATCH = 125_000, 512, 128
PRUNE_THRESHOLD = 3e-8
CONNECTED_DECODE = dict(acoustic_scale=0.325, blank_penalty=90.0, nbest=100, beam=17.0,
                        beam_width=48, first_beam_size=8, sum_mode=False, rescore=True)
# device searcher on the card against itself on the CPU: the same float32
# ops, but exp/log1p may differ in the last bit between the two devices, and
# one ulp per frame over 125 frames of scores near 100 sums to ~1e-4
SEARCH_TOL = 1e-4        # relative and absolute, as np.allclose
# the session evaluation's device batch (the harness pads every batch to it)
EVAL_SEARCH_BATCH = 32
# the profiler's host events of one launch call
LAUNCH_EVENTS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch"}
GATHER_GRID = [(rw, g) for rw in (4, 64, 128) for g in (1, 37, 4096)]
# session evaluation: three planted sessions on distinct days of TrainConfig()'s
# session list, over the connected world; run_single_decoding_step on a few trials
EVAL_DAYS, EVAL_TRIALS, EVAL_SINGLE = (0, 22, 44), 64, 4
# the Redis phase streams each request's 125 frames in chunks of 32: a chunk
# spans ~140 bins, past the end of any first word (lead 8 bins, at most 10
# phones + SIL of at most 11 bins each), so every partial has a word
REDIS_CHUNK = 32
REDIS_TOL = 1e-4         # final n-best scores, wire against in-process
GATHER_IN_FLIGHT = [1, 8, 32, 128]
# OPT-6.7b at its published widths, random bf16 weights drawn on the card
# (scripts/bench_opt.py's stages A-D): forward shapes (B, L), 100-candidate
# n-best lists of 6 words from a 3,000-word pool, a 48-word context
OPT_SEED = 11
# (1, 64): one packed row, the shape of a per-utterance finalize call
OPT_SHAPES = [(32, 32), (8, 128), (1, 64)]
OPT_LISTS, OPT_NBEST, OPT_CONTEXT_WORDS = 8, 100, 48
OPT_MAX_LEN = 32           # bench_opt.py stage B's rescorer
OPT_PARITY_LAYERS, OPT_PARITY_TEXTS = 2, 32
# full width, 2 layers, f32 with TF32 off: the card against the same code on
# the CPU, per-text score sums (~-90 over ~7 tokens); summation order only
OPT_F32_TOL = 1e-3
# bf16 against f32, and bf16 paths against each other (packed/unpacked,
# grouped/per-utterance): the JAX package's own bf16 tolerance for OPT
# scores (tests/test_opt_lm.py:214); the context sums (~-600 over ~55 tokens)
# take its prefix-path tolerance (:280)
OPT_BF16_TOL = dict(rtol=2e-2, atol=0.35)
OPT_PREFIX_TOL = dict(rtol=2e-2, atol=0.5)
# the full finalize as bench_opt.py stage C sets it, on the connected world
FINALIZE_KNOBS = dict(do_opt=True, alpha=0.55)
# DeepSeek-V2-Lite in the rescorer: the benchmark cell's σ of random weights
# (at DeepSeek's 0.006 random routers collapse onto a few experts with depth),
# the lattice n-best of the native searcher, one packed forward a finalize
DSV2_SEED = 12
DSV2_INIT_STD = 0.02
DSV2_DECODE = dict(acoustic_scale=0.325, blank_penalty=90.0, nbest=100, beam=17.0,
                   sum_mode=False, lattice_nbest=True, lattice_beam=8.0, **FINALIZE_KNOBS)
DSV2_CHUNK = 32            # frames a decode_chunk call, as the online cells
LLM_GROUP = 96
# the CTC prefix beam searcher on the connected batch's posteriors against
# the numpy oracle (float64 on the host): the reference test's tolerance
# (tests/test_prefix_beam.py:100-130)
PREFIX_UTTS, PREFIX_K, PREFIX_TOP = 8, 16, 8
PREFIX_TOL = dict(rtol=1e-4, atol=1e-5)
# the CLI phase: the device backend of decode_logits streams one utterance at
# a time, ~1 s each at 125 frames (host-issue bound), so it takes the first
# 16; eval_45session_sim's 45 sessions at 8 trials each
CLI_DEVICE_UTTS, CLI_SESSIONS, CLI_TRIALS = 16, 45, 8
# decode_logits' knobs for the planted posteriors: at its default acoustic
# scale (0.325, set for real posteriors of real text) the LM merges or
# extends words of these random-word sentences (5 of 512 missed; the decoder
# is the JAX package's C++), so the acoustics weigh 0.5, as the JAX
# package's CLI test sets it for its crafted logits; K = 48 as the
# connected decode
CLI_DECODE_ARGS = ["--acoustic_scale", "0.5", "--blank_penalty", "90", "--beam_width", "48"]
CLI_RANGE = "cli_stage1_batch"
# the examples at full width (TrainConfig()'s model): streaming hops after a
# warm-up; the quickstart and figures trainings cut from 300 and 120 steps
STREAM_WARMUP, STREAM_HOPS = 5, 60
# hops under the profiler, after a 50 ms settle: a trace of one hop started
# right at the window's opening missed its first kernels (4 of 5 K1 launches
# in one run)
PROFILED_HOPS, PROFILE_SETTLE_S = 10, 0.05
# streaming against the offline forward in bf16: two bf16 computations of one
# function. The offline input projection is one (1, P, ·) product, the
# streamed one P products of (1, 1, ·), and each rounds to bf16, so the two
# may differ by a bf16 rounding before any recurrence step. The carried state
# is rounded alike on both paths (h_T in bf16, fed back as is). Held to twice
# the bf16 policy's own error: |offline bf16 - offline f32| on the same bins
STREAM_BF16_FACTOR = 2.0
QUICKSTART_STEPS, FIGURES_STEPS = 20, 20
# what the two demos' make_config keeps at full width (their own training
# knobs; the optimizer epsilon is TrainConfig()'s 0.1)
DEMO_KNOBS = "dropout 0, batch 8 over 2 days, use_amp off (f32), lr warm-up 10 steps"
# the lattice and spelling demos at their defaults, as the CPU gives them:
# host-only (the native searcher, numpy's generator), so any host gives these
LATTICE_DEMO_RESULT = {"pool": {"top1_wer": 0.0, "mean_depth": 1.2},
                       "lattice": {"top1_wer": 0.0, "mean_depth": 34.3}}
SPELLING_DEMO_RESULT = 20
# the quality ladder on the connected world (scripts/quality_ladder.py's
# defaults): 128 planted utterances of 520 bins, device batch 64, blank bias
# 12; the lattice n-best (width 512) on two gains and the first 32 utterances
LADDER_GAINS = (15.0, 20.0, 25.0, 35.0, 45.0)
LADDER_BLANK_BIAS, LADDER_UTTS, LADDER_BATCH = 12.0, 128, 64
LADDER_LATTICE_GAINS, LADDER_LATTICE_UTTS, LADDER_LATTICE_WIDTH = (25.0, 45.0), 32, 512
# the sharded paths over a 1-rank NCCL group (one card): the collective
# timeout; the sharded forward's batch; the sharded steps beside the unsharded
# ones, noise and dropout off, held to 1e-6 relative (the same kernels and
# ops on the same inputs: the world-size-1 collectives are copies)
PARALLEL_TIMEOUT_S = 300
PARALLEL_FORWARD_B = 128
PARALLEL_TRAIN_STEPS, PARALLEL_TRAIN_TOL = 5, 1e-6
COLLECTIVE_PROBE_CALLS = 200
BUSY_CYCLES = 100_000_000   # torch.cuda._sleep: ~50 ms of a busy card
# the drivers phase: each driver's arguments (full size unless cut here;
# PERF.md §4 lists the cuts)
DRIVER_ARGV = {
    "bench": ["--skip_llm"],
    "bench_device_decode": ["--utts", "64"],
    "bench_streaming": ["--hops", "128", "--device_hops", "64"],
    "bench_training": [],
    "bench_training_full_input": ["--full_input"],
    "profile_train_step": ["--iters", "10"],
    "profile_device_step_gather": ["gather"],
    "profile_device_step_sort": ["sort"],
    "profile_device_step_sel": ["sel"],
    "profile_device_step_step": ["step", "--stub_lm"],
    "bench_opt": ["--context_words", "48"],
    "drive_large_lm": ["--entries", "1000000", "--vocab", "50000", "--order", "5",
                       "--device"],
}


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


def counted_launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def zero(counters):
    for fn in counters.values():
        fn.launches = 0


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
    """Every CUDA source of the port, one nvcc each, and the native decoder's
    two C++ sources, one g++, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from b2txt_tpu_torch import runtime
    from b2txt_tpu_torch.ops._build import (beam_step_library, gru_bwd_library,
                                            gru_fwd_library, moe_grouped_library,
                                            preprocess_library, row_gather_library)

    def native():
        t0 = time.perf_counter()
        runtime._load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = {"gru_fwd.cu": gru_fwd_library, "gru_bwd.cu": gru_bwd_library,
            "row_gather.cu": row_gather_library, "preprocess.cu": preprocess_library,
            "moe_grouped.cu": moe_grouped_library, "beam_step.cu": beam_step_library,
            "native": native}
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    wall = time.perf_counter() - t0
    gxx_s = built.pop("native")
    for name, b in built.items():
        emit({"phase": "build", "source": f"b2txt_tpu_torch/csrc/{name}",
              "library": b.path.name, "nvcc_s": b.seconds, "wall_s_all": wall})
        print(b.ptxas_report.strip(), flush=True)
    emit({"phase": "build", "source": "b2txt_tpu_torch/runtime/decoder.cc, ngram_train.cc",
          "library": runtime.library_path().name,
          "compiler": "g++ " + " ".join(runtime.GXX_FLAGS),
          "gxx_s": gxx_s, "gxx_s_is": "g++ and the library's load (near 0 if it was built)",
          "wall_s_all": wall})


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
        from b2txt_tpu_torch.scripts.time_gru import decoder_layer_inputs
        from b2txt_tpu_torch.utils.config import TrainConfig

        assert H == TrainConfig().model.n_units, H
        return decoder_layer_inputs(B, T, gen, SEED)
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
    from b2txt_tpu_torch.scripts.time_gru import per_step

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
            if H >= 256 and T > 1:
                one = [args[0][:, :1].contiguous()] + args[1:]
                fig.update(per_step(ms, cuda_ms(lambda: gru_layer_forward(*one), iters=20), T))
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
    from b2txt_tpu_torch.scripts.time_gru import per_step

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
            if big and T > 1:
                one = [a[:, :1].contiguous() if a.dim() == 3 else a for a in bwd_args]
                fig.update(per_step(ms, cuda_ms(lambda: gru_layer_backward(*one), iters=10), T))
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
    # the wrapper's draws, in its order: gain normals, then the cut
    gain = (torch.randn((B, C, C), generator=seeds[1], device="cuda")
            if training and args.static_gain_std > 0 else None)
    cut = (torch.randint(0, args.random_cut, (), generator=seeds[1], device="cuda")
           if training else 0)
    ref, nt_ref = fused_preprocess_reference(x, nt, args, training, noise, cut, gain)
    if not (bool(torch.isfinite(got).all()) and torch.equal(nt_got, nt_ref)):
        return float("inf")
    return float((got - ref).abs().max())


def phase_kernel_fused_preprocess(B: int, T: int, C: int):
    """K3 against its plain version: with the normals passed in (train,
    eval, walk, gain), and with its own Philox noise elementwise against
    the plain version fed ``philox_noise`` and the same cut; its on-chip
    noise by statistics. Times the kernel alone, the whole
    ``fused_preprocess`` call and the unfused ``transform_data`` at the
    default training knobs. Returns the figures."""
    import torch

    from b2txt_tpu_torch.ops.augment import TransformArgs, transform_data
    from b2txt_tpu_torch.ops.preprocess import (fused_preprocess, fused_preprocess_reference,
                                                launch_preprocess, philox_noise)
    from b2txt_tpu_torch.utils.config import DataTransforms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((B, T, C), generator=gen, device="cuda")
    nt = torch.full((B,), T, dtype=torch.long, device="cuda")
    defaults = TransformArgs.from_config(DataTransforms())
    walk = defaults._replace(random_walk_std=0.1)
    worst = 0.0
    cases = [("train", defaults, True, "noise"), ("eval", defaults, False, "noise"),
             ("train_walk", walk, True, "walk"),
             ("train_gain", defaults._replace(static_gain_std=0.05), True, "noise")]
    for label, args, training, tol_kind in cases:
        err = fused_against_plain(x, nt, args, training, gen)
        tol = PREPROCESS_TOL[tol_kind]
        ok = err <= tol
        emit({"phase": "kernel_fused_preprocess", "mode": f"noise passed in, {label}",
              "B": B, "T": T, "C": C, "max_abs_err": err, "tol": tol, "ok": ok})
        if not ok:
            raise RuntimeError(f"fused_preprocess ({label}) disagrees with its plain version")
        worst = max(worst, err)

    # on-chip Philox noise, elementwise against the plain version fed the
    # same normals (philox_noise) and the same cut, read by the kernel from
    # a device integer
    for label, args, tol_kind in (("train", defaults, "noise"), ("train_walk", walk, "walk")):
        for cut in (0, 2):
            seed = 100 + cut
            got = launch_preprocess(x, args, True, seed, None, torch.tensor(cut, device="cuda"))
            torch.cuda.synchronize()
            want, _ = fused_preprocess_reference(
                x, nt, args, True, philox_noise(seed, B, T, C, args, device="cuda"), cut)
            err = float((got - want).abs().max()) if bool(torch.isfinite(got).all()) else float("inf")
            tol = PREPROCESS_PHILOX_TOL[tol_kind]
            emit({"phase": "kernel_fused_preprocess", "mode": f"on-chip noise vs philox_noise, {label}",
                  "cut": cut, "B": B, "T": T, "C": C, "max_abs_err": err, "tol": tol,
                  "ok": err <= tol})
            if not err <= tol:
                raise RuntimeError(f"fused_preprocess on-chip noise ({label}, cut {cut}) "
                                   f"disagrees with philox_noise")
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

    cut = torch.tensor(1, device="cuda")
    ms = cuda_ms(lambda: launch_preprocess(x, defaults, True, 4, None, cut), iters=20)
    # what the noise costs: the same launch without it (eval), and with the walk
    eval_ms = cuda_ms(lambda: launch_preprocess(x, defaults, False, 4, None, None), iters=20)
    walk_ms = cuda_ms(lambda: launch_preprocess(x, walk, True, 4, None, cut), iters=20)
    call_ms = cuda_ms(lambda: fused_preprocess(x, nt, defaults, True, generator=gen, seed=4),
                      iters=20)
    transform_ms = cuda_ms(lambda: transform_data(x, nt, defaults, True, generator=gen), iters=20)
    host_noise = torch.randn((B, 2 * T + 1, C), generator=gen, device="cuda")
    plain_ms = cuda_ms(lambda: fused_preprocess_reference(x, nt, defaults, True, host_noise, 1),
                       iters=5)
    nbytes = 2 * 4 * B * T * C   # one read and one write of (B, T, C) f32
    fig = {"phase": "kernel_fused_preprocess", "mode": "timing, on-chip noise, TrainConfig knobs",
           "B": B, "T": T, "C": C, "max_abs_err": worst, "ms": ms, "call_ms": call_ms,
           "eval_ms": eval_ms, "walk_ms": walk_ms, "transform_data_ms": transform_ms,
           "plain_ms": plain_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}
    emit(fig)
    return fig


def phase_kernel_moe(T: int = 64, E: int = 64, k: int = 6, D: int = 2048, Fm: int = 1408):
    """K5, the grouped expert kernel, at the DeepSeek-V2-Lite rescorer's
    shapes (a packed forward's ~64 tokens, 64 experts, top-6, hidden 2048,
    expert width 1408; bf16): against its plain version, with no host sync
    inside the call, and timed against its bound, the touched experts'
    weights read once plus the activations. Returns the figures."""
    import torch

    from b2txt_tpu_torch.ops.moe import moe_experts, moe_experts_plain, route

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = torch.randn((T, D), generator=gen, device="cuda").bfloat16()
    gate = torch.randn((E, D), generator=gen, device="cuda").bfloat16() * 0.006
    gate_up = (torch.randn((E, 2 * Fm, D), generator=gen, device="cuda") * 0.006).bfloat16()
    down = (torch.randn((E, D, Fm), generator=gen, device="cuda") * 0.006).bfloat16()
    w, idx, counts = route(x, gate, k, 1.0, torch.ones(T, dtype=torch.bool, device="cuda"))
    before = moe_experts.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_experts(x, idx, w, gate_up, down, counts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = moe_experts.launches - before
    want = moe_experts_plain(x, idx, w, gate_up, down)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    touched = int((counts[:E] > 0).sum())
    ms = cuda_ms(lambda: moe_experts(x, idx, w, gate_up, down, counts), iters=20)
    plain_ms = cuda_ms(lambda: moe_experts_plain(x, idx, w, gate_up, down), iters=5)
    pairs = T * k
    nbytes = (touched * 3 * D * Fm * 2 + T * D * 2 + pairs * 2 * Fm * 2 + pairs * D * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fig = {"phase": "kernel_moe", "T": T, "E": E, "k": k, "D": D, "Fm": Fm,
           "experts_touched": touched, "max_abs_err": err, "max_abs_out": scale,
           "tol": "2e-2 of the largest output", "ok": err <= 2e-2 * scale,
           "launches": launches, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "share_of_bound": bound_ms / ms,
           "library_ms": None}
    emit(fig)
    if not fig["ok"]:
        raise RuntimeError(f"moe_experts disagrees with its plain version: {err} of {scale}")
    return fig


def phase_finalize_dsv2(world, logits, requests):
    """DeepSeek-V2-Lite at full width (27 layers, hidden 2048, 64 experts
    top-6 and 2 shared, vocabulary 102,400; 31.4 GB of random bf16 weights
    drawn on the card) as ``DecoderService``'s LLM on the serve phase's
    posteriors: the native searcher in 32-frame chunks, its lattice n-best
    and ``finalize``'s α-blend, one utterance at a time, after one round
    that captures each packed shape's graph. K5's launch count is set to 0
    just before the timed round and read after it: 2 a MoE layer, 52 a
    packed forward, counted at each replay. Returns the figures."""
    import tempfile

    import torch

    from b2txt_tpu_torch.decode.deepseek_lm import (DeepseekV2Config, DeepseekV2Rescorer,
                                                    init_params)
    from b2txt_tpu_torch.decode.packed_scorer import word_hash_encode
    from b2txt_tpu_torch.ops.moe import moe_experts
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.config import DecodeConfig

    lexicon, lm = world
    cfg = DeepseekV2Config.deepseek_v2_lite()
    t0 = time.perf_counter()
    params = init_params(cfg, "cuda", torch.bfloat16,
                         torch.Generator(device="cuda").manual_seed(DSV2_SEED), std=DSV2_INIT_STD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    llm = DeepseekV2Rescorer(cfg, word_hash_encode(cfg.vocab_size), params=params,
                             device="cuda", max_len=256, compute_dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dsv2_") as tmp:
        files = write_world(tmp, lexicon, lm, lm)
        service = DecoderService(lexicon, lm, DecodeConfig(**DSV2_DECODE), llm=llm,
                                 channel_order="model", searcher_backend="native",
                                 arpa_path=files["arpa"], lexicon_path=files["lexicon"])

    def finalize(lp):
        service.reset()
        for c in range(0, lp.shape[0], DSV2_CHUNK):
            service.decode_chunk(lp[c: c + DSV2_CHUNK])
        return service.finalize()

    for lp in logits:     # the rescorer's first calls: each packed shape's graph captured
        finalize(lp)
    forwards = mock.patch.object(llm, "_packed", wraps=llm._packed)
    torch.cuda.synchronize()
    moe_experts.launches = 0
    t0 = time.perf_counter()
    with forwards as packed:
        finals = [finalize(lp) for lp in logits]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, n_forwards = moe_experts.launches, packed.call_count
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    llm_cols = [r[3] for o in finals for r in o.nbest]
    rows = [len(o.nbest) for o in finals]
    fig = {"phase": "finalize_dsv2", "requests": len(finals),
           "llm": "DeepseekV2Config.deepseek_v2_lite(), bf16, random weights "
                  f"N(0, {DSV2_INIT_STD}^2), word_hash_encode",
           "weight_bytes": weight_bytes, "init_s": init_s,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(),
           "decode": DSV2_DECODE, "chunk_frames": DSV2_CHUNK,
           "nbest_rows_mean": float(np.mean(rows)),
           "exact": sum(o.sentence == s for o, (s, _) in zip(finals, requests)),
           "packed_forwards": n_forwards, "launches": launches, "moe_layers": n_moe,
           "launches_per_forward": launches / max(n_forwards, 1),
           "ms_per_utterance": wall * 1e3 / len(finals),
           "clock": "host, decode_chunk calls and finalize per utterance, ending in a sync",
           "llm_scores_finite": bool(np.all(np.isfinite(llm_cols))),
           "llm_scored": bool(any(v != 0.0 for v in llm_cols))}
    problems = []
    if n_forwards != sum(1 for n in rows if n):
        problems.append(f"{n_forwards} packed forwards for {sum(1 for n in rows if n)} "
                        f"utterances with an n-best")
    if n_forwards == 0 or launches != 2 * n_moe * n_forwards:
        problems.append(f"K5 launched {launches} times in {n_forwards} forwards, expected "
                        f"{2 * n_moe} a forward")
    if not (fig["llm_scores_finite"] and fig["llm_scored"]):
        problems.append("the LLM column is not finite or was never filled")
    fig["ok"] = not problems
    fig["problems"] = problems
    emit(fig)
    del service, llm, params
    torch.cuda.empty_cache()
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
        zero(counters)
        for batch in todo:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, grad_norm = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
        launches = counted_launches(counters)
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
    profile = profile_call(lambda: trainer.train_step(batches[1]), top=8)
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
    word, and a trigram trained with the port's python trainer. Returns the
    lexicon, the trigram, the word list, the generator and the corpus."""
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
    return Lexicon.from_words(words), train_ngram(corpus, order=3), wl, rng, corpus


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
    lexicon, lm, wl, rng, _ = build_world(vocab, SEED)
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

    zero(counters)
    t0 = time.perf_counter()
    logits = _batched_inference(model, feats_list, **infer)
    t1 = time.perf_counter()
    outs = service.decode_utterances(logits)
    t2 = time.perf_counter()
    launches = counted_launches(counters)

    n_batches = (n_requests + infer["batch_size"] - 1) // infer["batch_size"]
    exact = sum(o.sentence == s for o, (s, _) in zip(outs, requests))
    fig = {"phase": "serve", "requests": n_requests, "bins": bins,
           "frames": int(logits[0].shape[0]), "vocab": vocab, "batches": n_batches,
           "exact": exact, "world_build_s": world_s,
           "main_path_stage1_s": t1 - t0, "decode_s_per_request": (t2 - t1) / n_requests,
           "launches": launches}
    return fig, model, feats_list, infer, logits, outs, requests, (lexicon, lm)


def profile_call(run, top: int = 6, settle_s: float = 0.0):
    """One call (a stage-1 batch, a training step, a decode batch) under
    torch.profiler: device time and launches by kernel name, their sums, and
    the host wall time around the call. ``settle_s``: a host wait inside the
    window before the call, for calls whose first kernels come within
    microseconds of the window's start (the trace can miss them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(settle_s)
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
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms": ms, "calls": n} for ms, k, n in rows[:top]]}


def beam_step_bytes(searcher, B: int) -> int:
    """Bytes one frame of K6 must move for B rows: each beam's state read
    and written, its packed trie row and a [child, lookahead] pair a phone
    it extends by, its n-gram bucket rows (a gram a level and homophone
    probed, a context backoff a level above 1), the frame's log-probs and
    the records written."""
    K, H, order = searcher.config.beam_width, searcher.H, searcher.order
    CW = max(order - 1, 1)
    FB = searcher.config.first_beam_size or 39   # the first beam, ties aside
    n_probe = H if searcher.close_top is None else min(searcher.close_top, H)
    row = searcher.dev_lm.table[0].shape[1] * 4
    probes = (order - 1) * n_probe + max(order - 2, 0)
    state = 4 * (9 + CW)
    per_beam = 2 * state + 4 * (2 * H + 1) + 8 * FB + probes * row + 6
    return B * (K * per_beam + 4 * 41)


def phase_kernel_beam_step(searcher, lp, lens):
    """K6, the device search's frame step, at the session evaluation's
    search shape (the connected world's 125k-word trigram, B = 32 with
    padding rows, K = 48, first beam 8, H = 4): a batch's frames replayed
    from the captured graph of K6 against ``_expand`` op by op on the card
    (live beams and n-best), K6's time a frame (CUDA events over the
    batch's replays after a warm-up run, and the profiler's device time a
    launch) beside its byte bound, in the same call the plain ``_expand``
    op by op (host clock to a sync), and ptxas's registers and spills.
    Returns the figures."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from b2txt_tpu_torch.decode import lmbeam_device as lb
    from b2txt_tpu_torch.ops._build import beam_step_library
    from b2txt_tpu_torch.ops.beam_step import beam_step

    with torch.inference_mode():
        lp, lens, log_bp = searcher._prep_batch(lp, lens)
        if log_bp != 0.0:
            lp[:, :, searcher.blank] -= log_bp
        B, V, n = lp.shape[0], lp.shape[2], min(lp.shape[1], int(lens.max()))
        lens_dev = torch.from_numpy(lens.astype(np.int64)).to(lp.device)
        searcher._scan_batch(searcher._make_state(B), lp, lens)   # captures if new
        before = beam_step.launches
        got = searcher._scan_batch(searcher._make_state(B), lp, lens)
        launches = beam_step.launches - before
        want = searcher._scan_eager(searcher._make_state(B), lp, lens, lens_dev, n)
        nbest = [searcher._extract_results(tuple(t.cpu().numpy() for t in searcher._finalize(st)),
                                           tuple(r.cpu().numpy() for r in recs), None)
                 for st, recs in (got, want)]
        fg = searcher._frame_graph(B, V, n, lp.device)

        def replays_ms(reps: int = 3) -> float:
            total = 0.0
            for i in range(reps + 1):     # the first run warms up
                fg.load(searcher._make_state(B), lp, lens_dev, n)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fg.graph.replay(n)
                end.record()
                torch.cuda.synchronize()
                total += start.elapsed_time(end) if i else 0.0
            return total / (reps * n)

        graph_ms = replays_ms()
        graph_ms_again = replays_ms()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        searcher._scan_eager(searcher._make_state(B), lp, lens, lens_dev, n)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / n
        fg.load(searcher._make_state(B), lp, lens_dev, n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fg.graph.replay(n)
            torch.cuda.synchronize()
        k6 = [e for e in prof.key_averages() if "beam_step_kernel" in e.key]
        kernel_us = (sum(e.device_time_total for e in k6) / sum(e.count for e in k6)
                     if k6 else None)
    report = beam_step_library().ptxas_report
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)]
    bound_us = beam_step_bytes(searcher, B) / HBM_BYTES_PER_S * 1e6
    ms = 0.5 * (graph_ms + graph_ms_again)
    fig = {"phase": "kernel_beam_step", "B": B, "K": searcher.config.beam_width,
           "first_beam": searcher.config.first_beam_size, "H": searcher.H,
           "order": searcher.order, "frames": n, "padding_rows": int((lens == 0).sum()),
           "live_beams_equal": lb.live_beams(*got) == lb.live_beams(*want),
           "nbest_equal": nbest[0] == nbest[1], "nbest_rows": sum(len(r) for r in nbest[0]),
           "launches": launches, "launches_per_frame": launches / n,
           "ms": ms, "ms_runs": [graph_ms, graph_ms_again],
           "ms_is": "a frame: CUDA events over the batch's graph replays, mean of 3 runs",
           "kernel_us": kernel_us, "kernel_us_is": "the profiler's device time a launch",
           "plain_ms": plain_ms,
           "plain_ms_is": "_expand op by op, host clock to a sync, a frame",
           "bound_ms": bound_us / 1e3, "bound_by": "bytes",
           "share_of_bound": bound_us / 1e3 / ms, "registers": regs, "spill_bytes": spills,
           "max_abs_err": 0.0, "library_ms": None}
    fig["ok"] = (fig["live_beams_equal"] and fig["nbest_equal"] and fig["nbest_rows"] > 0
                 and launches == n and spills and not any(spills))
    emit(fig)
    if not fig["ok"]:
        raise RuntimeError(f"kernel_beam_step: {fig}")
    return fig


def search_graph_against_eager(searcher, lp, lens):
    """One batch of the device search with its frames replayed from the
    captured CUDA graph of K6 and issued op by op (``_scan_eager``): the
    final live beams as a set (``live_beams``) and the n-best (with the
    on-card rescore) bit for bit, every frame
    replayed; each path's ms a frame (host clock to a sync, the mean of two
    runs in turns graph, eager, eager, graph, after one of each; and to the
    return, the host's issue) and launch
    calls a frame (the profiler's host launch events over one run), and the
    device memory the capture reserved (buffers, the graph's pool and the
    outputs held)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from b2txt_tpu_torch.decode import lmbeam_device as lb
    from b2txt_tpu_torch.utils.profiling import counters, tracing

    with torch.inference_mode():
        lp, lens, log_bp = searcher._prep_batch(lp, lens)
        if log_bp != 0.0:
            lp[:, :, searcher.blank] -= log_bp
        B, n = lp.shape[0], min(lp.shape[1], int(lens.max()))
        lens_dev = torch.from_numpy(lens.astype(np.int64)).to(lp.device)
        paths = {
            "graph": lambda: searcher._scan_batch(searcher._make_state(B), lp, lens),
            "eager": lambda: searcher._scan_eager(searcher._make_state(B), lp, lens, lens_dev, n),
        }
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        with tracing():
            out = {"graph": paths["graph"]()}
        c = counters()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        capture_bytes = torch.cuda.memory_reserved() - reserved
        out["eager"] = paths["eager"]()
        nbest = {}
        for name, (st, recs) in out.items():
            final = tuple(t.cpu().numpy() for t in searcher._finalize(st))
            nbest[name] = searcher._extract_results(final, tuple(r.cpu().numpy() for r in recs),
                                                    None)
        secs = {"graph": [], "eager": []}
        issue = {"graph": [], "eager": []}
        for name in ("graph", "eager", "eager", "graph"):
            t0 = time.perf_counter()
            paths[name]()
            issue[name].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
        # the host's issue alone: behind a ~0.5 s device sleep the issue
        # neither waits for the card nor, unless the launch queue fills, is
        # held back by it
        behind_sleep = {}
        for name, fn in paths.items():
            torch.cuda._sleep(10 * BUSY_CYCLES)
            t0 = time.perf_counter()
            fn()
            behind_sleep[name] = 1e3 * (time.perf_counter() - t0) / n
            torch.cuda.synchronize()
        launches = {}
        for name, fn in paths.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            launches[name] = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_EVENTS)
    live_equal = lb.live_beams(*out["graph"]) == lb.live_beams(*out["eager"])
    fig = {"B": B, "K": searcher.config.beam_width, "first_beam": searcher.config.first_beam_size,
           "frames": n, "padding_rows": int((lens == 0).sum()),
           "live_beams_equal": live_equal,
           "nbest_equal": nbest["graph"] == nbest["eager"],
           "nbest_rows": sum(len(r) for r in nbest["graph"]),
           "counters": c, "capture_reserved_bytes": capture_bytes,
           "ms_per_frame": {k: 1e3 * sum(v) / len(v) / n for k, v in secs.items()},
           "issue_ms_per_frame": {k: 1e3 * sum(v) / len(v) / n for k, v in issue.items()},
           "issue_ms_per_frame_behind_sleep": behind_sleep,
           "launch_calls_per_frame": {k: v / n for k, v in launches.items()},
           "clock": "host, to a sync"}
    fig["ok"] = (live_equal and fig["nbest_equal"] and fig["nbest_rows"] > 0
                 and c.get("search.graph_frames") == c.get("search.frames") == n)
    return fig


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


def real_rows(out):
    """A FinalOutput's n-best rows of real hypotheses: beams at the search's
    NEG score floor carry payloads that depend on how top-k orders ties."""
    return [r for r in out.nbest if r[1] > -1e29]


def phase_search_parity(world, logits, requests, py_outs):
    """The serve phase's posteriors through DecoderService(searcher_backend=
    "device") on the card: every planted sentence, the python oracle's
    sentences, and the n-best of the same searcher on the CPU."""
    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.config import DecodeConfig

    lexicon, lm = world
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=100)
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        # the service builds its searcher on the card; the CPU one is passed in
        svc = DecoderService(lexicon, lm, cfg, searcher_backend="device", channel_order="model",
                             searcher=None if device == "cuda" else
                             DeviceLexiconBeamSearch(lexicon, lm, cfg, device="cpu"))
        t1 = time.perf_counter()
        runs[device] = (svc.decode_utterances(logits, batch_size=len(logits)),
                        t1 - t0, time.perf_counter() - t1)
    outs, cpu_outs = runs["cuda"][0], runs["cpu"][0]
    same_sentences, max_abs, scores_ok = True, 0.0, True
    for o, c in zip(outs, cpu_outs):
        a, b = real_rows(o), real_rows(c)
        if not a or [r[0] for r in a] != [r[0] for r in b]:
            same_sentences = False
            continue
        x = np.array([[r[1], r[2], r[4]] for r in a], np.float64)
        y = np.array([[r[1], r[2], r[4]] for r in b], np.float64)
        max_abs = max(max_abs, float(np.abs(x - y).max()))
        scores_ok &= bool(np.allclose(x, y, rtol=SEARCH_TOL, atol=SEARCH_TOL))
    fig = {"phase": "search_parity", "requests": len(logits), "vocab": VOCAB,
           "config": cfg.to_dict(),
           "exact": sum(o.sentence == s for o, (s, _) in zip(outs, requests)),
           "same_as_python_oracle": sum(o.sentence == p.sentence for o, p in zip(outs, py_outs)),
           "nbest_rows": [len(real_rows(o)) for o in outs],
           "nbest_same_sentences_as_cpu": same_sentences,
           "nbest_max_abs_diff_vs_cpu": max_abs, "tol": SEARCH_TOL,
           "searcher_build_s": {d: r[1] for d, r in runs.items()},
           "decode_s_per_request": {d: r[2] / len(logits) for d, r in runs.items()}}
    fig["ok"] = (fig["exact"] == len(logits) == fig["same_as_python_oracle"]
                 and same_sentences and scores_ok)
    emit(fig)
    return fig


def phase_serve_connected(cfg, device: str, counters):
    """The connected pipeline at bench.py's reference scale: planted
    features → smoothing → GRUDecoder (K1) → log-softmax on the card →
    DecoderService.decode_batched_utterances (device searcher, pruned trigram
    in bucket tables, on-card unpruned pool rescore). Returns the figures,
    the searcher and one batch of posteriors."""
    import torch

    from b2txt_tpu_torch.data.synthetic import phoneme_code
    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.evaluate.harness import _batched_inference_device
    from b2txt_tpu_torch.models import gru_decoder
    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
    from b2txt_tpu_torch.ops.gru import gru_layer_reference
    from b2txt_tpu_torch.models.planted import features_on_device, planted_params
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.config import DecodeConfig
    from b2txt_tpu_torch.utils.profiling import counters as traced, tracing

    t0 = time.perf_counter()
    lexicon, lm_unpruned, wl, rng, corpus = build_world(CONNECTED_VOCAB, SEED)
    t1 = time.perf_counter()
    lm = lm_unpruned.prune(PRUNE_THRESHOLD)
    t2 = time.perf_counter()
    requests = plant_requests(lexicon, wl, rng, CONNECTED_REQUESTS, BINS)
    dcfg = DecodeConfig(**CONNECTED_DECODE)
    world_s, prune_s = t1 - t0, t2 - t1
    t3 = time.perf_counter()
    searcher = DeviceLexiconBeamSearch(lexicon, lm, dcfg, max_homophones=4,
                                       rescore_lm=lm_unpruned, state_key="history",
                                       device=device)
    torch.cuda.synchronize(device)
    table_s = time.perf_counter() - t3
    service = DecoderService(lexicon, lm, dcfg, rescore_lm=lm_unpruned, channel_order="model",
                             searcher_backend="device", searcher=searcher)
    sizes_bytes = {"decode_lm": searcher.dev_lm.table_bytes,
                   "rescore_lm": searcher.rescore_lm.table_bytes,
                   "trie": searcher.trie.nbytes}

    code = phoneme_code(cfg.model.n_input_features)
    model = GRUDecoder(cfg.model, 45, 41, device=device)
    model.load_state_dict(planted_params(cfg.model, 45, code))
    labels = torch.from_numpy(np.stack([lab for _, lab in requests])).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    feats_list = list(features_on_device(torch.from_numpy(code).to(device), labels, gen,
                                         noise=0.3).cpu().numpy())
    infer = dict(day_idx=0, cfg=cfg, compute_dtype=torch.bfloat16,
                 batch_size=CONNECTED_BATCH, time_bucket=8)

    def pipeline(feats):
        t0 = time.perf_counter()
        batches, sizes, order, _ = _batched_inference_device(model, feats, **infer)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        outs = service.decode_batched_utterances(batches, sizes)
        return outs, order, batches, sizes, t1 - t0, time.perf_counter() - t1

    pipeline(feats_list[:CONNECTED_BATCH])   # warm-up: one batch
    zero(counters)
    with tracing():   # the search's frames and captures, beside K6's launches
        outs, order, batches, sizes, stage1_s, decode_s = pipeline(feats_list)
    launches = counted_launches(counters)
    searched = {"frames": traced().get("search.frames", 0),
                "graph_captures": traced().get("search.graph_captures", 0)}
    n_batches = len(batches)

    hyp = [None] * len(requests)
    for i, o in zip(order, outs):
        hyp[i] = o
    sents = [s for s, _ in requests]
    exact, search_errors, wer, (lo, hi) = score(hyp, sents)

    # the same posteriors fetched to the host, through the native searcher
    host_lp, k = [None] * len(requests), 0
    for (lp, lens), n in zip(batches, sizes):
        arr = lp.cpu().numpy()
        for row in range(n):
            host_lp[order[k]] = arr[row, : lens[row]]
            k += 1
    native_fig, native_service = native_decode((lexicon, lm, lm_unpruned), dcfg, host_lp,
                                               sents, hyp)

    # one batch's log-probs through the kernels and with the plain recurrence
    # patched in. The planted W_hh is 0, so this holds K1's row and gate
    # indexing at B=128; kernel_gru_fwd's (128, 125, 768, decoder_init) case
    # holds its h·W_hh product at this shape
    first = feats_list[:CONNECTED_BATCH]
    kernel_lp = _batched_inference_device(model, first, **infer)[0][0][0]
    with mock.patch.object(gru_decoder, "gru_layer", gru_layer_reference):
        plain_lp = _batched_inference_device(model, first, **infer)[0][0][0]
    stage1_vs_plain = {
        "max_abs_err": float((kernel_lp - plain_lp).abs().max()),
        "argmax_equal": bool(torch.equal(kernel_lp.argmax(-1), plain_lp.argmax(-1))),
        "within_tol": bool(torch.allclose(kernel_lp, plain_lp, rtol=2e-2, atol=2e-2)),
        "finite": bool(torch.isfinite(kernel_lp).all()),
        "tol": "rtol=atol=2e-2 (bf16)", "shape": list(kernel_lp.shape)}

    # one batch again, split: issuing the frames (host), the device
    # finishing them, then rescore + n-best extraction (collect)
    lp, lens = batches[0]
    t0 = time.perf_counter()
    handle = searcher._dispatch_batch(lp, lens)
    t1 = time.perf_counter()
    if handle.event is not None:
        handle.event.synchronize()
    t2 = time.perf_counter()
    searcher._collect_batch(handle)
    t3 = time.perf_counter()
    split = {"issue_ms": (t1 - t0) * 1e3, "device_wait_ms": (t2 - t1) * 1e3,
             "collect_ms": (t3 - t2) * 1e3}
    profile = profile_call(lambda: searcher._collect_batch(searcher._dispatch_batch(lp, lens)),
                             top=10)
    # the eval cell's search shape: 32 rows, the last 5 padding, 8 shorter
    lens32 = lens[:EVAL_SEARCH_BATCH].copy()
    lens32[-5:] = 0
    lens32[:8] -= np.arange(8, dtype=lens32.dtype)
    graph_fig = search_graph_against_eager(searcher, lp[:EVAL_SEARCH_BATCH], lens32)
    k6_fig = phase_kernel_beam_step(searcher, lp[:EVAL_SEARCH_BATCH], lens32)
    fig = {"phase": "serve_connected", "vocab": CONNECTED_VOCAB, "order": 3,
           "prune_threshold": PRUNE_THRESHOLD, "decode": CONNECTED_DECODE,
           "max_homophones": 4, "H": searcher.H, "state_key": "history",
           "requests": len(requests), "batch": CONNECTED_BATCH, "bins": BINS,
           "frames": int(lens.max()), "words_per_sentence": float(np.mean(
               [len(s.split()) for s in sents])),
           "lm_entries": {"decode": searcher.dev_lm.n_entries,
                          "rescore": searcher.rescore_lm.n_entries},
           "exact": exact, "search_errors": search_errors, "wer": wer, "wer_ci": [lo, hi],
           **native_fig, "stage1_vs_plain": stage1_vs_plain,
           "sentences_per_s": len(requests) / (stage1_s + decode_s),
           "stage1_ms_per_batch": stage1_s * 1e3 / n_batches,
           "decode_ms_per_batch": decode_s * 1e3 / n_batches,
           "one_batch_split": split, "decode_profile": profile, "graph_vs_eager": graph_fig,
           "kernel_beam_step": k6_fig,
           "world_build_s": world_s, "prune_s": prune_s, "table_build_s": table_s,
           "device_table_bytes": sizes_bytes, "launches": launches, "searched": searched}
    emit(fig)
    world = {"searcher": searcher, "native_service": native_service, "model": model,
             "lexicon": lexicon, "lm": lm, "lm_unpruned": lm_unpruned, "decode": dcfg,
             "words": wl, "rng": rng, "code": code, "infer": infer,
             "first_batch": (feats_list[:CONNECTED_BATCH], sents[:CONNECTED_BATCH]),
             "corpus": corpus, "posteriors": (host_lp, sents)}
    return fig, world


def score(finals, sents):
    """Exact sentences, search errors (the planted sentence is in the n-best
    and scores above the answer) and WER with its bootstrap CI."""
    from b2txt_tpu_torch.utils.metrics import calculate_aggregate_error_rate

    exact = sum(h.sentence == s for h, s in zip(finals, sents))
    search_errors = 0
    for h, s in zip(finals, sents):
        truth = [r for r in h.nbest if r[0] == s]
        if h.sentence != s and truth and h.nbest and truth[0][4] > h.nbest[0][4]:
            search_errors += 1
    wer, lo, hi, _ = calculate_aggregate_error_rate(
        [s.split() for s in sents], [h.sentence.split() for h in finals], seed=0)
    return exact, search_errors, wer, [lo, hi]


def host_cpu() -> dict:
    """The host's CPU as ``/proc/cpuinfo`` describes its first core (some
    hosts report the model name as "unknown"; family and model number still
    identify it), its architecture and the cores this process may use:
    host-side figures stand beside them."""
    import os
    import platform

    info = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().split("\n\n")[0].splitlines():
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    except OSError:
        pass
    return {"model_name": info.get("model name", "not reported"),
            "vendor": info.get("vendor_id"), "family": info.get("cpu family"),
            "model": info.get("model"), "mhz": info.get("cpu MHz"),
            "arch": platform.machine(), "cores": len(os.sched_getaffinity(0))}


def write_world(directory, lexicon, lm, lm_unpruned) -> dict:
    """The decode LM and the unpruned one as ARPA, and the lexicon as the
    native loader reads it (bench.py writes the same three files)."""
    from b2txt_tpu_torch.runtime import write_lexicon

    paths = {k: str(Path(directory) / name) for k, name in
             (("arpa", "lm.arpa"), ("unpruned", "lm_unpruned.arpa"), ("lexicon", "lexicon.txt"))}
    lm.to_arpa(paths["arpa"])
    lm_unpruned.to_arpa(paths["unpruned"])
    write_lexicon(lexicon, paths["lexicon"])
    return paths


def native_decode(world, dcfg, host_lp, sents, device_finals):
    """The connected posteriors on the host through
    ``DecoderService(searcher_backend="native")`` with the JAX package's
    signature (``arpa_path``, ``lexicon_path``): the pruned trigram and the
    lexicon as files, the unpruned trigram loaded for the native pool
    rescore (bench.py's native run). Returns the figures and the service."""
    import tempfile

    from b2txt_tpu_torch.serve import DecoderService

    lexicon, lm, lm_unpruned = world
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        t0 = time.perf_counter()
        files = write_world(tmp, lexicon, lm, lm_unpruned)
        t1 = time.perf_counter()
        service = DecoderService(lexicon, lm, dcfg, None, None, "model", "native",
                                 files["arpa"], files["lexicon"])
        service.searcher.set_rescore_lm(files["unpruned"])
        t2 = time.perf_counter()
    finals = service.decode_utterances(host_lp)
    t3 = time.perf_counter()
    exact, search_errors, wer, ci = score(finals, sents)
    return {"native_exact": exact, "native_search_errors": search_errors, "native_wer": wer,
            "native_wer_ci": ci,
            "native_equals_device": sum(a.sentence == b.sentence
                                        for a, b in zip(finals, device_finals)),
            "native_sentences_per_s": len(finals) / (t3 - t2), "native_load_s": t2 - t1,
            "native_write_files_s": t1 - t0, "native_lm_entries": service.searcher.lm_entries,
            "native_clock": "host, DecoderService.decode_utterances over host arrays",
            "host_cpu": host_cpu()}, service


def planted_sessions(world, names, trials: int, bins: int, seed: int, device) -> dict:
    """Planted sessions in ``load_session_file``'s layout, held in memory:
    per session ``trials`` sentences of the world's words, their features
    (made on ``device``), phoneme ids with SIL at word ends, labels."""
    import torch

    from b2txt_tpu_torch.models.planted import features_on_device

    lexicon = world["lexicon"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    code = torch.from_numpy(world["code"]).to(device)
    out = {}
    for name in names:
        reqs = plant_requests(lexicon, world["words"], rng, trials, bins)
        labels = torch.from_numpy(np.stack([lab for _, lab in reqs])).to(device)
        feats = features_on_device(code, labels, gen, noise=0.3).cpu().numpy()
        ids = [np.asarray([p for w in sent.split()
                           for p in list(lexicon.prons[lexicon.word_ids[w]][0]) + [40]], np.int32)
               for sent, _ in reqs]
        out[name] = {"neural_features": list(feats), "n_time_steps": [bins] * trials,
                     "seq_class_ids": ids, "seq_len": [len(i) for i in ids],
                     "transcriptions": [None] * trials,
                     "sentence_label": [sent for sent, _ in reqs], "session": [name] * trials,
                     "block_num": [t // 16 for t in range(trials)],
                     "trial_num": list(range(trials))}
    return out


def phase_evaluate(cfg, world, counters):
    """Session evaluation (``evaluate.harness``) over three planted sessions
    held in memory, on distinct days, with the connected phase's model and
    world: (a) the batched host mode with the native DecoderService, (b) the
    device-resident mode with a device DecoderService around the connected
    phase's searcher, (c) ``run_single_decoding_step`` on a few trials; then
    the competition CSV. K1's launches are counted in each mode."""
    import copy
    import csv
    import tempfile

    import torch

    from b2txt_tpu_torch.evaluate import (evaluate_session_data, run_single_decoding_step,
                                          write_competition_csv)
    from b2txt_tpu_torch.serve import DecoderService
    from b2txt_tpu_torch.utils.phonemes import greedy_collapse

    model = world["model"]
    device = model.h0.device
    # the training session list gives each session its day: one per day layer
    cfg = copy.deepcopy(cfg)
    cfg.dataset.sessions = [f"synthetic.{i:02d}" for i in range(model.n_days)]
    names = [cfg.dataset.sessions[d] for d in EVAL_DAYS]
    t0 = time.perf_counter()
    data = planted_sessions(world, names, EVAL_TRIALS, BINS, SEED + 7, device)
    make_s = time.perf_counter() - t0
    device_service = DecoderService(world["lexicon"], world["lm"], world["decode"],
                                    rescore_lm=world["lm_unpruned"], channel_order="model",
                                    searcher_backend="device", searcher=world["searcher"])

    def run(fn):
        zero(counters)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, {"s": time.perf_counter() - t0, "launches": counted_launches(counters)}

    modes = {}
    a, modes["native_host"] = run(lambda: evaluate_session_data(
        model, cfg, data.items(), decoder=world["native_service"],
        compute_dtype=torch.bfloat16))
    b, modes["device_resident"] = run(lambda: evaluate_session_data(
        model, cfg, data.items(), decoder=device_service, compute_dtype=torch.bfloat16,
        device_resident=True))
    first = data[names[0]]
    single, modes["single_step"] = run(lambda: [
        run_single_decoding_step(model, x, EVAL_DAYS[0], cfg, torch.bfloat16)
        for x in first["neural_features"][:EVAL_SINGLE]])
    for out, m in ((a, modes["native_host"]), (b, modes["device_resident"])):
        m.update({"greedy_PER": out["greedy_PER"], "day_PER": out["day_PER"],
                  "wer": out["WER"], "wer_ci": list(out["WER_CI"]),
                  "sentences_per_s": out["sentences_per_sec"],
                  "lm_decode_s": out["lm_decode_time"]})
    single_ids = [greedy_collapse(np.argmax(lg, axis=-1)) for lg in single]
    single_err = max(float(np.abs(lg - t.logits).max()) for lg, t in zip(single, a["trials"]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        path = str(Path(tmp) / "submission.csv")
        write_competition_csv(a["trials"], path)
        with open(path, newline="") as f:
            csv_rows = sum(1 for _ in csv.reader(f))
    n = len(a["trials"])
    fig = {"phase": "evaluate", "sessions": names,
           "day_idx": sorted({t.day_idx for t in a["trials"]}),
           "trials_per_session": EVAL_TRIALS, "bins": BINS, "vocab": CONNECTED_VOCAB,
           "input": "planted sessions in memory, load_session_file's layout",
           "sessions_make_s": make_s, "modes": modes,
           "exact": {"native_host": sum(t.decoded_sentence == t.sentence_label for t in a["trials"]),
                     "device_resident": sum(t.decoded_sentence == t.sentence_label
                                            for t in b["trials"])},
           "same_sentence_both_modes": sum(x.decoded_sentence == y.decoded_sentence
                                           for x, y in zip(a["trials"], b["trials"])),
           "same_greedy_ids_both_modes": sum(x.decoded_ids == y.decoded_ids
                                             for x, y in zip(a["trials"], b["trials"])),
           "single_step_trials": EVAL_SINGLE,
           "single_step_same_greedy_ids": sum(ids == t.decoded_ids
                                              for ids, t in zip(single_ids, a["trials"])),
           "single_step_vs_batched_max_abs": single_err, "single_step_tol": "2e-2 (bf16)",
           "csv_rows": csv_rows, "trials": n, "host_cpu": host_cpu()}
    emit(fig)
    return fig


def check_evaluate(fig) -> list:
    problems = []
    n, modes = fig["trials"], fig["modes"]
    for label in ("native_host", "device_resident"):
        if modes[label]["wer"] != 0.0 or fig["exact"][label] != n:
            problems.append(f"evaluate ({label}): WER {modes[label]['wer']}, "
                            f"{fig['exact'][label]}/{n} exact")
    for label in ("native_host", "device_resident", "single_step"):
        if modes[label]["launches"]["gru_fwd"] == 0:
            problems.append(f"evaluate ({label}): gru_fwd never launched")
    if (fig["same_sentence_both_modes"], fig["same_greedy_ids_both_modes"]) != (n, n):
        problems.append(f"evaluate: the two modes differ: {fig['same_sentence_both_modes']} "
                        f"sentences, {fig['same_greedy_ids_both_modes']} greedy ids of {n} agree")
    if (fig["single_step_same_greedy_ids"] != fig["single_step_trials"]
            or not fig["single_step_vs_batched_max_abs"] <= 2e-2):
        problems.append(f"evaluate: run_single_decoding_step against the batched mode: "
                        f"{fig['single_step_same_greedy_ids']} greedy ids agree, "
                        f"max |diff| {fig['single_step_vs_batched_max_abs']}")
    if fig["csv_rows"] != n + 1 or len(fig["day_idx"]) != len(EVAL_DAYS):
        problems.append(f"evaluate: {fig['csv_rows']} CSV rows for {n} trials, "
                        f"days {fig['day_idx']}")
    return problems


def phase_cli(cfg, world, counters):
    """The user CLIs of ``b2txt_tpu_torch.scripts`` over the connected world,
    called as a user calls them (``main(argv)``): (a) ``build_lm --native
    --no-format`` on the world's corpus and 125,000-word dictionary; (b)
    ``decode_logits`` on the connected posteriors saved as one (N, T, 41)
    .npy, native on all 512 and the device backend on the first 16; then the
    device searcher's sum-mode merge twice on those 16; (c)
    ``convert_checkpoint`` there and back on the connected model, and the
    logits of a model loaded from the result; (d) ``eval_45session_sim``'s
    path over 45 sessions × 8 trials in memory at full width, native, then
    device-resident; (e) ``utils.profiling.device_trace`` around one
    connected stage-1 batch inside a ``span``. K1's launches are
    counted in (c), (d) and (e), each from 0."""
    import tempfile

    import torch

    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.evaluate.harness import _batched_inference_device
    from b2txt_tpu_torch.runtime import write_lexicon
    from b2txt_tpu_torch.scripts import build_lm, convert_checkpoint, decode_logits
    from b2txt_tpu_torch.scripts import eval_45session_sim as sim
    from b2txt_tpu_torch.scripts.evaluate_model import load_decoder
    from b2txt_tpu_torch.utils.config import DecodeConfig
    from b2txt_tpu_torch.utils.profiling import device_trace, span

    device = world["model"].h0.device

    def counted(fn):
        zero(counters)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0, counted_launches(counters)

    fig = {"phase": "cli", "vocab": CONNECTED_VOCAB, "launches": {}}
    host_lp, sents = world["posteriors"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        # (a) build_lm
        (tmp / "corpus.txt").write_text("\n".join(" ".join(s) for s in world["corpus"]) + "\n")
        write_lexicon(world["lexicon"], str(tmp / "dict.txt"))
        t0 = time.perf_counter()
        lm = build_lm.main(["--corpus", str(tmp / "corpus.txt"), "--dict", str(tmp / "dict.txt"),
                            "--out", str(tmp / "lm"), "--native", "--no-format"])
        fig["build_lm"] = {"s": time.perf_counter() - t0, "sentences": len(world["corpus"]),
                           "ngrams": [len(t) for t in lm.tables],
                           "lexicon_lines": sum(1 for _ in open(tmp / "lm" / "lexicon.txt"))}

        # (b) decode_logits, native on all, the device backend on the first 16
        np.save(tmp / "posteriors.npy", np.stack(host_lp))
        np.save(tmp / "first.npy", np.stack(host_lp[:CLI_DEVICE_UTTS]))
        common = ["--lm_dir", str(tmp / "lm"), *CLI_DECODE_ARGS]
        runs = {}
        for backend, name in (("native", "posteriors"), ("device", "first")):
            t0 = time.perf_counter()
            hyps = decode_logits.main([*common, "--logits", str(tmp / f"{name}.npy"), "--out",
                                       str(tmp / f"hyps_{backend}.txt"), "--backend", backend,
                                       "--device", str(device)])
            runs[backend] = (list(hyps.values()), time.perf_counter() - t0)
        nat, dev = runs["native"][0], runs["device"][0]
        fig["decode_logits"] = {
            "native_utterances": len(nat),
            "native_exact": sum(h == s for h, s in zip(nat, sents)),
            "native_s": runs["native"][1], "native_sentences_per_s": len(nat) / runs["native"][1],
            "device_utterances": len(dev),
            "device_equals_native": sum(a == b for a, b in zip(dev, nat)),
            "device_s": runs["device"][1], "device_sentences_per_s": len(dev) / runs["device"][1],
            "clock": "host, around main() (LM load and table build included)"}

        # the device searcher's sum-mode merge (a fixed-order segment sum)
        # twice on the same batch: the n-best scores must repeat bit for bit
        searcher = world["searcher"]
        summing = DeviceLexiconBeamSearch(
            world["lexicon"], None, DecodeConfig(**{**CONNECTED_DECODE, "sum_mode": True}),
            max_homophones=4, dev_lm=searcher.dev_lm, rescore_lm=searcher.rescore_lm,
            device=searcher.device)
        lp = np.stack(host_lp[:CLI_DEVICE_UTTS])
        a, b = (summing.decode_batch(lp) for _ in range(2))
        fig["sum_mode_merge_repeat"] = {
            "utterances": CLI_DEVICE_UTTS,
            "bit_identical": sum([(r.sentence, r.ac_score, r.lm_score) for r in x]
                                 == [(r.sentence, r.ac_score, r.lm_score) for r in y]
                                 for x, y in zip(a, b))}

        # (c) convert_checkpoint there and back
        model = world["model"]
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"model_state_dict": sd}, tmp / "ref.pt")
        convert_checkpoint.main(["--from-torch", str(tmp / "ref.pt"), "--out", str(tmp / "ckpt")])
        convert_checkpoint.main(["--from-tpu", str(tmp / "ckpt"), "--out", str(tmp / "back.pt")])
        back = torch.load(tmp / "back.pt", weights_only=True)["model_state_dict"]
        loaded = load_decoder(str(tmp / "ckpt"), cfg, device)
        first = world["first_batch"][0]
        want = _batched_inference_device(model, first, **world["infer"])[0][0][0]
        got, _, fig["launches"]["convert_checkpoint"] = counted(
            lambda: _batched_inference_device(loaded, first, **world["infer"])[0][0][0])
        fig["convert_checkpoint"] = {
            "tensors": len(sd),
            "bit_identical": sum(k in back and back[k].dtype == v.dtype and torch.equal(back[k], v)
                                 for k, v in sd.items()),
            "logits_bit_identical": bool(torch.equal(got, want)), "logits_shape": list(got.shape)}

        # (d) eval_45session_sim's path, in memory
        names = sim.session_names(CLI_SESSIONS)
        scfg = sim.make_config(names, cfg.model.n_input_features)
        t0 = time.perf_counter()
        smodel = sim.make_model(scfg, device)
        data = sim.simulated_sessions(names, CLI_TRIALS, cfg.model.n_input_features)
        make_s = time.perf_counter() - t0
        modes, results = {}, {}
        for label, searcher_name, resident in (("native", "native", False),
                                               ("device_resident", "device", True)):
            decoder = sim.make_decoder(str(tmp), searcher_name, 128, device)
            res, s, fig["launches"][f"eval_{label}"] = counted(
                lambda: sim.evaluate(smodel, scfg, data.items(), decoder, resident))
            trials = results[label] = res["trials"]
            modes[label] = {"trials": len(trials), "s": s, "sentences_per_s": len(trials) / s,
                            "with_sentence": sum(t.decoded_sentence is not None for t in trials),
                            "greedy_PER": res["greedy_PER"], "WER": res["WER"]}
        fig["eval_45session_sim"] = {"sessions": CLI_SESSIONS, "trials_per_session": CLI_TRIALS,
                                     "make_s": make_s, "modes": modes,
                                     "same_greedy_ids_both_modes": sum(
                                         x.decoded_ids == y.decoded_ids for x, y in
                                         zip(results["native"], results["device_resident"]))}

        # (e) a profiled stage-1 batch
        def stage1():
            with span(CLI_RANGE):
                return _batched_inference_device(model, first, **world["infer"])

        with device_trace(str(tmp / "trace")):
            _, _, fig["launches"]["profiling"] = counted(stage1)
        events = json.loads((tmp / "trace" / "trace.json").read_text())["traceEvents"]
        fig["profiling"] = {
            "range": CLI_RANGE,
            "range_events": sum(e.get("name") == CLI_RANGE for e in events),
            "k1_kernel_events": sum(e.get("cat") == "kernel"
                                    and "gru_fwd_kernel" in e.get("name", "") for e in events),
            "kernel_events": sum(e.get("cat") == "kernel" for e in events)}
    fig["launches_total"] = {n: sum(v[n] for v in fig["launches"].values()) for n in counters}
    emit(fig)
    return fig


def check_cli(fig, n_layers) -> list:
    problems = []
    b = fig["build_lm"]
    if len(b["ngrams"]) != 3 or not all(b["ngrams"]) or b["lexicon_lines"] != CONNECTED_VOCAB:
        problems.append(f"cli build_lm: {b}")
    d = fig["decode_logits"]
    if not d["native_exact"] == d["native_utterances"] == CONNECTED_REQUESTS:
        problems.append(f"cli decode_logits native: {d['native_exact']}/{d['native_utterances']}")
    if not d["device_equals_native"] == d["device_utterances"] == CLI_DEVICE_UTTS:
        problems.append(f"cli decode_logits device: {d['device_equals_native']}/"
                        f"{d['device_utterances']} equal to native")
    if fig["sum_mode_merge_repeat"]["bit_identical"] != CLI_DEVICE_UTTS:
        problems.append(f"cli sum-mode merge repeat: {fig['sum_mode_merge_repeat']}")
    c = fig["convert_checkpoint"]
    if c["bit_identical"] != c["tensors"] or not c["logits_bit_identical"]:
        problems.append(f"cli convert_checkpoint: {c}")
    for label, m in fig["eval_45session_sim"]["modes"].items():
        n = CLI_SESSIONS * CLI_TRIALS
        if not (m["trials"] == m["with_sentence"] == n and np.isfinite(m["greedy_PER"])
                and np.isfinite(m["WER"]) and fig["launches"][f"eval_{label}"]["gru_fwd"] > 0):
            problems.append(f"cli eval_45session_sim {label}: {m}, "
                            f"launches {fig['launches'][f'eval_{label}']}")
    e = fig["eval_45session_sim"]
    if e["same_greedy_ids_both_modes"] != CLI_SESSIONS * CLI_TRIALS:
        problems.append(f"cli eval_45session_sim: greedy ids equal in both modes on "
                        f"{e['same_greedy_ids_both_modes']} trials")
    pr = fig["profiling"]
    if pr["range_events"] < 1 or pr["k1_kernel_events"] != n_layers:
        problems.append(f"cli profiling: {pr}")
    if fig["launches"]["profiling"]["gru_fwd"] != n_layers:
        problems.append(f"cli profiling: K1 launched {fig['launches']['profiling']} times")
    return problems


def phase_redis(world, logits, requests):
    """``RedisDecoderServer`` looping in a thread over the port's in-process
    fake redis (neither the ``redis`` package nor a server is on the
    machine), wrapping a native DecoderService over the serve phase's world;
    ``RemoteLMClient`` sends each served request (posteriors from K1):
    reset, update_params, the logits in chunks, finalize. The finals are
    held against the in-process service with the same backend."""
    import threading

    from b2txt_tpu_torch.serve import fakeredis

    fakeredis.install_fake_redis()   # before the adapter and client import redis
    fakeredis.reset_all()
    from b2txt_tpu_torch.serve import DecoderService, FinalOutput
    from b2txt_tpu_torch.serve.redis_adapter import RedisDecoderServer
    from b2txt_tpu_torch.serve.redis_client import RemoteLMClient
    from b2txt_tpu_torch.utils.config import DecodeConfig
    from b2txt_tpu_torch.utils.phonemes import rearrange_speech_logits

    lexicon, lm = world
    knobs = dict(acoustic_scale=0.325, blank_penalty=90.0, nbest=100)
    served = DecoderService(lexicon, lm, DecodeConfig(), searcher_backend="native",
                            channel_order="lm")
    in_process = DecoderService(lexicon, lm, DecodeConfig(**knobs), searcher_backend="native",
                                channel_order="model")
    server = RedisDecoderServer(served)
    thread = threading.Thread(target=server.run, daemon=True)
    thread.start()
    finals, partials, latency_s = [], [], []
    try:
        client = RemoteLMClient()
        for lg in logits:
            t0 = time.perf_counter()
            client.reset()
            client.update_params(**knobs)
            partials.append([client.send_logits(rearrange_speech_logits(lg[i : i + REDIS_CHUNK]))
                             for i in range(0, lg.shape[0], REDIS_CHUNK)])
            finals.append(client.finalize())
            latency_s.append(time.perf_counter() - t0)
    finally:
        server.stop()
        thread.join(timeout=10)
    want = [FinalOutput.parse_scoring(o.scoring_packed())
            for o in in_process.decode_utterances(logits)]
    same_sentences, max_abs = True, 0.0
    for f, w in zip(finals, want):
        if f.sentence != w.sentence or [r[0] for r in f.nbest] != [r[0] for r in w.nbest]:
            same_sentences = False
            continue
        max_abs = max(max_abs, float(np.abs(np.array([r[1:] for r in f.nbest])
                                            - np.array([r[1:] for r in w.nbest])).max()))
    fig = {"phase": "redis",
           "redis": "RedisDecoderServer in a thread over the in-process fake redis "
                    "(b2txt_tpu_torch/serve/fakeredis.py): no redis package or server",
           "backend": "native", "requests": len(logits), "chunk_frames": REDIS_CHUNK,
           "exact": sum(f.sentence == s for f, (s, _) in zip(finals, requests)),
           "chunks": sum(len(p) for p in partials),
           "nonempty_partials": sum(bool(x) for p in partials for x in p),
           "config_after_update_params": served.config == in_process.config,
           "finals_same_sentences_as_in_process": same_sentences,
           "finals_max_abs_score_diff": max_abs, "tol": REDIS_TOL,
           "nbest_rows": [len(f.nbest) for f in finals],
           "latency_ms_per_request": [t * 1e3 for t in latency_s],
           "latency_ms_mean": 1e3 * sum(latency_s) / len(latency_s),
           "latency_clock": "host, client side: reset to finalize", "host_cpu": host_cpu(),
           "server_stopped": not thread.is_alive()}
    fig["ok"] = (fig["exact"] == len(logits) and fig["nonempty_partials"] == fig["chunks"]
                 and same_sentences and max_abs <= REDIS_TOL
                 and fig["config_after_update_params"] and fig["server_stopped"])
    emit(fig)
    return fig


def gather_entry(p: dict) -> dict:
    """A gather profile line as kernel figures: ms per call of K4, its plain
    version (``index_select``) and ``table[idx]``, each timed over the
    profile's rotated index sets, and the bound: each gathered row read and
    written once, the indices read."""
    g, rw = p["gathers"], p["row_bytes"] // 4
    nbytes = 2 * g * rw * 4 + g * 4
    return {"rows": p["rows"], "rw": rw, "g": g, "in_flight": p["in_flight"],
            "max_abs_err": p["max_abs_err"], "ms": p["kernel_ns_per_row"] * g * 1e-6,
            "plain_ms": p["plain_ns_per_row"] * g * 1e-6,
            "library_ms": p["torch_ns_per_row"] * g * 1e-6,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def phase_kernel_row_gather(bucket_table):
    """K4 bit for bit against its plain version over a grid of row widths,
    gather counts and loads in flight, with repeated indices; then its path,
    the gather profile's three cases (launches counted there); then on the
    decode LM's own bucket table with uniform random bucket ids. The profile
    raises if K4 differs from its plain version in any bit."""
    import torch

    from b2txt_tpu_torch.ops.gather import row_gather, row_gather_reference
    from b2txt_tpu_torch.scripts.profile_gather import CASES, bench_case, bench_gather

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    grid_ok = True
    for rw, g in GATHER_GRID:
        table = torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 14, rw), generator=gen,
                              device="cuda", dtype=torch.int32)
        idx = torch.randint(0, 1 << 14, (g,), generator=gen, device="cuda", dtype=torch.int32)
        idx[: g // 2] = idx[0]
        for w in GATHER_IN_FLIGHT:
            grid_ok &= torch.equal(row_gather(table, idx, in_flight=w),
                                   row_gather_reference(table, idx))
    row_gather.launches = 0
    profile = [bench_case(*case) for case in CASES]
    launches = row_gather.launches
    bidx = torch.randint(0, bucket_table.shape[0], (4096,), generator=gen, device="cuda",
                         dtype=torch.int32)
    bucket = [gather_entry(bench_gather(bucket_table, bidx, w)) for w in (1, 8, 32)]
    fig = {"phase": "kernel_row_gather", "grid": GATHER_GRID, "grid_in_flight": GATHER_IN_FLIGHT,
           "grid_bit_exact": bool(grid_ok), "profile_gather": profile,
           "launches": launches, "main": gather_entry(profile[0]),
           "decode_lm_bucket_table": bucket}
    fig["ok"] = bool(grid_ok)
    emit(fig)
    return fig


def check_connected(fig, n_layers) -> list:
    problems = []
    n_batches = -(-fig["requests"] // fig["batch"])
    if fig["launches"]["gru_fwd"] != n_layers * n_batches:
        problems.append(f"serve_connected: gru_fwd launched {fig['launches']['gru_fwd']} "
                        f"times, expected {n_layers * n_batches}")
    s1 = fig["stage1_vs_plain"]
    if not (s1["within_tol"] and s1["argmax_equal"] and s1["finite"]):
        problems.append(f"serve_connected: kernel-path log-probs against the plain path: {s1}")
    if (fig["exact"], fig["search_errors"], fig["wer"]) != (fig["requests"], 0, 0.0):
        problems.append(f"serve_connected: {fig['exact']}/{fig['requests']} exact, "
                        f"{fig['search_errors']} search errors, WER {fig['wer']}")
    native = (fig["native_exact"], fig["native_search_errors"], fig["native_wer"],
              fig["native_equals_device"])
    if native != (fig["requests"], 0, 0.0, fig["requests"]):
        problems.append(f"serve_connected (native): {fig['native_exact']}/{fig['requests']} "
                        f"exact, {fig['native_search_errors']} search errors, WER "
                        f"{fig['native_wer']}, top-1 equal to the device searcher's on "
                        f"{fig['native_equals_device']}")
    if not fig["graph_vs_eager"]["ok"]:
        problems.append(f"serve_connected: the device search's graph replay against its "
                        f"eager loop: {fig['graph_vs_eager']}")
    # K6: one launch a frame searched, and two warm-up steps a capture
    frames, captures = fig["searched"]["frames"], fig["searched"]["graph_captures"]
    if not frames or fig["launches"]["beam_step"] != frames + 2 * captures:
        problems.append(f"serve_connected: beam_step launched {fig['launches']['beam_step']} "
                        f"times for {frames} frames searched and {captures} captures")
    return problems


def opt_texts(seed: int = 0):
    """bench_opt's stage B n-best lists (``nbest_lists``: per list, 6 words
    from a 3,000-word pool, then 100 candidates each with one word swapped)
    and a 48-word context drawn next, as its stage D draws it."""
    from b2txt_tpu_torch.scripts.bench_opt import nbest_lists

    rng = np.random.default_rng(seed)
    lists, pool = nbest_lists(OPT_NBEST, rng)
    context = " ".join(pool[i] for i in rng.integers(0, len(pool), OPT_CONTEXT_WORDS))
    return lists, context


def opt_bound(cfg, B: int, L: int):
    """Least time for one bf16 forward at (B, L): the weights read once, the
    tokens and mask read and the f32 logits written once, against
    2 · parameters · tokens flops at the bf16 peak."""
    nbytes = 2 * cfg.n_params + B * L * (8 + 4) + 4 * B * L * cfg.vocab_size
    flops = 2.0 * cfg.n_params * B * L
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), flops


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def phase_opt_forward(params, init_s: float):
    """OPT-6.7b's bf16 forward at its published widths (random weights drawn
    on the card): ms and tokens/s by CUDA events, the bound, the share of
    the bf16 peak, the card's peak memory. Then at full width and 2 layers:
    f32 on the card against the same code on the CPU, and bf16 against f32
    on the card, per-text score sums of one n-best list."""
    import dataclasses

    import torch

    from b2txt_tpu_torch.decode.opt_lm import (OPTConfig, OPTModel, OPTRescorer, init_params,
                                               word_hash_encode)

    cfg = OPTConfig.opt_6_7b()
    model = OPTModel.from_state_dict(cfg, params, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(OPT_SEED + 1)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shapes = []
    for B, L in OPT_SHAPES:
        tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device="cuda")
        mask = torch.ones((B, L), device="cuda")
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(tokens, mask, torch.bfloat16), iters=8, warmup=2)
        bound_ms, bound_by, flops = opt_bound(cfg, B, L)
        shapes.append({"B": B, "L": L, "ms": ms, "tokens_per_s": B * L / ms * 1e3,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_share": bound_ms / ms,
                       "mfu_bf16_peak": flops / (ms * 1e-3) / PEAK_FLOPS["bfloat16"]})
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.randint(0, cfg.vocab_size, OPT_SHAPES[0], generator=gen, device="cuda")
    with torch.inference_mode():
        profile = profile_call(lambda: model(tokens, torch.ones_like(tokens, dtype=torch.float32),
                                             torch.bfloat16))
    del model

    # full width, 2 layers: the card against the CPU in f32, bf16 against f32
    small = dataclasses.replace(cfg, num_layers=OPT_PARITY_LAYERS)
    sd = init_params(small, "cuda", torch.float32, gen)
    enc = word_hash_encode(cfg.vocab_size)
    texts = opt_texts()[0][0][:OPT_PARITY_TEXTS]
    card = OPTRescorer(small, params=sd, encode=enc, device="cuda", max_len=OPT_MAX_LEN)
    t0 = time.perf_counter()
    host = OPTRescorer(small, params={k: v.cpu() for k, v in sd.items()}, encode=enc,
                       device="cpu", max_len=OPT_MAX_LEN).score(texts)
    cpu_s = time.perf_counter() - t0
    f32 = card.score(texts)
    bf16 = OPTRescorer(small, params={k: v.to(torch.bfloat16) for k, v in sd.items()},
                       encode=enc, device="cuda", max_len=OPT_MAX_LEN,
                       compute_dtype=torch.bfloat16).score(texts)
    del card, sd
    torch.cuda.empty_cache()
    parity = {"layers": OPT_PARITY_LAYERS, "texts": len(texts),
              "score_range": [min(f32), max(f32)],
              "card_f32_vs_cpu_f32_max_abs": max_abs(f32, host), "f32_tol": OPT_F32_TOL,
              "card_bf16_vs_f32_max_abs": max_abs(bf16, f32), "bf16_tol": OPT_BF16_TOL,
              "cpu_score_s": cpu_s}
    parity["ok"] = bool(parity["card_f32_vs_cpu_f32_max_abs"] <= OPT_F32_TOL
                        and np.all(np.isfinite(bf16))
                        and np.allclose(bf16, f32, **OPT_BF16_TOL))
    fig = {"phase": "opt_forward", "config": "OPTConfig.opt_6_7b()",
           "widths": {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
                      "ffn": cfg.ffn_dim, "heads": cfg.num_heads, "vocab": cfg.vocab_size},
           "params": cfg.n_params, "weights_bytes_bf16": 2 * cfg.n_params,
           "weights": "random N(0, 0.02), bf16, drawn on the card", "init_s": init_s,
           "dtype": "bfloat16", "timing": "CUDA events, 8 forwards after 2 warm-up",
           "shapes": shapes, "profile_32x32": profile, "max_memory_allocated": peak,
           "memory_allocated_before": resident, "parity_2_layers": parity}
    emit(fig)
    return fig


def timed_lists(resc, lists, **kw):
    """Score each list once to warm, then each again on the host clock (the
    fetch syncs); returns (seconds per list, the timed scores)."""
    resc.score(lists[0], **kw)
    t0 = time.perf_counter()
    scores = [resc.score(cands, **kw) for cands in lists]
    return (time.perf_counter() - t0) / len(lists), scores


def phase_opt_rescore(params):
    """OPTRescorer over bench_opt.py's 100-candidate lists at 6.7b, bf16:
    packed and one row per candidate, then a 48-word context through the
    prefix-KV path and by concatenation. Packed equals unpacked and prefix-KV
    equals concatenated within the bf16 tolerance; every score is finite."""
    import torch

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer, word_hash_encode

    cfg = OPTConfig.opt_6_7b()
    enc = word_hash_encode(cfg.vocab_size)
    lists, context = opt_texts()

    def rescorer(**kw):
        return OPTRescorer(cfg, params=params, encode=enc, device="cuda",
                           compute_dtype=torch.bfloat16, **kw)

    packed = rescorer(max_len=OPT_MAX_LEN)
    packed_s, p_scores = timed_lists(packed, lists)
    again = [packed.score(cands) for cands in lists]
    unpacked = rescorer(max_len=OPT_MAX_LEN, pack=False)
    unpacked_s, u_scores = timed_lists(unpacked, lists)
    prefix = rescorer(max_len=512, encode_cont=lambda t, n: enc(t, n + 1)[1:])
    prefix_s, x_scores = timed_lists(prefix, lists, context=context)
    concat_s, c_scores = timed_lists(rescorer(max_len=512),
                                     [[context + " " + c for c in cands] for cands in lists])
    profiles = {"packed": profile_call(lambda: packed.score(lists[0])),
                "unpacked": profile_call(lambda: unpacked.score(lists[0]))}
    every = [np.asarray(v) for v in (p_scores, u_scores, x_scores, c_scores)]
    fig = {"phase": "opt_rescore", "config": "OPTConfig.opt_6_7b(), bf16",
           "lists": OPT_LISTS, "nbest": OPT_NBEST, "encode": "word_hash_encode",
           "tokens_per_list": float(np.mean([sum(len(enc(c, OPT_MAX_LEN)) for c in cands)
                                             for cands in lists])),
           "s_per_list_packed": packed_s, "s_per_list_unpacked": unpacked_s,
           "packed_vs_unpacked_max_abs": max_abs(p_scores, u_scores), "tol": OPT_BF16_TOL,
           "packed_repeat_max_abs": max_abs(p_scores, again),
           "context_words": OPT_CONTEXT_WORDS,
           "s_per_list_prefix_kv": prefix_s, "s_per_list_concatenated": concat_s,
           "prefix_speedup": concat_s / prefix_s, "prefix_runs": prefix.prefix_runs,
           "prefix_vs_concatenated_max_abs": max_abs(x_scores, c_scores),
           "prefix_tol": OPT_PREFIX_TOL,
           "score_range": [float(min(v.min() for v in every)),
                           float(max(v.max() for v in every))],
           "all_finite": bool(all(np.isfinite(v).all() for v in every)),
           "clock": "host, around score() (it ends in the fetch)",
           "profile_one_list": profiles}
    fig["ok"] = bool(fig["all_finite"] and prefix.prefix_runs > 0
                     and fig["packed_repeat_max_abs"] == 0.0
                     and np.allclose(p_scores, u_scores, **OPT_BF16_TOL)
                     and np.allclose(x_scores, c_scores, **OPT_PREFIX_TOL))
    emit(fig)
    return fig


def phase_finalize_opt(world, params, counters):
    """The full finalize on the connected world's first batch of 128 planted
    requests: K1 → log-softmax → device searcher (on-card pool rescore) →
    augment_nbest → the OPT-6.7b α-blend in DecoderService, per utterance and
    grouped (``llm_group_candidates``). Grouped must give every request the
    per-utterance sentence, or one whose blended total lies within the bf16
    tolerance of it."""
    import torch

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer, word_hash_encode
    from b2txt_tpu_torch.evaluate.harness import _batched_inference_device
    from b2txt_tpu_torch.serve import DecoderService

    cfg = OPTConfig.opt_6_7b()
    feats, sents = world["first_batch"]
    dcfg = world["decode"].replace(**FINALIZE_KNOBS)
    llm = OPTRescorer(cfg, params=params, encode=word_hash_encode(cfg.vocab_size),
                      device="cuda", max_len=OPT_MAX_LEN, compute_dtype=torch.bfloat16)
    service = DecoderService(world["lexicon"], world["lm"], dcfg,
                             rescore_lm=world["lm_unpruned"], llm=llm, channel_order="model",
                             searcher_backend="device", searcher=world["searcher"])
    llm.score(sents[:8])     # the rescorer's first call (cuBLAS handles, pinned pool)

    def run(group: int):
        service.llm_group_candidates = group
        zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches, sizes, order, _ = _batched_inference_device(world["model"], feats,
                                                             **world["infer"])
        outs = service.decode_batched_utterances(batches, sizes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finals = [None] * len(feats)
        for i, o in zip(order, outs):
            finals[i] = o
        return finals, {"s": wall, "sentences_per_s": len(feats) / wall,
                        "s_per_sentence": wall / len(feats),
                        "launches": counted_launches(counters),
                        "exact": sum(o.sentence == s for o, s in zip(finals, sents)),
                        "nbest_rows_mean": float(np.mean([len(o.nbest) for o in finals]))}

    per, per_fig = run(0)
    grouped, grouped_fig = run(LLM_GROUP)
    # one per-utterance call: the first request's finalize n-best
    first = [r[0] for r in per[0].nbest]
    per_fig["llm_call_profile"] = {"candidates": len(first),
                                   **profile_call(lambda: llm.score(first))}
    differ, worst_margin, problems = [], 0.0, []
    for i, (p, g) in enumerate(zip(per, grouped)):
        if p.sentence == g.sentence:
            continue
        rows = {r[0]: r for r in p.nbest}
        a, b = rows.get(p.sentence), rows.get(g.sentence)
        if a is None or b is None:
            problems.append(f"request {i}: grouped chose {g.sentence!r}, not in the "
                            f"per-utterance n-best")
            continue
        margin = a[4] - b[4]
        tol = 2 * dcfg.alpha * (OPT_BF16_TOL["atol"]
                                + OPT_BF16_TOL["rtol"] * max(abs(a[3]), abs(b[3])))
        differ.append({"request": i, "margin": margin, "tol": tol})
        worst_margin = max(worst_margin, margin)
        if margin > tol:
            problems.append(f"request {i}: totals {a[4]} and {b[4]} differ by {margin} > {tol}")
    llm_cols = [r[3] for o in per + grouped for r in o.nbest]
    fig = {"phase": "finalize_opt", "requests": len(feats), "vocab": CONNECTED_VOCAB,
           "decode": {**CONNECTED_DECODE, **FINALIZE_KNOBS},
           "llm": "OPTConfig.opt_6_7b(), bf16, random weights, word_hash_encode",
           "per_utterance": per_fig, "grouped": {"llm_group_candidates": LLM_GROUP,
                                                 **grouped_fig},
           "same_sentence": len(feats) - len(differ) - len(problems), "differ": differ,
           "worst_margin": worst_margin,
           "llm_scores_finite": bool(np.all(np.isfinite(llm_cols))),
           "llm_scored": bool(any(v != 0.0 for v in llm_cols)),
           "clock": "host, from the features to the finals, ending in a sync"}
    n_layers = world["model"].n_layers
    for label, f in (("per_utterance", per_fig), ("grouped", grouped_fig)):
        if f["launches"]["gru_fwd"] != n_layers:
            problems.append(f"{label}: gru_fwd launched {f['launches']['gru_fwd']} times, "
                            f"expected {n_layers}")
    if not (fig["llm_scores_finite"] and fig["llm_scored"]):
        problems.append("the LLM column is not finite or was never filled")
    fig["ok"] = not problems
    fig["problems"] = problems
    emit(fig)
    return fig


def phase_prefix_beam(world):
    """The CTC prefix beam searcher (decode/prefix_beam_device.py) on the
    card over 8 of the connected batch's posteriors (K = 16, first-beam 16),
    held against the numpy oracle on the host: the same n-best prefixes
    (near-tied neighbours may swap), scores within 1e-4."""
    import torch

    from b2txt_tpu_torch.decode import ctc_prefix_beam_search, ctc_prefix_beam_search_device
    from b2txt_tpu_torch.evaluate.harness import _batched_inference_device

    feats, _ = world["first_batch"]
    (lp, lens), = _batched_inference_device(world["model"], feats[:PREFIX_UTTS],
                                            **{**world["infer"], "batch_size": PREFIX_UTTS})[0]
    host = lp.cpu().numpy()
    device_s = oracle_s = 0.0
    same_top1, top_equal, problems, worst = 0, 0, [], 0.0
    runs = []
    for i in range(PREFIX_UTTS):
        n = int(lens[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ctc_prefix_beam_search_device(lp[i, :n], beam_width=PREFIX_K,
                                            first_beam_size=PREFIX_K, nbest=PREFIX_K)
        runs.append(got)
        t1 = time.perf_counter()
        want = ctc_prefix_beam_search(host[i, :n], beam_size=PREFIX_K)
        t2 = time.perf_counter()
        device_s += t1 - t0
        oracle_s += t2 - t1
        same_top1 += got[0][0] == want[0][0]
        scores = {tuple(h): s for h, s in want}
        for k, (h, s) in enumerate(got[:PREFIX_TOP]):
            top_equal += h == want[k][0]
            if tuple(h) not in scores:
                problems.append(f"utterance {i}: rank {k} prefix not in the oracle's n-best")
                continue
            worst = max(worst, abs(s - scores[tuple(h)]))
            if not (np.isclose(s, scores[tuple(h)], **PREFIX_TOL)
                    and (h == want[k][0] or np.isclose(s, want[k][1], **PREFIX_TOL))):
                problems.append(f"utterance {i}: rank {k} score {s} against the oracle's "
                                f"{scores[tuple(h)]} (rank {k}: {want[k][1]})")
    # the same input again: its segment merge sums in one fixed order
    again = [ctc_prefix_beam_search_device(lp[i, : int(lens[i])], beam_width=PREFIX_K,
                                           first_beam_size=PREFIX_K, nbest=PREFIX_K)
             for i in range(PREFIX_UTTS)]
    fig = {"phase": "prefix_beam", "utterances": PREFIX_UTTS, "beam_width": PREFIX_K,
           "first_beam_size": PREFIX_K, "frames": int(lens[0]), "compared_top": PREFIX_TOP,
           "same_top1": same_top1, "same_rank": top_equal,
           "repeat_bit_identical": sum(a == b for a, b in zip(runs, again)),
           "max_abs_score_diff": worst, "tol": PREFIX_TOL,
           "device_s_per_utterance": device_s / PREFIX_UTTS,
           "oracle_s_per_utterance": oracle_s / PREFIX_UTTS,
           "clock": "host; the device search ends in its fetch", "problems": problems}
    fig["ok"] = (same_top1 == fig["repeat_bit_identical"] == PREFIX_UTTS) and not problems
    emit(fig)
    return fig


def phase_examples(opt_params, counters):
    """The port's examples (``b2txt_tpu_torch.examples``) through their
    functions, at full width (``TrainConfig()``'s model) where they run a
    model: (a) streaming: ``STREAM_WARMUP + STREAM_HOPS`` hops of the
    carried-state forward in f32 and bf16 against the offline forward, each
    hop ending in the host's read of its frame, and one hop profiled; then
    Part B through the python and the device searchers; (b) the quickstart:
    ``QUICKSTART_STEPS`` training steps on synthetic sessions held in memory
    at 512 features, the val split decoded with the python searcher, the
    CSV; (c) the conversation demo's picks, and its context scoring on
    OPT-6.7b's random bf16 weights (prefix-KV against concatenated); (d) the
    lattice and spelling demos at their defaults (host-only); (e) the
    figures demo's data half, ``FIGURES_STEPS`` steps. Launches are counted
    from 0 in each part that runs a model."""
    import csv
    import tempfile

    import torch

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig
    from b2txt_tpu_torch.examples import (conversation_demo, figures_demo, lattice_demo,
                                          quickstart, spelling_demo, streaming_demo)
    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
    from b2txt_tpu_torch.utils.config import TrainConfig

    problems = []
    t_phase = time.perf_counter()
    cfg = TrainConfig()
    fig = {"phase": "examples", "model": "TrainConfig().model: 512 features, 5x768 GRU, "
           "patch 14/4"}

    # (a) streaming, full width, GRUDecoder's own init
    model = GRUDecoder(cfg.model, 45, 41, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    hops = STREAM_WARMUP + STREAM_HOPS
    stream = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        zero(counters)
        s = streaming_demo.stream_gru(model, dtype, hops=hops, device="cuda", verbose=False)
        launches = counted_launches(counters)
        timed = np.asarray(s["hop_ms"][STREAM_WARMUP:])
        stream[name] = {"hops": len(s["hop_ms"]), "timed_hops": len(timed),
                        "max_abs_err": s["max_abs_err"],
                        "median_hop_ms": float(np.median(timed)),
                        "p90_hop_ms": float(np.percentile(timed, 90)),
                        "mean_hop_ms": float(timed.mean()),
                        "gru_fwd_launches": launches["gru_fwd"],
                        # the offline forward adds one launch per layer
                        "gru_fwd_per_hop": (launches["gru_fwd"] - cfg.model.n_layers) / hops,
                        "finite": bool(np.isfinite(s["streamed"]).all()),
                        "offline": s["offline"]}
    policy = float(np.abs(stream["bfloat16"]["offline"] - stream["float32"]["offline"]).max())
    stream["bfloat16"]["tol"] = STREAM_BF16_FACTOR * policy
    stream["bfloat16"]["bf16_policy_err"] = policy
    stream["float32"]["tol"] = streaming_demo.STREAM_TOL_F32
    for name, st in stream.items():
        st.pop("offline")
        if not (st["finite"] and st["max_abs_err"] <= st["tol"]):
            problems.append(f"streaming {name}: max |streaming - offline| {st['max_abs_err']} "
                            f"> {st['tol']}")
        if st["gru_fwd_per_hop"] != cfg.model.n_layers:
            problems.append(f"streaming {name}: {st['gru_fwd_per_hop']} K1 launches a hop")
    # hops of each dtype under the profiler: bf16 adds the per-call casts of
    # the weights to bf16 (GRUDecoder.forward casts on every call)
    day = torch.tensor([1], device="cuda")
    window = torch.randn((cfg.model.patch_size, cfg.model.n_input_features), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        hop = streaming_demo.make_hop(model, day, dtype)
        h = streaming_demo.initial_state(model, dtype)
        hop(h, window)
        prof = profile_call(lambda: [hop(h, window)[0].cpu() for _ in range(PROFILED_HOPS)],
                            top=16, settle_s=PROFILE_SETTLE_S)
        calls = {r["name"]: r["calls"] for r in prof["top"]}
        prof.update({
            "hops": PROFILED_HOPS,
            "launches_per_hop": prof["kernel_launches"] / PROFILED_HOPS,
            "device_ms_per_hop": prof["device_ms"] / PROFILED_HOPS,
            # the trace is whole when it holds every K1 launch the wrapper counted
            "gru_fwd_per_hop_in_trace": sum(n for k, n in calls.items() if "gru_fwd_kernel" in k)
            / PROFILED_HOPS,
            "bf16_cast_launches_per_hop": sum(n for k, n in calls.items()
                                              if "bfloat16_copy" in k) / PROFILED_HOPS})
        stream[str(dtype).replace("torch.", "")]["hop_profile"] = prof
    stream["clock"] = "host, per hop, ending in the host's read of the frame"
    partb = {}
    for backend in ("python", "device"):
        t0 = time.perf_counter()
        partb[backend] = streaming_demo.stream_decode(backend=backend, device="cuda",
                                                      verbose=False)
        partb[backend]["s"] = time.perf_counter() - t0
    py, dev = partb["python"], partb["device"]
    same_partials = py["partials"] == dev["partials"]
    same_final = (py["final"].sentence == dev["final"].sentence == py["sentence"]
                  and [r[0] for r in py["final"].nbest] == [r[0] for r in dev["final"].nbest]
                  and np.allclose([r[1:] for r in py["final"].nbest],
                                  [r[1:] for r in dev["final"].nbest],
                                  rtol=SEARCH_TOL, atol=SEARCH_TOL))
    stream["part_b"] = {"chunks": len(py["partials"]), "partials": dev["partials"],
                        "final": dev["final"].sentence, "same_partials": same_partials,
                        "same_final": same_final, "s": {k: v["s"] for k, v in partb.items()}}
    if not (same_partials and same_final):
        problems.append(f"streaming part B: python and device searchers differ: "
                        f"{py['partials']} / {dev['partials']}")
    fig["streaming"] = stream
    del model

    # (b) the quickstart at full width, sessions in memory (no h5py on the host)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quickstart_") as root:
        qcfg = quickstart.make_config(root, QUICKSTART_STEPS, model=TrainConfig().model)
        qcfg.save_best_checkpoint = qcfg.save_val_metrics = False   # args.yaml needs PyYAML
        train_trials, val_trials, columns = quickstart.memory_data(neural_dim=512)
        zero(counters)
        t0 = time.perf_counter()
        trainer, stats = quickstart.train(qcfg, "cuda", train_trials, val_trials)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = counted_launches(counters)
        zero(counters)
        t0 = time.perf_counter()
        out = quickstart.decode_and_score(trainer.model, qcfg, root,
                                          quickstart.build_decoder(root), session_data=columns)
        decode_s = time.perf_counter() - t0
        decode_launches = counted_launches(counters)
        with open(out["csv_path"]) as f:
            rows = list(csv.reader(f))
    fig["quickstart"] = {
        "steps": QUICKSTART_STEPS, "reduced": {"num_training_batches": [300, QUICKSTART_STEPS]},
        "demo_knobs": DEMO_KNOBS,
        "no_checkpoint": "save_best_checkpoint, save_val_metrics off: no PyYAML on the host",
        "neural_dim": 512, "batch_size": qcfg.dataset.batch_size, "dtype": "float32",
        "train_s": train_s, "losses": [stats["train_losses"][0], stats["train_losses"][-1]],
        "val_PERs": stats["val_PERs"], "train_launches": train_launches,
        "n_trials": out["n_trials"], "greedy_PER": out["greedy_PER"], "WER": out["WER"],
        "decode_s": decode_s, "decode_launches": decode_launches,
        "csv_rows": len(rows) - 1, "csv_header": rows[0]}
    q = fig["quickstart"]
    if not (q["csv_rows"] == q["n_trials"] > 0 and rows[0] == ["id", "text"]):
        problems.append(f"quickstart: {q['csv_rows']} CSV rows for {q['n_trials']} trials")
    if not (train_launches["gru_fwd"] > 0 and train_launches["gru_bwd"]
            == QUICKSTART_STEPS * cfg.model.n_layers and decode_launches["gru_fwd"] > 0):
        problems.append(f"quickstart launches: {train_launches}, {decode_launches}")
    if not all(np.isfinite([out["greedy_PER"], out["WER"]] + q["losses"])):
        problems.append(f"quickstart: not finite: {q}")
    del trainer

    # (c) the conversation demo: the picks, then context scoring at 6.7b
    picks = conversation_demo.homophone_picks()
    ocfg = OPTConfig.opt_6_7b()
    t0 = time.perf_counter()
    scores = conversation_demo.context_scoring(ocfg, opt_params, "cuda", torch.bfloat16)
    conv_s = time.perf_counter() - t0
    fig["conversation"] = {
        "picks": picks, "opt": "OPTConfig.opt_6_7b(), bf16, random weights (the OPT phases')",
        "prefix_kv": scores["prefix_kv"].tolist(), "concatenated": scores["concatenated"].tolist(),
        "max_abs": max_abs(scores["prefix_kv"], scores["concatenated"]),
        "tol": OPT_PREFIX_TOL, "prefix_runs": scores["prefix_runs"], "s": conv_s}
    if picks != {"look at the sky": "the sun is bright here",
                 "he hugged his family": "the son is bright here"}:
        problems.append(f"conversation picks: {picks}")
    if not (scores["prefix_runs"] == 1 and np.isfinite(scores["prefix_kv"]).all()
            and np.allclose(scores["prefix_kv"], scores["concatenated"], **OPT_PREFIX_TOL)):
        problems.append(f"conversation context scoring: {fig['conversation']}")

    # (d) host-only demos at their defaults
    t0 = time.perf_counter()
    lat = lattice_demo.main(verbose=False)
    spell = spelling_demo.main(verbose=False)
    fig["lattice_demo"], fig["spelling_demo"] = lat, spell
    fig["host_demos_s"] = time.perf_counter() - t0
    if lat != LATTICE_DEMO_RESULT or spell != SPELLING_DEMO_RESULT:
        problems.append(f"lattice / spelling demos: {lat} / {spell}, the CPU gives "
                        f"{LATTICE_DEMO_RESULT} / {SPELLING_DEMO_RESULT}")

    # (e) the figures demo's data half on the card
    zero(counters)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_figures_") as out_dir:
        data = figures_demo.figure_data(out_dir, device="cuda", n_batches=FIGURES_STEPS,
                                        model=TrainConfig().model, in_memory=True,
                                        verbose=False)
    fig["figures"] = {
        "steps": FIGURES_STEPS, "reduced": {"num_training_batches": [120, FIGURES_STEPS]},
        "demo_knobs": DEMO_KNOBS,
        "s": time.perf_counter() - t0, "launches": counted_launches(counters),
        "trials": len(data["res"]["trials"]), "WER": data["res"]["WER"],
        "wpm": data["wpm"], "fig2_conditions": sorted(data["fig2"]),
        "raster_shape": list(data["raster"]["probs"].shape),
        "render": "the plot_* half is tested on the CPU (no matplotlib on the host)"}
    if fig["figures"]["launches"]["gru_fwd"] == 0 or fig["figures"]["trials"] != 48:
        problems.append(f"figures data half: {fig['figures']}")
    fig["launches_total"] = {
        "gru_fwd": (stream["float32"]["gru_fwd_launches"]
                    + stream["bfloat16"]["gru_fwd_launches"]
                    + train_launches["gru_fwd"] + decode_launches["gru_fwd"]
                    + fig["figures"]["launches"]["gru_fwd"]),
        "gru_bwd": train_launches["gru_bwd"] + fig["figures"]["launches"]["gru_bwd"]}
    fig["s"] = time.perf_counter() - t_phase
    fig["ok"], fig["problems"] = not problems, problems
    emit(fig)
    return fig


def phase_quality_ladder(world, counters):
    """``b2txt_tpu_torch.scripts.quality_ladder.run_ladder`` on the connected
    world: planted stage 1 (K1) at head gains ``LADDER_GAINS``, 128
    utterances of 520 bins in batches of 64; the native searcher and the
    device searcher of the connected phase on identical posteriors at every
    gain; the native lattice n-best (``state_key="ngram"``, width 512) on two
    gains over the first 32 utterances. At gain 45 both must be exact on all
    128 with equal WER; below it, agreement is reported, and for a gain
    where the top-1s differ, the first such utterance with both n-bests'
    scores of both answers."""
    import tempfile

    import torch

    from b2txt_tpu_torch.runtime import NativeLexiconBeamSearch
    from b2txt_tpu_torch.scripts.quality_ladder import backend_row, run_ladder
    from b2txt_tpu_torch.scripts.world import make_planted_utts

    dcfg = world["decode"]
    t0 = time.perf_counter()
    utts = make_planted_utts(world["lexicon"], world["words"], np.random.default_rng(SEED + 9),
                             LADDER_UTTS, BINS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ladder_") as tmp:
        files = write_world(tmp, world["lexicon"], world["lm"], world["lm_unpruned"])
        lat_cfg = dcfg.replace(beam_width=LADDER_LATTICE_WIDTH, lattice_beam=12.0,
                               lattice_nbest=True)
        lattice = NativeLexiconBeamSearch(files["arpa"], files["lexicon"], lat_cfg,
                                          max_homophones=4, rescore_arpa=files["unpruned"],
                                          state_key="ngram")
    setup_s = time.perf_counter() - t0
    launches = []

    def emit_row(row):
        launches.append(counted_launches(counters))
        zero(counters)
        emit({"phase": "quality_ladder", **row})

    zero(counters)
    t0 = time.perf_counter()
    ladder = run_ladder(dcfg, utts, LADDER_GAINS, LADDER_BLANK_BIAS, LADDER_BATCH, BINS,
                        world["native_service"].searcher, world["searcher"], device="cuda",
                        emit=emit_row)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sents = [s for s, _ in utts]
    # the lattice n-best, cut to two gains over the first utterances (its host
    # time), on the posteriors the ladder decoded
    lattice_s = 0.0
    for row in ladder:
        if row["gain"] not in LADDER_LATTICE_GAINS:
            continue
        lat_results = []
        t0 = time.perf_counter()
        for lp in row["posteriors"][:LADDER_LATTICE_UTTS]:
            lattice.reset()
            lattice.decode(lp)
            lat_results.append(lattice.finish_decoding())
        lat_s = time.perf_counter() - t0
        lattice_s += lat_s
        head = sents[:LADDER_LATTICE_UTTS]
        # the native searcher's quality on the same utterances (its speed is the row's)
        native_head = backend_row(dcfg, head, row["results"]["native"][:LADDER_LATTICE_UTTS],
                                  lat_s)
        del native_head["sentences_per_s"]
        emit({"phase": "quality_ladder_lattice", "gain": row["gain"],
              "utts": LADDER_LATTICE_UTTS, "width": LADDER_LATTICE_WIDTH,
              "lattice": backend_row(dcfg, head, lat_results, lat_s),
              "native_same_utts": native_head})
    problems, differs = [], {}
    for row, n in zip(ladder, launches):
        res = row["results"]
        for i, (nat, dev) in enumerate(zip(res["native"], res["device"])):
            top_n = nat[0].sentence if nat else ""
            top_d = dev[0].sentence if dev else ""
            if top_n == top_d:
                continue

            def scored(results, sentence):
                hit = [r for r in results if r.sentence == sentence]
                return ([hit[0].ac_score, hit[0].lm_score,
                         dcfg.acoustic_scale * hit[0].ac_score + hit[0].lm_score]
                        if hit else None)

            differs[str(row["gain"])] = {
                "utterance": i, "truth": sents[i], "native_top1": top_n, "device_top1": top_d,
                "score_is": "[ac, lm, acoustic_scale * ac + lm]",
                "native_nbest": {"native_top1": scored(nat, top_n),
                                 "device_top1": scored(nat, top_d)},
                "device_nbest": {"native_top1": scored(dev, top_n),
                                 "device_top1": scored(dev, top_d)}}
            break
        if n["gru_fwd"] != (LADDER_UTTS // LADDER_BATCH) * 5:
            problems.append(f"gain {row['gain']}: K1 launched {n['gru_fwd']} times")
    top = ladder[-1]
    if not (top["gain"] == 45.0 and top["native"]["exact"] == top["device"]["exact"]
            == f"{LADDER_UTTS}/{LADDER_UTTS}" and top["native"]["wer"] == top["device"]["wer"]):
        problems.append(f"gain 45: native {top['native']}, device {top['device']}")
    fig = {"phase": "quality_ladder_summary", "vocab": CONNECTED_VOCAB,
           "decode": CONNECTED_DECODE, "gains": list(LADDER_GAINS),
           "blank_bias": LADDER_BLANK_BIAS, "utts": LADDER_UTTS, "bins": BINS,
           "device_batch": LADDER_BATCH,
           "lattice": {"width": LADDER_LATTICE_WIDTH, "gains": list(LADDER_LATTICE_GAINS),
                       "utts": LADDER_LATTICE_UTTS,
                       "reduced": {"gains": [len(LADDER_GAINS), len(LADDER_LATTICE_GAINS)],
                                   "utts": [LADDER_UTTS, LADDER_LATTICE_UTTS]}},
           "top1_agreement": {str(r["gain"]): r["top1_agreement"] for r in ladder},
           "native_wer": {str(r["gain"]): r["native"]["wer"] for r in ladder},
           "device_wer": {str(r["gain"]): r["device"]["wer"] for r in ladder},
           "first_differing": differs, "launches_per_gain": launches,
           "setup_s": setup_s, "s": wall, "lattice_s": lattice_s, "host_cpu": host_cpu()}
    fig["ok"], fig["problems"] = not problems, problems
    emit(fig)
    return fig


# ----------------------------------------------------------------- sharded paths
def join_nccl_group():
    """A 1-rank NCCL group in this process (a file:// rendezvous in a fresh
    directory) and its ("data", "model") mesh of (1, 1). Prints the torch
    and NCCL versions."""
    import tempfile

    import torch

    from b2txt_tpu_torch.parallel import make_mesh
    from b2txt_tpu_torch.parallel.launch import init_group

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    init_group("nccl", 1, 0, f"file://{rendezvous}/rendezvous", PARALLEL_TIMEOUT_S)
    mesh = make_mesh(1, model_parallel=1)
    # what one collective costs the host: 4-byte all-reduces back to back
    # against as many one-element adds (a kernel launch each)
    x = torch.ones(1, device="cuda")
    costs = {}
    for name, op in (("all_reduce", lambda: torch.distributed.all_reduce(
            x, group=mesh.get_group("data"))), ("add_", lambda: x.add_(0))):
        for _ in range(20):
            op()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_PROBE_CALLS):
            op()
        torch.cuda.synchronize()
        costs[name] = (time.perf_counter() - t0) * 1e3 / COLLECTIVE_PROBE_CALLS
    # ... and behind a busy card: does the call return before the card
    # reaches it, as an enqueue does?
    behind = {}
    for name, op in (("all_reduce", lambda: torch.distributed.all_reduce(
            x, group=mesh.get_group("data"))), ("add_", lambda: x.add_(0))):
        torch.cuda.synchronize()
        torch.cuda._sleep(BUSY_CYCLES)
        t0 = time.perf_counter()
        op()
        behind[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(BUSY_CYCLES)
    torch.cuda.synchronize()
    emit({"phase": "nccl_group", "torch": torch.__version__,
          "nccl": ".".join(map(str, torch.cuda.nccl.version())), "world_size": 1,
          "rendezvous": "file://", "host_ms_per_call": costs,
          "calls": COLLECTIVE_PROBE_CALLS, "clock": "host, back to back, ending in a sync",
          "host_ms_behind_busy_card": behind,
          "busy_ms": (time.perf_counter() - t0) * 1e3})
    return mesh


def collective_counts(run):
    """One call under torch.profiler: the host-side collective records
    (keys naming nccl or c10d) and the device rows naming nccl, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    host, device = {}, {}
    for e in prof.key_averages():
        key = e.key.lower()
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        if "nccl" in key or (not on_device and key.startswith("c10d::")):
            (device if on_device else host)[e.key[:60]] = e.count
    return host, device


def phase_sharded_decode(world, mesh):
    """The connected world's 512 posteriors in batches of 128 through
    ``sharded_decode_batch`` on the 1-rank mesh, beside ``decode_batch``:
    every n-best equal bit for bit, 512/512 exact, the rank's table block
    the unsharded table's bytes; the collectives of one batch by profile."""
    searcher = world["searcher"]
    host_lp, sents = world["posteriors"]
    batches = []
    for lo in range(0, len(host_lp), CONNECTED_BATCH):
        chunk = host_lp[lo:lo + CONNECTED_BATCH]
        arr = np.zeros((len(chunk), max(a.shape[0] for a in chunk), 41), np.float32)
        for i, a in enumerate(chunk):
            arr[i, : a.shape[0]] = a
        batches.append((arr, np.asarray([a.shape[0] for a in chunk], np.int32)))

    def run(fn):
        t0 = time.perf_counter()
        outs = [r for arr, lens in batches for r in fn(arr, lens)]
        return outs, time.perf_counter() - t0

    def sharded(arr, lens):
        return searcher.sharded_decode_batch(arr, lens, mesh=mesh, axis="data")

    sharded(*batches[0])   # warm-up: NCCL's communicators
    got, sharded_s = run(sharded)
    ref, single_s = run(searcher.decode_batch)
    nbest = lambda rs: [[(x.sentence, x.ac_score, x.lm_score) for x in r] for r in rs]  # noqa: E731
    equal = sum(a == b for a, b in zip(nbest(got), nbest(ref)))
    exact = sum(bool(r) and r[0].sentence == s for r, s in zip(got, sents))
    # collectives a frame: the first batch cut to 1 and to 3 frames under the
    # profiler (a whole batch is ~77,000 launches, minutes of trace
    # processing); the same finalize and pool gathers in both
    cut = {}
    for k in (1, 3):
        lens_k = np.minimum(batches[0][1], k)
        lp, lengths, _ = searcher._prep_batch(batches[0][0], lens_k)
        cut[k] = (min(lp.shape[1], int(lengths.max())),
                  *collective_counts(lambda: sharded(batches[0][0], lens_k)))
    (f1, host1, dev1), (f3, host3, dev3) = cut[1], cut[3]
    per_frame = {"host": {k: (host3[k] - host1.get(k, 0)) / (f3 - f1) for k in host3},
                 "device": {k: (dev3[k] - dev1.get(k, 0)) / (f3 - f1) for k in dev3}}
    block, full = searcher.sharded_lm.table[0], searcher.dev_lm.table[0]
    fig = {"phase": "sharded_decode", "world_size": 1, "backend": "nccl",
           "requests": len(sents), "batch": CONNECTED_BATCH, "vocab": CONNECTED_VOCAB,
           "exact": exact, "nbest_equal_to_decode_batch": equal,
           "table_bytes_rank": block.numel() * block.element_size(),
           "table_bytes_unsharded": full.numel() * full.element_size(),
           "sentences_per_s_sharded": len(sents) / sharded_s,
           "sentences_per_s_decode_batch": len(sents) / single_s,
           "clock": "host, around the 4 batches (each ends in its n-best on the host)",
           "profiled_frames": [f1, f3], "collectives_host_records": [host1, host3],
           "collective_device_rows": [dev1, dev3], "collectives_per_frame": per_frame,
           "collectives_expected_per_frame": 2,
           "collectives_expected_per_frame_is": "one probe a frame (the gram and "
           "context-backoff keys together): an all-gather of keys and a reduce-scatter "
           "of rows; the finalize adds 3 probes and the pool 2 all-gathers"}
    fig["ok"] = (exact == len(sents) and equal == len(sents)
                 and fig["table_bytes_rank"] == fig["table_bytes_unsharded"])
    emit(fig)
    return fig


def bias_order_probe(params, n_ctx: int):
    """Why a mesh of one once differed from the unsharded rescorer: fc2 of
    layer 0 in bf16 at the context forward's rows (1, n_ctx, 16384) and at
    a packed batch's (13, 64, 16384), with its bias in the product (the
    unsharded ``_linear``) against the bias added after a bias-free product
    (``_row_parallel`` before the repair). The bias is 0, so any difference
    is the two cuBLAS kernels' rounding."""
    import torch
    import torch.nn.functional as F

    w = params["model.decoder.layers.0.fc2.weight"]
    b = params["model.decoder.layers.0.fc2.bias"]
    gen = torch.Generator(device="cuda").manual_seed(OPT_SEED + 2)
    out = {}
    for rows in ((1, n_ctx), (13, 64)):
        h = torch.randn(rows + (w.shape[1],), generator=gen, device="cuda").to(w.dtype)
        with torch.inference_mode():
            out[f"{rows[0]}x{rows[1]}"] = float((F.linear(h, w, b) - (F.linear(h, w) + b))
                                                .abs().max())
    return out


def phase_opt_tp(params, mesh):
    """OPTRescorer(mesh=(1, 1)) on the OPT phases' 6.7b weights against the
    unsharded rescorer: 8 lists of 100 candidates packed, and with the
    48-word context (prefix-KV). A group of one must give the unsharded
    scores bit for bit; the unsharded prefix-KV scores must repeat bit for
    bit; ``bias_order_probe`` shows the rounding the repair removed."""
    import torch

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer, word_hash_encode

    cfg = OPTConfig.opt_6_7b()
    enc = word_hash_encode(cfg.vocab_size)
    cont = lambda t, n: enc(t, n + 1)[1:]  # noqa: E731
    lists, context = opt_texts()
    figs = {}
    for name, m in (("unsharded", None), ("mesh", mesh)):
        kw = dict(params=params, encode=enc, device="cuda", compute_dtype=torch.bfloat16,
                  mesh=m)
        packed_s, packed = timed_lists(OPTRescorer(cfg, max_len=OPT_MAX_LEN, **kw), lists)
        prefix = OPTRescorer(cfg, max_len=512, encode_cont=cont, **kw)
        prefix_s, ctx = timed_lists(prefix, lists, context=context)
        resc = OPTRescorer(cfg, max_len=OPT_MAX_LEN, **kw)
        figs[name] = {"packed": packed, "context": ctx, "s_per_list_packed": packed_s,
                      "s_per_list_prefix_kv": prefix_s, "prefix_runs": prefix.prefix_runs,
                      "context_again": [prefix.score(c, context=context) for c in lists],
                      "profile": profile_call(lambda: resc.score(lists[0]))}
    a, b = figs["mesh"], figs["unsharded"]
    fig = {"phase": "opt_tp", "config": "OPTConfig.opt_6_7b(), bf16, mesh (1, 1)",
           "lists": OPT_LISTS, "nbest": OPT_NBEST, "context_words": OPT_CONTEXT_WORDS,
           "packed_max_abs": max_abs(a["packed"], b["packed"]), "tol": OPT_BF16_TOL,
           "context_max_abs": max_abs(a["context"], b["context"]), "prefix_tol": OPT_PREFIX_TOL,
           "context_repeat_max_abs": {name: max_abs(figs[name]["context"],
                                                    figs[name]["context_again"])
                                      for name in figs},
           "bias_in_product_vs_after_max_abs": bias_order_probe(
               params, len(enc(context, 512))),
           **{f"{k}_{name}": figs[name][k] for name in figs
              for k in ("s_per_list_packed", "s_per_list_prefix_kv")},
           "profile_one_list": {name: figs[name]["profile"] for name in figs},
           "all_finite": bool(np.isfinite(a["packed"]).all() and np.isfinite(a["context"]).all())}
    fig["ok"] = bool(fig["all_finite"] and a["prefix_runs"] > 0
                     and fig["packed_max_abs"] == 0.0 and fig["context_max_abs"] == 0.0
                     and np.allclose(a["packed"], b["packed"], **OPT_BF16_TOL)
                     and np.allclose(a["context"], b["context"], **OPT_PREFIX_TOL))
    emit(fig)
    return fig


def phase_parallel_forward(mesh, counters):
    """build_sharded_forward at full width in bf16 (GRUDecoder's own init),
    B = 128 requests of 520 bins, on the 1-rank mesh: the logits equal the
    module's forward bit for bit, the greedy ids too, K1 5 launches."""
    import torch

    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
    from b2txt_tpu_torch.ops.ctc import greedy_decode_ids
    from b2txt_tpu_torch.parallel import build_sharded_forward

    cfg, _ = train_config()
    model = GRUDecoder(cfg.model, 45, 41, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randn((PARALLEL_FORWARD_B, BINS, cfg.model.n_input_features), generator=gen,
                    device="cuda")
    day = torch.randint(0, 45, (PARALLEL_FORWARD_B,), generator=gen, device="cuda")
    fwd, place = build_sharded_forward(cfg, model.state_dict(), mesh, device="cuda")
    local = place(model.state_dict())
    fwd(local, x, day)   # warm-up
    torch.cuda.synchronize()
    zero(counters)
    t0 = time.perf_counter()
    logits, ids = fwd(local, x, day)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3
    launches = counted_launches(counters)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = model(x, day, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        module_ms = (time.perf_counter() - t0) * 1e3
        ref_ids = greedy_decode_ids(ref.float(), torch.full((ref.shape[0],), ref.shape[1],
                                                             device="cuda"))
    fig = {"phase": "parallel_forward", "mesh": [1, 1], "backend": "nccl",
           "B": PARALLEL_FORWARD_B, "bins": BINS, "dtype": "bfloat16",
           "logits_shape": list(logits.shape),
           "logits_bit_equal": bool(torch.equal(logits, ref)),
           "logits_max_abs": float((logits.float() - ref.float()).abs().max()),
           "ids_equal": bool(torch.equal(ids, ref_ids)),
           "finite": bool(torch.isfinite(logits).all()), "launches": launches,
           "sharded_ms": sharded_ms, "module_ms": module_ms,
           "clock": "host, one call each, after a warm-up, ending in a sync"}
    fig["ok"] = (fig["logits_bit_equal"] and fig["ids_equal"] and fig["finite"]
                 and launches["gru_fwd"] == cfg.model.n_layers)
    emit(fig)
    return fig


def phase_parallel_train(mesh, counters):
    """TrainConfig() at full width (bf16), noise and dropout off: 5 steps of
    Trainer(mesh=(1, 1)) beside 5 of the unsharded Trainer from the same
    weights and batches; loss, grad_norm and the parameters within 1e-6
    relative; K1 and K2 counted on the sharded steps."""
    import torch

    from b2txt_tpu_torch.data.loader import batch_to_device
    from b2txt_tpu_torch.data.synthetic import synthetic_trials
    from b2txt_tpu_torch.parallel import gather_params
    from b2txt_tpu_torch.train import Trainer

    cfg, reduced = train_config()
    dt = cfg.dataset.data_transforms
    dt.white_noise_std = dt.constant_offset_std = 0.0
    cfg.model.rnn_dropout = cfg.model.input_network.input_layer_dropout = 0.0
    cfg.use_fused_preprocess = False
    seed = TRAIN_SEED + 997 - hash("train") % 997   # see phase_train's draw()
    trials = synthetic_trials(cfg.dataset.sessions, trials_per_session=TRIALS_PER_SESSION,
                              neural_dim=cfg.dataset.neural_dim, seed=seed, split="train",
                              min_words=9, max_words=13, frames_per_phoneme=8, max_bins=512)
    runs = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        trainer = Trainer(cfg, device="cuda", train_trials=trials, mesh=m)
        batches = [batch_to_device(trainer.train_loader.get_batch(i), "cuda")
                   for i in range(PARALLEL_TRAIN_STEPS)]
        torch.cuda.synchronize()
        zero(counters)
        losses, norms, step_ms = [], [], []
        for batch in batches:
            t0 = time.perf_counter()
            loss, norm = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            norms.append(float(norm))
        launches = counted_launches(counters)
        params = (gather_params(trainer.sharded.params, mesh) if m is not None
                  else trainer.model.state_dict())
        runs[name] = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
                      "launches": launches,
                      "params": {k: v.detach().float().clone() for k, v in params.items()},
                      # one more step, after the compared ones
                      "profile": profile_call(lambda: trainer.train_step(batches[-1]), top=16)}
        del trainer
    a, b = runs["sharded"], runs["unsharded"]
    rel = lambda x, y: float(np.max(np.abs(np.subtract(x, y)) / np.abs(y)))  # noqa: E731
    param_rel = max(float((a["params"][k] - b["params"][k]).abs().max()
                          / b["params"][k].abs().max().clamp(min=1e-30)) for k in b["params"])
    fig = {"phase": "parallel_train", "mesh": [1, 1], "backend": "nccl",
           "config": "TrainConfig() defaults, white noise, offset and dropout off, "
                     "transform_data (no K3)", "reduced": reduced,
           "steps": PARALLEL_TRAIN_STEPS, "use_amp": cfg.use_amp,
           "batch_size": cfg.dataset.batch_size,
           "loss_rel": rel(a["losses"], b["losses"]),
           "grad_norm_rel": rel(a["grad_norms"], b["grad_norms"]), "param_rel": param_rel,
           "tol_rel": PARALLEL_TRAIN_TOL, "losses": a["losses"],
           "step_ms_sharded": a["step_ms"], "step_ms_unsharded": b["step_ms"],
           "ms_per_step_sharded": float(np.mean(a["step_ms"][1:])),
           "ms_per_step_unsharded": float(np.mean(b["step_ms"][1:])),
           "ms_per_step_over": f"steps 1..{PARALLEL_TRAIN_STEPS - 1}",
           "launches_sharded": a["launches"], "launches_unsharded": b["launches"],
           "profile_one_step": {"sharded": a["profile"], "unsharded": b["profile"]},
           "clock": "host, per step, ending in a sync"}
    fig["ok"] = (max(fig["loss_rel"], fig["grad_norm_rel"], param_rel) <= PARALLEL_TRAIN_TOL
                 and all(np.isfinite(a["losses"]))
                 and a["launches"]["gru_fwd"] == PARALLEL_TRAIN_STEPS * cfg.model.n_layers
                 and a["launches"]["gru_bwd"] == PARALLEL_TRAIN_STEPS * cfg.model.n_layers)
    emit(fig)
    return fig


TWO_RANK_LEX = {
    "the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
    "mat": ["M", "AE", "T"], "on": ["AA", "N"], "dog": ["D", "AO", "G"],
    "a": ["AH"], "and": ["AE", "N", "D"], "saw": ["S", "AO"],
    "their": ["DH", "EH", "R"], "there": ["DH", "EH", "R"],
    "rug": ["R", "AH", "G"], "is": ["IH", "Z"],
}
TWO_RANK_CORPUS = [
    "the cat sat on the mat".split(), "the dog sat on the rug".split(),
    "a cat and a dog is there".split(), "the cat saw their dog".split(),
    "there is a dog on the mat".split(),
] * 3


def two_rank_body(sd, batch, arr, lens):
    """One of two ranks on cuda:0 over gloo: the tiny sharded step at model
    = 2, and the 13-word world's sharded decode at D = 2."""
    import torch

    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.lm import Lexicon, train_ngram
    from b2txt_tpu_torch.parallel import (build_sharded_train_step, gather_params,
                                          make_mesh)
    from b2txt_tpu_torch.train.optimizer import make_optimizer
    from b2txt_tpu_torch.utils.config import DecodeConfig

    cfg = two_rank_cfg()
    mesh = make_mesh(2, model_parallel=2)
    step, place_params, place_batch = build_sharded_train_step(cfg, sd, make_optimizer, mesh,
                                                               device="cuda:0")
    state = place_params(sd)
    figs = [step(state, place_batch(batch)) for _ in range(2)]
    full = gather_params(state.params, mesh)
    out = {"loss": [float(f[0]) for f in figs], "grad_norm": [float(f[1]) for f in figs],
           "w_hh": [full[f"gru.weight_hh_l{k}"].cpu().numpy() for k in range(2)]}
    mesh = make_mesh(2, model_parallel=1)
    dev = DeviceLexiconBeamSearch(
        Lexicon.from_words(TWO_RANK_LEX), train_ngram(TWO_RANK_CORPUS, order=3),
        DecodeConfig(acoustic_scale=0.325, blank_penalty=9.0, nbest=10, beam_width=48,
                     first_beam_size=8, sum_mode=False), device="cuda:0")
    got = dev.sharded_decode_batch(arr, lens, mesh=mesh, axis="data")
    out["decode"] = [[(x.sentence, x.ac_score, x.lm_score) for x in r] for r in got]
    out["decode_single"] = [[(x.sentence, x.ac_score, x.lm_score) for x in r]
                            for r in dev.decode_batch(arr, lens)]
    torch.cuda.synchronize()
    return out


def two_rank_cfg():
    """tests/test_torch_parallel.py's quiet tiny config."""
    from b2txt_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.n_input_features, cfg.model.n_units, cfg.model.n_layers = 16, 32, 2
    cfg.model.rnn_dropout = cfg.model.input_network.input_layer_dropout = 0.0
    dt = cfg.dataset.data_transforms
    dt.random_cut, dt.white_noise_std, dt.constant_offset_std = 0, 0.0, 0.0
    cfg.epsilon = 1e-8
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 0
    return cfg


def phase_parallel_two_ranks():
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU), at the CPU tests' tiny width: the sharded step at model = 2 against
    the unsharded Trainer step, and the 13-word world's sharded decode at
    D = 2 against decode_batch, with the CPU tests' gates."""
    import tempfile

    import torch

    from b2txt_tpu_torch.data.synthetic import ctc_logprobs, synthetic_trials
    from b2txt_tpu_torch.lm import Lexicon
    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
    from b2txt_tpu_torch.parallel import spawn
    from b2txt_tpu_torch.train import Trainer

    cfg = two_rank_cfg()
    sd = {k: v.cpu() for k, v in GRUDecoder(cfg.model, 3, 41, device="cpu").state_dict().items()}
    rng = np.random.default_rng(0)
    batch = {"input_features": torch.from_numpy(rng.standard_normal((8, 64, 16), np.float32)),
             "seq_class_ids": torch.from_numpy(rng.integers(1, 41, (8, 12), dtype=np.int32)),
             "n_time_steps": torch.full((8,), 64, dtype=torch.int32),
             "phone_seq_lens": torch.from_numpy(rng.integers(4, 13, (8,), dtype=np.int32)),
             "day_indicies": torch.from_numpy(rng.integers(0, 3, (8,), dtype=np.int32))}
    lexicon = Lexicon.from_words(TWO_RANK_LEX)
    sents = ["the cat sat on the mat", "there is a dog on the mat", "the cat saw their dog",
             "a cat and a dog is there", "the dog sat on the rug", "the cat sat on the rug",
             "there is a dog", "a dog saw the cat"]
    lrng = np.random.default_rng(3)
    utts = [ctc_logprobs(lrng, lexicon.sentence_to_phonemes(s), hot=10.0, noise=0.3)
            for s in sents]
    arr = np.full((len(utts), max(u.shape[0] for u in utts), 41), -20.0, np.float32)
    lens = np.asarray([u.shape[0] for u in utts], np.int32)
    for i, u in enumerate(utts):
        arr[i, : u.shape[0]] = u
    t0 = time.perf_counter()
    ranks = spawn(two_rank_body, 2, args=(sd, batch, arr, lens), backend="gloo",
                  timeout_s=PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    # the unsharded step on the card, from the same weights and batch
    cfg.dataset.sessions = ["a", "b", "c"]
    cfg.dataset.days_per_batch, cfg.use_amp, cfg.num_training_batches = 2, False, 2
    cfg.output_dir = cfg.checkpoint_dir = tempfile.mkdtemp(prefix="chip_smoke_two_ranks_")
    trials = synthetic_trials(cfg.dataset.sessions, trials_per_session=4, neural_dim=16)
    trainer = Trainer(cfg, device="cuda", train_trials=trials)
    trainer.model.load_state_dict(sd)
    single = [trainer.train_step({k: v.cuda() for k, v in batch.items()}) for _ in range(2)]
    r0 = ranks[0]
    w_hh = [trainer.model.state_dict()[f"gru.weight_hh_l{k}"].cpu().numpy() for k in range(2)]
    fig = {"phase": "parallel_two_ranks", "ranks": 2, "backend": "gloo", "device": "cuda:0",
           "step_mesh": [1, 2], "decode_D": 2,
           "loss": r0["loss"], "loss_single": [float(s[0]) for s in single],
           "grad_norm": r0["grad_norm"], "grad_norm_single": [float(s[1]) for s in single],
           "w_hh_max_abs": max(float(np.abs(a - b).max()) for a, b in zip(r0["w_hh"], w_hh)),
           "decode_equal": all(r["decode"] == r["decode_single"] for r in ranks),
           "ranks_agree": all(r["decode"] == r0["decode"] for r in ranks), "wall_s": wall}
    fig["ok"] = bool(np.allclose(fig["loss"], fig["loss_single"], rtol=1e-5, atol=0)
                     and np.allclose(fig["grad_norm"], fig["grad_norm_single"], rtol=1e-5, atol=0)
                     and all(np.allclose(a, b, rtol=1e-4, atol=1e-6)
                             for a, b in zip(r0["w_hh"], w_hh))
                     and fig["decode_equal"] and fig["ranks_agree"])
    emit(fig)
    return fig


def run_driver(main, argv, counters, **kw):
    """A driver's ``main(argv)`` in this process with the kernels' counts
    from 0: (its return, every JSON line it printed, its wall seconds, the
    launches it made, the error it raised or None). Its printed lines are
    parsed here, not echoed."""
    import contextlib
    import io
    import traceback

    zero(counters)
    buf = io.StringIO()
    ret, error = None, None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = main(argv, **kw)
    except BaseException as e:  # noqa: BLE001 (SystemExit too: it is a result here)
        error = f"{type(e).__name__}: {e}"[:300] + " | " + traceback.format_exc()[-600:]
    s = time.perf_counter() - t0
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    return ret, lines, s, counted_launches(counters), error


def all_finite(obj) -> bool:
    """Every number inside ``obj`` (nested dicts and lists) is finite."""
    if isinstance(obj, dict):
        return all(all_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(all_finite(v) for v in obj)
    if isinstance(obj, float):
        return bool(np.isfinite(obj))
    return True


def phase_drivers(opt_params, counters):
    """The measurement drivers of ``b2txt_tpu_torch.scripts`` on the card,
    each through its ``main(argv)`` as a user runs it, with their printed
    JSON lines parsed and gated (DRIVER_ARGV gives each one's arguments):
    bench.py at full size without its LLM stage (``finalize_opt`` holds the
    6.7b finalize), bench_opt's stages A, B and D on the OPT weights already
    on the card, and the others at their own sizes or the cuts listed."""
    import torch

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer, word_hash_encode
    from b2txt_tpu_torch.scripts import (bench, bench_device_decode, bench_opt, bench_streaming,
                                         bench_training, drive_large_lm, profile_device_step,
                                         profile_train_step)

    mains = {"bench": bench.main, "bench_device_decode": bench_device_decode.main,
             "bench_streaming": bench_streaming.main, "bench_training": bench_training.main,
             "bench_training_full_input": bench_training.main,
             "profile_train_step": profile_train_step.main,
             "bench_opt": lambda argv: bench_opt.main(argv, params=opt_params),
             "drive_large_lm": drive_large_lm.main}
    mains.update({f"profile_device_step_{m}": profile_device_step.main
                  for m in ("gather", "sort", "sel", "step")})
    runs, problems = {}, []
    for name, argv in DRIVER_ARGV.items():
        ret, lines, secs, launches, error = run_driver(mains[name], argv, counters)
        runs[name] = {"argv": argv, "s": secs, "launches": launches, "lines": lines,
                      "error": error, "ret": ret}
        if error and name != "bench_training_full_input":
            problems.append(f"{name}: {error}")
        torch.cuda.empty_cache()
    if problems:
        fig = {"phase": "drivers", "ok": False, "problems": problems,
               "s": {n: r["s"] for n, r in runs.items()},
               "lines": {n: r["lines"] for n, r in runs.items() if n != "bench_opt"}}
        emit(fig)
        return fig

    def last(name):
        return runs[name]["lines"][-1]

    # bench.py: both backends exact, WER 0, K1 5 a batch
    e = last("bench")["extra"]
    n = e["utts"]
    for key in ("device_exact", "device_pipeline_exact", "native_exact"):
        if e[key] != f"{n}/{n}":
            problems.append(f"bench: {key} {e[key]}")
    if e["device_wer"] != 0.0 or e["native_wer"] != 0.0:
        problems.append(f"bench: WER {e['device_wer']} / {e['native_wer']}")
    if e["gru_fwd_launches_per_batch"] != 5 or runs["bench"]["launches"]["gru_fwd"] == 0:
        problems.append(f"bench: K1 {e['gru_fwd_launches_per_batch']} a batch, "
                        f"{runs['bench']['launches']['gru_fwd']} in all")
    # bench_device_decode: the device search as exact as the native one, by K6
    # at K = 128 (as drive_large_lm's, at order 5)
    d = last("bench_device_decode")
    if d["device_exact"] != d["native_exact"]:
        problems.append(f"bench_device_decode: {d['device_exact']} against {d['native_exact']}")
    for name in ("bench_device_decode", "drive_large_lm"):
        if runs[name]["launches"].get("beam_step", 1) == 0:
            problems.append(f"{name}: the device search never launched K6")
    # bench_streaming: the hop inside its 80 ms, K1 launched
    st = last("bench_streaming")
    if not (st["update_latency_ms"]["median"] < 80.0 and st["gru_fwd_launches"] > 0
            and all_finite(st)):
        problems.append(f"bench_streaming: {st['update_latency_ms']}, "
                        f"K1 {st['gru_fwd_launches']}")
    # the training drivers: finite, K1 and K2 launched (at B = 256 too)
    tr = last("bench_training")
    if not (all_finite(tr) and min(tr["launches"].values()) > 0):
        problems.append(f"bench_training: {tr}")
    fi = runs["bench_training_full_input"]
    if not (fi["error"] and "h5py" in fi["error"]):
        problems.append(f"bench_training --full_input: expected the h5py refusal, got "
                        f"{fi['error'] or fi['lines']}")
    steps = {line["stage"]: line for line in runs["profile_train_step"]["lines"]
             if "stage" in line}
    for B in (64, 128, 256):
        f = steps.get(f"full_step_B{B}")
        if f is None or not all_finite(f) or min(f["launches"].values()) == 0:
            problems.append(f"profile_train_step B={B}: {f}")
    if not all(all_finite(line) for line in runs["profile_train_step"]["lines"]):
        problems.append("profile_train_step: a time or loss is not finite")
    # profile_device_step: every mode prints its lines
    for mode, key in (("gather", "layout"), ("sort", "us_per_sort"), ("sel", "op"),
                      ("step", "ms_per_frame")):
        if not any(key in line for line in runs[f"profile_device_step_{mode}"]["lines"]):
            problems.append(f"profile_device_step {mode}: no {key} line")
    # bench_opt: stages A and B finite, B's scores those of OPTRescorer.score
    A, Bst = runs["bench_opt"]["ret"][0], runs["bench_opt"]["ret"][1]
    cfg = OPTConfig.opt_6_7b()
    lists, _ = bench_opt.nbest_lists(Bst["nbest"], np.random.default_rng(0))
    resc = OPTRescorer(cfg, params=opt_params, encode=word_hash_encode(cfg.vocab_size),
                       device="cuda", compute_dtype=torch.bfloat16, max_len=32)
    want = [resc.score(c) for c in lists]
    stage_b_equal = max_abs(Bst["scores"], want) == 0.0
    if not (all_finite(A) and Bst["scores_finite"] and stage_b_equal):
        problems.append(f"bench_opt: A finite {all_finite(A)}, B finite "
                        f"{Bst['scores_finite']}, B equal to OPTRescorer.score {stage_b_equal}")
    # drive_large_lm: the device search's top-1 equal to the native one's
    dl = runs["drive_large_lm"]["lines"]
    dev_line = [line for line in dl if line.get("backend") == "device"]
    if not dev_line or dev_line[0]["native_top1_equal"].split("/")[0] != \
            dev_line[0]["native_top1_equal"].split("/")[1]:
        problems.append(f"drive_large_lm: {dl}")

    fig = {"phase": "drivers", "s": {n: r["s"] for n, r in runs.items()},
           "total_s": sum(r["s"] for r in runs.values()), "clock": "host",
           "launches": {n: r["launches"] for n, r in runs.items()},
           "launches_total": {k: sum(r["launches"][k] for r in runs.values())
                              for k in counters},
           "argv": {n: r["argv"] for n, r in runs.items()},
           "lines": {n: [{k: v for k, v in line.items() if k != "scores"}
                         for line in r["lines"]] for n, r in runs.items()},
           "full_input_error": fi["error"][:200] if fi["error"] else None,
           "bench_opt_stage_b_equal_to_score": stage_b_equal,
           "problems": problems}
    fig["ok"] = not problems
    emit(fig)
    return fig


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

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, init_params
    from b2txt_tpu_torch.evaluate.harness import _batched_inference
    from b2txt_tpu_torch.models import gru_decoder
    from b2txt_tpu_torch.ops.beam_step import beam_step
    from b2txt_tpu_torch.ops.gru import gru_layer_backward, gru_layer_forward, gru_layer_reference
    from b2txt_tpu_torch.ops.preprocess import fused_preprocess
    from b2txt_tpu_torch.utils.config import TrainConfig

    phase_build()

    cfg = TrainConfig()
    main_shape = (N_REQUESTS, (BINS - 8 - cfg.model.patch_size) // cfg.model.patch_stride + 1,
                  cfg.model.n_units)
    train_shape = (cfg.dataset.batch_size, main_shape[1], cfg.model.n_units)
    phase_gru_witness(*main_shape)
    connected_shape = (CONNECTED_BATCH,) + main_shape[1:]
    # the streaming hop's shapes: one step per layer at B = 1, and four
    stream_shapes = [(1, 1, cfg.model.n_units), (1, 4, cfg.model.n_units)]
    fwd_figs = phase_kernel_gru_fwd(KERNEL_CASES + [main_shape + ("contractive",),
                                                    main_shape + ("decoder_init",),
                                                    connected_shape + ("decoder_init",)]
                                    + [shape + ("decoder_init",) for shape in stream_shapes])
    bwd_figs = phase_kernel_gru_bwd(KERNEL_CASES + [train_shape + ("contractive",),
                                                    train_shape + ("decoder_init",)])
    pre_fig = phase_kernel_fused_preprocess(cfg.dataset.batch_size, BINS,
                                            cfg.model.n_input_features)
    moe_fig = phase_kernel_moe()

    fig, model, feats_list, infer, logits, outs, requests, world = phase_serve(
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
    fig["stage1_profile"] = profile_call(lambda: _batched_inference(model, feats_list, **infer))
    with mock.patch.object(gru_decoder, "gru_layer", gru_layer_reference):
        plain = _batched_inference(model, feats_list, **infer)
    fig["logits_max_abs_err"] = max(float(np.abs(a - b).max()) for a, b in zip(logits, plain))
    fig["logits_argmax_equal"] = all(
        np.array_equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(logits, plain))
    fig["logits_finite"] = all(bool(np.isfinite(a).all()) for a in logits)
    fig["logits_tol"] = "rtol=atol=2e-2 (bf16)"
    emit(fig)
    problems = check_serve(fig, logits, plain, cfg, main_shape)
    dsv2_fig = phase_finalize_dsv2(world, logits, requests)
    if not dsv2_fig["ok"]:
        problems.append(f"finalize_dsv2: {dsv2_fig['problems']}")
    parity = phase_search_parity(world, logits, requests, outs)
    if not parity["ok"]:
        problems.append(f"search_parity: {parity}")
    redis_fig = phase_redis(world, logits, requests)
    if not redis_fig["ok"]:
        problems.append(f"redis: {redis_fig}")
    conn, conn_world = phase_serve_connected(cfg, "cuda", {"gru_fwd": gru_layer_forward,
                                                           "beam_step": beam_step})
    problems += check_connected(conn, cfg.model.n_layers)
    problems += check_evaluate(phase_evaluate(cfg, conn_world, {"gru_fwd": gru_layer_forward}))
    cli_fig = phase_cli(cfg, conn_world, {"gru_fwd": gru_layer_forward})
    problems += check_cli(cli_fig, cfg.model.n_layers)
    gather_fig = phase_kernel_row_gather(conn_world["searcher"].dev_lm.table[0])
    if not gather_fig["ok"] or gather_fig["launches"] == 0:
        problems.append(f"row_gather disagrees with its plain version or never launched: "
                        f"{gather_fig['grid_bit_exact']}, {gather_fig['launches']}")
    prefix_fig = phase_prefix_beam(conn_world)
    if not prefix_fig["ok"]:
        problems.append(f"prefix_beam: {prefix_fig['same_top1']}/{PREFIX_UTTS} top-1 equal to "
                        f"the oracle's; {prefix_fig['problems']}")
    ladder_fig = phase_quality_ladder(conn_world, {"gru_fwd": gru_layer_forward})
    if not ladder_fig["ok"]:
        problems.append(f"quality_ladder: {ladder_fig['problems']}")
    # the sharded paths: one NCCL group of this process, until the train phase ends
    phase_s = {}
    t0 = time.perf_counter()
    mesh = join_nccl_group()
    sharded_fig = phase_sharded_decode(conn_world, mesh)
    phase_s["nccl_group+sharded_decode"] = time.perf_counter() - t0
    if not sharded_fig["ok"]:
        problems.append(f"sharded_decode: {sharded_fig['exact']} exact, "
                        f"{sharded_fig['nbest_equal_to_decode_batch']} n-best equal")
    # OPT-6.7b's 13.3 GB of bf16 weights, drawn on the card from a seed; the
    # connected world leaves the card after the finalize, the weights after
    # the rescore phases
    t0 = time.perf_counter()
    opt_params = init_params(OPTConfig.opt_6_7b(), "cuda", torch.bfloat16,
                             torch.Generator(device="cuda").manual_seed(OPT_SEED))
    torch.cuda.synchronize()
    opt_init_s = time.perf_counter() - t0
    fin_fig = phase_finalize_opt(conn_world, opt_params, {"gru_fwd": gru_layer_forward})
    if not fin_fig["ok"]:
        problems.append(f"finalize_opt: {fin_fig['problems']}")
    del conn_world
    fwd_fig = phase_opt_forward(opt_params, opt_init_s)
    if not fwd_fig["parity_2_layers"]["ok"]:
        problems.append(f"opt_forward: {fwd_fig['parity_2_layers']}")
    resc_fig = phase_opt_rescore(opt_params)
    if not resc_fig["ok"]:
        problems.append(f"opt_rescore: {resc_fig}")
    t0 = time.perf_counter()
    tp_fig = phase_opt_tp(opt_params, mesh)
    phase_s["opt_tp"] = time.perf_counter() - t0
    if not tp_fig["ok"]:
        problems.append(f"opt_tp: {tp_fig}")
    examples_fig = phase_examples(opt_params, {"gru_fwd": gru_layer_forward,
                                               "gru_bwd": gru_layer_backward})
    if not examples_fig["ok"]:
        problems.append(f"examples: {examples_fig['problems']}")
    drivers_fig = phase_drivers(opt_params, {"gru_fwd": gru_layer_forward,
                                             "gru_bwd": gru_layer_backward,
                                             "beam_step": beam_step})
    if not drivers_fig["ok"]:
        problems.append(f"drivers: {drivers_fig['problems']}")
    del opt_params
    torch.cuda.empty_cache()
    train_fig = phase_train({"gru_fwd": gru_layer_forward, "gru_bwd": gru_layer_backward,
                             "fused_preprocess": fused_preprocess})
    problems += check_train(train_fig, cfg.model.n_layers)
    t0 = time.perf_counter()
    pfwd_fig = phase_parallel_forward(mesh, {"gru_fwd": gru_layer_forward})
    if not pfwd_fig["ok"]:
        problems.append(f"parallel_forward: {pfwd_fig}")
    ptrain_fig = phase_parallel_train(mesh, {"gru_fwd": gru_layer_forward,
                                             "gru_bwd": gru_layer_backward})
    if not ptrain_fig["ok"]:
        problems.append(f"parallel_train: {ptrain_fig}")
    torch.distributed.destroy_process_group()
    two_fig = phase_parallel_two_ranks()
    phase_s["parallel_forward+parallel_train+parallel_two_ranks"] = time.perf_counter() - t0
    emit({"phase": "parallel_phases", "s": phase_s, "total_s": sum(phase_s.values()),
          "clock": "host"})
    if not two_fig["ok"]:
        problems.append(f"parallel_two_ranks: {two_fig}")
    if problems:
        raise RuntimeError("; ".join(problems))

    k_fwd = {**fwd_figs[main_shape + ("decoder_init", "bfloat16")], "weights": "decoder_init"}
    k_bwd = {**bwd_figs[train_shape + ("decoder_init", "bfloat16")], "weights": "decoder_init"}
    runs = train_fig["runs"]
    fused = train_fig["fused_vs_plain"]
    pre_fig = {**pre_fig, "max_abs_err": max(pre_fig["max_abs_err"], fused["train"], fused["eval"])}
    emit({"kernels": [
        kernel_entry("gru_fwd", "cuda", "b2txt_tpu_torch/csrc/gru_fwd.cu",
                     "b2txt_tpu/ops/pallas/gru.py:32",
                     fig["launches"]["gru_fwd"] + cli_fig["launches_total"]["gru_fwd"]
                     + examples_fig["launches_total"]["gru_fwd"]
                     + sum(n["gru_fwd"] for n in ladder_fig["launches_per_gain"])
                     + pfwd_fig["launches"]["gru_fwd"]
                     + ptrain_fig["launches_sharded"]["gru_fwd"]
                     + drivers_fig["launches_total"]["gru_fwd"],
                     f"serve run: {fig['batches']} forward batch of {N_REQUESTS} requests "
                     f"({fig['launches']['gru_fwd']}); cli runs: "
                     + ", ".join(f"{k} {v['gru_fwd']}" for k, v in cli_fig["launches"].items())
                     + f"; examples {examples_fig['launches_total']['gru_fwd']} (streaming "
                     f"{STREAM_WARMUP + STREAM_HOPS} hops in f32 and bf16, quickstart, "
                     f"figures); quality ladder "
                     f"{sum(n['gru_fwd'] for n in ladder_fig['launches_per_gain'])} "
                     f"({len(LADDER_GAINS)} gains x {LADDER_UTTS // LADDER_BATCH} batches); "
                     f"parallel_forward {pfwd_fig['launches']['gru_fwd']}, parallel_train "
                     f"{ptrain_fig['launches_sharded']['gru_fwd']} ({PARALLEL_TRAIN_STEPS} "
                     f"sharded steps); drivers "
                     + ", ".join(f"{k} {v['gru_fwd']}"
                                 for k, v in drivers_fig["launches"].items()
                                 if v["gru_fwd"]),
                     k_fwd, ("B", "T", "H", "dtype", "weights")),
        kernel_entry("gru_bwd", "cuda", "b2txt_tpu_torch/csrc/gru_bwd.cu",
                     "b2txt_tpu/ops/pallas/gru.py:122",
                     runs["transform_data"]["launches"]["gru_bwd"]
                     + examples_fig["launches_total"]["gru_bwd"]
                     + ptrain_fig["launches_sharded"]["gru_bwd"]
                     + drivers_fig["launches_total"]["gru_bwd"],
                     f"train run: {TRAIN_STEPS} steps "
                     f"({runs['transform_data']['launches']['gru_bwd']}); examples: "
                     f"quickstart {QUICKSTART_STEPS} steps, figures {FIGURES_STEPS} steps "
                     f"({examples_fig['launches_total']['gru_bwd']}); parallel_train "
                     f"{PARALLEL_TRAIN_STEPS} sharded steps "
                     f"({ptrain_fig['launches_sharded']['gru_bwd']}); drivers "
                     + ", ".join(f"{k} {v['gru_bwd']}"
                                 for k, v in drivers_fig["launches"].items()
                                 if v["gru_bwd"]), k_bwd,
                     ("B", "T", "H", "dtype", "weights")),
        kernel_entry("fused_preprocess", "cuda", "b2txt_tpu_torch/csrc/preprocess.cu",
                     "b2txt_tpu/ops/pallas/preprocess.py:51",
                     runs["fused_preprocess"]["launches"]["fused_preprocess"],
                     f"fused train run: {FUSED_STEPS} steps", pre_fig,
                     ("B", "T", "C")),
        kernel_entry("row_gather", "cuda", "b2txt_tpu_torch/csrc/row_gather.cu",
                     "scripts/profile_pallas_gather.py:47", gather_fig["launches"],
                     "gather profile run: 3 cases, each 1 check + 2 warm-up + 32 timed "
                     "launches; figures of the first case, over its 32 rotated index sets",
                     gather_fig["main"], ("rows", "rw", "g", "in_flight")),
        kernel_entry("moe_experts", "cuda", "b2txt_tpu_torch/csrc/moe_grouped.cu",
                     "none (port-only: the JAX package has no expert layer)",
                     dsv2_fig["launches"],
                     f"finalize_dsv2 run: {dsv2_fig['requests']} finalizes, "
                     f"{dsv2_fig['packed_forwards']} packed forwards of DeepSeek-V2-Lite, "
                     f"{dsv2_fig['launches_per_forward']:g} a forward ({dsv2_fig['moe_layers']} "
                     f"MoE layers); figures of the kernel_moe phase", moe_fig,
                     ("T", "E", "k", "D", "Fm")),
        kernel_entry("beam_step", "cuda", "b2txt_tpu_torch/csrc/beam_step.cu",
                     "none (port-only: the JAX package's frame step is XLA)",
                     conn["launches"]["beam_step"],
                     f"serve_connected run through DecoderService: "
                     f"{conn['searched']['frames']:g} frames searched, one launch a frame, and "
                     f"two warm-up launches for each of {conn['searched']['graph_captures']:g} "
                     f"captures; figures of the kernel_beam_step phase",
                     conn["kernel_beam_step"], ("B", "K", "first_beam", "H", "order")),
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
