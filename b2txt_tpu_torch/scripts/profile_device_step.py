"""Profile the device beam search's frame step and its candidate gather
layouts.

Counterpart of ``scripts/profile_device_step.py``, with its modes, options
and JSON lines:

  step    — time the batched decode at the reference's scale (125k words),
            optionally with the LM probes stubbed out (``--stub_lm``), to
            split the probe cost from the sort/merge/trie cost.
  gather  — the probe-window gather layouts against synthetic tables of
            production size: arbitrary-start (8, 4) windows (the round-2
            layout) against bucket-aligned rows, window widths and dtypes,
            with torch indexing (the JAX driver's gathers are XLA gathers,
            not a Pallas kernel: K4, ``ops/gather.py``, is profiled by
            ``scripts/profile_gather.py``).
  sort    — the stable sort at the searcher's candidate shapes, the segment
            merge (``lmbeam_device._seg_merge4``, the port's counterpart of
            JAX's ``_seg_scan``) and ``topk``.
  sel     — selection and merge costs: ``topk``, lexicographic sorts of 3, 5
            and 7 operands, the four-column segment merge in Viterbi and sum
            modes, and a minor-dimension ``gather``.

Every timing is a loop of ``--iters`` steps issued back to back between two
CUDA events (the best of 3 loops; the JAX driver's ``lax.scan`` of the same
steps), each step drawing its own random indices on the device as the JAX
steps do.

    python -m b2txt_tpu_torch.scripts.profile_device_step gather
    python -m b2txt_tpu_torch.scripts.profile_device_step step --stub_lm
    python -m b2txt_tpu_torch.scripts.profile_device_step sel --device cpu --batch 4 \\
        --cands 64 --K 8 --iters 3

Where it differs from the JAX driver: ``--device`` (new; the CUDA card by
default, an error without one, ``cpu`` on request); ``backend`` is the torch
device type; ``sel`` has no ``approx_max_k`` lines (a TPU operation with no
PyTorch counterpart); ``step``'s "compile+first" line times the first
batch's decode (nothing is compiled). ``main(argv)`` returns the printed
objects.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def timed_loop(step: Callable, iters: int, device, reps: int = 3) -> float:
    """Seconds per call of ``step(carry, i) -> carry`` over ``iters``
    chained calls (the best of ``reps`` loops)."""
    import torch

    from ..utils.profiling import seconds_per_call

    def run():
        c = torch.zeros((), device=device)
        for i in range(iters):
            c = step(c, i)
        return c

    run()  # warm
    return min(seconds_per_call(run, 1, device, warmup=0) for _ in range(reps)) / iters


def _randint(lo: int, hi: int, shape, i: int, device):
    """Indices drawn on ``device`` from a generator seeded by the step."""
    import torch

    gen = torch.Generator(device=device).manual_seed(i)
    return torch.randint(lo, hi, shape, generator=gen, device=device)


# --------------------------------------------------------------------- gather
def bench_gathers(args, device, emit) -> None:
    import torch

    S_slots = args.slots          # total 16-byte slots in the table
    N = args.windows              # probe windows per call

    def report(name, per_call_s, n_idx, bytes_gathered):
        emit({
            "layout": name,
            "us_per_call": round(per_call_s * 1e6, 2),
            "n_windows": n_idx,
            "MB": round(bytes_gathered / 1e6, 3),
            "GBps": round(bytes_gathered / per_call_s / 1e9, 2),
            "ns_per_window": round(per_call_s / n_idx * 1e9, 2),
        })

    gen = torch.Generator(device=device).manual_seed(0)
    # A: the round-2 layout, arbitrary-start (8, 4) windows of a flat (S, 4)
    tabA = torch.randint(0, 1 << 30, (S_slots, 4), generator=gen, device=device,
                         dtype=torch.int32)
    ar8 = torch.arange(8, device=device)

    def stepA(c, i):
        slot0 = _randint(0, S_slots - 8, (N,), i, device)
        rows = tabA[slot0[:, None] + ar8[None]]                    # (N, 8, 4)
        return c + rows[:, 0, 2].sum().float()

    report("A_flat_window8x4", timed_loop(stepA, args.iters, device), N, N * 128)

    # B: bucket-aligned, (S/8, 8, 4), one index per window
    tabB = tabA.reshape(S_slots // 8, 8, 4)

    def stepB(c, i):
        rows = tabB[_randint(0, S_slots // 8, (N,), i, device)]   # (N, 8, 4)
        return c + rows[:, 0, 2].sum().float()

    report("B_bucket8x4", timed_loop(stepB, args.iters, device), N, N * 128)

    # B2: bucket-aligned flat rows, (S/8, 32) int32 (one 128-byte row)
    tabB2 = tabA.reshape(S_slots // 8, 32)

    def stepB2(c, i):
        rows = tabB2[_randint(0, S_slots // 8, (N,), i, device)]  # (N, 32)
        return c + rows[:, 2].sum().float()

    report("B2_bucketrow32", timed_loop(stepB2, args.iters, device), N, N * 128)

    # C: bucket-aligned half windows, (S/4, 16)
    tabC = tabA.reshape(S_slots // 4, 16)

    def stepC(c, i):
        rows = tabC[_randint(0, S_slots // 4, (N,), i, device)]   # (N, 16)
        return c + rows[:, 2].sum().float()

    report("C_bucketrow16", timed_loop(stepC, args.iters, device), N, N * 64)

    # D: two-choice bucket-4, indices (N, 2) into (S/4, 16)
    def stepD(c, i):
        rows = tabC[_randint(0, S_slots // 4, (N, 2), i, device)]  # (N, 2, 16)
        return c + rows[:, 0, 2].sum().float()

    report("D_2choice_row16", timed_loop(stepD, args.iters, device), N, N * 128)

    # E: single-element gathers (trie style), (S*4,) flat
    tabE = tabA.reshape(-1)

    def stepE(c, i):
        vals = tabE[_randint(0, S_slots * 4 - 1, (N,), i, device)]
        return c + vals.sum().float()

    report("E_scalar_gather", timed_loop(stepE, args.iters, device), N, N * 4)

    # F: wide bucket rows, (S/32, 128) int32 = one 512-byte row
    tabF = tabA.reshape(S_slots // 32, 128)

    def stepF(c, i):
        rows = tabF[_randint(0, S_slots // 32, (N,), i, device)]  # (N, 128)
        return c + rows[:, 2].sum().float()

    report("F_bucketrow128", timed_loop(stepF, args.iters, device), N, N * 512)

    # G: int16 bucket rows, (S/8, 32) int16 (half the bytes of B2)
    tabG = (tabA.reshape(S_slots // 8, 32) & 0x7FFF).to(torch.int16)

    def stepG(c, i):
        rows = tabG[_randint(0, S_slots // 8, (N,), i, device)]
        return c + rows[:, 2].to(torch.int32).sum().float()

    report("G_bucketrow32_i16", timed_loop(stepG, args.iters, device), N, N * 64)

    emit({"slots": S_slots, "windows": N, "table_MB": round(S_slots * 16 / 1e6, 1)})


# ----------------------------------------------------------------------- sort
def _sorted_operands(keys, ops):
    """Sort every operand by ``keys`` along dim 1 (stable): lax.sort with one key."""
    import torch

    perm = torch.sort(keys, dim=1, stable=True).indices
    return [keys.gather(1, perm)] + [o.gather(1, perm) for o in ops]


def bench_sort(args, device, emit) -> None:
    import torch

    from ..decode.lmbeam_device import _seg_merge4

    B, N = args.batch, args.cands
    gen = torch.Generator(device=device).manual_seed(0)
    k1 = torch.randint(0, 1 << 30, (B, N), generator=gen, device=device, dtype=torch.int32)
    ops = [torch.randn((B, N), generator=gen, device=device) for _ in range(5)]

    def step(c, i):
        out = _sorted_operands(k1 + i, ops)
        return c + out[1][0, 0]

    per = timed_loop(step, args.iters, device)
    emit({"sort_B": B, "sort_N": N, "operands": 6, "us_per_sort": round(per * 1e6, 2)})

    # the segment merge (log-sum-exp in segments) at the same shape
    starts = torch.rand((B, N), generator=gen, device=device) < 0.3
    starts[:, 0] = True

    def step2(c, i):
        sc = (ops[0] + i).reshape(-1, 1).expand(-1, 4).contiguous()
        merged, _, _ = _seg_merge4(sc, starts, True)
        return c + merged[0, 0]

    per2 = timed_loop(step2, args.iters, device)
    emit({"segscan_us": round(per2 * 1e6, 2)})

    k = min(96, N)

    def step3(c, i):
        v, _ = torch.topk(ops[0] + i, k, dim=1)
        return c + v[0, 0]

    per3 = timed_loop(step3, args.iters, device)
    emit({"topk_us": round(per3 * 1e6, 2), "k": k})


# ------------------------------------------------------------------ selection
def bench_sel(args, device, emit) -> None:
    """Selection and merge costs at the searcher's shapes: topk, sort
    operand scaling, a minor-dimension gather, and the four-column segment
    merge."""
    import torch

    from ..decode.lmbeam_device import _seg_merge4

    B, N, K = args.batch, args.cands, args.K
    gen = torch.Generator(device=device).manual_seed(0)
    vals = torch.randn((B, N), generator=gen, device=device)
    k1 = torch.randint(0, 1 << 30, (B, N), generator=gen, device=device, dtype=torch.int32)

    def t(name, step, extra=None):
        per = timed_loop(step, args.iters, device)
        emit({"op": name, "us": round(per * 1e6, 2), **(extra or {})})

    def s_topk(c, i):
        v, _ = torch.topk(vals + i, K, dim=1)
        return c + v[0, 0]

    t("top_k", s_topk)

    for n_ops in (3, 5, 7):
        ops = [torch.randn((B, N), generator=gen, device=device) for _ in range(n_ops - 1)]

        def s_sort(c, i, ops=ops):
            # two keys (k1 + i, ops[0]): a stable sort by the second, then by
            # the first
            p1 = torch.sort(ops[0], dim=1, stable=True).indices
            p2 = torch.sort((k1 + i).gather(1, p1), dim=1, stable=True).indices
            perm = p1.gather(1, p2)
            out = [o.gather(1, perm) for o in ops]
            return c + out[0][0, 0]

        t(f"sort_{n_ops}ops", s_sort)

    starts = torch.rand((B, N), generator=gen, device=device) < 0.3
    starts[:, 0] = True
    vals4 = torch.randn((B * N, 4), generator=gen, device=device)

    def s_seg4(c, i):
        merged, _, _ = _seg_merge4(vals4 + i, starts, False)
        return c + merged[0, 0]

    t("seg_merge4_viterbi", s_seg4)

    def s_seg4s(c, i):
        merged, _, _ = _seg_merge4(vals4 + i, starts, True)
        return c + merged[0, 0]

    t("seg_merge4_sum", s_seg4s)

    # minor-dimension gather: (B*K, 41) rows → (B*K, 8) selected columns
    rows = torch.randn((B * K, 41), generator=gen, device=device)
    idx = torch.randint(0, 41, (B * K, 8), generator=gen, device=device)

    def s_take(c, i):
        return c + (rows + i).gather(1, idx)[0, 0]

    t("take_minor_41to8", s_take, {"rows": B * K})


# ----------------------------------------------------------------------- step
def bench_step(args, device, emit) -> None:
    import torch

    from ..decode.lmbeam_device import DeviceLexiconBeamSearch
    from ..utils.config import DecodeConfig
    from .bench_device_decode import build_world, make_utts

    t0 = time.time()
    lex, lm, wl, arpa, lexp, rng = build_world(args.vocab, 3)
    print(f"world built {time.time() - t0:.0f}s", flush=True)
    cfg = DecodeConfig(
        acoustic_scale=0.325, blank_penalty=90.0,
        ctc_blank_skip_threshold=0.98, nbest=20,
        beam_width=args.K, beam=17.0, first_beam_size=8, sum_mode=False,
    )
    dev = DeviceLexiconBeamSearch(lex, lm, cfg, device=device)
    tab, P = dev.dev_lm.table
    emit({
        "lm_table_rows": int(tab.shape[0]),
        "lm_table_MB": round(tab.numel() * tab.element_size() / 1e6, 1),
        "trie_nodes": lex.n_nodes,
        "trie_next_MB": round(lex.n_nodes * 41 * 4 / 1e6, 1),
        "row_width": int(tab.shape[1]) if tab.dim() > 1 else P,
    })

    if args.stub_lm:
        real = dev.dev_lm

        class StubLM:
            """Every probe answers -2: the search without the table reads."""
            order = real.order
            bos_id = real.bos_id
            eos_id = real.eos_id
            unk_logp = real.unk_logp
            table = real.table

            def logp_words(self, ctx, words, uni_logp_w=None, n_exact=None):
                return torch.full(words.shape, -2.0, device=words.device)

            def logp(self, ctx, word):
                return torch.full(torch.broadcast_shapes(ctx.shape[:-1], word.shape), -2.0,
                                  device=word.device)

        dev.dev_lm = StubLM()

    B, T = args.batch, args.frames
    utts = make_utts(lex, wl, rng, B)
    arr = np.full((B, T, 41), -20.0, np.float32)
    arr[:, :, 0] = 0.0
    for i, (_, lp) in enumerate(utts):
        arr[i, : min(T, lp.shape[0])] = lp[:T]
    lens = np.full((B,), T, np.int32)

    t0 = time.time()
    dev.decode_batch(arr, lens)
    print(f"compile+first: {time.time() - t0:.1f}s", flush=True)
    best = 1e30
    for _ in range(3):
        t0 = time.perf_counter()
        dev.decode_batch(arr, lens)
        best = min(best, time.perf_counter() - t0)
    per_frame = best / T
    emit({
        "vocab": args.vocab, "B": B, "K": args.K, "T": T,
        "stub_lm": bool(args.stub_lm),
        "batch_s": round(best, 4),
        "ms_per_frame": round(per_frame * 1e3, 4),
        "us_per_utt_frame": round(per_frame / B * 1e6, 2),
        "sentences_per_sec_at_250f": round(B / (per_frame * 250), 2),
    })


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.profile_device_step",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["step", "gather", "sort", "sel"])
    p.add_argument("--vocab", type=int, default=125_000)
    p.add_argument("--K", type=int, default=96)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--stub_lm", action="store_true")
    p.add_argument("--slots", type=int, default=2_097_152)
    p.add_argument("--windows", type=int, default=24576)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--cands", type=int, default=1344)
    p.add_argument("--device", default=None,
                   help="where the profiled work runs: the CUDA card by default, 'cpu' to "
                        "run on the CPU")
    return p


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    args = build_parser().parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    lines: List[Dict[str, object]] = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"backend": device.type, "mode": args.mode})
    {"gather": bench_gathers, "sort": bench_sort, "sel": bench_sel,
     "step": bench_step}[args.mode](args, device, emit)
    return lines


if __name__ == "__main__":
    main()
