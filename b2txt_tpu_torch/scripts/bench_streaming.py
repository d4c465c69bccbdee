"""Simulated online streaming decode: the causal bin-by-bin GRU with carried
state plus the incremental LM beam search (PROGRESS config 5; the reference's
closed-loop flow of evaluate_model.py stage 2 with partial decodes per
chunk).

Counterpart of ``scripts/bench_streaming.py``. Every patch_stride (4) new
20 ms bins, the last patch_size (14) bins are day-transformed and patched
into one GRU step (streaming hidden state, K1 at B = 1, T = 1 per layer), the
new logit frame goes into the incremental beam search, and a partial
sentence is available. It reports the latency of one update (an 80 ms hop,
ending in the host's read of its frame), the device time of a hop over N
chained hops between two CUDA events (no host sync inside), the native
searcher's incremental step, and the fully device-resident hop (GRU step +
the device searcher's frame expansion) over N chained hops.

    python -m b2txt_tpu_torch.scripts.bench_streaming
    python -m b2txt_tpu_torch.scripts.bench_streaming --device cpu --features 32 \\
        --units 32 --layers 2 --hops 8 --device_hops 4

The JAX driver takes no options (production shapes). New here: ``--device``
(the CUDA card by default, an error without one; ``cpu`` on request) and,
to cut the model for a quick run, ``--features``, ``--units``, ``--layers``
(default ``TrainConfig()``'s 512, 768, 5), ``--hops`` (256) and
``--device_hops`` (128). The JAX driver's ``lax.scan`` over N updates in one
call becomes N hops issued back to back between two CUDA events. The text
lines are the JAX driver's; a last JSON line (new) carries every number,
with the K1 launches of the run, and ``main(argv)`` returns it. Each hop
still casts the model's weights to bf16 inside ``GRUDecoder.forward``: that
cost is measured here, not removed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m b2txt_tpu_torch.scripts.bench_streaming",
        description="Simulated online streaming decode benchmark (per-80 ms-hop latency)")
    p.add_argument("--device", default=None,
                   help="where the model and the device searcher run: the CUDA card by "
                        "default, 'cpu' to run on the CPU")
    p.add_argument("--features", type=int, default=None, help="input features (512)")
    p.add_argument("--units", type=int, default=None, help="GRU units (768)")
    p.add_argument("--layers", type=int, default=None, help="GRU layers (5)")
    p.add_argument("--hops", type=int, default=256, help="chained model hops timed")
    p.add_argument("--device_hops", type=int, default=128,
                   help="chained device-resident hops (GRU step + searcher expansion) timed")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)

    import torch

    from ..models.gru_decoder import GRUDecoder
    from ..utils.config import TrainConfig
    from ..utils.device import resolve_device
    from ..utils.profiling import kernel_launches, launches_since, seconds_per_call

    device = resolve_device(args.device)
    launches0 = kernel_launches()
    cfg = TrainConfig()
    for name, value in (("n_input_features", args.features), ("n_units", args.units),
                        ("n_layers", args.layers)):
        if value is not None:
            setattr(cfg.model, name, value)
    D, H, L = cfg.model.n_input_features, cfg.model.n_units, cfg.model.n_layers
    PATCH, STRIDE = cfg.model.patch_size, cfg.model.patch_stride
    model = GRUDecoder(cfg.model, n_days=45, n_classes=41, device=device,
                       generator=torch.Generator().manual_seed(0))
    day_idx = torch.zeros((1,), dtype=torch.long, device=device)
    h0 = model.h0.detach().reshape(1, 1, H).to(torch.bfloat16).expand(L, 1, H).contiguous()

    @torch.no_grad()
    def stream_step(h, window):
        """One online update: a 14-bin window → 1 logit frame + the new state."""
        logits, h2 = model(window[None], day_idx, states=h, return_state=True,
                           compute_dtype=torch.bfloat16)
        return logits[0, 0], h2

    rng = np.random.default_rng(0)

    # the latency of one update, ending in the host's read of its frame
    w = torch.from_numpy(rng.standard_normal((PATCH, D)).astype(np.float32)).to(device)
    lg, h = stream_step(h0, w)
    lg.float().cpu().numpy()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        lg, h = stream_step(h0, w)
        lg.float().cpu().numpy()
        lat.append(time.perf_counter() - t0)
    lat_ms = 1000 * np.asarray(lat)

    # the device time of a hop: N chained hops between two events
    N = args.hops
    ws = torch.from_numpy(rng.standard_normal((N, PATCH, D)).astype(np.float32)).to(device)

    def stream_many():
        h = h0
        for i in range(N):
            _, h = stream_step(h, ws[i])

    before = kernel_launches()
    amortized_us = 1e6 * seconds_per_call(stream_many, 4, device) / N
    k1_per_hop = launches_since(before)["gru_fwd"] / (5 * N)  # 1 warm-up + 4 timed calls

    # the native searcher's incremental step, per frame
    from ..data import synthetic
    from ..lm import Lexicon, train_ngram
    from ..lm.lexicon import strip_stress
    from ..runtime import NativeLexiconBeamSearch
    from ..utils.config import DecodeConfig

    prons = synthetic.word_pronunciations()
    lm = train_ngram(synthetic.sentence_corpus(100), order=3)
    tmp = tempfile.mkdtemp()
    arpa = os.path.join(tmp, "lm.arpa")
    lm.to_arpa(arpa)
    lexp = os.path.join(tmp, "lexicon.txt")
    with open(lexp, "w") as f:
        for wd, pron in prons.items():
            f.write(f"{wd.upper()}  {' '.join(strip_stress(pron))}\n")
    dec = NativeLexiconBeamSearch(
        arpa, lexp, DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=128)
    )
    lexicon = Lexicon.from_words(prons)
    ids = lexicon.sentence_to_phonemes("hello world brain text")
    frames = []
    for pid in ids:
        for _ in range(3):
            row = np.full(41, -8.0, np.float32)
            row[pid] = 0.0
            frames.append(row)
        blank = np.full(41, -8.0, np.float32)
        blank[0] = 0.0
        frames.append(blank)
    lp = np.stack(frames)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    dec.reset()
    lm_lat = []
    for t in range(lp.shape[0]):
        t0 = time.perf_counter()
        dec.decode(lp[t : t + 1])
        dec.result()
        lm_lat.append(time.perf_counter() - t0)
    lm_ms = 1000 * np.asarray(lm_lat)

    # the fully device-resident hop: the GRU step and the device searcher's
    # frame expansion, N hops chained between two events
    from ..decode.lmbeam_device import DeviceLexiconBeamSearch

    dcfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=5,
                        beam_width=96, first_beam_size=8, sum_mode=False)
    dev = DeviceLexiconBeamSearch(lexicon, lm, dcfg, device=device)
    bstate = dev._make_state(1)
    log_bp = float(math.log(dcfg.blank_penalty))
    blank_penalty = torch.zeros(41, device=device)
    blank_penalty[0] = log_bp
    Nh = args.device_hops
    ws_h = torch.from_numpy(rng.standard_normal((Nh, PATCH, D)).astype(np.float32)).to(device)

    @torch.no_grad()
    def device_hop_many():
        h, st = h0, bstate
        for i in range(Nh):
            lg, h = stream_step(h, ws_h[i])
            lp_dev = torch.log_softmax(lg.float(), dim=-1) - blank_penalty
            st = dev._expand(st, lp_dev[None], float(dcfg.acoustic_scale),
                             float(dcfg.length_penalty), dcfg.first_beam_size, False)[0]

    device_hop_us = 1e6 * seconds_per_call(device_hop_many, 4, device) / Nh

    hop_ms = STRIDE * 20.0
    print(f"online hop: {hop_ms:.0f} ms of neural data per update")
    print(f"fully device-resident hop (GRU step + device LM expand, "
          f"on-device chained): {device_hop_us:.1f} us/update "
          f"({0.1 * device_hop_us / hop_ms:.2f}% of the real-time budget)")
    print(f"model update latency: median {np.median(lat_ms):.2f} ms, "
          f"p90 {np.percentile(lat_ms, 90):.2f} ms (incl. the host's read of the frame)")
    print(f"model device step, amortized: {amortized_us:.1f} us/update")
    print(f"LM incremental step: median {np.median(lm_ms):.3f} ms, "
          f"p90 {np.percentile(lm_ms, 90):.3f} ms")
    total = np.median(lat_ms) + np.median(lm_ms)
    print(f"end-to-end per-update latency: ~{total:.2f} ms "
          f"({100 * total / hop_ms:.1f}% of the {hop_ms:.0f} ms real-time budget)")
    out = {"driver": "bench_streaming", "backend": device.type,
           "model": {"features": D, "units": H, "layers": L, "patch": PATCH, "stride": STRIDE,
                     "compute_dtype": "bfloat16"},
           "hop_ms_of_data": hop_ms,
           "update_latency_ms": {"median": float(np.median(lat_ms)),
                                 "p90": float(np.percentile(lat_ms, 90)), "n": len(lat)},
           "model_step_us_amortized": amortized_us, "chained_hops": N,
           "device_resident_hop_us": device_hop_us, "device_resident_hops": Nh,
           "lm_step_ms": {"median": float(np.median(lm_ms)),
                          "p90": float(np.percentile(lm_ms, 90)), "frames": len(lm_lat)},
           "end_to_end_ms": float(total), "budget_share": float(total / hop_ms),
           "gru_fwd_launches_per_hop": k1_per_hop,
           "gru_fwd_launches": launches_since(launches0)["gru_fwd"],
           "clock": "latency: host, ending in the frame's read; amortized and "
                    "device-resident: CUDA events around chained hops (host clock on the CPU)"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
