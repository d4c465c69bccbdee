"""Soft-posterior quality ladder: sweep the planted head gain and measure
decode quality per searcher backend.

Counterpart of ``scripts/quality_ladder.py``, with the same options;
``--device cpu`` (alias ``--force_cpu``) runs stage 1 and the device
searcher on the CPU, which otherwise run on the CUDA card. The connected
pipeline decodes every planted sentence exactly at the calibrated posterior
sharpness (head gain 45, blank bias 12). Lower gains give soft, ambiguous
posteriors, where both searchers must agree and degrade gracefully. Per gain
and backend it reports:

  * exact-match, search errors, aggregate WER (+CI);
  * n-best pool depth (distinct candidate sentences);
  * oracle WER of the n-best list (the floor an LLM rescorer could reach);
  * cross-backend top-1 agreement on identical posteriors.

The backends are the native C++ searcher and the device searcher, and with
``--lattice`` the native lattice n-best (``state_key="ngram"``, wide beam).

    python -m b2txt_tpu_torch.scripts.quality_ladder [--gains 15,20,25,35,45] [--lattice]
    python -m b2txt_tpu_torch.scripts.quality_ladder --vocab 300 --utts 8 \\
        --device_batch 4 --bins 288 --gains 18,45 --device cpu

Prints one JSON line per gain plus a summary line; ``main(argv)`` returns
them.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.quality_ladder",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--vocab", type=int, default=125_000)
    p.add_argument("--utts", type=int, default=128)
    p.add_argument("--device_batch", type=int, default=64)
    p.add_argument("--bins", type=int, default=520)
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--gains", default="15,20,25,35,45")
    p.add_argument("--blank_bias", type=float, default=12.0)
    p.add_argument("--beam_width", type=int, default=48)
    p.add_argument("--nbest", type=int, default=100)
    p.add_argument("--max_homophones", type=int, default=None)
    p.add_argument("--real_lexicon", action="store_true",
                   help="sweep over the reference's CMUdict trie (needs its dict.txt)")
    p.add_argument("--adversarial", action="store_true")
    p.add_argument("--lattice", action="store_true",
                   help="also decode with the C++ lattice n-best (ngram-keyed, wide "
                        "beam): the deep candidate lists of the reference's lattice "
                        "ShortestPath (ctc_wfst_beam_search.cc:123-160)")
    p.add_argument("--lattice_width", type=int, default=512)
    p.add_argument("--state_key", default="history", choices=["history", "ngram"],
                   help="the device searcher's hypothesis state space")
    p.add_argument("--device", default=None,
                   help="where stage 1 and the device searcher run: the CUDA card by "
                        "default, 'cpu' to run on the CPU")
    p.add_argument("--force_cpu", dest="device", action="store_const", const="cpu",
                   help="the same as --device cpu")
    return p


def pool_metrics(results, sents):
    """(mean distinct-pool depth, oracle WER) of n-best lists."""
    from ..utils.metrics import edit_distance

    depths = []
    dist = 0
    total = 0
    for r, truth in zip(results, sents):
        cands = list(dict.fromkeys(c.sentence for c in r)) if r else []
        depths.append(len(cands))
        ref = truth.split()
        best = min(
            (edit_distance(ref, c.split()) for c in cands),
            default=len(ref),
        )
        dist += best
        total += len(ref)
    return float(np.mean(depths)) if depths else 0.0, dist / max(total, 1)


def _host_decode(searcher, host_logits) -> list:
    out = []
    for lp in host_logits:
        searcher.reset()
        searcher.decode(lp)
        out.append(searcher.finish_decoding())
    return out


def backend_row(cfg, sents, results, seconds: float) -> dict:
    """One backend's figures over ``sents``."""
    from .world import aggregate_wer, score_results

    correct, serr = score_results(cfg, sents, results)
    wer, lo, hi = aggregate_wer(sents, results)
    depth, oracle = pool_metrics(results, sents)
    return {"exact": f"{correct}/{len(sents)}", "search_errors": serr,
            "wer": round(wer, 4), "wer_ci": [round(lo, 4), round(hi, 4)],
            "pool_depth_mean": round(depth, 1), "oracle_wer": round(oracle, 4),
            "sentences_per_s": round(len(sents) / seconds, 2)}


def run_ladder(cfg, utts, gains: Sequence[float], blank_bias: float, batch: int,
               bins: int, native, dev, lattice=None, device=None,
               emit: Callable[[dict], None] = lambda row: None) -> List[dict]:
    """The sweep over built searchers: per gain, planted stage 1 on
    ``device`` in batches of ``batch`` (the last padded with the batch's
    first utterance), the posteriors fetched to the host for ``native`` (and
    ``lattice``), and kept on the device for ``dev``'s batched decode.
    Returns one row per gain; each row also goes to ``emit``. Each row's
    ``results`` key holds the n-best lists per backend and ``posteriors`` the
    host posteriors (neither is emitted)."""
    import torch

    from ..utils.device import resolve_device
    from .world import make_stage1

    device = resolve_device(device)
    batches = []
    for start in range(0, len(utts), batch):
        chunk = utts[start : start + batch]
        lab = np.stack([lab for _, lab in chunk] + [chunk[0][1]] * (batch - len(chunk)))
        batches.append((lab, len(chunk), [s for s, _ in chunk]))
    all_sents = [s for _, _, sents in batches for s in sents]
    plens = None
    ladder = []
    for gain in gains:
        run1, P, _ = make_stage1(batch, bins, head_gain=gain, blank_bias=blank_bias,
                                 device=device)
        if plens is None or plens[0] != P:
            plens = np.full((batch,), P, np.int32)
        host_logits, staged = [], []
        for j, (lab, n_real, _) in enumerate(batches):
            lp = run1(lab, torch.Generator(device=device).manual_seed(1000 + j))
            staged.append(lp)
            arr = lp.cpu().numpy()
            host_logits.extend(arr[i] for i in range(n_real))

        t0 = time.perf_counter()
        nat_results = _host_decode(native, host_logits)
        nat_s = time.perf_counter() - t0

        dev_results = []
        t0 = time.perf_counter()
        for (_, n_real, _), res in zip(
            batches, dev.decode_batches([(lp, plens) for lp in staged])
        ):
            dev_results.extend(res[:n_real])
        dev_s = time.perf_counter() - t0

        row = {"gain": gain, "blank_bias": blank_bias, "utts": len(utts),
               "decode_frames": int(P)}
        row["native"] = backend_row(cfg, all_sents, nat_results, nat_s)
        row["device"] = backend_row(cfg, all_sents, dev_results, dev_s)
        results = {"native": nat_results, "device": dev_results}
        if lattice is not None:
            t0 = time.perf_counter()
            lat_results = _host_decode(lattice, host_logits)
            row["lattice"] = backend_row(cfg, all_sents, lat_results, time.perf_counter() - t0)
            results["lattice"] = lat_results
        row["top1_agreement"] = round(
            float(np.mean([
                (d[0].sentence if d else "") == (n[0].sentence if n else "")
                for d, n in zip(dev_results, nat_results)
            ])), 4,
        )
        emit(row)
        ladder.append({**row, "results": results, "posteriors": host_logits})
    return ladder


def main(argv=None) -> Dict[str, object]:
    """Returns {"rows": [per-gain rows], "summary": the summary line}."""
    args = build_parser().parse_args(argv)

    from ..decode.lmbeam_device import DeviceLexiconBeamSearch
    from ..runtime import NativeLexiconBeamSearch
    from ..utils.config import DecodeConfig
    from ..utils.device import resolve_device
    from .world import build_world, make_planted_utts

    device = resolve_device(args.device)
    # the connected pipeline's searcher knobs
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=args.nbest,
                       beam_width=args.beam_width, beam=17.0, first_beam_size=8,
                       sum_mode=False)
    gains = [float(g) for g in args.gains.split(",")]
    max_h = args.max_homophones or (6 if (args.adversarial or args.real_lexicon) else 4)
    (lex, lm, lm_unpruned, wl, arpa, arpa_unpruned, lexp, rng,
     _) = build_world(args.vocab, args.order, adversarial=args.adversarial,
                      real_lexicon=args.real_lexicon)
    utts = make_planted_utts(lex, wl, rng, args.utts, args.bins)

    native = NativeLexiconBeamSearch(arpa, lexp, cfg, max_homophones=max_h,
                                     rescore_arpa=arpa_unpruned)
    lattice = None
    if args.lattice:
        lat_cfg = cfg.replace(beam_width=args.lattice_width, lattice_beam=12.0,
                              lattice_nbest=True)
        lattice = NativeLexiconBeamSearch(arpa, lexp, lat_cfg, max_homophones=max_h,
                                          rescore_arpa=arpa_unpruned, state_key="ngram")
    dev = DeviceLexiconBeamSearch(lex, lm, cfg, max_homophones=max_h,
                                  rescore_lm=lm_unpruned, state_key=args.state_key,
                                  device=device)
    ladder = run_ladder(cfg, utts, gains, args.blank_bias, args.device_batch, args.bins,
                        native, dev, lattice, device=device,
                        emit=lambda row: print(json.dumps(row), flush=True))
    rows = [{k: v for k, v in r.items() if k not in ("results", "posteriors")}
            for r in ladder]
    tail = {
        "summary": "quality_ladder",
        "vocab": args.vocab, "order": args.order,
        "beam_width": args.beam_width, "nbest": args.nbest,
        "backend": device.type,
        "gains": gains,
        "device_wer_by_gain": {str(r["gain"]): r["device"]["wer"] for r in rows},
        "native_wer_by_gain": {str(r["gain"]): r["native"]["wer"] for r in rows},
        "min_top1_agreement": min(r["top1_agreement"] for r in rows),
    }
    print(json.dumps(tail), flush=True)
    return {"rows": rows, "summary": tail}


if __name__ == "__main__":
    main()
