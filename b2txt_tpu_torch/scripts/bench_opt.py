"""OPT-6.7b at full scale on the card, and the finalize path's throughput.

Counterpart of ``scripts/bench_opt.py``, with its options and one JSON line
per stage. The reference runs facebook/opt-6.7b in fp16 on a second GPU
inside its production decode loop (language-model-standalone.py:92-161,
:567-660); its 0.6-0.8 s/sentence baseline INCLUDES the n-gram rescore,
augment_nbest and the OPT rescoring (model_training/evaluate_model.py:185).
This drive measures the port's equivalents at the same scale:

  stage A: the full-shape OPT-6.7b forward in bf16, random weights drawn ON
           THE CARD from a seeded generator (13.3 GB; the checkpoint is not
           needed, the forward's cost does not depend on the values) →
           tokens/s, the share of the bf16 peak, and the card's memory.
  stage B: ``OPTRescorer.score`` over 100-candidate n-best lists (the
           canonical n-best, README.md:37) → OPT-rescore lists/s.
  stage D: ``--context_words``: conversational-context rescoring, the
           prefix-KV path against concatenated context + candidate.
  stage C: ``--full``: the whole finalize at the reference's scale: planted
           full-size RNN (K1) → the device beam search (unpruned pool rescore
           on the card) → augment_nbest → the α-blended OPT rescore
           (``DecoderService``, device backend) → sentences/s, per utterance
           and grouped (``--llm_group``).
  stage E: ``--lattice``: the C++ lattice n-best on the host feeding the OPT
           rescore on the card.

    python -m b2txt_tpu_torch.scripts.bench_opt --full --context_words 48
    python -m b2txt_tpu_torch.scripts.bench_opt --device cpu --opt_size tiny --nbest 8 \\
        --context_words 6 --full --vocab 300 --utts 4 --device_batch 2

Where it differs from the JAX driver: ``--device`` (new; the CUDA card by
default, an error without one, ``cpu`` on request) and ``--opt_size``
(new; ``6.7b``, or ``tiny`` for a wiring check whose numbers are not 6.7b
numbers); times are CUDA events around back-to-back forwards (stage A) and
the host clock around calls that end in their fetch (B–E), so stage A's
``compile_s`` becomes ``first_call_s``; ``mfu_est`` is against the H100's bf16
peak (``utils.profiling.H100_BF16_PEAK_FLOPS``), not the v5e's; stage A adds
``max_memory_allocated``. ``main(argv, params=...)`` takes weights already
on the card (a state dict from ``decode.opt_lm.init_params``) and returns
every stage's object, stage B's with its scores under ``"scores"`` (not
printed).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np

OPT_SIZES = ("6.7b", "tiny")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.bench_opt",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true",
                   help="stage C: end-to-end finalize pipeline at scale")
    p.add_argument("--vocab", type=int, default=125_000)
    p.add_argument("--utts", type=int, default=64)
    p.add_argument("--device_batch", type=int, default=64)
    p.add_argument("--nbest", type=int, default=100)
    p.add_argument("--context_words", type=int, default=0,
                   help="stage D: conversational-context rescore bench, prefix-KV against "
                        "concatenated at this context length")
    p.add_argument("--lattice", action="store_true",
                   help="stage E: quality-max finalize, the C++ LATTICE n-best (deep "
                        "candidate lists, decode/lattice.py) on the host feeding the OPT "
                        "rescore on the card")
    p.add_argument("--lattice_width", type=int, default=256)
    p.add_argument("--llm_group", type=int, default=96,
                   help="stage C also measures the grouped LLM finalize at this candidate "
                        "capacity (0 skips the grouped leg)")
    p.add_argument("--device", default=None,
                   help="where the model runs: the CUDA card by default, 'cpu' to run on "
                        "the CPU")
    p.add_argument("--opt_size", default="6.7b", choices=OPT_SIZES,
                   help="OPT-6.7b, or the tiny config for a wiring check")
    return p


def opt_config(size: str):
    from ..decode.opt_lm import OPTConfig

    return OPTConfig.opt_6_7b() if size == "6.7b" else OPTConfig.tiny(vocab=4096)


def stage_a_forward(cfg, model, device, reps: int = 8) -> Dict[str, object]:
    """The bf16 forward at (32, 32) and (8, 128): ms by CUDA events over
    ``reps`` forwards after one, tokens/s and the share of the bf16 peak."""
    import torch

    from ..utils.profiling import H100_BF16_PEAK_FLOPS, seconds_per_call, synchronize

    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for B, L in ((32, 32), (8, 128)):
        tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=device)
        mask = torch.ones((B, L), device=device)
        with torch.inference_mode():
            t0 = time.perf_counter()
            model(tokens, mask, torch.bfloat16)
            synchronize(device)
            first_s = time.perf_counter() - t0
            dt = seconds_per_call(lambda: model(tokens, mask, torch.bfloat16), reps, device,
                                  warmup=0)
        flops = 2 * cfg.n_params * B * L  # 2 · params · tokens (matmul-dominated)
        out[f"fwd_B{B}_L{L}"] = {
            "ms": round(dt * 1e3, 3),
            "tokens_per_s": round(B * L / dt, 1),
            "first_call_s": round(first_s, 2),
            "mfu_est": round(flops / dt / H100_BF16_PEAK_FLOPS, 3),
        }
    return out


def nbest_lists(nbest: int, rng):
    """8 lists of ``nbest`` candidates: 6 words from a 3,000-word pool, each
    candidate with one word swapped."""
    wordpool = [f"word{i}" for i in range(3000)]
    lists = []
    for _ in range(8):
        base = [wordpool[i] for i in rng.integers(0, 3000, 6)]
        cands = []
        for _ in range(nbest):
            c = list(base)
            c[rng.integers(0, len(c))] = wordpool[rng.integers(0, 3000)]
            cands.append(" ".join(c))
        lists.append(cands)
    return lists, wordpool


def main(argv: Optional[List[str]] = None, params=None) -> List[Dict[str, object]]:
    args = build_parser().parse_args(argv)
    if args.lattice and not args.full:
        args.full = True  # stage E builds on stage C's world and posteriors

    import torch

    from ..decode.opt_lm import OPTModel, OPTRescorer, init_params, word_hash_encode
    from ..utils.device import resolve_device
    from ..utils.profiling import synchronize

    device = resolve_device(args.device)
    cfg = opt_config(args.opt_size)
    n_params = cfg.n_params
    lines: List[Dict[str, object]] = []

    def emit(obj, hidden=()):
        lines.append(obj)
        print(json.dumps({k: v for k, v in obj.items() if k not in hidden}), flush=True)

    # ---- stage A: the weights drawn on the card
    t0 = time.perf_counter()
    passed_in = params is not None
    if params is None:
        params = init_params(cfg, device, torch.bfloat16,
                             torch.Generator(device=device).manual_seed(0))
    synchronize(device)
    init_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = OPTModel.from_state_dict(cfg, params, device)
    fwd = stage_a_forward(cfg, model, device)
    emit({
        "stage": "A_opt67b_forward",
        "backend": device.type,
        "opt_size": args.opt_size,
        "params": n_params,
        "hbm_gb_bf16": round(n_params * 2 / 2**30, 2),
        "init_s": round(init_s, 2),
        "weights": "passed in" if passed_in else "random bf16, drawn on the device",
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        **fwd,
    })
    del model

    # ---- stage B: 100-candidate n-best scoring
    enc = word_hash_encode(cfg.vocab_size)
    resc = OPTRescorer(cfg, params=params, encode=enc, device=device,
                       compute_dtype=torch.bfloat16, max_len=32)
    rng = np.random.default_rng(0)
    nbests, wordpool = nbest_lists(args.nbest, rng)
    t0 = time.perf_counter()
    resc.score(nbests[0])  # the first call
    b_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = [resc.score(cands) for cands in nbests]
    dt = (time.perf_counter() - t0) / len(nbests)
    emit({
        "stage": "B_opt_rescore_nbest",
        "nbest": args.nbest,
        "tokens_per_list": int(np.mean([sum(len(enc(c, 32)) for c in cs) for cs in nbests])),
        "s_per_sentence": round(dt, 4),
        "opt_rescore_sentences_per_s": round(1.0 / dt, 2),
        "first_call_s": round(b_first, 2),
        "scores_finite": bool(np.isfinite(scores).all()),
        "scores": scores,
    }, hidden=("scores",))

    if args.context_words:
        # ---- stage D: conversational-context rescoring (standalone
        # :165-199): the prefix-KV path runs the context forward once,
        # against the context inside every candidate
        ctx = " ".join(wordpool[i] for i in rng.integers(0, 3000, args.context_words))
        enc_cont = lambda t, n: enc(t, n + 1)[1:]  # noqa: E731 (drop BOS)
        presc = OPTRescorer(cfg, params=params, encode=enc, encode_cont=enc_cont,
                            device=device, compute_dtype=torch.bfloat16, max_len=512)
        cresc = OPTRescorer(cfg, params=params, encode=enc, device=device,
                            compute_dtype=torch.bfloat16, max_len=512)
        t0 = time.perf_counter()
        presc.score(nbests[0], context=ctx)
        d_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        prefix_scores = [presc.score(cands, context=ctx) for cands in nbests]
        dt_prefix = (time.perf_counter() - t0) / len(nbests)
        t0 = time.perf_counter()
        cresc.score([ctx + " " + c for c in nbests[0]])
        d_first2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        concat_scores = [cresc.score([ctx + " " + c for c in cands]) for cands in nbests]
        dt_concat = (time.perf_counter() - t0) / len(nbests)
        emit({
            "stage": "D_context_rescore",
            "context_words": args.context_words,
            "nbest": args.nbest,
            "s_per_sentence_prefix_kv": round(dt_prefix, 4),
            "s_per_sentence_concatenated": round(dt_concat, 4),
            "speedup": round(dt_concat / dt_prefix, 2),
            "first_call_s": [round(d_first, 2), round(d_first2, 2)],
            "prefix_vs_concatenated_max_abs": float(np.abs(
                np.subtract(prefix_scores, concat_scores)).max()),
        })

    if not args.full:
        return lines

    # ---- stage C: decode → on-card unpruned rescore → augment → OPT blend,
    # end to end at the reference's scale (its full finalize, standalone
    # :567-660)
    from ..decode.lmbeam_device import DeviceLexiconBeamSearch
    from ..serve.service import DecoderService
    from ..utils.config import DecodeConfig
    from .world import build_world, make_planted_utts, make_stage1

    dcfg = DecodeConfig(
        acoustic_scale=0.325, blank_penalty=90.0, nbest=args.nbest,
        beam_width=48, beam=17.0, first_beam_size=8, sum_mode=False,
        rescore=True, do_opt=True, alpha=0.55,
    )  # K=48, canonical (bench.py --beam_width)
    B, T = args.device_batch, 520
    t0 = time.perf_counter()
    (lex, lm, lm_unpruned, wl, arpa, arpa_unpruned, lexp, rng2, _) = build_world(args.vocab, 3)
    build_s = time.perf_counter() - t0
    utts = make_planted_utts(lex, wl, rng2, args.utts, T)
    run1, P, _ = make_stage1(B, T, device=device)

    # the service's device backend, on ``device`` (it attaches the unpruned LM)
    svc = DecoderService(lex, lm, dcfg, rescore_lm=lm_unpruned, llm=resc,
                         channel_order="model", searcher_backend="device",
                         searcher=DeviceLexiconBeamSearch(lex, lm, dcfg, device=device))

    batches, sizes, sents = [], [], []
    plens = np.full((B,), P, np.int32)
    for start in range(0, len(utts), B):
        chunk = utts[start : start + B]
        lab = np.stack([lab for _, lab in chunk] + [chunk[0][1]] * (B - len(chunk)))
        lp_dev = run1(lab, torch.Generator(device=device).manual_seed(5000 + start))
        batches.append((lp_dev, plens))
        sizes.append(len(chunk))
        sents.extend(s for s, _ in chunk)

    # the whole path once on batch 0, untimed
    t0 = time.perf_counter()
    svc.decode_batched_utterances(batches[:1], sizes[:1])
    warm_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    outs = svc.decode_batched_utterances(batches, sizes)
    wall = time.perf_counter() - t0
    correct = sum(o.sentence == s for o, s in zip(outs, sents))

    grouped = {}
    if args.llm_group > 0:
        # the grouped-LLM leg (output-identical): the whole pass once
        # untimed, then the same pass timed
        svc.llm_group_candidates = args.llm_group
        svc.decode_batched_utterances(batches, sizes)
        t0 = time.perf_counter()
        outs_g = svc.decode_batched_utterances(batches, sizes)
        wall_g = time.perf_counter() - t0
        svc.llm_group_candidates = 0
        grouped = {
            "grouped_llm_candidates": args.llm_group,
            "grouped_finalize_sentences_per_s": round(len(sents) / wall_g, 2),
            "grouped_s_per_sentence": round(wall_g / len(sents), 4),
            "grouped_output_identical": all(
                a.sentence == b.sentence for a, b in zip(outs, outs_g)),
        }

    emit({
        "stage": "C_full_finalize_pipeline",
        "utts": len(sents),
        "vocab": args.vocab,
        "finalize_sentences_per_s": round(len(sents) / wall, 2),
        "s_per_sentence": round(wall / len(sents), 4),
        "exact": f"{correct}/{len(sents)}",
        "includes": "device decode + on-card unpruned rescore + "
                    "augment_nbest + OPT-6.7b alpha-blend",
        "world_build_s": round(build_s, 1),
        "warm_s": round(warm_s, 1),
        **grouped,
    })

    if args.lattice:
        # ---- stage E: the quality-max finalize: the host C++ LATTICE
        # n-best (deep lists, ngram-keyed token passing) + unpruned rescore
        # + augment + OPT blend, the LLM forward of utterance i overlapping
        # utterance i+1's host search
        lat_cfg = dcfg.replace(beam_width=args.lattice_width, lattice_beam=10.0,
                               lattice_nbest=True)
        svc_lat = DecoderService(lex, lm, lat_cfg, rescore_lm=lm_unpruned, llm=resc,
                                 channel_order="model", searcher_backend="native",
                                 arpa_path=arpa, lexicon_path=lexp,
                                 llm_group_candidates=args.llm_group)
        host_lp = []
        for (lp_dev, _pl), n_real in zip(batches, sizes):
            arr = lp_dev.cpu().numpy()
            host_lp.extend(arr[i] for i in range(n_real))
        # the whole pass once untimed: the grouped calls' shapes follow the
        # group boundaries of the whole candidate stream
        svc_lat.decode_utterances(host_lp)
        t0 = time.perf_counter()
        outs_l = svc_lat.decode_utterances(host_lp)
        wall_l = time.perf_counter() - t0
        correct_l = sum(o.sentence == s for o, s in zip(outs_l, sents))
        depths = [len(o.nbest) for o in outs_l]
        emit({
            "stage": "E_lattice_finalize_pipeline",
            "utts": len(sents),
            "lattice_width": args.lattice_width,
            "finalize_sentences_per_s": round(len(sents) / wall_l, 2),
            "s_per_sentence": round(wall_l / len(sents), 4),
            "exact": f"{correct_l}/{len(sents)}",
            "mean_nbest_depth": round(float(np.mean(depths)), 1),
            "includes": "host C++ lattice n-best + unpruned rescore + "
                        "augment_nbest + OPT-6.7b alpha-blend (pipelined)",
        })
    return lines


if __name__ == "__main__":
    main()
