"""The device-resident batched beam search against the native C++ host
decoder.

Counterpart of ``scripts/bench_device_decode.py``, with its options and
printed lines. A head-to-head on the same synthetic utterances with a
trained model's CTC timing (blank-dominated frames,
``data.synthetic.ctc_logprobs``): sentences/s for
``DeviceLexiconBeamSearch.decode_batch`` (with blank-skip frame compaction
and first-beam pruning) and for the C++ ``NativeLexiconBeamSearch``, plus
their exact-match counts. The reference's end-to-end rate is ~1.4
sentences/s (RTX 4090 + Redis pipeline, evaluate_model.py:185).

    python -m b2txt_tpu_torch.scripts.bench_device_decode --vocab 2000 --batch 32 --utts 96
    python -m b2txt_tpu_torch.scripts.bench_device_decode --vocab 125000 --batch 16 --utts 32

``--device`` (new) says where the device searcher runs: the CUDA card by
default (an error without one), ``cpu`` on request; ``backend`` is the torch
device type. ``device_compile_s`` is the first batch's decode (there is
nothing to compile). The world is this driver's own (``build_world`` here:
an unpruned LM, no rescore LM), not bench.py's. The lines are the JAX
driver's; ``main(argv)`` returns the last one.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


def build_world(vocab_size: int, order: int, seed: int = 0, adversarial: bool = False):
    import tempfile

    from ..lm import Lexicon
    from ..lm.ngram import NGramLM
    from ..runtime import train_ngram_native
    from ..utils.phonemes import LOGIT_TO_PHONEME

    rng = np.random.default_rng(seed)
    if adversarial:
        # CMUdict collision statistics: homophone classes to 6, prefix
        # words, Zipf-ranked shortness (data/adversarial.py)
        from ..data.adversarial import homophone_lexicon, lexicon_stats

        words, by_freq = homophone_lexicon(rng, vocab_size)
        print(json.dumps(lexicon_stats(words)), flush=True)
        lex = Lexicon.from_words(words)
        wl = by_freq
    else:
        phones = LOGIT_TO_PHONEME[1:40]
        words = {}
        while len(words) < vocab_size:
            L = rng.integers(3, 10)  # CMUdict-like lengths (see world.build_world)
            pron = [phones[i] for i in rng.integers(0, 39, L)]
            words["w" + "".join(p.lower() for p in pron)] = pron
        lex = Lexicon.from_words(words)
        wl = list(words.keys())
    tmp = tempfile.mkdtemp()
    corpus_path = os.path.join(tmp, "corpus.txt")
    n_sents = max(3000, vocab_size // 10)
    with open(corpus_path, "w") as f:
        for _ in range(n_sents):
            f.write(" ".join(
                wl[i] for i in rng.integers(0, vocab_size, rng.integers(3, 10))
            ) + "\n")
        perm = rng.permutation(vocab_size)  # every word LM-covered
        for i in range(0, vocab_size, 6):
            f.write(" ".join(wl[j] for j in perm[i : i + 6]) + "\n")
    arpa = os.path.join(tmp, "lm.arpa")
    train_ngram_native(corpus_path, arpa, order=order)
    lm = NGramLM.from_arpa(arpa)
    lexp = os.path.join(tmp, "lexicon.txt")
    with open(lexp, "w") as f:
        for w, p in words.items():
            f.write(f"{w.upper()}  {' '.join(p)}\n")
    return lex, lm, wl, arpa, lexp, rng


def make_utts(lex, wl, rng, n_utts: int, words_per: int = 6):
    from ..data.synthetic import ctc_logprobs

    utts = []
    for _ in range(n_utts):
        sw = [wl[i] for i in rng.integers(0, len(wl), words_per)]
        ids = lex.sentence_to_phonemes(" ".join(sw))
        lp = ctc_logprobs(rng, ids, hot=12.0, noise=0.4)
        utts.append((" ".join(sw), lp))
    return utts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.bench_device_decode",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--vocab", type=int, default=2000)
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--utts", type=int, default=96)
    p.add_argument("--beam_width", type=int, default=128)
    p.add_argument("--first_beam", type=int, default=8)
    p.add_argument("--skip", type=float, default=0.98)
    p.add_argument("--blank_penalty", type=float, default=9.0)
    p.add_argument("--nbest", type=int, default=20)
    p.add_argument("--viterbi", action="store_true",
                   help="Kaldi-style max path merge (sum_mode=False)")
    p.add_argument("--skip_native", action="store_true")
    p.add_argument("--skip_device", action="store_true")
    p.add_argument("--adversarial", action="store_true",
                   help="homophone-dense CMUdict-statistics lexicon + Zipfian sentences "
                        "(data/adversarial.py)")
    p.add_argument("--max_homophones", type=int, default=6)
    p.add_argument("--device", default=None,
                   help="where the device searcher runs: the CUDA card by default, "
                        "'cpu' to run on the CPU")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)

    from ..utils.config import DecodeConfig
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.time()
    lex, lm, wl, arpa, lexp, rng = build_world(args.vocab, args.order,
                                               adversarial=args.adversarial)
    print(f"world built in {time.time() - t0:.1f}s "
          f"(vocab {args.vocab}, trie nodes {lex.n_nodes})", flush=True)
    utts = make_utts(lex, wl, rng, args.utts)
    mean_T = np.mean([lp.shape[0] for _, lp in utts])

    cfg = DecodeConfig(
        acoustic_scale=0.325, blank_penalty=args.blank_penalty,
        ctc_blank_skip_threshold=args.skip, nbest=args.nbest,
        beam_width=args.beam_width, beam=17.0,
        first_beam_size=args.first_beam, sum_mode=not args.viterbi,
    )
    out = {"vocab": args.vocab, "order": args.order, "batch": args.batch,
           "utts": args.utts, "beam_width": args.beam_width,
           "first_beam": args.first_beam, "skip": args.skip,
           "merge": "viterbi" if args.viterbi else "logsum",
           "blank_penalty": args.blank_penalty,
           "world": "adversarial" if args.adversarial else "uniform",
           "mean_frames": round(float(mean_T), 1),
           "backend": device.type}

    # ---- the native C++ host decoder
    if not args.skip_native:
        from ..runtime import NativeLexiconBeamSearch

        t0 = time.time()
        dec = NativeLexiconBeamSearch(arpa, lexp, cfg, max_homophones=args.max_homophones)
        out["native_load_s"] = round(time.time() - t0, 2)
        correct = 0
        t0 = time.time()
        for sent, lp in utts:
            dec.reset()
            dec.decode(lp)
            r = dec.finish_decoding()
            correct += bool(r) and r[0].sentence == sent
        dt = time.time() - t0
        out["native_sentences_per_sec"] = round(len(utts) / dt, 2)
        out["native_exact"] = f"{correct}/{len(utts)}"
        print(json.dumps(out), flush=True)

    # ---- the device batched decoder
    if not args.skip_device:
        from ..decode.lmbeam_device import DeviceLexiconBeamSearch

        t0 = time.time()
        dev = DeviceLexiconBeamSearch(lex, lm, cfg, max_homophones=args.max_homophones,
                                      device=device)
        out["device_build_s"] = round(time.time() - t0, 2)

        B = args.batch
        T = max(lp.shape[0] for _, lp in utts)
        batches = []
        for start in range(0, len(utts), B):
            chunk = utts[start : start + B]
            while len(chunk) < B:
                chunk = chunk + [chunk[0]]
            lens = np.array([lp.shape[0] for _, lp in chunk], np.int32)
            arr = np.full((B, T, 41), -20.0, np.float32)
            for i, (_, lp) in enumerate(chunk):
                arr[i, : lp.shape[0]] = lp
            batches.append((arr, lens, [s for s, _ in chunk]))

        # the first batch once, untimed
        t0 = time.time()
        dev.decode_batch(batches[0][0], batches[0][1])
        out["device_compile_s"] = round(time.time() - t0, 1)
        print("compiled in", out["device_compile_s"], "s", flush=True)

        correct = 0
        n_done = 0
        t0 = time.time()
        # software-pipelined: batch j+1's frames are issued before batch j's
        # fetch and extraction (decode_batches)
        for (arr, lens, sents), res in zip(
            batches, dev.decode_batches([(a, l) for a, l, _ in batches])
        ):
            for s, r in zip(sents, res):
                correct += bool(r) and r[0].sentence == s
                n_done += 1
        dt = time.time() - t0
        out["device_sentences_per_sec"] = round(n_done / dt, 2)
        out["device_exact"] = f"{correct}/{n_done}"

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
