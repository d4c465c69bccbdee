"""Large-LM scale drive: build → load → decode a ≥100M-entry ARPA n-gram.

Counterpart of ``scripts/drive_large_lm.py``, with its options and printed
lines. The reference holds its 5-gram in SRILM's in-memory representation at
~300 GB of RAM (reference README.md:101). The native runtime packs each
n-gram into one 16-byte sorted record (runtime/decoder.cc NGramLM::Rec), so
the same entry count costs ~1.6 GB per 100M n-grams plus the vocabulary
table. This drive writes a synthetic ARPA at that scale (``write_arpa``, a
copy of the JAX driver's), loads it through the native loader, reports RSS
bytes/entry, and decodes through the beam search; with ``--device`` it also
streams the ARPA into ``DeviceNGram``'s bucket tables on the card and
decodes through ``DeviceLexiconBeamSearch`` there.

    python -m b2txt_tpu_torch.scripts.drive_large_lm --entries 100000000 --vocab 50000 \\
        --order 5 --device
    python -m b2txt_tpu_torch.scripts.drive_large_lm --entries 200000 --vocab 2000 --device --on cpu

Where it differs from the JAX driver: ``--arpa`` defaults to
``large_lm.arpa`` in the temporary directory (``TMPDIR``); ``--on`` (new)
says where ``--device`` runs, the CUDA card by default (an error without
one) or ``cpu``; ``hbm_gb`` / ``hbm_bytes_per_entry`` are the card's memory
of the table and the unigram arrays; the device line adds
``native_top1_equal``, the device utterances whose top-1 equals the native
decoder's on the same posteriors (when the native decoder ran). ``main(argv)``
returns the printed JSON objects.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def write_arpa(path: str, vocab: int, counts: "list[int]",
               words: "list[str] | None" = None) -> int:
    """Unique synthetic n-grams up to order len(counts)+1: 1-grams = vocab;
    higher orders enumerate word chains w_i, w_{i+1+d}, w_{i+2+d+e}, ... by
    deterministic successor offsets (unique by construction), so the decoder
    walking a chain w_s w_{s+1} w_{s+2} … hits real max-order entries while
    off-chain queries exercise the backoff path. counts = [n2, n3, n4, n5…].
    ``words`` overrides the synthetic vocabulary (e.g. the real CMUdict word
    list for the production-scale dryrun).

    Reference analogue: the production 5-gram held in ~300 GB SRILM RAM
    (README.md:101, language_model/README.md:47)."""
    rng = np.random.default_rng(0)
    if words is None:
        words = [f"w{i:06d}" for i in range(vocab)]
    else:
        words = list(words)[:vocab]
        vocab = len(words)
    order = len(counts) + 1
    t0 = time.time()
    written = [0] * (order + 1)  # per gram order
    with open(path, "w", buffering=1 << 22) as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={vocab + 3}\n")
        for k, n in enumerate(counts):
            f.write(f"ngram {k + 2}={n}\n")
        f.write("\n\\1-grams:\n")
        f.write("-2.0 <s> -0.5\n-2.0 </s>\n-7.0 <unk>\n")
        uni = -np.log10(vocab) - rng.random(vocab).astype(np.float32)
        for i in range(0, vocab, 100000):
            f.write("".join(
                f"{uni[j]:.4f} {words[j]} -0.40\n"
                for j in range(i, min(i + 100000, vocab))
            ))
        written[1] = vocab + 3

        for k, n_k in enumerate(counts):
            g = k + 2  # gram order of this section
            f.write(f"\n\\{g}-grams:\n")
            per = -(-n_k // vocab)  # entries rooted at each start word
            done = 0
            bow = " -0.30" if g < order else ""
            for i in range(vocab):
                if done >= n_k:
                    break
                m = min(per, n_k - done)
                ps = -0.8 - 2.0 * rng.random(m).astype(np.float32)
                rows = []
                for d in range(m):
                    # chain: i, i+1, i+2, …, i+g-2, then a varying tail
                    chain = [words[(i + t) % vocab] for t in range(g - 1)]
                    chain.append(words[(i + g - 2 + 1 + d) % vocab])
                    rows.append(f"{ps[d]:.4f} {' '.join(chain)}{bow}\n")
                f.write("".join(rows))
                done += m
            written[g] = done
    n_total = sum(written)
    print(f"ARPA written: order {order}, {n_total:,} entries, "
          f"{os.path.getsize(path) / 1e9:.2f} GB in {time.time() - t0:.0f}s",
          flush=True)
    return n_total


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.drive_large_lm",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--entries", type=int, default=100_000_000)
    p.add_argument("--vocab", type=int, default=50_000)
    p.add_argument("--order", type=int, default=3, choices=[2, 3, 4, 5])
    p.add_argument("--arpa", default=None,
                   help="the ARPA file to write (default: large_lm.arpa in the temporary "
                        "directory)")
    p.add_argument("--keep", action="store_true")
    p.add_argument("--device", action="store_true",
                   help="also load into DeviceNGram (bucket tables on the card) and decode "
                        "through DeviceLexiconBeamSearch there")
    p.add_argument("--on", default=None,
                   help="where --device runs: the CUDA card by default, 'cpu' to run on "
                        "the CPU")
    p.add_argument("--skip_native", action="store_true")
    p.add_argument("--reuse_arpa", action="store_true",
                   help="reuse an existing --arpa file from a prior --keep run")
    return p


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    args = build_parser().parse_args(argv)
    if args.arpa is None:
        args.arpa = os.path.join(tempfile.gettempdir(), "large_lm.arpa")

    from ..runtime import NativeLexiconBeamSearch
    from ..utils.config import DecodeConfig
    from ..utils.device import resolve_device
    from ..utils.phonemes import LOGIT_TO_PHONEME

    # where the device half runs, checked before minutes of ARPA writing
    device = resolve_device(args.on) if args.device else None
    lines: List[Dict[str, object]] = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    # split higher-order entries: 30% bigrams, the rest over 3..order
    rest = args.entries - args.vocab - 3
    n2 = rest * 3 // 10
    hi = args.order - 2  # sections above the 2-grams
    counts = [n2] + [(rest - n2) // hi] * hi if hi else [rest]
    counts[-1] += rest - sum(counts)
    if args.reuse_arpa and os.path.exists(args.arpa):
        print(f"reusing {args.arpa}", flush=True)
    else:
        write_arpa(args.arpa, args.vocab, counts)

    # lexicon: random unique pronunciations for the full vocabulary
    rng = np.random.default_rng(1)
    phones = LOGIT_TO_PHONEME[1:40]
    lexp = args.arpa + ".lexicon.txt"
    prons = {}
    with open(lexp, "w", buffering=1 << 20) as f:
        for i in range(args.vocab):
            L = int(rng.integers(3, 8))
            pron = [phones[j] for j in rng.integers(0, 39, L)]
            f.write(f"W{i:06d}  {' '.join(pron)}\n")
            prons[f"w{i:06d}"] = pron

    from ..lm.lexicon import PHONE_TO_ID

    def make_utt(rng):
        """Words along the consecutive chains so the LM walk hits max-order
        entries; off-chain transitions exercise the backoff path."""
        start = int(rng.integers(0, args.vocab))
        ws = [f"w{(start + k) % args.vocab:06d}" for k in range(5)]
        ids = []
        for w in ws:
            ids.extend(PHONE_TO_ID[p] for p in prons[w])
            ids.append(40)
        rows = []
        for pid in ids:
            for _ in range(2):
                r = np.full(41, -12.0, np.float32)
                r[pid] = 0.0
                rows.append(r)
            b = np.full(41, -12.0, np.float32)
            b[0] = 0.0
            rows.append(b)
        lp = np.stack(rows)
        return " ".join(ws), lp - np.log(np.exp(lp).sum(-1, keepdims=True))

    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=10,
                       beam_width=128, beam=17.0, first_beam_size=8)

    dec = None
    if not args.skip_native:
        rss0 = rss_bytes()
        t0 = time.time()
        dec = NativeLexiconBeamSearch(args.arpa, lexp, cfg)
        load_s = time.time() - t0
        rss = rss_bytes() - rss0
        entries = dec.lm_entries
        print(f"native loaded {entries:,} entries in {load_s:.0f}s; "
              f"RSS +{rss / 1e9:.2f} GB = {rss / max(entries, 1):.1f} B/entry", flush=True)

        n_utts, correct = 24, 0
        t0 = time.time()
        for _ in range(n_utts):
            sent, lp = make_utt(rng)
            dec.reset()
            dec.decode(lp)
            r = dec.finish_decoding()
            correct += bool(r) and r[0].sentence == sent
        dt = time.time() - t0
        emit({
            "backend": "native", "order": args.order,
            "entries": entries, "rss_gb": round(rss / 1e9, 2),
            "bytes_per_entry": round(rss / max(entries, 1), 1),
            "load_s": round(load_s, 1),
            "decode_sentences_per_sec": round(n_utts / dt, 2),
            "decode_exact": f"{correct}/{n_utts}",
        })

    if args.device:
        from ..decode.lmbeam_device import DeviceLexiconBeamSearch
        from ..lm import Lexicon
        from ..lm.device_ngram import DeviceNGram
        from ..utils.profiling import synchronize

        t0 = time.time()
        lex = Lexicon.from_words(prons)
        lex_s = time.time() - t0
        t0 = time.time()
        dev_lm = DeviceNGram.from_arpa_streaming(args.arpa, lex, device=device)
        synchronize(device)
        load_s = time.time() - t0
        hbm = dev_lm.table_bytes + sum(t.numel() * t.element_size()
                                       for t in (dev_lm.uni_logp, dev_lm.uni_bow))
        n_dev = dev_lm.n_entries  # counted at build: the table never comes back
        print(f"device LM: {n_dev:,} entries streamed+packed in {load_s:.0f}s; "
              f"card memory {hbm / 1e9:.2f} GB = {hbm / max(n_dev, 1):.1f} B/entry "
              f"(lexicon {lex_s:.0f}s)", flush=True)

        t0 = time.time()
        dev = DeviceLexiconBeamSearch(lex, None, cfg, dev_lm=dev_lm, max_homophones=2,
                                      device=device)
        build_s = time.time() - t0
        B = 16
        utts = [make_utt(rng) for _ in range(B * 2)]
        T = max(lp.shape[0] for _, lp in utts)
        n_done = correct = 0
        t_first = None
        t0 = time.time()
        for s0 in range(0, len(utts), B):
            chunk = utts[s0 : s0 + B]
            lens = np.array([lp.shape[0] for _, lp in chunk], np.int32)
            arr = np.full((B, T, 41), -20.0, np.float32)
            for i, (_, lp) in enumerate(chunk):
                arr[i, : lp.shape[0]] = lp
            res = dev.decode_batch(arr, lens)
            if t_first is None:
                t_first = time.time() - t0  # the first batch, untimed
                t0 = time.time()
                continue
            for (sent, _), r in zip(chunk, res):
                n_done += 1
                correct += bool(r) and r[0].sentence == sent
            results = res
        dt = time.time() - t0
        fig = {
            "backend": "device", "device": str(device), "order": args.order,
            "entries": n_dev, "hbm_gb": round(hbm / 1e9, 2),
            "hbm_bytes_per_entry": round(hbm / max(n_dev, 1), 1),
            "stream_pack_s": round(load_s, 1),
            "trie_build_s": round(build_s + lex_s, 1),
            "compile_s": round(t_first or 0, 1),
            "decode_sentences_per_sec": round(n_done / dt, 2),
            "decode_exact": f"{correct}/{n_done}",
        }
        if dec is not None:
            # the timed batch's posteriors through the native decoder
            same = []
            for (_, lp), r in zip(utts[B:], results):
                dec.reset()
                dec.decode(lp)
                n = dec.finish_decoding()
                same.append((n[0].sentence if n else None) == (r[0].sentence if r else None))
            fig["native_top1_equal"] = f"{sum(same)}/{len(same)}"
        emit(fig)

    if not args.keep:
        os.remove(args.arpa)
        os.remove(lexp)
    return lines


if __name__ == "__main__":
    main()
