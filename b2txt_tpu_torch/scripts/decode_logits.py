"""Offline decode of saved logits — the reference's
``brain_speech_decoder_main.cc`` CLI equivalent: load .npy logits (one file
per utterance, (T, 41) model channel order, or a single (N, T, 41) array),
run the beam search, write a hyp file (``name<TAB>sentence`` a line).

Counterpart of ``scripts/decode_logits.py``, with the same options plus
``--device``: ``--backend device`` searches on the CUDA card (the port's
``DeviceLexiconBeamSearch``) unless ``--device cpu`` is given; the native
and python backends search on the host.

    python -m b2txt_tpu_torch.scripts.decode_logits --lm_dir lm/3gram --logits "logits/*.npy" \\
        --out hyps.txt [--acoustic_scale 0.325 --blank_penalty 90 --nbest 10] \\
        [--backend native|python|device] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.decode_logits",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--lm_dir", required=True)
    p.add_argument("--logits", required=True, help="glob of .npy files")
    p.add_argument("--out", required=True)
    p.add_argument("--acoustic_scale", type=float, default=0.325)
    p.add_argument("--blank_penalty", type=float, default=90.0)
    p.add_argument("--ctc_blank_skip_threshold", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--nbest", type=int, default=10)
    p.add_argument("--beam_width", type=int, default=128)
    p.add_argument("--backend", default="native",
                   choices=["native", "python", "device"])
    p.add_argument("--device", default=None,
                   help="where --backend device searches: the CUDA card by default, "
                        "'cpu' to search on the CPU")
    return p


def make_decoder(args, cfg):
    arpa = os.path.join(args.lm_dir, "lm.arpa")
    lexp = os.path.join(args.lm_dir, "lexicon.txt")
    if args.backend == "native":
        from ..runtime import NativeLexiconBeamSearch

        return NativeLexiconBeamSearch(arpa, lexp, cfg)
    from ..lm import Lexicon, NGramLM

    lm = NGramLM.from_arpa(arpa)
    lexicon = Lexicon.from_file(lexp, vocab=lm.vocab)
    if args.backend == "python":
        from ..decode.lmbeam import LexiconBeamSearch

        return LexiconBeamSearch(lexicon, lm, cfg)
    from ..decode.lmbeam_device import DeviceLexiconBeamSearch

    return DeviceLexiconBeamSearch(lexicon, lm, cfg, device=args.device)


def main(argv=None) -> dict:
    """Returns {utterance name: top-1 sentence}, in file order."""
    args = build_parser().parse_args(argv)

    from ..utils.config import DecodeConfig

    cfg = DecodeConfig(
        acoustic_scale=args.acoustic_scale, blank_penalty=args.blank_penalty,
        ctc_blank_skip_threshold=args.ctc_blank_skip_threshold,
        length_penalty=args.length_penalty, nbest=args.nbest,
        beam_width=args.beam_width,
    )
    dec = make_decoder(args, cfg)

    files = sorted(glob.glob(args.logits))
    utterances = []
    for f in files:
        arr = np.load(f)
        if arr.ndim == 3:
            utterances.extend((f"{f}[{i}]", arr[i]) for i in range(arr.shape[0]))
        else:
            utterances.append((f, arr))

    hyps = {}
    t0 = time.time()
    with open(args.out, "w") as out:
        for name, logits in utterances:
            x = logits - logits.max(-1, keepdims=True)
            lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
            dec.reset()
            dec.decode(lp.astype(np.float32))
            res = dec.finish_decoding()
            best = res[0].sentence if res else ""
            hyps[name] = best
            out.write(f"{name}\t{best}\n")
            print(f"{name}: {best}")
    dt = time.time() - t0
    print(f"Decoded {len(utterances)} utterances in {dt:.2f}s "
          f"({len(utterances)/max(dt,1e-9):.1f}/s) -> {args.out}")
    return hyps


if __name__ == "__main__":
    main()
