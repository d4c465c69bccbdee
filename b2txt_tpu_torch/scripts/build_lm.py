"""Build language-model artifacts from a text corpus + pronunciation dict.

Counterpart of ``scripts/build_lm.py``, with the same options and outputs,
over the port's ``lm`` package (``--native``: its C++ trainer). It stands in
for the reference's graph build (SRILM ngram-count/prune → arpa2fst →
T∘L∘G): no FST composition; the outputs are the ARPA model(s) and a
filtered lexicon that the beam searches use directly. All on the host.

    python -m b2txt_tpu_torch.scripts.build_lm --corpus corpus.txt --dict cmudict.txt \\
        --out lm/my_3gram --order 3 [--prune 1e-9] [--uniform-from-wordlist words.txt]

Outputs in --out: lm.arpa, lm_unpruned.arpa (when pruning), lexicon.txt
"""

from __future__ import annotations

import argparse
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.build_lm",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--corpus", help="raw text corpus (one doc/line)")
    p.add_argument("--dict", required=True, help="CMUdict-style pronunciation dict")
    p.add_argument("--out", required=True)
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--prune", type=float, default=0.0)
    p.add_argument("--discount", type=float, default=0.75)
    p.add_argument("--no-format", action="store_true",
                   help="corpus is already normalized (one sentence/line)")
    p.add_argument("--native", action="store_true",
                   help="train with the C++ runtime (SRILM-scale corpora)")
    p.add_argument("--uniform-from-wordlist", default=None,
                   help="build a uniform 1-gram over this word list instead")
    return p


def main(argv=None):
    """Returns the LM written to ``--out/lm.arpa``."""
    p = build_parser()
    args = p.parse_args(argv)

    from ..lm import format_corpus, load_lexicon_file, train_ngram, uniform_unigram
    from ..lm.lexicon import strip_stress

    os.makedirs(args.out, exist_ok=True)
    lex_raw = load_lexicon_file(args.dict)
    print(f"Loaded {len(lex_raw)} lexicon words from {args.dict}")

    if args.uniform_from_wordlist:
        with open(args.uniform_from_wordlist) as f:
            words = [w.strip().lower() for w in f if w.strip()]
        words = [w for w in words if w in lex_raw]
        lm = uniform_unigram([w.upper() for w in words])
        vocab_lower = set(words)
    else:
        if not args.corpus:
            p.error("--corpus required unless --uniform-from-wordlist")
        with open(args.corpus, errors="ignore") as f:
            lines = f.readlines()
        if args.no_format:
            sentences = [l.strip().upper().split() for l in lines if l.strip()]
        else:
            lex_words = set(lex_raw.keys())
            sentences = [
                s.split() for s in format_corpus(lines, lexicon_words=lex_words)
            ]
        print(f"Training {args.order}-gram on {len(sentences)} sentences...")
        if args.native:
            from ..lm import NGramLM
            from ..runtime import train_ngram_native

            with tempfile.TemporaryDirectory(prefix="build_lm_") as tmp:
                cpath = os.path.join(tmp, "corpus.txt")
                with open(cpath, "w") as f:
                    f.write("\n".join(" ".join(s) for s in sentences) + "\n")
                apath = os.path.join(tmp, "lm.arpa")
                train_ngram_native(cpath, apath, order=args.order,
                                   discount=args.discount)
                lm = NGramLM.from_arpa(apath)
        else:
            lm = train_ngram(sentences, order=args.order, discount=args.discount)
        vocab_lower = {w.lower() for w in lm.vocab}

    # filtered lexicon covering the LM vocabulary
    lex_path = os.path.join(args.out, "lexicon.txt")
    n = 0
    with open(lex_path, "w") as f:
        for w, prons in sorted(lex_raw.items()):
            if w in vocab_lower:
                for pron in prons:
                    f.write(f"{w.upper()}  {' '.join(strip_stress(pron))}\n")
                    n += 1
    print(f"Wrote {n} pronunciations to {lex_path}")

    if args.prune > 0:
        lm.to_arpa(os.path.join(args.out, "lm_unpruned.arpa"))
        lm = lm.prune(args.prune)
        print(f"Pruned with threshold {args.prune}")
    lm.to_arpa(os.path.join(args.out, "lm.arpa"))
    sizes = " ".join(f"{i+1}-grams={len(t)}" for i, t in enumerate(lm.tables))
    print(f"Wrote {os.path.join(args.out, 'lm.arpa')}: {sizes}")
    return lm


if __name__ == "__main__":
    main()
