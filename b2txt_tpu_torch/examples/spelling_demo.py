#!/usr/bin/env python
"""Letter-spelling decode recipe: the reference's handwriting/spelling-LM
example rebuilt on the port.

Counterpart of ``examples/spelling_demo.py``. The reference ships two
letter-level recipes: the handwriting sibling
(language_model/examples/handwriting/s0/run.sh — char-level TLG graph, char
order remap documented at runtime/server/x86/python/test.py:30-33) and the
speech spelling LM (examples/speech/s0/spelling_lm/make_corpus.py) used to
spell out-of-vocabulary words letter by letter. Here the same capability
needs no FSTs:

  1. the spelling lexicon: each 'word' is a LETTER pronounced by its spoken
     name (Lexicon.letters(), lm/lexicon.py — a..z -> EY, B IY, S IY, ...);
  2. a character-level n-gram trained on words spelled as letter sequences
     (the reference trains its char LM the same way, just via SRILM);
  3. the standard decoder service over that lexicon+LM (the native searcher,
     on the host): phoneme posteriors of spoken letter names decode to
     letter sequences, reassembled into words.

    python -m b2txt_tpu_torch.examples.spelling_demo [--n 20]
"""

import argparse

import numpy as np

# a small spelled-word corpus; with the reference checkout present the demo
# trains on real dictionary words instead
FALLBACK_WORDS = [
    "speech", "brain", "text", "decode", "neural", "prosthesis", "letter",
    "spelling", "signal", "electrode", "phoneme", "language", "model",
    "beam", "search", "lattice", "vocabulary", "sentence", "silence",
    "computer", "science", "research", "participant", "trial", "session",
]


def spelled_corpus(n_words: int = 4000):
    from ..data.real_assets import have_real_dict, load_real_dict

    if have_real_dict():
        words = [w for w in load_real_dict(words_only=True)
                 if w.isalpha()][:n_words]
    else:
        words = FALLBACK_WORDS
    return [list(w) for w in words]


def main(n_utts: int = 20, seed: int = 0, verbose: bool = True) -> int:
    from ..data.synthetic import ctc_logprobs
    from ..lm import Lexicon, train_ngram
    from ..serve.service import DecoderService
    from ..utils.config import DecodeConfig

    rng = np.random.default_rng(seed)

    # 1. spelling lexicon: 26 letter-'words' with spoken-name pronunciations
    lex = Lexicon.letters()

    # 2. char-level 3-gram over spelled words (the reference's char-dict
    #    build_lm.sh path, dict_type='char')
    corpus = spelled_corpus()
    lm = train_ngram(corpus, order=3)

    # 3. ordinary decode service over the letter lexicon — spelling is a
    #    lexicon/LM swap, not a different engine
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=90.0, nbest=10,
                       beam_width=48, first_beam_size=8, sum_mode=False)
    # posteriors below are in MODEL channel order ([BLANK, phones..., SIL]);
    # the default channel_order="lm" would apply the reference's wire-format
    # permutation (rearrange_speech_logits_pt)
    svc = DecoderService(lex, lm, cfg, searcher_backend="native",
                         channel_order="model")

    test_words = ["".join(w) for w in corpus[: max(200, n_utts)]]
    n_utts = min(n_utts, len(test_words))  # fallback corpus is small
    picks = [test_words[i]
             for i in rng.choice(len(test_words), n_utts, replace=False)]
    n_ok = 0
    for word in picks:
        ids = lex.sentence_to_phonemes(" ".join(word))  # spell it out
        lp = ctc_logprobs(rng, ids, noise=0.3)
        svc.reset()
        out = svc.decode_utterance(lp)
        spelled = out.sentence.replace(" ", "")
        ok = spelled == word
        n_ok += ok
        if verbose:
            print(f"  {word:16s} -> {spelled:16s} {'OK' if ok else 'MISS'}")
    if verbose:
        print(f"spelled-word decode: {n_ok}/{n_utts} exact")
    return n_ok


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=20)
    args = p.parse_args()
    main(args.n)
