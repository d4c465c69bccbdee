"""Adversarial decode fixture: homophone-dense lexicon + Zipfian corpus.

The round-2 bench world used random 3-9-phone pronunciations, which make
near-unique words — friendlier than English. This generator reproduces the
collision statistics of the REAL production lexicon (the reference's CMUdict,
examples/speech/s0/dict.txt, 125,071 words measured stress-stripped):

  * 26.7% of words share a pronunciation with at least one other word
    (homophone class sizes over distinct prons: 88.0% singletons, 8.7% pairs,
    2.1% triples, 0.7% quadruples, ~0.5% larger, up to 10);
  * pronunciation lengths 1-14 with the measured histogram (mean 6.4,
    p10 4, p90 9 — including the 1-3-phone mass real English has: "a", "eye",
    "ohio" class words) and SHORT words assigned to FREQUENT ranks, so the
    beam constantly crosses prefix-word boundaries ("a"/"at"/"ate");
  * ≥25% of pronunciations are strict prefixes of other pronunciations
    (arises from the length mix + shared stems; extension words are injected
    to guarantee it);
  * corpus word frequencies follow Zipf-Mandelbrot p(r) ∝ 1/(r+2.7)^1.05,
    so the n-gram LM is peaked, unlike the round-2 uniform world.

This is the fixture for the see/sea–their/there regime where word-lattice
hypothesis mass matters (reference rescoring path:
brain_speech_decoder.cc:61-101).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.phonemes import LOGIT_TO_PHONEME

# measured on the reference CMUdict (stress stripped), see module docstring
PRON_LEN_HIST: Dict[int, float] = {
    1: 49, 2: 993, 3: 6831, 4: 16325, 5: 25876, 6: 27140, 7: 20936,
    8: 15166, 9: 9225, 10: 5174, 11: 2890, 12: 1563, 13: 788, 14: 340,
}
CLASS_SIZE_P = [0.880, 0.087, 0.021, 0.007, 0.003, 0.002]  # sizes 1..6
EXTENSION_FRAC = 0.25   # fraction of prons built by extending an existing one
ZIPF_A, ZIPF_B = 1.05, 2.7


def homophone_lexicon(
    rng: np.random.Generator, vocab_size: int, max_class: int = 6
) -> Tuple[Dict[str, List[str]], List[str]]:
    """Returns ({word: pronunciation}, words_by_frequency_rank).

    Homophones are injected by reusing pronunciations per the measured class
    size distribution; prefix words by extending existing pronunciations.
    Frequency ranks correlate with shortness (short words rank early), so a
    Zipfian corpus exercises them constantly.
    """
    phones = LOGIT_TO_PHONEME[1:40]
    lens = np.array(sorted(PRON_LEN_HIST))
    len_p = np.array([PRON_LEN_HIST[k] for k in lens], np.float64)
    len_p /= len_p.sum()
    class_p = np.array(CLASS_SIZE_P[:max_class], np.float64)
    class_p /= class_p.sum()

    prons: List[Tuple[str, ...]] = []
    seen = set()
    words: Dict[str, List[str]] = {}
    pron_of: List[List[str]] = []

    def new_pron() -> Tuple[str, ...]:
        for _ in range(64):
            if prons and rng.random() < EXTENSION_FRAC:
                base = list(prons[rng.integers(0, len(prons))])
                ext = int(rng.integers(1, 4))
                p = tuple(base + [phones[i] for i in rng.integers(0, 39, ext)])
            else:
                L = int(rng.choice(lens, p=len_p))
                p = tuple(phones[i] for i in rng.integers(0, 39, L))
            if p not in seen:
                return p
        # fall back to a guaranteed-fresh long pronunciation
        while True:
            p = tuple(phones[i] for i in rng.integers(0, 39, 12))
            if p not in seen:
                return p

    n_words = 0
    widx = 0
    while n_words < vocab_size:
        p = new_pron()
        seen.add(p)
        prons.append(p)
        size = int(rng.choice(np.arange(1, len(class_p) + 1), p=class_p))
        size = min(size, vocab_size - n_words)
        for _ in range(size):
            w = f"w{widx:06d}"
            widx += 1
            words[w] = list(p)
            pron_of.append(list(p))
            n_words += 1

    # frequency ranks: short first, with jitter (English: frequent == short)
    names = list(words)
    lengths = np.array([len(words[w]) for w in names], np.float64)
    rank_key = lengths + rng.normal(0, 1.5, len(names))
    by_freq = [names[i] for i in np.argsort(rank_key, kind="stable")]
    return words, by_freq


def zipf_word_sampler(rng: np.random.Generator, n_words: int):
    """Returns draw(k) → k word RANKS under Zipf-Mandelbrot."""
    ranks = np.arange(n_words, dtype=np.float64)
    p = 1.0 / np.power(ranks + ZIPF_B, ZIPF_A)
    p /= p.sum()

    def draw(k: int) -> np.ndarray:
        return rng.choice(n_words, size=k, p=p)

    return draw


def zipf_corpus(
    rng: np.random.Generator,
    by_freq: List[str],
    n_sentences: int,
    words_per: Tuple[int, int] = (3, 10),
) -> List[List[str]]:
    draw = zipf_word_sampler(rng, len(by_freq))
    out = []
    for _ in range(n_sentences):
        k = int(rng.integers(*words_per))
        out.append([by_freq[r] for r in draw(k)])
    return out


def lexicon_stats(words: Dict[str, List[str]]) -> Dict[str, float]:
    """Collision statistics of a {word: pron} lexicon, for reporting."""
    from collections import defaultdict

    bypron = defaultdict(list)
    for w, p in words.items():
        bypron[tuple(p)].append(w)
    multi = sum(len(ws) for ws in bypron.values() if len(ws) > 1)
    sorted_prons = sorted(bypron)
    prefix = 0
    for i in range(len(sorted_prons) - 1):
        p, q = sorted_prons[i], sorted_prons[i + 1]
        if len(q) > len(p) and q[: len(p)] == p:
            prefix += 1
    lens = [len(p) for p in bypron]
    return {
        "words": len(words),
        "distinct_prons": len(bypron),
        "homophone_word_frac": round(multi / max(len(words), 1), 4),
        "prefix_pron_frac": round(prefix / max(len(bypron), 1), 4),
        "mean_pron_len": round(float(np.mean(lens)), 2),
    }
