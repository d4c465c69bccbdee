"""Frozen copy of b2txt_tpu_torch/lm/ngram.py, kept for the
benchmark's plain reference: it does not follow later changes to the program.

Backoff n-gram language model: scoring, training, pruning.

Replaces SRILM's ``ngram-count``/``ngram -prune`` binaries and the ARPA→G.fst
compile (``local/build_lm.sh:36-46``, ``tools/fst/make_tlg.sh``): models are
trained in-process with interpolated Kneser-Ney, loadable from any ARPA file
(including SRILM-produced ones), scored directly during beam search, and
pruned without leaving Python. All scores are natural log; backoff weights are
computed by exact normalization so that Σ_w P(w|ctx) = 1 (tested).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .arpa import NO_PROB, read_arpa, write_arpa

BOS, EOS, UNK = "<s>", "</s>", "<unk>"
_TINY = 1e-99


class NGramLM:
    """Standard backoff n-gram model over word strings.

    tables[k][(w1..wk+1)] = (logp, backoff_logweight) in natural log.
    """

    def __init__(self, tables: List[Dict[Tuple[str, ...], Tuple[float, float]]]):
        self.tables = tables
        self.order = len(tables)
        self.vocab = sorted(
            w[0] for w in tables[0] if w[0] not in (BOS,)
        )

    # ------------------------------------------------------------- scoring
    def logp(self, context: Sequence[str], word: str) -> float:
        """log P(word | context) with standard Katz backoff recursion."""
        ctx = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        if (word,) not in self.tables[0] and (UNK,) in self.tables[0]:
            word = UNK
        bo_sum = 0.0
        while True:
            gram = ctx + (word,)
            entry = self.tables[len(gram) - 1].get(gram)
            if entry is not None and entry[0] > NO_PROB + 1e-6:
                return bo_sum + entry[0]
            if not ctx:
                return bo_sum + (entry[0] if entry is not None else NO_PROB)
            bo_entry = self.tables[len(ctx) - 1].get(ctx)
            bo_sum += bo_entry[1] if bo_entry is not None else 0.0
            ctx = ctx[1:]

    def sentence_logp(
        self, words: Sequence[str], bos: bool = True, eos: bool = True
    ) -> float:
        context: List[str] = [BOS] if bos else []
        total = 0.0
        for w in list(words) + ([EOS] if eos else []):
            total += self.logp(context, w)
            context.append(w)
        return total

    def perplexity(self, sentences: Iterable[Sequence[str]]) -> float:
        total, n = 0.0, 0
        for s in sentences:
            total += self.sentence_logp(s)
            n += len(s) + 1
        return math.exp(-total / max(n, 1))

    # ---------------------------------------------------------------- I/O
    @classmethod
    def from_arpa(cls, path: str) -> "NGramLM":
        return cls(read_arpa(path))

    def to_arpa(self, path: str) -> None:
        write_arpa(path, self.tables)

    # ------------------------------------------------------------- pruning
    def prune(self, threshold: float) -> "NGramLM":
        """Weighted-difference pruning (SRILM ``ngram -prune`` analogue):
        drop a higher-order entry when
        p(ctx)·p(w|ctx)·(log p(w|ctx) − log p_backoff(w|ctx)) <= threshold.
        Backoff weights of surviving contexts are renormalized exactly."""
        new_tables: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [
            dict(self.tables[0])
        ]
        for k in range(1, self.order):
            kept: Dict[Tuple[str, ...], Tuple[float, float]] = {}
            lower = NGramLM(self.tables[:k])  # gains vs the ORIGINAL model
            for gram, (logp, bow) in self.tables[k].items():
                context, word = gram[:-1], gram[-1]
                backed = lower.logp(context[1:], word) + (
                    self.tables[k - 1].get(context, (0.0, 0.0))[1]
                )
                ctx_logp = self.tables[k - 1].get(context, (NO_PROB, 0.0))[0]
                gain = (
                    math.exp(max(ctx_logp, NO_PROB))
                    * math.exp(logp)
                    * (logp - backed)
                )
                if gain > threshold:
                    kept[gram] = (logp, bow)
            new_tables.append(kept)
        _recompute_backoffs(new_tables)
        return NGramLM(new_tables)


def _recompute_backoffs(
    tables: List[Dict[Tuple[str, ...], Tuple[float, float]]]
) -> None:
    """Set bow(ctx) = (1 − Σ_seen p(w|ctx)) / (1 − Σ_seen p_low(w|suffix))
    for every context of a higher-order entry (exact ARPA normalization)."""
    order = len(tables)
    lower_lm = NGramLM(tables[:1])
    for n in range(2, order + 1):
        by_context: Dict[Tuple[str, ...], List[Tuple[str, float]]] = defaultdict(list)
        for gram, (logp, _) in tables[n - 1].items():
            by_context[gram[:-1]].append((gram[-1], logp))
        lower_lm = NGramLM(tables[: n - 1])
        for context, entries in by_context.items():
            p_seen = sum(math.exp(lp) for _, lp in entries if lp > NO_PROB + 1e-6)
            p_low = sum(
                math.exp(lower_lm.logp(context[1:], w))
                for w, lp in entries
                if lp > NO_PROB + 1e-6
            )
            num = max(1.0 - p_seen, _TINY)
            den = max(1.0 - p_low, _TINY)
            bow = math.log(num) - math.log(den)
            prev = tables[n - 2].get(context)
            if prev is None:
                tables[n - 2][context] = (NO_PROB, bow)
            else:
                tables[n - 2][context] = (prev[0], bow)
        # contexts that are no longer contexts keep bow 0
        ctxs = set(by_context.keys())
        for gram, (lp, bw) in list(tables[n - 2].items()):
            if gram not in ctxs and abs(bw) > 1e-12:
                tables[n - 2][gram] = (lp, 0.0)


def train_ngram(
    sentences: Iterable[Sequence[str]],
    order: int = 3,
    discount: float = 0.75,
    vocab: Optional[Sequence[str]] = None,
    add_unk: bool = True,
) -> NGramLM:
    """Interpolated Kneser-Ney training (SRILM ngram-count replacement).

    ``vocab`` limits the vocabulary (-limit-vocab); OOV tokens map to <unk>
    when ``add_unk`` (-unk -map-unk "<unk>").
    """
    vocab_set = set(vocab) if vocab is not None else None
    counts: List[Counter] = [Counter() for _ in range(order)]

    for sent in sentences:
        words = [
            (UNK if (vocab_set is not None and w not in vocab_set and add_unk) else w)
            for w in sent
        ]
        if vocab_set is not None and not add_unk:
            words = [w for w in words if w in vocab_set]
        padded = [BOS] + words + [EOS]
        for n in range(1, order + 1):
            for i in range(len(padded) - n + 1):
                gram = tuple(padded[i : i + n])
                counts[n - 1][gram] += 1

    # Continuation counts: cont[k][gram] = #distinct left-extensions of the
    # (k+1)-gram `gram` (Kneser-Ney lower-order estimates).
    cont: List[Counter] = [Counter() for _ in range(order)]
    for n in range(2, order + 1):
        for gram in counts[n - 1]:
            cont[n - 2][gram[1:]] += 1

    # Unigram support: every corpus word type (incl. </s>) plus <unk>.
    vocab_words = sorted(
        {g[0] for g in counts[0] if g != (BOS,)} | ({UNK} if add_unk else set())
    )
    V = len(vocab_words)

    # the unigram normalizers do not depend on the word: summed once here,
    # not in every call (a sum over the vocabulary per word is quadratic)
    uni_total = (sum(c for g, c in counts[0].items() if g != (BOS,)) if order == 1
                 else sum(cont[0].values()))
    uni_types = len(cont[0])

    def unigram_p(w: str) -> float:
        if order == 1:
            total = uni_total
            return (counts[0].get((w,), 0) + 0.5) / (total + 0.5 * V)
        total = uni_total
        nt = uni_types
        disc = max(cont[0].get((w,), 0) - discount, 0.0) / max(total, 1)
        lam = discount * nt / max(total, 1)
        return disc + lam / V  # uniform floor over the V supported types

    def level_p(n: int, gram: Tuple[str, ...]) -> float:
        """Interpolated probability at order n for a *seen* n-gram."""
        if n == 1:
            return unigram_p(gram[0])
        context = gram[:-1]
        if n == order:
            c = counts[n - 1].get(gram, 0)
            total = ctx_totals[n - 1].get(context, 0)
        else:
            c = cont[n - 1].get(gram, 0)
            total = cont_ctx_totals[n - 1].get(context, 0)
        if total == 0:
            return level_p(n - 1, gram[1:])
        nt = type_counts[n - 1].get(context, 0)
        disc = max(c - discount, 0.0) / total
        lam = discount * nt / total
        return disc + lam * level_p(n - 1, gram[1:])

    ctx_totals: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(order)]
    for gram, c in counts[order - 1].items():
        ctx_totals[order - 1][gram[:-1]] += c
    cont_ctx_totals: List[Dict[Tuple[str, ...], int]] = [
        defaultdict(int) for _ in range(order)
    ]
    for n in range(2, order):
        for gram, c in cont[n - 1].items():
            cont_ctx_totals[n - 1][gram[:-1]] += c
    type_counts: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(order)]
    for n in range(2, order + 1):
        src = counts[n - 1] if n == order else cont[n - 1]
        for gram in src:
            type_counts[n - 1][gram[:-1]] += 1

    tables: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [
        dict() for _ in range(order)
    ]
    # Unigrams over the supported types; <s> present with NO_PROB (context only).
    for w in vocab_words:
        tables[0][(w,)] = (math.log(max(unigram_p(w), _TINY)), 0.0)
    tables[0][(BOS,)] = (NO_PROB, 0.0)

    for n in range(2, order + 1):
        for gram in counts[n - 1]:
            if gram[-1] == BOS:
                continue  # never predict <s>
            p = level_p(n, gram)
            tables[n - 1][gram] = (math.log(max(p, _TINY)), 0.0)

    _recompute_backoffs(tables)
    return NGramLM(tables)


def uniform_unigram(words: Sequence[str]) -> NGramLM:
    """Uniform 1-gram over a word list (reference recipe:
    s0/uniform_1gram/make_corpus.py)."""
    words = list(dict.fromkeys(words))
    logp = math.log(1.0 / (len(words) + 1))  # +1 for </s>
    tables: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [
        {(w,): (logp, 0.0) for w in words}
    ]
    tables[0][(EOS,)] = (logp, 0.0)
    tables[0][(BOS,)] = (NO_PROB, 0.0)
    return NGramLM(tables)
