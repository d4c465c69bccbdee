"""CTC prefix beam search — host (numpy) reference implementation.

Parity target: ``runtime/core/decoder/ctc_prefix_beam_search.{h,cc}`` (the
reference's LM-free fallback searcher, selected when no TLG graph is supplied —
brain_speech_decoder.cc:23-25). Semantics: per-prefix (s, ns) log scores
(blank-/non-blank-ending), viterbi scores and per-symbol timestamps, first-beam
topk pruning over symbols and second-beam pruning over prefixes. Validated
against the hand-computed example in ctc_prefix_beam_search_test.cc.

The TPU-resident vectorized version lives in ``prefix_beam_jax.py``; this
module is the correctness oracle and the small-input fallback.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

NEG_INF = -float("inf")


def log_add(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


@dataclass
class PrefixScore:
    """Score bundle for one prefix: total (s/ns) and viterbi (v_s/v_ns) paths."""

    s: float = NEG_INF       # ending in blank
    ns: float = NEG_INF      # ending in non-blank
    v_s: float = NEG_INF     # viterbi, blank-ending
    v_ns: float = NEG_INF    # viterbi, non-blank-ending
    cur_token_prob: float = NEG_INF
    times_s: List[int] = field(default_factory=list)
    times_ns: List[int] = field(default_factory=list)

    @property
    def score(self) -> float:
        return log_add(self.s, self.ns)

    @property
    def viterbi_score(self) -> float:
        return max(self.v_s, self.v_ns)

    @property
    def times(self) -> List[int]:
        return self.times_s if self.v_s > self.v_ns else self.times_ns


class CtcPrefixBeamSearch:
    """Stateful incremental prefix beam search over chunks of log-probs."""

    def __init__(self, blank: int = 0, first_beam_size: int = 10, second_beam_size: int = 10):
        self.blank = blank
        self.first_beam_size = first_beam_size
        self.second_beam_size = second_beam_size
        self.reset()

    def reset(self) -> None:
        self.abs_time_step = 0
        root = PrefixScore(s=0.0, ns=NEG_INF, v_s=0.0, v_ns=0.0)
        self.cur_hyps: Dict[Tuple[int, ...], PrefixScore] = {(): root}
        self._update_outputs()

    def search(self, logp: np.ndarray) -> None:
        """Advance over a (T, C) chunk of log-probabilities."""
        logp = np.asarray(logp)
        assert logp.ndim == 2
        for t in range(logp.shape[0]):
            self._step(logp[t])
            self.abs_time_step += 1
        self._update_outputs()

    def _step(self, lp: np.ndarray) -> None:
        next_hyps: Dict[Tuple[int, ...], PrefixScore] = {}
        k = min(self.first_beam_size, lp.shape[0])
        top_ids = np.argpartition(-lp, k - 1)[:k]

        def get(prefix):
            if prefix not in next_hyps:
                next_hyps[prefix] = PrefixScore()
            return next_hyps[prefix]

        for cid in top_ids:
            cid = int(cid)
            prob = float(lp[cid])
            for prefix, ps in self.cur_hyps.items():
                if cid == self.blank:
                    nxt = get(prefix)
                    nxt.s = log_add(nxt.s, ps.score + prob)
                    nxt.v_s = ps.viterbi_score + prob
                    nxt.times_s = list(ps.times)
                elif prefix and cid == prefix[-1]:
                    # repeat absorbed into the same prefix
                    n1 = get(prefix)
                    n1.ns = log_add(n1.ns, ps.ns + prob)
                    if n1.v_ns < ps.v_ns + prob:
                        n1.v_ns = ps.v_ns + prob
                        if n1.cur_token_prob < prob:
                            n1.cur_token_prob = prob
                            n1.times_ns = list(ps.times_ns)
                            n1.times_ns[-1] = self.abs_time_step
                    # blank-separated repeat extends the prefix
                    n2 = get(prefix + (cid,))
                    n2.ns = log_add(n2.ns, ps.s + prob)
                    if n2.v_ns < ps.v_s + prob:
                        n2.v_ns = ps.v_s + prob
                        n2.cur_token_prob = prob
                        n2.times_ns = list(ps.times_s) + [self.abs_time_step]
                else:
                    nxt = get(prefix + (cid,))
                    nxt.ns = log_add(nxt.ns, ps.score + prob)
                    if nxt.v_ns < ps.viterbi_score + prob:
                        nxt.v_ns = ps.viterbi_score + prob
                        nxt.cur_token_prob = prob
                        nxt.times_ns = list(ps.times) + [self.abs_time_step]

        ranked = sorted(next_hyps.items(), key=lambda kv: kv[1].score, reverse=True)
        self.cur_hyps = dict(ranked[: self.second_beam_size])

    def _update_outputs(self) -> None:
        ranked = sorted(self.cur_hyps.items(), key=lambda kv: kv[1].score, reverse=True)
        self.hypotheses = [list(p) for p, _ in ranked]
        self.likelihood = [ps.score for _, ps in ranked]
        self.viterbi_likelihood = [ps.viterbi_score for _, ps in ranked]
        self.times = [list(ps.times) for _, ps in ranked]

    def finalize(self) -> None:
        self._update_outputs()


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    beam_size: int = 10,
    blank: int = 0,
    first_beam_size: Optional[int] = None,
) -> List[Tuple[List[int], float]]:
    """One-shot convenience: returns [(ids, log_prob)] best-first."""
    searcher = CtcPrefixBeamSearch(
        blank=blank,
        first_beam_size=first_beam_size or beam_size,
        second_beam_size=beam_size,
    )
    searcher.search(log_probs)
    return list(zip(searcher.hypotheses, searcher.likelihood))
