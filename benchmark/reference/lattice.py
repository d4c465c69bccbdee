"""Frozen copy of b2txt_tpu_torch/decode/lattice.py (the searcher's lattice
bookkeeping), kept for the benchmark's plain reference.

Word-lattice n-best over beam-search provenance graphs.

The reference extracts its 100-deep n-best by ShortestPath over a
determinized Kaldi lattice (ctc_wfst_beam_search.cc:123-160). The lattice's
depth comes from token-passing RECOMBINATION: Kaldi's search state is the
WFST state (≈ LM context of order−1 words + position in the word), so
hypotheses with different full histories merge, and the lattice keeps the
merged-away alternatives as extra arcs. The rebuild's fixed-width searchers
historically keyed hypotheses by FULL word history, so their final pool
collapses to a handful of distinct sentences (measured 4-8 on soft
posteriors, scripts/quality_ladder.py) — far short of the reference's
nbest=100 OPT-rescore input.

This module restores lattice depth without FSTs, via a provenance GRAPH
recorded during the search (LexiconBeamSearch with state_key="ngram",
config.lattice_nbest, or record_lattice=True; native: the same machinery in
runtime/decoder.cc behind b2t_set_lattice_opt):

  * START node (id 0);
  * CLOSE nodes — a word boundary at frame t. All searchers are
    word-synchronous: a close re-enters the trie root in a canonical state
    (node 0, last=SIL, non-blank component only), so close nodes RECOMBINE
    exactly by (t, last order−1 words): from a boundary on, the search's
    future evolution is additive in the boundary score (single scalar
    source, Viterbi max algebra), and any in-edge can precede any out-edge
    with exact spliced scores. LM lookahead telescopes to zero across a
    word span, so edge weights are pure acoustic_scale·(span acoustic) +
    (word LM);
  * MERGE nodes — two hypotheses reached the same search state mid-word;
    the loser (within config.lattice_beam of the winner, Kaldi's lattice
    pruning margin) is kept as an alternative ε-edge. This is exactly the
    extra-arcs-into-a-token mechanism of lattice-faster-decoder.cc;
  * SINK — end-of-utterance candidates (</s> scored, trailing SIL optional).

Every edge stores its SPAN weight (cumulative score at the event minus the
creating hypothesis's boundary score), so any path's score is an exact sum
regardless of which alternatives were spliced. k-best paths = topological
DP with per-node top-k lists (ids are created in topological order), then
dedup by word sequence.

``forced_rank`` is the independent oracle: the exact best Viterbi rank of a
FIXED word sequence under the searcher's semantics. Lattice candidates must
never overestimate it (tests/test_lattice_nbest.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = -float("inf")


class LatticeGraph:
    """Provenance graph builder + k-best extractor (see module docstring)."""

    def __init__(self, ctx: int):
        self.ctx = ctx
        # per node: creation frame (topological tiebreak is id order)
        self.frames: List[int] = [-1]
        self.tails: List[Tuple[int, ...]] = [()]
        # in-edges per node: (src, word or -1, weight)
        self.edges: List[List[Tuple[int, int, float]]] = [[]]
        self.final_edges: List[Tuple[int, int, float]] = []
        self._close_ids: Dict[Tuple[int, Tuple[int, ...]], int] = {}

    def n_nodes(self) -> int:
        return len(self.frames)

    def close(self, parent: int, word: int, t: int, weight: float) -> int:
        """Word close at frame t; recombines by (t, new context tail)."""
        tail = (self.tails[parent] + (word,))[-self.ctx:]
        key = (t, tail)
        nid = self._close_ids.get(key)
        if nid is None:
            nid = len(self.frames)
            self._close_ids[key] = nid
            self.frames.append(t)
            self.tails.append(tail)
            self.edges.append([])
        self.edges[nid].append((parent, word, weight))
        return nid

    def merge(self, t: int,
              sources: Sequence[Tuple[int, float]]) -> int:
        """Mid-word state merge: ε-edges from each (provenance, span weight).
        Returns the merge node the surviving hypothesis now descends from."""
        nid = len(self.frames)
        self.frames.append(t)
        # tail irrelevant for merges (no recombination; closes after the
        # merge derive their tail from the WINNER's words via the searcher)
        self.tails.append(self.tails[sources[0][0]])
        self.edges.append([(src, -1, w) for src, w in sources])
        return nid

    def final(self, parent: int, word: int, weight: float) -> None:
        self.final_edges.append((parent, word, weight))

    # ------------------------------------------------------------- k-best
    def kbest(self, k: int) -> List[Tuple[Tuple[int, ...], float]]:
        """Top-k distinct word sequences by exact spliced-path score."""
        n = len(self.frames)
        # backward-reachability prune: most recorded alternatives die before
        # the utterance end (their beams were pruned) — only nodes on some
        # path to a final edge need the k-best DP (measured: the majority of
        # merge-chain nodes are unreachable at wide beams)
        live = bytearray(n)
        for src, _w, _wt in self.final_edges:
            live[src] = 1
        for nid in range(n - 1, 0, -1):  # ids topological ⇒ reverse sweep
            if live[nid]:
                for src, _w, _wt in self.edges[nid]:
                    live[src] = 1
        # per-node top-k: (score, edge_index_in_node, rank_in_src)
        best: List[List[Tuple[float, int, int]]] = [[] for _ in range(n)]
        best[0] = [(0.0, -1, -1)]
        for nid in range(1, n):          # ids are topological by construction
            if not live[nid]:
                continue
            cand: List[Tuple[float, int, int]] = []
            for ei, (src, _w, w) in enumerate(self.edges[nid]):
                for r, (s, _, _) in enumerate(best[src]):
                    cand.append((s + w, ei, r))
            cand.sort(key=lambda x: -x[0])
            best[nid] = cand[:k]

        finals: List[Tuple[float, int, int, int]] = []
        for fi, (src, _word, w) in enumerate(self.final_edges):
            for r, (s, _, _) in enumerate(best[src]):
                finals.append((s + w, fi, src, r))
        finals.sort(key=lambda x: -x[0])

        out: List[Tuple[Tuple[int, ...], float]] = []
        seen = set()
        for s, fi, nid, r in finals:
            words: List[int] = []
            cur, cr = nid, r
            ok = True
            while cur != 0:
                entries = best[cur]
                if cr >= len(entries):
                    ok = False
                    break
                _, ei, pr = entries[cr]
                src, word, _w = self.edges[cur][ei]
                if word >= 0:
                    words.append(word)
                cur, cr = src, pr
            if not ok:
                continue
            words.reverse()
            fw = self.final_edges[fi][1]
            if fw >= 0:
                words.append(fw)
            key = tuple(words)
            if not words or key in seen:
                continue
            seen.add(key)
            out.append((key, s))
            if len(out) >= k:
                break
        return out


def forced_rank(
    log_probs: np.ndarray,
    word_ids: Sequence[int],
    lexicon,
    lm,
    config,
    pron_index: int = 0,
) -> float:
    """Exact best Viterbi rank score of a FIXED word sequence under the
    searcher's semantics (blank penalty, acoustic scale, absorbed repeats,
    one re-emittable SIL per word boundary, optional leading SIL, optional
    trailing SIL / end-close, word LM at the boundary SIL, </s> at the end)
    — the independent oracle that lattice n-best scores are checked
    against: a spliced lattice path must never OVERESTIMATE this value, and
    equals it whenever the beam explored the optimal alignment.

    Valid only with blank skipping OFF (ctc_blank_skip_threshold >= 1.0):
    the searcher skips hot-blank frames (dropping their acoustic terms and
    re-inserting one synthetic blank) while this DP scores every frame, so
    under skipping a correct lattice candidate could legitimately exceed
    this value — raise rather than report a spurious overestimate."""
    import math

    from .ngram import BOS, EOS
    from .phonemes import BLANK_ID, SIL_ID_MODEL

    if getattr(config, "ctc_blank_skip_threshold", 1.0) < 1.0:
        raise ValueError(
            "forced_rank models the no-skip decode; run it with "
            "ctc_blank_skip_threshold=1.0 (the skipped frames' acoustic "
            "terms are absent from searcher scores but present in this DP)"
        )

    scale = config.acoustic_scale
    lp = np.asarray(log_probs, np.float64).copy()
    if config.blank_penalty != 1.0:
        lp[:, BLANK_ID] -= math.log(config.blank_penalty)

    # token string: [optional lead SIL] p11..p1k SIL p21.. SIL ... SIL
    # lm_at[i] = LM added when token i (a boundary SIL) is ENTERED;
    # end_lm[i] = eos-inclusive LM for end-closing right after phone token i.
    ctx = [BOS]
    tokens: List[int] = [SIL_ID_MODEL]          # optional leading SIL
    lm_at: List[float] = [0.0]
    end_lm: Dict[int, float] = {}
    for wi, w in enumerate(word_ids):
        pron = lexicon.prons[w][pron_index]
        for p in pron:
            tokens.append(p)
            lm_at.append(0.0)
        wlp = lm.logp(ctx, lexicon.words[w]) + config.length_penalty
        ctx.append(lexicon.words[w])
        if wi == len(word_ids) - 1:
            end_lm[len(tokens) - 1] = wlp + lm.logp(ctx, EOS)
        tokens.append(SIL_ID_MODEL)
        lm_at.append(wlp)
    eos = lm.logp(ctx, EOS)

    n = len(tokens)
    s = np.full(n + 1, NEG_INF)    # blank-ending, index = tokens consumed
    ns = np.full(n + 1, NEG_INF)   # non-blank-ending at token idx-1
    s[0] = 0.0
    for t in range(lp.shape[0]):
        row = lp[t]
        new_s = np.full(n + 1, NEG_INF)
        new_ns = np.full(n + 1, NEG_INF)
        for pos in range(n + 1):
            r = max(s[pos], ns[pos])
            if r == NEG_INF:
                continue
            # blank
            v = r + scale * row[BLANK_ID]
            if v > new_s[pos]:
                new_s[pos] = v
            # repeat of current token (absorbed)
            if pos > 0 and ns[pos] != NEG_INF:
                v = ns[pos] + scale * row[tokens[pos - 1]]
                if v > new_ns[pos]:
                    new_ns[pos] = v
            # extra silence: a boundary SIL may be re-EMITTED after blanks
            # (the searcher's SIL-at-root branch), with no additional LM
            if (pos > 0 and tokens[pos - 1] == SIL_ID_MODEL
                    and s[pos] != NEG_INF):
                v = s[pos] + scale * row[SIL_ID_MODEL]
                if v > new_ns[pos]:
                    new_ns[pos] = v
            # advance to next token
            if pos < n:
                c = tokens[pos]
                base = s[pos] if (pos > 0 and c == tokens[pos - 1]) else r
                if base != NEG_INF:
                    v = base + scale * row[c] + lm_at[pos]
                    if v > new_ns[pos + 1]:
                        new_ns[pos + 1] = v
            # skip the optional leading SIL: from start, enter token 1
            if pos == 0 and n > 1:
                v = r + scale * row[tokens[1]] + lm_at[1]
                if v > new_ns[2]:
                    new_ns[2] = v
        s, ns = new_s, new_ns
    best = NEG_INF
    v = max(s[n], ns[n])           # trailing silence consumed
    if v != NEG_INF:
        best = v + eos
    for pos, add in end_lm.items():
        v = max(s[pos + 1], ns[pos + 1])
        if v != NEG_INF:
            best = max(best, v + add)
    return float(best)
