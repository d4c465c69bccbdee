"""Frozen copy of b2txt_tpu_torch/decode/lmbeam.py (the python searcher), kept for the
benchmark's plain reference: it does not follow later changes to the program.

Lexicon-constrained CTC beam search with n-gram fusion — host reference.

This is the TPU-framework replacement for the reference's WFST pipeline
(T∘L∘G composition + Kaldi token passing: ctc_wfst_beam_search.cc +
lattice-faster-online-decoder): instead of compiling the CTC topology, lexicon
and LM into TLG.fst, hypotheses walk the phoneme trie directly and the n-gram
LM is queried word-synchronously when SIL (the word separator) closes a word.

Semantics carried over from the reference decoder:
  * acoustic_scale multiplies acoustic log-probs during search
    (CtcWfstBeamSearchOptions, lm_decoder.cc:30-35)
  * blank_penalty subtracts log(penalty) from the blank log-prob before search
    (DecodeNumpy, lm_decoder.cc:14-37)
  * blank-frame skipping above ctc_blank_skip_threshold, with one blank frame
    re-inserted before a repeated symbol (ctc_wfst_beam_search.cc:70-121)
  * length_penalty added per emitted word
  * nbest results carry (sentence, ac_score, lm_score) like DecodeResult
    (brain_speech_decoder.h:100-108)
  * homophones branch into distinct hypotheses (the role of alternative L arcs)

The search merges alignment paths per (word history, trie node) state in
log-sum (CTC-proper) or max (Kaldi-style Viterbi) mode. A vectorized device
version lives in lmbeam_jax.py; this module is its oracle and the
small-vocabulary fallback.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .decode_config import DecodeConfig
from .lexicon import Lexicon
from .ngram import BOS, EOS, NGramLM
from .phonemes import BLANK_ID, SIL_ID_MODEL

NEG_INF = -float("inf")


def log_add(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


@dataclass
class LmHyp:
    """One hypothesis: word history + partial-word trie position.

    Ranking score r = acoustic_scale·(acoustic) + lm, kept split into
    blank-ending (s) / non-blank-ending (ns) CTC components. ac_* track the
    unscaled acoustic part for DecodeResult-style reporting.

    Under state_key='ngram' the two components may descend from DIFFERENT
    full word histories (they share only the LM-context tail), so the word
    history and cumulative LM are tracked PER COMPONENT — the Viterbi
    readout (.words/.lm) follows the max component exactly, matching
    Kaldi's one-path-per-token semantics. In history mode the pairs are
    always equal.
    """

    words_s: Tuple[int, ...] = ()
    words_ns: Tuple[int, ...] = ()
    node: int = 0
    last: int = -1
    s: float = NEG_INF
    ns: float = NEG_INF
    ac_s: float = NEG_INF
    ac_ns: float = NEG_INF
    lm_s: float = 0.0
    lm_ns: float = 0.0
    # lattice provenance (Viterbi mode): graph node id each score component
    # descends from (0 = utterance start) + the component's score AT that
    # node, so edge weights are exact span costs (decode/lattice.py)
    barc_s: int = 0
    barc_ns: int = 0
    bsc_s: float = 0.0
    bsc_ns: float = 0.0

    @property
    def words(self) -> Tuple[int, ...]:
        return self.words_s if self.s >= self.ns else self.words_ns

    @property
    def lm(self) -> float:
        return self.lm_s if self.s >= self.ns else self.lm_ns

    @property
    def score(self) -> float:
        return log_add(self.s, self.ns) if self.s != NEG_INF or self.ns != NEG_INF else NEG_INF

    @property
    def ac_score(self) -> float:
        return log_add(self.ac_s, self.ac_ns)


@dataclass
class DecodeResult:
    """Mirror of the reference DecodeResult (brain_speech_decoder.h:100-108)."""

    sentence: str
    ac_score: float
    lm_score: float


Key = Tuple[Tuple[int, ...], int, int]


class LexiconBeamSearch:
    """Stateful incremental decoder (reset / decode-chunk / finalize)."""

    def __init__(
        self,
        lexicon: Lexicon,
        lm: NGramLM,
        config: Optional[DecodeConfig] = None,
        blank: int = BLANK_ID,
        sil: int = SIL_ID_MODEL,
        sum_mode: Optional[bool] = None,
        max_homophones: int = 4,
        lm_lookahead: bool = True,
        state_key: str = "history",
        record_lattice: Optional[bool] = None,
    ):
        self.lexicon = lexicon
        self.lm = lm
        self.config = config or DecodeConfig()
        if sum_mode is not None:
            self.config = self.config.replace(sum_mode=sum_mode)
        self.blank = blank
        self.sil = sil
        self.max_homophones = max_homophones
        # hypothesis state space: "history" merges only identical full word
        # histories (the legacy cross-backend contract), "ngram" truncates
        # to the LM context (order−1 words) — Kaldi's token-passing state
        # space (lattice-faster-decoder.h), where different histories merge
        # and the merged-away alternatives become lattice depth. Top-1 is
        # exact either way (the LM context is a sufficient statistic).
        if state_key not in ("history", "ngram"):
            raise ValueError(f"state_key must be history|ngram: {state_key}")
        if state_key == "ngram" and self.config.sum_mode:
            # merging different word histories under log-sum would pool
            # distinct sentences' path mass — Viterbi only (as on device)
            raise ValueError("state_key='ngram' requires sum_mode=False")
        self.state_key = state_key
        self._ctx_len = max(getattr(lm, "order", 2) - 1, 1)
        # lattice provenance recording costs a graph append per close and a
        # node per competitive merge — on by default only when the lattice
        # can be consumed (mirrors decoder.cc's gating); pass True to use
        # nbest_lattice() with history keying
        self._record_explicit = record_lattice is not None
        if record_lattice is None:
            record_lattice = (self.config.lattice_nbest
                              or state_key == "ngram")
        self.record_lattice = record_lattice
        # LM lookahead smearing over the trie: partial words carry the best
        # reachable unigram score so they compete fairly with closed words
        # (cancels exactly at word close — net final scores are unchanged).
        if lm_lookahead:
            self.la = lexicon.lookahead_scores(lambda w: lm.logp([], w))
        else:
            import numpy as _np

            self.la = _np.zeros(lexicon.n_nodes, _np.float32)
        # per-node homophone-class members ordered by DESCENDING unigram
        # log-prob (stable: ties keep CSR order), so the max_homophones cap
        # drops the least-likely members — the SAME drop policy as the
        # device TrieArrays and the native decoder (cross-backend parity
        # when a class exceeds the cap).
        self._node_words_cache: dict = {}
        self.reset()

    def _node_words(self, node: int):
        ws = self._node_words_cache.get(node)
        if ws is None:
            ws = sorted(
                self.lexicon.node_words(node),
                key=lambda w: -self.lm.logp([], self.lexicon.words[w]),
            )
            self._node_words_cache[node] = ws
        return ws

    def set_opt(self, config: DecodeConfig) -> None:
        """Runtime reconfiguration (parity: BrainSpeechDecoder::SetOpt)."""
        if self.state_key == "ngram" and config.sum_mode:
            raise ValueError("state_key='ngram' requires sum_mode=False")
        if config.lattice_nbest and config.sum_mode:
            raise ValueError("lattice_nbest requires sum_mode=False")
        self.config = config
        # re-derive lattice recording from the new config (unless pinned by
        # the constructor arg) so set_opt(lattice_nbest=True) works like the
        # native decoder's b2t_set_lattice_opt. Enabling mid-utterance would
        # backtrace a graph that is missing every word closed so far —
        # refuse, matching the native latch-at-Reset semantics.
        if not self._record_explicit:
            want = config.lattice_nbest or self.state_key == "ngram"
            if want and not self.record_lattice and self.n_frames > 0:
                raise ValueError(
                    "cannot enable lattice recording mid-utterance; "
                    "reset() first"
                )
            self.record_lattice = want

    def reset(self) -> None:
        from .lattice import LatticeGraph

        root = LmHyp(s=0.0, ns=NEG_INF, ac_s=0.0, ac_ns=NEG_INF)
        self.hyps: Dict[Key, LmHyp] = {((), 0, -1): root}
        self.n_frames = 0
        self._finalized: Optional[List[DecodeResult]] = None
        self._pending_blank = False  # blank-skip bookkeeping
        self._graph = LatticeGraph(self._ctx_len)  # lattice provenance
        self._step_idx = 0  # counts _step calls incl. re-inserted blanks

    def _key(self, words: Tuple[int, ...], node: int, last: int) -> Key:
        if self.state_key == "ngram":
            return (words[-self._ctx_len:], node, last)
        return (words, node, last)

    # ----------------------------------------------------------------- core
    def _score(self, h: LmHyp) -> float:
        """Ranking score under the configured merge mode: CTC-proper log-sum
        of the blank/non-blank components, or Viterbi max (Kaldi token
        passing takes the best path through a state)."""
        if self.config.sum_mode:
            return h.score
        return max(h.s, h.ns)

    def _merge(self, into: Dict[Key, LmHyp], hyp: LmHyp) -> None:
        key = self._key(hyp.words, hyp.node, hyp.last)
        cur = into.get(key)
        if cur is None:
            into[key] = hyp
            return
        if self.config.sum_mode:
            cur.s = log_add(cur.s, hyp.s)
            cur.ns = log_add(cur.ns, hyp.ns)
            cur.ac_s = max(cur.ac_s, hyp.ac_s)
            cur.ac_ns = max(cur.ac_ns, hyp.ac_ns)
            return
        # Viterbi: per-component max — each component keeps its best path's
        # score, acoustic, word history, LM and boundary provenance (Kaldi
        # one-path-per-token semantics, exact under either state keying).
        # A finite loser from a DIFFERENT word boundary becomes a lattice
        # merge ε-edge when within lattice_beam of the winner (Kaldi's
        # lattice pruning margin, lattice-faster-decoder.h) — the depth
        # mechanism of the reference's determinized lattice
        lb = self.config.lattice_beam
        t = self._step_idx
        rec = self.record_lattice

        def comp(win_v, win_ac, win_b, win_bs, win_w, win_l,
                 lose_v, lose_b, lose_bs):
            if (rec and lose_v != NEG_INF and win_b != lose_b
                    and win_v - lose_v <= lb):
                m = self._graph.merge(
                    t, [(win_b, win_v - win_bs), (lose_b, lose_v - lose_bs)]
                )
                return win_v, win_ac, m, win_v, win_w, win_l
            return win_v, win_ac, win_b, win_bs, win_w, win_l

        if hyp.s > cur.s:
            (cur.s, cur.ac_s, cur.barc_s, cur.bsc_s, cur.words_s,
             cur.lm_s) = comp(
                hyp.s, hyp.ac_s, hyp.barc_s, hyp.bsc_s, hyp.words_s,
                hyp.lm_s, cur.s, cur.barc_s, cur.bsc_s)
        elif cur.s != NEG_INF:
            (cur.s, cur.ac_s, cur.barc_s, cur.bsc_s, cur.words_s,
             cur.lm_s) = comp(
                cur.s, cur.ac_s, cur.barc_s, cur.bsc_s, cur.words_s,
                cur.lm_s, hyp.s, hyp.barc_s, hyp.bsc_s)
        if hyp.ns > cur.ns:
            (cur.ns, cur.ac_ns, cur.barc_ns, cur.bsc_ns, cur.words_ns,
             cur.lm_ns) = comp(
                hyp.ns, hyp.ac_ns, hyp.barc_ns, hyp.bsc_ns, hyp.words_ns,
                hyp.lm_ns, cur.ns, cur.barc_ns, cur.bsc_ns)
        elif cur.ns != NEG_INF:
            (cur.ns, cur.ac_ns, cur.barc_ns, cur.bsc_ns, cur.words_ns,
             cur.lm_ns) = comp(
                cur.ns, cur.ac_ns, cur.barc_ns, cur.bsc_ns, cur.words_ns,
                cur.lm_ns, hyp.ns, hyp.barc_ns, hyp.bsc_ns)

    def _lm_context(self, words: Tuple[int, ...]) -> List[str]:
        # Sentence-start conditioning: G.fst decoding starts in the <s>
        # context state, so the first word scores as P(w | <s>).
        return [BOS] + [self.lexicon.words[w] for w in words]

    def _step(self, lp: np.ndarray) -> None:
        cfg = self.config
        scale = cfg.acoustic_scale
        next_hyps: Dict[Key, LmHyp] = {}

        # first-beam prune: restrict phone extensions to this frame's top-k
        # phones (threshold at the k-th best non-blank/non-SIL log-prob; SIL
        # always kept) — the reference first-pass beam, mirrored by the C++
        # (decoder.cc Step) and device (lmbeam_jax._expand) searchers.
        V = lp.shape[0]
        fb = cfg.first_beam_size
        fb_thresh = NEG_INF
        if fb > 0 and fb < V - 2:
            vals = sorted(
                (float(lp[c]) for c in range(1, V) if c != self.sil),
                reverse=True,
            )
            fb_thresh = vals[fb - 1]

        # lattice provenance is Viterbi-only and opt-in (see __init__)
        record = self.record_lattice and not cfg.sum_mode
        t_idx = self._step_idx
        for h in self.hyps.values():
            node, last = h.node, h.last
            score = self._score(h)
            ac = h.ac_score
            # max-component provenance/lineage (Viterbi); in sum mode the
            # components share lineage by construction
            if h.s >= h.ns:
                bb, bbs, bw, bl = h.barc_s, h.bsc_s, h.words_s, h.lm_s
            else:
                bb, bbs, bw, bl = h.barc_ns, h.bsc_ns, h.words_ns, h.lm_ns
            # ---- blank: stay ----
            lb = float(lp[self.blank])
            self._merge(
                next_hyps,
                LmHyp(bw, bw, node, last,
                      s=score + scale * lb, ns=NEG_INF,
                      ac_s=ac + lb, ac_ns=NEG_INF, lm_s=bl, lm_ns=bl,
                      barc_s=bb, bsc_s=bbs),
            )
            # ---- repeat of last symbol (absorbed, non-blank path) ----
            if last >= 0 and h.ns != NEG_INF:
                lc = float(lp[last])
                self._merge(
                    next_hyps,
                    LmHyp(h.words_ns, h.words_ns, node, last,
                          s=NEG_INF, ns=h.ns + scale * lc,
                          ac_s=NEG_INF, ac_ns=h.ac_ns + lc,
                          lm_s=h.lm_ns, lm_ns=h.lm_ns,
                          barc_ns=h.barc_ns, bsc_ns=h.bsc_ns),
                )
            # ---- extend with a new (or blank-separated repeated) symbol ----
            for c in range(1, lp.shape[0]):
                lc = float(lp[c])
                if c != self.sil and lc < fb_thresh:
                    continue
                base = h.s if c == last else score            # ranking base
                ac_base = h.ac_s if c == last else ac
                if c == last:
                    src_barc, src_bsc = h.barc_s, h.bsc_s
                    src_w, src_l = h.words_s, h.lm_s
                else:
                    src_barc, src_bsc, src_w, src_l = bb, bbs, bw, bl
                if base == NEG_INF:
                    continue
                if c == self.sil:
                    # SIL at root = leading/extra silence (optional-sil arc)
                    if node == 0:
                        self._merge(
                            next_hyps,
                            LmHyp(src_w, src_w, 0, self.sil,
                                  s=NEG_INF, ns=base + scale * lc,
                                  ac_s=NEG_INF, ac_ns=ac_base + lc,
                                  lm_s=src_l, lm_ns=src_l,
                                  barc_ns=src_barc, bsc_ns=src_bsc),
                        )
                    # SIL at a word-final node closes the word(s)
                    wlist = self._node_words(node)
                    ctx = self._lm_context(src_w)
                    for wid in wlist[: self.max_homophones]:
                        wlp = self.lm.logp(ctx, self.lexicon.words[wid])
                        lm_add = wlp + cfg.length_penalty
                        # swap this word's lookahead for its true LM score,
                        # re-enter the root lookahead for the next word
                        la_adj = float(self.la[0]) - float(self.la[node])
                        ns_new = base + scale * lc + lm_add + la_adj
                        arc_id = 0
                        if record:
                            arc_id = self._graph.close(
                                src_barc, wid, t_idx, ns_new - src_bsc)
                        new_w = src_w + (wid,)
                        self._merge(
                            next_hyps,
                            LmHyp(new_w, new_w, 0, self.sil,
                                  s=NEG_INF,
                                  ns=ns_new,
                                  ac_s=NEG_INF, ac_ns=ac_base + lc,
                                  lm_s=src_l + lm_add, lm_ns=src_l + lm_add,
                                  barc_ns=arc_id, bsc_ns=ns_new),
                        )
                else:
                    child = int(self.lexicon.next[node, c])
                    if child < 0:
                        continue
                    la_adj = float(self.la[child]) - float(self.la[node])
                    self._merge(
                        next_hyps,
                        LmHyp(src_w, src_w, child, c,
                              s=NEG_INF, ns=base + scale * lc + la_adj,
                              ac_s=NEG_INF, ac_ns=ac_base + lc,
                              lm_s=src_l, lm_ns=src_l,
                              barc_ns=src_barc, bsc_ns=src_bsc),
                    )

        ranked = sorted(next_hyps.values(), key=self._score, reverse=True)
        keep = ranked[: self.config.beam_width]
        if keep and self.config.beam > 0:
            cutoff = self._score(keep[0]) - self.config.beam
            keep = [h for h in keep if self._score(h) >= cutoff]
        self.hyps = {self._key(h.words, h.node, h.last): h for h in keep}
        self._step_idx += 1

    def decode(self, log_probs: np.ndarray) -> None:
        """Advance over a (T, C) chunk of *log-probs* in model channel order
        ([BLANK, phones..., SIL]). Blank penalty + blank skipping applied here
        (parity: DecodeNumpy + CtcWfstBeamSearch::Search)."""
        cfg = self.config
        lp = np.asarray(log_probs, np.float64)
        if cfg.blank_penalty != 1.0:
            lp = lp.copy()
            lp[:, self.blank] -= math.log(cfg.blank_penalty)
        for t in range(lp.shape[0]):
            row = lp[t]
            if (
                cfg.ctc_blank_skip_threshold < 1.0
                and math.exp(row[self.blank]) > cfg.ctc_blank_skip_threshold
            ):
                self._pending_blank = True
                self.n_frames += 1
                continue
            if self._pending_blank:
                # re-insert one blank frame so repeated symbols stay separated
                blank_row = np.full_like(row, -30.0)
                blank_row[self.blank] = 0.0
                self._step(blank_row)
                self._pending_blank = False
            self._step(row)
            self.n_frames += 1
        self._finalized = None

    # ------------------------------------------------------------- results
    def decoded_something(self) -> bool:
        return self.n_frames > 0 and len(self.hyps) > 0

    def _close_final_words(self) -> List[LmHyp]:
        """End-of-utterance: close hyps at word-final nodes (trailing SIL is
        optional, as in L.fst), keep root hyps, add </s> LM score. Also
        records lattice FinalRecs (Viterbi mode) for nbest_lattice()."""
        cfg = self.config
        record = self.record_lattice and not cfg.sum_mode
        if record:
            self._graph.final_edges = []  # idempotent across repeated calls
        out: Dict[Key, LmHyp] = {}
        for h in self.hyps.values():
            words, node, last = h.words, h.node, h.last
            # (candidate, boundary node + score of max component, end word)
            candidates: List[Tuple[LmHyp, int, float, int]] = []
            if h.s >= h.ns:
                bb, bbs = h.barc_s, h.bsc_s
            else:
                bb, bbs = h.barc_ns, h.bsc_ns
            if node == 0:
                candidates.append((h, bb, bbs, -1))
            else:
                ctx = self._lm_context(words)
                for wid in self._node_words(node)[: self.max_homophones]:
                    wlp = self.lm.logp(ctx, self.lexicon.words[wid]) + cfg.length_penalty
                    # same lookahead cancellation as in-search word closes, so
                    # final candidates all share the root-lookahead offset
                    # (components may carry different full histories under
                    # ngram keying but share the LM-context tail, so wlp is
                    # identical for both)
                    adj = wlp + float(self.la[0]) - float(self.la[node])
                    candidates.append((
                        replace(h, words_s=h.words_s + (wid,),
                                words_ns=h.words_ns + (wid,), node=0,
                                s=(h.s + adj if h.s != NEG_INF else NEG_INF),
                                ns=(h.ns + adj if h.ns != NEG_INF else NEG_INF),
                                lm_s=h.lm_s + wlp, lm_ns=h.lm_ns + wlp),
                        bb, bbs, wid,
                    ))
            for cand, barc, bscore, endw in candidates:
                eos_lp = self.lm.logp(self._lm_context(cand.words), EOS)
                cand = replace(
                    cand,
                    s=(cand.s + eos_lp if cand.s != NEG_INF else NEG_INF),
                    ns=(cand.ns + eos_lp if cand.ns != NEG_INF else NEG_INF),
                    lm_s=cand.lm_s + eos_lp, lm_ns=cand.lm_ns + eos_lp,
                )
                if record and self._score(cand) != NEG_INF:
                    self._graph.final(barc, endw, self._score(cand) - bscore)
                key = (cand.words, 0, cand.last)
                prev = out.get(key)
                if prev is None or self._score(cand) > self._score(prev):
                    out[key] = cand
        return sorted(out.values(), key=self._score, reverse=True)

    def nbest_lattice(self, k: Optional[int] = None) -> List[DecodeResult]:
        """Lattice n-best: k best word sequences over ALL recorded close
        events (the analogue of the reference's ShortestPath over the
        determinized lattice, ctc_wfst_beam_search.cc:123-160) — reaches
        nbest-deep candidate lists where the surviving-beam pool collapses
        to a handful of sentences. Viterbi mode only (sum_mode merges path
        mass across alignments; per-path provenance is undefined there).

        Scores: rank = acoustic_scale·ac + lm exactly (lookahead telescopes
        to zero boundary-to-boundary); lm is recomputed per sequence so
        DecodeResult carries the same (ac, lm) split as the pool."""
        if self.config.sum_mode:
            raise ValueError("lattice n-best requires sum_mode=False")
        if not self.record_lattice:
            raise ValueError(
                "lattice recording is off — construct with "
                "record_lattice=True (or state_key='ngram' / "
                "config.lattice_nbest)"
            )
        self._close_final_words()  # (re)build the graph's final edges
        k = k or self.config.nbest
        seqs = self._graph.kbest(k)
        cfg = self.config
        out: List[DecodeResult] = []
        for words, rank in seqs:
            ctx = [BOS]
            lm_total = 0.0
            for w in words:
                lm_total += (self.lm.logp(ctx, self.lexicon.words[w])
                             + cfg.length_penalty)
                ctx.append(self.lexicon.words[w])
            lm_total += self.lm.logp(ctx, EOS)
            out.append(DecodeResult(
                sentence=" ".join(self.lexicon.words[w] for w in words),
                ac_score=(rank - lm_total) / cfg.acoustic_scale,
                lm_score=lm_total,
            ))
        return out

    def finish_decoding(self) -> List[DecodeResult]:
        """Parity: FinishDecoding → FinalizeSearch n-best extraction.
        Duplicate sentences (same words, different alignment tail) keep only
        their best-scoring entry — matching the native/device searchers.
        With config.lattice_nbest (Viterbi mode), the n-best list deepens to
        the lattice k-best (nbest_lattice) instead of the surviving pool."""
        if self.config.lattice_nbest and not self.config.sum_mode:
            self._finalized = self.nbest_lattice()
            return self._finalized
        finals = self._close_final_words()
        self._finalized = []
        seen = set()
        for h in finals:
            if len(self._finalized) >= self.config.nbest:
                break
            if not h.words:
                continue
            sentence = " ".join(self.lexicon.words[w] for w in h.words)
            if sentence in seen:
                continue
            seen.add(sentence)
            self._finalized.append(
                DecodeResult(sentence=sentence, ac_score=h.ac_score, lm_score=h.lm)
            )
        return self._finalized

    def result(self) -> List[DecodeResult]:
        """Best-first results; partial (greedy word path) before finalize."""
        if self._finalized is not None:
            return self._finalized
        if not self.hyps:
            return []
        best = max(self.hyps.values(), key=self._score)
        return [
            DecodeResult(
                sentence=" ".join(self.lexicon.words[w] for w in best.words),
                ac_score=best.ac_score,
                lm_score=best.lm,
            )
        ]


def decode_numpy(
    searcher: LexiconBeamSearch, logits: np.ndarray, priors: Optional[np.ndarray] = None
) -> None:
    """Free-function mirror of lm_decoder.DecodeNumpy: log_softmax(logits) −
    priors, then advance the searcher (blank penalty handled in decode())."""
    x = np.asarray(logits, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    lp = x - np.log(np.exp(x).sum(axis=-1, keepdims=True))
    if priors is not None:
        lp = lp - priors
    searcher.decode(lp)
