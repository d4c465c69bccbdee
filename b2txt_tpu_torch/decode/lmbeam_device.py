"""Lexicon-constrained CTC beam search with n-gram fusion, on the device.

Counterpart of ``b2txt_tpu/decode/lmbeam_jax.py``. The lexicon trie and the
n-gram bucket tables are tensors on the searcher's device, and each frame
expands a fixed-width beam of hypotheses for a whole batch of utterances at
once:

    stay / repeat         (K)        blank or absorbed-repeat emissions
    extend-phone          (K×V)      trie transitions (L.fst arcs), the
                                     frame's first beam of phones
    silence-at-root       (K)        optional-silence arcs
    close-word            (K×H)      SIL at word-final trie nodes; one
                                     candidate per homophone with its n-gram
                                     score added word-synchronously (G.fst)

Candidates sort by their 64-bit identity key, duplicate states merge per
segment (max, or a log-sum-exp in ``sum_mode``), and the K best survive.
Backpointers (parent, word) stay on the device for the whole utterance and
come to the host once per batch for sentence reconstruction.

What differs from the JAX module, and why:

- ``vmap`` over utterances is a batch dimension written out; ``lax.scan``
  over frames issues device work without syncing with the host, so
  ``decode_batches`` overlaps batch j+1's frames with batch j's host
  extraction as JAX's asynchronous dispatch does. On the card, with a
  ``DeviceNGram``, the frame step is one hand-written kernel, K6
  (``ops/beam_step.py``), where ``_expand`` op by op is ~600; a batch's
  frames are replays of one CUDA graph of it (``_FrameGraph``, captured
  through ``utils/cuda_graphs.py``), and the streaming ``decode`` launches
  it a frame. Elsewhere (the CPU, the sharded search) the frames are a
  Python loop over ``_expand``, the kernel's plain version.
- The three-key ``lax.sort`` is two stable sorts: on the Viterbi rank, then
  on one int64 key ordering (k1, k2) as unsigned 32-bit pairs. Each
  segment's last element is therefore its best path, the representative
  whose payload survives (the ngram-keying invariant).
- The segmented ``associative_scan`` is a per-segment reduction:
  ``scatter_reduce(amax)`` (exact) for the Viterbi ranking columns and the
  acoustic ones, a max-shifted log-sum-exp for the ranking columns in
  ``sum_mode`` (it rounds differently from the pairwise scan; the n-best
  scores stay within 1e-4 of the JAX package's). In Viterbi each acoustic
  column takes its ranking column's best path's, as the host searchers
  merge; the JAX package takes the acoustic column's own max, so a merged
  beam there can report more acoustic score than any one of its paths.
- The first beam extends by every phone at or above the frame's
  ``first_beam``-th best log-prob, ties included, as the host searchers
  threshold it (the JAX package takes exactly ``first_beam`` by top-k; bf16
  posteriors tie often). ``_expand`` lays out all V phones, those outside
  the beam at NEG: its shapes need no host read of the beam's size.
- Each frame drops the beams more than ``beam`` below the row's best, as
  the host searchers do (the JAX package keeps all K).
- Ties: ``torch.topk``, K6 and the JAX top-k order equal scores
  differently, so beams whose score is the NEG floor carry other payloads,
  and beams of equal totals may take other slots; they never
  outrank a real hypothesis.
- No time bucketing: shapes need not be static, so a batch runs exactly its
  longest utterance's frames.
- ``sharded_decode_batch`` runs one process per rank of a ``DeviceMesh``
  axis (the JAX package's ``shard_map``): each rank prepares the WHOLE
  batch, so every rank runs the same frames and issues the same probes, and
  decodes its rows against its block of the bucket table
  (``lm.device_ngram.ShardedNGram``).

Score semantics mirror the host LexiconBeamSearch (lmbeam.py), this
module's correctness oracle (tested).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..lm.device_ngram import DeviceNGram, hash_ctx, hash_extend
from ..lm.lexicon import Lexicon
from ..lm.ngram import NGramLM
from ..ops.beam_step import beam_step, workspace
from ..ops.segment import sorted_segment_sum
from ..utils.config import DecodeConfig
from ..utils.cuda_graphs import Captured, GraphCache
from ..utils.device import resolve_device
from ..utils.device import upload as _upload
from ..utils.phonemes import BLANK_ID, SIL_ID_MODEL
from ..utils.profiling import count, span
from .lmbeam import DecodeResult

NEG = -1.0e30
_INT32_MIN = -(1 << 31)
GRAPH_CACHE = 8      # captured frame steps a searcher keeps
GRAPH_T_STEP = 64    # a captured step's frame capacity, in multiples of this


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    m_safe = m.clamp(min=NEG)
    out = m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))
    return out.masked_fill(m <= NEG, NEG)


def _key64(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the unsigned order of the 32-bit pair
    (k1, k2) held as int32: flip k1's sign bit, scale by 2^32 (no overflow:
    |k1 ^ INT32_MIN| <= 2^31), add k2's unsigned value."""
    return (k1 ^ _INT32_MIN).long() * (1 << 32) + (k2.long() & 0xFFFFFFFF)


def _seg_merge4(sc: torch.Tensor, starts: torch.Tensor, sum_mode: bool):
    """The segmented merge of the candidates' four score columns (s, ns,
    ac_s, ac_ns), ``sc`` (B*N, 4) in sorted order, whose segments begin
    where ``starts`` (B, N) is True. In ``sum_mode`` the ranking columns
    merge by log-sum-exp and the acoustic ones by max. In Viterbi each
    ranking column keeps its best path, and each acoustic column that
    path's acoustic score (the host searcher's per-component merge; among
    paths of equal score, the highest acoustic). Returns (merged (B*N, 4)
    by segment, the ranking total of each segment (B*N,), each candidate's
    segment (B*N,))."""
    B, N = starts.shape
    dev = sc.device
    seg = (starts.cumsum(1) - 1
           + torch.arange(B, device=dev)[:, None] * N).reshape(-1)   # (B*N,)
    if not sum_mode:
        seg2 = seg[:, None].expand(-1, 2)
        best = torch.full((B * N, 2), -math.inf, dtype=torch.float32, device=dev)
        best.scatter_reduce_(0, seg2, sc[:, :2], "amax")
        # an acoustic score counts only where its path holds the column's max
        ac = torch.where(sc[:, :2] == best[seg], sc[:, 2:], -math.inf)
        best_ac = torch.full((B * N, 2), -math.inf, dtype=torch.float32, device=dev)
        best_ac.scatter_reduce_(0, seg2, ac, "amax")
        return torch.cat([best, best_ac], 1), torch.maximum(best[:, 0], best[:, 1]), seg
    merged = torch.full((B * N, 4), -math.inf, dtype=torch.float32, device=dev)
    merged.scatter_reduce_(0, seg[:, None].expand(-1, 4), sc, "amax")
    m = merged[:, :2]
    m_safe = m.clamp(min=NEG)
    tot = sorted_segment_sum(torch.exp(sc[:, :2] - m_safe[seg]), seg, B * N)
    lse = (m_safe + torch.log(tot)).masked_fill(m <= NEG, NEG)
    return torch.cat([lse, merged[:, 2:]], 1), _logaddexp(lse[:, 0], lse[:, 1]), seg


class LmBeamState(NamedTuple):
    """One batch of beams; every field is (B, K, ...)."""

    h1: torch.Tensor     # int32: uint32 word-history hash (chained over closed words)
    h2: torch.Tensor
    node: torch.Tensor   # int32 trie node
    last: torch.Tensor   # int32 last emitted phone (-1 none)
    ctx: torch.Tensor    # (B, K, order-1) int32 LM context, -1 left-padded
    s: torch.Tensor      # ranking score, blank-ending
    ns: torch.Tensor     # ranking score, non-blank-ending
    ac_s: torch.Tensor   # unscaled acoustic (viterbi), blank-ending
    ac_ns: torch.Tensor
    lm: torch.Tensor     # accumulated LM score


def _select(mask: torch.Tensor, new: LmBeamState, old: LmBeamState) -> LmBeamState:
    """Per utterance: ``new`` where mask (B,) is set, else ``old``."""
    m2 = mask[:, None]
    return LmBeamState(*(torch.where(m2[..., None] if n.dim() == 3 else m2, n, o)
                         for n, o in zip(new, old)))


@dataclass
class TrieArrays:
    """Gather-optimized trie: besides the plain next/words_at arrays (used by
    finalize), the frame step reads ONE packed node row per beam plus one
    [child, lookahead] pair per (beam, phone):

      node_pack[node]   = [wids(H) | uni_logp_bits(H) | la_bits] (2H+1 int32)
      next_la2[node, c] = [child, la_child_bits]                 (2 int32)
    """

    next: torch.Tensor       # (n_nodes, V) int32
    words_at: torch.Tensor   # (n_nodes, H) int32, -1 padded
    node_pack: torch.Tensor  # (n_nodes, 2H+1) int32
    next_la2: torch.Tensor   # (n_nodes, V, 2) int32: [child, la_child_bits]
    n_dropped: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.next, self.words_at, self.node_pack, self.next_la2))

    @classmethod
    def build(
        cls,
        lexicon: Lexicon,
        max_homophones: int,
        la: np.ndarray,
        uni_logp: np.ndarray,
        device: torch.device,
    ) -> "TrieArrays":
        n_nodes = lexicon.n_nodes
        counts = np.diff(lexicon.word_offsets).astype(np.int64)
        # cap H at the lexicon's LARGEST homophone class: empty homophone
        # slots cost probes every frame and change nothing
        H = max(1, min(max_homophones, int(counts.max(initial=1))))
        # vectorized CSR → (n_nodes, H) scatter. Within each node the class
        # members are ordered by DESCENDING unigram log-prob first, so a cap
        # below the real class size drops the least-likely homophones
        uni_of_word = np.asarray(uni_logp)[
            np.clip(lexicon.word_list, 0, None)]
        order = np.lexsort(
            (-uni_of_word,
             np.repeat(np.arange(n_nodes, dtype=np.int64), counts))
        )
        word_list = lexicon.word_list[order]
        words_at = np.full((n_nodes, H), -1, np.int32)
        node_of = np.repeat(np.arange(n_nodes, dtype=np.int64), counts)
        pos = (np.arange(len(word_list), dtype=np.int64)
               - np.repeat(lexicon.word_offsets[:-1].astype(np.int64), counts))
        keep = pos < H
        words_at[node_of[keep], pos[keep]] = word_list[keep]
        dropped = int(np.maximum(counts - H, 0).sum())

        la32 = np.asarray(la, np.float32)
        uni_w = uni_logp[np.clip(words_at, 0, None)].astype(np.float32)
        node_pack = np.concatenate(
            [words_at, uni_w.view(np.int32), la32.view(np.int32)[:, None]],
            axis=1,
        ).astype(np.int32)
        la_child = la32[np.clip(lexicon.next, 0, None)]
        next_la2 = np.stack(
            [lexicon.next, la_child.view(np.int32)], axis=2
        ).astype(np.int32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        return cls(next=put(lexicon.next), words_at=put(words_at),
                   node_pack=put(node_pack), next_la2=put(next_la2), n_dropped=dropped)


def compact_blank_skip(
    lp: np.ndarray,
    lengths: np.ndarray,
    blank: int,
    thresh: float,
    log_blank_penalty: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Blank-skip frame compaction for batched decode.

    Applies the blank penalty, then per utterance drops frames whose
    (penalized) blank probability exceeds ``thresh`` and re-inserts ONE
    synthetic blank frame before the next processed frame — exactly the
    streaming skip semantics (reference: ctc_wfst_beam_search.cc:70-121;
    host oracle: lmbeam.py decode()).

    lp: (B, T, C) log-probs. Returns (lp_out (B, T', C), new_lengths) with
    the blank penalty already applied (run the scan with log_blank_penalty=0).
    """
    lp = np.array(lp, np.float32, copy=True)
    B, T, C = lp.shape
    if log_blank_penalty != 0.0:
        lp[:, :, blank] -= log_blank_penalty

    # within each utterance every frame is either kept or skipped, so a
    # synthetic blank precedes kept frame t iff frame t-1 was skipped;
    # trailing skipped frames emit nothing
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]   # (B, T)
    skip = valid & (np.exp(lp[:, :, blank]) > thresh)
    keep = valid & ~skip
    insert = keep & np.pad(skip[:, :-1], ((0, 0), (1, 0)))
    end = np.cumsum(keep.astype(np.int64) + insert.astype(np.int64), axis=1)
    lens_out = end[:, -1].astype(np.int32) if T else np.zeros((B,), np.int32)

    T_out = max(1, int(lens_out.max(initial=0)))
    out = np.full((B, T_out, C), -30.0, np.float32)
    out[:, :, blank] = 0.0  # padding AND inserted-blank rows are this template
    bidx, tidx = np.nonzero(keep)
    out[bidx, end[bidx, tidx] - 1] = lp[bidx, tidx]
    return out, lens_out


def _compress_traces(traces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, B, K) word-emission traces (−1 = none) → per-beam word-id lists
    (B, K, L) int32 −1-padded plus their lengths (B, K). One vectorized numpy
    pass (stable argsort floats kept words to the front per column); L is
    bucketed to a multiple of 8."""
    mask = traces >= 0
    lens = mask.sum(axis=0).astype(np.int32)                    # (B, K)
    L = -(-max(1, int(lens.max(initial=0))) // 8) * 8
    if traces.shape[0] < L:  # short streaming decodes: pad T up to the bucket
        pad = L - traces.shape[0]
        traces = np.concatenate(
            [traces, np.full((pad,) + traces.shape[1:], -1, traces.dtype)]
        )
        mask = np.concatenate(
            [mask, np.zeros((pad,) + mask.shape[1:], bool)]
        )
    order = np.argsort(~mask, axis=0, kind="stable")            # kept first
    gathered = np.take_along_axis(traces, order[:L], axis=0)    # (L, B, K)
    out = np.where(np.arange(L)[:, None, None] < lens[None], gathered, -1)
    return np.moveaxis(out, 0, -1).astype(np.int32), lens


def _backtrace_all(parents: np.ndarray, words: np.ndarray) -> np.ndarray:
    """Vectorized word backtrace for every final beam of every utterance.

    parents/words: (T, B, K). Returns (T, B, K) int32 where [:, b, k] is the
    chronological word-emission trace of final beam k (−1 = no word)."""
    T, B, K = parents.shape
    b_idx = np.arange(B)[:, None]
    cur = np.broadcast_to(np.arange(K, dtype=np.int64)[None], (B, K)).copy()
    out = np.empty((T, B, K), np.int32)
    for t in range(T - 1, -1, -1):
        out[t] = words[t][b_idx, cur]
        cur = parents[t][b_idx, cur]
    return out


def live_beams(state: "LmBeamState", recs) -> List[dict]:
    """Per row of a search's final ``state`` and records ``recs`` (parents,
    words; (T, B, K)), its live beams (max(s, ns) > NEG/2) by identity (h1,
    h2, node, last): context, scores and lm as bits, and the words each
    emitted. K6 and ``torch.topk`` may order beams of equal totals
    differently, so two searches are compared by this set, not slot by
    slot."""
    traces = _backtrace_all(recs[0].cpu().numpy().astype(np.int64), recs[1].cpu().numpy())
    st = [x.cpu() for x in state]
    bits = [x.view(torch.int32) if x.dtype == torch.float32 else x for x in st]
    live = (torch.maximum(st[5], st[6]) > NEG / 2).numpy()
    return [{tuple(int(bits[i][b, k]) for i in range(4)):
             (tuple(bits[4][b, k].tolist()), tuple(int(bits[i][b, k]) for i in range(5, 10)),
              tuple(w for w in traces[:, b, k].tolist() if w >= 0))
             for k in np.nonzero(live[b])[0]} for b in range(live.shape[0])]


class _BatchHandle(NamedTuple):
    """A dispatched batch: its finalize outputs and backpointers, being
    copied to host memory behind ``event`` (None on the CPU)."""

    final: Tuple[torch.Tensor, ...]   # scores, words, lm, ac: (B, K, H+1)
    recs: Tuple[torch.Tensor, ...]    # parents int16, words int32: (T, B, K)
    event: Optional[torch.cuda.Event]


class _FrameGraph:
    """The buffers of the batched frame step, for replay as a CUDA graph of
    K6: the beam state (B, K, ·), the batch's log-probs (B, T_cap, V), its
    lengths (B,), the frame counter ``t`` on the device and the backpointer
    rows (T_cap, B, K) keep their addresses. Each step reads frame ``t`` by
    index, leaves the beams of rows past their length as they are, writes
    row ``t`` of the records and advances ``t``, so one graph serves every
    frame of every batch of its shape. It holds its ``dev_lm``, whose
    tensors the graph reads, so the id in its cache key stays that LM's.
    Off the card it holds the buffers and K6's workspace only."""

    def __init__(self, searcher: "DeviceLexiconBeamSearch", B: int, T_cap: int, V: int,
                 device: torch.device):
        self.dev_lm = searcher.dev_lm
        self.T_cap = T_cap
        self.state = searcher._make_state(B)
        K = self.state.s.shape[1]
        self.lp = torch.zeros((B, T_cap, V), dtype=torch.float32, device=device)
        self.lens = torch.zeros((B,), dtype=torch.int64, device=device)
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)
        self.parents = torch.zeros((T_cap, B, K), dtype=torch.int16, device=device)
        self.words = torch.zeros((T_cap, B, K), dtype=torch.int32, device=device)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=device)   # K6's rows done
        self.work = workspace(B, K, V, searcher.H, searcher.dev_lm.order, device)
        self.graph: Optional[Captured] = None

    def load(self, state: LmBeamState, lp: torch.Tensor, lens: torch.Tensor,
             n_frames: int) -> None:
        """A batch's initial state, its first ``n_frames`` frames and its
        lengths into the buffers; ``t`` back to 0."""
        for buf, x in zip(self.state, state):
            buf.copy_(x)
        self.lp[:, :n_frames].copy_(lp[:, :n_frames])
        self.lens.copy_(lens)
        self.t.zero_()

    def result(self, n_frames: int):
        """Copies of the final state and of the first ``n_frames`` record
        rows, which the next batch's load leaves as they are."""
        return (LmBeamState(*(b.clone() for b in self.state)),
                (self.parents[:n_frames].clone(), self.words[:n_frames].clone()))


class DeviceLexiconBeamSearch:
    """Stateful streaming decoder with the reset/decode/finalize protocol,
    plus batched decodes, running the search itself on the device."""

    def __init__(
        self,
        lexicon: Lexicon,
        lm: Optional[NGramLM],
        config: Optional[DecodeConfig] = None,
        blank: int = BLANK_ID,
        sil: int = SIL_ID_MODEL,
        max_homophones: int = 4,
        dev_lm: Optional[DeviceNGram] = None,
        rescore_lm=None,
        close_probe_top: Optional[int] = None,
        state_key: str = "history",
        device: Union[str, torch.device, None] = None,
    ):
        """Pass either a host NGramLM (packed onto the device here) or a
        prebuilt DeviceNGram (``dev_lm``, on ``device``). ``rescore_lm``
        (NGramLM or DeviceNGram) enables unpruned-LM finalize rescoring — see
        attach_rescore_lm. ``close_probe_top`` probes the n-gram tables for
        only the top-C unigram-ranked homophones per close; use with
        rescore_lm. ``device`` None means the CUDA card (raises without one);
        pass ``device="cpu"`` to search on the CPU."""
        self.device = resolve_device(device)
        self.lexicon = lexicon
        self.config = config or DecodeConfig()
        self.blank = blank
        self.sil = sil
        self.dev_lm = dev_lm if dev_lm is not None else DeviceNGram.build(
            lm, lexicon, self.device
        )
        self.close_top = close_probe_top
        # hypothesis state space: "history" merges only identical full word
        # histories; "ngram" truncates identity to the LM context hash (Kaldi
        # token-passing state space). Viterbi-only: under sum_mode, merging
        # different sentences would pool their path mass incorrectly.
        if state_key not in ("history", "ngram"):
            raise ValueError(f"state_key must be history|ngram: {state_key}")
        if state_key == "ngram" and self.config.sum_mode:
            raise ValueError("state_key='ngram' requires sum_mode=False")
        self.state_key = state_key
        # LM lookahead smearing over the trie (see lmbeam.py) — ranking only,
        # cancels at word close
        uni_np = self.dev_lm.uni_logp.cpu().numpy()
        if lm is not None:
            la_np = lexicon.lookahead_scores(lambda w: lm.logp([], w))
        else:
            unk = self.dev_lm.unk_logp
            ids = lexicon.word_ids

            def uni_lp(w: str) -> float:
                v = uni_np[ids[w]]
                return float(v) if v > -1e8 else unk

            la_np = lexicon.lookahead_scores(uni_lp)
        self.la = torch.from_numpy(np.asarray(la_np, np.float32)).to(self.device)
        self.la0 = float(la_np[0])
        self.trie = TrieArrays.build(lexicon, max_homophones, la_np, uni_np, self.device)
        # TrieArrays caps H at the lexicon's largest homophone class
        self.H = self.trie.words_at.shape[1]
        self.order = self.dev_lm.order
        self.rescore_lm: Optional[DeviceNGram] = None
        if rescore_lm is not None:
            self.attach_rescore_lm(rescore_lm)
        # captured frame steps by shape, step options and LM
        self._graphs = GraphCache(GRAPH_CACHE, beam_step, "search.graph_captures")
        self.reset()

    def attach_rescore_lm(self, lm) -> None:
        """Enable unpruned-LM rescoring of the FULL finalize candidate pool,
        on the device (the native decoder's pool rescore,
        runtime/decoder.cc:675-690; reference brain_speech_decoder.cc:61-101):
        each candidate's decode-LM score is replaced by the unpruned model's
        full-sentence log-probability (+ length_penalty·n_words) and the
        ranking score shifts by the difference before the n-best cut. ``lm``
        is a host NGramLM (packed here) or a DeviceNGram on this searcher's
        device sharing its lexicon word ids."""
        self.rescore_lm = lm if isinstance(lm, DeviceNGram) else DeviceNGram.build(
            lm, self.lexicon, self.device
        )

    def _rescore(self, traces: torch.Tensor, lens: torch.Tensor,
                 fwords: torch.Tensor) -> torch.Tensor:
        """Unpruned-LM log-probability of every pool candidate: traces
        (B, K, L) word ids, lens (B, K) live counts, fwords (B, K, H+1) final
        word variants (−1 = sentence ends at the traced words). One step per
        traced word scores every beam's prefix; the H+1 variants share it."""
        rlm = self.rescore_lm
        CW = max(rlm.order - 1, 1)
        B, K, L = traces.shape
        ctx = torch.full((B, K, CW), -1, dtype=torch.int32, device=self.device)
        ctx[..., CW - 1] = rlm.bos_id
        acc = torch.zeros((B, K), dtype=torch.float32, device=self.device)
        for t in range(L):
            valid = lens > t
            wc = traces[..., t].clamp(min=0)
            acc = acc + torch.where(valid, rlm.logp(ctx, wc), 0.0)
            new_ctx = torch.cat([ctx[..., 1:], wc[..., None]], -1) if CW > 1 else wc[..., None]
            ctx = torch.where(valid[..., None], new_ctx, ctx)
        H1 = fwords.shape[-1]
        fw_ok = fwords >= 0
        wc = fwords.clamp(min=0)
        wlp = rlm.logp_words(ctx, wc)                             # (B, K, H+1)
        new_ctx = (torch.cat([ctx[..., None, 1:].expand(B, K, H1, CW - 1), wc[..., None]], -1)
                   if CW > 1 else wc[..., None])
        eos_close = rlm.logp(new_ctx, torch.full_like(wc, rlm.eos_id))
        eos_root = rlm.logp(ctx, torch.full_like(lens, rlm.eos_id))[..., None]
        return torch.where(fw_ok, acc[..., None] + wlp + eos_close, acc[..., None] + eos_root)

    def _apply_rescore(self, scores, lms, fwords, traces):
        """Shift (scores, lms) per the pool rescore semantics. traces:
        (T, B, K); scores/lms/fwords: (B, K, H+1) numpy. Returns the updated
        (scores, lms)."""
        cfg = self.config
        tr, tr_lens = _compress_traces(traces)
        L = max(1, int(tr_lens.max(initial=0)))  # steps past every trace add nothing
        with torch.inference_mode():
            new_lm = self._rescore(
                torch.from_numpy(np.ascontiguousarray(tr[..., :L])).to(self.device),
                torch.from_numpy(tr_lens).to(self.device),
                torch.from_numpy(np.ascontiguousarray(fwords, np.int32)).to(self.device),
            ).cpu().numpy()
        n_words = tr_lens[:, :, None] + (fwords >= 0)
        new_lm = new_lm + float(cfg.length_penalty) * n_words
        finite = np.isfinite(scores)
        scores = np.where(finite, scores + (new_lm - lms), scores)
        lms = np.where(finite, new_lm, lms)
        return scores, lms

    # ---------------------------------------------------------------- state
    def set_opt(self, config: DecodeConfig) -> None:
        # mirror the constructor's validation: runtime reconfiguration must
        # not reach states the constructor rejects
        if self.state_key == "ngram" and config.sum_mode:
            raise ValueError("state_key='ngram' requires sum_mode=False")
        if config.lattice_nbest:
            raise ValueError(
                "lattice_nbest needs the 'native' or 'python' backend; "
                "the device searcher returns the beam pool"
            )
        self.config = config

    def _make_state(self, B: int = 1) -> LmBeamState:
        K = self.config.beam_width
        k = np.arange(K, dtype=np.uint32)
        h1 = np.where(k == 0, np.uint32(0x811C9DC5), np.uint32(0x80000000) | k)
        h2 = np.where(k == 0, np.uint32(0x01000193), np.uint32(0x40000000) | k)
        ctx = np.full((K, max(self.order - 1, 1)), -1, np.int32)
        ctx[:, -1] = self.dev_lm.bos_id
        first = np.where(k == 0, 0.0, NEG).astype(np.float32)
        neg = np.full((K,), NEG, np.float32)

        def put(a):
            t = _upload(a, self.device)
            return t.expand((B,) + t.shape).contiguous()

        return LmBeamState(
            h1=put(h1.view(np.int32)), h2=put(h2.view(np.int32)),
            node=put(np.zeros((K,), np.int32)), last=put(np.full((K,), -1, np.int32)),
            ctx=put(ctx), s=put(first), ns=put(neg), ac_s=put(first), ac_ns=put(neg),
            lm=put(np.zeros((K,), np.float32)),
        )

    def reset(self) -> None:
        self.state = self._make_state()
        self.records: List[Tuple[np.ndarray, np.ndarray]] = []
        self.n_frames = 0
        self._final_cache = None

    # ------------------------------------------------------------ expansion
    def _expand(self, st: LmBeamState, lp: torch.Tensor, scale: float,
                length_penalty: float, first_beam: Optional[int] = None,
                sum_mode: bool = True, beam: float = 0.0):
        """One frame of expansion for a batch: state (B, K), lp (B, V); the
        plain version of K6 (``ops/beam_step.py``). ``first_beam`` restricts
        the phone-extension candidates to the frame's first beam of phones
        (the reference's first-beam prune);
        ``sum_mode`` selects the CTC-proper log-sum path merge (True) or
        Kaldi-style Viterbi max (False); ``beam`` > 0 drops the beams more
        than ``beam`` below the row's best (to NEG), the host searchers'
        window. Returns (new state, parents, syms, words), the last three
        (B, K)."""
        B, K = st.s.shape
        V = lp.shape[-1]
        H = self.H
        CW = st.ctx.shape[-1]
        blank, sil = self.blank, self.sil
        dev = lp.device
        i32 = dict(dtype=torch.int32, device=dev)
        score = (_logaddexp(st.s, st.ns) if sum_mode
                 else torch.maximum(st.s, st.ns))
        ac = _logaddexp(st.ac_s, st.ac_ns)

        arangeK = torch.arange(K, **i32).expand(B, K)
        has_last = st.last >= 0
        lp_last = torch.where(has_last, lp.gather(1, st.last.clamp(0, V - 1).long()), NEG)
        lp_blank = lp[:, blank, None]                     # (B, 1)
        lp_sil = lp[:, sil, None]

        def sort_keys(wh1, wh2, node, last):
            """Merge identity = (word history, trie node, last phone) — the
            word-lattice state space of the reference's TLG decoding."""
            return hash_extend(wh1, wh2, node * (V + 2) + last + 2)

        def const(v, shape):
            return torch.full(shape, v, **i32)

        # ---- 1. stay: blank emission (s-path) + absorbed repeat (ns-path)
        k1, k2 = sort_keys(st.h1, st.h2, st.node, st.last)
        stay = dict(
            k1=k1, k2=k2,
            h1=st.h1, h2=st.h2, node=st.node, last=st.last, ctx=st.ctx,
            s=score + scale * lp_blank,
            ns=torch.where(has_last, st.ns + scale * lp_last, NEG),
            ac_s=ac + lp_blank,
            ac_ns=torch.where(has_last, st.ac_ns + lp_last, NEG),
            lm=st.lm, parent=arangeK, sym=const(-1, (B, K)), word=const(-1, (B, K)),
        )

        # ---- packed per-node rows: ONE gather each for the close-branch data
        # (homophone word ids + their unigram log-probs + node lookahead) and
        # for the extension data (children + child lookahead)
        nrow = self.trie.node_pack[st.node]               # (B, K, 2H+1)
        wids = nrow[..., :H]
        uni_w = nrow[..., H:2 * H].view(torch.float32)
        la_node = nrow[..., 2 * H].view(torch.float32)

        # ---- 2. extend with phone c (non-blank, non-SIL)
        c = torch.arange(V, **i32).expand(B, K, V)
        lp_ext = lp[:, None, :].expand(B, K, V)
        pair = self.trie.next_la2[st.node]                            # (B, K, V, 2)
        phone_ok = (c != blank) & (c != sil) & torch.isfinite(lp_ext)
        if first_beam is not None and first_beam < V - 2:
            # the first beam: the phones (blank and SIL aside: the stay,
            # silence and close branches take them) at or above this frame's
            # first_beam-th best log-prob, ties included, as the host
            # searchers threshold it
            masked = lp.clone()
            masked[:, blank] = -math.inf
            masked[:, sil] = -math.inf
            kth = torch.topk(masked, first_beam, dim=1).values[:, -1:]
            phone_ok = phone_ok & (masked >= kth)[:, None, :]
        child = pair[..., 0]
        la_child = pair[..., 1].view(torch.float32)
        is_rep = c == st.last[..., None]
        base = torch.where(is_rep, st.s[..., None], score[..., None])
        ac_base = torch.where(is_rep, st.ac_s[..., None], ac[..., None])
        phone_ok = phone_ok & (child >= 0)
        child0 = child.clamp(min=0)
        ek1, ek2 = sort_keys(st.h1[..., None], st.h2[..., None], child0, c)
        la_delta = la_child - la_node[..., None]
        ext = dict(
            k1=ek1, k2=ek2, h1=st.h1[..., None], h2=st.h2[..., None], node=child0, last=c,
            ctx=st.ctx[:, :, None, :],
            s=NEG, ns=torch.where(phone_ok, base + scale * lp_ext + la_delta, NEG),
            ac_s=NEG, ac_ns=torch.where(phone_ok, ac_base + lp_ext, NEG),
            lm=st.lm[..., None], parent=arangeK[..., None],
            sym=torch.where(phone_ok, c, -1), word=-1,
        )

        # ---- 3. SIL at root: extra/leading silence
        last_sil = st.last == sil
        sil_base = torch.where(last_sil, st.s, score)
        sil_ac_base = torch.where(last_sil, st.ac_s, ac)
        at_root = st.node == 0
        rk1, rk2 = sort_keys(st.h1, st.h2, 0, const(sil, (1, 1)))
        silroot = dict(
            k1=rk1, k2=rk2, h1=st.h1, h2=st.h2, node=0, last=sil, ctx=st.ctx,
            s=NEG, ns=torch.where(at_root, sil_base + scale * lp_sil, NEG),
            ac_s=NEG, ac_ns=torch.where(at_root, sil_ac_base + lp_sil, NEG),
            lm=st.lm, parent=arangeK, sym=torch.where(at_root, sil, -1), word=-1,
        )

        # ---- 4. close word(s): SIL at word-final node, n-gram scored
        w_ok = wids >= 0                                   # (B, K, H)
        wc = wids.clamp(min=0)
        # context hashing and backoff probes once per beam, gram probes per
        # (beam, homophone); unigram log-probs come from node_pack
        wlp = self.dev_lm.logp_words(st.ctx, wc, uni_w, n_exact=self.close_top)
        wlp = wlp + length_penalty
        new_ctx = (torch.cat([st.ctx[:, :, None, 1:].expand(B, K, H, CW - 1), wc[..., None]], -1)
                   if CW > 1 else wc[..., None])
        if self.state_key == "ngram":
            # identity = the new LM context window (the Kaldi token-passing
            # state space)
            wh1, wh2 = hash_ctx(new_ctx)
        else:
            wh1, wh2 = hash_extend(st.h1[..., None], st.h2[..., None], wids + V + 2)
        ck1, ck2 = sort_keys(wh1, wh2, 0, const(sil, (1, 1, 1)))
        la_close = self.la0 - la_node[..., None]           # (B, K, 1)
        close = dict(
            k1=ck1, k2=ck2, h1=wh1, h2=wh2, node=0, last=sil, ctx=new_ctx,
            s=NEG,
            ns=torch.where(w_ok, sil_base[..., None] + scale * lp_sil[..., None] + wlp
                           + la_close, NEG),
            ac_s=NEG, ac_ns=torch.where(w_ok, sil_ac_base[..., None] + lp_sil[..., None], NEG),
            lm=torch.where(w_ok, st.lm[..., None] + wlp, st.lm[..., None]),
            parent=arangeK[..., None], sym=torch.where(w_ok, sil, -1),
            word=torch.where(w_ok, wids, -1),
        )

        # ---- candidates in JAX's order: stay, extend, silence, close. Per
        # candidate one int64 key, the four scores, and ONE int32 payload row
        # (h1, h2, node, last, parent, sym, word, lm bits, ctx) gathered once
        # for the K winners. Merged duplicates share identical (h1, h2, node,
        # last, ctx, lm) under history keying.
        keys, scores, payloads = [], [], []
        for part, shape in ((stay, (B, K)), (ext, (B, K, V)), (silroot, (B, K)),
                            (close, (B, K, H))):

            def full(x, dtype):
                if isinstance(x, torch.Tensor):
                    return x.expand(shape).to(dtype)
                return torch.full(shape, x, dtype=dtype, device=dev)

            k1_, k2_ = (t.expand(shape) for t in (part["k1"], part["k2"]))
            keys.append(_key64(k1_, k2_).reshape(B, -1))
            sc = torch.stack([full(part[f], torch.float32)
                              for f in ("s", "ns", "ac_s", "ac_ns")], -1)
            scores.append(sc.reshape(B, -1, 4))
            cols = [full(part[f], torch.int32)[..., None]
                    for f in ("h1", "h2", "node", "last", "parent", "sym", "word")]
            cols.append(full(part["lm"], torch.float32).contiguous()
                        .view(torch.int32)[..., None])
            cols.append(part["ctx"].expand(shape + (CW,)))
            payloads.append(torch.cat(cols, -1).reshape(B, -1, 8 + CW))
        key = torch.cat(keys, 1)                            # (B, N)
        scores = torch.cat(scores, 1)                       # (B, N, 4)
        payload = torch.cat(payloads, 1)                    # (B, N, 8 + CW)
        N = key.shape[1]

        # ---- sort by (k1, k2, Viterbi rank): each segment's LAST element is
        # its best path, the representative whose payload the winner takes
        # (under ngram keying different word histories share a segment)
        mkey = torch.maximum(scores[..., 0], scores[..., 1])
        p1 = torch.sort(mkey, dim=1, stable=True).indices
        key_s, p2 = torch.sort(key.gather(1, p1), dim=1, stable=True)
        perm = p1.gather(1, p2)
        sc = scores.gather(1, perm[..., None].expand(B, N, 4)).reshape(B * N, 4)

        # ---- merge each segment
        starts = torch.ones((B, N), dtype=torch.bool, device=dev)
        starts[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
        seg_end = torch.ones((B, N), dtype=torch.bool, device=dev)
        seg_end[:, :-1] = starts[:, 1:]
        merged, combined, seg = _seg_merge4(sc, starts, sum_mode)
        total = torch.where(seg_end, combined[seg].reshape(B, N), -math.inf)

        top_total, top_idx = torch.topk(total, K, dim=1)
        valid = top_total > -math.inf
        if beam > 0:
            valid = valid & (top_total >= top_total[:, :1] - beam)
        m4 = merged[seg.reshape(B, N).gather(1, top_idx)]   # (B, K, 4)
        win = perm.gather(1, top_idx)
        pw = payload.gather(1, win[..., None].expand(B, K, payload.shape[-1]))
        new_state = LmBeamState(
            h1=pw[..., 0], h2=pw[..., 1], node=pw[..., 2], last=pw[..., 3],
            ctx=pw[..., 8:],
            s=torch.where(valid, m4[..., 0], NEG),
            ns=torch.where(valid, m4[..., 1], NEG),
            ac_s=torch.where(valid, m4[..., 2], NEG),
            ac_ns=torch.where(valid, m4[..., 3], NEG),
            lm=pw[..., 7].contiguous().view(torch.float32),
        )
        return new_state, pw[..., 4], pw[..., 5], pw[..., 6]

    def _step_args(self):
        cfg = self.config
        return dict(scale=float(cfg.acoustic_scale), length_penalty=float(cfg.length_penalty),
                    first_beam=cfg.first_beam_size or None, sum_mode=bool(cfg.sum_mode),
                    beam=float(cfg.beam))

    # ----------------------------------------------------------------- scan
    def _scan_batch(self, state: LmBeamState, lp: torch.Tensor, lengths: np.ndarray,
                    n_frames: Optional[int] = None):
        """Batched utterance decode: the expansion over B utterances, one
        frame at a time, up to the longest utterance (or ``n_frames``
        frames). Frames past an utterance's length leave its beams as they
        are. Nothing here waits for the device: ``lengths`` is on the host.
        Returns the final state and the backpointers (parents int16, words
        int32), each (T, B, K).

        Where ``_replays`` holds, the frames are replays of a captured graph
        of K6 (``_scan_graph``); elsewhere they are ``_expand``'s loop
        (``_scan_eager``)."""
        B, T, V = lp.shape
        K = state.s.shape[1]
        if n_frames is None:
            n_frames = min(T, int(np.max(lengths, initial=0)))
        count("search.frames", n_frames)
        if not n_frames:
            empty = torch.empty((0, B, K), dtype=torch.int32, device=lp.device)
            return state, (empty.to(torch.int16), empty)
        lens = _upload(np.asarray(lengths, np.int64), lp.device)
        if self._replays(lp):
            return self._scan_graph(state, lp, lens, n_frames)
        return self._scan_eager(state, lp, lengths, lens, n_frames)

    def _replays(self, lp: torch.Tensor) -> bool:
        """Whether ``lp``'s frames are K6's launches, a batch's replaying
        its captured step: on the card, with a plain ``DeviceNGram`` (a
        subclass may probe through collectives or the host)."""
        return lp.device.type == "cuda" and type(self.dev_lm) is DeviceNGram

    def _scan_eager(self, state: LmBeamState, lp: torch.Tensor, lengths: np.ndarray,
                    lens: torch.Tensor, n_frames: int):
        """``_scan_batch``'s frames op by op: ``_expand`` each frame, the
        mask only past the frames every utterance has."""
        B, T, V = lp.shape
        K = state.s.shape[1]
        args = self._step_args()
        n_all = int(np.min(lengths, initial=T))   # frames every utterance has
        keep_k = torch.arange(K, dtype=torch.int32, device=lp.device).expand(B, K)
        parents, words = [], []
        for t in range(n_frames):
            new, par, _, wd = self._expand(state, lp[:, t], **args)
            if t < n_all:
                state = new
            else:
                active = lens > t
                state = _select(active, new, state)
                par = torch.where(active[:, None], par, keep_k)
                wd = torch.where(active[:, None], wd, -1)
            # int16 backpointers: half the bytes to the host; K < 2^15
            parents.append(par.to(torch.int16))
            words.append(wd)
        return state, (torch.stack(parents), torch.stack(words))

    def _kernel_step(self, state: LmBeamState, lp: torch.Tensor, lens, t, ticket, parents,
                     words, work, t_offset: int = 0, advance: bool = True) -> None:
        """One frame by K6, in place over ``state``: ``_expand`` with this
        searcher's trie, LM and options (``ops.beam_step.beam_step``);
        ``work`` is ``ops.beam_step.workspace``'s for the shape."""
        beam_step(state, lp, lens, t, ticket, parents, words, self.trie, self.dev_lm,
                  **self._step_args(), close_top=self.close_top,
                  ngram_key=self.state_key == "ngram", blank=self.blank, sil=self.sil,
                  la0=self.la0, t_offset=t_offset, advance=advance, work=work)

    def _frame_graph(self, B: int, V: int, n_frames: int, device: torch.device) -> _FrameGraph:
        """The captured frame step for this shape, these step options and
        this LM: from the cache, or captured now over a new ``_FrameGraph``'s
        buffers, K6's one launch after two warm-up launches, ``t`` back to 0
        before each. A batch longer than the entry's frame capacity captures
        anew with a larger one."""
        key = (device, B, V, self.config.beam_width, max(self.order - 1, 1), self.H,
               tuple(sorted(self._step_args().items())), self.close_top, self.state_key,
               id(self.dev_lm))

        def capture() -> _FrameGraph:
            fg = _FrameGraph(self, B, -(-n_frames // GRAPH_T_STEP) * GRAPH_T_STEP, V, device)
            fg.graph = self._graphs.capture(
                lambda: self._kernel_step(fg.state, fg.lp, fg.lens, fg.t, fg.ticket, fg.parents,
                                          fg.words, fg.work),
                device, warmups=2, reset=fg.t.zero_)
            return fg

        return self._graphs.get(key, capture, fits=lambda fg: fg.T_cap >= n_frames)

    def _scan_graph(self, state: LmBeamState, lp: torch.Tensor, lens: torch.Tensor,
                    n_frames: int):
        """``_scan_batch``'s frames as ``n_frames`` replays of the captured
        frame step: one launch call a frame."""
        B, _, V = lp.shape
        with torch.inference_mode():
            fg = self._frame_graph(B, V, n_frames, lp.device)
            fg.load(state, lp, lens, n_frames)
            fg.graph.replay(n_frames)
            count("search.graph_frames", n_frames)
            return fg.result(n_frames)

    def _finalize(self, st: LmBeamState):
        """Close open words (no acoustic cost) + </s>; returns per-candidate
        (scores, words, lm, ac), each (B, K, H+1) [slot H = already at the
        root]. length_penalty applies to the final word close, as in the
        host oracle (lmbeam.py:304) and the native decoder (decoder.cc:654)."""
        cfg = self.config
        B, K = st.node.shape
        H = self.H
        CW = st.ctx.shape[-1]
        lm = self.dev_lm
        wids = self.trie.words_at[st.node]                 # (B, K, H)
        w_ok = wids >= 0
        wc = wids.clamp(min=0)
        wlp = lm.logp_words(st.ctx, wc) + float(cfg.length_penalty)
        new_ctx = (torch.cat([st.ctx[:, :, None, 1:].expand(B, K, H, CW - 1), wc[..., None]], -1)
                   if CW > 1 else wc[..., None])
        eos_close = lm.logp(new_ctx, torch.full_like(wc, lm.eos_id))          # (B, K, H)
        eos_root = lm.logp(st.ctx, torch.full_like(st.node, lm.eos_id))      # (B, K)

        score = (_logaddexp(st.s, st.ns) if cfg.sum_mode
                 else torch.maximum(st.s, st.ns))
        at_root = st.node == 0
        la_adj = (self.la[0] - self.la[st.node])[..., None]
        close_score = torch.where(w_ok & ~at_root[..., None],
                                  score[..., None] + wlp + la_adj + eos_close, -math.inf)
        root_score = torch.where(at_root, score + eos_root, -math.inf)
        all_scores = torch.cat([close_score, root_score[..., None]], -1)
        all_words = torch.cat([torch.where(w_ok, wids, -1),
                               torch.full_like(wids[..., :1], -1)], -1)
        all_lm = torch.cat([torch.where(w_ok, st.lm[..., None] + wlp + eos_close, 0.0),
                            (st.lm + eos_root)[..., None]], -1)
        ac = _logaddexp(st.ac_s, st.ac_ns)
        all_ac = ac[..., None].expand(B, K, H + 1)
        return all_scores, all_words, all_lm, all_ac

    # ------------------------------------------------------------- batches
    def decode_batch(
        self,
        log_probs: Union[np.ndarray, torch.Tensor],
        input_lengths: Optional[np.ndarray] = None,
        nbest: Optional[int] = None,
    ) -> List[List[DecodeResult]]:
        """One-shot decode of (B, T, 41) log-probs (model channel order) →
        per-utterance n-best. Frames past input_lengths are ignored. Blank
        skipping is host-side frame compaction (compact_blank_skip), so the
        device loop runs only over informative frames."""
        return self._collect_batch(self._dispatch_batch(log_probs, input_lengths), nbest)

    def _dispatch_batch(self, log_probs, input_lengths) -> _BatchHandle:
        """Issue a batch's frames and finalize on the device, and the copies
        of their outputs to pinned host memory, without waiting for any of
        it. Pair with _collect_batch."""
        with span("search.issue"), torch.inference_mode():
            lp, lengths, log_bp = self._prep_batch(log_probs, input_lengths)
            if log_bp != 0.0:
                lp[:, :, self.blank] -= log_bp
            state, recs = self._scan_batch(self._make_state(lp.shape[0]), lp, lengths)
            final = self._finalize(state)
            if lp.device.type != "cuda":
                return _BatchHandle(final, recs, None)
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in final + recs)
            event = torch.cuda.Event()
            event.record()
            return _BatchHandle(host[:4], host[4:], event)

    def _collect_batch(self, handle: _BatchHandle, nbest=None) -> List[List[DecodeResult]]:
        if handle.event is not None:
            with span("search.wait"):
                handle.event.synchronize()
        with span("search.extract"):
            final = tuple(t.numpy() for t in handle.final)
            recs = tuple(t.numpy() for t in handle.recs)
            return self._extract_results(final, recs, nbest)

    def decode_batches(self, batches: Iterable, nbest=None):
        """Software-pipelined decode over [(log_probs, lengths), ...]: the
        next batch's device work is issued BEFORE the previous batch's
        outputs are fetched and extracted, hiding the host-side n-best work
        under device compute. Yields per-batch result lists in order."""
        pending = None
        for item in batches:
            handle = self._dispatch_batch(item[0], item[1])
            if pending is not None:
                yield self._collect_batch(pending, nbest)
            pending = handle
        if pending is not None:
            yield self._collect_batch(pending, nbest)

    def _prep_batch(self, log_probs, input_lengths):
        """Batch prep: blank-skip frame compaction when it can fire, and
        a float32 copy of the log-probs on the searcher's device.

        When the blank penalty alone makes the skip threshold unreachable —
        exp(lp_blank − log(penalty)) ≤ 1/penalty < threshold, the canonical
        regime (penalty 90) — compaction is provably a no-op and the input
        never goes to the host: a tensor on the card (e.g. straight from the
        RNN forward) stays there. Returns (lp (B, T, V) tensor, lengths (B,)
        int32 numpy, blank log-penalty still to apply)."""
        cfg = self.config
        B, T, V = log_probs.shape
        if input_lengths is None:
            input_lengths = np.full((B,), T, np.int32)
        if isinstance(input_lengths, torch.Tensor):
            input_lengths = input_lengths.cpu().numpy()
        log_bp = float(math.log(cfg.blank_penalty))
        thresh = float(cfg.ctc_blank_skip_threshold)
        skip_possible = thresh < 1.0 and (1.0 / cfg.blank_penalty) > thresh
        if skip_possible:
            lp_np = (log_probs.float().cpu().numpy() if isinstance(log_probs, torch.Tensor)
                     else np.asarray(log_probs, np.float32))
            lp_np, input_lengths = compact_blank_skip(
                lp_np, np.asarray(input_lengths), self.blank, thresh, log_bp,
            )
            log_bp = 0.0  # penalty already applied during compaction
            lp = _upload(lp_np, self.device)
        elif isinstance(log_probs, torch.Tensor):
            lp = log_probs.to(device=self.device, dtype=torch.float32, copy=True)
        else:
            lp = _upload(np.array(log_probs, np.float32), self.device)
        return lp, np.asarray(input_lengths, np.int32), log_bp

    def _extract_results(self, final, recs, nbest):
        cfg = self.config
        scores, fwords, lms, acs = final
        B = scores.shape[0]
        parents = recs[0].astype(np.int64)                     # (T, B, K)
        traces = _backtrace_all(parents, recs[1])              # (T, B, K)

        if self.rescore_lm is not None:
            scores, lms = self._apply_rescore(scores, lms, fwords, traces)

        n_out = nbest or cfg.nbest
        results: List[List[DecodeResult]] = []
        for b in range(B):
            flat = scores[b].reshape(-1)
            order = np.argsort(-flat)
            out: List[DecodeResult] = []
            seen = set()
            H1 = scores.shape[2]
            for idx in order:
                if len(out) >= n_out or not np.isfinite(flat[idx]):
                    break
                k, j = divmod(int(idx), H1)
                col = traces[:, b, k]
                ws = col[col >= 0].tolist()
                if fwords[b, k, j] >= 0:
                    ws = ws + [int(fwords[b, k, j])]
                if not ws:
                    continue
                sentence = " ".join(self.lexicon.words[w] for w in ws)
                if sentence in seen:
                    continue
                seen.add(sentence)
                out.append(
                    DecodeResult(
                        sentence=sentence,
                        ac_score=float(acs[b, k, j]),
                        lm_score=float(lms[b, k, j]),
                    )
                )
            results.append(out)
        return results

    # -------------------------------------------------------------- sharded
    def sharded_decode_batch(
        self,
        log_probs: Union[np.ndarray, torch.Tensor],
        input_lengths: Optional[np.ndarray] = None,
        *,
        mesh,
        axis: str = "data",
        nbest: Optional[int] = None,
    ) -> List[List[DecodeResult]]:
        """``decode_batch`` over the ``axis`` of a ``DeviceMesh``, on every
        rank of it at once (one process per rank, each given the whole
        batch): the utterances shard over the axis AND the bucket table
        row-shards over the same ranks (``ShardedNGram``: probes exchange
        keys with an all-gather and reassemble rows with a reduce-scatter).
        Every rank returns the n-best of the whole batch, equal bit for bit
        to ``decode_batch``'s. B must be divisible by the axis size.

        Each rank prepares the whole batch (the blank-skip compaction sets
        T) and runs the whole batch's longest length of frames, so every
        rank issues the same probes. The pool rescore (``rescore_lm``) runs
        unsharded on every rank over the gathered pool."""
        from ..lm.device_ngram import ShardedNGram
        from ..parallel.comm import gather_shards

        group = mesh.get_group(axis)
        D, r = mesh[axis].size(), mesh.get_local_rank(axis)
        with torch.inference_mode():
            lp, lengths, log_bp = self._prep_batch(log_probs, input_lengths)
            B, T, _ = lp.shape
            if B % D:
                raise ValueError(f"batch {B} not divisible by mesh axis size {D}")
            packed, _ = self.dev_lm.table
            if packed.shape[0] % D:
                raise ValueError(f"{packed.shape[0]} buckets not divisible by {D} ranks")
            if log_bp != 0.0:
                lp[:, :, self.blank] -= log_bp
            b, n = B // D, packed.shape[0] // D
            rows = slice(r * b, (r + 1) * b)
            # this rank's block of bucket rows, on this rank's device
            self.sharded_lm = ShardedNGram.from_device_ngram(
                self.dev_lm, packed[r * n:(r + 1) * n].to(self.device), group)
            base = self.dev_lm
            self.dev_lm = self.sharded_lm
            try:
                state, recs = self._scan_batch(self._make_state(b), lp[rows], lengths[rows],
                                               n_frames=min(T, int(np.max(lengths, initial=0))))
                final = self._finalize(state)
            finally:
                self.dev_lm = base
            # the whole pool to every rank: two all-gathers of int32 stacks
            i32 = torch.int32
            scores, words, lms, acs = gather_shards(torch.stack(
                [final[0].view(i32), final[1].to(i32), final[2].view(i32),
                 final[3].contiguous().view(i32)]), 1, group).unbind(0)      # (B, K, H+1)
            parents, wds = gather_shards(torch.stack([recs[0].to(i32), recs[1]]), 2,
                                         group).unbind(0)                  # (T, B, K)
            final_np = (scores.view(torch.float32).cpu().numpy(), words.cpu().numpy(),
                        lms.view(torch.float32).cpu().numpy(),
                        acs.view(torch.float32).cpu().numpy())
            recs_np = (parents.to(torch.int16).cpu().numpy(), wds.cpu().numpy())
        return self._extract_results(final_np, recs_np, nbest)

    # ------------------------------------------------------------- protocol
    def decode(self, log_probs: Union[np.ndarray, torch.Tensor]) -> None:
        """Advance over a (T, 41) chunk of log-probs (model channel order).
        Blank penalty and the blank skip (one synthetic blank frame before
        the first kept frame after skipped ones, within the chunk) as in the
        JAX package's streaming scan. The chunk's skip mask and its
        backpointers come to the host once per chunk."""
        cfg = self.config
        with torch.inference_mode():
            lp = (log_probs.to(device=self.device, dtype=torch.float32, copy=True)
                  if isinstance(log_probs, torch.Tensor)
                  else torch.from_numpy(np.array(log_probs, np.float32)).to(self.device))
            T, V = lp.shape
            log_bp = float(math.log(cfg.blank_penalty))
            if log_bp != 0.0:
                lp[:, self.blank] -= log_bp
            thresh = float(cfg.ctc_blank_skip_threshold)
            skip = np.zeros(T, bool)
            if thresh < 1.0:
                skip = (torch.exp(lp[:, self.blank]) > thresh).cpu().numpy()
            reinsert = np.concatenate([[False], skip[:-1]]) & ~skip if T else skip
            blank_row = torch.full((1, V), -30.0, dtype=torch.float32, device=self.device)
            blank_row[0, self.blank] = 0.0
            K = self.state.s.shape[1]
            keep_k = torch.arange(K, dtype=torch.int32, device=self.device)[None]
            if self._replays(lp):
                self._decode_kernel(lp, blank_row, skip, reinsert, keep_k)
            else:
                args = self._step_args()
                state = self.state
                parents, words = [], []
                for t in range(T):
                    if skip[t]:
                        parents.append(keep_k)
                        words.append(torch.full_like(keep_k, -1))
                        continue
                    if reinsert[t]:
                        state = self._expand(state, blank_row, **args)[0]
                    state, par, _, wd = self._expand(state, lp[t : t + 1], **args)
                    parents.append(par)
                    words.append(wd)
                self.state = state
                if T:
                    self.records.append((torch.cat(parents).cpu().numpy(),
                                         torch.cat(words).cpu().numpy()))
        self.n_frames += T
        self._final_cache = None

    def _decode_kernel(self, lp: torch.Tensor, blank_row: torch.Tensor, skip: np.ndarray,
                       reinsert: np.ndarray, keep_k: torch.Tensor) -> None:
        """``decode``'s frames by K6, one launch a frame kept (and one for
        a reinserted blank frame, not recorded), over a copy of the state
        that then becomes it."""
        T, V = lp.shape
        state = LmBeamState(*(x.clone() for x in self.state))
        parents = keep_k.to(torch.int16).expand(T, 1, -1).clone()
        words = torch.full(parents.shape, -1, dtype=torch.int32, device=self.device)
        t0 = torch.zeros((1,), dtype=torch.int64, device=self.device)
        ticket = torch.zeros((1,), dtype=torch.int32, device=self.device)
        work = workspace(1, keep_k.shape[1], V, self.H, self.dev_lm.order, self.device)
        lp, blank_row = lp[None], blank_row[None]
        for t in np.nonzero(~skip)[0].tolist():
            if reinsert[t]:
                self._kernel_step(state, blank_row, None, t0, ticket, None, None, work,
                                  advance=False)
            self._kernel_step(state, lp, None, t0, ticket, parents, words, work, t_offset=t,
                              advance=False)
        self.state = state
        if T:
            self.records.append((parents[:, 0].int().cpu().numpy(),
                                 words[:, 0].cpu().numpy()))

    def decoded_something(self) -> bool:
        return self.n_frames > 0

    def _backtrace_words(self, beam: int) -> List[int]:
        words: List[int] = []
        k = beam
        for parents, wrec in reversed(self.records):
            for t in range(parents.shape[0] - 1, -1, -1):
                w = wrec[t, k]
                if w >= 0:
                    words.append(int(w))
                k = int(parents[t, k])
        words.reverse()
        return words

    def finish_decoding(self) -> List[DecodeResult]:
        cfg = self.config
        with torch.inference_mode():
            scores, fwords, lms, acs = (t[0].cpu().numpy() for t in self._finalize(self.state))
        if self.rescore_lm is not None and self.records:
            # streaming path: reconstruct every beam's word trace, then run
            # the same pool rescore as the batched path on (1, K, ·) shapes
            K = scores.shape[0]
            T_tot = sum(r[0].shape[0] for r in self.records)
            traces = np.full((T_tot, 1, K), -1, np.int32)
            for k in range(K):
                ws = self._backtrace_words(k)
                traces[: len(ws), 0, k] = ws
            s2, l2 = self._apply_rescore(
                scores[None], lms[None], fwords[None], traces
            )
            scores, lms = s2[0], l2[0]
        flat = scores.reshape(-1)
        order = np.argsort(-flat)
        results: List[DecodeResult] = []
        seen = set()
        H1 = scores.shape[1]
        for idx in order:
            if len(results) >= cfg.nbest or not np.isfinite(flat[idx]):
                break
            k, j = divmod(int(idx), H1)
            words = self._backtrace_words(k)
            if fwords[k, j] >= 0:
                words = words + [int(fwords[k, j])]
            if not words:
                continue
            sentence = " ".join(self.lexicon.words[w] for w in words)
            if sentence in seen:
                continue
            seen.add(sentence)
            results.append(
                DecodeResult(
                    sentence=sentence,
                    ac_score=float(acs[k, j]),
                    lm_score=float(lms[k, j]),
                )
            )
        self._final_cache = results
        return results

    def result(self) -> List[DecodeResult]:
        if self._final_cache is not None:
            return self._final_cache
        if self.n_frames == 0:
            return []
        with torch.inference_mode():
            st = self.state
            score = _logaddexp(st.s, st.ns)[0].cpu().numpy()
            ac = _logaddexp(st.ac_s, st.ac_ns)[0].cpu().numpy()
            lm = st.lm[0].cpu().numpy()
        k = int(np.argmax(score))
        words = self._backtrace_words(k)
        if not np.isfinite(score[k]):
            return []
        sentence = " ".join(self.lexicon.words[w] for w in words)
        return [DecodeResult(sentence=sentence, ac_score=float(ac[k]), lm_score=float(lm[k]))]
