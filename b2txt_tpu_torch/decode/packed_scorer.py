"""The n-best scorer over any causal LM: tokenize, pack, upload, one
forward, per-hypothesis sums, and a fetch that alone waits for the card.

A model fits when its ``forward(tokens, attention_mask, compute_dtype,
positions=None, segment_ids=None)`` returns float32 logits (B, L, vocab)
and, with ``segment_ids``, attends block-diagonally and causally within
each segment, ``positions`` counting from 0 in each (``OPTModel``,
``DeepseekV2Model``). ``PackedScorer`` is the ``LLMScorer`` over such a
model, and on the card it replays each packed shape's forward from one CUDA
graph; ``OPTRescorer`` adds its mesh and its shared-context path.

Score = Σ log P(token_t | tokens_<t) over a hypothesis' tokens after the
first, less length_penalty · n_tokens (the reference's rescore_with_gpt2,
language-model-standalone.py:127-161). The sums per segment go through
``ops/segment.py``: the same bits on every call.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.segment import segment_sum
from ..utils.cuda_graphs import GraphCache
from ..utils.device import upload
from ..utils.profiling import count, current_rid, span


def word_hash_encode(vocab_size: int) -> Callable[[str, int], List[int]]:
    """Stable ~1-token-per-word encoder for throughput drives with random
    weights: matches GPT2-BPE's token COUNT on short hypotheses (~1.3
    tokens/word) without needing the vocab files. Real deployments pass
    utils.bpe.ByteBPE.for_opt(...) instead."""

    def enc(text: str, max_len: int) -> List[int]:
        ids = [2]  # OPT BOS
        for w in text.split():
            # crc32, not hash(): builtin str hash is salted per process and
            # would make a drive's scores/exact counts non-reproducible
            ids.append((zlib.crc32(w.encode()) % (vocab_size - 10)) + 10)
        return ids[:max_len]

    return enc


def pack_sequences(ids: Sequence[Sequence[int]], capacity: int):
    """First-fit-decreasing bin packing of token id lists into rows of
    ``capacity`` tokens. Returns rows: for each row a list of
    (original_index, seq) pairs."""
    order = sorted(range(len(ids)), key=lambda i: -len(ids[i]))
    rows: List[List[tuple]] = []
    space: List[int] = []
    for i in order:
        seq = list(ids[i])[:capacity]
        for r, free in enumerate(space):
            if free >= len(seq):
                rows[r].append((i, seq))
                space[r] = free - len(seq)
                break
        else:
            rows.append([(i, seq)])
            space.append(capacity - len(seq))
    return rows


def _next_token_lp(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log P(tokens[:, t+1] | tokens[:, :t+1]) for t < L-1: (B, L-1)."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return lp.gather(2, tokens[:, 1:, None].long())[..., 0]


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    return segment_sum(data.reshape(-1).float(), seg.reshape(-1).long(), n_segments)


def score_tokens_fn(compute_dtype: torch.dtype = torch.float32):
    """Returns f(model, tokens, mask) → (sum log P(token), n_scored) per
    row — the reference's rescore_with_gpt2 numerator (standalone :127-161)."""

    def score(model, tokens, mask):
        tok_lp = _next_token_lp(model(tokens, mask, compute_dtype), tokens) * mask[:, 1:]
        return tok_lp.sum(dim=1), mask.sum(dim=1)

    return score


def _packed_sums(logits, tokens, segment_ids, n_segments):
    """Per-segment Σ log P(t → t+1) over pairs inside one segment."""
    tok_lp = _next_token_lp(logits, tokens)                       # (B, L-1)
    valid = (segment_ids[:, :-1] == segment_ids[:, 1:]) & (segment_ids[:, 1:] > 0)
    seg = torch.where(valid, segment_ids[:, 1:], 0)
    return _segment_sum(tok_lp * valid, seg, n_segments)


def score_packed_fn(n_segments: int, compute_dtype: torch.dtype = torch.float32, **forward_kw):
    """Packed-row variant of :func:`score_tokens_fn`: rows carry several
    independent hypotheses (block-diagonal causal attention via
    ``segment_ids``), and per-hypothesis (Σ log P, n_tokens) come back as
    segment sums indexed by segment id (1-based; index 0 collects padding
    and cross-segment boundaries and is discarded). ``forward_kw`` goes to
    the model's forward."""

    def score(model, tokens, segment_ids, positions):
        mask = (segment_ids > 0).float()
        logits = model(tokens, mask, compute_dtype, positions=positions,
                       segment_ids=segment_ids, **forward_kw)
        sums = _packed_sums(logits, tokens, segment_ids, n_segments)
        # n_tokens counts every real token of the segment (the first,
        # unscored one included) — the unpacked path's mask.sum parity
        return sums, _segment_sum(mask, segment_ids, n_segments)

    return score


def _bucket(n: int, least: int) -> int:
    """The smallest power of two that is at least ``n`` and ``least``."""
    return max(least, 1 << (max(n, 1) - 1).bit_length())


def _fetcher(sums: torch.Tensor, cnt: torch.Tensor, lo: int, n: int, length_penalty: float,
             name: str, counters: Optional[Dict[str, torch.Tensor]] = None,
             ) -> Callable[[], List[float]]:
    """The thunk that waits for the device: scores lo..lo+n-1. Its span
    ``name`` carries the request id of the dispatch that made it.
    ``counters`` (device scalars) come back in the scores' one copy and are
    counted (``utils.profiling.count``)."""
    rid = current_rid()

    def fetch() -> List[float]:
        with span(name, rid=rid):
            if counters:
                both = torch.cat([sums[lo : lo + n], cnt[lo : lo + n],
                                  torch.stack(list(counters.values())).float()]).cpu().numpy()
                s, c = both[:n], both[n : 2 * n]
                for key, v in zip(counters, both[2 * n:]):
                    count(key, float(v))
            else:
                s = sums[lo : lo + n].cpu().numpy()
                c = cnt[lo : lo + n].cpu().numpy()
            return (s - c * np.float32(length_penalty)).tolist()

    return fetch


class PackedScorer:
    """LLMScorer over ``model`` (the packed contract above): score(texts) =
    Σ token log-probs − length_penalty · n_tokens. ``encode`` maps (text,
    max_len) → token ids. ``pack`` puts several hypotheses in a row
    (block-diagonal attention; the same scores as one padded row each).
    ``score_async`` only enqueues the forward; its thunk fetches. The spans
    are ``<span_name>.dispatch`` and ``<span_name>.fetch``.

    A context is concatenated before each text (``supports_context``
    False): llm_rescore then passes it prepended, with the same totals.

    The packed rows are padded to a power of two (at least ``ROWS_LEAST``)
    and the segment bins to one (at least ``BINS_LEAST``), so a few shapes
    serve every n-best. Where the scorer keeps a ``GraphCache`` (``_graphs``,
    set by a subclass) and the tokens are on the card, each shape's forward
    is captured once as a CUDA graph and replayed: a dispatch is a copy of
    the inputs into the graph's buffers, one replay and copies of the
    outputs, which a later replay leaves as they are. Elsewhere (the CPU, a
    scorer without a cache) the forward runs op by op."""

    span_name = "lm"
    supports_context = False
    ROWS_LEAST = 1    # the packed rows' least bucket
    BINS_LEAST = 16   # the segment bins' least bucket
    _graphs: Optional[GraphCache] = None   # captured forwards by padded shape; None: eager

    def __init__(self, model, encode: Callable[[str, int], List[int]], device: torch.device,
                 max_len: int = 256, compute_dtype: torch.dtype = torch.float32,
                 pack: bool = True):
        self.model = model
        self.encode = encode
        self.device = device
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.pack = pack

    # hooks for a subclass: its rows on a mesh, their sums met across it,
    # and device counters the fetch copies with the scores
    def _my_rows(self, *arrays: np.ndarray) -> List[np.ndarray]:
        return list(arrays)

    def _meet(self, sums: torch.Tensor, cnt: torch.Tensor):
        return sums, cnt

    def _gather(self, sums: torch.Tensor, cnt: torch.Tensor):
        return sums, cnt

    def _counters(self, extra) -> Optional[Dict[str, torch.Tensor]]:
        """The device counters, by name, in ``_forward``'s third result."""
        return None

    def _forward(self, n_segments: int, tokens, seg, pos):
        """(sums, counts, None) of one packed forward, op by op; a subclass
        may return a device tensor third, which the fetch copies."""
        sums, cnt = score_packed_fn(n_segments, self.compute_dtype)(self.model, tokens, seg, pos)
        return sums, cnt, None

    def _replays(self, tokens: torch.Tensor) -> bool:
        """Whether the packed forward replays its shape's graph: where the
        scorer keeps graphs and the tokens are on the card."""
        return self._graphs is not None and tokens.device.type == "cuda"

    def _packed(self, n_segments: int, tokens, seg, pos):
        """``_forward``'s (sums, counts, third) of one packed forward,
        replayed where ``_replays``, else run op by op."""
        if self._replays(tokens):
            return self._replay(n_segments, tokens, seg, pos)
        return self._forward(n_segments, tokens, seg, pos)

    def _replay(self, n_segments: int, tokens, seg, pos):
        """The captured forward of this shape: the inputs copied into its
        buffers, one replay, the outputs copied out. A new shape's forward
        is captured over copies of its inputs, after one warm-up forward."""
        def capture():
            inputs = tuple(t.clone() for t in (tokens, seg, pos))
            return inputs, self._graphs.capture(lambda: self._forward(n_segments, *inputs),
                                                tokens.device)

        inputs, g = self._graphs.get((tokens.device, tuple(tokens.shape), n_segments), capture)
        for buf, x in zip(inputs, (tokens, seg, pos)):
            buf.copy_(x)
        g.replay()
        return tuple(None if t is None else t.clone() for t in g.out)

    def _pack_rows(self, ids: List[List[int]]):
        """First-fit-decreasing packing of token lists into rows of ``L``
        tokens (at least 64, a multiple of 16, at most ``max_len``):
        (tokens, segment ids (1-based, 0 = padding), positions within each
        segment, the number of segment bins: one a list plus the index-0
        trash bin)."""
        longest = max((len(s) for s in ids), default=1)
        L = min(self.max_len, max(64, -(-longest // 16) * 16))
        rows = pack_sequences(ids, L)
        B = max(len(rows), 1)
        tokens = np.zeros((B, L), np.int64)
        seg = np.zeros((B, L), np.int64)
        pos = np.zeros((B, L), np.int64)
        for r, row in enumerate(rows):
            off = 0
            for orig_idx, s in row:
                tokens[r, off : off + len(s)] = s
                seg[r, off : off + len(s)] = orig_idx + 1
                pos[r, off : off + len(s)] = np.arange(len(s))
                off += len(s)
        return tokens, seg, pos, len(ids) + 1

    def _pack_arrays(self, ids: List[List[int]]):
        """``_pack_rows``' arrays with zero rows after the packed ones up to
        the rows' bucket, and the bins' bucket."""
        tokens, seg, pos, n_segments = self._pack_rows(ids)
        pad = np.zeros((_bucket(tokens.shape[0], self.ROWS_LEAST) - tokens.shape[0],
                        tokens.shape[1]), np.int64)
        return (*(np.concatenate([a, pad]) for a in (tokens, seg, pos)),
                _bucket(n_segments, self.BINS_LEAST))

    def _score_packed_begin(
        self, ids: List[List[int]], length_penalty: float
    ) -> Callable[[], List[float]]:
        """Pack the hypotheses several-per-row (block-diagonal attention):
        the forward runs over ~real-token counts instead of one padded row
        per hypothesis. Score-identical to the unpacked path. Enqueues the
        forward on the device and returns the fetch; only the fetch waits."""
        tokens, seg, pos, n_segments = self._pack_arrays(ids)
        up = lambda a: upload(a, self.device)  # noqa: E731
        with torch.inference_mode():
            sums, cnt, extra = self._packed(n_segments,
                                            *map(up, self._my_rows(tokens, seg, pos)))
            sums, cnt = self._meet(sums, cnt)
        return _fetcher(sums, cnt, 1, len(ids), length_penalty, self.span_name + ".fetch",
                        self._counters(extra))

    def _score_unpacked_begin(
        self, ids: List[List[int]], length_penalty: float
    ) -> Callable[[], List[float]]:
        """One right-padded row per hypothesis."""
        n = len(ids)
        L = min(self.max_len, max(1, max((len(i) for i in ids), default=1)))
        tokens = np.zeros((max(n, 1), L), np.int64)
        mask = np.zeros((max(n, 1), L), np.float32)
        for i, seq in enumerate(ids):
            tokens[i, : len(seq)] = seq[:L]
            mask[i, : len(seq)] = 1.0
        tokens, mask = self._my_rows(tokens, mask)
        with torch.inference_mode():
            sums, n_tok = score_tokens_fn(self.compute_dtype)(
                self.model, upload(tokens, self.device), upload(mask, self.device))
            sums, n_tok = self._gather(sums, n_tok)
        return _fetcher(sums, n_tok, 0, n, length_penalty, self.span_name + ".fetch")

    def _context_begin(self, context: str, texts: Sequence[str],
                       length_penalty: float) -> Optional[Callable[[], List[float]]]:
        """A subclass's own path for a shared context, or None."""
        return None

    def _begin(self, ids: List[List[int]], length_penalty: float) -> Callable[[], List[float]]:
        if self.pack:
            return self._score_packed_begin(ids, length_penalty)
        return self._score_unpacked_begin(ids, length_penalty)

    def score_async(
        self,
        texts: Sequence[str],
        length_penalty: float = 0.0,
        context: Optional[str] = None,
    ) -> Callable[[], List[float]]:
        """Enqueue the scoring forward on the device NOW; the returned
        zero-arg callable fetches the scores. Lets a caller overlap the next
        utterance's host finalize work (augment, packing) with this
        utterance's forward — see decode/rescore.py llm_rescore_async.

        With ``context``, each text is scored as context+text (the
        reference's conversational mode, standalone :165-199)."""
        with span(self.span_name + ".dispatch"):
            if context:
                begin = self._context_begin(context, texts, length_penalty)
                if begin is not None:
                    return begin
                texts = [context + " " + t for t in texts]
            return self._begin([self.encode(t, self.max_len) for t in texts], length_penalty)

    def score(
        self,
        texts: Sequence[str],
        length_penalty: float = 0.0,
        context: Optional[str] = None,
    ) -> List[float]:
        return self.score_async(texts, length_penalty, context=context)()
