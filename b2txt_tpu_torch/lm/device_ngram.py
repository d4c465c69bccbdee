"""Device-resident n-gram model: a bucketed hash table in device memory plus
dense unigrams.

Counterpart of ``b2txt_tpu/lm/device_ngram.py``. The layout is the same,
and the packed table is the same array bit for bit: every n-gram of order
>= 2 lives in ONE bucketed table whose rows are buckets of 16 slots
``[key1, key2, value_bits, backoff_bits]`` (256 B of int32), so the beam
search probes a word with one row gather; unigrams are dense arrays indexed
by word id. The backoff recursion of
``NGramLM.logp`` resolves from the stacked probe results as a fixed,
unrolled select chain.

Keys are 64 bits (two uint32 lanes) from the xorshift-avalanche mix that the
searcher also uses for hypothesis identity. On the tensor side a uint32 key
is held as the int32 with the same bits: multiplies wrap modulo 2^32 and
right shifts are arithmetic shifts masked to the logical result, so every
key equals ``_mix_np``'s bit for bit, top bit included. There is no ``jit``:
the table is a tensor on the searcher's device, probed with plain indexing.

``ShardedNGram`` is the row-sharded view of one table over a process group
(the JAX package's ``ShardedNGram``, :539-604): every probe goes through
``DeviceNGram._lookup``, which the view overrides with the collective probe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .lexicon import Lexicon
from .ngram import BOS, EOS, NGramLM, UNK

BUCKET_CAP = 16      # slots per bucket: one (16, 4) int32 = 256 B row
BIG_TABLE_ENTRIES = 8_000_000  # above this, buckets double to 32 slots
TARGET_MEAN = 4      # keys per bucket on average (load factor 0.25)
MISSING = -1.0e9     # dense-unigram sentinel for "no entry"

Device = Union[str, torch.device, None]


def _mix_np(h: np.ndarray, c: np.ndarray, seed: int) -> np.ndarray:
    with np.errstate(over="ignore"):  # modular uint32 arithmetic is intended
        x = (h ^ (c.astype(np.uint32) * np.uint32(seed))).astype(np.uint32)
        x = ((x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x = ((x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)).astype(np.uint32)
        return (x ^ (x >> np.uint32(16))).astype(np.uint32)


def _i32(x: int) -> int:
    """The int32 with the bits of the uint32 ``x``."""
    return x - (1 << 32) if x >= 1 << 31 else x


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 bits."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _mix(h: torch.Tensor, c: torch.Tensor, seed: int) -> torch.Tensor:
    """``_mix_np`` on int32 tensors holding uint32 bits (int32 multiplies
    wrap modulo 2^32, as uint32 ones do)."""
    x = h ^ (c * _i32(seed))
    x = (x ^ _srl(x, 16)) * _i32(0x85EBCA6B)
    x = (x ^ _srl(x, 13)) * _i32(0xC2B2AE35)
    return x ^ _srl(x, 16)


SEED1, SEED2 = 0x9E3779B9, 0x7F4A7C15
H1_INIT, H2_INIT = 0x811C9DC5, 0x01000193


def hash_ids_np(ids: Sequence[int]) -> Tuple[np.uint32, np.uint32]:
    h1 = np.uint32(0x811C9DC5)
    h2 = np.uint32(0x01000193)
    for i in ids:
        c = np.uint32(np.int64(i) + 3)
        h1 = _mix_np(h1, c, SEED1)
        h2 = _mix_np(h2, c, SEED2)
    return h1, h2


def hash_ids_batch(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized hash_ids_np over an (N, L) id matrix — the 100M-entry ARPA
    streaming path hashes whole chunks in L column passes."""
    n = ids.shape[0]
    h1 = np.full(n, 0x811C9DC5, np.uint32)
    h2 = np.full(n, 0x01000193, np.uint32)
    for j in range(ids.shape[1]):
        with np.errstate(over="ignore"):
            c = (ids[:, j].astype(np.int64) + 3).astype(np.uint32)
        h1 = _mix_np(h1, c, SEED1)
        h2 = _mix_np(h2, c, SEED2)
    return h1, h2


def hash_extend(h1: torch.Tensor, h2: torch.Tensor, wid: torch.Tensor):
    """Extend the key pairs (h1, h2) by word ids ``wid`` (broadcasting):
    ``hash_extend_jnp``."""
    c = (wid + 3).to(torch.int32)
    return _mix(h1, c, SEED1), _mix(h2, c, SEED2)


def hash_init(shape, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key pair of the empty sequence, broadcast to ``shape``."""
    kw = dict(dtype=torch.int32, device=device)
    return torch.full(shape, _i32(H1_INIT), **kw), torch.full(shape, _i32(H2_INIT), **kw)


def hash_ctx(ctx: torch.Tensor):
    """64-bit identity hash of an LM-context window (..., CW) — the ngram
    state keying of the device searcher (``hash_ctx_jnp``: hypotheses sharing
    the last order−1 words merge)."""
    h1, h2 = hash_init(ctx.shape[:-1], ctx.device)
    for i in range(ctx.shape[-1]):  # CW is small (order-1)
        h1, h2 = hash_extend(h1, h2, ctx[..., i])
    return h1, h2


@dataclass
class BucketTable:
    """Bucketed open hash table: (key1, key2) uint32 pair → (value, backoff).

    Packed layout: (n_buckets, BUCKET_CAP * 4) int32 rows with slot-major
    columns [key1, key2, value_bits, backoff_bits] × BUCKET_CAP, so every
    probe is ONE aligned contiguous row gather. Bucket id = key1 &
    (n_buckets − 1). int32 storage keeps value bit patterns exact.
    """

    packed: np.ndarray   # (n_buckets, BUCKET_CAP*4) int32

    @classmethod
    def build_arrays(
        cls,
        h1: np.ndarray,
        h2: np.ndarray,
        values: np.ndarray,
        backoffs: np.ndarray,
    ) -> "BucketTable":
        """Vectorized build from parallel arrays (the 100M-entry path)."""
        h1 = h1.astype(np.uint32).copy()
        h2 = h2.astype(np.uint32)
        zero = (h1 == 0) & (h2 == 0)
        h1[zero] = 1  # key (0,0) is the empty marker

        # dedup identical 64-bit keys (keep first — matches host behavior)
        key64 = h1.astype(np.uint64) << np.uint64(32) | h2.astype(np.uint64)
        _, first_idx = np.unique(key64, return_index=True)
        if len(first_idx) != len(key64):
            keep = np.sort(first_idx)
            h1, h2 = h1[keep], h2[keep]
            values, backoffs = values[keep], backoffs[keep]

        n = max(len(h1), 1)
        # bucket capacity adapts to scale: 16 slots (256 B rows) for small
        # tables, 32 slots (512 B rows) once tens of millions of entries make
        # the Poisson tail of a 16-slot bucket non-negligible
        cap = BUCKET_CAP if n < BIG_TABLE_ENTRIES else 2 * BUCKET_CAP
        n_buckets = 1
        while n_buckets * (cap // 4) < n:
            n_buckets *= 2
        while True:
            bucket = (h1 & np.uint32(n_buckets - 1)).astype(np.int64)
            counts = np.bincount(bucket, minlength=n_buckets)
            if counts.max(initial=0) <= cap:
                break
            n_buckets *= 2  # Poisson-tail overflow: relax the load factor

        order = np.argsort(bucket, kind="stable")
        sorted_b = bucket[order]
        starts = np.zeros(n_buckets, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        pos = np.arange(len(h1), dtype=np.int64) - starts[sorted_b]
        slot = sorted_b * cap + pos

        flat = np.zeros((n_buckets * cap, 4), np.int32)
        flat[slot, 0] = h1[order].view(np.int32)
        flat[slot, 1] = h2[order].view(np.int32)
        flat[slot, 2] = values[order].astype(np.float32).view(np.int32)
        flat[slot, 3] = backoffs[order].astype(np.float32).view(np.int32)
        return cls(flat.reshape(n_buckets, cap * 4))

    @classmethod
    def build(
        cls, entries: Dict[Tuple[int, ...], Tuple[float, float]]
    ) -> "BucketTable":
        """From {id tuple: (logp, backoff)}. The keys are hashed with
        ``hash_ids_batch``, one pass per tuple length, into the entries'
        own order, so the packed array is the per-entry build's."""
        n = len(entries)
        h1 = np.empty(n, np.uint32)
        h2 = np.empty(n, np.uint32)
        vb = np.asarray(list(entries.values()), np.float32).reshape(n, 2)
        keys = list(entries)
        by_len: Dict[int, List[int]] = {}
        for i, ids in enumerate(keys):
            by_len.setdefault(len(ids), []).append(i)
        for length, rows in by_len.items():
            rows = np.asarray(rows, np.int64)
            ids = np.asarray([keys[i] for i in rows], np.int64).reshape(len(rows), length)
            h1[rows], h2[rows] = hash_ids_batch(ids)
        return cls.build_arrays(h1, h2, vb[:, 0], vb[:, 1])

    def as_device(self, device: torch.device) -> Tuple[torch.Tensor, int]:
        """(packed table on ``device``, slots per bucket)."""
        cap = self.packed.shape[1] // 4
        return torch.from_numpy(self.packed).to(device), cap


def _lookup(table: Tuple[torch.Tensor, int], h1: torch.Tensor, h2: torch.Tensor,
            not_found: float):
    """Probe table for keys (h1, h2). Returns (value, backoff, found).

    One contiguous row gather per key fetches the whole bucket; keys are
    unique in the table (build dedups), so the bucket holds AT MOST one hit
    and the select reduces to a masked sum.
    """
    packed, cap = table
    n_buckets = packed.shape[0]
    h1 = _nonzero_key(h1, h2)
    rows = packed[h1 & (n_buckets - 1)]                  # (..., cap*4): 1 row gather
    return _match(rows, cap, h1, h2, not_found)


def _nonzero_key(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """(0, 0) marks an empty slot: such a key probes as h1 = 1."""
    return torch.where((h1 == 0) & (h2 == 0), torch.ones_like(h1), h1)


def _match(rows: torch.Tensor, cap: int, h1: torch.Tensor, h2: torch.Tensor,
           not_found: float):
    """(value, backoff, found) of keys (h1, h2) in their bucket rows."""
    rows = rows.reshape(rows.shape[:-1] + (cap, 4))
    hit = (rows[..., 0] == h1[..., None]) & (rows[..., 1] == h2[..., None])
    found = hit.any(dim=-1)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    vbits = torch.where(hit, rows[..., 2], zero).sum(dim=-1).to(torch.int32)
    bbits = torch.where(hit, rows[..., 3], zero).sum(dim=-1).to(torch.int32)
    v = torch.where(found, vbits.view(torch.float32), not_found)
    b_ = torch.where(found, bbits.view(torch.float32), 0.0)
    return v, b_, found


@dataclass
class DeviceNGram:
    """Packed n-gram LM. Word ids are lexicon ids; BOS/EOS/UNK get reserved
    ids n_words, n_words+1, n_words+2.

    Orders >= 2 live in ONE unified bucketed table (the 64-bit sequence hash
    keeps different-length grams distinct); unigrams are dense arrays indexed
    by word id (uni_logp holds MISSING for absent words, raw ARPA values —
    including NO_PROB — otherwise). A full backoff-chain query for H words
    sharing a context costs (order−1)·H bucket rows + (order−2) context rows
    + H+1 dense element reads.
    """

    order: int
    n_words: int
    table: Tuple[torch.Tensor, int]
    uni_logp: torch.Tensor   # (n_words+3,) f32, MISSING if absent
    uni_bow: torch.Tensor    # (n_words+3,) f32, 0 if absent
    unk_logp: float
    n_entries: int = 0       # total packed n-grams (all orders), set at build

    @property
    def bos_id(self) -> int:
        return self.n_words

    @property
    def eos_id(self) -> int:
        return self.n_words + 1

    @property
    def unk_id(self) -> int:
        return self.n_words + 2

    @property
    def device(self) -> torch.device:
        return self.uni_logp.device

    @property
    def table_bytes(self) -> int:
        """Bytes of the tensors on the device: bucket table and unigrams."""
        return sum(t.numel() * t.element_size()
                   for t in (self.table[0], self.uni_logp, self.uni_bow))

    @classmethod
    def from_arpa_streaming(
        cls, path: str, lexicon: Lexicon, max_order: Optional[int] = None,
        device: Device = None,
    ) -> "DeviceNGram":
        """Build directly from an ARPA file — the large-model path. Bucketed
        slots are 16 bytes at a 0.25 load factor (~64 B per n-gram in device
        memory). ``device`` None means the CUDA card (raises without one)."""
        import gzip

        from .arpa import LOG10

        device = resolve_device(device)
        n_words = len(lexicon.words)
        special = {BOS: n_words, EOS: n_words + 1, UNK: n_words + 2}

        def wid(w: str) -> int:
            if w in special:
                return special[w]
            return lexicon.word_ids.get(w, -2)

        opener = gzip.open if path.endswith(".gz") else open
        # pass 1: counts
        counts: List[int] = []
        with opener(path, "rt") as f:
            for line in f:
                line = line.strip()
                if line.startswith("ngram "):
                    counts.append(int(line.split("=")[1]))
                elif line.startswith("\\1-grams"):
                    break
        order = len(counts) if max_order is None else min(len(counts), max_order)

        unk_logp = -23.0
        uni_logp = np.full(n_words + 3, MISSING, np.float32)
        uni_bow = np.zeros(n_words + 3, np.float32)
        # preallocate from the header counts (upper bound)
        n_hi = sum(counts[1:order]) if order > 1 else 0
        hi_h1 = np.empty(n_hi, np.uint32)
        hi_h2 = np.empty(n_hi, np.uint32)
        hi_v = np.empty(n_hi, np.float32)
        hi_b = np.empty(n_hi, np.float32)
        n_filled = 0
        CHUNK = 1 << 18
        ids_buf = np.empty((CHUNK, order), np.int64)
        vb_buf = np.empty((CHUNK, 2), np.float32)

        def flush(cur: int, n: int):
            nonlocal n_filled
            if n == 0 or cur == 1:
                return
            ids = ids_buf[:n, :cur]
            ok = ~(ids == -2).any(axis=1)
            ids, vb = ids[ok], vb_buf[:n][ok]
            h1, h2 = hash_ids_batch(ids)
            m = len(h1)
            hi_h1[n_filled : n_filled + m] = h1
            hi_h2[n_filled : n_filled + m] = h2
            hi_v[n_filled : n_filled + m] = vb[:, 0]
            hi_b[n_filled : n_filled + m] = vb[:, 1]
            n_filled += m

        with opener(path, "rt") as f:
            # skip to first gram section
            for line in f:
                if line.strip() == "\\1-grams:":
                    break
            cur = 1
            n_buf = 0
            for line in f:
                s = line.strip()
                if s.startswith("\\") and s.endswith("-grams:"):
                    flush(cur, n_buf)
                    n_buf = 0
                    cur = int(s[1:].split("-")[0])
                    if cur > order:
                        break
                    continue
                if s == "\\end\\":
                    break
                if not s:
                    continue
                parts = s.split()
                try:
                    logp = float(parts[0]) * LOG10
                except ValueError:
                    continue
                words = parts[1 : 1 + cur]
                bow = (
                    float(parts[1 + cur]) * LOG10
                    if len(parts) > 1 + cur else 0.0
                )
                if cur == 1:
                    if words[0] == UNK:
                        unk_logp = logp
                    i = wid(words[0])
                    if i >= 0:
                        uni_logp[i] = logp
                        uni_bow[i] = bow
                    continue
                for j, w in enumerate(words):
                    ids_buf[n_buf, j] = wid(w)
                vb_buf[n_buf, 0] = logp
                vb_buf[n_buf, 1] = bow
                n_buf += 1
                if n_buf == CHUNK:
                    flush(cur, n_buf)
                    n_buf = 0
            flush(cur, n_buf)
        table = BucketTable.build_arrays(
            hi_h1[:n_filled], hi_h2[:n_filled],
            hi_v[:n_filled], hi_b[:n_filled],
        )
        n_uni = int(np.count_nonzero(uni_logp > MISSING / 2))
        return cls(order=order, n_words=n_words, table=table.as_device(device),
                   uni_logp=torch.from_numpy(uni_logp).to(device),
                   uni_bow=torch.from_numpy(uni_bow).to(device),
                   unk_logp=float(unk_logp), n_entries=n_filled + n_uni)

    @classmethod
    def build(cls, lm: NGramLM, lexicon: Lexicon, device: Device = None) -> "DeviceNGram":
        """Pack a host NGramLM over ``lexicon``'s word ids. ``device`` None
        means the CUDA card (raises without one)."""
        device = resolve_device(device)
        n_words = len(lexicon.words)
        special = {BOS: n_words, EOS: n_words + 1, UNK: n_words + 2}

        def wid(w: str) -> int:
            if w in special:
                return special[w]
            return lexicon.word_ids.get(w, -1)

        uni_logp = np.full(n_words + 3, MISSING, np.float32)
        uni_bow = np.zeros(n_words + 3, np.float32)
        for gram, (logp, bow) in lm.tables[0].items():
            i = wid(gram[0])
            if i >= 0:
                uni_logp[i] = logp
                uni_bow[i] = bow

        packed: Dict[Tuple[int, ...], Tuple[float, float]] = {}
        for k in range(1, lm.order):
            for gram, (logp, bow) in lm.tables[k].items():
                ids = tuple(wid(w) for w in gram)
                if any(i < 0 for i in ids):
                    continue  # word not in decode lexicon
                packed[ids] = (logp, bow)
        unk = lm.tables[0].get((UNK,), (-23.0, 0.0))[0]
        n_uni = int(np.count_nonzero(uni_logp > MISSING / 2))
        return cls(order=lm.order, n_words=n_words,
                   table=BucketTable.build(packed).as_device(device),
                   uni_logp=torch.from_numpy(uni_logp).to(device),
                   uni_bow=torch.from_numpy(uni_bow).to(device),
                   unk_logp=float(unk), n_entries=len(packed) + n_uni)

    def context_hashes(self, context: torch.Tensor):
        """Key pairs of each context suffix, longest first (length order−1
        down to 1). context: (..., order-1) ids, -1 left-padded; each pair is
        shaped (...)."""
        ctxs = []
        for start in range(self.order - 1):
            h1, h2 = hash_init(context.shape[:-1], context.device)
            for j in range(start, self.order - 1):
                w = context[..., j]
                h1n, h2n = hash_extend(h1, h2, w)
                use = w >= 0
                h1 = torch.where(use, h1n, h1)
                h2 = torch.where(use, h2n, h2)
            ctxs.append((h1, h2))
        return ctxs

    def _lookup(self, h1: torch.Tensor, h2: torch.Tensor, not_found: float):
        """Probe entry point; ``ShardedNGram`` overrides it with the
        collective probe."""
        return _lookup(self.table, h1, h2, not_found)

    def logp_words(
        self,
        context: torch.Tensor,
        words: torch.Tensor,
        uni_logp_w: Optional[torch.Tensor] = None,
        n_exact: Optional[int] = None,
    ) -> torch.Tensor:
        """log P(word | context) for SETS of candidate words, each set
        sharing one context. context: (..., order-1) ids, -1 padded on the
        LEFT (most recent word last); words: (..., H). Returns (..., H)
        log-probs. ``logp_words`` of the JAX package with its ``vmap`` over
        beams written out as the leading dimensions.

        ``uni_logp_w`` optionally supplies the words' dense unigram
        log-probs (the fused beam search pre-packs them per trie node).
        Context suffix hashing and the backoff-weight probes run once per
        context, not once per candidate word.

        ``n_exact`` probes the gram tables only for the FIRST n_exact words;
        the tail gets the full backoff-chain-to-unigram score (exact whenever
        no higher-order gram exists for that word in this context). Intended
        for use with the unpruned pool rescore.
        """
        order = self.order
        H = words.shape[-1]
        if uni_logp_w is None:
            uni_logp_w = self.uni_logp[words.clamp(min=0)]       # (..., H)

        if order > 1:
            n_valid = (context >= 0).sum(dim=-1, keepdim=True)  # (..., 1)
            ctxs = self.context_hashes(context)
            levels = list(range(order - 1, 0, -1))  # ctx suffix lengths, desc
            probe_w = (words if n_exact is None or n_exact >= H
                       else words[..., :n_exact])
            # gram probes for levels order−1..1 — ONE stacked row gather
            keys = [hash_extend(ctxs[(order - 1) - l][0][..., None],
                                ctxs[(order - 1) - l][1][..., None], probe_w)
                    for l in levels]
            gk1 = torch.stack([k[0] for k in keys])               # (o-1, ..., C)
            gk2 = torch.stack([k[1] for k in keys])
            # context-backoff probes: suffix lengths order−1..2 via the table
            # (length 1 via the dense unigram backoff), in the same probe as
            # the grams: one row gather (one exchange when sharded) for both
            ng = gk1.numel()
            if order > 2:
                ck1 = torch.stack([ctxs[(order - 1) - l][0] for l in levels[:-1]])
                ck2 = torch.stack([ctxs[(order - 1) - l][1] for l in levels[:-1]])
                gk1 = torch.cat([gk1.reshape(-1), ck1.reshape(-1)])
                gk2 = torch.cat([gk2.reshape(-1), ck2.reshape(-1)])
            v, b_, f = self._lookup(gk1, gk2, self.unk_logp)
            gshape = (len(levels),) + probe_w.shape
            vg, fg = v[:ng].view(gshape), f[:ng].view(gshape)
            if order > 2:
                bows_hi, fcs_hi = b_[ng:].view(ck1.shape), f[ng:].view(ck1.shape)
            if probe_w.shape[-1] < H:
                pad = H - probe_w.shape[-1]
                vg = torch.nn.functional.pad(vg, (0, pad))
                fg = torch.nn.functional.pad(fg, (0, pad))  # False → backoff chain
            last = context[..., order - 2].clamp(min=0)
            bow1 = self.uni_bow[last][..., None]
            exists1 = (self.uni_logp[last] > MISSING / 2)[..., None]

        # longest-match with accumulated backoff, unrolled over orders
        shape = words.shape
        result = torch.full(shape, self.unk_logp, dtype=torch.float32, device=words.device)
        resolved = torch.zeros(shape, dtype=torch.bool, device=words.device)
        bo_acc = torch.zeros(shape, dtype=torch.float32, device=words.device)
        if order > 1:
            for i, level in enumerate(levels):
                level_ok = n_valid >= level
                v, found = vg[i], fg[i]
                # NO_PROB (-99 log10) entries exist only as backoff contexts
                hit = found & (v > -200.0) & level_ok & ~resolved
                result = torch.where(hit, bo_acc + v, result)
                resolved = resolved | hit
                if level >= 2:
                    bow_l, exists_l = bows_hi[i][..., None], fcs_hi[i][..., None]
                else:
                    bow_l, exists_l = bow1, exists1
                add = torch.where(exists_l & level_ok & ~resolved, bow_l, 0.0)
                bo_acc = bo_acc + add
        # level 0: dense unigram
        hit0 = (uni_logp_w > -200.0) & ~resolved
        result = torch.where(hit0, bo_acc + uni_logp_w, result)
        resolved = resolved | hit0
        return torch.where(resolved, result, bo_acc + self.unk_logp)

    def logp(self, context: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        """log P(word | context): context (..., order-1), word (...) → (...)."""
        return self.logp_words(context, word[..., None])[..., 0]


@dataclass
class ShardedNGram(DeviceNGram):
    """A ``DeviceNGram`` whose bucket table is ROW-SHARDED over a process
    group of D ranks: the capacity design for reference-scale LMs (the
    reference's ~300 GB-RAM SRILM 5-gram becomes bucket rows split D ways).

    ``table`` is this rank's block: the n_buckets/D consecutive bucket rows
    [r·n/D, (r+1)·n/D) (the high bits of the bucket id pick the owner). A
    probe all-gathers the keys of every rank over ``group``, answers the
    keys this rank owns from its block (zero rows for the others), sums the
    rows over the group with a reduce-scatter, which leaves each rank the
    sum of its own keys' rows, and matches them. A key's row comes from its
    one owner plus zero rows, so the probe equals the unsharded one bit for
    bit. Every rank of the group must probe the same number of times with
    keys of the same shapes (``decode/lmbeam_device.py``'s
    ``sharded_decode_batch`` sees to it)."""

    group: object = None

    def _lookup(self, h1: torch.Tensor, h2: torch.Tensor, not_found: float):
        import torch.distributed as dist

        from ..parallel.comm import gather_rows, reduce_scatter_rows

        shard, cap = self.table
        D, r = dist.get_world_size(self.group), dist.get_rank(self.group)
        local_n = shard.shape[0]
        h1 = _nonzero_key(h1, h2)
        all_h1 = gather_rows(h1, self.group)                  # (D, ...): every rank's keys
        bucket = all_h1 & (local_n * D - 1)
        mine = (bucket // local_n) == r
        rows = shard[torch.where(mine, bucket % local_n, 0)]  # local gather
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))
        rows = reduce_scatter_rows(rows, self.group)          # my keys' rows
        return _match(rows, cap, h1, h2, not_found)

    @classmethod
    def from_device_ngram(cls, dev: DeviceNGram, shard: torch.Tensor, group) -> "ShardedNGram":
        """The view of ``dev`` whose table is this rank's block ``shard``."""
        return cls(order=dev.order, n_words=dev.n_words, table=(shard, dev.table[1]),
                   uni_logp=dev.uni_logp, uni_bow=dev.uni_bow, unk_logp=dev.unk_logp,
                   n_entries=dev.n_entries, group=group)
