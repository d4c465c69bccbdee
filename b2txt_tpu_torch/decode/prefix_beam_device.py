"""Vectorized CTC prefix beam search on the device.

Counterpart of ``b2txt_tpu/decode/prefix_beam_jax.py``: the re-architecture
of the reference's pointer-chasing C++ searcher (ctc_prefix_beam_search.cc)
as a fixed-width beam of K hypotheses held in tensors:

    s, ns     (K,)  blank-/non-blank-ending log scores
    h1, h2    (K,)  64 bits of rolling prefix hash (dedupe identity)
    last      (K,)  last emitted symbol

Each frame expands K×V candidates (stay + extend-with-c), sorts them by
hash, merges duplicate prefixes with a segmented log-sum-exp and keeps the
top K. Backpointers (parent beam, emitted symbol) stay on the device and
come to the host once per utterance for sequence reconstruction.

What differs from the JAX module, and why:

- The 32-bit hashes are int64 tensors holding uint32 values, wrapped with
  ``& 0xFFFFFFFF`` after each multiply (PyTorch's uint32 has few CUDA ops).
- ``lax.sort(num_keys=2)`` is one stable sort on an int64 key whose signed
  order is the unsigned order of (h1, h2); candidates with equal hashes
  keep their order, as in the stable ``lax.sort``.
- ``lax.associative_scan``'s pairwise merge is one max-shifted
  log-sum-exp per segment (a fixed-order segment sum, so two runs on the
  card give the same bits): it rounds differently, so scores agree with
  the JAX package's within 1e-4, not bit for bit.
- ``torch.topk`` breaks ties differently from ``lax.top_k``: beams at the
  NEG score floor may sit in other slots; they never outrank a real prefix.
- ``lax.scan`` over T is a Python loop over frames that issues device work
  without waiting for it; the frames past ``input_length`` (a host int)
  are not run and their backpointers are the identity.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.segment import sorted_segment_sum
from ..utils.device import resolve_device

NEG = -1.0e30
_MASK32 = 0xFFFFFFFF


def _mix(h: torch.Tensor, c: torch.Tensor, seed: int) -> torch.Tensor:
    """One xorshift-multiply avalanche round combining hash h with symbol c
    (uint32 arithmetic on int64 values in [0, 2^32))."""
    x = h ^ ((c * seed) & _MASK32)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    m_safe = m.clamp(min=NEG)
    out = m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))
    return out.masked_fill(m <= NEG, NEG)


def _segment_logsumexp(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """log Σ exp over each segment of ``values`` (segment ids ``seg`` in
    [0, n), sorted); NEG where every value of a segment is at or below NEG."""
    m = torch.full((n,), -math.inf, dtype=values.dtype, device=values.device)
    m.scatter_reduce_(0, seg, values, "amax")
    m_safe = m.clamp(min=NEG)
    tot = sorted_segment_sum(torch.exp(values - m_safe[seg]), seg, n)
    return (m_safe + torch.log(tot)).masked_fill(m <= NEG, NEG)


class BeamState(NamedTuple):
    s: torch.Tensor      # (K,) float32
    ns: torch.Tensor     # (K,) float32
    h1: torch.Tensor     # (K,) int64 holding uint32
    h2: torch.Tensor     # (K,) int64 holding uint32
    last: torch.Tensor   # (K,) int64, -1 for the empty prefix


def init_state(beam_width: int, device) -> BeamState:
    k = torch.arange(beam_width, dtype=torch.int64, device=device)
    return BeamState(
        s=torch.where(k == 0, 0.0, NEG).float(),
        ns=torch.full((beam_width,), NEG, dtype=torch.float32, device=device),
        # distinct sentinel hashes for unused slots so they never merge with
        # real prefixes; slot 0 (the empty prefix) hashes to a fixed seed pair
        h1=torch.where(k == 0, 0x12345678, 0x80000000 | k),
        h2=torch.where(k == 0, 0x9ABCDEF0, 0x40000000 | k),
        last=torch.full((beam_width,), -1, dtype=torch.int64, device=device),
    )


def _expand_step(state: BeamState, lp: torch.Tensor, blank: int
                 ) -> Tuple[BeamState, torch.Tensor, torch.Tensor]:
    """One frame of beam expansion. lp: (V,) masked log-probs.
    Returns (new_state, parents (K,), syms (K,))."""
    K = state.s.shape[0]
    V = lp.shape[0]
    dev = lp.device
    score = _logaddexp(state.s, state.ns)
    has_last = state.last >= 0

    # --- stay candidates: same prefix
    lp_last = torch.where(has_last, lp[state.last.clamp(0, V - 1)], NEG)
    stay_s = score + lp[blank]
    stay_ns = torch.where(has_last, state.ns + lp_last, NEG)

    # --- extend candidates: prefix + c for every non-blank symbol
    syms = torch.arange(V, dtype=torch.int64, device=dev)
    nonblank = syms != blank
    c = syms[None, :].expand(K, V)
    base = torch.where(c == state.last[:, None], state.s[:, None], score[:, None])
    ext_ns = torch.where(nonblank[None, :], base + lp[None, :], NEG)
    kk = torch.arange(K, dtype=torch.int64, device=dev)

    h1 = torch.cat([state.h1, _mix(state.h1[:, None], c, 0x9E3779B9).reshape(-1)])
    h2 = torch.cat([state.h2, _mix(state.h2[:, None], c, 0x7F4A7C15).reshape(-1)])
    s = torch.cat([stay_s, torch.full((K * V,), NEG, dtype=torch.float32, device=dev)])
    ns = torch.cat([stay_ns, ext_ns.reshape(-1)])
    last = torch.cat([state.last, c.reshape(-1)])
    parent = torch.cat([kk, kk[:, None].expand(K, V).reshape(-1)])
    sym = torch.cat([torch.full((K,), -1, dtype=torch.int64, device=dev),
                     torch.where(nonblank[None, :], c, -1).reshape(-1)])

    # --- dedupe: stable sort by (h1, h2), segmented log-sum-exp merge
    key = (h1 - (1 << 31)) * (1 << 32) + h2      # signed order = unsigned (h1, h2)
    key_s, perm = torch.sort(key, stable=True)
    N = key.shape[0]
    starts = torch.ones(N, dtype=torch.bool, device=dev)
    starts[1:] = key_s[1:] != key_s[:-1]
    seg = starts.cumsum(0) - 1
    s_tot = _segment_logsumexp(s[perm], seg, N)[seg]
    ns_tot = _segment_logsumexp(ns[perm], seg, N)[seg]
    seg_end = torch.ones(N, dtype=torch.bool, device=dev)
    seg_end[:-1] = starts[1:]
    total = torch.where(seg_end, _logaddexp(s_tot, ns_tot), -math.inf)

    top_total, top_idx = torch.topk(total, K)
    live = top_total > -math.inf
    win = perm[top_idx]                          # each segment's last candidate
    new_state = BeamState(
        s=torch.where(live, s_tot[top_idx], NEG),
        ns=torch.where(live, ns_tot[top_idx], NEG),
        h1=h1[win], h2=h2[win], last=last[win],
    )
    return new_state, parent[win], sym[win]


def beam_search_scan(
    log_probs: torch.Tensor,
    input_length: Optional[int] = None,
    beam_width: int = 64,
    blank: int = 0,
    first_beam_size: Optional[int] = None,
):
    """Run the search over (T, V) log-probs on their device; frames past
    ``input_length`` are frozen. Returns (final BeamState, parents (T, K),
    syms (T, K)), all on the device."""
    T, V = log_probs.shape
    n = T if input_length is None else min(int(input_length), T)
    dev = log_probs.device
    state = init_state(beam_width, dev)
    keep = torch.arange(beam_width, dtype=torch.int64, device=dev)
    parents = keep[None, :].repeat(T, 1)
    syms = torch.full((T, beam_width), -1, dtype=torch.int64, device=dev)
    for t in range(n):
        lp = log_probs[t].float()
        if first_beam_size is not None and first_beam_size < V:
            kth = torch.topk(lp, first_beam_size).values[-1]
            lp = torch.where(lp >= kth, lp, -math.inf)
        state, parents[t], syms[t] = _expand_step(state, lp, blank)
    return state, parents, syms


def backtrace(parents: np.ndarray, syms: np.ndarray, beam: int) -> List[int]:
    """Reconstruct the symbol sequence of ``beam`` from the backpointer arrays."""
    seq: List[int] = []
    k = beam
    for t in range(parents.shape[0] - 1, -1, -1):
        if syms[t, k] >= 0:
            seq.append(int(syms[t, k]))
        k = int(parents[t, k])
    seq.reverse()
    return seq


def ctc_prefix_beam_search_device(
    log_probs: Union[np.ndarray, torch.Tensor],
    input_length: Optional[int] = None,
    beam_width: int = 64,
    blank: int = 0,
    first_beam_size: Optional[int] = None,
    nbest: int = 10,
    device=None,
) -> List[Tuple[List[int], float]]:
    """One-shot decode of a (T, V) utterance → [(ids, log_prob)] best-first.
    A tensor runs on its own device; a numpy array is moved to ``device``
    (None = the CUDA card)."""
    if not torch.is_tensor(log_probs):
        log_probs = torch.from_numpy(np.asarray(log_probs, np.float32)).to(
            resolve_device(device))
    state, parents, syms = beam_search_scan(
        log_probs, input_length, beam_width=beam_width, blank=blank,
        first_beam_size=first_beam_size)
    s = state.s.cpu().numpy()
    ns = state.ns.cpu().numpy()
    score = np.logaddexp(np.where(s <= NEG, -np.inf, s), np.where(ns <= NEG, -np.inf, ns))
    parents = parents.cpu().numpy()
    syms = syms.cpu().numpy()
    order = np.argsort(-score, kind="stable")[:nbest]
    return [(backtrace(parents, syms, int(k)), float(score[k]))
            for k in order if np.isfinite(score[k])]
