"""The device beam search's frame step as one CUDA kernel (K6).

K6, ``csrc/beam_step.cu``, replaces no TPU kernel: the JAX package's frame
step (``decode/lmbeam_jax.py``) is XLA. It is the body of the port's
``DeviceLexiconBeamSearch._expand`` with the frame step's masking and record
writes (``decode/lmbeam_device.py``), ~600 small kernels a frame when issued
op by op: one CTA a row of the batch builds the row's candidates (stay,
extend by the first beam's phones, silence at the root, close with its
n-gram probes), merges
duplicate states and keeps the K best, in shared memory, and writes the
new beams over the old ones in place. Where a frame's candidates outgrow a
CTA's shared memory (K = 128 with every phone in the first beam), they and
their sorts take the row's slice of a workspace (``workspace``). The
source says what bounds it.

``beam_step`` launches it for CUDA tensors; it has no CPU mode, and the
search's plain version is ``_expand`` (the CPU, the sharded n-gram).
``beam_step.launches`` counts launches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

THREADS = 512
SMEM_BYTES = 232448 - 1024   # a CTA's shared memory on Hopper less its static variables
MAX_BEAMS = 32767            # parents are int16


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def layout(K: int, V: int, H: int, CW: int, order: int) -> Tuple[int, int, int]:
    """(shared memory a CTA takes, of it the beams' own arrays, workspace
    bytes a row): ``b2t_beam_step_smem``, ``_fixed`` and ``_work`` in the
    source. Room is planned for up to K * (2 + V + H) candidates, since
    every phone may be in the first beam (ties at its threshold extend
    too); where they and the beams' arrays outgrow a CTA, the CTA takes
    all of its shared memory, and a row's candidates that do not fit there
    go to the workspace."""
    L = max(order - 1, 0)
    fixed = sum(_pad16(n) for n in (
        20 * K, 36 * K, 4 * K * CW, 4 * K * H, 4 * K * H, 4 * K * H, 8 * K * L, 4 * L * K * H,
        L * K * H, 4 * max(L - 1, 0) * K, max(L - 1, 0) * K, K, 4 * K * V, 4 * K * V, 4 * V,
        4 * V))
    N = K * (2 + V + H)
    P = 1 << max(N - 1, 0).bit_length()
    most = 2 * _pad16(8 * P) + _pad16(16 * N) + _pad16(4 * P)
    if fixed + most <= SMEM_BYTES:
        return fixed + most, fixed, 0
    return SMEM_BYTES, fixed, most


def workspace(B: int, K: int, V: int, H: int, order: int,
              device: torch.device) -> torch.Tensor:
    """The workspace ``beam_step`` needs for B rows of this shape: uint8,
    empty where the candidates always fit in shared memory. Its owner
    allocates it once, off the hot path."""
    return torch.empty(B * layout(K, V, H, max(order - 1, 1), order)[2], dtype=torch.uint8,
                       device=device)


def first_beam_rank(first_beam: Optional[int], V: int) -> int:
    """The kernel's ``first_beam``: the rank whose log-prob thresholds the
    extensions where ``_expand`` restricts them, else 0 (every phone)."""
    if first_beam is not None and first_beam < 1:
        raise ValueError(f"beam_step: first beam {first_beam} < 1 (None: every phone)")
    return first_beam if first_beam is not None and first_beam < V - 2 else 0


def _check(state: Sequence[torch.Tensor], lp, lens, t, ticket, parents, words, node_pack,
           next_la2, table, uni, work, order: int, H: int) -> None:
    h1, ctx = state[0], state[4]
    B, K = h1.shape
    V = lp.shape[-1]
    CW = ctx.shape[-1]
    _, fixed, per_row = layout(K, V, H, CW, order)
    if fixed > SMEM_BYTES:
        raise ValueError(f"beam_step: K={K}, V={V}, H={H}, order {order} need {fixed} B of "
                         f"shared memory a row for the beams' own arrays, over the limit of "
                         f"{SMEM_BYTES} B (a CTA's 227 KB less its static variables)")
    if per_row and (work is None or work.dtype != torch.uint8 or work.numel() < B * per_row):
        raise ValueError(f"beam_step: K={K}, V={V}, H={H}, order {order} need a uint8 "
                         f"workspace of {B * per_row} B for the candidates that outgrow "
                         f"shared memory (ops.beam_step.workspace)")
    if K > MAX_BEAMS:
        raise ValueError(f"beam_step: K={K} beams over the limit of {MAX_BEAMS} (int16 parents)")
    tensors = list(state) + [lp, t, ticket, node_pack, next_la2, table[0], *uni]
    tensors += [x for x in (lens, parents, words) if x is not None]
    tensors += [work] if per_row else []
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"beam_step runs on CUDA tensors only (the search's plain "
                             f"version is _expand), got a tensor on {x.device}")
        if x.device != h1.device:
            raise ValueError(f"beam_step: tensors on {x.device} and {h1.device}")
        if not x.is_contiguous():
            raise ValueError("beam_step: every tensor must be contiguous")
    ints, floats = state[:5] + (node_pack, next_la2, table[0]), state[5:] + (lp, *uni)
    if any(x.dtype != torch.int32 for x in ints) or any(x.dtype != torch.float32 for x in floats):
        raise TypeError("beam_step: int32 state ids, trie and table; float32 scores, lp, unigrams")
    if any(x.shape != (B, K) for x in state[:4] + state[5:]) or ctx.shape != (B, K, CW) \
            or CW != max(order - 1, 1):
        raise ValueError(f"beam_step: state fields (B, K) = ({B}, {K}) and ctx (B, K, "
                         f"{max(order - 1, 1)}), got {[tuple(x.shape) for x in state]}")
    if lp.dim() != 3 or lp.shape[0] != B:
        raise ValueError(f"beam_step: lp (B, T, V) with B={B}, got {tuple(lp.shape)}")
    if node_pack.dim() != 2 or node_pack.shape[1] != 2 * H + 1 \
            or next_la2.shape[1:] != (V, 2) or next_la2.shape[0] != node_pack.shape[0]:
        raise ValueError(f"beam_step: node_pack (nodes, {2 * H + 1}) and next_la2 (nodes, {V}, "
                         f"2), got {tuple(node_pack.shape)}, {tuple(next_la2.shape)}")
    n_buckets, cap = table[0].shape[0], table[1]
    if cap % 16 or table[0].shape[1] != 4 * cap or n_buckets & (n_buckets - 1):
        raise ValueError(f"beam_step: a table of 2^n buckets of 16k slots, got "
                         f"{tuple(table[0].shape)} with {cap} slots a bucket")
    if lens is not None and (lens.dtype != torch.int64 or lens.shape != (B,)):
        raise ValueError("beam_step: lens (B,) int64")
    if t.dtype != torch.int64 or t.numel() != 1 or ticket.dtype != torch.int32 \
            or ticket.numel() != 1:
        raise ValueError("beam_step: t (1,) int64 and ticket (1,) int32")
    if (parents is None) != (words is None) or (parents is not None and (
            parents.dtype != torch.int16 or words.dtype != torch.int32
            or parents.shape[1:] != (B, K) or words.shape != parents.shape)):
        raise ValueError(f"beam_step: parents (T, {B}, {K}) int16 and words int32, or neither")


def beam_step(state: Sequence[torch.Tensor], lp: torch.Tensor, lens: Optional[torch.Tensor],
              t: torch.Tensor, ticket: torch.Tensor, parents: Optional[torch.Tensor],
              words: Optional[torch.Tensor], trie, lm, *, scale: float, length_penalty: float,
              first_beam: Optional[int], sum_mode: bool, close_top: Optional[int],
              ngram_key: bool, blank: int, sil: int, la0: float, beam: float = 0.0,
              t_offset: int = 0, advance: bool = True,
              work: Optional[torch.Tensor] = None) -> None:
    """One frame of the beam search over B rows, in place.

    ``state`` is an ``LmBeamState`` (h1, h2, node, last, ctx, s, ns, ac_s,
    ac_ns, lm; (B, K) and ctx (B, K, CW)), overwritten with the next frame's
    beams. The frame is row ``t[0] + t_offset`` of ``lp`` (B, T, V); a row
    whose ``lens`` (int64, None: all) is not past that frame takes the step,
    another keeps its beams. ``parents`` (T, B, K) int16 and ``words``
    int32 get that row of backpointers and emitted words (None: not
    recorded). With ``advance`` the kernel adds 1 to ``t`` when every row is
    done (``ticket``, an int32 zero, counts the rows). ``trie`` is the
    searcher's ``TrieArrays``, ``lm`` its ``DeviceNGram``; the options are
    ``_expand``'s (``beam`` > 0: the window below the row's best),
    ``ngram_key`` its ``state_key == "ngram"``. ``work`` is ``workspace``'s
    tensor for this shape (None where it is empty)."""
    V = lp.shape[-1]
    H = trie.node_pack.shape[1] // 2
    rank = first_beam_rank(first_beam, V)
    if close_top is not None and close_top < 0:
        raise ValueError(f"beam_step: close_top {close_top} < 0")
    uni = (lm.uni_logp, lm.uni_bow)
    _check(tuple(state), lp, lens, t, ticket, parents, words, trie.node_pack, trie.next_la2,
           lm.table, uni, work, lm.order, H)

    from ._build import beam_step_library

    lib = beam_step_library().lib
    B, K = state[0].shape
    table, cap = lm.table

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(lp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b2t_beam_step(
            *(x.data_ptr() for x in state), lp.data_ptr(), ptr(lens), t.data_ptr(),
            ticket.data_ptr(), ptr(parents), ptr(words), trie.node_pack.data_ptr(),
            trie.next_la2.data_ptr(), table.data_ptr(), uni[0].data_ptr(), uni[1].data_ptr(),
            ptr(work) if work is not None and work.numel() else None, B, K, V, lp.shape[1], state[4].shape[-1], H, rank, lm.order, table.shape[0],
            cap, blank, sil, H if close_top is None else close_top, int(ngram_key),
            int(sum_mode), t_offset, int(advance), scale, length_penalty, la0, lm.unk_logp,
            beam, stream)
    if err != 0:
        msg = lib.b2t_cuda_error_string(err).decode()
        raise RuntimeError(f"beam_step (B={B}, K={K}, V={V}, first beam {first_beam}, H={H}) "
                           f"kernel launch failed: cudaError {err}: {msg}")
    beam_step.launches += 1


beam_step.launches = 0
