"""Row gather ``out[i] = table[idx[i]]``: the CUDA kernel K4 and its plain
version.

K4, ``csrc/row_gather.cu``, replaces the Pallas kernel ``make_dma_gather``
(``scripts/profile_pallas_gather.py:47``): a ring of W single-row async
copies in flight. On Hopper the ring lives in shared memory: each CTA loads
its own indices, then keeps up to W rows in flight, each row one bulk copy of
the tensor memory accelerator into its slot and one bulk store out of it; the
grid spreads the rows over every SM whatever W is. It is bound by bytes. Its
path is the gather profile, ``b2txt_tpu_torch.scripts.profile_gather``, on
the access pattern of the device beam search's n-gram and trie rows.

``row_gather`` launches the kernel for CUDA tensors and takes the plain
version, ``row_gather_reference``, only for CPU tensors.
"""

from __future__ import annotations

import torch

IN_FLIGHT = (1, 8, 32, 128)
SMEM_BYTES = 232448   # a CTA's shared memory on Hopper (227 KB): the ring's room


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table.index_select(0, idx)``."""
    return table.index_select(0, idx)


def _check(table: torch.Tensor, idx: torch.Tensor, in_flight: int) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"row_gather takes table (rows, rw) and idx (g,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"row_gather takes int32 table and idx, got {table.dtype}, {idx.dtype}")
    if table.shape[1] < 4 or table.shape[1] % 4:
        raise ValueError(f"rows must be a positive multiple of 4 int32 (16 B), got rw={table.shape[1]}")
    if table.device != idx.device:
        raise ValueError(f"idx is on {idx.device}, table is on {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if in_flight not in IN_FLIGHT:
        raise ValueError(f"in_flight must be one of {IN_FLIGHT}, got {in_flight}")
    if idx.shape[0] >= 1 << 31:
        raise ValueError("at most 2^31 - 1 rows per call")
    row_bytes = table.shape[1] * 4
    if in_flight * (row_bytes + 12) > SMEM_BYTES:   # a slot, its mbarrier and its index
        raise ValueError(f"in_flight={in_flight} rows of {row_bytes} B exceed a CTA's "
                         f"{SMEM_BYTES} B of shared memory")
    if table.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("table and idx must be 16-byte aligned (the kernel's bulk copies)")


def row_gather(table: torch.Tensor, idx: torch.Tensor, in_flight: int = 8) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` for an int32 table (rows, rw), rw a
    multiple of 4, and int32 indices (g,). Every index must lie in
    [0, rows): the kernel does not check them.

    On CUDA tensors this launches K4, each CTA keeping at most ``in_flight``
    rows in flight (one of ``IN_FLIGHT``; ``in_flight`` rows must fit a CTA's
    shared memory); ``row_gather.launches`` counts launches. CPU tensors go
    to ``row_gather_reference``."""
    _check(table, idx, in_flight)
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather runs on CUDA or CPU tensors, got {table.device}")

    from ._build import row_gather_library

    lib = row_gather_library().lib
    g, rw = idx.shape[0], table.shape[1]
    out = torch.empty((g, rw), dtype=torch.int32, device=table.device)
    if out.data_ptr() % 16:
        raise ValueError("the output must be 16-byte aligned (the kernel's bulk copies)")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b2t_row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                 g, rw, in_flight, stream)
    if err != 0:
        msg = lib.b2t_cuda_error_string(err).decode()
        raise RuntimeError(f"row_gather (g={g}, rw={rw}, in_flight={in_flight}) kernel "
                           f"launch failed: cudaError {err}: {msg}")
    row_gather.launches += 1
    return out


row_gather.launches = 0
