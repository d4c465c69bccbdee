"""K4's wrapper on the CPU: the plain version equals the JAX script's
reference arm (``table[idx]``, scripts/profile_pallas_gather.py:114), the
wrapper takes it for CPU tensors, and it rejects what the kernel does not
take. The kernel itself is held bit for bit on the card
(tests/test_torch_kernels_gpu.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from b2txt_tpu_torch.ops import gather


@pytest.mark.parametrize("rw,g", [(4, 1), (64, 37), (128, 4096)])
def test_reference_equals_jax_table_idx(rw, g):
    rng = np.random.default_rng(rw + g)
    table = rng.integers(0, 1 << 20, (1 << 10, rw)).astype(np.int32)
    idx = rng.integers(0, 1 << 10, g).astype(np.int32)
    idx[: g // 2] = idx[0]
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = gather.row_gather_reference(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    before = gather.row_gather.launches
    via_wrapper = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(via_wrapper.numpy(), want)
    assert gather.row_gather.launches == before   # the CPU takes the plain version


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table = torch.zeros((16, 8), dtype=torch.int32)
    idx = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather.row_gather(table.float(), idx)
    with pytest.raises(TypeError):
        gather.row_gather(table, idx.long())
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.row_gather(torch.zeros((16, 6), dtype=torch.int32), idx)
    with pytest.raises(ValueError):
        gather.row_gather(table[0], idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather.row_gather(torch.zeros((8, 16), dtype=torch.int32).t(), idx)
    with pytest.raises(ValueError, match="in_flight"):
        gather.row_gather(table, idx, in_flight=3)


def test_wrapper_rejects_misaligned_tensors_and_oversized_rings():
    """The kernel's bulk copies need 16-byte aligned tensors, and W rows of
    the table must fit a CTA's shared memory."""
    flat = torch.zeros(16 * 8 + 4, dtype=torch.int32)
    shifted = flat[1 : 1 + 16 * 8].view(16, 8)      # offset by one int32: 4 bytes
    idx = torch.zeros((3,), dtype=torch.int32)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        gather.row_gather(shifted, idx)
    with pytest.raises(ValueError, match="aligned"):
        gather.row_gather(flat[:16].view(2, 8), torch.zeros(5, dtype=torch.int32)[1:])
    wide = torch.zeros((4, 512), dtype=torch.int32)    # 2 KB rows
    with pytest.raises(ValueError, match="shared memory"):
        gather.row_gather(wide, idx, in_flight=128)
    assert torch.equal(gather.row_gather(wide, idx, in_flight=32), wide[:3])
