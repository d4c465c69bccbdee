"""K1 (the GRU recurrence) in the PyTorch port: its plain version against the
JAX package's Pallas kernel run in interpret mode. The CUDA kernel is held
against the plain version in test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from b2txt_tpu.ops.pallas.gru import gru_layer_pallas
from b2txt_tpu_torch.ops import gru as port_gru


def _inputs(rng, B, T, H):
    x_proj = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((3 * H, H)) * 0.3).astype(np.float32)
    b_hh = (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    return x_proj, w_hh, b_hh, h0


@pytest.mark.parametrize("B,T,H", [(4, 12, 16), (8, 33, 32), (1, 9, 24)])
def test_reference_matches_pallas_interpret(rng, B, T, H):
    args = _inputs(rng, B, T, H)
    out, hf = gru_layer_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    ref_out, ref_hf = port_gru.gru_layer_reference(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ref_out.numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref_hf.numpy(), np.asarray(hf), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_plain_version_without_launch(rng, monkeypatch):
    monkeypatch.setattr(port_gru.gru_layer_forward, "launches", 0)
    monkeypatch.setattr(port_gru.gru_layer_backward, "launches", 0)
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs(rng, 2, 5, 8)]
    out, hf = port_gru.gru_layer(*args)
    ref_out, ref_hf = port_gru.gru_layer_reference(*args)
    assert torch.equal(out, ref_out) and torch.equal(hf, ref_hf)
    (out.sum() + hf.sum()).backward()
    assert port_gru.gru_layer_forward.launches == 0
    assert port_gru.gru_layer_backward.launches == 0


def test_reference_bf16_rounds_each_step(rng):
    """bf16 in, bf16 out: h_t is rounded to the compute dtype every step."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(rng, 3, 6, 8)]
    out, hf = port_gru.gru_layer_reference(*args)
    assert out.dtype == torch.bfloat16 and hf.dtype == torch.bfloat16
    assert torch.equal(out[:, -1], hf)
