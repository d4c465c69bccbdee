"""K2 (the GRU backward recurrence) in the PyTorch port: its plain version
against the JAX package's Pallas backward kernel in interpret mode and
against jax.grad, and gradients through the port's GRUDecoder against the JAX
model's. The CUDA kernel is held against the plain version in
test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from b2txt_tpu.models.gru_decoder import forward as jax_forward
from b2txt_tpu.models.gru_decoder import init_params
from b2txt_tpu.ops.pallas.gru import _gru_bwd_call, gru_layer_pallas
from b2txt_tpu_torch.models import GRUDecoder, params_from_jax, params_to_jax
from b2txt_tpu_torch.ops import gru as port_gru
from b2txt_tpu_torch.utils.config import ModelConfig

# bf16: dxp and dpre are rounded to bf16 every step in both packages, so a
# summation-order difference can flip a last bit (2^-8 relative) and move
# the values that depend on it; 1/64 of the largest magnitude allows a few
# such flips and no wrong gate.
BF16_TOL = 1.0 / 64


def _inputs(rng, B, T, H):
    x_proj = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((3 * H, H)) * 0.3).astype(np.float32)
    b_hh = (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    g_out = rng.standard_normal((B, T, H)).astype(np.float32)
    g_hf = rng.standard_normal((B, H)).astype(np.float32)
    return (x_proj, w_hh, b_hh, h0), g_out, g_hf


def fwd_args_t(fwd_args):
    return [torch.from_numpy(a) for a in fwd_args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H", [(4, 12, 16), (8, 33, 32)])
def test_backward_reference_matches_pallas_interpret(rng, B, T, H, dtype):
    fwd_args, g_out, g_hf = _inputs(rng, B, T, H)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in fwd_args]
    out, _ = gru_layer_pallas(*jargs, interpret=True)
    ref = _gru_bwd_call(*jargs, out, jnp.asarray(g_out), jnp.asarray(g_hf), True)

    # both backwards start from the same forward outputs (the JAX kernel's)
    targs = [torch.from_numpy(a).to(tdt) for a in fwd_args]
    out_t = torch.from_numpy(np.array(out.astype(jnp.float32))).to(tdt)
    ours = port_gru.gru_layer_backward_reference(
        *targs, out_t, torch.from_numpy(g_out), torch.from_numpy(g_hf))
    for name, a, r in zip(["dxp", "dw_hh", "db_hh", "dh0"], ours, ref):
        assert a.dtype == tdt, name
        a, r = a.float().numpy(), np.asarray(r.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, r, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            assert np.abs(a - r).max() <= BF16_TOL * np.abs(r).max(), name


@pytest.mark.parametrize("B,T,H", [(4, 12, 16), (8, 33, 32)])
def test_autograd_matches_jax_grad(rng, B, T, H):
    """gru_layer's gradients (GRULayerFn: plain forward, plain K2) ==
    jax.grad of gru_layer_pallas through its custom VJP, through both the
    outputs and h_T."""
    fwd_args, _, _ = _inputs(rng, B, T, H)

    def loss_jax(*a):
        out, hf = gru_layer_pallas(*a, interpret=True)
        return jnp.sum(out * jnp.cos(out)) + 2.0 * jnp.sum(hf)

    g_ref = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in fwd_args))
    targs = [torch.from_numpy(a).requires_grad_() for a in fwd_args]
    out, hf = port_gru.gru_layer(*targs)
    (torch.sum(out * torch.cos(out)) + 2.0 * torch.sum(hf)).backward()
    for name, t, r in zip(["x_proj", "w_hh", "b_hh", "h0"], targs, g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_unused_final_state_gets_zero_cotangent(rng):
    """A loss of the outputs only: autograd passes None for h_T's cotangent,
    which becomes zeros."""
    fwd_args, g_out, _ = _inputs(rng, 3, 5, 8)
    targs = [torch.from_numpy(a).requires_grad_() for a in fwd_args]
    out, _ = port_gru.gru_layer(*targs)
    (out * torch.from_numpy(g_out)).sum().backward()
    plain_out, _ = port_gru.gru_layer_reference(*fwd_args_t(fwd_args))
    want = port_gru.gru_layer_backward_reference(
        *fwd_args_t(fwd_args), plain_out, torch.from_numpy(g_out), torch.zeros(3, 8))
    for t, w in zip(targs, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


def test_inference_mode_runs_the_forward_once(rng, monkeypatch):
    """Under torch.inference_mode the Function still runs its forward (the
    kernel on the card) exactly once per call, and records no graph."""
    calls = []
    plain = port_gru.gru_layer_forward

    def counted(*a):
        calls.append(1)
        return plain(*a)

    monkeypatch.setattr(port_gru, "gru_layer_forward", counted)
    targs = fwd_args_t(_inputs(rng, 2, 4, 8)[0])
    with torch.inference_mode():
        out, hf = port_gru.gru_layer(*targs)
    assert len(calls) == 1 and out.grad_fn is None
    assert torch.equal(out, port_gru.gru_layer_reference(*targs)[0])


def _model_params(seed=3):
    params = init_params(jax.random.PRNGKey(seed), neural_dim=12, n_units=16, n_days=2,
                         n_classes=41, n_layers=2, patch_size=6, patch_stride=2)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def test_decoder_gradients_match_jax(rng):
    """Full-model gradients through the port's GRUDecoder (the recurrence
    through GRULayerFn) == jax.grad through the JAX forward, for every
    parameter (as tests/test_pallas_gru.py:88-114 holds the Pallas path)."""
    params = _model_params()
    x = rng.standard_normal((3, 30, 12)).astype(np.float32)
    day = np.array([0, 1, 0])

    def loss(p):
        logits = jax_forward(p, jnp.asarray(x), jnp.asarray(day), patch_size=6,
                             patch_stride=2, use_pallas=False)
        return jnp.mean(logits ** 2)

    g_ref = jax.grad(loss)(params)
    cfg = ModelConfig(n_input_features=12, n_units=16, n_layers=2, patch_size=6, patch_stride=2)
    model = GRUDecoder(cfg, 2, 41, device="cpu")
    model.load_state_dict(params_from_jax(params))
    logits = model(torch.from_numpy(x), torch.from_numpy(day))
    torch.mean(logits ** 2).backward()
    ours = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_leaves = jax.tree_util.tree_leaves(g_ref)
    our_leaves = jax.tree_util.tree_leaves(ours)
    assert len(ref_leaves) == len(our_leaves)
    for a, b in zip(our_leaves, ref_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4)
