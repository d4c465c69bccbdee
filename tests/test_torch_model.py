"""The port's GRUDecoder, smoothing and checkpoint mapping against the JAX
package, on the same numpy inputs (f32, CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from b2txt_tpu.models import gru_decoder as jax_model
from b2txt_tpu.models import planted as jax_planted
from b2txt_tpu.models.torch_import import state_dict_from_params as jax_state_dict
from b2txt_tpu.ops.smoothing import gauss_smooth as jax_smooth
from b2txt_tpu.ops.smoothing import gaussian_kernel as jax_gaussian_kernel
from b2txt_tpu.utils.config import ModelConfig as JaxModelConfig
from b2txt_tpu_torch.models import GRUDecoder, extract_patches, params_from_jax, params_to_jax
from b2txt_tpu_torch.models import planted as port_planted
from b2txt_tpu_torch.ops.smoothing import gauss_smooth, gaussian_kernel
from b2txt_tpu_torch.utils.config import ModelConfig

D, H, N_DAYS, N_CLASSES, N_LAYERS = 24, 16, 3, 41, 2


def _cfg(patch_size, patch_stride):
    cfg = ModelConfig()
    cfg.n_input_features, cfg.n_units, cfg.n_layers = D, H, N_LAYERS
    cfg.patch_size, cfg.patch_stride = patch_size, patch_stride
    return cfg


def _jax_params(patch_size, seed=0):
    params = jax_model.init_params(
        jax.random.PRNGKey(seed), neural_dim=D, n_units=H, n_days=N_DAYS,
        n_classes=N_CLASSES, n_layers=N_LAYERS, patch_size=patch_size,
    )
    # non-identity day layers so the day gather is exercised
    rng = np.random.default_rng(seed)
    params["day_w"] = params["day_w"] + 0.1 * rng.standard_normal(params["day_w"].shape)
    params["day_b"] = 0.1 * rng.standard_normal(params["day_b"].shape)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _port_model(params, patch_size, patch_stride):
    model = GRUDecoder(_cfg(patch_size, patch_stride), N_DAYS, N_CLASSES, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("patch_size,patch_stride", [(14, 4), (0, 0)])
def test_forward_matches_jax(rng, patch_size, patch_stride):
    params = _jax_params(patch_size)
    x = rng.standard_normal((3, 50, D)).astype(np.float32)
    day_idx = np.array([0, 2, 1])
    ref, ref_h = jax_model.forward(
        params, jnp.asarray(x), jnp.asarray(day_idx), return_state=True,
        patch_size=patch_size, patch_stride=patch_stride, use_pallas=False,
    )
    model = _port_model(params, patch_size, patch_stride)
    with torch.no_grad():
        ours, ours_h = model(torch.from_numpy(x), torch.from_numpy(day_idx), return_state=True)
    assert ours.shape == ref.shape and ours_h.shape == ref_h.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours_h.numpy(), np.asarray(ref_h), rtol=1e-4, atol=1e-5)


def test_streaming_with_carried_state_matches_jax(rng):
    """Patches fed in two chunks with carried state == the JAX package's
    chunked forward, and == the port's own full forward."""
    params = _jax_params(14)
    x = rng.standard_normal((1, 62, D)).astype(np.float32)
    day_idx = np.array([1])
    model = _port_model(params, 14, 4)
    xt, dt = torch.from_numpy(x), torch.from_numpy(day_idx)
    with torch.no_grad():
        full = model(xt, dt)
        patched = extract_patches(model.day_layer(xt, dt), 14, 4)
        P = patched.shape[1]
        l1, h1 = model(patched[:, : P // 2], dt, return_state=True, skip_day_layer=True)
        l2, _ = model(patched[:, P // 2 :], dt, states=h1, return_state=True,
                      skip_day_layer=True)
    chunked = torch.cat([l1, l2], dim=1).numpy()
    np.testing.assert_allclose(chunked, full.numpy(), rtol=1e-4, atol=1e-5)

    pre = (jnp.einsum("btd,bdk->btk", jnp.asarray(x), params["day_w"][day_idx])
           + params["day_b"][day_idx][:, None, :])
    jpatched = jax_model.extract_patches(pre / (1.0 + jnp.abs(pre)), 14, 4)
    np.testing.assert_allclose(patched.numpy(), np.asarray(jpatched), rtol=1e-5, atol=1e-6)
    kw = dict(return_state=True, patch_size=0, patch_stride=0, skip_day_layer=True,
              use_pallas=False)
    j1, jh1 = jax_model.forward(params, jpatched[:, : P // 2], jnp.asarray(day_idx), **kw)
    j2, _ = jax_model.forward(params, jpatched[:, P // 2 :], jnp.asarray(day_idx),
                              states=jh1, **kw)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        chunked, np.concatenate([np.asarray(j1), np.asarray(j2)], axis=1),
        rtol=1e-4, atol=1e-5)


def test_extract_patches_matches_jax(rng):
    x = rng.standard_normal((2, 37, D)).astype(np.float32)
    ours = extract_patches(torch.from_numpy(x), 14, 4).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_model.extract_patches(jnp.asarray(x), 14, 4)))


def test_params_round_trip_bit_exact():
    params = _jax_params(14, seed=3)
    sd = params_from_jax(params)
    back = params_to_jax(sd)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # and through the port's module: load, read back, convert again
    model = _port_model(params, 14, 4)
    again = params_to_jax(model.state_dict())
    for a, b in zip(flat, jax.tree_util.tree_leaves(again)):
        assert np.array_equal(a, b)


def test_planted_params_match_jax():
    cfg = _cfg(14, 4)
    cfg.n_units = 48  # the planted readout needs n_units >= 41
    jcfg = JaxModelConfig(n_input_features=D, n_units=48, n_layers=N_LAYERS)
    code = np.random.default_rng(5).standard_normal((N_CLASSES, D)).astype(np.float32)
    ours = port_planted.planted_params(cfg, N_DAYS, code)
    ref = jax_state_dict(jax_planted.planted_params(jcfg, N_DAYS, code))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert np.array_equal(ours[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_smoothing_matches_jax(rng, padding):
    """Taps and output are bit-identical to the JAX package's on the CPU."""
    x = rng.standard_normal((3, 57, 16)).astype(np.float32)
    assert gaussian_kernel() == jax_gaussian_kernel()
    ours = gauss_smooth(torch.from_numpy(x), padding=padding).numpy()
    ref = np.asarray(jax_smooth(jnp.asarray(x), padding=padding))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_adjusted_lengths_match_jax(rng):
    """``GRUDecoder.adjusted_lengths`` on random lengths, for a tensor and
    for an int (the evaluation harness passes ints)."""
    for patch_size, patch_stride in ((14, 4), (5, 2)):
        cfg = _cfg(patch_size, patch_stride)
        ours = GRUDecoder(cfg, N_DAYS, N_CLASSES, device="cpu")
        jcfg = JaxModelConfig()
        jcfg.n_input_features, jcfg.n_units, jcfg.n_layers = D, H, N_LAYERS
        jcfg.patch_size, jcfg.patch_stride = patch_size, patch_stride
        ref = jax_model.GRUDecoder(jcfg, n_days=N_DAYS, n_classes=N_CLASSES)
        lengths = rng.integers(patch_size, 600, 50)
        got = ours.adjusted_lengths(torch.from_numpy(lengths))
        want = np.asarray(ref.adjusted_lengths(jnp.asarray(lengths, jnp.int32)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert [ours.adjusted_lengths(int(n)) for n in lengths] == want.tolist()


def test_kernel_array_matches_jax():
    from b2txt_tpu.ops import kernel_array as jax_kernel_array
    from b2txt_tpu_torch.ops import kernel_array

    for std, size in ((2.0, 100), (1.5, 20), (3.0, 64)):
        got, want = kernel_array(std, size), jax_kernel_array(std, size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("patch_size,patch_stride", [(14, 4), (0, 0)])
def test_param_count_matches_jax(patch_size, patch_stride):
    from b2txt_tpu.models import param_count as jax_param_count
    from b2txt_tpu_torch.models import param_count

    params = _jax_params(patch_size)
    model = _port_model(params, patch_size, patch_stride)
    assert param_count(model) == jax_param_count(params)
    assert param_count(model.state_dict()) == jax_param_count(params)
