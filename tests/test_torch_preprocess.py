"""The port's augmentations (``ops/augment.py``) and K3's plain version
(``ops/preprocess.py``) against the JAX package, with the JAX package's own
random draws handed to the port. The Triton kernel is held against the plain
version in test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from b2txt_tpu.ops.augment import TransformArgs as JaxArgs
from b2txt_tpu.ops.augment import shift_left_and_zero as jax_shift
from b2txt_tpu.ops.augment import transform_data as jax_transform
from b2txt_tpu.ops.pallas.preprocess import fused_preprocess as jax_fused
from b2txt_tpu_torch.ops import preprocess as port_pre
from b2txt_tpu_torch.ops.augment import (TransformArgs, TransformDraws, draw_transform,
                                         shift_left_and_zero, transform_data)
from b2txt_tpu_torch.utils.config import DataTransforms

B, T, C = 3, 40, 16
# Knobs beyond the defaults: the random walk's cumsum and the gain's product
# sum in another order than XLA's, one float32 ulp (~2.4e-7 here) apart.
KNOBS = {"defaults": ({}, 0.0), "walk": ({"random_walk_std": 0.3}, 1e-6),
         "gain": ({"static_gain_std": 0.1}, 1e-6)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    return x, np.full((B,), T, np.int32)


def test_transform_args_from_config():
    c = DataTransforms(random_walk_std=0.5, random_cut=2)
    assert TransformArgs.from_config(c)._asdict() == JaxArgs.from_config(c)._asdict()


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_transform_data_matches_jax_with_its_draws(rng, knob):
    """Same JAX draws (key split into gain, white, offset, walk, cut, as
    augment.py:77) → the same features and lengths; bit for bit at the
    default knobs."""
    kw, tol = KNOBS[knob]
    x, nt = _inputs(rng)
    key = jax.random.PRNGKey(3)
    ref, nt_ref = jax_transform(key, jnp.asarray(x), jnp.asarray(nt), JaxArgs(**kw), True)
    k_gain, k_white, k_offset, k_walk, k_cut = jax.random.split(key, 5)
    draws = TransformDraws(
        gain=_t(jax.random.normal(k_gain, (B, C, C))),
        white=_t(jax.random.normal(k_white, (B, T, C))),
        offset=_t(jax.random.normal(k_offset, (B, 1, C))),
        walk=_t(jax.random.normal(k_walk, (B, T, C))),
        cut=_t(jax.random.randint(k_cut, (), 0, 3)).long(),
    )
    out, nt_out = transform_data(_t(x), _t(nt).long(), TransformArgs(**kw), True, draws=draws)
    np.testing.assert_array_equal(nt_out.numpy(), np.asarray(nt_ref))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=tol)


def test_transform_data_eval_is_bit_equal(rng):
    x, nt = _inputs(rng)
    ref, _ = jax_transform(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(nt), JaxArgs(), False)
    out, nt_out = transform_data(_t(x), _t(nt).long(), TransformArgs(), False)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(nt_out.numpy(), nt)


@pytest.mark.parametrize("cut", [0, 1, 4])
def test_shift_left_and_zero_matches_jax(rng, cut):
    x, _ = _inputs(rng)
    ref = jax_shift(jnp.asarray(x), cut)
    np.testing.assert_array_equal(shift_left_and_zero(_t(x), torch.tensor(cut)).numpy(),
                                  np.asarray(ref))


def test_draws_follow_the_knobs():
    x = torch.zeros(2, 5, 3)
    g = torch.Generator().manual_seed(0)
    d = draw_transform(x, TransformArgs(constant_offset_std=0.0, random_walk_std=0.1), g)
    assert d.white.shape == (2, 5, 3) and d.walk.shape == (2, 5, 3)
    assert d.offset is None and d.gain is None and 0 <= int(d.cut) < 3


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_fused_reference_matches_jax_interpret(rng, knob, training):
    """K3's plain version with the JAX draws (key split into gain, cut,
    seed, noise, as preprocess.py:129; host noise laid out as at :156-164)
    against the Pallas kernel in interpret mode: bit-equal in eval mode;
    in training the jitted interpreter fuses the noise adds, so they agree
    to one float32 ulp."""
    kw, tol = KNOBS[knob]
    x, nt = _inputs(rng)
    key = jax.random.PRNGKey(5)
    ref, nt_ref = jax_fused(key, jnp.asarray(x), jnp.asarray(nt), JaxArgs(**kw),
                            training=training, interpret=True)
    k_gain, k_cut, _, k_noise = jax.random.split(key, 4)
    out, nt_out = port_pre.fused_preprocess_reference(
        _t(x), _t(nt).long(), TransformArgs(**kw), training,
        noise=_t(jax.random.normal(k_noise, (B, 2 * T + 1, C), jnp.float32)),
        cut=int(jax.random.randint(k_cut, (), 0, 3, jnp.int32)),
        gain=_t(jax.random.normal(k_gain, (B, C, C))),
    )
    np.testing.assert_array_equal(nt_out.numpy(), np.asarray(nt_ref))
    if training:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=max(tol, 1e-6))
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_noise_layout_follows_enabled_draws():
    """Host normals are consumed in order of the enabled draws only
    (preprocess.py:75-81): with white noise off, the offset is row 0."""
    assert port_pre.noise_rows(TransformArgs(), 10) == (0, 10, 11)
    assert port_pre.noise_rows(TransformArgs(white_noise_std=0.0), 10)[1] == 0


def test_cpu_tensors_take_plain_version_without_launch(rng, monkeypatch):
    monkeypatch.setattr(port_pre.fused_preprocess, "launches", 0)
    x, nt = _inputs(rng)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    args = TransformArgs()
    out, nt_out = port_pre.fused_preprocess(_t(x), _t(nt).long(), args, True, generator=g1)
    cut = torch.randint(0, 3, (), generator=g2)
    noise = torch.randn((B, 2 * T + 1, C), generator=g2)
    want, nt_want = port_pre.fused_preprocess_reference(_t(x), _t(nt).long(), args, True,
                                                        noise, cut)
    assert torch.equal(out, want) and torch.equal(nt_out, nt_want)
    assert port_pre.fused_preprocess.launches == 0


def test_fused_rejects_a_walk_along_time():
    with pytest.raises(ValueError, match="along channels"):
        port_pre.fused_preprocess(torch.zeros(1, 4, 2), torch.tensor([4]),
                                  TransformArgs(random_walk_std=0.1, random_walk_axis=1))
