"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor b2txt_tpu, so it also runs where only the port is
installed: ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
Every test skips where there is no CUDA card.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
from b2txt_tpu_torch.ops import gru as port_gru
from b2txt_tpu_torch.ops import preprocess as port_pre
from b2txt_tpu_torch.ops.augment import TransformArgs
from b2txt_tpu_torch.utils.config import TrainConfig


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _recurrent_inputs(B, H, weights, rng):
    """(W_hh, b_hh, h0) as float32 arrays. "contractive": random with
    spectral radius ~0.5, so a rounding difference between the two versions
    shrinks over the T steps instead of growing. "decoder_init": layer 0 of
    GRUDecoder at TrainConfig() defaults with its own (orthogonal) init."""
    if weights == "decoder_init":
        cfg = TrainConfig().model
        assert H == cfg.n_units
        model = GRUDecoder(cfg, 1, 41, device="cpu", generator=torch.Generator().manual_seed(0))
        h0 = np.broadcast_to(model.h0.detach().reshape(1, H).numpy(), (B, H))
        return [model.gru.weight_hh_l0.detach().numpy(), model.gru.bias_hh_l0.detach().numpy(), h0]
    return [rng.standard_normal((3 * H, H)) * (0.5 / np.sqrt(H)),
            rng.standard_normal((3 * H,)) * 0.1,
            rng.standard_normal((B, H))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,weights", [
    (1, 7, 16, "contractive"), (5, 33, 40, "contractive"), (40, 11, 72, "contractive"),
    (32, 125, 768, "contractive"), (16, 125, 768, "decoder_init"),
])
def test_gru_kernel_matches_plain(B, T, H, weights, dtype, tol):
    _need_card()
    rng = np.random.default_rng(B * 1000 + H)
    arrays = [rng.standard_normal((B, T, 3 * H)), *_recurrent_inputs(B, H, weights, rng)]
    args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dtype)
            for a in arrays]
    before = port_gru.gru_layer_forward.launches
    out, hf = port_gru.gru_layer_forward(*args)
    torch.cuda.synchronize()
    assert port_gru.gru_layer_forward.launches == before + 1
    ref_out, ref_hf = port_gru.gru_layer_reference(*args)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (hf.float() - ref_hf.float()).abs().max().item() <= tol


def _rel_err(a, b):
    return ((a.double() - b.double()).abs().max() / max(1.0, b.double().abs().max().item())).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,weights", [
    (1, 7, 16, "contractive"), (5, 33, 40, "contractive"), (40, 11, 72, "contractive"),
    (64, 125, 768, "contractive"), (64, 125, 768, "decoder_init"),
])
def test_gru_backward_kernel_matches_plain(B, T, H, weights, dtype, tol):
    """K2 against gru_layer_backward_reference on the same forward outputs
    and cotangents: max |x - x_plain| / max(1, max |x_plain|) for dxp,
    dW_hh, db_hh and dh0 (the tolerances of chip_smoke.py's GRU_BWD_TOL)."""
    _need_card()
    rng = np.random.default_rng(B * 1000 + H + 1)
    arrays = [rng.standard_normal((B, T, 3 * H)), *_recurrent_inputs(B, H, weights, rng)]
    args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dtype)
            for a in arrays]
    out, _ = port_gru.gru_layer_forward(*args)
    g_out = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32)).cuda()
    g_hf = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)).cuda()
    before = port_gru.gru_layer_backward.launches
    got = port_gru.gru_layer_backward(*args, out, g_out, g_hf)
    torch.cuda.synchronize()
    assert port_gru.gru_layer_backward.launches == before + 1
    want = port_gru.gru_layer_backward_reference(*args, out, g_out, g_hf)
    for name, a, b in zip(["dxp", "dw_hh", "db_hh", "dh0"], got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("label,kw,training,tol", [
    ("train", {}, True, 1e-5), ("eval", {}, False, 1e-5),
    ("walk", {"random_walk_std": 0.1}, True, 1e-4), ("gain", {"static_gain_std": 0.05}, True, 1e-4),
])
def test_fused_preprocess_kernel_matches_plain(label, kw, training, tol):
    """K3 with the normals passed in against its plain version on the same
    normals, gain and cut (drawn from two generators with one seed)."""
    _need_card()
    B, T, C = 8, 130, 96
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, T, C), generator=gen, device="cuda")
    nt = torch.full((B,), T, device="cuda")
    noise = torch.randn((B, 2 * T + 1, C), generator=gen, device="cuda")
    args = TransformArgs(**kw)
    g1, g2 = (torch.Generator(device="cuda").manual_seed(9) for _ in range(2))
    before = port_pre.fused_preprocess.launches
    got, nt_got = port_pre.fused_preprocess(x, nt, args, training, generator=g1, noise=noise)
    torch.cuda.synchronize()
    assert port_pre.fused_preprocess.launches == before + 1
    gain = cut = None
    if training and args.static_gain_std > 0:
        gain = torch.randn((B, C, C), generator=g2, device="cuda")
    if training and args.random_cut > 0:
        cut = torch.randint(0, args.random_cut, (), generator=g2, device="cuda")
    want, nt_want = port_pre.fused_preprocess_reference(x, nt, args, training, noise, cut, gain)
    assert torch.equal(nt_got, nt_want)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
def test_fused_preprocess_on_chip_noise_statistics():
    """Philox normals inside K3: white noise standard and independent
    across rows, the offset constant along time with the given std."""
    _need_card()
    B, T, C = 16, 256, 128
    zeros = torch.zeros((B, T, C), device="cuda")
    nt = torch.full((B,), T, device="cuda")
    w, _ = port_pre.fused_preprocess(
        zeros, nt, TransformArgs(constant_offset_std=0.0, random_cut=0, smooth_data=False),
        True, seed=1)
    assert abs(w.mean().item()) < 0.01 and abs(w.std().item() - 1.0) < 0.01
    assert abs(torch.corrcoef(torch.stack([w[0].flatten(), w[1].flatten()]))[0, 1].item()) < 0.05
    o, _ = port_pre.fused_preprocess(
        zeros, nt, TransformArgs(white_noise_std=0.0, constant_offset_std=0.5, random_cut=0,
                                 smooth_data=False), True, seed=2)
    assert o.std(dim=1).max().item() < 1e-6
    assert abs(o[:, 0, :].std().item() - 0.5) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_decoder_gradients_on_card_match_plain_path(dtype, tol):
    """Gradients through GRUDecoder on the card (K1 forward, K2 backward)
    equal the plain path's (both recurrences patched to their plain
    versions): ||g - g_plain|| / ||g_plain|| per parameter, the tolerances
    of chip_smoke.py's TRAIN_GRAD_TOL. Every parameter gets a gradient,
    the day layers and W_hh among them."""
    _need_card()
    cfg = TrainConfig().model
    cfg.n_input_features, cfg.n_units, cfg.n_layers = 64, 128, 3
    model = GRUDecoder(cfg, 2, 41, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((6, 90, 64), generator=gen, device="cuda")
    day = torch.tensor([0, 1, 0, 1, 1, 0], device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        logits = model(x, day, compute_dtype=dtype)
        (logits.float() ** 2).mean().backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    before = port_gru.gru_layer_backward.launches
    kernel = grads()
    assert port_gru.gru_layer_backward.launches == before + cfg.n_layers
    with mock.patch.object(port_gru, "gru_layer_forward", port_gru.gru_layer_reference), \
            mock.patch.object(port_gru, "gru_layer_backward",
                              port_gru.gru_layer_backward_reference):
        plain = grads()
    for n, g in plain.items():
        assert g.abs().max().item() > 0, n
        err = ((kernel[n].double() - g.double()).norm() / g.double().norm()).item()
        assert err <= tol, (n, err)
