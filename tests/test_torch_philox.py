"""The plain version of K3's noise generator (``ops/preprocess.py``):
Philox4x32-10 against Random123's known answers, the element-to-normal
layout the kernel uses, and the normals' statistics. The kernel itself is
held to ``philox_noise`` elementwise on the card (test_torch_kernels_gpu.py)."""

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.ops import preprocess as port_pre
from b2txt_tpu_torch.ops.augment import TransformArgs


def _words(*hexes):
    return torch.tensor([int(h, 16) for h in hexes], dtype=torch.int64)


# Random123's known-answer vectors for philox4x32_10 (kat_vectors)
@pytest.mark.parametrize("counter,key,want", [
    (("0", "0", "0", "0"), ("0", "0"), ("6627e8d5", "e169c58d", "bc57ac4c", "9b00dbd8")),
    (("ffffffff",) * 4, ("ffffffff",) * 2, ("408f276d", "41c83b0e", "a20bc7c6", "6d5451fd")),
    (("243f6a88", "85a308d3", "13198a2e", "03707344"), ("a4093822", "299f31d0"),
     ("d16cfe09", "94fdcceb", "5001e420", "24126ea1")),
])
def test_philox_matches_random123_known_answers(counter, key, want):
    got = port_pre.philox4x32_10(_words(*counter), _words(*key))
    assert got.tolist() == _words(*want).tolist()


def test_philox_is_elementwise_over_batches():
    """A batch of counters gives each counter's own words."""
    counters = torch.tensor([[0, 0, 0, 0], [5, 0, 2, 0], [2**32 - 1, 7, 1, 0]], dtype=torch.int64)
    key = torch.tensor([[9, 0]] * 3, dtype=torch.int64)
    batch = port_pre.philox4x32_10(counters, key)
    for i in range(3):
        assert torch.equal(batch[i], port_pre.philox4x32_10(counters[i], key[i]))


def _normal_of_element(seed, stream, e):
    """Element e's normal by the kernel's recipe, in numpy float32."""
    j = e >> 2
    w = port_pre.philox4x32_10(torch.tensor([j & 0xFFFFFFFF, j >> 32, stream, 0]),
                               torch.tensor([seed, 0])).numpy()
    u = ((w >> 9) * 2 + 1).astype(np.float32) * np.float32(2.0**-24)
    a, b = (0, 1) if (e & 3) < 2 else (2, 3)
    r = np.sqrt(np.float32(-2.0) * np.log(u[a]))
    theta = np.float32(port_pre.TWO_PI_F32) * u[b]
    n = r * (np.cos(theta) if (e & 3) % 2 == 0 else np.sin(theta))
    return np.float32(n)


def test_philox_noise_layout_follows_the_kernel():
    """White (b·T + t)·C + c of stream 0, offset b·C + c of stream 1, walk
    (b·T + t)·C + c of stream 2, in the rows of ``noise_rows``; disabled
    draws leave their rows out, unused rows are 0."""
    B, T, C, seed = 2, 5, 7, 123
    args = TransformArgs(random_walk_std=0.2)
    noise = port_pre.philox_noise(seed, B, T, C, args)
    rw, ro, rk = port_pre.noise_rows(args, T)
    assert noise.shape == (B, 2 * T + 1, C) and (rw, ro, rk) == (0, T, T + 1)
    for b, t, c in [(0, 0, 0), (0, 0, 3), (1, 4, 6), (1, 2, 5), (0, 3, 1)]:
        e = (b * T + t) * C + c
        np.testing.assert_allclose(noise[b, rw + t, c], _normal_of_element(seed, 0, e), rtol=1e-6)
        np.testing.assert_allclose(noise[b, rk + t, c], _normal_of_element(seed, 2, e), rtol=1e-6)
    for b, c in [(0, 0), (1, 6), (1, 2)]:
        np.testing.assert_allclose(noise[b, ro, c], _normal_of_element(seed, 1, b * C + c),
                                   rtol=1e-6)
    no_walk = port_pre.philox_noise(seed, B, T, C, TransformArgs(white_noise_std=0.0))
    assert no_walk[:, 0].abs().sum() > 0 and no_walk[:, 1:].abs().sum() == 0
    assert torch.equal(no_walk[:, 0], noise[:, ro])


def test_philox_noise_is_standard_and_uncorrelated():
    B, T, C = 4, 200, 64
    noise = port_pre.philox_noise(7, B, T, C, TransformArgs(random_walk_std=1.0))
    white, walk = noise[:, :T], noise[:, T + 1 :]
    for n in (white, walk):
        assert abs(n.mean().item()) < 0.02 and abs(n.std().item() - 1.0) < 0.02
        assert torch.isfinite(n).all() and n.abs().max().item() < 6.0
    pairs = [(white[0].flatten(), white[1].flatten()), (white.flatten(), walk.flatten()),
             (white[:, :-1].flatten(), white[:, 1:].flatten())]
    for a, b in pairs:
        assert abs(torch.corrcoef(torch.stack([a, b]))[0, 1].item()) < 0.03
    other = port_pre.philox_noise(8, B, T, C, TransformArgs(random_walk_std=1.0))
    assert abs(torch.corrcoef(torch.stack([white.flatten(), other[:, :T].flatten()]))[0, 1]) < 0.03


def test_offset_is_constant_along_time():
    """The offset normal exists once per (b, c): with only the offset on and
    no smoothing, every row of a batch row carries the same values."""
    B, T, C = 3, 20, 16
    args = TransformArgs(white_noise_std=0.0, constant_offset_std=0.5, random_cut=0,
                         smooth_data=False)
    out, _ = port_pre.fused_preprocess(torch.zeros(B, T, C), torch.full((B,), T), args, True,
                                       seed=3)
    assert torch.equal(out, out[:, :1].expand(B, T, C))
    assert out[:, 0].abs().min().item() > 0 and not torch.equal(out[0, 0], out[1, 0])


def test_cpu_noise_follows_the_seed():
    x, nt = torch.zeros(2, 30, 8), torch.full((2,), 30)
    args = TransformArgs(random_cut=0)
    a, _ = port_pre.fused_preprocess(x, nt, args, True, seed=1)
    b, _ = port_pre.fused_preprocess(x, nt, args, True, seed=1)
    c, _ = port_pre.fused_preprocess(x, nt, args, True, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
