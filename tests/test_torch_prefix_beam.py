"""The port's CTC prefix beam searchers on the CPU: the numpy copy
(decode/prefix_beam.py) on the C++ gtest fixture, and the device searcher
(decode/prefix_beam_device.py) on the fixture and against the JAX searcher
(decode/prefix_beam_jax.py) on random inputs: plain, first-beam pruning,
input-length masking (tests/test_prefix_beam.py:26-40, :100-130)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b2txt_tpu.decode import ctc_prefix_beam_search_jax
from b2txt_tpu.decode.prefix_beam_jax import _mix as jax_mix
from b2txt_tpu_torch.decode import (CtcPrefixBeamSearch, ctc_prefix_beam_search,
                                    ctc_prefix_beam_search_device)
from b2txt_tpu_torch.decode.prefix_beam_device import _mix

FIXTURE = np.log(np.array([[0.25, 0.40, 0.35], [0.40, 0.35, 0.25], [0.10, 0.50, 0.40]],
                          np.float32))


def test_numpy_copy_on_the_gtest_fixture():
    """Expected values from ctc_prefix_beam_search_test.cc:29-59."""
    s = CtcPrefixBeamSearch(blank=0, first_beam_size=3, second_beam_size=3)
    s.search(FIXTURE)
    assert s.hypotheses == [[2, 1], [1, 2], [1]]
    np.testing.assert_allclose(np.exp(s.likelihood), [0.2185, 0.1550, 0.1525], rtol=1e-5)
    np.testing.assert_allclose(np.exp(s.viterbi_likelihood), [0.07, 0.064, 0.07], rtol=1e-5)
    assert s.times == [[0, 2], [0, 2], [2]]


def test_device_searcher_on_the_gtest_fixture():
    res = ctc_prefix_beam_search_device(FIXTURE, beam_width=3, nbest=3, device="cpu")
    assert [r[0] for r in res] == [[2, 1], [1, 2], [1]]
    np.testing.assert_allclose(np.exp([r[1] for r in res]), [0.2185, 0.1550, 0.1525],
                               rtol=1e-5)


@pytest.mark.parametrize("case", [
    dict(V=6, T=40, K=16),                          # tests/test_prefix_beam.py:100
    dict(V=8, T=20, K=12, first_beam_size=3),       # :116
    dict(V=5, T=30, K=8, input_length=18),          # :124
    dict(V=41, T=125, K=16, first_beam_size=16),    # the phoneme posteriors' shape
], ids=["plain", "first_beam", "input_length", "phonemes"])
def test_device_searcher_matches_jax(case):
    """The whole n-best: the same prefixes in the same order, scores within
    1e-4; and the numpy oracle's best prefix and score."""
    case = dict(case)
    V, T, K = case.pop("V"), case.pop("T"), case.pop("K")
    rng = np.random.default_rng(V * T)
    lp = np.log(rng.dirichlet(np.ones(V), size=T).astype(np.float32))
    want = ctc_prefix_beam_search_jax(lp, beam_width=K, nbest=K, **case)
    got = ctc_prefix_beam_search_device(lp, beam_width=K, nbest=K, device="cpu", **case)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-4,
                               atol=1e-5)
    n = case.get("input_length", T)
    oracle = ctc_prefix_beam_search(lp[:n], beam_size=K,
                                    first_beam_size=case.get("first_beam_size"))
    assert got[0][0] == oracle[0][0]
    np.testing.assert_allclose(got[0][1], oracle[0][1], rtol=1e-4)


def test_device_searcher_takes_a_tensor_on_its_device():
    lp = np.log(np.random.default_rng(2).dirichlet(np.ones(5), size=12).astype(np.float32))
    assert (ctc_prefix_beam_search_device(torch.from_numpy(lp), beam_width=8)
            == ctc_prefix_beam_search_device(lp, beam_width=8, device="cpu"))


def test_hash_mix_is_the_jax_packages_uint32_round():
    rng = np.random.default_rng(4)
    h = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    c = rng.integers(0, 41, 4096).astype(np.int32)
    for seed in (0x9E3779B9, 0x7F4A7C15):
        want = np.asarray(jax_mix(jnp.asarray(h), jnp.asarray(c), seed)).astype(np.int64)
        got = _mix(torch.from_numpy(h.astype(np.int64)), torch.from_numpy(c.astype(np.int64)),
                   seed)
        np.testing.assert_array_equal(got.numpy(), want)
