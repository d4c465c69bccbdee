"""The port's connected-pipeline world (b2txt_tpu_torch/scripts/world.py)
against the world helpers of the JAX package's bench.py: the same files byte
for byte, the same planted utterances, the same scores, and stage 1 equal to
the JAX pieces on the same numpy features."""

import ast
import filecmp
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode.lmbeam import DecodeResult
from b2txt_tpu_torch.scripts import world

ROOT = Path(__file__).resolve().parent.parent
HELPERS = ("make_stage1", "build_world", "make_planted_utts", "score_results", "aggregate_wer")


@pytest.fixture(scope="module")
def bench():
    """bench.py's world helpers, taken from its source: importing bench.py
    would also switch on JAX's persistent compilation cache under $HOME."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    mod = ast.Module(body=[n for n in tree.body
                           if isinstance(n, ast.FunctionDef) and n.name in HELPERS],
                     type_ignores=[])
    ns = {"np": np, "os": os, "time": time, "jax": jax, "jnp": jnp}
    exec(compile(mod, "bench.py", "exec"), ns)
    return ns


def _files(w):
    return w[4], w[5], w[6]   # arpa, arpa_unpruned, lexicon path


@pytest.mark.parametrize("adversarial", [False, True])
def test_build_world_writes_the_same_files(bench, adversarial):
    ours = world.build_world(300, adversarial=adversarial)
    theirs = bench["build_world"](300, adversarial=adversarial)
    assert ours[3] == theirs[3]                      # the word list, in order
    for a, b in zip(_files(ours), _files(theirs)):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
    assert ours[8] == theirs[8]                      # the lexicon statistics
    # the generator is left in the same state: the planted utterances agree
    u_ours = world.make_planted_utts(ours[0], ours[3], ours[7], 12, 288)
    u_theirs = bench["make_planted_utts"](theirs[0], theirs[3], theirs[7], 12, 288)
    assert [s for s, _ in u_ours] == [s for s, _ in u_theirs]
    for (_, a), (_, b) in zip(u_ours, u_theirs):
        np.testing.assert_array_equal(a, b)


def test_real_lexicon_raises_without_the_reference_dict(bench, monkeypatch):
    from b2txt_tpu.data import real_assets as jax_assets
    from b2txt_tpu_torch.data import real_assets as port_assets

    monkeypatch.setattr(jax_assets, "have_real_dict", lambda: False)
    monkeypatch.setattr(port_assets, "have_real_dict", lambda: False)
    with pytest.raises(SystemExit, match="dict.txt not found"):
        world.build_world(300, real_lexicon=True)
    with pytest.raises(SystemExit, match="dict.txt not found"):
        bench["build_world"](300, real_lexicon=True)


def test_scores_equal_the_jax_helpers(bench):
    """score_results and aggregate_wer over the same n-best lists: exact
    answers, a search error (the truth out-scores the answer), a miss with
    the truth scoring lower, an empty list."""
    from b2txt_tpu_torch.utils.config import DecodeConfig

    cfg = DecodeConfig(acoustic_scale=0.325)
    sents = ["a b c", "d e", "f g h", "i j", "k"]
    results = [
        [DecodeResult("a b c", -10.0, -5.0), DecodeResult("a b", -12.0, -4.0)],
        [DecodeResult("d f", -20.0, -8.0), DecodeResult("d e", -10.0, -6.0)],
        [DecodeResult("f g", -10.0, -5.0), DecodeResult("f g h", -30.0, -9.0)],
        [],
        [DecodeResult("k", -1.0, -1.0)],
    ]
    assert world.score_results(cfg, sents, results) == bench["score_results"](
        cfg, sents, results) == (2, 1)
    assert world.aggregate_wer(sents, results) == bench["aggregate_wer"](sents, results)


def test_stage1_equals_the_jax_pieces_at_a_soft_gain():
    """Planted weights at head gain 18, 'valid' smoothing, the full-width
    forward and the log-softmax, in f32, on the same numpy features: the
    model forward's tolerance (tests/test_gru_model.py)."""
    from b2txt_tpu.models import gru_decoder
    from b2txt_tpu.models.planted import planted_params
    from b2txt_tpu.ops.smoothing import gauss_smooth
    from b2txt_tpu.utils import TrainConfig
    from b2txt_tpu_torch.data.synthetic import phoneme_code

    B, T, gain = 2, 96, 18.0
    run, P, info = world.make_stage1(B, T, head_gain=gain, device="cpu",
                                     compute_dtype=torch.float32)
    assert info["decode_frames"] == P == (T - 8 - 14) // 4 + 1
    cfg = TrainConfig()
    code = phoneme_code(cfg.model.n_input_features)
    rng = np.random.default_rng(3)
    labels = rng.integers(-1, 41, (B, T))
    x = np.where((labels >= 0)[..., None], code[np.maximum(labels, 0)], 0.0)
    x = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)

    ours = run.posteriors(torch.from_numpy(x)).numpy()
    params = planted_params(cfg.model, 45, code, head_gain=gain)
    dt = cfg.dataset.data_transforms
    sm = gauss_smooth(jnp.asarray(x), std=dt.smooth_kernel_std, size=dt.smooth_kernel_size,
                      padding="valid")
    logits = gru_decoder.forward(params, sm, jnp.asarray(np.arange(B) % 45, jnp.int32),
                                 patch_size=cfg.model.patch_size,
                                 patch_stride=cfg.model.patch_stride,
                                 compute_dtype=jnp.float32)
    theirs = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))
    assert ours.shape == theirs.shape == (B, P, 41)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
    # the labels path draws its features on the device from the generator
    lp = run(labels, torch.Generator().manual_seed(0))
    assert lp.shape == (B, P, 41) and lp.dtype == torch.float32
    assert torch.isfinite(lp).all()
