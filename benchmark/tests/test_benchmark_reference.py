"""The yardstick on the CPU: operation counts against hand-worked values,
the plain reference against hand-worked cases and torch.nn.GRU, and the
traffic generator's repeatability."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import flops
from benchmark.drivers import common
from benchmark.reference import gru as ref_gru
from benchmark.reference.opt import draw_weights, sequence_scores, word_hash_encode
from benchmark.reference.rescore import augment_nbest
from benchmark.reference.train import lr_at
from benchmark.traffic import stratified

SMALL = dict(n_input_features=4, n_units=3, n_layers=2, n_classes=5, patch_size=2,
             patch_stride=1, smooth_kernel_std=2.0, smooth_kernel_size=100)


def test_stage1_flops_by_hand():
    K = flops.kernel_taps(SMALL)
    assert K == len(ref_gru.gaussian_kernel(2.0, 100))
    bins, frames = 40, 20
    smoothed = bins - (K - 1)
    per_bin = 2 * K * 4 + 2 * 4 * 4
    per_frame = (2 * 8 * 9) + (2 * 3 * 9) + 2 * (2 * 3 * 9) + 2 * 3 * 5
    assert flops.stage1_flops(SMALL, bins, frames) == smoothed * per_bin + frames * per_frame
    assert flops.stage1_flops(SMALL, bins, frames, same=True) == bins * per_bin + frames * per_frame


def test_gru_kernel_counts_by_hand():
    f = flops.gru_layer_fwd(B=2, F=10, H=4)
    assert f["flops"] == 2 * 10 * 4 * 12
    assert f["bytes"] == 2 * (10 * 12 + 12 * 4 + 12 + 2 * 4 + 10 * 4 + 2 * 4)
    b = flops.gru_layer_bwd(B=2, F=10, H=4)
    assert b["flops"] == 2 * 2 * 10 * 4 * 12
    assert b["bytes"] == 2 * (10 * 12 + 12 * 4 + 12 + 2 * 4 + 2 * 10 * 4 + 2 * 10 * 12) + 4 * 2 * 4 * 2
    assert flops.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_opt_flops_by_hand():
    cfg = dict(hidden_size=2, ffn_dim=3, vocab_size=5, num_layers=1)
    per_token = 2 * (4 * 4 + 2 * 2 * 3) + 2 * 2 * 5
    attn = 2 * 2 * 2 * 3 * 4 / 2
    assert flops.opt_forward_flops(cfg, [3]) == 3 * per_token + attn


def test_reference_gru_equals_torch_gru():
    torch.manual_seed(0)
    D, H, C = 4, 6, 5
    cfg = dict(SMALL, n_input_features=D, n_units=H, n_layers=2, n_classes=C, patch_size=1,
               patch_stride=1)
    gru = torch.nn.GRU(D, H, num_layers=2, batch_first=True)
    head = torch.nn.Linear(H, C)
    sd = {f"gru.{k}": v.detach() for k, v in gru.state_dict().items()}
    sd.update({"day_weights.0": torch.eye(D), "day_biases.0": torch.zeros(1, D),
               "out.weight": head.weight.detach(), "out.bias": head.bias.detach(),
               "h0": torch.zeros(1, 1, H)})
    x = np.random.default_rng(0).standard_normal((60, D)).astype(np.float32)
    got = ref_gru.log_posteriors(sd, x, 0, cfg, "cpu")
    kern = torch.from_numpy(ref_gru.gaussian_kernel(2.0, 100))
    xt = torch.from_numpy(x)
    K = len(kern)
    sm = sum(kern[k] * xt[k: k + 60 - K + 1] for k in range(K))
    sm = sm / (1 + sm.abs())
    with torch.no_grad():
        out, _ = gru(sm[None])
        want = torch.log_softmax(head(out[0]), -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ref_gru.n_frames(cfg, 60) == got.shape[0]


def test_opt_scores_of_zero_weights_by_hand():
    cfg = dict(vocab_size=11, hidden_size=8, ffn_dim=16, num_layers=2, num_heads=2,
               max_position_embeddings=16)
    sd = draw_weights(cfg, 3, "cpu", torch.float32)
    for k in sd:
        sd[k] = torch.zeros_like(sd[k])
    got = sequence_scores(sd, cfg, [[2, 5, 7, 1], [2, 3]], "cpu")
    assert got == pytest.approx([-3 * math.log(11), -math.log(11)], rel=1e-6)


def test_opt_weights_repeat_by_seed_and_encode_is_stable():
    cfg = dict(vocab_size=11, hidden_size=8, ffn_dim=16, num_layers=1, num_heads=2,
               max_position_embeddings=16)
    a, b = draw_weights(cfg, 5, "cpu"), draw_weights(cfg, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["lm_head.weight"] is a["model.decoder.embed_tokens.weight"]
    enc = word_hash_encode(50272)
    assert enc("wab wcd", 256) == enc("wab wcd", 256) and enc("wab wcd", 256)[0] == 2
    assert len(enc("a b c", 2)) == 2


def test_augment_and_gaps_by_hand():
    rows = augment_nbest([("a b c", -10.0, -5.0), ("a x c", -11.0, -5.0)], 20, 0.5, 0.01)
    assert [r[0] for r in rows] == ["a b c", "a x c"]
    served = [("a b c", -10.0, -5.0, 0.0, 0.0), ("z", 0.0, 0.0, 0.0, 0.0)]
    ref = [("a b c", -10.2, -5.0), ("a x c", -11.0, -4.0)]
    score, best = common.nbest_gaps(served, ref, "a b c", 0.5)
    assert score == pytest.approx(0.1)
    assert best == pytest.approx((0.5 * -11.0 - 4.0) - (0.5 * -10.2 - 5.0))
    assert common.nbest_gaps(served, ref, "a x c", 0.5)[1] == 0.0
    assert common.nbest_gaps(served, ref, "z", 0.5)[1] == math.inf
    a = np.array([[0.0, -1.0, -50.0]])
    b = np.array([[-0.1, -1.3, -30.0]])
    assert common.posterior_gap(a, b, -20.0) == pytest.approx(0.3)


def test_lr_schedule_by_hand():
    assert lr_at(0, 0.005, 1e-4, 120000, 1000) == 0.0
    assert lr_at(2, 0.005, 1e-4, 120000, 1000) == pytest.approx(0.005 * 2 / 1000)
    assert lr_at(120000, 0.005, 1e-4, 120000, 1000) == pytest.approx(1e-4)


def test_stratified_keeps_the_multiset():
    a = stratified(24, 48, 4, np.random.default_rng(1))
    b = stratified(24, 48, 4, np.random.default_rng(2))
    assert sorted(a) == sorted(b) == [27, 33, 39, 45]
    lens = stratified(360, 680, 144, np.random.default_rng(3))
    assert min(lens) >= 360 and max(lens) <= 680 and len(set(lens)) > 100


def test_traffic_repeats_by_seed(tmp_path, monkeypatch):
    from benchmark import traffic, world

    monkeypatch.setattr(world, "CACHE_DIR", str(tmp_path))
    wcfg = dict(vocab_size=200, order=3, prune_threshold=3e-8, world_seed=0)
    d, words, prons = world.build_world(wcfg)
    assert len(words) == 200 and len(prons) == 200
    code = torch.from_numpy(world.phoneme_code(16))
    tr = dict(calls=1, sessions_per_call=2, trials_per_session=[3, 5], bins=[360, 420])
    a = traffic.session_calls(tr, 4, words, prons, code, 2 ** 40 + 7, 0.3)
    b = traffic.session_calls(tr, 4, words, prons, code, 2 ** 40 + 7, 0.3)
    c = traffic.session_calls(tr, 4, words, prons, code, 2 ** 40 + 8, 0.3)
    flat = lambda calls: [t for s in calls[0] for t in s.trials]  # noqa: E731
    assert [t.sentence for t in flat(a)] == [t.sentence for t in flat(b)]
    assert all(np.array_equal(x.features, y.features) for x, y in zip(flat(a), flat(b)))
    assert [t.sentence for t in flat(a)] != [t.sentence for t in flat(c)]
    assert sorted(len(s.trials) for s in a[0]) == sorted(len(s.trials) for s in c[0])
    t1, d1 = traffic.trial_stream(dict(pool=5, bins=[360, 420]), 4, words, prons, code, 9, 0.3)
    t2, d2 = traffic.trial_stream(dict(pool=5, bins=[360, 420]), 4, words, prons, code, 9, 0.3)
    assert d1 == d2 and [t.sentence for t in t1] == [t.sentence for t in t2]
