"""DeepSeek-V2 (decode/deepseek_lm.py) against its plain float32 reference
(benchmark/reference/deepseek_v2.py) on the CPU, at a tiny size: hidden 64, 3 layers
of which the first is dense, 8 experts top-3 with 1 shared, kv rank 32,
vocabulary 97.

Tolerances: both sides compute in float32 on the same weights, but sum in
other orders (the plain expert path weights every expert's output by a
dense matrix, einsum against matmul), a few ulps a product; 2e-5 on logits
of order 1 and on sentence sums of order 10 is ~40 times the widest gap
seen.
"""

import math
from dataclasses import asdict

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import deepseek_lm as D
from b2txt_tpu_torch.decode.packed_scorer import _bucket, word_hash_encode
from b2txt_tpu_torch.ops import moe
from b2txt_tpu_torch.utils import profiling
from benchmark.reference import deepseek_v2 as R

CFG = D.DeepseekV2Config.tiny()
ATOL = 2e-5
TEXTS = ["the cat sat on the mat", "a dog", "the quick brown fox jumps over the lazy dog",
         "hello", "we will see it tomorrow morning", "an apple a day"]
enc = word_hash_encode(CFG.vocab_size)


def params(seed, std=0.1):
    return D.init_params(CFG, "cpu", torch.float32, torch.Generator().manual_seed(seed), std=std)


def batch(seed):
    g = torch.Generator().manual_seed(seed + 100)
    tok = torch.randint(0, CFG.vocab_size, (3, 11), generator=g)
    mask = torch.ones(3, 11)
    mask[1, 7:] = 0
    mask[2, 2:] = 0
    return tok, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_the_plain_reference(seed):
    sd = params(seed)
    tok, mask = batch(seed)
    routing = []
    got = D.DeepseekV2Model.from_state_dict(CFG, sd, "cpu")(tok, mask, routing=routing)
    ref, chosen, gap = R.forward(sd, asdict(CFG), tok, mask.bool(), "cpu")
    real = mask.bool()
    np.testing.assert_allclose(got[real].numpy(), ref[real].numpy(), atol=ATOL, rtol=0)
    # the same experts, and the padding sent to the expert no kernel runs
    assert gap == 0.0 and len(routing) == len(chosen) == 2
    for (idx, counts), c in zip(routing, chosen):
        assert torch.equal(idx[real].sort(-1).values, c.sort(-1).values)
        assert (idx[~real] == CFG.n_routed_experts).all()
        assert counts[-1] == (~real).sum() * CFG.num_experts_per_tok


def test_packed_rows_equal_unpacked_rows():
    sd = params(3)
    scores = [D.DeepseekV2Rescorer(CFG, enc, params=sd, device="cpu", pack=pack).score(TEXTS)
              for pack in (True, False)]
    np.testing.assert_allclose(scores[0], scores[1], atol=ATOL, rtol=0)
    # and the logits of one packed row equal its segments' own
    model = D.DeepseekV2Model.from_state_dict(CFG, sd, "cpu")
    a, b = enc(TEXTS[0], 64), enc(TEXTS[4], 64)
    tok = torch.tensor([a + b])
    seg = torch.tensor([[1] * len(a) + [2] * len(b)])
    pos = torch.tensor([list(range(len(a))) + list(range(len(b)))])
    packed = model(tok, torch.ones_like(tok, dtype=torch.float32), positions=pos,
                   segment_ids=seg)[0]
    alone = [model(torch.tensor([s]), torch.ones(1, len(s)))[0] for s in (a, b)]
    np.testing.assert_allclose(packed.numpy(), torch.cat(alone).numpy(), atol=ATOL, rtol=0)


def test_yarn_frequencies_and_softmax_scale_are_the_hand_worked_values():
    lite = D.DeepseekV2Config.deepseek_v2_lite()
    f = D.yarn_inv_freq(lite).double().numpy()
    # correction dims: floor(64 ln(4096 / (32 · 2π)) / (2 ln 10^4)) = 10 and
    # ceil(64 ln(4096 / (1 · 2π)) / (2 ln 10^4)) = 23; the ramp runs between
    base = 10000.0 ** (-np.arange(32) / 32)
    np.testing.assert_allclose(f[:11], base[:11], rtol=1e-6)
    np.testing.assert_allclose(f[23:], base[23:] / 40, rtol=1e-6)
    np.testing.assert_allclose(f[11], base[11] * (12 / 13 + 1 / 13 / 40), rtol=1e-6)
    assert abs(f[11] - 0.0390069) < 1e-6
    # 192^-1/2 · (0.1 · 0.707 · ln 40 + 1)^2
    assert D.softmax_scale(lite) == pytest.approx(0.1147213867929261, rel=1e-12)
    assert R.softmax_scale(asdict(lite)) == pytest.approx(0.1147213867929261, rel=1e-12)
    np.testing.assert_allclose(R.yarn_inv_freq(asdict(lite)).numpy(), f, rtol=1e-6)
    m = D.DeepseekV2Model(CFG, device="meta")
    assert m.rope_scale == 1.0 and R.rope_scale(asdict(CFG)) == 1.0
    assert lite.n_params == 15_706_484_224


def test_no_token_is_dropped_when_the_router_sends_every_token_to_one_expert():
    """A planted router: hidden unit 0 holds a positive constant for every
    token through every layer, and only expert 5's gate row reads it, so
    expert 5 is every token's first choice; its output counts for each."""
    sd = params(4)
    e = 5
    for name, t in sd.items():
        if name == "model.embed_tokens.weight":
            t[:, 0] = 1.0
        elif name.endswith(("o_proj.weight", "mlp.down_proj.weight",
                            "shared_experts.down_proj.weight")):
            t[0] = 0.0
        elif name.endswith("experts.down_proj.weight"):
            t[:, 0] = 0.0
        elif name.endswith("mlp.gate.weight"):
            t.zero_()
            t[e, 0] = 5.0
    tok, mask = batch(4)
    routing = []
    got = D.DeepseekV2Model.from_state_dict(CFG, sd, "cpu")(tok, mask, routing=routing)
    ref, _, gap = R.forward(sd, asdict(CFG), tok, mask.bool(), "cpu")
    real = mask.bool()
    for idx, counts in routing:
        assert (idx[real][:, 0] == e).all() and counts[e] == real.sum()
    np.testing.assert_allclose(got[real].numpy(), ref[real].numpy(), atol=ATOL, rtol=0)
    assert gap == 0.0


def test_rescorer_scores_are_the_references_sentence_sums():
    sd = params(5)
    got = D.DeepseekV2Rescorer(CFG, enc, params=sd, device="cpu").score(TEXTS, 0.5)
    ids = [enc(t, 256) for t in TEXTS]
    want, _, _ = R.sequence_scores(sd, asdict(CFG), ids, "cpu")
    np.testing.assert_allclose(got, np.array(want) - 0.5 * np.array([len(s) for s in ids]),
                               atol=ATOL, rtol=0)


def test_packing_pads_to_a_few_shapes():
    """Rows padded to a power of two (at least 2), segment bins to one (at
    least 16): the padding is all zeros, the real rows are the shared
    packing's, and the scores are the same for any padding."""
    resc = D.DeepseekV2Rescorer(CFG, enc, params=params(7), device="cpu", max_len=16)
    ids = [enc(t, 16) for t in TEXTS]
    tokens, seg, pos, n = resc._pack_arrays(ids)
    base = resc._pack_rows(ids)
    assert base[0].shape == (3, 16) and tokens.shape == (4, 16) and n == 16 and base[3] == 7
    for got, want in zip((tokens, seg, pos), base[:3]):
        assert np.array_equal(got[:3], want) and not got[3:].any()
    assert [_bucket(k, 2) for k in (1, 2, 3, 5)] == [2, 2, 4, 8]
    assert [_bucket(k, 16) for k in (7, 16, 17)] == [16, 16, 32]
    want, _, _ = R.sequence_scores(params(7), asdict(CFG), ids, "cpu")
    np.testing.assert_allclose(resc.score(TEXTS), want, atol=ATOL, rtol=0)


def test_score_async_returns_before_its_fetch_and_counts(monkeypatch):
    """score_async enqueues; nothing reads a tensor back before the thunk,
    which copies the touched experts with the scores."""
    sd = params(6)
    resc = D.DeepseekV2Rescorer(CFG, enc, params=sd, device="cpu")
    want = resc.score(TEXTS[:4])

    def refuse(*a, **k):
        raise AssertionError("host read before the fetch")

    with profiling.tracing():
        with monkeypatch.context() as m:
            for name in ("cpu", "item", "tolist", "numpy"):
                m.setattr(torch.Tensor, name, refuse)
            thunk = resc.score_async(TEXTS[:4])
        np.testing.assert_allclose(thunk(), want, rtol=1e-6)
        counters = profiling.counters()
        names = [r.name for r in profiling.records()]
    n_tok = sum(len(enc(t, 256)) for t in TEXTS[:4])
    assert counters["moe.tokens"] == n_tok * 2
    assert 3 <= counters["moe.experts_touched"] <= 2 * CFG.n_routed_experts
    assert names.count("dsv2.dispatch") == names.count("dsv2.fetch") == 1
    assert names.count("mla.attention") == 3 and names.count("moe.experts") == 2


def test_grouping_sorts_the_pairs_by_expert():
    """The kernels' prelude: pairs sorted by expert, offsets from the
    counts, the inverse order, padding last."""
    g = torch.Generator().manual_seed(7)
    h = torch.randn(10, 16, generator=g)
    real = torch.ones(10, dtype=torch.bool)
    real[8:] = False
    gate = torch.randn(8, 16, generator=g)
    w, idx, counts = moe.route(h, gate, 3, 1.0, real)
    rows, order, inv, offsets = moe.group(idx, counts)
    flat = idx.reshape(-1)
    assert torch.equal(flat[order], flat[order].sort().values)
    assert torch.equal(order[inv], torch.arange(30))
    assert torch.equal(rows, (order // 3).to(torch.int32))
    for e in range(9):
        assert (flat[order][offsets[e]:offsets[e + 1]] == e).all()
    assert offsets[-1] == 30 and counts[8] == 6
    # the weights: the softmax's top 3, not renormalized
    assert torch.allclose(w, torch.softmax(h @ gate.T, -1).topk(3).values)


def test_config_takes_the_published_keys():
    published = asdict(D.DeepseekV2Config())
    assert D.DeepseekV2Config(**published) == D.DeepseekV2Config.deepseek_v2_lite()
    assert math.isclose(published["rope_scaling"]["mscale_all_dim"], 0.707)
    with pytest.raises(ValueError, match="norm_topk_prob"):
        D.DeepseekV2Config(norm_topk_prob=True)
