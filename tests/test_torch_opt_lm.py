"""The port's OPT (b2txt_tpu_torch.decode.opt_lm) against the JAX package's
on the CPU, at OPTConfig.tiny() (vocab 97, D 32, 2 layers): the forward's
logits (and transformers.OPTForCausalLM's through params_from_hf), and
OPTRescorer's packed, unpacked and context paths, with the tolerances of
tests/test_opt_lm.py. Weights cross with params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b2txt_tpu.decode import opt_lm as J
from b2txt_tpu_torch.decode import opt_lm as P

F32 = dict(rtol=1e-4, atol=1e-3)      # tests/test_opt_lm.py:205, :238-288
BF16 = dict(rtol=2e-2, atol=0.35)     # tests/test_opt_lm.py:214
TEXT_LENS = [1, 2, 3, 5, 9, 9, 14, 23, 40, 40, 7, 11, 2, 31, 6, 17, 29]
CTX = "the shared conversation so far"


def enc(t, n):
    return [(3 + 17 * b) % 97 for b in t.encode()][:n]


@pytest.fixture(scope="module")
def tiny():
    """(cfg, JAX params, the port's state dict on the CPU, texts)."""
    cfg = J.OPTConfig.tiny()
    params = J.init_params(jax.random.PRNGKey(0), cfg)
    sd = P.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(3)
    texts = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, n)) for n in TEXT_LENS]
    return cfg, params, sd, texts


def _batch(kind):
    rng = np.random.default_rng(0 if kind == "full" else 1)
    if kind == "full":
        lens = np.array([17, 17, 17])
    else:
        lens = np.array([21, 13, 5, 1])
    L = int(lens.max())
    tokens = rng.integers(0, 97, (len(lens), L))
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    return tokens * mask.astype(tokens.dtype), mask, lens


@pytest.mark.parametrize("kind", ["full", "padded"])
def test_forward_matches_jax(tiny, kind):
    """f32 logits on every real position (padding positions are free)."""
    cfg, params, sd, _ = tiny
    tokens, mask, lens = _batch(kind)
    want = np.asarray(J.forward(params, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask), cfg))
    model = P.OPTModel.from_state_dict(P.OPTConfig.tiny(), sd, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["full", "padded"])
def test_forward_matches_transformers(kind):
    """The port's forward against transformers.OPTForCausalLM, its weights
    loaded with load_state_dict (HF's names) and through params_from_hf."""
    transformers = pytest.importorskip("transformers")
    cfg = P.OPTConfig.tiny()
    hf_cfg = transformers.OPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, ffn_dim=cfg.ffn_dim,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        word_embed_proj_dim=cfg.hidden_size, do_layer_norm_before=True, dropout=0.0,
        activation_function="relu")
    torch.manual_seed(0)
    hf = transformers.OPTForCausalLM(hf_cfg).eval()
    model = P.OPTModel(cfg, device="cpu")
    model.load_state_dict(hf.state_dict())          # strict: the same names
    via = P.OPTModel.from_state_dict(cfg, P.params_from_hf(hf.state_dict()), "cpu")
    tokens, mask, lens = _batch(kind)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(tokens), attention_mask=torch.from_numpy(mask)).logits
        for m in (model, via):
            got = m(torch.from_numpy(tokens), torch.from_numpy(mask))
            for b, n in enumerate(lens):
                np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n].numpy(),
                                           rtol=1e-4, atol=2e-4)


def test_params_round_trip_and_shapes(tiny):
    """params_to_jax(params_from_jax(tree)) is the tree; the state dict has
    every HF name (lm_head tied); init_params draws N(0, 0.02) from its
    generator; the 6.7b names and parameter count (bench_opt.py's)."""
    cfg, params, sd, _ = tiny
    back = P.params_to_jax(sd, P.OPTConfig.tiny())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sd["lm_head.weight"] is sd["model.decoder.embed_tokens.weight"]
    assert set(sd) == set(P.param_shapes(P.OPTConfig.tiny())) | {"lm_head.weight"}

    draws = [P.init_params(P.OPTConfig.tiny(), "cpu", torch.float32,
                           torch.Generator().manual_seed(5)) for _ in range(2)]
    emb = draws[0]["model.decoder.embed_tokens.weight"]
    assert torch.equal(emb, draws[1]["model.decoder.embed_tokens.weight"])
    assert abs(float(emb.std()) - 0.02) < 2e-3
    assert torch.equal(draws[0]["model.decoder.layers.1.fc2.bias"], torch.zeros(32))

    big = P.OPTConfig.opt_6_7b()
    shapes = P.param_shapes(big)
    assert shapes["model.decoder.layers.31.fc1.weight"] == (16384, 4096)
    assert sum(int(np.prod(s)) for s in shapes.values()) == big.n_params == 6_658_473_984


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rescorer_matches_jax(tiny, pack, dtype):
    """OPTRescorer.score, packed and one row per text, at length penalties 0
    and 0.75, against the JAX rescorer on the same encode; bf16 scores are
    finite (the compute dtype's own mask floor)."""
    cfg, params, sd, texts = tiny
    ref = J.OPTRescorer(cfg, params=params, encode=enc, max_len=48, pack=pack,
                        compute_dtype=getattr(jnp, dtype))
    port = P.OPTRescorer(P.OPTConfig.tiny(), params=sd, encode=enc, device="cpu", max_len=48,
                         pack=pack, compute_dtype=getattr(torch, dtype))
    tol = F32 if dtype == "float32" else BF16
    for pen in (0.0, 0.75):
        got = port.score(texts, length_penalty=pen)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, ref.score(texts, length_penalty=pen), **tol)
    # the packing packed: fewer rows than texts
    assert len(P.pack_sequences([enc(t, 48) for t in texts], 64)) < len(texts)


@pytest.mark.parametrize("n", [1, 9, 17, 100])
def test_bucketed_packing_scores_as_the_unpadded_packing(tiny, n):
    """The packed rows padded with zero rows to a power of two and the
    segment bins to one (at least 16), the keys of the rescorer's graphs:
    the real rows are the plain packing's, and the scores those of the
    forward over the plain packing's exact shape."""
    _, _, sd, _ = tiny
    words = "the cat sat on a mat we will see it tomorrow hello there an apple".split()
    rng = np.random.default_rng(n)
    texts = [" ".join(rng.choice(words, int(rng.integers(1, 14)))) for _ in range(n)]
    resc = P.OPTRescorer(P.OPTConfig.tiny(), params=sd, encode=P.word_hash_encode(97),
                         device="cpu", max_len=64)
    ids = [resc.encode(t, resc.max_len) for t in texts]
    tokens, seg, pos, bins = resc._pack_arrays(ids)
    plain = resc._pack_rows(ids)
    rows = plain[0].shape[0]
    assert tokens.shape[0] == 1 << (rows - 1).bit_length() and plain[3] == n + 1
    assert bins == max(16, 1 << n.bit_length())
    for got, want in zip((tokens, seg, pos), plain[:3]):
        assert np.array_equal(got[:rows], want) and not got[rows:].any()
    with torch.inference_mode():
        sums, cnt, _ = resc._forward(plain[3], *(torch.from_numpy(a) for a in plain[:3]))
    want = sums[1:].numpy() - cnt[1:].numpy() * np.float32(0.5)
    np.testing.assert_array_equal(np.float32(resc.score(texts, 0.5)), want)


@pytest.mark.parametrize("max_len", [64, 16], ids=["prefix_kv", "concatenated"])
def test_context_matches_jax(tiny, max_len):
    """Context scoring: at max_len 64 through the prefix-KV path (context
    forward once); at 16 context + hypothesis overflow and both packages
    score the concatenated truncations. Both against the JAX rescorer and
    against concatenated scoring without a context."""
    cfg, params, sd, texts = tiny
    texts = texts[:4] + ["alpha beta", "g"]
    ref = J.OPTRescorer(cfg, params=params, encode=enc, encode_cont=enc, max_len=max_len)
    port = P.OPTRescorer(P.OPTConfig.tiny(), params=sd, encode=enc, encode_cont=enc,
                         device="cpu", max_len=max_len)
    flat = P.OPTRescorer(P.OPTConfig.tiny(), params=sd, encode=enc, device="cpu",
                         max_len=max_len, pack=False)
    for pen in (0.0, 0.4):
        got = port.score(texts, length_penalty=pen, context=CTX)
        np.testing.assert_allclose(got, ref.score(texts, length_penalty=pen, context=CTX), **F32)
        np.testing.assert_allclose(
            got, flat.score([CTX + " " + t for t in texts], length_penalty=pen), **F32)
    assert (port.prefix_runs > 0) == (max_len == 64) == bool(ref._prefix)
    if max_len == 64:
        bf = P.OPTRescorer(P.OPTConfig.tiny(), params=sd, encode=enc, encode_cont=enc,
                           device="cpu", max_len=max_len, compute_dtype=torch.bfloat16)
        got = bf.score(texts, context=CTX)
        assert bf.prefix_runs == 1 and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, port.score(texts, context=CTX), rtol=2e-2, atol=0.5)


def test_score_async_matches_score_and_waits_only_in_the_fetch(tiny, monkeypatch):
    """score_async enqueues and returns; nothing reads a tensor back to the
    host before the thunk is called (the service overlaps its host work
    with the forward), and the fetched scores equal score()'s."""
    _, _, sd, texts = tiny
    texts = texts[:5]
    cases = [(P.OPTRescorer(P.OPTConfig.tiny(), params=sd, encode=enc, encode_cont=enc,
                            device="cpu", max_len=64, pack=pack), ctx)
             for pack, ctx in ((True, None), (False, None), (True, CTX))]
    want = [r.score(texts, 0.25, context=ctx) for r, ctx in cases]

    def refuse(*a, **k):
        raise AssertionError("host read before the fetch")

    with monkeypatch.context() as m:
        for name in ("cpu", "item", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        thunks = [r.score_async(texts, 0.25, context=ctx) for r, ctx in cases]
    for th, w in zip(thunks, want):
        np.testing.assert_allclose(th(), w, rtol=1e-5)


def test_text_helpers_are_the_jax_packages():
    words = ["the cat sat", "", "a much longer candidate with several words in it"]
    assert [P.word_hash_encode(50272)(t, 8) for t in words] == [
        J.word_hash_encode(50272)(t, 8) for t in words]
    ids = [[1] * n for n in (5, 30, 12, 64, 1, 33, 7)]
    assert P.pack_sequences(ids, 64) == J.pack_sequences(ids, 64)


def test_segment_sum_matches_a_float64_sum():
    """The packed scores' segment sum (ids in any order; sorted for the
    merges of the searchers) against a float64 sum: empty segments 0."""
    from b2txt_tpu_torch.ops.segment import segment_sum, sorted_segment_sum

    gen = torch.Generator().manual_seed(0)
    seg = torch.randint(0, 70, (5000,), generator=gen)
    values = torch.randn(5000, 2, generator=gen)
    ref = torch.zeros(100, 2, dtype=torch.float64).index_add_(0, seg, values.double())
    got = segment_sum(values, seg, 100)
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-4)
    assert torch.equal(got[70:], torch.zeros(30, 2))
    seg_s, perm = torch.sort(seg, stable=True)
    assert torch.equal(sorted_segment_sum(values[perm], seg_s, 100), got)
