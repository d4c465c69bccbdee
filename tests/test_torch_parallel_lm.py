"""The rescorers' tensor parallelism on the CPU over gloo: the tiny OPT
(``OPTRescorer(mesh=...)``) against the unsharded port and the JAX
package's mesh rescorer (tests/test_opt_lm.py:289-312), the byte-level
transformer (``DeviceCausalLMRescorer(mesh=...)``) against the unsharded
one and JAX's (tests/test_llm_rescorer.py:53-66), and the 6.7b layout on
the meta device (the counterpart of tests/test_opt_lm.py:145).

One group of 4 ranks runs the meshes (2, 2) and (1, 4); JAX is imported
inside the fixtures only."""

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import device_lm, opt_lm
from b2txt_tpu_torch.parallel import make_mesh, spawn

WORLD = 4
MESHES = [(2, 2), (1, 4)]
F32 = dict(rtol=1e-4, atol=1e-3)       # tests/test_opt_lm.py:305-312
BYTE = dict(rtol=1e-4, atol=1e-4)      # tests/test_llm_rescorer.py:64-66
TEXTS = ["alpha beta", "g", "the longest of the candidate texts here",
         "mid sized one", "another medium candidate"]
CTX = "the shared conversation"
BYTE_TEXTS = ["the cat sat on the mat", "there is the cat", "hello"]
SPAWN_DEADLINE_S = 120


def enc(t, n):
    """tests/test_opt_lm.py:298's encoder."""
    return [(5 + 13 * b) % 97 for b in t.encode()][:n]


def _texts():
    rng = np.random.default_rng(3)
    extra = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
             for n in (9, 14, 23, 40, 40, 7, 31, 17, 29)]
    return TEXTS + extra


def _opt(sd, **kw):
    return opt_lm.OPTRescorer(opt_lm.OPTConfig.tiny(), params=sd, encode=enc, encode_cont=enc,
                              max_len=64, device="cpu", **kw)


def _opt_scores(resc, texts):
    return {"packed": resc.score(texts), "context": resc.score(texts, context=CTX),
            "prefix_runs": resc.prefix_runs}


def _rank_cases(sd_np, byte_np, texts):
    sd = {k: torch.from_numpy(v) for k, v in sd_np.items()}
    byte = device_lm.params_from_jax(byte_np, device="cpu")
    out = {}
    for shape in MESHES:
        mesh = make_mesh(WORLD, model_parallel=shape[1])
        resc = _opt(sd, mesh=mesh)
        out[shape] = {**_opt_scores(resc, texts),
                      "unpacked": _opt(sd, mesh=mesh, pack=False).score(texts),
                      "graphs": resc._graphs,
                      "q_proj": tuple(resc.model.model.decoder.layers[0].self_attn.q_proj
                                      .weight.shape),
                      "byte": device_lm.DeviceCausalLMRescorer(
                          params=byte, mesh=mesh, device="cpu").score(BYTE_TEXTS)}
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax
    from jax.sharding import Mesh

    from b2txt_tpu.decode import jax_lm
    from b2txt_tpu.decode import opt_lm as J

    cfg = J.OPTConfig.tiny()
    params = jax.tree_util.tree_map(np.asarray, J.init_params(jax.random.PRNGKey(0), cfg))
    texts = _texts()
    opt_mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    jresc = J.OPTRescorer(cfg, params=params, encode=enc, max_len=64, pack=True,
                          mesh=opt_mesh, encode_cont=enc)
    byte_single = jax_lm.JaxCausalLMRescorer(seed=2)
    byte_mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    byte_params = jax.tree_util.tree_map(np.asarray, byte_single.params)
    jbyte = jax_lm.JaxCausalLMRescorer(params=byte_params, mesh=byte_mesh)
    sd = {k: v.numpy() for k, v in opt_lm.params_from_jax(params, device="cpu").items()}
    return {"sd": sd, "byte": byte_params, "texts": texts,
            "opt": {"packed": jresc.score(texts), "context": jresc.score(texts, context=CTX)},
            "byte_scores": jbyte.score(BYTE_TEXTS)}


@pytest.fixture(scope="module")
def ranks(jax_side):
    return spawn(_rank_cases, WORLD, args=(jax_side["sd"], jax_side["byte"], jax_side["texts"]),
                 timeout_s=SPAWN_DEADLINE_S)


@pytest.fixture(scope="module")
def host(jax_side):
    """The unsharded port, in one process."""
    sd = {k: torch.from_numpy(v) for k, v in jax_side["sd"].items()}
    byte = device_lm.params_from_jax(jax_side["byte"], device="cpu")
    return {**_opt_scores(_opt(sd), jax_side["texts"]),
            "unpacked": _opt(sd, pack=False).score(jax_side["texts"]),
            "byte": device_lm.DeviceCausalLMRescorer(params=byte, device="cpu").score(BYTE_TEXTS)}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("path", ["packed", "context", "unpacked"])
def test_opt_mesh_equals_host(ranks, host, shape, path):
    for r in ranks:
        np.testing.assert_allclose(r[shape][path], host[path], **F32)
    assert ranks[0][shape]["prefix_runs"] == host["prefix_runs"] == 1


@pytest.mark.parametrize("path", ["packed", "context"])
def test_opt_mesh_equals_jax_mesh(ranks, jax_side, path):
    np.testing.assert_allclose(ranks[0][(2, 2)][path], jax_side["opt"][path], **F32)


def _one_rank_case(sd):
    """The mesh (1, 1) and the unsharded rescorer in bf16, in one rank."""
    mesh = make_mesh(1, model_parallel=1)
    out = {}
    for name, m in (("mesh", mesh), ("unsharded", None)):
        out[name] = {**_opt_scores(_opt(sd, mesh=m, compute_dtype=torch.bfloat16), _texts()),
                     "unpacked": _opt(sd, mesh=m, pack=False,
                                      compute_dtype=torch.bfloat16).score(_texts())}
    return out


@pytest.fixture(scope="module")
def one_rank():
    """Tiny OPT in bf16 with non-zero biases (``init_params`` draws them 0)."""
    gen = torch.Generator().manual_seed(5)
    sd = opt_lm.init_params(opt_lm.OPTConfig.tiny(), "cpu", torch.float32, gen)
    for name in sd:
        if name.endswith(".bias"):
            sd[name] = torch.randn(sd[name].shape, generator=gen) * 0.5
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    return spawn(_one_rank_case, 1, args=(sd,), timeout_s=SPAWN_DEADLINE_S)[0]


@pytest.mark.parametrize("path", ["packed", "context", "unpacked"])
def test_opt_mesh_of_one_equals_unsharded_bit_for_bit(one_rank, path):
    """A group of one runs the unsharded forward: out_proj's and fc2's
    biases go into the first rank's product, not after the all_reduce (a
    bf16 add after the product rounds twice: up to 8.9e-3 apart on these
    scores before that repair)."""
    np.testing.assert_array_equal(one_rank["mesh"][path], one_rank["unsharded"][path])


@pytest.mark.parametrize("shape", MESHES)
def test_opt_mesh_keeps_no_graphs(ranks, jax_side, shape):
    """The mesh's forward all-reduces inside its layers, so it runs op by op:
    no rank keeps a graph cache, where the unsharded rescorer keeps one."""
    assert all(r[shape]["graphs"] is None for r in ranks)
    assert _opt({k: torch.from_numpy(v) for k, v in jax_side["sd"].items()})._graphs is not None


@pytest.mark.parametrize("shape", MESHES)
def test_opt_heads_split(ranks, shape):
    D = opt_lm.OPTConfig.tiny().hidden_size
    assert ranks[0][shape]["q_proj"] == (D // shape[1], D)


@pytest.mark.parametrize("shape", MESHES)
def test_byte_lm_mesh_equals_single_device(ranks, host, jax_side, shape):
    for r in ranks:
        np.testing.assert_allclose(r[shape]["byte"], host["byte"], **BYTE)
    np.testing.assert_allclose(ranks[0][shape]["byte"], jax_side["byte_scores"], **BYTE)


def test_byte_lm_partition_specs_cover_the_tree(jax_side):
    byte = device_lm.params_from_jax(jax_side["byte"], device="cpu")
    specs = device_lm.param_partition_specs(byte)
    assert set(specs) == set(byte)
    assert [set(b) for b in specs["blocks"]] == [set(b) for b in byte["blocks"]]


def test_6_7b_tensor_parallel_layout_on_meta():
    """The tensor-parallel OPT-6.7b at model = 4 without its weights: each
    column- and row-parallel weight a quarter of its published shape,
    embeddings and norms whole, ~1.826 B parameters (3.65 GB in bf16) a
    rank: 1.611 B sharded + 0.214 B of embeddings."""
    cfg = opt_lm.OPTConfig.opt_6_7b()
    M = 4
    model = opt_lm.OPTModel(cfg, device="meta", dtype=torch.bfloat16, model_parallel=M)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    full = opt_lm.param_shapes(cfg)
    specs = opt_lm.partition_specs(cfg)
    assert set(shapes) == set(full)
    for name, shape in full.items():
        want = list(shape)
        if specs[name] is not None:
            want[specs[name]] //= M
        assert shapes[name] == tuple(want), name
    D, F = cfg.hidden_size, cfg.ffn_dim
    layer = model.model.decoder.layers[31]
    assert tuple(layer.self_attn.q_proj.weight.shape) == (D // M, D)
    assert tuple(layer.self_attn.out_proj.weight.shape) == (D, D // M)
    assert tuple(layer.fc1.weight.shape) == (F // M, D)
    assert tuple(layer.fc2.weight.shape) == (D, F // M)
    assert shapes["model.decoder.embed_tokens.weight"] == (50272, 4096)
    assert shapes["model.decoder.embed_positions.weight"] == (2050, 4096)
    n = sum(p.numel() for p in model.parameters())
    embeddings = 50272 * 4096 + 2050 * 4096
    assert abs(n - 1.826e9) < 0.001e9 and abs((n - embeddings) - 1.611e9) < 0.001e9
    assert abs(2 * n / 1e9 - 3.65) < 0.01


def test_opt_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="must divide"):
        opt_lm.OPTModel(opt_lm.OPTConfig.tiny(), device="meta", model_parallel=3)
