"""Byte-level causal-LM rescorer on the device: a small decoder-only
transformer behind the LLMScorer protocol.

Counterpart of ``b2txt_tpu/decode/jax_lm.py``. The reference rescores
n-best hypotheses with OPT-6.7b through HF transformers on a second GPU
(language-model-standalone.py:92-161); this byte-level model is the
self-contained stand-in whose score() follows the reference's
token-logprob-sum − length_penalty·n_tokens formula (:127-161). Byte-level
tokenization (vocab 256 + BOS) needs no external files and handles any
hypothesis text; pass a custom ``encode`` for larger vocabularies.

The parameters are the JAX package's pytree with tensors for arrays
(Linear weights (in, out)), so ``params_from_jax`` is a conversion of leaves.
What differs from the JAX module: ``device`` (None = the CUDA card) beside
``mesh``, which is a ``DeviceMesh`` with one process per position: the
rescorer shards the heads and the MLP hidden dimension over "model"
(``param_partition_specs``), with an ``all_reduce`` over the "model" group
after the attention output and the MLP (the sums XLA inserts), and the rows
over "data" (an all-gather of the row sums); and the padded length is the
longest hypothesis, not a multiple of 32 (a bucket for XLA's compile cache;
causal attention makes the scores the same).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device, upload

Params = Dict[str, Any]

BOS = 256
VOCAB = 257


def init_params(
    generator: Optional[torch.Generator] = None,
    vocab: int = VOCAB,
    d_model: int = 64,
    n_layers: int = 2,
    d_ff: int = 256,
    max_len: int = 256,
    device=None,
) -> Params:
    """N(0, 0.02) weights, zero biases, unit norms, drawn on ``device``
    (None = the CUDA card) with ``generator``."""
    device = resolve_device(device)
    s = 0.02

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device) * s

    def ones(n):
        return torch.ones(n, device=device)

    def zeros(n):
        return torch.zeros(n, device=device)

    blocks = [{
        "ln1_g": ones(d_model), "ln1_b": zeros(d_model),
        "wq": normal(d_model, d_model), "wk": normal(d_model, d_model),
        "wv": normal(d_model, d_model), "wo": normal(d_model, d_model),
        "ln2_g": ones(d_model), "ln2_b": zeros(d_model),
        "w1": normal(d_model, d_ff), "b1": zeros(d_ff),
        "w2": normal(d_ff, d_model), "b2": zeros(d_model),
    } for _ in range(n_layers)]
    return {"emb": normal(vocab, d_model), "pos": normal(max_len, d_model),
            "blocks": blocks, "lnf_g": ones(d_model), "lnf_b": zeros(d_model)}


def params_from_jax(tree: Params, device=None) -> Params:
    """The JAX package's params pytree (numpy or JAX arrays) as tensors on
    ``device`` (None = the card), in the same layout and dtype."""
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a)).to(device)

    return {"emb": leaf(tree["emb"]), "pos": leaf(tree["pos"]),
            "blocks": [{k: leaf(v) for k, v in blk.items()} for blk in tree["blocks"]],
            "lnf_g": leaf(tree["lnf_g"]), "lnf_b": leaf(tree["lnf_b"])}


def param_partition_specs(params: Params) -> Params:
    """Tensor-parallel layout (the params' tree, each leaf the dimension it
    splits along over "model", or None): q/k/v and the MLP's first layer
    split their output columns (dim 1 of the (in, out) weights, b1's dim
    0), the attention output and the MLP's second layer their input rows;
    embeddings, norms and b2 replicate."""
    block = {"ln1_g": None, "ln1_b": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
             "ln2_g": None, "ln2_b": None, "w1": 1, "b1": 0, "w2": 0, "b2": None}
    return {"emb": None, "pos": None, "blocks": [dict(block) for _ in params["blocks"]],
            "lnf_g": None, "lnf_b": None}


def shard_params(params: Params, mesh) -> Params:
    """This rank's slice of every leaf over the mesh's "model" axis."""
    from ..parallel.mesh import shard_tensors

    specs = param_partition_specs(params)

    def flat(tree):
        return {k: v for k, v in tree.items() if k != "blocks"}

    return {**shard_tensors(flat(params), flat(specs), mesh),
            "blocks": [shard_tensors(blk, bspec, mesh)
                       for blk, bspec in zip(params["blocks"], specs["blocks"])]}


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def forward(params: Params, tokens: torch.Tensor, n_heads: int = 4,
            compute_dtype: torch.dtype = torch.float32, group=None) -> torch.Tensor:
    """tokens: (B, L) int → logits (B, L, vocab) float32. Causal
    self-attention, pre-LN blocks, tied input/output embedding. ``gelu`` is
    the tanh approximation (``jax.nn.gelu``'s default); scores are divided
    by √hd after the product in float32 and masked with -1e30, as the JAX
    code does. With ``group`` (the "model" group), ``params`` are this
    rank's tensor-parallel shard (``shard_params``): n_heads / M heads, and
    the two row-parallel products are summed over the group."""
    cd = compute_dtype
    emb = params["emb"].to(cd)
    B, L = tokens.shape
    x = F.embedding(tokens.long(), emb) + params["pos"][:L].to(cd)
    D = x.shape[-1]
    hd = D // n_heads
    causal = torch.ones((L, L), dtype=torch.bool, device=tokens.device).tril()

    def summed(y):
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(y, group=group)
        return y

    for blk in params["blocks"]:
        h = _ln(x, blk["ln1_g"].to(cd), blk["ln1_b"].to(cd))
        q = (h @ blk["wq"].to(cd)).view(B, L, -1, hd)
        k = (h @ blk["wk"].to(cd)).view(B, L, -1, hd)
        v = (h @ blk["wv"].to(cd)).view(B, L, -1, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        att = att.masked_fill(~causal, -1e30)
        att = torch.softmax(att, dim=-1).to(cd)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, -1)
        x = x + summed(o @ blk["wo"].to(cd))
        h = _ln(x, blk["ln2_g"].to(cd), blk["ln2_b"].to(cd))
        h = F.gelu(h @ blk["w1"].to(cd) + blk["b1"].to(cd), approximate="tanh")
        x = x + summed(h @ blk["w2"].to(cd)) + blk["b2"].to(cd)

    x = _ln(x, params["lnf_g"].to(cd), params["lnf_b"].to(cd))
    return (x @ emb.T).float()


def encode_bytes(text: str, max_len: int) -> List[int]:
    ids = [BOS] + list(text.encode("utf-8"))
    return ids[:max_len]


class DeviceCausalLMRescorer:
    """LLMScorer over the byte-level transformer. score(texts) = Σ token
    log-probs − length_penalty · n_tokens (parity: rescore_with_gpt2,
    standalone :127-161). Runs on ``device`` (None = the CUDA card).

    ``mesh`` (a ("data", "model") ``DeviceMesh``, one process per position,
    every rank scoring the same texts): the transformer is tensor-parallel
    over "model" and the rows shard over "data" (padded to a multiple of
    its size); every rank returns every score."""

    def __init__(
        self,
        params: Optional[Params] = None,
        device: Optional[Union[str, torch.device]] = None,
        max_len: int = 256,
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        n_heads: int = 4,
        encode: Optional[Callable[[str, int], List[int]]] = None,
        mesh=None,
    ):
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from ..parallel.mesh import mesh_device

            self.device = mesh_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, max_len=max_len, device=self.device)
        self.mesh = mesh
        self.params = params if mesh is None else shard_params(params, mesh)
        if n_heads % (1 if mesh is None else mesh["model"].size()):
            raise ValueError(f"{n_heads} heads do not divide by model={mesh['model'].size()}")
        self.n_heads = n_heads
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.encode = encode or encode_bytes

    def score_async(
        self, texts: Sequence[str], length_penalty: float = 0.0
    ) -> Callable[[], List[float]]:
        """Enqueue the forward now; the returned thunk fetches — the service
        pipelines finalize through this (decode/rescore.py
        llm_rescore_async)."""
        n = len(texts)
        ids = [self.encode(t, self.max_len) for t in texts]
        L = min(self.max_len, max(1, max((len(i) for i in ids), default=1)))
        tokens = np.zeros((max(n, 1), L), np.int64)
        mask = np.zeros((max(n, 1), L), np.float32)
        for i, seq in enumerate(ids):
            tokens[i, : len(seq)] = seq[:L]
            mask[i, : len(seq)] = 1.0
        group = None
        if self.mesh is not None:
            from ..parallel.mesh import data_rows

            tokens, mask = data_rows(self.mesh, tokens, mask)
            group = self.mesh.get_group("model")
        tokens, mask = upload(tokens, self.device), upload(mask, self.device)
        with torch.inference_mode():
            logits = forward(self.params, tokens, self.n_heads, self.compute_dtype, group)
            lp = torch.log_softmax(logits[:, :-1], dim=-1)
            tok_lp = lp.gather(2, tokens[:, 1:, None])[..., 0] * mask[:, 1:]
            sums, n_tokens = tok_lp.sum(dim=1), mask.sum(dim=1)
            if self.mesh is not None:
                from ..parallel.comm import gather_shards

                sums, n_tokens = gather_shards(torch.stack([sums, n_tokens]), 1,
                                               self.mesh.get_group("data"))

        def fetch() -> List[float]:
            s = sums[:n].cpu().numpy()
            t = n_tokens[:n].cpu().numpy()
            return (s - t * np.float32(length_penalty)).tolist()

        return fetch

    def score(self, texts: Sequence[str], length_penalty: float = 0.0) -> List[float]:
        return self.score_async(texts, length_penalty)()
