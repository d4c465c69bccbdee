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
What differs from the JAX module: ``device`` (None = the CUDA card) in place
of ``mesh`` (tensor parallelism belongs to the port's ``parallel/`` work),
and the padded length is the longest hypothesis, not a multiple of 32 (a
bucket for XLA's compile cache; causal attention makes the scores the same).
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


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def forward(params: Params, tokens: torch.Tensor, n_heads: int = 4,
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """tokens: (B, L) int → logits (B, L, vocab) float32. Causal
    self-attention, pre-LN blocks, tied input/output embedding. ``gelu`` is
    the tanh approximation (``jax.nn.gelu``'s default); scores are divided
    by √hd after the product in float32 and masked with -1e30, as the JAX
    code does."""
    cd = compute_dtype
    emb = params["emb"].to(cd)
    B, L = tokens.shape
    x = F.embedding(tokens.long(), emb) + params["pos"][:L].to(cd)
    D = x.shape[-1]
    hd = D // n_heads
    causal = torch.ones((L, L), dtype=torch.bool, device=tokens.device).tril()

    for blk in params["blocks"]:
        h = _ln(x, blk["ln1_g"].to(cd), blk["ln1_b"].to(cd))
        q = (h @ blk["wq"].to(cd)).view(B, L, n_heads, hd)
        k = (h @ blk["wk"].to(cd)).view(B, L, n_heads, hd)
        v = (h @ blk["wv"].to(cd)).view(B, L, n_heads, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        att = att.masked_fill(~causal, -1e30)
        att = torch.softmax(att, dim=-1).to(cd)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)
        x = x + o @ blk["wo"].to(cd)
        h = _ln(x, blk["ln2_g"].to(cd), blk["ln2_b"].to(cd))
        h = F.gelu(h @ blk["w1"].to(cd) + blk["b1"].to(cd), approximate="tanh")
        x = x + h @ blk["w2"].to(cd) + blk["b2"].to(cd)

    x = _ln(x, params["lnf_g"].to(cd), params["lnf_b"].to(cd))
    return (x @ emb.T).float()


def encode_bytes(text: str, max_len: int) -> List[int]:
    ids = [BOS] + list(text.encode("utf-8"))
    return ids[:max_len]


class DeviceCausalLMRescorer:
    """LLMScorer over the byte-level transformer. score(texts) = Σ token
    log-probs − length_penalty · n_tokens (parity: rescore_with_gpt2,
    standalone :127-161). Runs on ``device`` (None = the CUDA card)."""

    def __init__(
        self,
        params: Optional[Params] = None,
        device: Optional[Union[str, torch.device]] = None,
        max_len: int = 256,
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        n_heads: int = 4,
        encode: Optional[Callable[[str, int], List[int]]] = None,
    ):
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, max_len=max_len, device=self.device)
        self.params = params
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
        tokens, mask = upload(tokens, self.device), upload(mask, self.device)
        with torch.inference_mode():
            logits = forward(self.params, tokens, self.n_heads, self.compute_dtype)
            lp = torch.log_softmax(logits[:, :-1], dim=-1)
            tok_lp = lp.gather(2, tokens[:, 1:, None])[..., 0] * mask[:, 1:]
            sums, n_tokens = tok_lp.sum(dim=1), mask.sum(dim=1)

        def fetch() -> List[float]:
            s = sums[:n].cpu().numpy()
            t = n_tokens[:n].cpu().numpy()
            return (s - t * np.float32(length_penalty)).tolist()

        return fetch

    def score(self, texts: Sequence[str], length_penalty: float = 0.0) -> List[float]:
        return self.score_async(texts, length_penalty)()
