"""OPT-architecture causal LM in PyTorch, and the n-best rescorer over it.

Counterpart of ``b2txt_tpu/decode/opt_lm.py``. The reference loads
facebook/opt-6.7b fp16 through HF transformers on a second GPU and rescores
n-best hypotheses with token-logprob sums (language-model-standalone.py
:92-161). This module runs the same decoder on the CUDA card:

  * learned positional embeddings with the OPT offset of 2, indexed by the
    attention-mask cumsum (so padding never advances the position counter),
  * pre-LN blocks (do_layer_norm_before=True, the 6.7b configuration) with
    ReLU MLPs and per-layer ``final_layer_norm`` between attention and MLP,
  * decoder-level final layer norm and an lm_head tied to embed_tokens.

``OPTModel``'s parameter names are HF ``OPTForCausalLM``'s state-dict names
(one parameter layout), so a reference checkpoint loads with
``load_state_dict``. ``params_from_hf`` and ``params_from_jax`` /
``params_to_jax`` move weights between HF, the JAX package and the port.

What differs from the JAX module, and why:

- The mesh is a ``DeviceMesh`` with one process per position
  (``parallel/``), not one SPMD program: ``OPTModel(model_parallel=M)``
  holds this rank's column-parallel q/k/v/fc1 rows (heads and FFN units
  M ways) and row-parallel out_proj/fc2 columns, and its forward runs an
  ``all_reduce`` over the "model" group after out_proj and fc2; their
  biases are added once, by the group's first rank inside its product, so
  a group of one computes exactly what the unsharded model computes
  (``partition_specs``; XLA inserts that reduce on the TPU).
  ``OPTRescorer(mesh=...)`` also shards its rows over "data": every rank
  scores the whole list's rows it owns and the per-segment sums (or the
  rows' sums) meet over the data group.
- Shapes are bucketed otherwise: the JAX rescorer rounds the row count to
  8, the unpacked length to 16, the segment count to 32 and the context
  length to 32 for XLA's compile cache. The port pads the packed rows and
  the segment bins to powers of two (at least 1 and 16), the keys of its
  CUDA graphs (``PackedScorer``), and runs the exact unpacked and context
  counts, which it runs op by op. The packing row width (at least 64, a
  multiple of 16) is kept: it decides which hypotheses share a row.
  Padding never changes a score, so the scores are the JAX package's
  either way (tests/test_torch_opt_lm.py).
- The score functions take the model where the JAX ones take params, and
  no ``cfg`` (the model carries it).
- Layer norms are ``F.layer_norm`` (one kernel, f32 statistics); the JAX
  code forms them from bf16 means in bf16. Attention is explicit products
  with the mask, as the JAX code has it, with the compute dtype's own
  finite minimum as the mask fill and the softmax in float32.
- ``jax.ops.segment_sum`` is a stable sort by segment id and one
  fixed-order sum per segment into float32 bins (bin 0 the discard bin,
  ``ops/segment.py``): two runs on the card give the same bits, as one XLA
  scatter does on the TPU (``index_add_``'s float atomics would not).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.cuda_graphs import GraphCache
from ..utils.device import resolve_device, upload
from .packed_scorer import (PackedScorer, _fetcher, _packed_sums, _segment_sum,  # noqa: F401
                            pack_sequences, score_packed_fn, score_tokens_fn, word_hash_encode)

POS_OFFSET = 2  # OPT's learned-position offset (OPTLearnedPositionalEmbedding)

StateDict = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 4096
    ffn_dim: int = 16384
    num_layers: int = 32
    num_heads: int = 32
    max_position_embeddings: int = 2048

    @classmethod
    def opt_6_7b(cls) -> "OPTConfig":
        return cls()  # defaults are the 6.7b shapes (README.md:101, ~13 GB fp16)

    @classmethod
    def tiny(cls, vocab: int = 97) -> "OPTConfig":
        return cls(vocab_size=vocab, hidden_size=32, ffn_dim=64,
                   num_layers=2, num_heads=4, max_position_embeddings=64)

    @property
    def n_params(self) -> int:
        """Parameters of the model (the tied lm_head counted once)."""
        return sum(int(np.prod(shape)) for shape in param_shapes(self).values())


def param_shapes(cfg: OPTConfig) -> Dict[str, tuple]:
    """Every parameter's name (HF's) and shape, lm_head excluded (tied)."""
    D, F_ = cfg.hidden_size, cfg.ffn_dim
    shapes = {"model.decoder.embed_tokens.weight": (cfg.vocab_size, D),
              "model.decoder.embed_positions.weight":
                  (cfg.max_position_embeddings + POS_OFFSET, D)}
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            shapes[p + f"self_attn.{proj}.weight"] = (D, D)
            shapes[p + f"self_attn.{proj}.bias"] = (D,)
        shapes[p + "self_attn_layer_norm.weight"] = (D,)
        shapes[p + "self_attn_layer_norm.bias"] = (D,)
        shapes[p + "fc1.weight"] = (F_, D)
        shapes[p + "fc1.bias"] = (F_,)
        shapes[p + "fc2.weight"] = (D, F_)
        shapes[p + "fc2.bias"] = (D,)
        shapes[p + "final_layer_norm.weight"] = (D,)
        shapes[p + "final_layer_norm.bias"] = (D,)
    shapes["model.decoder.final_layer_norm.weight"] = (D,)
    shapes["model.decoder.final_layer_norm.bias"] = (D,)
    return shapes


def partition_specs(cfg: OPTConfig) -> Dict[str, Optional[int]]:
    """Tensor-parallel layout over the "model" axis, by HF name: the
    dimension each tensor splits along, or None (replicated). q/k/v and fc1
    are column-parallel (their (out, in) weights and biases split on dim 0:
    heads and FFN units); out_proj and fc2 are row-parallel (weights split
    on dim 1, an all_reduce follows, and their biases are added once, by
    the group's first rank before it); embeddings and norms replicate.
    JAX's P(None, "model") on its (in, out) weights is the same split."""
    specs: Dict[str, Optional[int]] = {name: None for name in param_shapes(cfg)}
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        for col in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "fc1"):
            specs[p + col + ".weight"] = specs[p + col + ".bias"] = 0
        for row in ("self_attn.out_proj", "fc2"):
            specs[p + row + ".weight"] = 1
    return specs


class _Attention(nn.Module):
    def __init__(self, d: int, device, dtype, m: int):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.k_proj = nn.Linear(d, d // m, **kw)
        self.v_proj = nn.Linear(d, d // m, **kw)
        self.q_proj = nn.Linear(d, d // m, **kw)
        self.out_proj = nn.Linear(d // m, d, **kw)


class _Layer(nn.Module):
    def __init__(self, cfg: OPTConfig, device, dtype, m: int):
        super().__init__()
        D, kw = cfg.hidden_size, dict(device=device, dtype=dtype)
        self.self_attn = _Attention(D, device, dtype, m)
        self.self_attn_layer_norm = nn.LayerNorm(D, **kw)
        self.fc1 = nn.Linear(D, cfg.ffn_dim // m, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim // m, D, **kw)
        self.final_layer_norm = nn.LayerNorm(D, **kw)


class _Decoder(nn.Module):
    def __init__(self, cfg: OPTConfig, device, dtype, m: int):
        super().__init__()
        D, kw = cfg.hidden_size, dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D, **kw)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + POS_OFFSET, D, **kw)
        self.layers = nn.ModuleList(_Layer(cfg, device, dtype, m)
                                    for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(D, **kw)


class _Body(nn.Module):
    def __init__(self, cfg: OPTConfig, device, dtype, m: int):
        super().__init__()
        self.decoder = _Decoder(cfg, device, dtype, m)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def _ln(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], _cast(norm.weight, dtype), _cast(norm.bias, dtype),
                        eps=1e-5)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, _cast(lin.weight, dtype), _cast(lin.bias, dtype))


class OPTModel(nn.Module):
    """OPT decoder with HF ``OPTForCausalLM``'s parameter names. Load its
    weights from a state dict (``init_params``, ``params_from_hf``,
    ``params_from_jax``), or build one around existing tensors with
    :meth:`from_state_dict`. ``lm_head.weight`` is
    ``model.decoder.embed_tokens.weight`` (tied, as in OPT).

    ``model_parallel=M`` builds this rank's shard of the tensor-parallel
    model (``partition_specs``): 1/M of the heads and FFN units. Its
    forward all-reduces over ``tp_group``, the mesh's "model" group, which
    :meth:`from_state_dict` sets from a mesh."""

    def __init__(self, cfg: OPTConfig, device=None, dtype: torch.dtype = torch.float32,
                 model_parallel: int = 1):
        super().__init__()
        device = resolve_device(device)
        if cfg.num_heads % model_parallel or cfg.ffn_dim % model_parallel:
            raise ValueError(f"{cfg.num_heads} heads and {cfg.ffn_dim} FFN units must divide "
                             f"by model={model_parallel}")
        self.cfg = cfg
        self.model_parallel = model_parallel
        self.tp_group = None
        self.tp_rank = 0
        self.model = _Body(cfg, device, dtype, model_parallel)
        self.lm_head = nn.Module()
        self.tie_weights()

    def tie_weights(self) -> None:
        self.lm_head.weight = self.model.decoder.embed_tokens.weight

    @classmethod
    def from_state_dict(cls, cfg: OPTConfig, state_dict: StateDict, device=None,
                        mesh=None) -> "OPTModel":
        """The model around ``state_dict``'s tensors, moved to ``device``
        (None = the CUDA card) in their own dtype, without a second copy.
        With a ("data", "model") ``mesh``: this rank's tensor-parallel shard
        of the full ``state_dict``, all-reducing over the "model" group."""
        device = resolve_device(device)
        sd = {k: v for k, v in state_dict.items() if k != "lm_head.weight"}
        M = 1
        if mesh is not None:
            from ..parallel.mesh import shard_tensors

            M = mesh["model"].size()
            sd = shard_tensors(sd, partition_specs(cfg), mesh)
        model = cls(cfg, device="meta", model_parallel=M)
        if mesh is not None:
            model.tp_group = mesh.get_group("model")
            model.tp_rank = mesh.get_local_rank("model")
        sd = {k: v.to(device) for k, v in sd.items()}
        sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
        model.load_state_dict(sd, assign=True)
        model.tie_weights()
        return model

    def forward(
        self,
        tokens: torch.Tensor,                   # (B, L) int
        attention_mask: torch.Tensor,           # (B, L) 1.0 = real token
        compute_dtype: torch.dtype = torch.float32,
        positions: Optional[torch.Tensor] = None,    # (B, L) within-sequence
        segment_ids: Optional[torch.Tensor] = None,  # (B, L), 0 = padding
        prefix_kv: Optional[List] = None,            # per-layer (k, v) (1, C, H, hd)
        prefix_mask: Optional[torch.Tensor] = None,  # (1, C) 1.0 = real prefix token
        return_kv: bool = False,
    ):
        """Logits (B, L, vocab), float32. Matches
        transformers.OPTForCausalLM with do_layer_norm_before=True and a tied
        lm_head (tests/test_torch_opt_lm.py).

        With ``segment_ids``, each row may pack several independent
        sequences: attention is block-diagonal × causal and ``positions``
        gives each token's 0-based index within its segment. ``prefix_kv``
        cross-attends every query to a cached context's keys and values
        (positions must then be offset by the prefix length by the caller);
        ``return_kv`` collects that cache."""
        cfg = self.cfg
        dec = self.model.decoder
        B, L = tokens.shape
        D = cfg.hidden_size
        hd = D // cfg.num_heads
        H = cfg.num_heads // self.model_parallel   # this rank's heads
        dev = tokens.device
        emb = _cast(dec.embed_tokens.weight, compute_dtype)
        if positions is None:
            # OPT position ids: cumsum of the attention mask (padding holds
            # position)
            positions = (torch.cumsum(attention_mask, 1) * attention_mask).to(torch.int64) - 1
        pos = positions.long().clamp(-1, cfg.max_position_embeddings - 1) + POS_OFFSET
        x = F.embedding(tokens.long(), emb) + F.embedding(
            pos, _cast(dec.embed_positions.weight, compute_dtype))

        causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
        mask = causal[None, None] & (attention_mask[:, None, None, :] > 0.5)   # (B,1,L,L)
        if segment_ids is not None:
            mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        if prefix_kv is not None:
            # every query may attend to every REAL prefix position (the prefix
            # is wholly earlier in the causal order)
            C = prefix_kv[0][0].shape[1]
            if prefix_mask is None:
                pm = torch.ones((1, 1, 1, C), dtype=torch.bool, device=dev)
            else:
                pm = (prefix_mask > 0.5)[:, None, None, :]
            mask = torch.cat([pm.expand(B, 1, L, C), mask], dim=-1)
        # the compute dtype's OWN finite min: f32's min cast to bf16 rounds to
        # -inf, and a fully masked padding-query row would then softmax to
        # NaN, which 0-weight × NaN spreads into real positions through the
        # next layer's values
        neg = torch.finfo(compute_dtype).min

        kv_cache: List = []
        for li, layer in enumerate(dec.layers):
            attn = layer.self_attn
            h = _ln(x, layer.self_attn_layer_norm, compute_dtype)
            q = (_linear(h, attn.q_proj, compute_dtype) * (hd ** -0.5)).view(B, L, H, hd)
            k = _linear(h, attn.k_proj, compute_dtype).view(B, L, H, hd)
            v = _linear(h, attn.v_proj, compute_dtype).view(B, L, H, hd)
            if return_kv:
                kv_cache.append((k, v))
            if prefix_kv is not None:
                kp, vp = prefix_kv[li]
                k = torch.cat([_cast(kp, compute_dtype).expand((B,) + kp.shape[1:]), k], dim=1)
                v = torch.cat([_cast(vp, compute_dtype).expand((B,) + vp.shape[1:]), v], dim=1)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k).masked_fill(~mask, neg)
            att = torch.softmax(att.float(), dim=-1).to(compute_dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, H * hd)
            x = x + self._row_parallel(o, attn.out_proj, compute_dtype)

            h = _ln(x, layer.final_layer_norm, compute_dtype)
            h = torch.relu(_linear(h, layer.fc1, compute_dtype))
            x = x + self._row_parallel(h, layer.fc2, compute_dtype)

        x = _ln(x, dec.final_layer_norm, compute_dtype)
        logits = (x @ emb.T).float()
        if return_kv:
            return logits, kv_cache
        return logits

    def _row_parallel(self, h: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
        """out_proj / fc2: this rank's partial product summed over the
        "model" group. The first rank of the group adds the bias inside its
        product, so the bias counts once and a group of one runs exactly the
        unsharded ``_linear``: adding the bias after a bias-free product
        takes another cuBLAS kernel, whose bf16 sums round differently."""
        if self.tp_group is None:
            return _linear(h, lin, dtype)
        import torch.distributed as dist

        y = _linear(h, lin, dtype) if self.tp_rank == 0 else F.linear(h, _cast(lin.weight, dtype))
        dist.all_reduce(y, group=self.tp_group)
        return y


def init_params(cfg: OPTConfig, device=None, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> StateDict:
    """N(0, 0.02) weights and biases 0, norms (1, 0), as the JAX package's
    ``init_params``, drawn on ``device`` (None = the CUDA card) in ``dtype``
    with ``generator`` (a generator of that device). At 6.7b in bf16 that is
    13.3 GB made on the card; nothing crosses from the host."""
    device = resolve_device(device)
    sd = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("layer_norm.weight"):
            sd[name] = torch.ones(shape, device=device, dtype=dtype)
        elif name.endswith(".bias"):
            sd[name] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            sd[name] = torch.randn(shape, generator=generator, device=device,
                                   dtype=dtype).mul_(0.02)
    sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def params_from_hf(state_dict: Dict[str, Any]) -> StateDict:
    """An HF ``OPTForCausalLM`` state dict (torch tensors or numpy arrays)
    as the port's: float32 tensors on the CPU, names and (out, in) layout
    unchanged, ``lm_head.weight`` tied to ``embed_tokens``."""
    def f32(v):
        if torch.is_tensor(v):
            return v.detach().to("cpu", torch.float32)
        return torch.from_numpy(np.asarray(v, np.float32))

    sd = {k: f32(v) for k, v in state_dict.items() if k != "lm_head.weight"}
    sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


_JAX_LINEAR = {"q_w": "self_attn.q_proj", "k_w": "self_attn.k_proj",
               "v_w": "self_attn.v_proj", "o_w": "self_attn.out_proj",
               "fc1_w": "fc1", "fc2_w": "fc2"}
_JAX_NORM = {"ln_attn": "self_attn_layer_norm", "ln_mlp": "final_layer_norm"}


def params_from_jax(tree: Dict[str, Any], device=None) -> StateDict:
    """The JAX package's params pytree (numpy or JAX arrays; Linear weights
    (in, out)) as the port's state dict on ``device`` (None = the card),
    weights transposed back to (out, in), in the tree's own dtype."""
    device = resolve_device(device)

    def t(a, transpose=False):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a.T if transpose else a)).to(device)

    sd = {"model.decoder.embed_tokens.weight": t(tree["embed_tokens"]),
          "model.decoder.embed_positions.weight": t(tree["embed_positions"])}
    for i, blk in enumerate(tree["layers"]):
        p = f"model.decoder.layers.{i}."
        for key, name in _JAX_LINEAR.items():
            sd[p + name + ".weight"] = t(blk[key], transpose=True)
            sd[p + name + ".bias"] = t(blk[key[:-1] + "b"])
        for key, name in _JAX_NORM.items():
            sd[p + name + ".weight"] = t(blk[key]["g"])
            sd[p + name + ".bias"] = t(blk[key]["b"])
    sd["model.decoder.final_layer_norm.weight"] = t(tree["ln_f"]["g"])
    sd["model.decoder.final_layer_norm.bias"] = t(tree["ln_f"]["b"])
    sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def params_to_jax(state_dict: StateDict, cfg: OPTConfig) -> Dict[str, Any]:
    """The port's state dict as the JAX package's params pytree of float32
    numpy arrays (Linear weights transposed to (in, out))."""
    def a(name, transpose=False):
        x = state_dict[name].detach().float().cpu().numpy()
        return np.ascontiguousarray(x.T if transpose else x)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        blk = {}
        for key, name in _JAX_LINEAR.items():
            blk[key] = a(p + name + ".weight", transpose=True)
            blk[key[:-1] + "b"] = a(p + name + ".bias")
        for key, name in _JAX_NORM.items():
            blk[key] = {"g": a(p + name + ".weight"), "b": a(p + name + ".bias")}
        layers.append(blk)
    return {"embed_tokens": a("model.decoder.embed_tokens.weight"),
            "embed_positions": a("model.decoder.embed_positions.weight"),
            "layers": layers,
            "ln_f": {"g": a("model.decoder.final_layer_norm.weight"),
                     "b": a("model.decoder.final_layer_norm.bias")}}


def score_prefix_packed_fn(n_segments: int, compute_dtype: torch.dtype = torch.float32,
                           meet: Optional[Callable] = None):
    """Shared-context variant of :func:`score_packed_fn` (the reference's
    conversational rescoring, standalone :165-199): every candidate is
    scored as context+hypothesis, but the context forward runs ONCE and the
    packed hypothesis rows cross-attend its cached K/V.

    Sums include the context's own token log-probs and the cross-boundary
    P(first hyp token | context); counts include the context tokens.
    ``positions`` are 0-based WITHIN each hypothesis; the prefix offset is
    added here. ``n_ctx`` is the context's real length (a host int).
    ``meet`` (sums, cnt) → (sums, cnt) combines the rows' segment sums
    across ranks before the shared constants are added once."""

    def score(model: OPTModel, ctx, n_ctx: int, tokens, segment_ids, positions):
        Cb = ctx.shape[1]
        dev = ctx.device
        ctx_mask = (torch.arange(Cb, device=dev) < n_ctx)[None, :].float()
        ctx_logits, kv = model(ctx, ctx_mask, compute_dtype, return_kv=True)
        clp = torch.log_softmax(ctx_logits, dim=-1)                # (1, Cb, V)
        # context self-score: P(ctx[j] | ctx[<j]) for j = 1..n_ctx-1
        pair_lp = clp[0, :-1].gather(1, ctx[0, 1:, None].long())[:, 0]
        ctx_sum = (pair_lp * (torch.arange(Cb - 1, device=dev) < n_ctx - 1)).sum()
        last_row = clp[0, n_ctx - 1]                                # (V,)

        mask = (segment_ids > 0).float()
        logits = model(tokens, mask, compute_dtype, positions=positions + n_ctx,
                       segment_ids=segment_ids, prefix_kv=kv, prefix_mask=ctx_mask)
        sums = _packed_sums(logits, tokens, segment_ids, n_segments)
        # each hypothesis' FIRST token is scored from the context's last row
        first = (segment_ids > 0) & (positions == 0)
        first_lp = last_row[tokens.long()] * first
        sums = sums + _segment_sum(first_lp, torch.where(first, segment_ids, 0), n_segments)
        cnt = _segment_sum(mask, segment_ids, n_segments)
        if meet is not None:
            sums, cnt = meet(sums, cnt)
        # context log-prob and token count are shared constants — included
        # so totals equal concatenated context+hypothesis scoring exactly
        return sums + ctx_sum, cnt + n_ctx

    return score


class OPTRescorer(PackedScorer):
    """LLMScorer over the OPT forward (``PackedScorer`` with OPT's mesh and
    shared-context path). score(texts) = Σ token log-probs −
    length_penalty · n_tokens (parity: rescore_with_gpt2, standalone
    :127-161). ``encode`` maps text → token ids — the reference uses the HF
    GPT2-BPE tokenizer (standalone :115-123); pass a
    ``b2txt_tpu_torch.utils.bpe.ByteBPE`` (``ByteBPE.for_opt(vocab,
    merges)``) or any (text, max_len) → ids callable. Without one, a
    byte-mod-vocab stand-in is used FOR TESTS ONLY and a loud warning is
    emitted. ``params`` is a state dict in the port's layout
    (``init_params``, ``params_from_hf``, ``params_from_jax``); without it the
    weights are drawn from ``seed``. Runs on ``device`` (None = the CUDA
    card). Its spans are ``opt.dispatch`` and ``opt.fetch``.

    ``mesh`` (a ("data", "model") ``DeviceMesh``, one process per position,
    every rank scoring the same texts): the model is tensor-parallel over
    "model" (``partition_specs``; the heads must divide by it) and the rows
    (packed or not) shard over "data", padded to a multiple of its size.
    Packed segment sums meet in an all_reduce over the data group, row sums
    in an all-gather; a context stays whole on every rank. Every rank
    returns every score.

    The packed rows are padded to a power of two (at least 1: OPT is dense,
    so a padded row costs real GEMM rows) and the segment bins to one (at
    least 16). Without a mesh, on the card, each shape's packed forward is
    captured once as a CUDA graph (~22 kernels a layer, ~727 launch calls
    eagerly at 32 layers) and replayed (``PackedScorer``); its captures count
    as ``opt.graph_captures``. The mesh's forward all-reduces inside its
    layers, and runs op by op, as do the prefix-KV context path, the
    unpacked rows and the CPU."""

    span_name = "opt"
    GRAPH_CACHE = 16  # captured shapes kept, the least recently used dropped

    def __init__(
        self,
        cfg: OPTConfig,
        params: Optional[StateDict] = None,
        encode: Optional[Callable[[str, int], List[int]]] = None,
        device: Optional[Union[str, torch.device]] = None,
        max_len: int = 256,
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        pack: bool = True,
        encode_cont: Optional[Callable[[str, int], List[int]]] = None,
        mesh=None,
    ):
        if mesh is None:
            device = resolve_device(device)
        else:
            from ..parallel.mesh import mesh_device

            device = mesh_device(device)
        self.mesh = mesh
        self.cfg = cfg
        if mesh is None:
            # the forward's kernels are cuBLAS's and PyTorch's: a counter of
            # its own stands for GraphCache's kernel
            self._graphs = GraphCache(self.GRAPH_CACHE, SimpleNamespace(launches=0),
                                      "opt.graph_captures")
        if encode is None:
            logging.getLogger("b2txt_tpu_torch.opt").warning(
                "OPTRescorer: no tokenizer supplied — falling back to a "
                "byte-mod-vocab stand-in. Scores are MEANINGLESS with real "
                "OPT weights; pass encode=ByteBPE.for_opt(vocab.json, "
                "merges.txt) (utils/bpe.py) for the reference's GPT2-BPE "
                "behavior (standalone :115-123)."
            )
            encode = (
                lambda t, n: [b % cfg.vocab_size for b in t.encode("utf-8")][:n]
            )
            if encode_cont is None:
                # the stand-in is byte-wise with no BOS: continuation encode
                # is the same map
                encode_cont = encode
        if encode_cont is None and hasattr(encode, "encode"):
            # ByteBPE-style tokenizer: continuation = no BOS. GPT-2's
            # pretokenizer splits at spaces (the space belongs to the next
            # chunk), so encode(ctx) + encode(" "+hyp, no BOS) equals
            # encode(ctx+" "+hyp) — tested in tests/test_bpe.py
            encode_cont = lambda t, n: encode.encode(t, add_bos=False)[:n]  # noqa: E731
        self.encode_cont = encode_cont
        # llm_rescore passes context separately to scorers advertising this
        # (the prefix-KV path scores it once instead of per candidate)
        self.supports_context = True
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(cfg, device, torch.float32, gen)
        super().__init__(OPTModel.from_state_dict(cfg, params, device, mesh=mesh), encode,
                         device, min(max_len, cfg.max_position_embeddings), compute_dtype, pack)
        self.prefix_runs = 0   # context scorings that took the prefix-KV path

    def _my_rows(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """With a mesh: this rank's block of the rows (``data_rows``)."""
        if self.mesh is None:
            return list(arrays)
        from ..parallel.mesh import data_rows

        return data_rows(self.mesh, *arrays)

    def _meet(self, sums: torch.Tensor, cnt: torch.Tensor):
        """Per-segment sums of every data rank's rows, summed (a segment
        lies in one row: the other ranks add zeros)."""
        if self.mesh is None:
            return sums, cnt
        import torch.distributed as dist

        both = torch.stack([sums, cnt])
        dist.all_reduce(both, group=self.mesh.get_group("data"))
        return both[0], both[1]

    def _gather(self, sums: torch.Tensor, cnt: torch.Tensor):
        """Per-row sums of every data rank's rows, in row order."""
        if self.mesh is None:
            return sums, cnt
        from ..parallel.comm import gather_shards

        both = gather_shards(torch.stack([sums, cnt]), 1, self.mesh.get_group("data"))
        return both[0], both[1]

    def _context_begin(self, context: str, texts: Sequence[str],
                       length_penalty: float) -> Optional[Callable[[], List[float]]]:
        """The prefix-KV path (the context's forward runs once) where the
        rows are packed and continuations can be encoded; else None
        (concatenation, identical totals)."""
        if self.pack and self.encode_cont is not None:
            return self._score_prefix_begin(context, texts, length_penalty)
        return None

    def _score_prefix_begin(
        self, context: str, texts: Sequence[str], length_penalty: float
    ) -> Callable[[], List[float]]:
        """Shared-context scoring: tokenize the context once (with BOS), the
        hypotheses as continuations (leading space, no BOS — a GPT-2
        pretoken boundary, so the ids equal the concatenated encode), run
        the context forward once and cross-attend the packed hypotheses to
        its cached K/V (score_prefix_packed_fn)."""
        ctx_ids = self.encode(context, self.max_len)
        if not ctx_ids:  # unreachable via llm_rescore (it checks .split())
            ids = [self.encode(t, self.max_len) for t in texts]
            return self._score_packed_begin(ids, length_penalty)
        ids = [self.encode_cont(" " + t, self.max_len) for t in texts]
        longest = max((len(s) for s in ids), default=1)
        if len(ctx_ids) + longest > self.max_len:
            # the concatenated path truncates ctx+hyp at max_len; score the
            # same truncations so the exact-parity contract holds (and
            # positions never clip past max_position_embeddings)
            ids = [self.encode(context + " " + t, self.max_len) for t in texts]
            return self._score_packed_begin(ids, length_penalty)
        tokens, seg, pos, n_segments = self._pack_arrays(ids)
        up = lambda a: upload(a, self.device)  # noqa: E731
        meet = self._meet if self.mesh is not None else None
        with torch.inference_mode():
            sums, cnt = score_prefix_packed_fn(n_segments, self.compute_dtype, meet)(
                self.model, up(np.asarray([ctx_ids], np.int64)), len(ctx_ids),
                *map(up, self._my_rows(tokens, seg, pos)))
        self.prefix_runs += 1
        return _fetcher(sums, cnt, 1, len(ids), length_penalty, "opt.fetch")
