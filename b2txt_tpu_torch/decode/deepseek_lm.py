"""DeepSeek-V2 causal LM in PyTorch, and the n-best rescorer over it.

The port's second LLM for the rescorer's slot, beside OPT: latent
attention and routed experts, as in DeepSeek-V2 (arXiv:2405.04434) and the
model's public ``modeling_deepseek.py``, with ``q_lora_rank`` null (the
Lite model). The benchmark's ``reference/deepseek_v2.py`` holds the same
equations in plain float32; the tests hold this module to it.

* x = embed(tokens); per layer x += MLA(RMSNorm(x)), x += FFN(RMSNorm(x));
  logits = lm_head(RMSNorm(x)), an untied head.
* MLA: q = W_q h, 16 heads of (128 nope + 64 rope); [c_kv; k_pe] = W_kva h
  (512 + 64), c_kv RMS-normed; [k_nope; v] = W_kvb c_kv, 16 heads of (128 +
  128); every head shares k_pe. YaRN RoPE on q_pe and k_pe after
  ``apply_rotary_pos_emb``'s reorder; softmax scale 192^-1/2 · mscale^2.
* FFN: layer 0 a dense SwiGLU (10,944); the others MoE: the router in
  float32 over 64 experts, softmax, a greedy top-6, weights not
  renormalized, plus 2 shared experts as one SwiGLU of 2,816. Every token
  is routed (no capacity, none dropped); the experts' product is
  ``ops/moe.py``'s grouped kernel (K5) on the card, with no host sync.

``DeepseekV2Model.forward`` keeps ``OPTModel.forward``'s packed contract
(block-diagonal causal attention over ``segment_ids``, ``positions``
within each segment), so ``DeepseekV2Rescorer`` is the shared
``PackedScorer``. Parameter names are HF's, with each MoE layer's routed
experts stacked: ``mlp.experts.gate_up_proj.weight`` (E, 2F, D), gate rows
first, and ``mlp.experts.down_proj.weight`` (E, D, F).

Norms take float32 statistics (HF's DeepseekV2RMSNorm); RoPE runs in
float32 and is cast back; the attention's softmax is float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe import moe_experts, route
from ..utils.cuda_graphs import GraphCache
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .packed_scorer import PackedScorer, score_packed_fn

StateDict = Dict[str, torch.Tensor]


def _yarn() -> Dict:
    return {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
            "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096, "type": "yarn"}


@dataclass(frozen=True)
class DeepseekV2Config:
    """The keys of the model's config.json (deepseek-ai/DeepSeek-V2-Lite),
    its values by default. Only what the Lite model uses is implemented: no
    q LoRA, no attention bias, silu, a softmax router with a greedy top-k
    and no renormalization, every layer past the dense ones MoE, untied
    embeddings, YaRN."""

    attention_bias: bool = False
    first_k_dense_replace: int = 1
    hidden_act: str = "silu"
    hidden_size: int = 2048
    intermediate_size: int = 10944
    kv_lora_rank: int = 512
    max_position_embeddings: int = 163840
    model_type: str = "deepseek_v2"
    moe_intermediate_size: int = 1408
    moe_layer_freq: int = 1
    n_group: int = 1
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    norm_topk_prob: bool = False
    num_attention_heads: int = 16
    num_experts_per_tok: int = 6
    num_hidden_layers: int = 27
    num_key_value_heads: int = 16
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_scaling: Dict = field(default_factory=_yarn)
    rope_theta: float = 10000
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    seq_aux: bool = True
    tie_word_embeddings: bool = False
    topk_group: int = 1
    topk_method: str = "greedy"
    v_head_dim: int = 128
    vocab_size: int = 102400

    def __post_init__(self):
        want = dict(q_lora_rank=None, attention_bias=False, hidden_act="silu", moe_layer_freq=1,
                    scoring_func="softmax", topk_method="greedy", norm_topk_prob=False,
                    tie_word_embeddings=False)
        bad = {k: getattr(self, k) for k, v in want.items() if getattr(self, k) != v}
        if self.rope_scaling.get("type") != "yarn":
            bad["rope_scaling"] = self.rope_scaling
        if bad:
            raise ValueError(f"DeepseekV2Config: not implemented: {bad}")

    @classmethod
    def deepseek_v2_lite(cls) -> "DeepseekV2Config":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 97) -> "DeepseekV2Config":
        """Hidden 64, 3 layers (the first dense), 8 experts top-3, 1 shared,
        kv rank 32: the CPU tests' size."""
        return cls(hidden_size=64, intermediate_size=96, kv_lora_rank=32,
                   max_position_embeddings=256, moe_intermediate_size=32, n_routed_experts=8,
                   n_shared_experts=1, num_attention_heads=4, num_experts_per_tok=3,
                   num_hidden_layers=3, num_key_value_heads=4, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16, vocab_size=vocab)

    @property
    def n_params(self) -> int:
        return sum(int(np.prod(s)) for s in param_shapes(self).values())


def param_shapes(cfg: DeepseekV2Config) -> Dict[str, tuple]:
    """Every parameter's name (HF's, routed experts stacked) and shape."""
    D, V, H = cfg.hidden_size, cfg.vocab_size, cfg.num_attention_heads
    dn, dr, dv, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    E, Fm, S = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.n_shared_experts
    shapes = {"model.embed_tokens.weight": (V, D)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        shapes[p + "input_layernorm.weight"] = (D,)
        shapes[p + "self_attn.q_proj.weight"] = (H * (dn + dr), D)
        shapes[p + "self_attn.kv_a_proj_with_mqa.weight"] = (R + dr, D)
        shapes[p + "self_attn.kv_a_layernorm.weight"] = (R,)
        shapes[p + "self_attn.kv_b_proj.weight"] = (H * (dn + dv), R)
        shapes[p + "self_attn.o_proj.weight"] = (D, H * dv)
        shapes[p + "post_attention_layernorm.weight"] = (D,)
        if i < cfg.first_k_dense_replace:
            I_ = cfg.intermediate_size
            shapes[p + "mlp.gate_proj.weight"] = (I_, D)
            shapes[p + "mlp.up_proj.weight"] = (I_, D)
            shapes[p + "mlp.down_proj.weight"] = (D, I_)
        else:
            shapes[p + "mlp.gate.weight"] = (E, D)
            shapes[p + "mlp.experts.gate_up_proj.weight"] = (E, 2 * Fm, D)
            shapes[p + "mlp.experts.down_proj.weight"] = (E, D, Fm)
            shapes[p + "mlp.shared_experts.gate_proj.weight"] = (S * Fm, D)
            shapes[p + "mlp.shared_experts.up_proj.weight"] = (S * Fm, D)
            shapes[p + "mlp.shared_experts.down_proj.weight"] = (D, S * Fm)
    shapes["model.norm.weight"] = (D,)
    shapes["lm_head.weight"] = (V, D)
    return shapes


def init_params(cfg: DeepseekV2Config, device=None, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None, std: float = 0.006) -> StateDict:
    """N(0, std^2) matrices and norms of 1, drawn on ``device`` (None = the
    CUDA card) in ``dtype`` with ``generator``; 0.006 is DeepSeek-V2's
    initializer_range."""
    device = resolve_device(device)
    sd = {}
    for name, shape in param_shapes(cfg).items():
        if len(shape) == 1:
            sd[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            sd[name] = torch.randn(shape, generator=generator, device=device,
                                   dtype=dtype).mul_(std)
    return sd


class _W(nn.Module):
    def __init__(self, *shape, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                   requires_grad=False)


class _SwiGLU(nn.Module):
    def __init__(self, D: int, width: int, kw):
        super().__init__()
        self.gate_proj = _W(width, D, **kw)
        self.up_proj = _W(width, D, **kw)
        self.down_proj = _W(D, width, **kw)


class _Experts(nn.Module):
    def __init__(self, E: int, D: int, Fm: int, kw):
        super().__init__()
        self.gate_up_proj = _W(E, 2 * Fm, D, **kw)
        self.down_proj = _W(E, D, Fm, **kw)


class _MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, kw):
        super().__init__()
        D, E, Fm = cfg.hidden_size, cfg.n_routed_experts, cfg.moe_intermediate_size
        self.gate = _W(E, D, **kw)
        self.experts = _Experts(E, D, Fm, kw)
        self.shared_experts = _SwiGLU(D, cfg.n_shared_experts * Fm, kw)


class _MLA(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, kw):
        super().__init__()
        D, H, R = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.q_proj = _W(H * (dn + dr), D, **kw)
        self.kv_a_proj_with_mqa = _W(R + dr, D, **kw)
        self.kv_a_layernorm = _W(R, **kw)
        self.kv_b_proj = _W(H * (dn + dv), R, **kw)
        self.o_proj = _W(D, H * dv, **kw)


class _Layer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dense: bool, kw):
        super().__init__()
        D = cfg.hidden_size
        self.input_layernorm = _W(D, **kw)
        self.self_attn = _MLA(cfg, kw)
        self.post_attention_layernorm = _W(D, **kw)
        self.mlp = _SwiGLU(D, cfg.intermediate_size, kw) if dense else _MoE(cfg, kw)


class _Body(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, kw):
        super().__init__()
        self.embed_tokens = _W(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(_Layer(cfg, i < cfg.first_k_dense_replace, kw)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = _W(cfg.hidden_size, **kw)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """HF's DeepseekV2RMSNorm: float32 statistics, the weight applied in the
    working dtype."""
    return _cast(weight, dtype) * F.rms_norm(x.float(), x.shape[-1:], eps=eps).to(dtype)


def _lin(x: torch.Tensor, w: _W, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, _cast(w.weight, dtype))


def _swiglu(x: torch.Tensor, m: _SwiGLU, dtype: torch.dtype) -> torch.Tensor:
    return _lin(F.silu(_lin(x, m.gate_proj, dtype)) * _lin(x, m.up_proj, dtype),
                m.down_proj, dtype)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_pos_emb`` in float32 on (B, L, h, d): the pairs
    reordered (view (..., d/2, 2), transpose, reshape), then rotate_half."""
    d = x.shape[-1]
    x = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1) * sin


def yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """(rope dim / 2,) float32: base^(-2i/d) blended with its value over
    ``factor`` along a linear ramp between the correction dims of
    ``beta_fast`` and ``beta_slow`` at the original length."""
    rs, d, base = cfg.rope_scaling, cfg.qk_rope_head_dim, float(cfg.rope_theta)

    def dim_of(rotations):
        n = rs["original_max_position_embeddings"]
        return d * math.log(n / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(rs["beta_fast"])), 0)
    high = min(math.ceil(dim_of(rs["beta_slow"])), d - 1)
    high = high + 0.001 if low == high else high
    extra = base ** -(torch.arange(0, d, 2, dtype=torch.float32) / d)
    ramp = ((torch.arange(d // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_mscale(cfg.rope_scaling["factor"], cfg.rope_scaling["mscale_all_dim"])
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


class DeepseekV2Model(nn.Module):
    """DeepSeek-V2 decoder with HF's parameter names (routed experts
    stacked). Build it around a state dict with :meth:`from_state_dict`."""

    def __init__(self, cfg: DeepseekV2Config, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.model = _Body(cfg, kw)
        self.lm_head = _W(cfg.vocab_size, cfg.hidden_size, **kw)
        rs = cfg.rope_scaling
        self.rope_scale = (yarn_mscale(rs["factor"], rs["mscale"])
                           / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
        self.scale = softmax_scale(cfg)
        self._inv_freq = yarn_inv_freq(cfg)
        if kw["device"].type != "meta":
            self._inv_freq = self._inv_freq.to(kw["device"])

    @classmethod
    def from_state_dict(cls, cfg: DeepseekV2Config, state_dict: StateDict,
                        device=None) -> "DeepseekV2Model":
        """The model around ``state_dict``'s tensors, moved to ``device``
        (None = the CUDA card) in their own dtype, without a second copy."""
        device = resolve_device(device)
        model = cls(cfg, device="meta")
        model.load_state_dict({k: v.to(device) for k, v in state_dict.items()}, assign=True)
        model._inv_freq = model._inv_freq.to(device)
        return model

    def forward(
        self,
        tokens: torch.Tensor,                   # (B, L) int
        attention_mask: torch.Tensor,           # (B, L) 1.0 = real token
        compute_dtype: torch.dtype = torch.float32,
        positions: Optional[torch.Tensor] = None,    # (B, L) within-sequence
        segment_ids: Optional[torch.Tensor] = None,  # (B, L), 0 = padding
        routing: Optional[List] = None,
    ) -> torch.Tensor:
        """Logits (B, L, vocab), float32. With ``segment_ids`` each row may
        pack several sequences: attention is block-diagonal × causal and
        ``positions`` counts from 0 in each. ``routing``, a list, receives
        each MoE layer's (experts (B, L, k), tokens per expert (E + 1,)) on
        the device; padding goes to expert E."""
        cfg, body, dt = self.cfg, self.model, compute_dtype
        B, L = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = ((torch.cumsum(attention_mask, 1) * attention_mask).long() - 1).clamp(min=0)
        freqs = positions.float()[..., None] * self._inv_freq
        emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
        cos, sin = emb.cos() * self.rope_scale, emb.sin() * self.rope_scale
        real = attention_mask > 0.5
        allowed = torch.ones((L, L), dtype=torch.bool, device=dev).tril()[None, None] \
            & real[:, None, None, :]
        if segment_ids is not None:
            allowed = allowed & (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        # the compute dtype's own finite minimum: a padding query with no
        # key left softmaxes to uniform, not NaN
        neg = torch.finfo(dt).min
        eps = cfg.rms_norm_eps
        x = F.embedding(tokens.long(), _cast(body.embed_tokens.weight, dt))
        for i, layer in enumerate(body.layers):
            h = _rms(x, layer.input_layernorm.weight, eps, dt)
            with span("mla.attention"):
                x = x + self._attention(layer.self_attn, h, cos, sin, allowed, neg, dt)
            h = _rms(x, layer.post_attention_layernorm.weight, eps, dt)
            if i < cfg.first_k_dense_replace:
                x = x + _swiglu(h, layer.mlp, dt)
            else:
                x = x + self._moe(layer.mlp, h, real.reshape(-1), dt, routing)
        x = _rms(x, body.norm.weight, eps, dt)
        return _lin(x, self.lm_head, dt).float()

    def _attention(self, a: _MLA, h, cos, sin, allowed, neg, dt):
        cfg = self.cfg
        B, L, _ = h.shape
        H, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
        q = _lin(h, a.q_proj, dt).view(B, L, H, dn + dr)
        c, k_pe = _lin(h, a.kv_a_proj_with_mqa, dt).split([cfg.kv_lora_rank, dr], dim=-1)
        c = _rms(c, a.kv_a_layernorm.weight, cfg.rms_norm_eps, dt)
        k_nope, v = _lin(c, a.kv_b_proj, dt).view(B, L, H, dn + dv).split([dn, dv], dim=-1)
        # q's heads and the shared k_pe rotated together, as H + 1 heads
        pe = _rope(torch.cat([q[..., dn:], k_pe.reshape(B, L, 1, dr)], dim=2), cos, sin).to(dt)
        qh = torch.cat([q[..., :dn], pe[:, :, :H]], dim=-1)
        kh = torch.cat([k_nope, pe[:, :, H:].expand(B, L, H, dr)], dim=-1)
        att = (torch.einsum("bqhd,bkhd->bhqk", qh, kh) * self.scale).masked_fill(~allowed, neg)
        att = torch.softmax(att.float(), dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, H * dv)
        return _lin(o, a.o_proj, dt)

    def _moe(self, m: _MoE, h, real, dt, routing):
        cfg = self.cfg
        B, L, D = h.shape
        x = h.reshape(B * L, D)
        with span("moe.route"):
            w, idx, counts = route(x, m.gate.weight, cfg.num_experts_per_tok,
                                   cfg.routed_scaling_factor, real)
        with span("moe.experts"):
            y = moe_experts(x, idx, w, _cast(m.experts.gate_up_proj.weight, dt),
                            _cast(m.experts.down_proj.weight, dt), counts)
            y = y + _swiglu(x, m.shared_experts, dt)
        if routing is not None:
            routing.append((idx.view(B, L, -1), counts))
        return y.view(B, L, D)


class DeepseekV2Rescorer(PackedScorer):
    """LLMScorer over the DeepSeek-V2 forward: the shared packed scorer,
    with spans ``dsv2.dispatch`` and ``dsv2.fetch``. ``encode`` maps (text,
    max_len) → token ids; ``params`` is a state dict in the port's layout
    (``init_params``), drawn from ``seed`` when None. A context is
    concatenated before each text (no latent prefix cache).

    The rows are padded to a power of two (at least 2) and the segment bins
    to one (at least 16), so a few shapes serve every n-best. On the card
    each shape's forward is captured once as a CUDA graph (the kernels of
    27 layers, ~2,500 launch calls eagerly) and replayed (``PackedScorer``);
    on the CPU it runs op by op.

    Counters: ``moe.tokens``, the tokens into MoE layers (known on the
    host); ``moe.experts_touched``, the experts that saw a token, summed over
    the layers, counted on the card and copied by the fetch with the
    scores; ``dsv2.graph_captures``."""

    span_name = "dsv2"
    ROWS_LEAST = 2
    GRAPH_CACHE = 16  # captured shapes kept, the least recently used dropped

    def __init__(
        self,
        cfg: DeepseekV2Config,
        encode: Callable[[str, int], List[int]],
        params: Optional[StateDict] = None,
        device: Optional[Union[str, torch.device]] = None,
        max_len: int = 256,
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        pack: bool = True,
    ):
        device = resolve_device(device)
        if params is None:
            params = init_params(cfg, device, torch.float32,
                                 torch.Generator(device=device).manual_seed(seed))
        self.cfg = cfg
        self.n_moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
        self._graphs = GraphCache(self.GRAPH_CACHE, moe_experts, "dsv2.graph_captures")
        super().__init__(DeepseekV2Model.from_state_dict(cfg, params, device), encode, device,
                         min(max_len, cfg.max_position_embeddings), compute_dtype, pack)

    def _begin(self, ids: List[List[int]], length_penalty: float):
        count("moe.tokens", sum(map(len, ids)) * self.n_moe_layers)
        return super()._begin(ids, length_penalty)

    def _forward(self, n_segments: int, tokens, seg, pos):
        """(sums, counts, experts touched or None) of one packed forward."""
        routing: List = []
        sums, cnt = score_packed_fn(n_segments, self.compute_dtype, routing=routing)(
            self.model, tokens, seg, pos)
        if not routing:
            return sums, cnt, None
        return sums, cnt, torch.stack([c[:-1] for _, c in routing]).gt(0).sum()

    def _counters(self, touched) -> Optional[Dict[str, torch.Tensor]]:
        return None if touched is None else {"moe.experts_touched": touched}
