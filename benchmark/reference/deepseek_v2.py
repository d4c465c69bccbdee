"""Plain DeepSeek-V2 (deepseek-ai/DeepSeek-V2-Lite's architecture) for the
reference's n-best scores, and the benchmark's own draw of its weights.

The one plain reference of the program's ``decode/deepseek_lm.py``: the
benchmark's comparison reads it on the card, and the CPU tests
(``tests/test_torch_deepseek_lm.py``) hold the program to it.

Written from DeepSeek-V2 (arXiv:2405.04434) and the model's public
``modeling_deepseek.py``, with ``q_lora_rank`` null (DeepSeek-V2-Lite):

* x = embed(tokens); per layer x += MLA(RMSNorm(x)), x += FFN(RMSNorm(x));
  logits = lm_head(RMSNorm(x)), the head untied; RMSNorm in float32 with
  ``rms_norm_eps``.
* MLA: q = W_q h gives heads of (nope + rope) dims; [c_kv; k_pe] = W_kva h,
  c_kv RMS-normed, [k_nope; v] = W_kvb c_kv per head; every head shares
  k_pe. RoPE after the reorder of ``apply_rotary_pos_emb`` (view (..., d/2,
  2), transpose, reshape), then rotate_half, with YaRN frequencies; the
  scores scaled by (nope + rope)^-1/2 · mscale(factor, mscale_all_dim)^2.
* FFN: the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; the rest a softmax router over ``n_routed_experts``
  in float32, a greedy top-k, weights not renormalized and scaled by
  ``routed_scaling_factor``, plus ``n_shared_experts`` experts as one
  SwiGLU of their summed width. Every token is routed; none is dropped.

Weights are a state dict in the program's layout: HF's names, with each
layer's routed experts stacked (``mlp.experts.gate_up_proj.weight`` of
(E, 2F, D), gate rows first; ``mlp.experts.down_proj.weight`` of (E, D,
F)). Everything runs in float32 with TF32 off, one layer after another;
``control=True`` rounds every product's operands to float8 (e4m3).
``follow`` makes the MoE layers mix the experts another forward chose
(``route_gap`` says how far that choice lies from this one's own).

Imports only torch and math: nothing of the program, nor JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def mscale(scale: float, m: float) -> float:
    """YaRN's attention scale: 0.1 · m · ln(scale) + 1 (1 at scale ≤ 1)."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, length: int) -> float:
    return dim * math.log(length / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(cfg: Dict) -> torch.Tensor:
    """YaRN's inverse frequencies, float32 (rope dim / 2,): base^(-2i/d)
    blended with its value divided by ``factor`` along a linear ramp between
    the correction dims of ``beta_fast`` and ``beta_slow``."""
    rs, d, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    n = rs["original_max_position_embeddings"]
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    low = max(math.floor(_correction_dim(rs["beta_fast"], d, base, n)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], d, base, n)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_scale(cfg: Dict) -> float:
    """The factor on cos and sin: mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)."""
    rs = cfg["rope_scaling"]
    return mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])


def softmax_scale(cfg: Dict) -> float:
    """(nope + rope)^-1/2 · mscale(factor, mscale_all_dim)^2."""
    rs = cfg["rope_scaling"]
    m = mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_pos_emb`` on (..., L, H, d) with cos, sin (..., L, 1, d)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + half * sin


def cos_sin(cfg: Dict, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) at integer ``positions`` (..., L), shaped (..., L, 1, d)."""
    freqs = positions.to(torch.float32)[..., None] * yarn_inv_freq(cfg).to(positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)[..., None, :]
    s = rope_scale(cfg)
    return emb.cos() * s, emb.sin() * s


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(torch.float32)


class _Ref:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, device, control: bool):
        self.sd, self.cfg, self.device = sd, cfg, device
        self.q = _fp8 if control else (lambda t: t)

    def w(self, name: str) -> torch.Tensor:
        return self.sd[name].to(device=self.device, dtype=torch.float32)

    def lin(self, h: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return self.q(h) @ self.q(weight).t()

    def norm(self, h: torch.Tensor, name: str) -> torch.Tensor:
        var = h.pow(2).mean(-1, keepdim=True)
        return self.w(name) * (h * torch.rsqrt(var + self.cfg["rms_norm_eps"]))

    def swiglu(self, h, gate, up, down):
        return self.lin(F.silu(self.lin(h, gate)) * self.lin(h, up), down)


def _attention(r: _Ref, p: str, h, cos, sin, allowed):
    cfg = r.cfg
    B, L, _ = h.shape
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    q = r.lin(h, r.w(p + "self_attn.q_proj.weight")).view(B, L, H, dn + dr)
    ckv = r.lin(h, r.w(p + "self_attn.kv_a_proj_with_mqa.weight"))
    c, k_pe = ckv.split([cfg["kv_lora_rank"], dr], dim=-1)
    c = r.norm(c, p + "self_attn.kv_a_layernorm.weight")
    kv = r.lin(c, r.w(p + "self_attn.kv_b_proj.weight")).view(B, L, H, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = rotate(q[..., dn:], cos, sin)
    k_pe = rotate(k_pe.view(B, L, 1, dr), cos, sin).expand(B, L, H, dr)
    qh = torch.cat([q[..., :dn], q_pe], dim=-1)
    kh = torch.cat([k_nope, k_pe], dim=-1)
    att = torch.einsum("bqhd,bkhd->bhqk", r.q(qh), r.q(kh)) * softmax_scale(cfg)
    att = att.masked_fill(~allowed, float("-inf")).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", r.q(att), r.q(v)).reshape(B, L, H * dv)
    return r.lin(o, r.w(p + "self_attn.o_proj.weight"))


def _moe(r: _Ref, p: str, h, real, follow: Optional[torch.Tensor]):
    """(output, chosen experts (N, k), route gap) of one MoE layer over the
    real tokens ``h[real]``."""
    cfg = r.cfg
    E, k, Fm = cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    x = h[real]
    logits = r.lin(x, r.w(p + "mlp.gate.weight"))
    probs = logits.softmax(-1)
    own = torch.topk(probs, k, dim=-1).indices
    chosen = own if follow is None else follow.to(x.device)
    kth = logits.gather(1, own).min(1).values
    gap = float((kth - logits.gather(1, chosen).min(1).values).max()) if len(x) else 0.0
    weight = probs.gather(1, chosen) * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    gate_up = r.w(p + "mlp.experts.gate_up_proj.weight")
    down = r.w(p + "mlp.experts.down_proj.weight")
    for e in range(E):
        hit = chosen == e                               # (N, k)
        rows = hit.any(1).nonzero()[:, 0]
        if len(rows):
            we = (weight * hit).sum(1)[rows, None]
            y[rows] += we * r.swiglu(x[rows], gate_up[e, :Fm], gate_up[e, Fm:], down[e])
    s = p + "mlp.shared_experts."
    y = y + r.swiglu(x, r.w(s + "gate_proj.weight"), r.w(s + "up_proj.weight"),
                     r.w(s + "down_proj.weight"))
    out = torch.zeros_like(h)
    out[real] = y
    return out, chosen, gap


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor, mask: torch.Tensor,
            device, control: bool = False,
            follow: Optional[Sequence[torch.Tensor]] = None):
    """(logits (B, L, V) float32, chosen experts per MoE layer (N, k) over
    the real tokens in row-major order, widest route gap) of right-padded
    ``tokens`` with ``mask`` (True = real), positions 0.. in each row.
    ``follow``, per MoE layer (N, k), makes the layer mix those experts with
    this forward's own router probabilities."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = _Ref(sd, cfg, device, control)
    tokens, mask = tokens.to(device), mask.to(device).bool()
    B, L = tokens.shape
    x = F.embedding(tokens.long(), r.w("model.embed_tokens.weight"))
    cos, sin = cos_sin(cfg, torch.arange(L, device=device)[None].expand(B, L))
    allowed = (torch.ones((L, L), dtype=torch.bool, device=device).tril()[None, None]
               & mask[:, None, None, :])
    chosen_all: List[torch.Tensor] = []
    gap = 0.0
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = r.norm(x, p + "input_layernorm.weight")
        x = x + _attention(r, p, h, cos, sin, allowed)
        h = r.norm(x, p + "post_attention_layernorm.weight")
        if i < cfg["first_k_dense_replace"]:
            x = x + r.swiglu(h, r.w(p + "mlp.gate_proj.weight"), r.w(p + "mlp.up_proj.weight"),
                             r.w(p + "mlp.down_proj.weight"))
        else:
            j = len(chosen_all)
            y, chosen, g = _moe(r, p, h, mask, None if follow is None else follow[j])
            x = x + y
            chosen_all.append(chosen)
            gap = max(gap, g)
    x = r.norm(x, "model.norm.weight")
    return r.lin(x, r.w("lm_head.weight")), chosen_all, gap


def sequence_scores(sd: Dict[str, torch.Tensor], cfg: Dict, ids: Sequence[Sequence[int]],
                    device, control: bool = False,
                    follow: Optional[Sequence[torch.Tensor]] = None):
    """(Σ log P(token_t | tokens_<t) for t ≥ 1 of each id list, as floats;
    chosen experts per MoE layer over the lists' tokens in order; widest
    route gap), one forward over the right-padded lists."""
    B, L = len(ids), max(len(s) for s in ids)
    tok = torch.zeros((B, L), dtype=torch.long)
    mask = torch.zeros((B, L), dtype=torch.bool)
    for i, s in enumerate(ids):
        tok[i, : len(s)] = torch.as_tensor(s)
        mask[i, : len(s)] = True
    logits, chosen, gap = forward(sd, cfg, tok, mask, device, control, follow)
    tok, mask = tok.to(device), mask.to(device)
    lp = torch.log_softmax(logits[:, :-1], dim=-1).gather(2, tok[:, 1:, None])[..., 0]
    return (lp * mask[:, 1:]).sum(1).double().cpu().tolist(), chosen, gap


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Every parameter's name (HF's, each MoE layer's routed experts
    stacked) and shape, from the config.json keys."""
    D, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    R, E, Fm = cfg["kv_lora_rank"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    S = cfg["n_shared_experts"] * Fm
    shapes = {"model.embed_tokens.weight": (V, D)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (D,),
                       p + "self_attn.q_proj.weight": (H * (dn + dr), D),
                       p + "self_attn.kv_a_proj_with_mqa.weight": (R + dr, D),
                       p + "self_attn.kv_a_layernorm.weight": (R,),
                       p + "self_attn.kv_b_proj.weight": (H * (dn + dv), R),
                       p + "self_attn.o_proj.weight": (D, H * dv),
                       p + "post_attention_layernorm.weight": (D,)})
        if i < cfg["first_k_dense_replace"]:
            I_ = cfg["intermediate_size"]
            shapes.update({p + "mlp.gate_proj.weight": (I_, D), p + "mlp.up_proj.weight": (I_, D),
                           p + "mlp.down_proj.weight": (D, I_)})
        else:
            shapes.update({p + "mlp.gate.weight": (E, D),
                           p + "mlp.experts.gate_up_proj.weight": (E, 2 * Fm, D),
                           p + "mlp.experts.down_proj.weight": (E, D, Fm),
                           p + "mlp.shared_experts.gate_proj.weight": (S, D),
                           p + "mlp.shared_experts.up_proj.weight": (S, D),
                           p + "mlp.shared_experts.down_proj.weight": (D, S)})
    shapes["model.norm.weight"] = (D,)
    shapes["lm_head.weight"] = (V, D)
    return shapes


def draw_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """Random weights made on ``device`` in ``dtype``: every matrix N(0,
    std^2) from one draw of a generator seeded with ``seed``, every norm 1.
    The tensors are views of two flat buffers; the same seed gives the same
    values."""
    shapes = param_shapes(cfg)
    mats = [n for n, s in shapes.items() if len(s) > 1]
    ones = [n for n, s in shapes.items() if len(s) == 1]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))

    def views(names, buf):
        out, off = {}, 0
        for n in names:
            k = math.prod(shapes[n])
            out[n] = buf[off: off + k].view(shapes[n])
            off += k
        return out

    n_mat = sum(math.prod(shapes[n]) for n in mats)
    sd = views(mats, torch.randn(n_mat, generator=gen, device=device, dtype=dtype).mul_(std))
    sd.update(views(ones, torch.ones(sum(shapes[n][0] for n in ones), device=device,
                                     dtype=dtype)))
    return sd
