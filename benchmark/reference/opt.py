"""Plain OPT (facebook/opt-6.7b's architecture) for the reference's n-best
scores, and the benchmark's own draw of its weights.

Written from the published description and HF ``OPTForCausalLM`` with
``do_layer_norm_before=True``: learned positions offset by 2, pre-LN blocks
(self-attention, then a ReLU MLP), a final layer norm and a head tied to the
token embedding. A hypothesis' score is the sum of log P(token | earlier
tokens) over its tokens after the first (the reference's
``rescore_with_gpt2``, ``language-model-standalone.py:127-161``). Imports
nothing of the program; computes in float32 with TF32 off, or, as the
control, with every product's operands in float8 (e4m3).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

POS_OFFSET = 2


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """HF ``OPTForCausalLM`` state-dict names and shapes (lm_head tied)."""
    D, Fd = cfg["hidden_size"], cfg["ffn_dim"]
    shapes = {"model.decoder.embed_tokens.weight": (cfg["vocab_size"], D),
              "model.decoder.embed_positions.weight":
                  (cfg["max_position_embeddings"] + POS_OFFSET, D)}
    for i in range(cfg["num_layers"]):
        p = f"model.decoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            shapes[p + f"self_attn.{proj}.weight"] = (D, D)
            shapes[p + f"self_attn.{proj}.bias"] = (D,)
        shapes[p + "self_attn_layer_norm.weight"] = (D,)
        shapes[p + "self_attn_layer_norm.bias"] = (D,)
        shapes[p + "fc1.weight"] = (Fd, D)
        shapes[p + "fc1.bias"] = (Fd,)
        shapes[p + "fc2.weight"] = (D, Fd)
        shapes[p + "fc2.bias"] = (D,)
        shapes[p + "final_layer_norm.weight"] = (D,)
        shapes[p + "final_layer_norm.bias"] = (D,)
    shapes["model.decoder.final_layer_norm.weight"] = (D,)
    shapes["model.decoder.final_layer_norm.bias"] = (D,)
    return shapes


def draw_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights made on ``device`` in ``dtype``: every matrix N(0,
    0.02^2) from one draw of a generator seeded with ``seed``, biases 0,
    norms (1, 0). The tensors are views of three flat buffers; the same seed
    gives the same values."""
    shapes = param_shapes(cfg)
    mats = [n for n, s in shapes.items() if len(s) == 2]
    ones = [n for n in shapes if n.endswith("layer_norm.weight")]
    zeros = [n for n, s in shapes.items() if len(s) == 1 and n not in ones]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))

    def views(names, buf):
        out, off = {}, 0
        for n in names:
            k = 1
            for d in shapes[n]:
                k *= d
            out[n] = buf[off: off + k].view(shapes[n])
            off += k
        return out

    n_mat = sum(torch.Size(shapes[n]).numel() for n in mats)
    flat = torch.randn(n_mat, generator=gen, device=device, dtype=dtype).mul_(0.02)
    sd = views(mats, flat)
    sd.update(views(ones, torch.ones(sum(shapes[n][0] for n in ones), device=device,
                                     dtype=dtype)))
    sd.update(views(zeros, torch.zeros(sum(shapes[n][0] for n in zeros), device=device,
                                       dtype=dtype)))
    sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def word_hash_encode(vocab_size: int):
    """The tokenizer stand-in the cell states: BOS (2), then one id a word,
    crc32 of the word mod (vocab - 10), plus 10."""

    def enc(text: str, max_len: int) -> List[int]:
        ids = [2] + [(zlib.crc32(w.encode()) % (vocab_size - 10)) + 10 for w in text.split()]
        return ids[:max_len]

    return enc


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(torch.float32)


@torch.no_grad()
def sequence_scores(sd: Dict[str, torch.Tensor], cfg: Dict, ids: Sequence[Sequence[int]],
                    device, control: bool = False) -> List[float]:
    """Sum of log P(token_t | tokens_<t) for t >= 1 of each id list, one
    float32 forward over the right-padded batch, a layer at a time."""
    q = _fp8 if control else (lambda t: t)
    w = lambda name: sd[name].to(device=device, dtype=torch.float32)  # noqa: E731
    B, L = len(ids), max(len(s) for s in ids)
    D, H = cfg["hidden_size"], cfg["num_heads"]
    hd = D // H
    tok = torch.zeros((B, L), dtype=torch.long, device=device)
    mask = torch.zeros((B, L), dtype=torch.bool, device=device)
    for i, s in enumerate(ids):
        tok[i, : len(s)] = torch.as_tensor(s, device=device)
        mask[i, : len(s)] = True
    pos = torch.arange(L, device=device)[None].expand(B, L) + POS_OFFSET
    x = F.embedding(tok, w("model.decoder.embed_tokens.weight")) + F.embedding(
        pos, w("model.decoder.embed_positions.weight"))
    allowed = torch.ones((L, L), dtype=torch.bool, device=device).tril()[None, None] \
        & mask[:, None, None, :]

    def lin(h, name):
        return q(h) @ q(w(name + ".weight")).t() + w(name + ".bias")

    def ln(h, name):
        return F.layer_norm(h, (D,), w(name + ".weight"), w(name + ".bias"), eps=1e-5)

    for i in range(cfg["num_layers"]):
        p = f"model.decoder.layers.{i}."
        h = ln(x, p + "self_attn_layer_norm")
        qh = (lin(h, p + "self_attn.q_proj") * hd ** -0.5).view(B, L, H, hd)
        kh = lin(h, p + "self_attn.k_proj").view(B, L, H, hd)
        vh = lin(h, p + "self_attn.v_proj").view(B, L, H, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh))
        att = att.masked_fill(~allowed, float("-inf")).softmax(-1)
        att = torch.nan_to_num(att)   # padded query rows attend to nothing
        o = torch.einsum("bhqk,bkhd->bqhd", q(att), q(vh)).reshape(B, L, D)
        x = x + lin(o, p + "self_attn.out_proj")
        h = ln(x, p + "final_layer_norm")
        x = x + lin(torch.relu(lin(h, p + "fc1")), p + "fc2")
    x = ln(x, "model.decoder.final_layer_norm")
    logits = q(x) @ q(w("model.decoder.embed_tokens.weight")).t()
    lp = torch.log_softmax(logits[:, :-1], dim=-1).gather(2, tok[:, 1:, None])[..., 0]
    lp = (lp * mask[:, 1:]).sum(1)
    return lp.double().cpu().tolist()
