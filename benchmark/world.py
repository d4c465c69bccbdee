"""The inputs every cell shares, made by the benchmark from its own code.

Frozen copies of the program's input makers, so that a later change to the
program cannot change what it is measured on:

* ``phoneme_code``: ``data/synthetic.py``'s planted feature code;
* ``planted_state_dict``: ``models/planted.py``'s ``planted_params`` (the
  phoneme-code readout at full width, head gain 45, blank bias 12), with one
  addition: the recurrent weights W_hh are drawn from the run's seed at a
  small scale instead of being zero, so that the recurrence's product is part
  of what the comparison sees;
* ``plant_frame_labels``, ``features``: the planted label runs and the
  features made from them on the device;
* ``build_world``: ``scripts/world.py``'s decode world (a lexicon of random
  3-9-phone words, a corpus covering every word, a Kneser-Ney trigram and its
  pruned copy), trained by the frozen ``reference/ngram.py`` and written as
  ``lm.arpa``, ``lm_unpruned.arpa`` and ``lexicon.txt``;
* ``plant_sentence``: ``scripts/world.py``'s ``make_planted_utts`` for one
  utterance.

The world's files are cached in ``benchmark/.cache/world-<key>/``, keyed by
the parameters that make them, so only a checkout's first run builds them.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference.ngram import train_ngram
from .reference.phonemes import LOGIT_TO_PHONEME

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")

_TARGET_PREACT = 1.5


def phoneme_code(neural_dim: int, n_classes: int = 41, seed: int = 123) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_classes, neural_dim)).astype(np.float32)


def planted_state_dict(model_cfg: Dict, n_days: int, code: np.ndarray, seed: int,
                       device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The planted readout as a ``GRUDecoder`` state dict (the reference
    checkpoint's names), made on ``device``. Each layer's update gate is held
    at 0 (b_ih_z = -30), so h_t = tanh(W_in x_t + b + r * (W_hn h_{t-1})):
    layer 1 holds a matched filter per phoneme on the patch's center frame,
    layers 2-5 pass the 41 detector channels through, the head scales them
    and biases BLANK. W_hh is N(0, (w_hh_scale)^2 / H), drawn with a
    generator on ``device`` seeded with ``seed``."""
    D = int(model_cfg["n_input_features"])
    H = int(model_cfg["n_units"])
    P = int(model_cfg["patch_size"])
    L = int(model_cfg["n_layers"])
    C = int(model_cfg["n_classes"])
    gain = float(model_cfg["head_gain"])
    blank_bias = float(model_cfg["blank_bias"])
    scale = float(model_cfg["w_hh_scale"])
    in_dim = D * P if P > 0 else D
    center = P // 2

    soft = code / (1.0 + np.abs(code))
    resp = np.sum(code * soft, axis=1)
    filt = torch.from_numpy(code * (_TARGET_PREACT / resp)[:, None]).to(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    # every layer's W_hh in one draw
    w_hh = torch.randn((L, 3 * H, H), generator=gen, device=device,
                       dtype=torch.float32).mul_(scale / H ** 0.5)
    sd: Dict[str, torch.Tensor] = {}
    eye_d = torch.eye(D, device=device)
    for i in range(n_days):
        sd[f"day_weights.{i}"] = eye_d.clone()
        sd[f"day_biases.{i}"] = torch.zeros((1, D), device=device)
    for k in range(L):
        d_in = in_dim if k == 0 else H
        w_ih = torch.zeros((3 * H, d_in), device=device)
        if k == 0:
            w_ih[2 * H: 2 * H + C, center * D: (center + 1) * D] = filt
        else:
            w_ih[2 * H: 2 * H + C, :C] = torch.eye(C, device=device)
        b_ih = torch.zeros((3 * H,), device=device)
        b_ih[H: 2 * H] = -30.0
        sd[f"gru.weight_ih_l{k}"] = w_ih
        sd[f"gru.weight_hh_l{k}"] = w_hh[k].clone()
        sd[f"gru.bias_ih_l{k}"] = b_ih
        sd[f"gru.bias_hh_l{k}"] = torch.zeros((3 * H,), device=device)
    out_w = torch.zeros((C, H), device=device)
    out_w[:, :C] = torch.eye(C, device=device) * gain
    out_b = torch.zeros((C,), device=device)
    out_b[0] = blank_bias
    sd["out.weight"] = out_w
    sd["out.bias"] = out_b
    sd["h0"] = torch.zeros((1, 1, H), device=device)
    return {k: v.to(dtype) for k, v in sd.items()}


def plant_frame_labels(rng: np.random.Generator, phoneme_ids: Sequence[int], T: int,
                       min_hot: int = 5, max_hot: int = 7, min_gap: int = 2,
                       max_gap: int = 4, lead: int = 8) -> Tuple[np.ndarray, int]:
    """(T,) int32 frame labels (-1 = silence) with hot runs long enough that
    every phoneme catches a patch center at stride 4. Returns (labels,
    number planted)."""
    labels = np.full((T,), -1, np.int32)
    t = lead
    prev = -1
    n_planted = 0
    for pid in phoneme_ids:
        if pid == prev:
            t += 8
        n = int(rng.integers(min_hot, max_hot + 1))
        if t + n > T - 12:
            break
        labels[t: t + n] = pid
        n_planted += 1
        t += n + int(rng.integers(min_gap, max_gap + 1))
        prev = pid
    return labels, n_planted


def features(code: torch.Tensor, labels: torch.Tensor, generator: torch.Generator,
             noise: float) -> torch.Tensor:
    """(B, T) labels -> (B, T, D) planted features on ``labels``' device."""
    x = torch.where((labels >= 0)[..., None], code[labels.clamp(min=0)],
                    torch.zeros((), dtype=code.dtype, device=code.device))
    return x + noise * torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                   device=x.device)


def plant_sentence(words: Sequence[str], prons: Sequence[Sequence[int]],
                   rng: np.random.Generator, T: int) -> Tuple[str, np.ndarray, List[int]]:
    """One planted utterance of ``T`` bins: words drawn until the phone+SIL
    budget fills (``prons[i]``: word i's phone ids). Returns (sentence,
    (T,) labels, phoneme ids with SIL)."""
    budget = max(8, min(44, (T - 24) // 11))
    while True:
        sent: List[str] = []
        ids: List[int] = []
        while True:
            i = int(rng.integers(0, len(words)))
            w, pron = words[i], prons[i]
            if ids and len(ids) + len(pron) + 1 > budget:
                break
            sent.append(w)
            ids.extend(pron)
            ids.append(40)  # SIL at word end
        lab, n = plant_frame_labels(rng, ids, T)
        if n == len(ids):
            return " ".join(sent), lab, ids


def world_key(world_cfg: Dict) -> str:
    keys = ("vocab_size", "order", "prune_threshold", "world_seed")
    blob = json.dumps({k: world_cfg[k] for k in keys}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def build_world(world_cfg: Dict) -> Tuple[str, List[str], List[List[int]]]:
    """The decode world's directory (``lm.arpa``, ``lm_unpruned.arpa``,
    ``lexicon.txt``, ``words.json``), built once per checkout. Returns
    (directory, word list, each word's phone ids)."""
    d = os.path.join(CACHE_DIR, "world-" + world_key(world_cfg))
    done = os.path.join(d, "words.json")
    if not os.path.exists(done):
        os.makedirs(d, exist_ok=True)
        V = int(world_cfg["vocab_size"])
        rng = np.random.default_rng(int(world_cfg["world_seed"]))
        phones = LOGIT_TO_PHONEME[1:40]
        prons: Dict[str, List[str]] = {}
        while len(prons) < V:
            n = rng.integers(3, 10)
            pron = [phones[i] for i in rng.integers(0, 39, n)]
            prons["w" + "".join(p.lower() for p in pron)] = pron
        wl = list(prons)
        perm = rng.permutation(V)
        corpus = [[wl[j] for j in perm[i: i + 6]] for i in range(0, V, 6)]
        for _ in range(max(3000, V // 5)):
            corpus.append([wl[i] for i in rng.integers(0, V, rng.integers(3, 10))])
        lm = train_ngram(corpus, order=int(world_cfg["order"]))
        lm.to_arpa(os.path.join(d, "lm_unpruned.arpa"))
        lm.prune(float(world_cfg["prune_threshold"])).to_arpa(os.path.join(d, "lm.arpa"))
        with open(os.path.join(d, "lexicon.txt"), "w") as f:
            for w, p in prons.items():
                f.write(f"{w.upper()}  {' '.join(p)}\n")
        ids = {p: i for i, p in enumerate(LOGIT_TO_PHONEME)}
        tmp = done + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"words": wl, "prons": [[ids[p] for p in prons[w]] for w in wl]}, f)
        os.replace(tmp, done)
    with open(done) as f:
        w = json.load(f)
    return d, w["words"], w["prons"]
