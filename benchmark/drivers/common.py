"""What the serving drivers share: the program's decode world and stage-1
model built from the benchmark's inputs, and the numbers the comparison
with the plain reference reads."""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..world import build_world, phoneme_code, planted_state_dict


def program_world(config: Dict):
    """The decode world, loaded by the program's own loaders from the raw
    files, as ``scripts/evaluate_model.py`` loads an LM directory. Returns
    (world dir, words, prons, lexicon, lm, unpruned lm)."""
    from b2txt_tpu_torch.lm import Lexicon, NGramLM

    d, words, prons = build_world(config["world"])
    lm = NGramLM.from_arpa(os.path.join(d, "lm.arpa"))
    lexicon = Lexicon.from_file(os.path.join(d, "lexicon.txt"), vocab=lm.vocab)
    unpruned = NGramLM.from_arpa(os.path.join(d, "lm_unpruned.arpa"))
    return d, words, prons, lexicon, lm, unpruned


def decode_config(config: Dict):
    from b2txt_tpu_torch.utils.config import DecodeConfig

    return DecodeConfig(**config["decode"])


def program_model(config: Dict, seed: int, device):
    """(train config with one session name per day, the program's
    ``GRUDecoder`` holding the benchmark's planted weights, those weights,
    the feature code on ``device``)."""
    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
    from b2txt_tpu_torch.utils.config import TrainConfig

    m = config["model"]
    tc = TrainConfig()
    for key in ("n_input_features", "n_units", "n_layers", "patch_size", "patch_stride"):
        setattr(tc.model, key, int(m[key]))
    dt = tc.dataset.data_transforms
    dt.smooth_kernel_std = float(m["smooth_kernel_std"])
    dt.smooth_kernel_size = int(m["smooth_kernel_size"])
    n_days = int(m["n_days"])
    tc.dataset.sessions = [f"day{i:02d}" for i in range(n_days)]
    code = phoneme_code(int(m["n_input_features"]), int(m["n_classes"]))
    sd = planted_state_dict(m, n_days, code, seed, device)
    model = GRUDecoder(tc.model, n_days, int(m["n_classes"]), device=device)
    model.load_state_dict(sd)
    return tc, model, sd, torch.from_numpy(code).to(device)


def compute_dtype(config: Dict) -> torch.dtype:
    return getattr(torch, config["model"]["compute_dtype"])


def posterior_gap(served: np.ndarray, ref: np.ndarray, floor: float) -> float:
    """The widest gap between served and reference log-probs, over the
    entries the reference puts above ``floor`` (those a search can use)."""
    if served.shape != ref.shape:
        return math.inf
    mask = ref >= floor
    return float(np.max(np.abs(served.astype(np.float64) - ref)[mask]))


def total(row: Tuple, scale: float) -> float:
    """scale * acoustic + n-gram of an (sentence, ac, lm, ...) row."""
    return scale * row[1] + row[2]


def nbest_gaps(served_rows: Sequence[Tuple], ref_rows: Sequence[Tuple],
               served_best: str, scale: float) -> Tuple[float, float]:
    """(score gap, best gap) of one utterance. The score gap is the widest
    |served - reference| of scale*ac + lm over sentences both lists hold;
    the best gap is how far the reference's score of the served sentence
    lies below the reference's best (inf when the reference never found
    the served sentence)."""
    ref = {r[0].strip(): total(r, scale) for r in ref_rows}
    gaps = [abs(total(r, scale) - ref[r[0].strip()]) for r in served_rows
            if r[0].strip() in ref]
    score_gap = max(gaps) if gaps else math.inf
    best = max(ref.values()) if ref else math.inf
    best_gap = best - ref[served_best.strip()] if served_best.strip() in ref else math.inf
    return score_gap, best_gap


def sample_indices(n: int, k: int, seed: int, must: Sequence[int] = ()) -> List[int]:
    """k of range(n) drawn from ``seed``, with ``must`` among them."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    picked = list(dict.fromkeys(int(i) for i in must))
    rest = [i for i in rng.permutation(n).tolist() if i not in picked]
    return sorted(picked + rest[: max(0, k - len(picked))])
