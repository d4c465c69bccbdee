"""The connected pipeline's synthetic world: planted stage 1, the decode
lexicon and its n-gram pair, planted utterances, and their scoring.

Counterpart of the world helpers of the JAX package's ``bench.py``:
``make_stage1`` (:71), ``build_world`` (:118), ``make_planted_utts`` (:198),
``score_results`` (:229) and ``aggregate_wer`` (:244). ``build_world`` trains
with the port's native trainer and writes the same ARPA and lexicon files;
``make_planted_utts``, ``score_results`` and ``aggregate_wer`` are copies;
``make_stage1`` runs the planted full-size model (512 features, 5×768 GRU,
patch 14/4) on the card, or where ``device`` says.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Union

import numpy as np
import torch


def make_stage1(B: int, T: int, head_gain: Optional[float] = None,
                blank_bias: Optional[float] = None,
                device: Union[str, torch.device, None] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
    """Full-size planted stage 1: (B, T) frame labels (−1 = silence) and a
    ``torch.Generator`` on ``device`` → (B, P, 41) log-probs on ``device``.
    The features are made on the device (``features_on_device``, noise 0.3),
    smoothed with 'valid' padding, and run through ``GRUDecoder`` (K1 on the
    card) in ``compute_dtype``; the log-softmax is float32. ``head_gain`` /
    ``blank_bias`` override the planted head's calibration (45 / 12): lower
    gains give soft posteriors. ``device=None`` means the CUDA card.

    Returns ``(run, P, info)``. ``run.posteriors(x)`` takes (B, T, 512)
    features instead of labels."""
    from ..data.synthetic import phoneme_code
    from ..models.gru_decoder import GRUDecoder
    from ..models.planted import features_on_device, planted_params
    from ..ops.smoothing import gauss_smooth, gaussian_kernel
    from ..utils.config import TrainConfig
    from ..utils.device import resolve_device, upload

    device = resolve_device(device)
    cfg = TrainConfig()
    code_np = phoneme_code(cfg.model.n_input_features)
    gkw = {}
    if head_gain is not None:
        gkw["head_gain"] = head_gain
    if blank_bias is not None:
        gkw["blank_bias"] = blank_bias
    model = GRUDecoder(cfg.model, 45, 41, device=device)
    model.load_state_dict(planted_params(cfg.model, 45, code_np, **gkw))
    code = torch.from_numpy(code_np).to(device)
    dt = cfg.dataset.data_transforms
    ksize = len(gaussian_kernel(dt.smooth_kernel_std, dt.smooth_kernel_size))
    P = (T - (ksize - 1) - cfg.model.patch_size) // cfg.model.patch_stride + 1
    day_idx = torch.arange(B, device=device) % 45

    @torch.no_grad()
    def posteriors(x: torch.Tensor) -> torch.Tensor:
        sm = gauss_smooth(x, std=dt.smooth_kernel_std, size=dt.smooth_kernel_size,
                          padding="valid")
        logits = model(sm, day_idx, compute_dtype=compute_dtype)
        return torch.log_softmax(logits.float(), dim=-1)

    def run(labels, generator: torch.Generator) -> torch.Tensor:
        # a pinned, non-blocking upload: a pageable copy would wait for the
        # card, and run() only enqueues work
        labels = upload(np.asarray(labels, np.int64), device)
        return posteriors(features_on_device(code, labels, generator, noise=0.3))

    run.posteriors = posteriors
    info = {"batch": B, "bins_per_sentence": T, "decode_frames": P,
            "device": str(device), "compute_dtype": str(compute_dtype).replace("torch.", ""),
            "use_cuda_gru": device.type == "cuda"}
    return run, P, info


def build_world(vocab_size: int, order: int = 3, seed: int = 0,
                prune_threshold: float = 3e-8, adversarial: bool = False,
                real_lexicon: bool = False):
    """Synthetic decode world at reference scale: a ``vocab_size``-word
    lexicon with full LM coverage, a natively trained unpruned n-gram and
    its weighted-difference-pruned decode LM (the reference's G /
    G_no_prune pair), written as ``lm.arpa``, ``lm_unpruned.arpa`` and
    ``lexicon.txt`` in a new temporary directory. ``adversarial`` uses
    CMUdict homophone and collision statistics (``data.adversarial``)
    instead of unique pronunciations; ``real_lexicon`` uses the reference's
    CMUdict (``data.real_assets``) and raises ``SystemExit`` without it.

    Returns (lexicon, lm, lm_unpruned, words, arpa, arpa_unpruned,
    lexicon_path, rng, stats), as ``bench.build_world`` does."""
    import tempfile

    from ..lm import Lexicon
    from ..lm.ngram import NGramLM
    from ..runtime import train_ngram_native
    from ..utils.phonemes import LOGIT_TO_PHONEME

    rng = np.random.default_rng(seed)
    stats = None
    if real_lexicon:
        from ..data.adversarial import lexicon_stats
        from ..data.real_assets import (have_real_dict,
                                        real_lexicon as _load_real)

        if not have_real_dict():
            raise SystemExit("--real_lexicon: reference dict.txt not found")
        t0 = time.perf_counter()
        lex, prons = _load_real(
            max_words=vocab_size if vocab_size < 124_000 else None)
        trie_build_s = time.perf_counter() - t0
        words = {w: ps[0] for w, ps in prons.items()}
        wl = list(words.keys())
        vocab_size = len(wl)
        stats = lexicon_stats(words)
        stats["trie_build_s"] = round(trie_build_s, 2)
        stats["trie_nodes"] = lex.n_nodes
    elif adversarial:
        from ..data.adversarial import homophone_lexicon, lexicon_stats

        words, wl = homophone_lexicon(rng, vocab_size)
        stats = lexicon_stats(words)
    else:
        phones = LOGIT_TO_PHONEME[1:40]
        words = {}
        while len(words) < vocab_size:
            # 3-9 phones (avg ~6), CMUdict-like; 2-phone-heavy random vocabs
            # have a homophone and prefix ambiguity no real lexicon has (that
            # regime is ``adversarial``)
            L = rng.integers(3, 10)
            pron = [phones[i] for i in rng.integers(0, 39, L)]
            words["w" + "".join(p.lower() for p in pron)] = pron
        wl = list(words.keys())
    if not real_lexicon:
        lex = Lexicon.from_words(words)

    tmp = tempfile.mkdtemp()
    corpus_path = os.path.join(tmp, "corpus.txt")
    with open(corpus_path, "w") as f:
        perm = rng.permutation(vocab_size)  # every word covered
        for i in range(0, vocab_size, 6):
            f.write(" ".join(wl[j] for j in perm[i : i + 6]) + "\n")
        for _ in range(max(3000, vocab_size // 5)):
            f.write(" ".join(
                wl[i] for i in rng.integers(0, vocab_size, rng.integers(3, 10))
            ) + "\n")
    arpa_unpruned = os.path.join(tmp, "lm_unpruned.arpa")
    train_ngram_native(corpus_path, arpa_unpruned, order=order)
    lm_unpruned = NGramLM.from_arpa(arpa_unpruned)
    arpa = os.path.join(tmp, "lm.arpa")
    lm = lm_unpruned.prune(prune_threshold)
    lm.to_arpa(arpa)
    lexp = os.path.join(tmp, "lexicon.txt")
    with open(lexp, "w") as f:
        for w, p in words.items():
            f.write(f"{w.upper()}  {' '.join(p)}\n")
    return lex, lm, lm_unpruned, wl, arpa, arpa_unpruned, lexp, rng, stats


def make_planted_utts(lex, wl, rng, n: int, T: int,
                      phone_budget: int | None = None):
    """n utterances: (sentence, planted (T,) frame labels). Words are drawn
    until the phone+SIL budget fills (~5-6 words/sentence at CMUdict-like
    pronunciation lengths at the canonical T=520; smaller T derives a
    proportionally smaller budget so planting always fits)."""
    from ..models.planted import plant_frame_labels

    if phone_budget is None:
        # worst-case emission is 11 frames (hot 7 + gap 4); keep headroom
        phone_budget = max(8, min(44, (T - 24) // 11))
    out = []
    while len(out) < n:
        sent_words = []
        ids: list = []
        while True:
            w = wl[int(rng.integers(0, len(wl)))]
            wid = lex.word_ids[w]
            n_ph = len(lex.prons[wid][0]) + 1
            if ids and len(ids) + n_ph > phone_budget:
                break
            sent_words.append(w)
            ids.extend(lex.prons[wid][0])
            ids.append(40)  # SIL at word end
        lab, n_planted = plant_frame_labels(rng, ids, T)
        if n_planted != len(ids):
            continue  # rare worst-case spacing draw — resample
        out.append((" ".join(sent_words), lab))
    return out


def score_results(cfg, sents, results):
    correct = search_errors = 0
    for sent, r in zip(sents, results):
        if r and r[0].sentence == sent:
            correct += 1
        elif r:
            truth = [c for c in r if c.sentence == sent]
            if truth and (
                cfg.acoustic_scale * truth[0].ac_score + truth[0].lm_score
                > cfg.acoustic_scale * r[0].ac_score + r[0].lm_score
            ):
                search_errors += 1
    return correct, search_errors


def aggregate_wer(sents, results):
    from ..utils.metrics import calculate_aggregate_error_rate

    refs = [s.split() for s in sents]
    hyps = [(r[0].sentence.split() if r else []) for r in results]
    agg, lo, hi, _ = calculate_aggregate_error_rate(refs, hyps, seed=0)
    return agg, lo, hi
