"""Batched inference: per-utterance feature arrays → per-utterance logits.

Counterpart of the inference part of ``b2txt_tpu/evaluate/harness.py``
(``_forward_bucket``, ``_batched_inference``, :71-121): trials are sorted by
length, padded into time-bucketed batches, smoothed with 'valid' padding
(the inference-path difference of the reference, helpers:92-98) and run
through the model on its device; each trial's logits are cut back to its own
patch count. The logits feed ``serve.DecoderService.decode_utterances``;
``_batched_inference_device`` (:124-152) keeps log-softmax posteriors on
the card for ``DecoderService.decode_batched_utterances``. Session
evaluation, HDF5 loading and g2p wait for a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.gru_decoder import GRUDecoder
from ..ops.smoothing import gauss_smooth, gaussian_kernel
from ..utils.config import TrainConfig


def _forward_bucket(
    model: GRUDecoder, feats_list: Sequence[np.ndarray], idxs, day_idx: int,
    cfg: TrainConfig, compute_dtype: torch.dtype, time_bucket: int,
    pad_rows: Optional[int] = None,
):
    """Pad one sorted bucket of trials (to ``pad_rows`` rows, when given),
    smooth and run the forward on the model's device. Returns (logits
    (B, P, C) on that device, per-trial output lengths)."""
    dt = cfg.dataset.data_transforms
    ksize = len(gaussian_kernel(dt.smooth_kernel_std, dt.smooth_kernel_size))
    device = model.h0.device
    B = pad_rows or len(idxs)
    max_t = max(feats_list[i].shape[0] for i in idxs)
    T_pad = ((max_t + time_bucket - 1) // time_bucket) * time_bucket
    batch = np.zeros((B, T_pad, feats_list[idxs[0]].shape[1]), np.float32)
    for row, i in enumerate(idxs):
        batch[row, : feats_list[i].shape[0]] = feats_list[i]
    x = torch.from_numpy(batch).to(device)
    with torch.inference_mode():
        if dt.smooth_data:
            x = gauss_smooth(x, std=dt.smooth_kernel_std,
                             size=dt.smooth_kernel_size, padding="valid")
        logits = model(
            x, torch.full((B,), day_idx, dtype=torch.long, device=device),
            compute_dtype=compute_dtype,
        )
    p_is = []
    for i in idxs:
        t_i = feats_list[i].shape[0]
        if dt.smooth_data:
            t_i = t_i - ksize + 1
        p_is.append((t_i - cfg.model.patch_size) // cfg.model.patch_stride + 1)
    return logits, p_is


def _batched_inference(
    model: GRUDecoder, feats_list: Sequence[np.ndarray], day_idx: int,
    cfg: TrainConfig, compute_dtype: torch.dtype = torch.float32,
    batch_size: int = 32, time_bucket: int = 128,
) -> List[np.ndarray]:
    """Pad trials into bucketed batches for device efficiency; per-trial
    adjusted lengths slice the per-trial (P_i, C) float32 logits back out."""
    out: List[Optional[np.ndarray]] = [None] * len(feats_list)
    order = np.argsort([f.shape[0] for f in feats_list])
    for start in range(0, len(order), batch_size):
        idxs = order[start : start + batch_size]
        logits, p_is = _forward_bucket(
            model, feats_list, idxs, day_idx, cfg, compute_dtype, time_bucket
        )
        logits = logits.float().cpu().numpy()
        for row, (i, p_i) in enumerate(zip(idxs, p_is)):
            out[i] = logits[row, :p_i]
    return out  # type: ignore[return-value]


def _batched_inference_device(
    model: GRUDecoder, feats_list: Sequence[np.ndarray], day_idx: int,
    cfg: TrainConfig, compute_dtype: torch.dtype = torch.float32,
    batch_size: int = 32, time_bucket: int = 128,
):
    """Device-resident variant of _batched_inference: log-softmax posteriors
    STAY on the model's device (they feed the device beam search directly —
    the coupling of evaluate_model.py:158-237 without a host round-trip);
    only the greedy argmax ids (B, P) come to the host. Every batch is
    padded to ``batch_size`` rows (padding rows get length 0).

    Returns (batches [(log_probs (B, P, 41) f32 tensor, lens (B,) int32)],
    sizes, trial_order, greedy_ids {trial: (P_i,) ids})."""
    order = np.argsort([f.shape[0] for f in feats_list])
    batches, sizes, trial_order, greedy = [], [], [], {}
    for start in range(0, len(order), batch_size):
        idxs = order[start : start + batch_size]
        logits, p_is = _forward_bucket(
            model, feats_list, idxs, day_idx, cfg, compute_dtype, time_bucket,
            pad_rows=batch_size,
        )
        lp = torch.log_softmax(logits.float(), dim=-1)
        ids = lp.argmax(dim=-1).to(torch.int32).cpu().numpy()   # small fetch
        lens = np.zeros((batch_size,), np.int32)
        for row, (i, p_i) in enumerate(zip(idxs, p_is)):
            lens[row] = p_i
            greedy[int(i)] = ids[row, :p_i]
        batches.append((lp, lens))
        sizes.append(len(idxs))
        trial_order.extend(int(i) for i in idxs)
    return batches, sizes, trial_order, greedy
