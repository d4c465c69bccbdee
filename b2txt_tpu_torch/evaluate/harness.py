"""Session evaluation harness: greedy PER, LM-decoded WER, competition CSV.

Counterpart of ``b2txt_tpu/evaluate/harness.py`` (parity target:
``model_training/evaluate_model.py`` + helpers): per-session
data_{val,test}.hdf5 loading, inference with 'valid'-padding Gaussian
smoothing (runSingleDecodingStep, helpers:87-115), greedy argmax phoneme
printout, LM decoding via the streaming service (replacing the Redis
round-trip), aggregate WER with punctuation-normalized references
(:240-267), and the ``id,text`` competition CSV (:270-274).

The model is the port's ``GRUDecoder`` on its device, in place of the JAX
package's ``params``. Trials are sorted by length, padded into time-bucketed
batches and run on the model's device; each trial's logits are cut back to
its own patch count (``_batched_inference``). ``_batched_inference_device``
keeps log-softmax posteriors on the card for
``DecoderService.decode_batched_utterances``. ``evaluate_sessions`` reads
the HDF5 files (h5py) and hands each session's columns to
``evaluate_session_data``, which also takes sessions held in memory.
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.hdf5_store import load_session_file
from ..models.gru_decoder import GRUDecoder
from ..ops.smoothing import gauss_smooth, gaussian_kernel
from ..serve.service import DecoderService, FinalOutput
from ..utils.config import TrainConfig
from ..utils.g2p import sentence_to_phoneme_ids
from ..utils.metrics import calculate_aggregate_error_rate, edit_distance
from ..utils.phonemes import LOGIT_TO_PHONEME, greedy_collapse, remove_punctuation
from ..utils.profiling import count, span


@dataclass
class TrialEval:
    session: str
    day_idx: int
    block_num: int
    trial_num: int
    logits: Optional[np.ndarray]  # (P, 41) f32 model order; None when the
                                  # posteriors stayed on the device
    decoded_ids: List[int]      # greedy phoneme ids
    true_ids: Optional[List[int]]
    sentence_label: Optional[str]
    decoded_sentence: Optional[str] = None  # filled by LM decode


def run_single_decoding_step(
    model: GRUDecoder,
    x: np.ndarray,
    day_idx: int,
    cfg: TrainConfig,
    compute_dtype: torch.dtype = torch.float32,
) -> np.ndarray:
    """Smooth ('valid' padding — the inference-path difference, helpers:92-98)
    then forward one trial on the model's device. Returns (P, 41) float32
    logits."""
    dt = cfg.dataset.data_transforms
    device = model.h0.device
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)[None]
    with torch.inference_mode():
        if dt.smooth_data:
            x = gauss_smooth(x, std=dt.smooth_kernel_std, size=dt.smooth_kernel_size,
                             padding="valid")
        logits = model(x, torch.tensor([day_idx], dtype=torch.long, device=device),
                       compute_dtype=compute_dtype)
    return logits[0].float().cpu().numpy()


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
        p_is.append(model.adjusted_lengths(t_i))
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


def evaluate_session_data(
    model: GRUDecoder,
    cfg: TrainConfig,
    session_data: Iterable[Tuple[str, Dict]],
    eval_type: str = "val",
    decoder: Optional[DecoderService] = None,
    compute_dtype: torch.dtype = torch.float32,
    batched: bool = True,
    verbose: bool = False,
    device_resident: bool = False,
    sessions: Optional[Sequence[str]] = None,
) -> Dict:
    """The evaluation of ``evaluate_sessions`` after the file read:
    ``session_data`` yields (session, the columns ``load_session_file``
    returns) pairs, e.g. ``dict.items()`` of sessions held in memory.
    ``sessions`` is the list a session absent from the training list takes
    its day index from (by default the order of ``session_data``)."""
    with span("eval.call"):
        if device_resident and (
            decoder is None or not hasattr(decoder.searcher, "decode_batches")
        ):
            raise ValueError(
                "device_resident=True requires a device-backend DecoderService"
            )
        trials: List[TrialEval] = []
        dev_batches: List = []
        dev_sizes: List[int] = []
        dev_order: List[int] = []

        # Day indices must match the model's day-layer indices — i.e. the session's
        # position in the TRAINING session list, not in a filtered subset.
        train_sessions = list(cfg.dataset.sessions)

        for n, (session, data) in enumerate(session_data):
            if session in train_sessions:
                day_idx = train_sessions.index(session)
            else:
                day_idx = list(sessions).index(session) if sessions is not None else n
            feats = data["neural_features"]
            if not feats:
                continue
            count("eval.trials", len(feats))
            with span("eval.stage1"):
                if device_resident:
                    base = len(trials)
                    batches_s, sizes_s, order_s, greedy_s = _batched_inference_device(
                        model, feats, day_idx, cfg, compute_dtype
                    )
                    dev_batches.extend(batches_s)
                    dev_sizes.extend(sizes_s)
                    dev_order.extend(base + i for i in order_s)
                    logits_list = [None] * len(feats)
                    decoded_by_i = {
                        i: greedy_collapse(ids) for i, ids in greedy_s.items()
                    }
                elif batched:
                    logits_list = _batched_inference(
                        model, feats, day_idx, cfg, compute_dtype
                    )
                else:
                    logits_list = [
                        run_single_decoding_step(model, f, day_idx, cfg, compute_dtype)
                        for f in feats
                    ]
            for i, logits in enumerate(logits_list):
                decoded = (decoded_by_i[i] if device_resident
                           else greedy_collapse(np.argmax(logits, axis=-1)))
                true_ids = (
                    list(map(int, data["seq_class_ids"][i][: data["seq_len"][i]]))
                    if data["seq_class_ids"][i] is not None and data["seq_len"][i]
                    else None
                )
                trials.append(
                    TrialEval(
                        session=session, day_idx=day_idx,
                        block_num=data["block_num"][i], trial_num=data["trial_num"][i],
                        logits=logits, decoded_ids=decoded, true_ids=true_ids,
                        sentence_label=data["sentence_label"][i],
                    )
                )
                if verbose and true_ids is not None:
                    print(f"{session} b{data['block_num'][i]} t{data['trial_num'][i]}:"
                          f" {' '.join(LOGIT_TO_PHONEME[j] for j in decoded)}")

        out: Dict = {"trials": trials, "eval_type": eval_type}

        # Greedy aggregate PER over trials with labels. Trials carrying only a
        # transcript get a g2p-derived phoneme reference (the reference computes
        # PER targets for arbitrary text via g2p_en — general_utils.py:51-74).
        for t in trials:
            if t.true_ids is None and t.sentence_label:
                t.true_ids = sentence_to_phoneme_ids(t.sentence_label)
        labeled = [t for t in trials if t.true_ids is not None]
        if labeled:
            total_ed = sum(edit_distance(t.true_ids, t.decoded_ids) for t in labeled)
            total_len = sum(len(t.true_ids) for t in labeled)
            out["greedy_PER"] = total_ed / max(total_len, 1)
            day_per: Dict[str, Tuple[int, int]] = {}
            for t in labeled:
                ed = edit_distance(t.true_ids, t.decoded_ids)
                e, l = day_per.get(t.session, (0, 0))
                day_per[t.session] = (e + ed, l + len(t.true_ids))
            out["day_PER"] = {
                s: e / max(l, 1) for s, (e, l) in day_per.items()
            }

        # LM decode → sentences + aggregate WER. decode_utterances runs the whole
        # set through the batched device search when the service uses the device
        # backend; other backends decode serially.
        if decoder is not None:
            t0 = time.time()
            with span("eval.search"):
                if device_resident:
                    # the posteriors on the card feed the device beam search
                    # directly; outputs map back through the bucketing order
                    outs_d = decoder.decode_batched_utterances(dev_batches, dev_sizes)
                    for pos, final in zip(dev_order, outs_d):
                        trials[pos].decoded_sentence = final.sentence
                else:
                    finals: List[FinalOutput] = decoder.decode_utterances(
                        [t.logits for t in trials]
                    )
                    for t, final in zip(trials, finals):
                        t.decoded_sentence = final.sentence
            out["lm_decode_time"] = time.time() - t0
            out["sentences_per_sec"] = len(trials) / max(out["lm_decode_time"], 1e-9)

            refs, hyps = [], []
            for t in trials:
                if t.sentence_label is None:
                    continue
                refs.append(remove_punctuation(t.sentence_label).split())
                hyps.append(remove_punctuation(t.decoded_sentence or "").split())
            if refs:
                agg, lo, hi, per_item = calculate_aggregate_error_rate(refs, hyps, seed=0)
                out["WER"] = agg
                out["WER_CI"] = (lo, hi)
        return out


def evaluate_sessions(
    model: GRUDecoder,
    cfg: TrainConfig,
    data_dir: str,
    eval_type: str = "val",
    sessions: Optional[Sequence[str]] = None,
    decoder: Optional[DecoderService] = None,
    compute_dtype: torch.dtype = torch.float32,
    batched: bool = True,
    verbose: bool = False,
    device_resident: bool = False,
) -> Dict:
    """Run the full eval flow over ``data_dir/<session>/data_<eval_type>.hdf5``
    (sessions without the file are skipped). Returns a dict with per-trial
    results, greedy aggregate PER, and (with a decoder) aggregate WER.

    ``device_resident=True`` (requires a device-backend decoder) keeps the
    RNN posteriors on the card and feeds them straight to the device beam
    search (service.decode_batched_utterances); only greedy argmax ids are
    fetched per trial. TrialEval.logits is None in this mode."""
    sessions = list(sessions if sessions is not None else cfg.dataset.sessions)

    def read():
        for session in sessions:
            path = os.path.join(data_dir, session, f"data_{eval_type}.hdf5")
            if os.path.exists(path):
                yield session, load_session_file(path)

    return evaluate_session_data(
        model, cfg, read(), eval_type=eval_type, decoder=decoder,
        compute_dtype=compute_dtype, batched=batched, verbose=verbose,
        device_resident=device_resident, sessions=sessions,
    )


def write_competition_csv(trials: Sequence[TrialEval], csv_path: str) -> None:
    """Write the 'id,text' submission file (evaluate_model.py:270-274)."""
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "text"])
        for i, t in enumerate(trials):
            writer.writerow([i, t.decoded_sentence or ""])
