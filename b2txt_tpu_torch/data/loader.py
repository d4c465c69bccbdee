"""Batch assembly + host→device prefetch.

Counterpart of ``b2txt_tpu/data/loader.py`` (the reference's
dataset.py:100-159 and the DataLoader prefetch at rnn_trainer.py:197-203).
Batches are padded to bucketed shapes (time rounded up to ``time_bucket``,
labels to ``label_bucket``) as in the JAX package; padding is masked
downstream by n_time_steps / phone_seq_lens.

The padding is ``collate``, a function of in-memory trials, so a
``BatchLoader`` serves trials from HDF5 sessions (h5py is imported only
then) or from memory (``trials=``). ``prefetch_iterator`` assembles batches
on a background thread and copies them to the card from pinned host memory
without blocking.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .hdf5_store import Trial, read_trial
from .sampler import BatchSampler

_FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# what a step reads; the rest of a batch stays in numpy for the host metrics
DEVICE_FIELDS = ("input_features", "seq_class_ids", "n_time_steps", "phone_seq_lens",
                 "day_indicies")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def collate(
    trials: Sequence[Trial], days: Sequence[int], time_bucket: int = 256,
    label_bucket: int = 64, max_chars: int = 500,
) -> Dict[str, np.ndarray]:
    """Pad trials (with their day indices) into one numpy batch, as the
    JAX package's ``BatchLoader.get_batch`` does."""
    B = len(trials)
    D = trials[0].input_features.shape[1]
    labels = [tr.seq_class_ids if tr.seq_class_ids is not None else np.zeros((0,), np.int32)
              for tr in trials]
    T_pad = _round_up(max(tr.input_features.shape[0] for tr in trials), time_bucket)
    S_pad = _round_up(max(max(len(l) for l in labels), 1), label_bucket)
    batch = {
        "input_features": np.zeros((B, T_pad, D), np.float32),
        "seq_class_ids": np.zeros((B, S_pad), np.int32),
        "n_time_steps": np.asarray([tr.n_time_steps for tr in trials], np.int32),
        "phone_seq_lens": np.asarray([tr.seq_len or 0 for tr in trials], np.int32),
        "day_indicies": np.asarray(days, np.int32),
        "block_nums": np.asarray([tr.block_num for tr in trials], np.int32),
        "trial_nums": np.asarray([tr.trial_num for tr in trials], np.int32),
        "transcriptions": np.zeros((B, max_chars), np.uint8),
    }
    for i, (tr, l) in enumerate(zip(trials, labels)):
        f = tr.input_features
        batch["input_features"][i, : f.shape[0]] = f
        batch["seq_class_ids"][i, : len(l)] = l
        tx = tr.transcription if tr.transcription is not None else np.zeros((0,), np.uint8)
        batch["transcriptions"][i, : min(len(tx), max_chars)] = tx[:max_chars]
    return batch


class BatchLoader:
    """Assembles padded numpy batches from a BatchSampler, over HDF5
    sessions (``trial_indices[day]['session_path']``) or, with ``trials``
    ({day: [Trial, ...]}), over trials in memory. ``transfer_dtype`` is the
    dtype in which ``prefetch_iterator`` sends the features to the card
    ("bfloat16" halves the bytes; the step upcasts)."""

    def __init__(
        self,
        sampler: BatchSampler,
        time_bucket: int = 256,
        label_bucket: int = 64,
        max_chars: int = 500,
        feature_subset: Optional[Sequence[int]] = None,
        transfer_dtype: str = "float32",
        trials: Optional[Dict[int, List[Trial]]] = None,
    ):
        self.sampler = sampler
        self.time_bucket = time_bucket
        self.label_bucket = label_bucket
        self.max_chars = max_chars
        self.feature_subset = feature_subset or sampler.feature_subset
        self.trials = trials
        if transfer_dtype not in _FEATURE_DTYPES:
            raise ValueError(f"transfer_dtype must be float32|bfloat16, got {transfer_dtype!r}")
        self.feature_dtype = _FEATURE_DTYPES[transfer_dtype]

    def __len__(self) -> int:
        return len(self.sampler)

    def _trials_of_day(self, d: int, idxs) -> List[Trial]:
        if self.trials is not None:
            out = [self.trials[d][int(t)] for t in idxs]
            if self.feature_subset:
                cols = list(self.feature_subset)
                out = [Trial(**{**tr.__dict__, "input_features": tr.input_features[:, cols]})
                       for tr in out]
            return out
        import h5py  # only HDF5 sessions need h5py

        path = self.sampler.trial_indices[d]["session_path"]
        out = []
        with h5py.File(path, "r") as f:
            for t in idxs:
                try:
                    out.append(read_trial(f, int(t), self.feature_subset))
                except Exception as e:  # parity: dataset.py:144-146
                    print(f"Error loading trial {t} from session {path}: {e}")
        return out

    def get_batch(self, idx: int) -> Dict[str, np.ndarray]:
        index = self.sampler.batch_index[idx]
        trials: List[Trial] = []
        days: List[int] = []
        for d in index.keys():
            got = self._trials_of_day(d, index[d])
            trials.extend(got)
            days.extend([int(d)] * len(got))
        return collate(trials, days, self.time_bucket, self.label_bucket, self.max_chars)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self.get_batch(i)


def batch_to_device(
    batch: Dict[str, np.ndarray], device, feature_dtype: torch.dtype = torch.float32,
) -> Dict[str, object]:
    """Numpy batch → the ``DEVICE_FIELDS`` as tensors on ``device``:
    features in ``feature_dtype``, integer fields as int64. On a CUDA device
    the copies leave pinned host memory without blocking. The other fields
    pass through."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out: Dict[str, object] = {}
    for k, v in batch.items():
        if k not in DEVICE_FIELDS:
            out[k] = v
            continue
        t = torch.from_numpy(v)
        t = t.to(feature_dtype) if k == "input_features" else t.long()
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


def prefetch_iterator(loader: BatchLoader, device, prefetch: int = 2) -> Iterator[Dict[str, object]]:
    """Background-thread batch assembly (the DataLoader workers' role):
    each batch arrives with its step fields as tensors on ``device`` (on a
    card: pinned, non-blocking copies in ``loader.feature_dtype``, issued
    from the worker thread so they overlap the previous step)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    errors: list = []

    def worker():
        try:
            for batch in loader:
                q.put(batch_to_device(batch, device, loader.feature_dtype))
        except BaseException as e:  # re-raised in the consuming thread
            errors.append(e)
        finally:
            q.put(sentinel)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        yield item
    if errors:
        raise errors[0]
