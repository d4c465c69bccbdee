"""HDF5 session store: trial metadata scan, train/test splits, trial reads.

Parity targets: ``model_training/dataset.py:244-334`` (train_test_split_indicies,
including bad_trials_dict exclusion and the session-name extraction), the
per-trial group layout ``trial_%04d`` with datasets ``input_features`` (T, 512),
``seq_class_ids``, ``transcription`` and attrs ``n_time_steps, seq_len,
block_num, trial_num, session, sentence_label`` (dataset.py:121-142), and the
full-file loader of ``evaluate_model_helpers.py:29-77``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Trial:
    """One decoded trial: features + labels + metadata."""

    input_features: np.ndarray  # (T, D) float32
    seq_class_ids: Optional[np.ndarray]  # (S,) int
    transcription: Optional[np.ndarray]  # (max_chars,) uint8, 0-terminated
    n_time_steps: int
    seq_len: Optional[int]
    block_num: int
    trial_num: int
    session: str
    sentence_label: Optional[str]


def session_name_from_path(path: str) -> str:
    """Extract the session directory name (t15.20xx.xx.xx / t12.*) from a path
    (parity: dataset.py:272)."""
    for s in path.split("/"):
        if s.startswith("t15.20") or s.startswith("t12.20"):
            return s
    # Fall back to the parent directory name for non-reference layouts.
    return os.path.basename(os.path.dirname(path))


def read_trial(f: h5py.File, t: int, feature_subset: Optional[Sequence[int]] = None) -> Trial:
    g = f[f"trial_{t:04d}"]
    feats = g["input_features"][:]
    if feature_subset:
        feats = feats[:, list(feature_subset)]
    return Trial(
        input_features=np.asarray(feats, dtype=np.float32),
        seq_class_ids=(g["seq_class_ids"][:] if "seq_class_ids" in g else None),
        transcription=(g["transcription"][:] if "transcription" in g else None),
        n_time_steps=int(g.attrs["n_time_steps"]),
        seq_len=(int(g.attrs["seq_len"]) if "seq_len" in g.attrs else None),
        block_num=int(g.attrs["block_num"]),
        trial_num=int(g.attrs["trial_num"]),
        session=str(g.attrs.get("session", "")),
        sentence_label=(
            str(g.attrs["sentence_label"]) if "sentence_label" in g.attrs else None
        ),
    )


def load_session_file(file_path: str) -> Dict[str, list]:
    """Load every trial in a session file into column lists
    (parity: evaluate_model_helpers.py:29-77, minus the corpus CSV join which
    lives in evaluate.harness)."""
    data: Dict[str, list] = {
        "neural_features": [], "n_time_steps": [], "seq_class_ids": [],
        "seq_len": [], "transcriptions": [], "sentence_label": [],
        "session": [], "block_num": [], "trial_num": [],
    }
    import h5py  # only HDF5 sessions need h5py

    with h5py.File(file_path, "r") as f:
        for key in list(f.keys()):
            g = f[key]
            data["neural_features"].append(np.asarray(g["input_features"][:], np.float32))
            data["n_time_steps"].append(int(g.attrs["n_time_steps"]))
            data["seq_class_ids"].append(
                g["seq_class_ids"][:] if "seq_class_ids" in g else None
            )
            data["seq_len"].append(
                int(g.attrs["seq_len"]) if "seq_len" in g.attrs else None
            )
            data["transcriptions"].append(
                g["transcription"][:] if "transcription" in g else None
            )
            data["sentence_label"].append(
                str(g.attrs["sentence_label"]) if "sentence_label" in g.attrs else None
            )
            data["session"].append(str(g.attrs.get("session", "")))
            data["block_num"].append(int(g.attrs["block_num"]))
            data["trial_num"].append(int(g.attrs["trial_num"]))
    return data


def train_test_split_indices(
    file_paths: Sequence[str],
    test_percentage: float = 0.1,
    seed: int = -1,
    bad_trials_dict: Optional[Dict[str, Dict[str, List[int]]]] = None,
):
    """Split trials per day into train/test index dicts.

    Returns two dicts {day: {'trials': [...], 'session_path': path}} with the
    reference's exact semantics (dataset.py:244-334): legacy np.random seeding,
    0/1 shortcut paths, max(1, int(n*pct)) test count, choice without
    replacement.
    """
    if seed != -1:
        np.random.seed(seed)

    trials_per_day = {}
    for i, path in enumerate(file_paths):
        session = session_name_from_path(path)
        good: List[int] = []
        if os.path.exists(path):
            import h5py  # only HDF5 sessions need h5py

            with h5py.File(path, "r") as f:
                num_trials = len(list(f.keys()))
                for t in range(num_trials):
                    key = f"trial_{t:04d}"
                    block_num = f[key].attrs["block_num"]
                    trial_num = f[key].attrs["trial_num"]
                    if (
                        bad_trials_dict is not None
                        and session in bad_trials_dict
                        and str(block_num) in bad_trials_dict[session]
                        and trial_num in bad_trials_dict[session][str(block_num)]
                    ):
                        continue
                    good.append(t)
        trials_per_day[i] = {
            "num_trials": len(good),
            "trial_indices": good,
            "session_path": path,
        }

    train_trials: Dict[int, Dict[str, Any]] = {}
    test_trials: Dict[int, Dict[str, Any]] = {}
    for day, info in trials_per_day.items():
        all_idx = info["trial_indices"]
        sp = info["session_path"]
        if test_percentage == 0:
            train_trials[day] = {"trials": all_idx, "session_path": sp}
            test_trials[day] = {"trials": [], "session_path": sp}
        elif test_percentage == 1:
            train_trials[day] = {"trials": [], "session_path": sp}
            test_trials[day] = {"trials": all_idx, "session_path": sp}
        else:
            num_test = max(1, int(info["num_trials"] * test_percentage))
            test_idx = np.random.choice(all_idx, size=num_test, replace=False).tolist()
            train_idx = [i for i in all_idx if i not in test_idx]
            train_trials[day] = {"trials": train_idx, "session_path": sp}
            test_trials[day] = {"trials": test_idx, "session_path": sp}
    return train_trials, test_trials


def write_session_file(
    file_path: str,
    trials: Sequence[Dict[str, Any]],
) -> None:
    """Write trials to the reference HDF5 layout (used by tests + synthetic data).

    Each trial dict needs: input_features (T, D), seq_class_ids (S,),
    transcription (uint8, 0-terminated), block_num, trial_num, session,
    sentence_label.
    """
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    import h5py  # only HDF5 sessions need h5py

    with h5py.File(file_path, "w") as f:
        for t, tr in enumerate(trials):
            g = f.create_group(f"trial_{t:04d}")
            feats = np.asarray(tr["input_features"], dtype=np.float32)
            g.create_dataset("input_features", data=feats)
            if tr.get("seq_class_ids") is not None:
                g.create_dataset(
                    "seq_class_ids", data=np.asarray(tr["seq_class_ids"], np.int32)
                )
                g.attrs["seq_len"] = len(tr["seq_class_ids"])
            if tr.get("transcription") is not None:
                g.create_dataset(
                    "transcription", data=np.asarray(tr["transcription"], np.uint8)
                )
            g.attrs["n_time_steps"] = feats.shape[0]
            g.attrs["block_num"] = int(tr.get("block_num", 0))
            g.attrs["trial_num"] = int(tr.get("trial_num", t))
            g.attrs["session"] = str(tr.get("session", ""))
            if tr.get("sentence_label") is not None:
                g.attrs["sentence_label"] = str(tr["sentence_label"])
