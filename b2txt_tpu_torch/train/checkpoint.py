"""Checkpoint save/load: parameters + optimizer state + step + metrics.

Counterpart of ``b2txt_tpu/train/checkpoint.py`` (the reference's
rnn_trainer.py:365-406). The file is a pickle of numpy arrays: the
parameters under the reference checkpoint's names (``day_weights.{i}``,
``gru.weight_ih_l{k}``, ..., ``h0``) and the optimizer's ``state_dict`` with
its tensors as numpy arrays, so it loads without torch. The JAX package's
Orbax format has no counterpart here.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch


def to_numpy_tree(tree: Any) -> Any:
    """Tensors → numpy arrays, through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return tree


def to_tensor_tree(tree: Any) -> Any:
    """Numpy arrays → tensors, through dicts, lists and tuples."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True))
    if isinstance(tree, dict):
        return {k: to_tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_tensor_tree(v) for v in tree)
    return tree


def save_checkpoint(
    path: str,
    params: Any,
    opt_state: Any = None,
    step: int = 0,
    val_per: float = float("inf"),
    val_loss: float = float("inf"),
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ckpt = {
        "params": to_numpy_tree(params),
        "opt_state": to_numpy_tree(opt_state) if opt_state is not None else None,
        "step": int(step),
        "val_PER": float(val_per),
        "val_loss": float(val_loss),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ckpt, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)
