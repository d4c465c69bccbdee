"""The port stands alone: no module of b2txt_tpu_torch (nor chip_smoke.py)
imports JAX or the JAX package, and its entry points want the card unless
told otherwise."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "b2txt_tpu_torch"

_CHILD = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["b2txt_tpu"] = None
sys.modules["triton"] = None       # triton and h5py load only inside functions
sys.modules["h5py"] = None
import b2txt_tpu_torch
names = ["b2txt_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(b2txt_tpu_torch.__path__, "b2txt_tpu_torch.")
]
failed = {}
for name in names:
    try:
        importlib.import_module(name)
    except Exception as e:  # report every module, not just the first
        failed[name] = repr(e)
print(json.dumps({"names": names, "failed": failed}))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["failed"] == {}
    expected = {"b2txt_tpu_torch.ops.gru", "b2txt_tpu_torch.serve.service",
                "b2txt_tpu_torch.evaluate.harness", "b2txt_tpu_torch.decode.lmbeam",
                "b2txt_tpu_torch.ops.augment", "b2txt_tpu_torch.ops.preprocess",
                "b2txt_tpu_torch.ops.ctc", "b2txt_tpu_torch.train.trainer",
                "b2txt_tpu_torch.train.optimizer", "b2txt_tpu_torch.train.checkpoint",
                "b2txt_tpu_torch.data.loader", "b2txt_tpu_torch.data.sampler",
                "b2txt_tpu_torch.data.hdf5_store", "b2txt_tpu_torch.utils.logging"}
    assert expected <= set(report["names"])


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_source_names_jax(path):
    """Covers imports inside functions too, which the import test cannot see."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "b2txt_tpu"), f"{path} imports {m}"


def test_entry_points_want_the_card(monkeypatch):
    from b2txt_tpu_torch.models import GRUDecoder
    from b2txt_tpu_torch.utils import TrainConfig, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = TrainConfig().model
    cfg.n_input_features, cfg.n_units, cfg.n_layers = 8, 8, 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRUDecoder(cfg, n_days=2, n_classes=41)
    assert resolve_device("cpu") == torch.device("cpu")
