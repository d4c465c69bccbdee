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
sys.modules["triton"] = None       # no module imports triton; h5py, PyYAML and redis
sys.modules["h5py"] = None         # load only inside the functions that need them
sys.modules["yaml"] = None
sys.modules["redis"] = None
sys.modules["regex"] = None        # the card host has neither: utils/bpe.py and
sys.modules["transformers"] = None # decode/rescore.py import them inside functions
sys.modules["matplotlib"] = None   # analysis/plots.py, reached only when a figure is drawn
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
    # analysis/plots.py draws the figures: the one module that needs matplotlib
    failed = report["failed"]
    assert set(failed) == {"b2txt_tpu_torch.analysis.plots"}, failed
    assert "matplotlib" in failed["b2txt_tpu_torch.analysis.plots"]
    expected = {"b2txt_tpu_torch.ops.gru", "b2txt_tpu_torch.serve.service",
                "b2txt_tpu_torch.evaluate.harness", "b2txt_tpu_torch.decode.lmbeam",
                "b2txt_tpu_torch.ops.augment", "b2txt_tpu_torch.ops.preprocess",
                "b2txt_tpu_torch.ops.ctc", "b2txt_tpu_torch.train.trainer",
                "b2txt_tpu_torch.train.optimizer", "b2txt_tpu_torch.train.checkpoint",
                "b2txt_tpu_torch.data.loader", "b2txt_tpu_torch.data.sampler",
                "b2txt_tpu_torch.data.hdf5_store", "b2txt_tpu_torch.utils.logging",
                "b2txt_tpu_torch.lm.device_ngram", "b2txt_tpu_torch.decode.lmbeam_device",
                "b2txt_tpu_torch.ops.gather", "b2txt_tpu_torch.scripts.profile_gather",
                "b2txt_tpu_torch.runtime", "b2txt_tpu_torch.serve.redis_adapter",
                "b2txt_tpu_torch.serve.redis_client", "b2txt_tpu_torch.serve.fakeredis",
                "b2txt_tpu_torch.utils.g2p", "b2txt_tpu_torch.utils.lts",
                "b2txt_tpu_torch.data.real_assets", "b2txt_tpu_torch.evaluate.golden",
                "b2txt_tpu_torch.scripts.evaluate_model",
                "b2txt_tpu_torch.scripts.language_model_standalone",
                "b2txt_tpu_torch.decode.opt_lm", "b2txt_tpu_torch.decode.device_lm",
                "b2txt_tpu_torch.decode.packed_scorer", "b2txt_tpu_torch.decode.deepseek_lm",
                "b2txt_tpu_torch.ops.moe",
                "b2txt_tpu_torch.decode.prefix_beam", "b2txt_tpu_torch.decode.prefix_beam_device",
                "b2txt_tpu_torch.lm.corpus", "b2txt_tpu_torch.utils.bpe",
                "b2txt_tpu_torch.utils.profiling", "b2txt_tpu_torch.data.adversarial",
                "b2txt_tpu_torch.data.download", "b2txt_tpu_torch.analysis",
                "b2txt_tpu_torch.analysis.figures", "b2txt_tpu_torch.analysis.notebook_data",
                "b2txt_tpu_torch.ops.segment", "b2txt_tpu_torch.scripts.train_model",
                "b2txt_tpu_torch.scripts.convert_checkpoint", "b2txt_tpu_torch.scripts.build_lm",
                "b2txt_tpu_torch.scripts.decode_logits", "b2txt_tpu_torch.scripts.download_data",
                "b2txt_tpu_torch.scripts.eval_45session_sim", "b2txt_tpu_torch.scripts.world",
                "b2txt_tpu_torch.scripts.quality_ladder", "b2txt_tpu_torch.examples",
                "b2txt_tpu_torch.examples.quickstart", "b2txt_tpu_torch.examples.streaming_demo",
                "b2txt_tpu_torch.examples.conversation_demo",
                "b2txt_tpu_torch.examples.lattice_demo", "b2txt_tpu_torch.examples.spelling_demo",
                "b2txt_tpu_torch.examples.figures_demo", "b2txt_tpu_torch.scripts.bench",
                "b2txt_tpu_torch.scripts.bench_device_decode",
                "b2txt_tpu_torch.scripts.bench_opt", "b2txt_tpu_torch.scripts.bench_streaming",
                "b2txt_tpu_torch.scripts.bench_training",
                "b2txt_tpu_torch.scripts.profile_train_step",
                "b2txt_tpu_torch.scripts.profile_device_step",
                "b2txt_tpu_torch.scripts.drive_large_lm"}
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
    from b2txt_tpu_torch.decode import DeviceCausalLMRescorer
    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        OPTRescorer(OPTConfig.tiny())
    from b2txt_tpu_torch.decode.deepseek_lm import DeepseekV2Config, DeepseekV2Rescorer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepseekV2Rescorer(DeepseekV2Config.tiny(), lambda t, n: [2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCausalLMRescorer()
    assert resolve_device("cpu") == torch.device("cpu")
