"""Fixtures for the benchmark's CPU tests: a throwaway checkout holding the
benchmark, tiny cells of each kind added as new files and manifest entries,
and the program linked in."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = dict(n_input_features=32, n_units=64, n_days=4)
TINY_OPT = dict(vocab_size=97, hidden_size=32, ffn_dim=64, num_layers=2, num_heads=4,
                max_position_embeddings=64)
# read from sound tiny runs on the CPU (bf16 there too), with room
TINY_LIMITS = {
    "tiny-eval": {"posterior_gap": 0.8, "score_gap": 1.0, "best_gap": 0.5},
    "tiny-eval-native": {"posterior_gap": 0.8, "score_gap": 1.0, "best_gap": 0.5},
    "tiny-online": {"posterior_gap": 0.8, "llm_gap": 0.006, "blend_gap": 0.005},
    "tiny-train": {"loss_gap": 0.005, "grad_gap": 0.01, "change_gap": 0.01,
                   "draws_gap": 6.0},
}


def _json(path, obj=None):
    if obj is None:
        with open(path) as f:
            return json.load(f)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny_checkout(dst: str) -> str:
    """A copy of the benchmark with a tiny cell of each kind added: new
    files under configs/, traffic/ and limits/, new manifest entries, no
    existing file changed."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(ROOT, "b2txt_tpu_torch"), os.path.join(dst, "b2txt_tpu_torch"))
    b = os.path.join(dst, "benchmark")
    m = _json(os.path.join(ROOT, "BENCHMARK.json"))
    base = _json(os.path.join(b, "configs", "nejm-gru5x768.json"))
    base["model"].update(TINY_MODEL)
    base["world"]["vocab_size"] = 300
    base["train"].update(batch_size=8, days_per_batch=2)
    _json(os.path.join(b, "configs", "tiny.json"), base)
    opt = _json(os.path.join(b, "configs", "nejm-gru5x768-opt6.7b.json"))
    opt["model"].update(TINY_MODEL)
    opt["world"]["vocab_size"] = 300
    opt["opt"] = dict(TINY_OPT)
    opt["rescorer"]["max_len"] = 32
    _json(os.path.join(b, "configs", "tiny-opt.json"), opt)
    for name in ("tiny", "tiny-opt"):
        m["configs"].append({"name": name, "source": "https://example.org/tiny",
                             "file": f"benchmark/configs/{name}.json", "reduced": [],
                             "why": "a tiny copy for the CPU tests"})
    traffic = {
        "tiny-eval": ("sessions-b32", "tiny", "eval-device-b32",
                      dict(calls=1, sessions_per_call=2, trials_per_session=[3, 5],
                           bins=[360, 420], check_trials=4)),
        # the same sessions on the host's native searcher: a traffic file only
        "tiny-eval-native": ("sessions-b32", "tiny", "eval-device-b32",
                             dict(calls=1, sessions_per_call=2, trials_per_session=[3, 5],
                                  bins=[360, 420], check_trials=4,
                                  searcher_backend="native")),
        "tiny-online": ("online-trials", "tiny-opt", "online-native-opt",
                        # the full cell's signal to noise at 32 features:
                        # 1.5 * sqrt(32 / 512)
                        dict(pool=6, check_trials=3, trace_trials=2, feature_noise=0.375)),
        "tiny-train": ("train-b64", "tiny", "train-b64",
                       dict(trials_per_day=6, bins=[360, 420], trace_steps=2)),
    }
    for cell, (src, config, like, upd) in traffic.items():
        t = _json(os.path.join(b, "traffic", f"{src}.json"))
        t.update(upd)
        _json(os.path.join(b, "traffic", f"{cell}.json"), t)
        _json(os.path.join(b, "limits", f"{cell}.json"), TINY_LIMITS[cell])
        m["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                               "why": "a tiny cell for the CPU tests"})
        for metric in m["end_to_end"] + m["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
    _json(os.path.join(dst, "BENCHMARK.json"), m)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_checkout(str(tmp_path_factory.mktemp("checkout")))
