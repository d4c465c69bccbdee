"""The manifest, the harness's lookups by name, the statistics and the
refusals, on the CPU."""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(ROOT)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]] \
        + [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in manifest["end_to_end"])
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_piece_is_found_by_name(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        assert w["chips"] == 1
        cfg = harness.find_config(manifest, w["config"], ROOT)
        assert cfg["reduced"] == []
        traffic = harness.load_traffic(w["traffic"], ROOT)
        assert hasattr(harness.driver_class(traffic["kind"]), "check")
        limits = harness.load_limits(w["name"], ROOT)
        assert limits and all(v > 0 for v in limits.values())
        reported = {m["name"] for m in harness.metrics_for_e2e(manifest, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_for(manifest, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in reported and m["moves"] in e2e
            assert callable(harness.metric_reader(m["name"], ROOT))


def test_metrics_of_one_layer_share_its_name(manifest):
    for m in manifest["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_percentile_is_over_all_values():
    xs = list(np.random.default_rng(0).exponential(size=401))
    assert harness.percentile(xs, 95) == pytest.approx(float(np.percentile(xs, 95)))
    assert harness.percentile(xs, 50) == pytest.approx(statistics.median(xs))
    assert harness.percentile([3.0], 95) == 3.0


def test_quartile_spread_uses_python_quantiles():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert harness.quartile_spread(vals) == pytest.approx((q3 - q1) / med)


def test_rates_are_over_the_whole_window():
    from benchmark.drivers.online import Cell as Online
    from benchmark.drivers.session_eval import Cell as Eval

    e = Eval.__new__(Eval)
    e.attempted, e.window_s = 300, 12.5
    assert e.end_to_end() == {"sentences_per_s": 24.0}
    o = Online.__new__(Online)
    o.spans = harness.Spans()
    for s in [0.05] * 95 + [0.5] * 5:
        o.spans.add("sentence", s)
    got = o.end_to_end()
    assert got["sentence_ms_p50"] == pytest.approx(50.0)
    assert got["sentence_ms_p95"] == pytest.approx(harness.percentile([50.0] * 95 + [500.0] * 5, 95))


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "b2txt_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "b2txt_tpu.models", types.ModuleType("b2txt_tpu.models"))
    assert harness.forbidden_modules() == ["b2txt_tpu", "jax"]


def test_no_module_of_jax_or_the_jax_package_in_the_benchmark():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|b2txt_tpu)(\s|\.|$)", re.M)
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_reference_imports_nothing_of_the_program():
    pat = re.compile(r"^\s*(from|import)\s+(b2txt_tpu|benchmark\.(?!reference))", re.M)
    d = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(d):
        if f.endswith(".py"):
            with open(os.path.join(d, f)) as fh:
                assert not pat.search(fh.read()), f


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                           "--workload", "eval-device-b32", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_a_directory_without_the_program_fails(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "eval-device-b32",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and "correct" not in proc.stdout
