"""The harness: finds a cell's pieces by name, runs it, prints its line.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

* the configuration: ``configs/<config>.json`` (as the manifest's ``file``);
* the traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  driver in ``drivers/<kind>.py`` that runs that kind of traffic;
* the comparison's limits: ``limits/<workload>.json``;
* each per-layer metric: ``metrics/<metric>.py``, whose ``read(run)``
  returns the value or None when the run holds nothing to read.

A driver is a class ``Cell(config, traffic, seed, device)`` with
``setup()``, ``window(seconds)``, ``end_to_end() -> {metric: value}``,
``traced()`` (a bounded part of the traffic, run under the profiler),
``detail()`` (a few figures for reading a run), ``free()`` and
``check(control="") -> {number: value}``, with ``attempted``, ``failed``
and ``spans`` (a ``Spans``) as attributes.
``run(...)`` drives one cell through set-up, the window, the optional trace
and the comparison, and returns the contract's result object.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# module top-level names that may never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "b2txt_tpu")


def load_manifest(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_workload(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def find_config(manifest: Dict[str, Any], name: str, root: str = ROOT) -> Dict[str, Any]:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def load_json(root: str, *parts: str) -> Dict[str, Any]:
    with open(os.path.join(root, "benchmark", *parts)) as f:
        return json.load(f)


def load_traffic(name: str, root: str = ROOT) -> Dict[str, Any]:
    return load_json(root, "traffic", f"{name}.json")


def load_limits(workload: str, root: str = ROOT) -> Dict[str, float]:
    return load_json(root, "limits", f"{workload}.json")


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}").Cell


def metric_reader(name: str, root: str = ROOT) -> Callable:
    return _load_module(os.path.join(root, "benchmark", "metrics", f"{name}.py"),
                        "benchmark_metric_" + name.replace(".", "_").replace("-", "_")).read


def metrics_for(manifest: Dict[str, Any], section: str, workload: str) -> List[Dict[str, Any]]:
    """The cell's metrics of ``section``: those that list it, and those
    without a ``workloads`` key whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in metrics_for_e2e(manifest, workload)}
    out = []
    for m in manifest[section]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out


def metrics_for_e2e(manifest: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one the
    port must not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def quartile_spread(values: List[float]) -> float:
    """(Q3 - Q1) / median, with Python's default quantile method."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else math.inf


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Spans:
    """Host-clock spans and counters the benchmark records around the
    program's calls: ``add(name, seconds)``, ``count(name, n)``."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


class Run:
    """What a per-layer metric's reader sees: the cell's name, its config
    and traffic, the driver's spans and counters, and the trace summary."""

    def __init__(self, workload: str, config: Dict, traffic: Dict, cell, trace):
        self.workload = workload
        self.config = config
        self.traffic = traffic
        self.cell = cell
        self.spans = cell.spans.spans
        self.counters = cell.spans.counters
        self.trace = trace


def device_info(device, count: int) -> Dict[str, Any]:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        root: str = ROOT, control: str = "", manifest=None) -> Dict[str, Any]:
    """One run of ``workload``; returns the result object (the contract's
    keys, with ``limits`` last). ``device`` None means the CUDA card;
    ``control`` ("fp8", or "half_batch" for training) puts the reference's
    control or a fault in the program's place for the comparison."""
    import torch

    manifest = manifest or load_manifest(root)
    wl = find_workload(manifest, workload)
    config = find_config(manifest, wl["config"], root)
    traffic = load_traffic(wl["traffic"], root)
    limits = load_limits(workload, root)
    if device is None:
        device = torch.device("cuda")
    device = torch.device(device)

    t0 = time.perf_counter()
    cell = driver_class(traffic["kind"])(config, traffic, seed, device)
    cell.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    cell.window(seconds)
    metrics: Dict[str, Dict[str, Any]] = {}
    dev = device_info(device, int(wl["chips"]))
    if trace:
        from .trace import profile

        summary = profile(cell.traced, device)
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        dev["memory_peak_bytes"] = device_info(device, int(wl["chips"]))["memory_peak_bytes"]
        r = Run(workload, config, traffic, cell, summary)
        for m in metrics_for(manifest, "per_layer", workload):
            v = metric_reader(m["name"], root)(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = summary.breakdown()
    else:
        e2e = cell.end_to_end()
        e2e["setup_s"] = setup_s
        for m in metrics_for_e2e(manifest, workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        breakdown = None

    attempted, failed = cell.attempted, cell.failed
    cell.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check(control=control)
    gc.collect()
    found = forbidden_modules()
    # a number that is not finite has failed; JSON has no infinity, so it is
    # printed as the largest float
    compared = {k: {"value": float(v) if math.isfinite(v) else sys.float_info.max,
                    "limit": limits[k]} for k, v in numbers.items()}
    correct = bool(compared) and all(c["value"] <= c["limit"] for c in compared.values())
    out: Dict[str, Any] = {"correct": correct and failed == 0, "attempted": attempted,
                           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["detail"] = cell.detail()
    out["limits"] = compared
    out["forbidden_modules"] = found
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell on the CUDA card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=[0, 1])
    p.add_argument("--control", nargs="?", const="fp8", default="",
                   choices=["fp8", "half_batch"],
                   help="put the reference's control (fp8: the precision below the "
                        "configuration's; half_batch: a training loss over half the rows) "
                        "in the program's place for the comparison; measures the limits, "
                        "a check never passes it")
    args = p.parse_args(argv)

    import torch

    manifest = load_manifest()
    wl = find_workload(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), manifest=manifest,
              control=args.control)
    found = out.pop("forbidden_modules")
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in out["limits"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
