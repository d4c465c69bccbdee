"""Runs of one cell, each a fresh process as a check makes them, and the
spread of each metric.

    python3 benchmark/spread.py --workload <cell> --seeds 11,12,13 --seconds 30 \\
        [--trace 0] [--control] [--out chiprun_out/<file>.jsonl]

Each run is ``benchmark/run.py`` with one seed; its last stdout line (the
result), the end of its stderr, its exit code and wall time go to ``--out``
as one JSON line. The summary printed at the end gives, per metric and per
compared number, every reading, the median and the quartile spread
((Q3 - Q1) / median, Python's ``statistics.quantiles``), and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.harness import quartile_spread  # noqa: E402


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--control", default="", choices=["", "fp8", "half_batch"])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    print(power_limit(), flush=True)
    for seed in seeds:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        if args.control:
            cmd += ["--control", args.control]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result,
               "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        lim = {k: v["value"] for k, v in (result or {}).get("limits", {}).items()}
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"), "metrics": brief,
                          "limits": lim}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
    summary = {}
    for key in ("metrics", "limits"):
        names = sorted({n for r in rows if r["result"] for n in r["result"][key]})
        for n in names:
            vals = [r["result"][key][n]["value"] for r in rows
                    if r["result"] and n in r["result"][key]]
            entry = {"values": vals, "median": statistics.median(vals)}
            if len(vals) >= 2:
                entry["spread"] = quartile_spread(vals)
            summary[f"{key}.{n}"] = entry
    print(json.dumps({"summary": summary}), flush=True)
    print(power_limit(), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
