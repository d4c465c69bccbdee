"""The per-layer metrics read from the program's own spans and counters
(``b2txt_tpu_torch.utils.profiling.records()``): on the tiny CPU cells each
span metric reads a finite value, except the device search's wait (no event
to wait on off the card), and the launch counts read nothing (no CUDA launch
calls); against a program without the tracer every reader returns None."""

from __future__ import annotations

import math
import os

import pytest

from benchmark import harness

SPANS = {
    "tiny-eval": (["eval.stage1_ms_per_trial", "eval.search_issue_us_per_frame",
                   "eval.extract_ms"], ["eval.search_wait_us_per_frame"]),
    "tiny-online": (["online.native_ms", "online.llm_issue_ms", "online.llm_wait_ms"],
                    ["online.llm_launches"]),
    "tiny-train": (["train.optimizer_ms"], ["train.step_launches"]),
}
NEW = [m for read, silent in SPANS.values() for m in read + silent]


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_span_metrics_read_on_the_cpu(tiny_root, cell):
    out = harness.run(cell, 2 ** 40 + 5, 1.0, True, device="cpu", root=tiny_root)
    assert out["correct"], out["limits"]
    read, silent = SPANS[cell]
    for name in read:
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    for name in silent:
        assert name not in out["metrics"]


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_without_the_tracer(tiny_root, monkeypatch, name):
    from b2txt_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    monkeypatch.delattr(profiling, "counters")

    class Run:
        trace = None

    assert os.path.exists(os.path.join(tiny_root, "benchmark", "metrics", f"{name}.py"))
    assert harness.metric_reader(name, tiny_root)(Run()) is None
