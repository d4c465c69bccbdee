"""``eval.search_graph_share``: the share of the device search's frames run
as replays of a captured CUDA graph, from the program's counters. It reads
100 when every frame replayed, and nothing where the program has no replay
counter (a program before the graph, or the eager loop on the CPU)."""

from __future__ import annotations

import pytest

from benchmark import harness

NAME = "eval.search_graph_share"


class _Run:
    trace = None


@pytest.mark.parametrize("counters,want", [
    ({"search.frames": 164, "search.graph_frames": 164, "search.graph_captures": 1}, 100.0),
    ({"search.frames": 200, "search.graph_frames": 50}, 25.0),
    ({"search.frames": 164}, None),
    ({"search.frames": 0, "search.graph_frames": 0}, None),
    ({}, None),
])
def test_graph_share_from_the_counters(tiny_root, monkeypatch, counters, want):
    from b2txt_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    assert harness.metric_reader(NAME, tiny_root)(_Run()) == want


def test_graph_share_silent_without_the_counters_module(tiny_root, monkeypatch):
    from b2txt_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert harness.metric_reader(NAME, tiny_root)(_Run()) is None


def test_graph_share_silent_on_the_cpu(tiny_root):
    """The tiny eval cell searches on the CPU, op by op: the traced run's
    line leaves the share out and keeps the search's other metrics."""
    out = harness.run("tiny-eval", 2 ** 40 + 7, 1.0, True, device="cpu", root=tiny_root)
    assert NAME not in out["metrics"]
    assert out["metrics"]["eval.search_issue_us_per_frame"]["value"] > 0
