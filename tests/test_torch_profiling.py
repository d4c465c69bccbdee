"""The port's ``utils/profiling``: its stage timer counts as the JAX
package's does, and its device trace (``torch.profiler``) writes a Chrome
trace that holds the ``annotate`` ranges."""

import json

import torch

from b2txt_tpu.utils.profiling import StageTimer as JaxStageTimer
from b2txt_tpu_torch.utils.profiling import StageTimer, annotate, device_trace


def test_stage_timer_counts_as_the_jax_one():
    timers = StageTimer(), JaxStageTimer()
    for t in timers:
        for name in ["load", "decode", "decode", "rescore", "decode"]:
            with t.stage(name):
                pass
        try:
            with t.stage("fails"):
                raise ValueError
        except ValueError:
            pass
    ours, ref = (t.summary() for t in timers)
    assert list(ours) == list(ref) == ["load", "decode", "rescore", "fails"]
    for name in ref:
        assert ours[name]["count"] == ref[name]["count"]
        assert set(ours[name]) == set(ref[name])
        assert ours[name]["total_s"] >= 0


def test_device_trace_holds_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with device_trace(str(tmp_path)):
        with annotate("stage1_batch"):
            y = x @ x
    assert y.shape == (64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "stage1_batch" in names
    assert any("mm" in str(n) for n in names)
