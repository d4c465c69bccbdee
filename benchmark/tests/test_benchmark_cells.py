"""Every kind of cell run end to end on the CPU at a tiny size: sound runs
come out correct, and the control and each fault the cell can have, planted
under the timed path, come out not correct. The tiny cells are new files and
manifest entries in a throwaway checkout (``conftest.make_tiny_checkout``):
a cell, a configuration, a traffic mix and a per-layer metric are added
without editing a file that is there."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness


def run(root, cell, seed=2 ** 40 + 3, trace=False, control=""):
    return harness.run(cell, seed, 1.0, trace, device="cpu", root=root, control=control)


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-eval-native", "tiny-online", "tiny-train"])
def test_sound_run_is_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"], out["limits"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-2:] == ["limits", "forbidden_modules"]
    assert out["forbidden_modules"] == []


@pytest.mark.parametrize("cell,control", [("tiny-eval", "fp8"), ("tiny-online", "fp8"),
                                          ("tiny-train", "fp8"), ("tiny-train", "half_batch")])
def test_control_is_not_correct(tiny_root, cell, control):
    assert not run(tiny_root, cell, control=control)["correct"]


def _fault_sentence(monkeypatch):
    """The device search's answers altered where they are produced."""
    from b2txt_tpu_torch.serve import service

    orig = service.results_to_nbest

    def altered(results):
        return [(s + " " + s.split()[0], a, l) if s else (s, a, l) for s, a, l in orig(results)]

    monkeypatch.setattr(service, "results_to_nbest", altered)


def _fault_scores(monkeypatch):
    """The search's acoustic scores altered where they are produced."""
    from b2txt_tpu_torch.serve import service

    orig = service.results_to_nbest

    def altered(results):
        return [(s, a - 10.0, l) for s, a, l in orig(results)]

    monkeypatch.setattr(service, "results_to_nbest", altered)


def _fault_posteriors(monkeypatch):
    """Stage 1's logits altered where they are produced."""
    from b2txt_tpu_torch.models.gru_decoder import GRUDecoder

    orig = GRUDecoder.forward

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        return out * 1.1

    monkeypatch.setattr(GRUDecoder, "forward", altered)


def _fault_llm(monkeypatch):
    """OPT's scores altered where they are produced."""
    from b2txt_tpu_torch.decode.opt_lm import OPTRescorer

    orig = OPTRescorer.score_async

    def altered(self, *a, **k):
        fetch = orig(self, *a, **k)
        return lambda: [v - 1.0 for v in fetch()]

    monkeypatch.setattr(OPTRescorer, "score_async", altered)


def _fault_blend(monkeypatch):
    """The pick blended without OPT's scores (alpha taken as 0)."""
    from b2txt_tpu_torch.decode import rescore

    orig = rescore._blend

    def altered(kept, ac, ngram, llm_scores, acoustic_scale, alpha):
        return orig(kept, ac, ngram, llm_scores, acoustic_scale, 0.0)

    monkeypatch.setattr(rescore, "_blend", altered)


def _fault_state_unchanged(monkeypatch):
    """A step that leaves the parameters as they were (learning rates 0)."""
    from b2txt_tpu_torch.train import trainer

    def zero(opt, schedules, step):
        for g in opt.param_groups:
            g["lr"] = 0.0

    monkeypatch.setattr(trainer, "set_learning_rates", zero)


def _fault_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from b2txt_tpu_torch.train import trainer

    orig = trainer.ctc_loss

    def half(log_probs, targets, input_lengths, target_lengths, blank=0):
        losses = orig(log_probs, targets, input_lengths, target_lengths, blank)
        return losses[: losses.shape[0] // 2]

    monkeypatch.setattr(trainer, "ctc_loss", half)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-eval", _fault_sentence), ("tiny-eval", _fault_posteriors),
    ("tiny-eval", _fault_scores), ("tiny-eval-native", _fault_sentence),
    ("tiny-online", _fault_posteriors), ("tiny-online", _fault_llm),
    ("tiny-online", _fault_sentence), ("tiny-online", _fault_scores),
    ("tiny-online", _fault_blend),
    ("tiny-train", _fault_state_unchanged), ("tiny-train", _fault_half_batch)])
def test_fault_under_the_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run(tiny_root, cell)
    assert not out["correct"], out["limits"]


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-online", "tiny-train"])
def test_traced_run_reports_its_layer_metrics(tiny_root, cell):
    out = run(tiny_root, cell, trace=True)
    assert out["correct"]
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: the readers of device numbers return
    # nothing, the host-side ones read
    names = set(out["metrics"])
    assert not any(n.endswith("device_idle") or n.endswith("roofline") for n in names)
    assert any(n.endswith("mfu") for n in names)


def test_online_detail_counts_what_opt_scored(tiny_root):
    """The online line says how many rows and tokens OPT scored a trial."""
    out = run(tiny_root, "tiny-online")
    rows, tokens = out["detail"]["opt_rows_per_trial"], out["detail"]["opt_tokens_per_trial"]
    assert 1 <= rows["p50"] <= rows["max"] and tokens["p50"] > rows["p50"]


def test_a_new_metric_is_new_files_only(tiny_root, tmp_path):
    """A per-layer metric added as a reader file and a manifest entry."""
    import shutil

    root = str(tmp_path / "co")
    shutil.copytree(tiny_root, root, symlinks=True)
    with open(os.path.join(root, "benchmark", "metrics", "eval.calls.py"), "w") as f:
        f.write('"""eval.calls: the window\'s evaluation calls."""\n\n\n'
                'def read(run):\n    return float(len(run.spans.get("call", []))) or None\n')
    m = harness.load_manifest(root)
    m["per_layer"].append({"name": "eval.calls", "unit": "calls", "better": "higher",
                           "source": "program_span", "layer": "session evaluation",
                           "moves": "sentences_per_s", "workloads": ["tiny-eval"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    out = run(root, "tiny-eval", trace=True)
    assert out["metrics"]["eval.calls"]["value"] >= 1


def test_dropout_left_out_is_not_correct(tiny_root, monkeypatch):
    """The program's random values are checked apart: dropout that keeps
    everything fails the draws' number."""
    from b2txt_tpu_torch.models import gru_decoder

    monkeypatch.setattr(gru_decoder, "dropout", lambda x, p, generator: x)
    out = run(tiny_root, "tiny-train")
    assert not out["correct"] and out["limits"]["draws_gap"]["value"] > 100
