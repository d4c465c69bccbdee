"""The ``online_lm`` kind at a tiny size on the CPU: DeepSeek-V2 in the
rescorer's place (hidden 64, 3 layers of which the first is dense, 8
experts top-3 with 1 shared, kv rank 32, vocabulary 97). A sound run is
correct; the float8 control and each fault planted under the timed path
(the top-k renormalized, the shared experts left out, one expert's tokens
dropped) are not. The tiny cell is new files and manifest entries in a
throwaway checkout, as ``conftest.make_tiny_checkout`` adds the others."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness

from conftest import TINY_MODEL, _json, make_tiny_checkout

TINY_LLM = dict(hidden_size=64, intermediate_size=96, kv_lora_rank=32,
                max_position_embeddings=256, moe_intermediate_size=32, n_routed_experts=8,
                n_shared_experts=1, num_attention_heads=4, num_experts_per_tok=3,
                num_hidden_layers=3, num_key_value_heads=4, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, vocab_size=97)
# read from sound tiny runs on the CPU (bf16 there too), with room
TINY_LIMITS = {"posterior_gap": 0.8, "route_gap": 0.02, "llm_gap": 0.05, "blend_gap": 0.03}


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory):
    root = make_tiny_checkout(str(tmp_path_factory.mktemp("checkout_lm")))
    b = os.path.join(root, "benchmark")
    cfg = _json(os.path.join(b, "configs", "nejm-gru5x768-dsv2lite.json"))
    cfg["model"].update(TINY_MODEL)
    cfg["world"]["vocab_size"] = 300
    cfg["llm"].update(TINY_LLM)
    cfg["llm_init_std"] = 0.05
    cfg["rescorer"]["max_len"] = 32
    _json(os.path.join(b, "configs", "tiny-dsv2.json"), cfg)
    t = _json(os.path.join(b, "traffic", "online-trials-lm.json"))
    t.update(pool=6, check_trials=3, trace_trials=2, feature_noise=0.375)
    _json(os.path.join(b, "traffic", "tiny-online-lm.json"), t)
    _json(os.path.join(b, "limits", "tiny-online-lm.json"), TINY_LIMITS)
    m = harness.load_manifest(root)
    m["configs"].append({"name": "tiny-dsv2", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/tiny-dsv2.json", "reduced": [],
                         "why": "a tiny copy for the CPU tests"})
    m["workloads"].append({"name": "tiny-online-lm", "config": "tiny-dsv2",
                           "traffic": "tiny-online-lm", "chips": 1,
                           "why": "a tiny cell for the CPU tests"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "online-native-dsv2lite" in metric.get("workloads", []):
            metric["workloads"].append("tiny-online-lm")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return root


def run(root, trace=False, control=""):
    return harness.run("tiny-online-lm", 2 ** 40 + 3, 1.0, trace, device="cpu", root=root,
                       control=control)


def test_the_configuration_holds_the_published_config_whole():
    """The file's top-level keys are config.json's, and the ``llm`` block
    the program is built from is the same, with nothing reduced."""
    from b2txt_tpu_torch.decode.deepseek_lm import DeepseekV2Config

    cfg = _json(os.path.join(harness.ROOT, "benchmark", "configs",
                             "nejm-gru5x768-dsv2lite.json"))
    assert cfg["reduced"] == []
    assert {k: cfg[k] for k in cfg["llm"]} == cfg["llm"]
    assert DeepseekV2Config(**cfg["llm"]) == DeepseekV2Config.deepseek_v2_lite()


def test_sound_run_is_correct(lm_root):
    out = run(lm_root)
    assert out["correct"], out["limits"]
    assert set(out["limits"]) == {"posterior_gap", "route_gap", "llm_gap", "blend_gap"}
    assert out["attempted"] > 0 and out["failed"] == 0 and out["forbidden_modules"] == []
    assert {"sentence_ms_p50", "sentence_ms_p95", "setup_s"} <= set(out["metrics"])
    assert out["detail"]["llm_rows_per_trial"]["p50"] >= 1


def test_control_is_not_correct(lm_root):
    assert not run(lm_root, control="fp8")["correct"]


def _renormalized(monkeypatch):
    """The top-k's weights renormalized to sum to 1."""
    from b2txt_tpu_torch.decode import deepseek_lm

    orig = deepseek_lm.route

    def altered(*a, **k):
        w, idx, counts = orig(*a, **k)
        return w / w.sum(-1, keepdim=True), idx, counts

    monkeypatch.setattr(deepseek_lm, "route", altered)


def _shared_left_out(monkeypatch):
    """The MoE layers without their shared experts."""
    from b2txt_tpu_torch.decode import deepseek_lm

    orig = deepseek_lm._swiglu

    def altered(x, m, dtype):
        y = orig(x, m, dtype)
        return torch.zeros_like(y) if m.gate_proj.weight.shape[0] == 32 else y

    monkeypatch.setattr(deepseek_lm, "_swiglu", altered)


def _one_expert_dropped(monkeypatch):
    """The tokens routed to one expert (the first token's first choice)
    dropped from its sum."""
    from b2txt_tpu_torch.decode import deepseek_lm

    orig = deepseek_lm.moe_experts

    def altered(x, idx, w, *a):
        return orig(x, idx, torch.where(idx == idx[0, 0], 0.0, w), *a)

    monkeypatch.setattr(deepseek_lm, "moe_experts", altered)


@pytest.mark.parametrize("fault", [_renormalized, _shared_left_out, _one_expert_dropped])
def test_fault_under_the_timed_path_is_not_correct(lm_root, monkeypatch, fault):
    fault(monkeypatch)
    out = run(lm_root)
    assert not out["correct"], out["limits"]


def test_traced_run_reports_its_layer_metrics(lm_root):
    out = run(lm_root, trace=True)
    assert out["correct"]
    # the CPU has no device trace: the readers of device numbers return
    # nothing, the host-side ones read
    names = set(out["metrics"])
    assert {"dsv2.llm_issue_ms", "dsv2.llm_wait_ms", "dsv2.mfu", "online.stage1_ms",
            "online.chunks_ms", "online.native_ms", "online.finalize_ms"} <= names
    assert not {"dsv2.experts_share", "dsv2.experts_roofline"} & names
