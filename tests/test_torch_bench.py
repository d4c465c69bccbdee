"""The port's headline driver (``b2txt_tpu_torch.scripts.bench``) against the
JAX package's ``bench.py``, and the OPT driver (``scripts.bench_opt``), on
the CPU at a tiny scale.

The JAX ``bench.py`` runs in a subprocess as tests/test_bench_entry.py runs
it (its import turns on JAX's persistent compile cache, which goes under a
temporary ``HOME`` here); the port's ``main(argv)`` runs in-process with
``--device cpu``. Their stage-1 noise differs (two frameworks' random bits),
so the two lines agree on the quality and configuration fields, not on the
rates."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.scripts import bench, bench_opt

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--vocab", "300", "--utts", "4", "--device_batch", "2", "--bins", "288"]
QUALITY = ["device_exact", "device_pipeline_exact", "native_exact", "device_search_errors",
           "native_search_errors", "device_wer", "device_wer_ci", "native_wer", "native_wer_ci"]
CONFIG = ["vocab", "order", "beam_width", "nbest", "first_beam", "blank_penalty",
          "acoustic_scale", "max_homophones", "close_probe_top", "state_key", "utts",
          "words_per_sentence"]
# tests/test_bench_entry.py:28-33
ENTRY_KEYS = ["connected", "device_pipeline_sentences_per_sec",
              "host_overlapped_sentences_per_sec", "device_wer", "native_wer", "rescore",
              "headline_mode", "per_bin_latency_us", "pipeline_per_bin_latency_us",
              "llm_finalize", "multipliers"]


def _one_json_line(text: str) -> dict:
    lines = [line for line in text.splitlines() if line.startswith("{")]
    assert len(lines) == 1, text[-2000:]
    return json.loads(lines[0])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The drivers' torch work on 2 threads: beside the other test workers,
    torch's default of every core oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_line(tmp_path_factory):
    home = tmp_path_factory.mktemp("home")
    code = ("import jax; jax.config.update('jax_platforms','cpu');\n"
            f"import sys; sys.argv=['bench.py'] + {TINY!r}\n"
            "exec(open('bench.py').read())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=1200, cwd=ROOT, env={**os.environ, "HOME": str(home)})
    assert r.returncode == 0, r.stderr[-2000:]
    return _one_json_line(r.stdout)


@pytest.fixture(scope="module")
def port_run():
    """(the port's returned line, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.main(TINY + ["--device", "cpu"])
    return line, out.getvalue()


@pytest.fixture(scope="module")
def port_line(port_run):
    return port_run[0]


@pytest.mark.parametrize("key", QUALITY + CONFIG)
def test_port_bench_equals_jax_bench(jax_line, port_line, key):
    assert port_line["extra"][key] == jax_line["extra"][key], key


def test_port_bench_line_has_the_entry_keys(port_line):
    d = port_line
    assert d["metric"] == "pipeline_sentences_per_sec"
    assert d["value"] > 0 and d["unit"] == "sentences/s" and d["vs_baseline"] > 0
    e = d["extra"]
    for key in ENTRY_KEYS:
        assert key in e, key
    assert e["connected"] is True and e["backend"] == "cpu"
    # the LLM stage is skipped on the CPU unless --llm_tiny, as on JAX's CPU backend
    assert e["llm_finalize"] == {"skipped": True}
    assert e["multipliers"]["ngram_pipeline_vs_reference_full"] > 0
    assert e["multipliers"]["llm_inclusive_vs_reference_full"] is None
    assert e["device_exact"] == e["native_exact"] == "4/4"
    # no kernel on the CPU: K1 is counted only where it launches
    assert e["gru_fwd_launches_per_batch"] == e["gru_fwd_launches"] == 0
    assert e["host_overlapped_stage1_batches"] >= 1


def test_port_bench_prints_one_json_line(port_run):
    line, printed = port_run
    assert _one_json_line(printed) == line


def test_port_bench_llm_tiny():
    """--llm_tiny runs the finalize stage (decode → on-card rescore →
    augment → α-blend) with OPTConfig.tiny and labels it."""
    e = bench.main(TINY + ["--device", "cpu", "--llm_tiny", "--llm_utts", "4"])["extra"]
    llm = e["llm_finalize"]
    assert llm["measured_in_run"] is True and llm["tiny_model"] is True
    assert llm["finalize_with_opt67b_sentences_per_s"] > 0
    assert llm["finalize_with_opt67b_exact"] == "4/4"
    assert llm["opt67b_forward_tokens_per_s"] > 0
    # tiny-model rates do not feed the like-for-like 6.7b multiplier
    assert e["multipliers"]["llm_inclusive_vs_reference_full"] is None


def test_port_bench_llm_stage_error_fails_the_run(monkeypatch, capsys):
    """By design the port lets an LLM-stage error fail the run, where the
    JAX driver reports it in ``llm_finalize.error`` and exits 0
    (bench.py:632-639): no line is printed."""
    def fails(*args, **kwargs):
        raise RuntimeError("the finalize failed")

    monkeypatch.setattr(bench, "measure_llm_finalize", fails)
    with pytest.raises(RuntimeError, match="the finalize failed"):
        bench.main(TINY + ["--device", "cpu", "--utts", "2", "--llm_tiny", "--llm_utts", "2"])
    assert not [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_port_bench_refuses_real_lexicon_as_jax_does():
    """Without the reference's dict.txt both drivers stop in build_world
    with the same message (bench.py:145)."""
    jax_message = re.search(r'raise SystemExit\("(--real_lexicon:[^"]*)"\)',
                            (ROOT / "bench.py").read_text()).group(1)
    with pytest.raises(SystemExit) as exc:
        bench.main(TINY + ["--device", "cpu", "--real_lexicon"])
    assert str(exc.value) == jax_message


def test_port_bench_adversarial():
    """The homophone-dense world: close_probe_top 2 by default, the lexicon's
    statistics in the line, both quality columns."""
    e = bench.main(["--adversarial"] + TINY + ["--device", "cpu"])["extra"]
    assert e["adversarial"] is True and e["close_probe_top"] == 2
    assert e["max_homophones"] == 6
    assert "lexicon_stats" in e
    assert "device_wer" in e and "native_wer" in e


def _finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or bool(np.isfinite(obj))


def test_bench_opt_stages_on_the_cpu(capsys):
    """Stages A, B, D, C and E with the tiny OPT: every printed line parses
    and is finite, B's scores are OPTRescorer.score's on the same lists, D's
    prefix-KV scores equal the concatenated ones, C and E decode every
    planted sentence."""
    from b2txt_tpu_torch.decode.opt_lm import OPTRescorer, init_params, word_hash_encode

    cfg = bench_opt.opt_config("tiny")
    params = init_params(cfg, "cpu", torch.bfloat16, torch.Generator().manual_seed(0))
    lines = bench_opt.main(["--device", "cpu", "--opt_size", "tiny", "--nbest", "8",
                            "--context_words", "6", "--full", "--vocab", "300", "--utts", "4",
                            "--device_batch", "2", "--lattice", "--lattice_width", "32"],
                           params=params)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["stage"] for p in printed] == [
        "A_opt67b_forward", "B_opt_rescore_nbest", "D_context_rescore",
        "C_full_finalize_pipeline", "E_lattice_finalize_pipeline"]
    assert all(_finite(p) for p in printed)
    assert "scores" not in printed[1] and printed[0]["weights"] == "passed in"
    lists, _ = bench_opt.nbest_lists(8, np.random.default_rng(0))
    resc = OPTRescorer(cfg, params=params, encode=word_hash_encode(cfg.vocab_size),
                       device="cpu", compute_dtype=torch.bfloat16, max_len=32)
    np.testing.assert_array_equal(lines[1]["scores"], [resc.score(c) for c in lists])
    assert printed[2]["prefix_vs_concatenated_max_abs"] < 0.35   # the bf16 context tolerance
    assert printed[3]["exact"] == printed[4]["exact"] == "4/4"
    assert printed[3]["grouped_output_identical"] is True


@pytest.mark.parametrize("driver", [bench, bench_opt])
def test_help_parses(driver, capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main(["--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("driver", [bench, bench_opt])
def test_wants_the_card(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--vocab", "300"])
