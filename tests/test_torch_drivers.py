"""The port's measurement drivers other than bench.py and bench_opt.py, on
the CPU at a few layers and narrow widths: ``bench_device_decode`` against
the JAX script (the same exact counts on the same utterances),
``drive_large_lm``'s ``write_arpa`` against the JAX function (the same
bytes) and its native and device searches (the same top-1), and the
streaming, training and profiling drivers' ``main(argv)`` with every printed
JSON line parsed and finite. Every driver parses ``--help`` and wants the
card unless told ``cpu``."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.scripts import (bench_device_decode, bench_streaming, bench_training,
                                     drive_large_lm, profile_device_step, profile_train_step)

ROOT = Path(__file__).resolve().parent.parent
SMALL_MODEL = ["--features", "32", "--units", "32", "--layers", "2"]


def _json_lines(text: str):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or bool(np.isfinite(obj))


def _load_jax_script(name: str):
    """A JAX script's module from scripts/ by path (its imports of jax and
    b2txt_tpu stay inside its functions)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The drivers' torch work on 2 threads: beside the other test workers,
    torch's default of every core oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- bench_device_decode
DEVICE_DECODE = ["--vocab", "300", "--utts", "8", "--batch", "4", "--beam_width", "32"]


@pytest.fixture(scope="module")
def device_decode_lines(tmp_path_factory):
    """(the JAX script's lines, the port's lines) at the same argv. The JAX
    script turns on JAX's persistent compile cache at import: it runs in a
    subprocess with a temporary HOME."""
    home = tmp_path_factory.mktemp("home")
    r = subprocess.run([sys.executable, "scripts/bench_device_decode.py", *DEVICE_DECODE],
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env={**os.environ, "HOME": str(home), "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    port = bench_device_decode.main(DEVICE_DECODE + ["--device", "cpu"])
    return _json_lines(r.stdout), port


@pytest.mark.parametrize("key", ["native_exact", "device_exact", "mean_frames", "vocab",
                                 "beam_width", "merge", "world"])
def test_bench_device_decode_equals_jax(device_decode_lines, key):
    jax_lines, port = device_decode_lines
    assert port[key] == jax_lines[-1][key], key
    assert port["device_exact"] == port["native_exact"] == "8/8"


def test_bench_device_decode_prints_the_native_line_first(capsys):
    bench_device_decode.main(["--vocab", "300", "--utts", "4", "--batch", "4", "--device", "cpu",
                              "--skip_device", "--adversarial"])
    lines = _json_lines(capsys.readouterr().out)
    # the adversarial world's statistics, the native line, the last line
    assert len(lines) == 3 and lines[1] == lines[2]
    assert lines[-1]["world"] == "adversarial" and "native_exact" in lines[-1]
    assert "device_exact" not in lines[-1]


# ------------------------------------------------------------ drive_large_lm
def test_write_arpa_is_a_copy_of_the_jax_function(tmp_path):
    """The function's source is the JAX driver's, and so are its bytes."""
    def source(path):
        text = path.read_text()
        fn = next(n for n in ast.parse(text).body
                  if isinstance(n, ast.FunctionDef) and n.name == "write_arpa")
        return ast.get_source_segment(text, fn)

    assert source(ROOT / "b2txt_tpu_torch/scripts/drive_large_lm.py") == \
        source(ROOT / "scripts/drive_large_lm.py")
    jax_mod = _load_jax_script("drive_large_lm")
    for counts in ([1500, 700], [900, 400, 400, 300]):
        a, b = tmp_path / "port.arpa", tmp_path / "jax.arpa"
        assert drive_large_lm.write_arpa(str(a), 400, counts) == \
            jax_mod.write_arpa(str(b), 400, counts)
        assert a.read_bytes() == b.read_bytes()


def test_drive_large_lm_native_and_device_agree(tmp_path, capsys):
    arpa = str(tmp_path / "lm.arpa")
    lines = drive_large_lm.main(["--entries", "30000", "--vocab", "1000", "--order", "4",
                                 "--arpa", arpa, "--device", "--on", "cpu"])
    assert _json_lines(capsys.readouterr().out) == lines
    native, device = lines
    assert native["backend"] == "native" and device["backend"] == "device"
    assert native["entries"] == device["entries"] == 30000
    assert native["decode_exact"] == "24/24" and device["decode_exact"] == "16/16"
    assert device["native_top1_equal"] == "16/16"
    assert all(_finite(line) for line in lines)
    assert not os.path.exists(arpa)   # removed without --keep


# ------------------------------------------------ streaming, training, profiling
def test_bench_streaming_main(capsys):
    out = bench_streaming.main(["--device", "cpu", *SMALL_MODEL, "--hops", "6",
                                "--device_hops", "3"])
    text = capsys.readouterr().out
    assert _json_lines(text) == [out]
    assert "model update latency: median" in text and "LM incremental step" in text
    assert _finite(out) and out["backend"] == "cpu"
    assert out["model"] == {"features": 32, "units": 32, "layers": 2, "patch": 14, "stride": 4,
                            "compute_dtype": "bfloat16"}
    assert out["update_latency_ms"]["n"] == 20 and out["chained_hops"] == 6
    assert out["gru_fwd_launches"] == 0   # K1 launches only on the card


TRAIN = ["--device", "cpu", *SMALL_MODEL, "--batch_size", "4"]


@pytest.mark.parametrize("mode", ["step", "full_input"])
def test_bench_training_main(mode, capsys):
    argv = (TRAIN + ["--bins", "128", "--label_len", "10", "--chained", "2", "--synced", "1"]
            if mode == "step" else
            TRAIN + ["--full_input", "--steps", "2", "--warm", "1", "--trials", "8"])
    out = bench_training.main(argv)
    text = capsys.readouterr().out
    assert _json_lines(text) == [out]
    assert _finite(out) and out["mode"] == mode and out["steps_per_sec"] > 0
    if mode == "step":
        assert "train steps/s:" in text and len(out["losses"]) == 3
    else:
        assert "full-input-path train steps/s:" in text and out["timed_steps"] == 2


def test_profile_train_step_main(capsys):
    lines = profile_train_step.main(["--device", "cpu", *SMALL_MODEL, "--batches", "2,4",
                                     "--batch", "2", "--bins", "128", "--label_len", "10",
                                     "--iters", "1", "--chain", "1"])
    assert _json_lines(capsys.readouterr().out) == lines
    assert all(_finite(line) for line in lines)
    stages = [line.get("stage") for line in lines[1:]]
    assert stages == ["full_step_B2", "full_step_B4", "augment_only", "fwd_kernel", "fwd_plain",
                      "fwd_layers1", "fwd_layers5", "ctc_fwd_only", "ctc_grad",
                      "optimizer_only"]
    assert "not a yardstick" in lines[5]["note"]
    assert all(line["ms"] > 0 for line in lines[1:])


@pytest.mark.parametrize("mode,key", [("gather", "layout"), ("sort", "us_per_sort"),
                                      ("sel", "op"), ("step", "ms_per_frame")])
def test_profile_device_step_modes(mode, key, capsys):
    argv = [mode, "--device", "cpu", "--iters", "2", "--batch", "4", "--cands", "64", "--K", "8",
            "--slots", "4096", "--windows", "64", "--vocab", "300", "--frames", "16"]
    if mode == "step":
        argv.append("--stub_lm")
    lines = profile_device_step.main(argv)
    assert _json_lines(capsys.readouterr().out) == lines
    assert lines[0] == {"backend": "cpu", "mode": mode}
    assert any(key in line for line in lines) and all(_finite(line) for line in lines)


# ---------------------------------------------------------------- every driver
DRIVERS = [bench_device_decode, bench_streaming, bench_training, drive_large_lm,
           profile_device_step, profile_train_step]


@pytest.mark.parametrize("driver", DRIVERS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_help_parses(driver, capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main(["--help"])
    assert exc.value.code == 0
    assert "usage: python -m b2txt_tpu_torch.scripts." in capsys.readouterr().out


WANTS_CARD = {
    bench_device_decode: ["--vocab", "300"],
    bench_streaming: [],
    bench_training: [],
    drive_large_lm: ["--device", "--entries", "2000", "--vocab", "100"],
    profile_device_step: ["sel"],
    profile_train_step: [],
}


@pytest.mark.parametrize("driver", DRIVERS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_wants_the_card(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(WANTS_CARD[driver])
