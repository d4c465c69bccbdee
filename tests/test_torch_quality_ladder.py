"""The port's soft-posterior quality ladder
(b2txt_tpu_torch/scripts/quality_ladder.py), run in-process at the JAX
package's test size (tests/test_quality_ladder.py): the same keys per gain
and backend, both searchers equal on identical posteriors, the lattice list
at least as deep, and pool_metrics equal to the JAX script's."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode.lmbeam import DecodeResult
from b2txt_tpu_torch.scripts import quality_ladder

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--vocab", "300", "--utts", "6", "--device_batch", "3", "--bins", "288",
        "--gains", "18,45", "--lattice", "--lattice_width", "128"]


def test_quality_ladder_tiny_on_the_cpu(capsys):
    out = quality_ladder.main(TINY + ["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3 and '"summary": "quality_ladder"' in printed[-1]
    gains, summary = out["rows"], out["summary"]
    assert len(gains) == 2 and summary["backend"] == "cpu"
    for row in gains:
        for b in ("native", "device", "lattice"):
            for key in ("exact", "wer", "wer_ci", "search_errors", "pool_depth_mean",
                        "oracle_wer", "sentences_per_s"):
                assert key in row[b], (b, key)
        # both canonical backends decode identical posteriors identically
        assert row["native"]["wer"] == row["device"]["wer"]
        assert row["top1_agreement"] == 1.0
        # the lattice list is at least as deep and its oracle at least as good
        assert row["lattice"]["pool_depth_mean"] >= row["native"]["pool_depth_mean"]
        assert row["lattice"]["oracle_wer"] <= row["native"]["oracle_wer"]
    soft, sharp = gains
    assert soft["gain"] < sharp["gain"]
    assert soft["native"]["wer"] >= sharp["native"]["wer"]
    assert sharp["native"]["wer"] == 0.0 and sharp["native"]["exact"] == "6/6"
    assert summary["min_top1_agreement"] == 1.0


def test_pool_metrics_equals_the_jax_script():
    tree = ast.parse((ROOT / "scripts" / "quality_ladder.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "pool_metrics")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "quality_ladder.py", "exec"), ns)
    sents = ["a b c", "d e f", "g h"]
    results = [
        [DecodeResult("a b c", -1.0, -1.0), DecodeResult("a b", -2.0, -1.0),
         DecodeResult("a b c", -3.0, -1.0)],
        [DecodeResult("d x f", -1.0, -1.0), DecodeResult("d e", -2.0, -1.0)],
        [],
    ]
    assert quality_ladder.pool_metrics(results, sents) == ns["pool_metrics"](results, sents)


def test_options_and_the_card():
    parse = quality_ladder.build_parser().parse_args
    assert parse([]).device is None
    assert parse(["--force_cpu"]).device == "cpu" == parse(["--device", "cpu"]).device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quality_ladder.main(TINY)
