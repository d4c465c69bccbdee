"""The port's two CLIs, ``python -m b2txt_tpu_torch.scripts.evaluate_model``
and ``... .language_model_standalone``: their argparse surface; the
evaluation CLI on the CPU against ``scripts/evaluate_model.py`` on the same
checkpoint, sessions and LM (the same PER and WER lines, the same CSV), and
the three checkpoint layouts it reads; and the LM server driven over the
port's fake redis, as tests/test_cli_scripts.py drives the JAX package's."""

import os
import runpy
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLIS = ["evaluate_model", "language_model_standalone"]
SESSIONS = ["t15.2023.08.11", "t15.2023.08.13"]

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")


@pytest.fixture(autouse=True)
def _redis_module_restored(monkeypatch):
    """The port's fake is ``redis`` only for the test that installs it: the
    JAX package's Redis tests, which may run next in the same worker, read
    the fake they installed when imported."""
    for name in ("redis", "redis.exceptions"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name))


@pytest.mark.parametrize("cli", CLIS)
def test_cli_help_parses(cli):
    r = subprocess.run([sys.executable, "-m", f"b2txt_tpu_torch.scripts.{cli}", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "usage" in r.stdout.lower() and "--device" in r.stdout


def _lm_dir(tmp_path, corpus, prons):
    """lm.arpa + lexicon.txt, the layout both CLIs read."""
    from b2txt_tpu_torch.lm import train_ngram

    lm_dir = tmp_path / "lm"
    lm_dir.mkdir()
    train_ngram(corpus, order=3).to_arpa(str(lm_dir / "lm.arpa"))
    with open(lm_dir / "lexicon.txt", "w") as f:
        for w, pron in prons.items():
            f.write(f"{w.upper()}  {' '.join(p.rstrip('012') for p in pron)}\n")
    return str(lm_dir)


@needs_gxx
def test_evaluate_model_cli_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """A JAX-package checkpoint (random init) evaluated by both CLIs, with
    the native searcher (their default): the same per-trial greedy lines,
    PER and WER lines, and a byte-equal competition CSV."""
    from b2txt_tpu.data import synthetic as jax_synthetic
    from b2txt_tpu.models import init_params_from_config
    from b2txt_tpu.train.checkpoint import save_checkpoint
    from b2txt_tpu.utils import TrainConfig
    from b2txt_tpu_torch.data import synthetic
    from b2txt_tpu_torch.scripts import evaluate_model

    data_dir = str(tmp_path / "data")
    jax_synthetic.write_synthetic_sessions(data_dir, SESSIONS, trials_per_session=6,
                                           neural_dim=16)
    cfg = TrainConfig()
    cfg.model.n_input_features = cfg.dataset.neural_dim = 16
    cfg.model.n_units, cfg.model.n_layers = 32, 2
    cfg.dataset.sessions = SESSIONS
    model_path = tmp_path / "model"
    params = init_params_from_config(jax.random.PRNGKey(5), cfg.model, n_days=2, n_classes=41)
    save_checkpoint(str(model_path / "checkpoint" / "best_checkpoint"), params)
    cfg.save(str(model_path / "checkpoint" / "args.yaml"))
    lm_dir = _lm_dir(tmp_path, synthetic.sentence_corpus(100), synthetic.word_pronunciations())

    common = ["--model_path", str(model_path), "--data_dir", data_dir, "--lm_dir", lm_dir,
              "--acoustic_scale", "0.5", "--blank_penalty", "1.0", "--nbest", "10",
              "--beam_width", "32"]
    ref_csv, our_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    script = os.path.join(REPO, "scripts", "evaluate_model.py")
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", [script, *common, "--csv_path", ref_csv])
    runpy.run_path(script, run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    evaluate_model.main([*common, "--csv_path", our_csv, "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()

    def comparable(lines):
        return [ln for ln in lines if not ln.startswith(("LM decode throughput", "Wrote"))]

    assert any(ln.startswith("Aggregate greedy PER") for ln in ours)
    assert any(ln.startswith("Aggregate WER") for ln in ours)
    assert comparable(ours) == comparable(ref)
    assert open(our_csv, "rb").read() == open(ref_csv, "rb").read()


def _clean_logits(phoneme_ids, hot=8.0):
    rows = []
    for pid in phoneme_ids:
        for _ in range(3):
            row = np.full(41, -hot, np.float32)
            row[pid] = 0.0
            rows.append(row)
        blank = np.full(41, -hot, np.float32)
        blank[0] = 0.0
        rows.append(blank)
    return np.stack(rows)


def _serve_one(tmp_path, monkeypatch, argv):
    """main(argv + the LM directory) in a thread against the fake redis:
    argparse → ARPA/lexicon load → DecoderService → RedisDecoderServer.run;
    one planted utterance over the wire protocol. Returns (service, final)."""
    from b2txt_tpu_torch.lm import Lexicon, NGramLM
    from b2txt_tpu_torch.scripts import language_model_standalone
    from b2txt_tpu_torch.serve import fakeredis
    from b2txt_tpu_torch.serve.redis_adapter import RedisDecoderServer
    from b2txt_tpu_torch.serve.redis_client import RemoteLMClient
    from b2txt_tpu_torch.utils.phonemes import rearrange_speech_logits

    fakeredis.install_fake_redis()
    fakeredis.reset_all()
    prons = {"the": ["DH", "AH0"], "cat": ["K", "AE1", "T"], "sat": ["S", "AE1", "T"],
             "mat": ["M", "AE1", "T"], "on": ["AA1", "N"], "there": ["DH", "EH1", "R"],
             "is": ["IH1", "Z"], "hat": ["HH", "AE1", "T"]}
    corpus = [s.split() for s in ["the cat sat on the mat", "there is the cat",
                                  "the cat is there", "the cat sat on the hat"]] * 4
    lm_dir = _lm_dir(tmp_path, corpus, prons)

    captured = {}
    orig_run = RedisDecoderServer.run

    def run_capture(self, *a, **k):
        captured["server"] = self
        return orig_run(self, *a, **k)

    monkeypatch.setattr(RedisDecoderServer, "run", run_capture)
    argv = ["--lm_path", lm_dir, "--acoustic_scale", "0.5", "--blank_penalty", "1.0",
            "--nbest", "5", "--beam_width", "32", "--beam", "0.0", *argv]
    thread = threading.Thread(target=language_model_standalone.main, args=(argv,), daemon=True)
    thread.start()
    deadline = time.time() + 60
    while "server" not in captured and time.time() < deadline:
        time.sleep(0.02)
    assert "server" in captured, "CLI never reached the server loop"
    time.sleep(0.2)  # let the loop connect and set stream cursors
    assert thread.is_alive()
    try:
        lm = NGramLM.from_arpa(os.path.join(lm_dir, "lm.arpa"))
        lexicon = Lexicon.from_file(os.path.join(lm_dir, "lexicon.txt"), vocab=lm.vocab)
        client = RemoteLMClient()
        client.reset()
        logits = rearrange_speech_logits(_clean_logits(lexicon.sentence_to_phonemes(SENT)))
        assert client.send_logits(logits)
        final = client.finalize()
    finally:
        captured["server"].stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    return captured["server"].service, final


SENT = "the cat sat on the mat"


@pytest.mark.parametrize("searcher", [pytest.param("native", marks=needs_gxx), "python"])
def test_language_model_standalone_cli(tmp_path, monkeypatch, searcher):
    """The server with each host searcher."""
    service, final = _serve_one(tmp_path, monkeypatch, ["--searcher", searcher])
    assert service.searcher_backend == searcher
    assert final.sentence == SENT
    assert final.nbest and len(final.nbest[0]) == 5


@pytest.mark.parametrize("weights", ["random_init", "opt_weights"])
def test_language_model_standalone_cli_with_the_ports_opt(tmp_path, monkeypatch, weights):
    """--do_opt --opt_backend port --opt_size tiny on the CPU: bf16 weights
    drawn on the device, or read from an HF-layout state dict written with
    torch.save; the request comes back rescored by the port's OPT."""
    import torch

    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer, init_params

    argv = ["--searcher", "python", "--device", "cpu", "--do_opt", "--opt_backend", "port",
            "--opt_size", "tiny"]
    sd = None
    if weights == "random_init":
        argv.append("--opt_random_init")
    else:
        sd = init_params(OPTConfig.tiny(), "cpu", torch.float32, torch.Generator().manual_seed(3))
        path = str(tmp_path / "opt.pt")
        torch.save({k: v for k, v in sd.items() if k != "lm_head.weight"}, path)
        argv += ["--opt_weights", path]
    service, final = _serve_one(tmp_path, monkeypatch, argv)
    llm = service.llm
    assert isinstance(llm, OPTRescorer) and llm.compute_dtype == torch.bfloat16
    assert llm.device == torch.device("cpu") and service.config.do_opt
    if sd is not None:
        for k, v in llm.model.state_dict().items():
            assert v.dtype == torch.bfloat16 and torch.equal(v, sd[k].to(torch.bfloat16)), k
    assert final.sentence == SENT
    assert any(row[3] != 0.0 for row in final.nbest)     # the LLM's column


def test_language_model_standalone_cli_port_opt_needs_weights(tmp_path, capsys):
    from b2txt_tpu_torch.scripts import language_model_standalone

    lm_dir = _lm_dir(tmp_path, [["the", "cat"]] * 3, {"the": ["DH", "AH0"], "cat": ["K", "AE1", "T"]})
    with pytest.raises(SystemExit):
        language_model_standalone.main(["--lm_path", lm_dir, "--device", "cpu", "--do_opt",
                                        "--opt_backend", "port", "--opt_size", "tiny"])
    assert "--opt_weights or --opt_random_init" in capsys.readouterr().err


@pytest.mark.parametrize("layout", ["port", "jax", "reference_torch"])
def test_evaluate_model_reads_every_checkpoint_layout(tmp_path, layout):
    """The port's pickle (reference parameter names), the JAX package's
    pickle (its parameter tree) and a reference PyTorch checkpoint all load
    into the same GRUDecoder weights."""
    import torch

    from b2txt_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
    from b2txt_tpu_torch.models import GRUDecoder, params_to_jax
    from b2txt_tpu_torch.scripts.evaluate_model import load_decoder
    from b2txt_tpu_torch.train.checkpoint import save_checkpoint
    from b2txt_tpu_torch.utils import TrainConfig

    cfg = TrainConfig()
    cfg.model.n_input_features, cfg.model.n_units, cfg.model.n_layers = 8, 12, 2
    model = GRUDecoder(cfg.model, 3, 41, device="cpu")
    path = str(tmp_path / "best_checkpoint")
    if layout == "port":
        save_checkpoint(path, model.state_dict())
    elif layout == "jax":
        jax_save_checkpoint(path, params_to_jax(model.state_dict()))
    else:
        torch.save({"model_state_dict": model.state_dict()}, path)
    loaded = load_decoder(path, cfg, torch.device("cpu"))
    assert loaded.n_days == 3
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
