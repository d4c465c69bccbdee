"""The port's CLIs, ``python -m b2txt_tpu_torch.scripts.<name>``: their
argparse surface; the evaluation CLI on the CPU against
``scripts/evaluate_model.py`` on the same checkpoint, sessions and LM (the
same PER and WER lines, the same CSV), and the three checkpoint layouts it
reads; the LM server driven over the port's fake redis, as
tests/test_cli_scripts.py drives the JAX package's; and build_lm,
decode_logits, convert_checkpoint, train_model and download_data against
their JAX counterparts on the same files, and eval_45session_sim's
in-memory sessions against its HDF5 ones."""

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
CLIS = ["evaluate_model", "language_model_standalone", "train_model", "convert_checkpoint",
        "build_lm", "decode_logits", "download_data", "eval_45session_sim"]
# the CLIs that run work on the card, and so take --device
DEVICE_CLIS = {"evaluate_model", "language_model_standalone", "train_model", "decode_logits",
               "eval_45session_sim"}
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
    assert "usage" in r.stdout.lower()
    assert ("--device" in r.stdout) == (cli in DEVICE_CLIS)


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


# ------------------------------------------------ build_lm and decode_logits

DICT = """\\
;;; tiny CMUdict-style fixture (stress digits exercised on purpose)
THE  DH AH0
CAT  K AE1 T
SAT  S AE1 T
MAT  M AE1 T
ON  AA1 N
THERE  DH EH1 R
THEIR  DH EH1 R
IS  IH1 Z
HAT  HH AE1 T
"""
RAW_CORPUS = ["The cat sat on the mat.", "There is the cat!", "The cat is there...",
              "There is the mat", "the cat sat on the HAT, there."] * 4


def _run_jax_cli(script, argv):
    """scripts/<script> as __main__ with ``argv``, in-process."""
    path = os.path.join(REPO, "scripts", script)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [path, *argv])
        mp.chdir(REPO)
        runpy.run_path(path, run_name="__main__")


def _build_lm_args(tmp, mode, out):
    args = ["--dict", str(tmp / "dict.txt"), "--out", str(out)]
    if mode == "uniform":
        return args + ["--uniform-from-wordlist", str(tmp / "words.txt")]
    args += ["--corpus", str(tmp / "corpus.txt"), "--order", "3"]
    if mode == "native":
        return args + ["--no-format", "--native"]
    return args + ["--prune", "1e-2"]


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_world")
    (tmp / "dict.txt").write_text(DICT)
    (tmp / "corpus.txt").write_text("\n".join(RAW_CORPUS) + "\n")
    (tmp / "words.txt").write_text("cat\nhat\nmat\nzebra\n")
    return tmp


@pytest.mark.parametrize("mode", ["python", pytest.param("native", marks=needs_gxx), "uniform"])
def test_build_lm_matches_the_jax_cli(lm_world, mode):
    """One corpus and dict through both packages' build_lm: a byte-equal
    lexicon.txt and the same ARPA tables (n-grams, log-probs and backoffs
    within 1e-6), pruned and unpruned."""
    from b2txt_tpu_torch.lm import read_arpa
    from b2txt_tpu_torch.scripts import build_lm

    ref, ours = lm_world / f"jax_{mode}", lm_world / f"port_{mode}"
    _run_jax_cli("build_lm.py", _build_lm_args(lm_world, mode, ref))
    lm = build_lm.main(_build_lm_args(lm_world, mode, ours))
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(ours))
    assert ("lm_unpruned.arpa" in names) == (mode == "python")
    assert (ours / "lexicon.txt").read_bytes() == (ref / "lexicon.txt").read_bytes()
    assert "AE1" not in (ours / "lexicon.txt").read_text()
    for name in names:
        if not name.endswith(".arpa"):
            continue
        a, b = read_arpa(str(ours / name)), read_arpa(str(ref / name))
        assert len(a) == len(b) and all(set(x) == set(y) for x, y in zip(a, b)), name
        for x, y in zip(a, b):
            for gram, (lp, bo) in x.items():
                assert y[gram] == pytest.approx((lp, bo), abs=1e-6), (name, gram)
    if mode == "uniform":
        assert sorted(w.lower() for w in lm.vocab if not w.startswith("<")) == [
            "cat", "hat", "mat"]


DECODE_ARGS = ["--acoustic_scale", "0.5", "--blank_penalty", "1.0", "--beam_width", "64"]


@pytest.fixture(scope="module")
def decode_world(lm_world):
    """The port's LM dir, planted logits in both layouts (one utterance a
    file, and one (N, T, 41) file), and the JAX CLI's hyp file over them."""
    from b2txt_tpu_torch.lm import Lexicon, NGramLM
    from b2txt_tpu_torch.scripts import build_lm

    lm_dir = lm_world / "decode_lm"
    build_lm.main(["--corpus", str(lm_world / "corpus.txt"), "--dict",
                   str(lm_world / "dict.txt"), "--out", str(lm_dir), "--order", "3"])
    lm = NGramLM.from_arpa(str(lm_dir / "lm.arpa"))
    lexicon = Lexicon.from_file(str(lm_dir / "lexicon.txt"), vocab=lm.vocab)
    sents = ["the cat sat on the mat", "there is the cat", "the cat is there"]
    logits = [_clean_logits(lexicon.sentence_to_phonemes(s)) for s in sents]
    np.save(lm_world / "utt_a.npy", logits[0])
    tmax = max(x.shape[0] for x in logits[1:])

    def pad(x):   # hot-blank frames: harmless under CTC
        ext = np.full((tmax - x.shape[0], 41), -8.0, np.float32)
        ext[:, 0] = 0.0
        return np.concatenate([x, ext])

    np.save(lm_world / "utt_stack.npy", np.stack([pad(x) for x in logits[1:]]))
    ref = lm_world / "hyps_jax.txt"
    _run_jax_cli("decode_logits.py", ["--lm_dir", str(lm_dir), "--logits",
                                      str(lm_world / "utt_*.npy"), "--out", str(ref),
                                      *DECODE_ARGS])
    return lm_world, lm_dir, sents, ref


@pytest.mark.parametrize("backend", [pytest.param("native", marks=needs_gxx), "python",
                                     "device"])
def test_decode_logits_matches_the_jax_cli(decode_world, backend):
    """Each backend of the port's decode_logits (the device searcher on the
    CPU) writes the JAX CLI's hyp file, byte for byte: the planted sentences."""
    from b2txt_tpu_torch.scripts import decode_logits

    tmp, lm_dir, sents, ref = decode_world
    out = tmp / f"hyps_{backend}.txt"
    hyps = decode_logits.main(["--lm_dir", str(lm_dir), "--logits", str(tmp / "utt_*.npy"),
                               "--out", str(out), "--backend", backend, "--device", "cpu",
                               *DECODE_ARGS])
    assert out.read_bytes() == ref.read_bytes()
    assert list(hyps.values()) == sents


# ------------------------------------------------------- convert_checkpoint

def test_convert_checkpoint_round_trips_and_matches_the_jax_cli(tmp_path):
    """A reference .pt → the port's checkpoint → .pt again, every tensor bit
    for bit; the port's checkpoint holds the JAX CLI's parameters bit for
    bit, and --from-tpu on the JAX CLI's checkpoint writes the JAX CLI's
    .pt; a GRUDecoder loaded from the result gives the same logits."""
    import jax
    import torch

    from b2txt_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from b2txt_tpu_torch.models import GRUDecoder, params_to_jax
    from b2txt_tpu_torch.scripts import convert_checkpoint
    from b2txt_tpu_torch.scripts.evaluate_model import load_decoder
    from b2txt_tpu_torch.train.checkpoint import load_checkpoint
    from b2txt_tpu_torch.utils import TrainConfig

    cfg = TrainConfig()
    cfg.model.n_input_features, cfg.model.n_units, cfg.model.n_layers = 8, 12, 2
    model = GRUDecoder(cfg.model, 3, 41, device="cpu",
                       generator=torch.Generator().manual_seed(4))
    sd = model.state_dict()
    ref_pt = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": sd, "val_PER": 0.5}, ref_pt)

    ours, ours_pt = str(tmp_path / "port_ckpt"), str(tmp_path / "port.pt")
    convert_checkpoint.main(["--from-torch", ref_pt, "--out", ours])
    convert_checkpoint.main(["--from-tpu", ours, "--out", ours_pt])
    back = torch.load(ours_pt, weights_only=True)["model_state_dict"]
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    jax_ckpt, jax_pt, from_jax_pt = (str(tmp_path / n) for n in ("jax_ckpt", "jax.pt",
                                                                  "from_jax.pt"))
    _run_jax_cli("convert_checkpoint.py", ["--from-torch", ref_pt, "--out", jax_ckpt])
    ref_leaves = jax.tree_util.tree_leaves(jax_load_checkpoint(jax_ckpt)["params"])
    our_leaves = jax.tree_util.tree_leaves(params_to_jax(
        {k: torch.from_numpy(v) for k, v in load_checkpoint(ours)["params"].items()}))
    assert len(ref_leaves) == len(our_leaves)
    for a, b in zip(our_leaves, ref_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    _run_jax_cli("convert_checkpoint.py", ["--from-tpu", jax_ckpt, "--out", jax_pt])
    convert_checkpoint.main(["--from-tpu", jax_ckpt, "--out", from_jax_pt])
    ref, got = torch.load(jax_pt, weights_only=True), torch.load(from_jax_pt, weights_only=True)
    assert {k: v for k, v in ref.items() if k != "model_state_dict"} == {
        k: v for k, v in got.items() if k != "model_state_dict"}
    assert list(ref["model_state_dict"]) == list(got["model_state_dict"])
    for k, v in ref["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 8)).astype(np.float32))
    loaded = load_decoder(ours, cfg, torch.device("cpu"))
    with torch.no_grad():
        assert torch.equal(loaded(x, torch.tensor([0, 2])), model(x, torch.tensor([0, 2])))


# -------------------------------------------------------------- train_model

def test_train_model_matches_the_jax_cli(tmp_path, capsys):
    """One tiny args.yaml over HDF5 sessions from the port's writer, through
    both packages' train_model from the same initial parameters (each
    package's checkpoint of them; the files differ only in their paths):
    3 steps give parameters within 1e-5 (tests/test_torch_train.py's
    tolerance), and the port's best checkpoint loads in its evaluate_model."""
    import jax
    import torch

    from b2txt_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from b2txt_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
    from b2txt_tpu_torch.data import synthetic
    from b2txt_tpu_torch.models import GRUDecoder, params_to_jax
    from b2txt_tpu_torch.scripts import evaluate_model, train_model
    from b2txt_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from b2txt_tpu_torch.utils import TrainConfig

    data_dir = str(tmp_path / "data")
    synthetic.write_synthetic_sessions(data_dir, SESSIONS, trials_per_session=16, neural_dim=16)
    cfg = TrainConfig()
    cfg.model.n_input_features = cfg.dataset.neural_dim = 16
    cfg.model.n_units, cfg.model.n_layers = 48, 2
    cfg.model.rnn_dropout = cfg.model.input_network.input_layer_dropout = 0.0
    cfg.model.input_network.input_layer_sizes = [16]
    cfg.dataset.sessions = SESSIONS
    cfg.dataset.dataset_probability_val = [1, 1]
    cfg.dataset.batch_size, cfg.dataset.days_per_batch = 8, 2
    cfg.dataset.dataset_dir = data_dir
    dt = cfg.dataset.data_transforms
    dt.white_noise_std = dt.constant_offset_std = 0.0
    dt.random_cut = 0
    cfg.num_training_batches = cfg.lr_decay_steps = cfg.lr_decay_steps_day = 3
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 2
    cfg.lr_max = cfg.lr_max_day = 0.005
    cfg.epsilon = 0.1
    cfg.batches_per_val_step = 2
    cfg.use_amp = False
    cfg.save_final_model = True
    cfg.init_from_checkpoint = True

    init = GRUDecoder(cfg.model, 2, 41, device="cpu",
                      generator=torch.Generator().manual_seed(1)).state_dict()
    for pkg in ("jax", "port"):
        cfg.output_dir = str(tmp_path / pkg)
        cfg.checkpoint_dir = str(tmp_path / pkg / "checkpoint")
        cfg.init_checkpoint_path = str(tmp_path / f"{pkg}_init")
        if pkg == "jax":
            jax_save_checkpoint(cfg.init_checkpoint_path, params_to_jax(init))
        else:
            save_checkpoint(cfg.init_checkpoint_path, init)
        cfg.save(str(tmp_path / f"{pkg}_args.yaml"))
    _run_jax_cli("train_model.py", [str(tmp_path / "jax_args.yaml")])
    stats = train_model.main([str(tmp_path / "port_args.yaml"), "--device", "cpu"])
    assert len(stats["train_losses"]) == 3 and all(np.isfinite(stats["train_losses"]))

    name = "checkpoint/final_checkpoint_batch_2"
    ref = jax.tree_util.tree_leaves(jax_load_checkpoint(str(tmp_path / "jax" / name))["params"])
    ours = jax.tree_util.tree_leaves(params_to_jax(
        {k: torch.from_numpy(v) for k, v in
         load_checkpoint(str(tmp_path / "port" / name))["params"].items()}))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    assert not all(np.array_equal(a, b) for a, b in
                   zip(ours, jax.tree_util.tree_leaves(params_to_jax(init))))

    capsys.readouterr()
    evaluate_model.main(["--model_path", str(tmp_path / "port"), "--data_dir", data_dir,
                         "--device", "cpu"])
    assert "Aggregate greedy PER" in capsys.readouterr().out


# ------------------------------------------------------------ download_data

def test_download_data_matches_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs against one fake Dryad API (``urlopen`` patched; nothing
    leaves the process): the same files, the zip unpacked."""
    import io
    import json
    import urllib.request
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("hdf5_data_final/t15.2023.08.11/data_val.hdf5", b"not really hdf5")
    files = {"data.zip": buf.getvalue(), "README.md": b"readme"}
    api = {
        "/api/v2/datasets/": {"_links": {"stash:version": {"href": "/api/v2/versions/7"}}},
        "/api/v2/versions/7/files": {"_embedded": {"stash:files": [
            {"path": n, "_links": {"stash:download": {"href": f"/dl/{n}"}}} for n in files]}},
    }
    seen = []

    def urlopen(url, data=None, *a, **k):
        url = getattr(url, "full_url", url)
        seen.append(url)
        path = url.split("datadryad.org", 1)[1]
        if path.startswith("/dl/"):
            body = files[path[4:]]
        else:
            body = json.dumps(next(v for p, v in api.items() if path.startswith(p))).encode()
        r = io.BytesIO(body)
        r.info = lambda: {}
        return r

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    from b2txt_tpu_torch.scripts import download_data

    _run_jax_cli("download_data.py", ["--out", str(tmp_path / "jax")])
    n_jax = len(seen)
    download_data.main(["--out", str(tmp_path / "port")])
    assert len(seen) == 2 * n_jax == 8 and seen[:n_jax] == seen[n_jax:]

    def tree(root):
        return sorted((str(p.relative_to(root)), p.read_bytes()) for p in root.rglob("*")
                      if p.is_file())

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert (tmp_path / "port" / "hdf5_data_final" / "t15.2023.08.11" / "data_val.hdf5").exists()


# ------------------------------------------------------- eval_45session_sim

@needs_gxx
def test_eval_45session_sim_in_memory_equals_hdf5(tmp_path, capsys):
    """3 sessions × 4 trials at tiny widths on the CPU: the script's HDF5
    path (write, read back, evaluate) and its in-memory sessions give the
    same trials, logits, greedy ids, sentences, PER and WER."""
    from b2txt_tpu_torch.scripts import eval_45session_sim as sim

    args = sim.build_parser().parse_args(
        ["--sessions", "3", "--trials-per-session", "4", "--neural-dim", "16",
         "--beam_width", "16", "--device", "cpu", "--out", str(tmp_path)])
    cfg = sim.make_config(sim.session_names(args.sessions), args.neural_dim)
    cfg.model.n_units, cfg.model.n_layers = 32, 2
    hdf5 = sim.run(args, cfg)
    assert "12 trials" in capsys.readouterr().out
    memory = sim.evaluate(sim.make_model(cfg, "cpu"), cfg,
                          sim.simulated_sessions(cfg.dataset.sessions, 4, 16).items(),
                          sim.make_decoder(str(tmp_path), "native", 16, "cpu"))
    assert len(hdf5["trials"]) == len(memory["trials"]) == 12
    for a, b in zip(hdf5["trials"], memory["trials"]):
        assert (a.session, a.day_idx, a.trial_num) == (b.session, b.day_idx, b.trial_num)
        assert np.array_equal(a.logits, b.logits)
        assert a.decoded_ids == b.decoded_ids and a.true_ids == b.true_ids
        assert a.decoded_sentence == b.decoded_sentence and a.decoded_sentence is not None
    for key in ("greedy_PER", "WER"):
        assert hdf5[key] == memory[key] and np.isfinite(hdf5[key])
    assert [t.day_idx for t in memory["trials"]] == [0] * 4 + [1] * 4 + [2] * 4
