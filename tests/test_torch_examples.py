"""The port's examples (b2txt_tpu_torch/examples/) and notebooks
(b2txt_tpu_torch/analyses/) against the JAX package's (examples/,
analyses/): the same inputs through both, on the CPU."""

import csv
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b2txt_tpu_torch.examples import (conversation_demo, figures_demo, lattice_demo,
                                      quickstart, spelling_demo, streaming_demo)
from b2txt_tpu_torch.models import GRUDecoder, params_from_jax

ROOT = Path(__file__).resolve().parent.parent


def _jax_example(name):
    """examples/<name>.py of the JAX package, loaded under its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nbest_close(a, b):
    assert [c[0] for c in a] == [c[0] for c in b]
    np.testing.assert_allclose([c[1:] for c in a], [c[1:] for c in b], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- streaming


def test_streamed_frames_equal_the_jax_demos():
    """Part A from the JAX demo's weights (init_params_from_config at
    PRNGKey(0)) carried across: the streamed frames equal the JAX demo's hop
    by hop (1e-5), and the offline forward."""
    from b2txt_tpu.models import gru_decoder

    cfg = streaming_demo.demo_model_config()
    params = gru_decoder.init_params_from_config(jax.random.PRNGKey(0), cfg, n_days=3,
                                                 n_classes=41)
    model = GRUDecoder(cfg, 3, 41, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    ours = streaming_demo.stream_gru(model, verbose=False)

    # the JAX demo's loop (examples/streaming_demo.py:59-83), keeping its frames
    patch, stride, L, H = cfg.patch_size, cfg.patch_stride, cfg.n_layers, cfg.n_units
    day = jnp.asarray([1])
    T = patch + 15 * stride
    bins = jnp.asarray(np.random.default_rng(0).standard_normal((T, 64)), jnp.float32)
    hop = jax.jit(lambda h, w: gru_decoder.forward(
        params, w[None], day, states=h, return_state=True, patch_size=patch,
        patch_stride=stride))
    h = jnp.broadcast_to(params["h0"], (L, 1, H))
    frames = []
    for t in range(0, T - patch + 1, stride):
        logits, h = hop(h, bins[t : t + patch])
        frames.append(np.asarray(logits[0, 0]))
    assert ours["streamed"].shape == (16, 41)
    np.testing.assert_allclose(ours["streamed"], np.stack(frames), rtol=1e-5, atol=1e-5)
    assert ours["max_abs_err"] < streaming_demo.STREAM_TOL_F32
    assert len(ours["hop_ms"]) == 16


@pytest.fixture(scope="module")
def jax_stream_decode():
    return _jax_example("streaming_demo").stream_decode(verbose=False)


@pytest.mark.parametrize("backend", ["python", "device"])
def test_stream_decode_equals_the_jax_demos(jax_stream_decode, backend):
    """Part B: the same partial after every chunk, the same final, the final
    n-best within 1e-4; the device searcher (on the CPU) as the python one."""
    ours = streaming_demo.stream_decode(backend=backend, device="cpu", verbose=False)
    assert ours["partials"] == jax_stream_decode["partials"]
    assert ours["partials"][-1] == ours["final"].sentence == ours["sentence"]
    assert ours["final"].sentence == jax_stream_decode["final"].sentence
    _nbest_close(ours["final"].nbest, jax_stream_decode["final"].nbest)
    assert len(ours["final"].nbest[0]) == 5


def test_streaming_main_on_the_cpu():
    out = streaming_demo.main(verbose=False, device="cpu")
    assert out["final"].sentence == out["sentence"] and out["hop_ms"] > 0


# ------------------------------------------------------------- quickstart


@pytest.fixture(scope="module")
def quickstart_runs(tmp_path_factory):
    """Sessions written once (their trials depend on the process), a JAX
    Trainer's weights after 3 steps, then the val split through the JAX
    evaluate_sessions and through the port's decode_and_score, from the files
    and from memory."""
    from b2txt_tpu.evaluate import evaluate_sessions, write_competition_csv
    from b2txt_tpu.lm import Lexicon, train_ngram
    from b2txt_tpu.serve import DecoderService
    from b2txt_tpu.train import Trainer
    from b2txt_tpu.data import synthetic
    from b2txt_tpu.utils.config import DecodeConfig, TrainConfig

    root = str(tmp_path_factory.mktemp("quickstart"))
    quickstart.write_data(root)
    cfg = quickstart.make_config(root, n_batches=3)
    jcfg = TrainConfig.from_dict(cfg.to_dict())
    trainer = Trainer(jcfg)
    trainer.train()

    decoder = DecoderService(
        Lexicon.from_words(synthetic.word_pronunciations()),
        train_ngram(synthetic.sentence_corpus(200), order=3),
        DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, nbest=10, beam_width=64),
        channel_order="model", searcher_backend="python")
    theirs = evaluate_sessions(trainer.params, jcfg, root, eval_type="val", decoder=decoder,
                               compute_dtype=jnp.float32)
    jax_csv = os.path.join(root, "jax_submission.csv")
    write_competition_csv(theirs["trials"], jax_csv)

    model = GRUDecoder(cfg.model, len(cfg.dataset.sessions), 41, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, trainer.params)))
    ours = quickstart.decode_and_score(model, cfg, root, quickstart.build_decoder(root))
    _, _, columns = quickstart.memory_data()
    in_memory = quickstart.decode_and_score(model, cfg, root, quickstart.build_decoder(root),
                                            session_data=columns)
    return theirs, jax_csv, ours, in_memory


def test_decode_and_score_equals_the_jax_evaluation(quickstart_runs):
    theirs, jax_csv, ours, in_memory = quickstart_runs
    assert ours["n_trials"] == len(theirs["trials"]) == 48
    for a, b in zip(ours["trials"], theirs["trials"]):
        assert (a.session, a.trial_num) == (b.session, b.trial_num)
        assert list(a.decoded_ids) == list(b.decoded_ids)
        assert a.decoded_sentence == b.decoded_sentence
    assert ours["greedy_PER"] == theirs["greedy_PER"]
    assert ours["WER"] == theirs["WER"]
    with open(ours["csv_path"]) as f, open(jax_csv) as g:
        assert list(csv.reader(f)) == list(csv.reader(g))
    # the sessions held in memory (hosts without h5py) decode as the files do
    assert [t.decoded_sentence for t in in_memory["trials"]] == \
        [t.decoded_sentence for t in ours["trials"]]
    assert (in_memory["greedy_PER"], in_memory["WER"]) == (ours["greedy_PER"], ours["WER"])


def test_quickstart_main_passes_the_jax_tests_bounds():
    """tests/test_quickstart.py's bounds, on the port's main at 40 batches."""
    out = quickstart.main(n_batches=40, device="cpu")
    assert out["n_trials"] > 0
    assert 0.0 <= out["greedy_PER"] <= 1.5
    assert 0.0 <= out["WER"] <= 1.5
    with open(out["csv_path"]) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["id", "text"]
    assert len(rows) == out["n_trials"] + 1


# ------------------------------------------------------------- conversation


def test_conversation_equals_the_jax_demo():
    """The same homophone picks; the prefix-KV and concatenated OPT scores of
    the JAX demo's tiny rescorer within 1e-4/1e-3 of the JAX ones, from its
    weights carried across."""
    from b2txt_tpu.decode import opt_lm as jax_opt
    from b2txt_tpu_torch.decode import opt_lm

    demo = _jax_example("conversation_demo")
    picks = conversation_demo.homophone_picks()
    assert picks == demo.main(verbose=False)
    assert picks == {"look at the sky": "the sun is bright here",
                     "he hugged his family": "the son is bright here"}

    ocfg = jax_opt.OPTConfig.tiny()
    enc = conversation_demo.byte_encode(ocfg.vocab_size)
    resc = jax_opt.OPTRescorer(ocfg, encode=enc, encode_cont=enc, max_len=64)
    ctx, texts = conversation_demo.CONTEXTS[0], conversation_demo.TEXTS
    want_prefix = np.asarray(resc.score(texts, context=ctx))
    want_concat = np.asarray(resc.score([ctx + " " + t for t in texts]))
    ours = conversation_demo.context_scoring(
        opt_lm.OPTConfig.tiny(), opt_lm.params_from_jax(resc.params, device="cpu"), "cpu")
    assert ours["prefix_runs"] == 1
    np.testing.assert_allclose(ours["prefix_kv"], want_prefix, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ours["concatenated"], want_concat, rtol=1e-4, atol=1e-3)
    assert conversation_demo.main(verbose=False, device="cpu") == picks


# ------------------------------------------------------------- lattice, spelling


def test_lattice_and_spelling_return_the_jax_demos_results():
    """Host-only demos (the native searcher): the same returned values as
    the JAX demos at the JAX tests' seeds and at the defaults."""
    lat, spell = _jax_example("lattice_demo"), _jax_example("spelling_demo")
    for kw in ({"n_utts": 3, "seed": 1}, {}):
        assert lattice_demo.main(verbose=False, **kw) == lat.main(verbose=False, **kw)
    for kw in ({"n_utts": 10, "seed": 1}, {}):
        assert spelling_demo.main(verbose=False, **kw) == spell.main(verbose=False, **kw)
    assert spelling_demo.spelled_corpus() == spell.spelled_corpus()
    res = lattice_demo.main(n_utts=3, seed=1, verbose=False)
    assert res["lattice"]["mean_depth"] > 3 * res["pool"]["mean_depth"]
    assert spelling_demo.main(n_utts=10, seed=1, verbose=False) >= 7


# ------------------------------------------------------------- figures


def test_figure_statistics_equal_the_jax_demos(quickstart_runs, tmp_path):
    """The data half's statistics over the same evaluated trials, as the JAX
    demo computes them (examples/figures_demo.py:86-116); the render half
    writes the JAX demo's six panels (examples/figures/)."""
    from b2txt_tpu.analysis import cumulative_usage, logit_raster, vocab_condition_comparison
    from b2txt_tpu.analysis import words_per_minute

    trials = quickstart_runs[2]["trials"]
    ours = figures_demo.figure_statistics(trials)
    fig2 = vocab_condition_comparison([{
        "day": t.session, "corpus": "50_word" if t.block_num % 2 == 0 else "125k_word",
        "reference": t.sentence_label or "", "decoded": t.decoded_sentence or ""}
        for t in trials], n_resamples=1000)
    assert ours["fig2"] == fig2
    np.testing.assert_array_equal(ours["raster"]["probs"], logit_raster(trials[0].logits)["probs"])
    usage = cumulative_usage([1.5, 2.0, 1.0], [40, 55, 30])
    for k, v in usage.items():
        np.testing.assert_array_equal(ours["usage"][k], v)
    assert ours["wpm"] == words_per_minute(
        [len((t.decoded_sentence or "").split()) for t in trials],
        [t.logits.shape[0] * 0.08 for t in trials], [t.session for t in trials])

    paths = figures_demo.render({"res": {"trials": trials}, **ours}, str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths) == sorted(
        p.name for p in (ROOT / "examples" / "figures").glob("*.png"))
    assert all(os.path.getsize(p) > 5000 for p in paths)


def test_figure_data_from_memory_on_the_cpu(tmp_path):
    """The data half as the card runs it: sessions in memory, no checkpoint."""
    data = figures_demo.figure_data(str(tmp_path), device="cpu", n_batches=2, in_memory=True,
                                    verbose=False)
    assert len(data["res"]["trials"]) == 3 * figures_demo.TRIALS_PER_SESSION
    assert set(data["wpm"]) == set(figures_demo.SESSIONS)
    assert (tmp_path / "fig2c_probs.npy").exists()
    assert not (tmp_path / "model" / "ckpt").exists()


# ------------------------------------------------------------- notebooks


@pytest.mark.parametrize("name,outdir,n_panels", [
    ("figure_2.ipynb", "figure_2_out", 3),
    ("figure_4.ipynb", "figure_4_out", 3),
])
def test_port_notebook_runs(tmp_path, monkeypatch, name, outdir, n_panels):
    """Cell by cell from a scratch directory, as tests/test_notebooks.py runs
    the JAX package's; the port's notebooks import only the port."""
    nb = json.loads((ROOT / "b2txt_tpu_torch" / "analyses" / name).read_text())
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(ROOT))
    ns = {}
    sources = ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]
    assert all("b2txt_tpu." not in s for s in sources)
    for src in sources:
        exec(compile(src, name, "exec"), ns)
    panels = sorted(tmp_path.joinpath(outdir).glob("*.png"))
    assert len(panels) == n_panels, panels
    assert all(p.stat().st_size > 5000 for p in panels)


@pytest.mark.parametrize("run", [
    lambda: streaming_demo.main(verbose=False),
    lambda: conversation_demo.main(verbose=False),
    lambda: quickstart.train(quickstart.make_config("unused", 1)),
    lambda: figures_demo.figure_data("unused", in_memory=True, verbose=False),
], ids=["streaming", "conversation", "quickstart", "figures"])
def test_demos_run_on_the_card_unless_told_otherwise(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
