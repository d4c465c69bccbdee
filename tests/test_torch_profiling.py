"""The port's tracer (``utils/profiling``): its summary counts as the JAX
package's stage timer does; spans are nothing while tracing is off, nest
with their parents and request ids while it is on, start recording by
themselves under ``torch.profiler`` on its clock, and sit in the Chrome trace
of ``device_trace``; the program's spans are where the work happens
(session evaluation, the device search, the service, OPT, the Trainer)."""

import json

import numpy as np
import pytest
import torch

from b2txt_tpu.utils.profiling import StageTimer as JaxStageTimer
from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer
from b2txt_tpu_torch.evaluate import evaluate_session_data
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.models import GRUDecoder
from b2txt_tpu_torch.ops.smoothing import gaussian_kernel
from b2txt_tpu_torch.serve import DecoderService
from b2txt_tpu_torch.utils import TrainConfig
from b2txt_tpu_torch.utils import profiling
from b2txt_tpu_torch.utils.config import DecodeConfig
from b2txt_tpu_torch.utils.profiling import (count, counters, device_trace, kernel_launches,
                                             records, span, summary, tracing)

LEX = {"the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
       "mat": ["M", "AE", "T"], "on": ["AA", "N"]}
CORPUS = ["the cat sat on the mat".split(), "the cat sat".split()] * 4
KNOBS = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=32, beam=0.0)


def service(**kw):
    return DecoderService(Lexicon.from_words(LEX), train_ngram(CORPUS, order=2),
                          DecodeConfig(**{**KNOBS, **kw.pop("knobs", {})}),
                          channel_order="model", **kw)


def logits(seed=0, T=24):
    return np.random.default_rng(seed).standard_normal((T, 41)).astype(np.float32)


def by_name(recs):
    out = {}
    for i, r in enumerate(recs):
        out.setdefault(r.name, []).append(i)
    return out


def test_stage_timer_counts_as_the_jax_one():
    """``summary()`` over spans keeps the JAX stage timer's counts, keys and
    order of names, a span left by an exception included."""
    jax_timer = JaxStageTimer()

    def stages(stage):
        for name in ["load", "decode", "decode", "rescore", "decode"]:
            with stage(name):
                pass
        try:
            with stage("fails"):
                raise ValueError
        except ValueError:
            pass

    with tracing():
        stages(span)
    stages(jax_timer.stage)
    ours, ref = summary(), jax_timer.summary()
    assert list(ours) == list(ref) == ["load", "decode", "rescore", "fails"]
    for name in ref:
        assert ours[name]["count"] == ref[name]["count"]
        assert set(ours[name]) == set(ref[name])
        assert ours[name]["total_s"] >= 0


def test_device_trace_holds_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with device_trace(str(tmp_path)):
        with span("stage1_batch"):
            y = x @ x
    assert y.shape == (64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "stage1_batch" in names
    assert any("mm" in str(n) for n in names)
    assert [r.name for r in records()] == ["stage1_batch"]


def test_off_records_nothing():
    with tracing():
        pass                      # an empty recording, then tracing off
    svc = service()
    svc.decode_utterance(logits(), chunk=8)
    assert records() == [] and counters() == {}
    assert span("a") is span("b", rid=3) is profiling._NO_SPAN
    with span("a") as s:
        assert s.rid is None
    count("c")
    assert counters() == {} and profiling.current_rid() is None


def test_spans_nest_with_parents_and_request_ids():
    with tracing():
        with span("outer", rid="r1") as outer:
            with span("inner", k=2) as inner:
                count("n", 3)
                count("n")
            with span("sibling", rid="r2"):
                assert profiling.current_rid() == "r2"
        with span("alone"):
            pass
        with pytest.raises(KeyError):
            with span("raises"):
                raise KeyError
    assert outer.rid == inner.rid == "r1"
    recs = records()
    assert [r.name for r in recs] == ["outer", "inner", "sibling", "alone", "raises"]
    assert [r.parent for r in recs] == [None, 0, 0, None, None]
    assert [r.rid for r in recs] == ["r1", "r1", "r2", None, None]
    assert recs[1].attrs == {"k": 2} and counters() == {"n": 4}
    for r in recs:
        assert r.start_ns <= r.end_ns
    assert recs[0].start_ns <= recs[1].start_ns <= recs[1].end_ns <= recs[2].start_ns
    assert recs[2].end_ns <= recs[0].end_ns


def test_threads_record_every_span_and_count():
    """Threads share one recording: no span or count is lost, and each
    span's parent is the span open around it on its own thread."""
    import sys
    import threading

    def work(k):
        for i in range(100):
            with span("outer", rid=k):
                with span("inner"):
                    count("n")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = records()
    assert len(recs) == 16 * 200 and counters() == {"n": 1600}
    for r in recs:
        if r.name == "inner":
            parent = recs[r.parent]
            assert parent.name == "outer" and parent.rid == r.rid
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns


@pytest.mark.parametrize("given", [None, "1700000000000-0"])
@pytest.mark.parametrize("n_utts", [1, 2])
def test_one_request_id_per_utterance(n_utts, given):
    svc = service()
    with tracing():
        for u in range(n_utts):
            svc.reset(request_id=None if given is None else f"{given}{u}")
            for c in range(0, 24, 8):
                svc.decode_chunk(logits(u)[c: c + 8])
            svc.finalize()
    recs = records()
    assert [r.name for r in recs].count("serve.finalize") == n_utts
    rids = [r.rid for r in recs]
    assert None not in rids and len(set(rids)) == n_utts
    # each request's spans run from its first chunk to its finalize
    for u, rid in enumerate(dict.fromkeys(rids)):
        names = [r.name for r in recs if r.rid == rid]
        assert names == ["serve.decode_chunk"] * 3 + ["serve.finalize"]
        if given is not None:
            assert rid == f"{given}{u}"


def test_recording_starts_under_the_profiler():
    with tracing():
        with span("earlier"):
            pass
    assert not profiling._profiler_enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("profiled"):
            count("k")
    # the earlier recording is cleared; the profiled one stays readable after
    assert [r.name for r in records()] == ["profiled"] and counters() == {"k": 1}
    assert span("after") is profiling._NO_SPAN


def test_spans_are_on_the_profilers_clock():
    """Exported spans start and end within 1 ms of the ``record_function``
    events they opened: each lies inside its event's interval (1 ms of
    slack), and the median gap at either end is under 1 ms (a single span
    can be pushed further inside by the scheduler, never outside)."""
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(10):
            with span(f"clock.{i}"):
                with span(f"clock.{i}.inner"):
                    x = torch.tanh(x @ x)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    recs = records()
    assert len(recs) == 20 and set(events) == {r.name for r in recs}
    starts, ends = [], []
    for r in recs:
        a = events[r.name].start_ns()
        b = a + events[r.name].duration_ns()
        assert a - 1e6 <= r.start_ns <= r.end_ns <= b + 1e6, (r, a, b)
        starts.append(r.start_ns - a)
        ends.append(b - r.end_ns)
    assert abs(np.median(starts)) < 1e6 and abs(np.median(ends)) < 1e6, (starts, ends)


def test_train_step_spans_in_order(tmp_path):
    from b2txt_tpu_torch.data.synthetic import synthetic_trials
    from b2txt_tpu_torch.train import Trainer

    cfg = TrainConfig()
    cfg.model.n_input_features = cfg.dataset.neural_dim = 8
    cfg.model.n_units, cfg.model.n_layers = 16, 1
    cfg.model.input_network.input_layer_sizes = [8]
    cfg.dataset.sessions = ["t15.2023.08.11", "t15.2023.08.13"]
    cfg.dataset.batch_size, cfg.dataset.days_per_batch = 4, 2
    cfg.num_training_batches = 2
    cfg.use_amp = False
    cfg.output_dir, cfg.checkpoint_dir = str(tmp_path), str(tmp_path / "ckpt")
    trainer = Trainer(cfg, device="cpu",
                      train_trials=synthetic_trials(cfg.dataset.sessions, 4, 8))
    rng = np.random.default_rng(0)
    batch = {"input_features": torch.from_numpy(rng.standard_normal((4, 64, 8), np.float32)),
             "seq_class_ids": torch.from_numpy(rng.integers(1, 41, (4, 6)).astype(np.int32)),
             "n_time_steps": torch.full((4,), 64, dtype=torch.int32),
             "phone_seq_lens": torch.full((4,), 6, dtype=torch.int32),
             "day_indicies": torch.tensor([0, 1, 0, 1], dtype=torch.int32)}
    with tracing():
        loss, _ = trainer.train_step(batch)
    assert np.isfinite(float(loss))
    recs = records()
    assert recs[0].name == "train.step" and recs[0].parent is None
    children = [r.name for r in recs if r.parent == 0]
    assert children == ["train.augment", "train.forward", "train.loss", "train.backward",
                        "train.optimizer"]


def test_opt_spans_sit_under_the_finalize():
    cfg = OPTConfig.tiny()
    llm = OPTRescorer(cfg, device="cpu", max_len=24,
                      encode=lambda t, n: [2] + [10 + len(w) for w in t.split()][: n - 1])
    svc = service(llm=llm, knobs=dict(do_opt=True))
    with tracing():
        svc.decode_utterance(logits(), chunk=8)
    recs = by_name(records())
    (fin,) = recs["serve.finalize"]
    (dispatch,), (fetch,) = recs["opt.dispatch"], recs["opt.fetch"]
    allr = records()
    assert allr[dispatch].parent == fin and allr[fetch].parent == fin
    assert allr[dispatch].end_ns <= allr[fetch].start_ns
    assert allr[dispatch].rid == allr[fetch].rid == allr[fin].rid is not None


def test_evaluation_and_device_search_spans():
    """One evaluation call on the CPU through the device searcher: the
    session's stage 1 and the search under ``eval.call``, the searcher's
    issue and n-best extraction under ``eval.search`` (no event to wait on
    off the card), the frames it scanned and the trials counted."""
    cfg = TrainConfig()
    cfg.model.n_input_features = cfg.dataset.neural_dim = 8
    cfg.model.n_units, cfg.model.n_layers = 16, 1
    cfg.dataset.sessions = ["day0"]
    model = GRUDecoder(cfg.model, 1, 41, device="cpu")
    lex, lm = Lexicon.from_words(LEX), train_ngram(CORPUS, order=2)
    dcfg = DecodeConfig(**KNOBS)
    svc = DecoderService(lex, lm, dcfg, channel_order="model", searcher_backend="device",
                         searcher=DeviceLexiconBeamSearch(lex, lm, dcfg, device="cpu"))
    rng = np.random.default_rng(1)
    n = 3
    data = {"neural_features": [rng.standard_normal((t, 8)).astype(np.float32)
                                for t in (40, 56, 72)],
            "seq_class_ids": [None] * n, "seq_len": [0] * n, "block_num": [0] * n,
            "trial_num": list(range(n)), "sentence_label": [None] * n}
    with tracing():
        out = evaluate_session_data(model, cfg, [("day0", data)], decoder=svc,
                                    device_resident=True)
    assert len(out["trials"]) == n
    recs = records()
    names = by_name(recs)
    (call,) = names["eval.call"]
    assert [recs[i].parent for i in names["eval.stage1"] + names["eval.search"]] == [call, call]
    (search,) = names["eval.search"]
    for name in ("search.issue", "search.extract"):
        assert [recs[i].parent for i in names[name]] == [search]
    assert "search.wait" not in names
    assert len(names["serve.finalize"]) == n
    assert len({recs[i].rid for i in names["serve.finalize"]}) == n
    # one batch of the three trials, scanned to the longest one's frames
    dt = cfg.dataset.data_transforms
    k = len(gaussian_kernel(dt.smooth_kernel_std, dt.smooth_kernel_size))
    frames = (72 - k + 1 - cfg.model.patch_size) // cfg.model.patch_stride + 1
    assert counters() == {"eval.trials": n, "search.frames": frames}


def test_kernel_launches_counts_every_hand_written_kernel():
    assert set(kernel_launches()) == {"gru_fwd", "gru_bwd", "preprocess", "row_gather"}
