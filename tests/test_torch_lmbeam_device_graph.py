"""The device searcher's frame step in static form (``_FrameGraph``), run op
by op on the CPU, against the eager frame loop bit for bit: final state,
backpointers, words and n-best. On the card the step is K6, the frame-step
kernel, and a CUDA graph of it replays each frame: there the replayed
search is held to the loop of ``_expand`` on the card, live beams as a set
(tests/test_torch_kernels_gpu.py holds K6 against ``_expand`` frame by
frame). Also the graph cache's keys, where the search takes the eager loop,
and K6's wrapper's checks. Imports neither JAX nor the JAX package."""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import lmbeam_device as lb
from b2txt_tpu_torch.decode.lmbeam_device import live_beams
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.lm.device_ngram import ShardedNGram
from b2txt_tpu_torch.utils.config import DecodeConfig
from b2txt_tpu_torch.utils.profiling import counters, tracing
from torch_search_world import CORPUS, LEX, SENTENCES, batch_of, noisy_logprobs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world():
    """tests/test_torch_lmbeam_device.py's world, the port's side: (lexicon,
    trigram, None, None, log-probs)."""
    lexicon = Lexicon.from_words(LEX)
    lps = [noisy_logprobs(lexicon.sentence_to_phonemes(s), seed=100 + i)
           for i, s in enumerate(SENTENCES)]
    return lexicon, train_ngram(CORPUS, order=3), None, None, lps


def _batch(world, lengths):
    """The world's utterances (56, 84 and 76 frames) in turn, cut to
    ``lengths`` (0: a padding row), as one (B, T, 41) batch padded with -20."""
    lps = world[4]
    rows = [lps[i % len(lps)][:n] if n else lps[0][:1] for i, n in enumerate(lengths)]
    batch, _ = batch_of(rows)
    return batch, np.asarray(lengths, np.int32)


def _static_scan(searcher, fg, lp, lengths):
    """``_scan_batch``'s frames as ``_frame_step`` calls on ``fg``'s buffers."""
    n = min(lp.shape[1], int(lengths.max()))
    fg.load(searcher._make_state(lp.shape[0]), lp, torch.from_numpy(lengths.astype(np.int64)), n)
    for _ in range(n):
        searcher._frame_step(fg)
    return fg.result(n)


def _nbest(searcher, state, recs):
    final = tuple(t.cpu().numpy() for t in searcher._finalize(state))
    return searcher._extract_results(final, tuple(r.cpu().numpy() for r in recs), None)


def _assert_same_live(searcher, got, want):
    """The same live beams in every row, with the same words, and the same
    n-best: where K6 and ``torch.topk`` order beams of equal totals
    differently, the beams' slots (and so the parents) differ."""
    live = live_beams(*got)
    assert live == live_beams(*want) and any(live)
    assert _nbest(searcher, *got) == _nbest(searcher, *want)


def _card_replay_equals_eager(cfg, state_key, batches):
    """On the card: each batch's frames replayed from the captured graph of
    K6 against ``_expand``'s loop on the card; one capture for both batches,
    every frame one K6 launch."""
    from b2txt_tpu_torch.ops.beam_step import beam_step

    lexicon, lm = batches[0][0], batches[0][1]
    searcher = lb.DeviceLexiconBeamSearch(lexicon, lm, cfg, state_key=state_key, device="cuda")
    before = beam_step.launches
    with tracing(), torch.inference_mode():
        for _, _, lp, lens in batches:
            lp = torch.from_numpy(lp).cuda()
            got = searcher._scan_batch(searcher._make_state(lp.shape[0]), lp, lens)
            n = int(lens.max())
            want = searcher._scan_eager(searcher._make_state(lp.shape[0]), lp, lens,
                                        torch.from_numpy(lens.astype(np.int64)).cuda(), n)
            _assert_same_live(searcher, got, want)
    frames = sum(int(b[3].max()) for b in batches)
    c = counters()
    assert c["search.graph_frames"] == frames and c["search.graph_captures"] == 1
    assert beam_step.launches - before == frames + 2   # the capture's two warm-up steps


def _assert_same_scan(searcher, got, want):
    (st_g, (par_g, wd_g)), (st_w, (par_w, wd_w)) = got, want
    for name, a, b in zip(lb.LmBeamState._fields, st_g, st_w):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert par_g.dtype == par_w.dtype == torch.int16 and torch.equal(par_g, par_w)
    assert wd_g.dtype == wd_w.dtype == torch.int32 and torch.equal(wd_g, wd_w)
    assert _nbest(searcher, *got) == _nbest(searcher, *want)


@pytest.mark.parametrize("lengths,sum_mode,first_beam,state_key", [
    ((50, 84, 70), True, 0, "history"),          # unequal lengths
    ((50, 84, 70), True, 6, "history"),
    ((50, 84, 70), False, 8, "history"),
    ((50, 84, 70), False, 0, "ngram"),
    ((56, 0, 76, 0), True, 6, "history"),        # padded with length-0 rows
    ((56, 0, 76, 0), False, 8, "ngram"),
    ((56, 56, 56), False, 0, "history"),         # every frame unmasked
])
def test_static_frame_step_equals_eager_scan(world, lengths, sum_mode, first_beam, state_key):
    """The static step, masked on every frame, reading frame t by index from
    a buffer with more frames than the batch (left NaN past it), gives the
    eager loop's bits; so does a second, shorter batch through the same
    buffers."""
    lexicon, lm = world[0], world[1]
    cfg = DecodeConfig(nbest=10, beam_width=64, acoustic_scale=0.5, blank_penalty=1.0,
                       first_beam_size=first_beam, ctc_blank_skip_threshold=1.0,
                       sum_mode=sum_mode)
    searcher = lb.DeviceLexiconBeamSearch(lexicon, lm, cfg, state_key=state_key, device="cpu")
    with torch.inference_mode():
        lp, lens = _batch(world, lengths)
        lp = torch.from_numpy(lp)
        fg = lb._FrameGraph(searcher, lp.shape[0], lp.shape[1] + 7, lp.shape[2], CPU)
        fg.lp.fill_(float("nan"))
        eager = searcher._scan_batch(searcher._make_state(lp.shape[0]), lp, lens)
        assert eager[1][0].shape[0] == max(lengths)
        _assert_same_scan(searcher, _static_scan(searcher, fg, lp, lens), eager)

        shorter = np.minimum(lens, 40)
        lp2 = torch.flip(lp, [0])[:, :40]
        eager2 = searcher._scan_batch(searcher._make_state(lp.shape[0]), lp2, shorter)
        _assert_same_scan(searcher, _static_scan(searcher, fg, lp2, shorter), eager2)
    if torch.cuda.is_available():
        _card_replay_equals_eager(cfg, state_key, [
            (lexicon, lm, lp.numpy(), lens),
            (lexicon, lm, np.ascontiguousarray(lp2.numpy()), shorter)])


def _searcher(world, **cfg):
    return lb.DeviceLexiconBeamSearch(world[0], world[1], DecodeConfig(beam_width=16, **cfg),
                                      device="cpu")


def test_graph_cache_keys(world):
    """A captured entry serves only its shape, step options and LM: a
    set_opt with other step options, another dev_lm or a batch past the
    entry's frame capacity captures anew; the cache keeps GRAPH_CACHE."""
    s = _searcher(world, first_beam_size=6)
    captured = []
    with mock.patch.object(s, "_capture", side_effect=captured.append), torch.inference_mode():
        fg = s._frame_graph(3, 41, 10, CPU)
        assert fg.T_cap == lb.GRAPH_T_STEP and len(captured) == 1
        assert s._frame_graph(3, 41, lb.GRAPH_T_STEP, CPU) is fg     # within capacity
        assert s._frame_graph(3, 41, 1, CPU) is fg
        assert fg.state.s.shape == (3, 16) and fg.lp.shape == (3, lb.GRAPH_T_STEP, 41)

        longer = s._frame_graph(3, 41, lb.GRAPH_T_STEP + 1, CPU)
        assert longer is not fg and longer.T_cap == 2 * lb.GRAPH_T_STEP
        assert s._frame_graph(3, 41, 5, CPU) is longer and len(s._graphs) == 1

        assert s._frame_graph(4, 41, 5, CPU) is not longer            # another B
        s.set_opt(DecodeConfig(beam_width=16, first_beam_size=6, acoustic_scale=0.7))
        other_args = s._frame_graph(3, 41, 5, CPU)
        assert other_args is not longer and other_args.args["scale"] == 0.7
        s.set_opt(DecodeConfig(beam_width=16, first_beam_size=6))
        assert s._frame_graph(3, 41, 5, CPU) is longer                # the options back

        base = s.dev_lm
        s.dev_lm = ShardedNGram.from_device_ngram(base, base.table[0], group=None)
        other_lm = s._frame_graph(3, 41, 5, CPU)
        assert other_lm is not longer and other_lm.dev_lm is s.dev_lm
        s.dev_lm = base
        assert s._frame_graph(3, 41, 5, CPU) is longer
        assert len(captured) == 5

        for B in range(5, 5 + lb.GRAPH_CACHE):
            s._frame_graph(B, 41, 5, CPU)
        assert len(s._graphs) == lb.GRAPH_CACHE
        assert longer not in s._graphs.values()                       # least recently used
        assert len(captured) == 5 + lb.GRAPH_CACHE


def test_eager_loop_off_the_card_and_with_the_sharded_lm(world):
    """Replays engage only for a tensor on the card with a plain
    DeviceNGram: the CPU, and the sharded LM on the card, run the eager
    loop. Off the card the counters read frames and no replayed frame."""
    s = _searcher(world)
    on_card = SimpleNamespace(device=torch.device("cuda", 0))
    assert s._replays(on_card)
    assert not s._replays(torch.zeros(1))
    base = s.dev_lm
    s.dev_lm = ShardedNGram.from_device_ngram(base, base.table[0], group=None)
    assert not s._replays(on_card)
    s.dev_lm = base

    lp, lens = _batch(world, (56, 30))
    with mock.patch.object(s, "_scan_graph") as graph, tracing(), torch.inference_mode():
        _, (parents, _) = s._scan_batch(s._make_state(2), torch.from_numpy(lp), lens)
    graph.assert_not_called()
    assert parents.shape == (56, 2, 16)
    assert counters().get("search.frames") == 56 and "search.graph_frames" not in counters()


def _fg(world, **cfg):
    s = _searcher(world, **cfg)
    with torch.inference_mode():
        fg = lb._FrameGraph(s, 3, 16, 41, CPU)
    return s, fg


def test_beam_step_raises_on_cpu_tensors(world):
    """K6 has no CPU mode: its wrapper refuses a tensor off the card."""
    from b2txt_tpu_torch.ops.beam_step import beam_step

    s, fg = _fg(world, first_beam_size=6)
    before = beam_step.launches
    with pytest.raises(ValueError, match="runs on CUDA tensors only"):
        s._kernel_step(fg.state, fg.lp, fg.lens, fg.t, fg.ticket, fg.parents, fg.words,
                       fg.work)
    assert beam_step.launches == before


@pytest.mark.parametrize("K,first_beam,limit", [
    (1024, 8, "shared memory"),                 # the candidates' sorts outgrow a CTA
    (512, None, "shared memory"),
])
def test_beam_step_raises_past_its_limits(world, K, first_beam, limit):
    """A shape whose beams' own arrays outgrow a CTA's shared memory is
    refused, naming the limit, before anything is launched; the session
    evaluation's shape (K = 48, H = 4, trigram) keeps its candidates in
    shared memory too, and the repo's widest (K = 128, H = 6, 5-gram) runs
    with a workspace for them."""
    from b2txt_tpu_torch.ops.beam_step import SMEM_BYTES, layout

    s, _ = _fg(world, first_beam_size=first_beam or 0)
    s.config.beam_width = K
    with torch.inference_mode():
        fg = lb._FrameGraph(s, 2, 16, 41, CPU)
    with pytest.raises(ValueError, match=f"{limit}.*over the limit of {SMEM_BYTES} B"):
        s._kernel_step(fg.state, fg.lp, fg.lens, fg.t, fg.ticket, fg.parents, fg.words,
                       fg.work)
    assert layout(48, 41, 4, 2, 3)[0] < SMEM_BYTES and layout(48, 41, 4, 2, 3)[2] == 0
    assert layout(128, 41, 6, 4, 5)[1] < SMEM_BYTES < sum(layout(128, 41, 6, 4, 5)[1:])


def test_beam_step_workspace_for_the_widest_beams(world):
    """At K = 128 with every phone in the first beam (the DecodeConfig
    default) the candidates outgrow shared memory: ``_FrameGraph`` holds a
    workspace of the wrapper's size, and the wrapper refuses a launch
    without one, naming the bytes, before it looks at the device."""
    from b2txt_tpu_torch.ops.beam_step import layout

    s, _ = _fg(world)
    s.config.beam_width = 128
    with torch.inference_mode():
        fg = lb._FrameGraph(s, 2, 16, 41, CPU)
    per_row = layout(128, 41, s.H, fg.state.ctx.shape[-1], s.dev_lm.order)[2]
    assert per_row > 0 and fg.work.dtype == torch.uint8 and fg.work.numel() == 2 * per_row
    args = (fg.state, fg.lp, fg.lens, fg.t, fg.ticket, fg.parents, fg.words)
    with pytest.raises(ValueError, match=f"workspace of {2 * per_row} B"):
        s._kernel_step(*args, None)
    with pytest.raises(ValueError, match=f"workspace of {2 * per_row} B"):
        s._kernel_step(*args, fg.work[:-1])
    with pytest.raises(ValueError, match="runs on CUDA tensors only"):
        s._kernel_step(*args, fg.work)
    assert lb._FrameGraph(_fg(world)[0], 2, 16, 41, CPU).work.numel() == 0   # K = 16


def test_frame_step_and_streaming_decode_launch_the_kernel_where_they_replay(world):
    """Where ``_replays`` holds, the graph's step and the streaming decode
    are K6's launches with the searcher's options (the step advancing ``t``,
    the stream one launch a kept frame at its offset and one unrecorded for
    a reinserted blank frame), and ``_expand`` is not called; where it does
    not (the CPU here), ``_expand`` runs and K6 never."""
    s, fg = _fg(world, first_beam_size=6, sum_mode=False, length_penalty=-0.5)
    s.close_top = 2
    with mock.patch.object(lb, "beam_step") as k6, mock.patch.object(s, "_expand") as expand, \
            mock.patch.object(s, "_replays", return_value=True), torch.inference_mode():
        s._frame_step(fg)
        (state, lp, lens, t, ticket, parents, words, trie, dev_lm), kw = k6.call_args
        assert state is fg.state and lp is fg.lp and lens is fg.lens and t is fg.t
        assert ticket is fg.ticket and parents is fg.parents and words is fg.words
        assert trie is s.trie and dev_lm is s.dev_lm
        assert kw == dict(scale=s.config.acoustic_scale, length_penalty=-0.5, first_beam=6,
                          sum_mode=False, beam=17.0, close_top=2, ngram_key=False,
                          blank=s.blank, sil=s.sil, la0=s.la0, t_offset=0, advance=True,
                          work=fg.work)

        k6.reset_mock()
        s.set_opt(DecodeConfig(beam_width=16, ctc_blank_skip_threshold=0.5, blank_penalty=1.0))
        lp = np.full((5, 41), -9.0, np.float32)
        lp[[0, 2, 3], 5] = 0.0
        lp[[1, 4], 0] = 0.0                 # frames 1 and 4 skipped: 2 reinserts a blank
        s.reset()
        s.decode(lp)
        calls = [(c.args[1].shape, c.args[5] is None, c.kwargs["t_offset"], c.kwargs["advance"])
                 for c in k6.call_args_list]
        assert calls == [((1, 5, 41), False, 0, False), ((1, 1, 41), True, 0, False),
                         ((1, 5, 41), False, 2, False), ((1, 5, 41), False, 3, False)]
        parents, words = s.records[-1]
        assert parents.shape == words.shape == (5, 16) and (words[[1, 4]] == -1).all()
        assert (parents[[1, 4]] == np.arange(16)).all()
        expand.assert_not_called()

    with mock.patch.object(lb, "beam_step", side_effect=AssertionError("K6 on the CPU")), \
            torch.inference_mode():
        s.reset()
        s.decode(lp)
        lp_b, lens = _batch(world, (20, 12))
        _, (par, _) = s._scan_batch(s._make_state(2), torch.from_numpy(lp_b), lens)
        s._frame_step(fg)
    assert par.shape == (20, 2, 16) and s.n_frames == 5
