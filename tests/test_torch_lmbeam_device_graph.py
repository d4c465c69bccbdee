"""The device searcher's captured frame step (``_FrameGraph``) off the
card: the graph cache's keys, where the search takes ``_expand``'s loop,
that the captured step and the streaming decode are K6's launches with the
searcher's options, and K6's wrapper's checks. On the card
tests/test_torch_kernels_gpu.py holds the replayed graph of K6 to
``_expand``'s loop, and K6 to ``_expand`` frame by frame. Imports neither
JAX nor the JAX package."""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import lmbeam_device as lb
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


def _searcher(world, **cfg):
    return lb.DeviceLexiconBeamSearch(world[0], world[1], DecodeConfig(beam_width=16, **cfg),
                                      device="cpu")


def test_graph_cache_keys(world):
    """A captured entry serves only its shape, step options and LM: a
    set_opt with other step options, another dev_lm or a batch past the
    entry's frame capacity captures anew; the cache keeps GRAPH_CACHE."""
    s = _searcher(world, first_beam_size=6)
    captured = []
    with mock.patch.object(s._graphs, "capture", side_effect=lambda *a, **k: captured.append(a)), \
            torch.inference_mode():
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
        assert other_args is not longer and ("scale", 0.7) in list(s._graphs.entries)[-1][6]
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
        assert longer not in s._graphs.entries.values()               # least recently used
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
    """Where ``_replays`` holds, the graph's captured step and the streaming
    decode are K6's launches with the searcher's options (the step advancing
    ``t`` after two warm-ups, each from ``t`` = 0; the stream one launch a
    kept frame at its offset and one unrecorded for a reinserted blank
    frame), and ``_expand`` is not called; where it does not (the CPU here),
    the decode and the batch run ``_expand`` and K6 never. The captured step
    has no CPU fallback: there K6's wrapper refuses it."""
    s = _searcher(world, first_beam_size=6, sum_mode=False, length_penalty=-0.5)
    s.close_top = 2
    step_once = mock.patch.object(s._graphs, "capture", side_effect=lambda step, *a, **k: step())
    with mock.patch.object(lb, "beam_step") as k6, mock.patch.object(s, "_expand") as expand, \
            mock.patch.object(s, "_replays", return_value=True), step_once as capture, \
            torch.inference_mode():
        fg = s._frame_graph(3, 41, 16, CPU)
        assert capture.call_args.args[1:] == (CPU,)
        assert capture.call_args.kwargs == dict(warmups=2, reset=fg.t.zero_)
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
    assert par.shape == (20, 2, 16) and s.n_frames == 5
    with step_once, pytest.raises(ValueError, match="runs on CUDA tensors only"):
        s._frame_graph(2, 41, 16, CPU)
