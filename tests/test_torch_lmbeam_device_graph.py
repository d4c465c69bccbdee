"""The device searcher's frame step in static form (``_FrameGraph``), run op
by op on the CPU, against the eager frame loop bit for bit: final state,
backpointers, words and n-best. On the card the same step is what a CUDA
graph captures and replays (tests/test_torch_kernels_gpu.py holds the
replay against the loop there). Also the graph cache's keys, and where the
search takes the eager loop."""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import lmbeam_device as lb
from b2txt_tpu_torch.lm.device_ngram import ShardedNGram
from b2txt_tpu_torch.utils.config import DecodeConfig
from b2txt_tpu_torch.utils.profiling import counters, tracing

from test_torch_lmbeam_device import (  # noqa: F401  (fixtures)
    batch_of, noisy_logprobs, world,
)

CPU = torch.device("cpu")


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
    final = tuple(t.numpy() for t in searcher._finalize(state))
    return searcher._extract_results(final, tuple(r.numpy() for r in recs), None)


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
