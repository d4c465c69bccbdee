"""The one CUDA-graph cache of the port (``utils/cuda_graphs.py``) off the
card, the capture stood in for: its reuse, refit and eviction policy in
each of its three owners (the device search's frame step, the DeepSeek and
OPT rescorers' packed forwards) at the owner's own capacity, kernel and
counter, the rescorers' key, the padded shape, and the OPT paths that run
op by op. On the card tests/test_torch_kernels_gpu.py holds the replayed
graphs to their eager runs. Imports neither JAX nor the JAX package."""

import weakref
from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import deepseek_lm as D
from b2txt_tpu_torch.decode import lmbeam_device as lb
from b2txt_tpu_torch.decode import opt_lm as O
from b2txt_tpu_torch.decode.packed_scorer import word_hash_encode
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.ops.beam_step import beam_step
from b2txt_tpu_torch.ops.moe import moe_experts
from b2txt_tpu_torch.utils.cuda_graphs import GraphCache
from b2txt_tpu_torch.utils.device import upload
from torch_search_world import CORPUS, LEX

CFG = D.DeepseekV2Config.tiny()
enc = word_hash_encode(CFG.vocab_size)


def _search():
    return lb.DeviceLexiconBeamSearch(Lexicon.from_words(LEX), train_ngram(CORPUS, order=3),
                                      device="cpu")


def _dsv2():
    return D.DeepseekV2Rescorer(CFG, enc, device="cpu")


OPT_CFG = O.OPTConfig.tiny()
opt_enc = word_hash_encode(OPT_CFG.vocab_size)


def _opt(**kw):
    return O.OPTRescorer(OPT_CFG, encode=opt_enc, encode_cont=lambda t, n: opt_enc(t, n + 1)[1:],
                         device="cpu", **kw)


@pytest.mark.parametrize("owner,capacity,kernel,counter", [
    (_search, 8, beam_step, "search.graph_captures"),
    (_dsv2, 16, moe_experts, "dsv2.graph_captures"),
    (_opt, 16, None, "opt.graph_captures"),
], ids=["search-8", "dsv2-16", "opt-16"])
def test_cache_reuses_refits_and_evicts(owner, capacity, kernel, counter):
    """An entry is made once for its key and served after; one that does not
    fit is dropped before its replacement is made (its graph's pool freed
    first); past the owner's capacity the least recently used goes. OPT's
    kernels are cuBLAS's and PyTorch's: its kernel is a counter of its own
    (``kernel`` None)."""
    cache = owner()._graphs
    assert isinstance(cache, GraphCache) and cache.capacity == capacity
    if kernel is None:
        kernel = cache.kernel
        assert kernel not in (beam_step, moe_experts) and kernel.launches == 0
    assert cache.kernel is kernel and cache.counter == counter
    made = []

    class Entry:
        def __init__(self, size):
            self.size = size

    def make(key, size=1, gone=None):
        def new():
            assert key not in cache.entries
            assert gone is None or gone() is None      # the old entry freed first
            made.append(key)
            return Entry(size)
        return new

    first = cache.get("a", make("a"))
    assert cache.get("a", make("a")) is first and made == ["a"]
    assert cache.get("a", make("a"), fits=lambda e: e.size >= 1) is first
    gone = weakref.ref(first)
    del first
    bigger = cache.get("a", make("a", 2, gone), fits=lambda e: e.size >= 2)
    assert bigger.size == 2 and made == ["a", "a"]

    for k in range(capacity - 1):
        cache.get(k, make(k))
    assert len(cache) == capacity
    cache.get(0, make(0))                         # 0 now the most recently used
    cache.get("b", make("b"))
    assert len(cache) == capacity and "a" not in cache.entries
    assert 0 in cache.entries and list(cache.entries)[-2:] == [0, "b"]
    cache.get(1, make(1))
    assert "a" not in cache.entries and len(made) == 2 + capacity
    assert made[-1] == "b"


class _Eager:
    """Stands in for a captured forward on the CPU: each replay runs it."""

    def __init__(self, step):
        self.step, self.out = step, step()

    def replay(self):
        self.out = self.step()


def test_dsv2_key_is_the_padded_shape():
    """Two n-best lists that pad to one shape share one entry, their
    tokens copied into its inputs at each replay; a list of another row or
    segment bucket captures anew."""
    resc = _dsv2()
    same = [["the cat sat on the mat", "a dog", "hello"],        # 1 row, bins 16
            ["we will see it", "an apple a day", "hi", "so"]]
    other = [["w%d x y z" % i for i in range(20)],               # 21 bins: 32
             [c * 7 for c in ("a b c d e f g h ", "i j k l m n o p ", "q r s t u v w x ")]]
    # the second of ``other``: 3 rows of 64 tokens, padded to 4

    def run(texts):
        tokens, seg, pos, n = resc._pack_arrays([enc(t, 256) for t in texts])
        inputs = [upload(x, resc.device) for x in (tokens, seg, pos)]
        with torch.inference_mode():
            got = resc._replay(n, *inputs)[0]
            want = resc._forward(n, *inputs)[0]
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return tokens.shape, n

    with mock.patch.object(resc._graphs, "capture",
                           side_effect=lambda step, device: _Eager(step)) as capture:
        shapes = [run(texts) for texts in same]
        assert shapes[0] == shapes[1] and capture.call_count == 1 and len(resc._graphs) == 1
        for i, texts in enumerate(other):
            assert run(texts) not in shapes
            assert capture.call_count == len(resc._graphs) == 2 + i
        run(same[0])
    assert capture.call_count == 3


OPT_TEXTS = ["the cat sat on the mat", "a dog", "we will see it tomorrow", "hello there",
             "an apple a day", "the quick brown fox", "jumps over the lazy dog", "hi", "so"]


def test_opt_replays_the_plain_packed_forward_alone():
    """Where ``_replays`` holds, OPT's packed forward is its shape's graph:
    the same scores, one capture a padded shape, served again at the next
    list of that shape. The prefix-KV context path and the unpacked rows run
    op by op and leave the cache as it was."""
    resc = _opt()
    want = _opt().score(OPT_TEXTS)
    unpacked = _opt(pack=False)
    ctx = "the shared conversation so far"
    want_ctx, want_unpacked = resc.score(OPT_TEXTS, context=ctx), unpacked.score(OPT_TEXTS)
    longer = [(t + " ") * 4 for t in OPT_TEXTS]         # 3 rows of 64, padded to 4
    want_longer = resc.score(longer)
    with mock.patch.object(O.OPTRescorer, "_replays", return_value=True), \
            mock.patch.object(resc._graphs, "capture",
                              side_effect=lambda step, device: _Eager(step)) as capture:
        np.testing.assert_array_equal(resc.score(OPT_TEXTS), want)
        np.testing.assert_array_equal(resc.score(OPT_TEXTS[::-1]), want[::-1])
        assert capture.call_count == len(resc._graphs) == 1
        resc.score(OPT_TEXTS[:2])                       # one row, 3 bins: the same shape
        assert capture.call_count == 1
        np.testing.assert_array_equal(resc.score(longer), want_longer)
        assert capture.call_count == len(resc._graphs) == 2
        np.testing.assert_array_equal(resc.score(OPT_TEXTS, context=ctx), want_ctx)
        np.testing.assert_array_equal(unpacked.score(OPT_TEXTS), want_unpacked)
        assert capture.call_count == len(resc._graphs) == 2 and resc.prefix_runs == 2
        assert len(unpacked._graphs) == 0
