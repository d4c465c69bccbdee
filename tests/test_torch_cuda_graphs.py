"""The one CUDA-graph cache of the port (``utils/cuda_graphs.py``) off the
card, the capture stood in for: its reuse, refit and eviction policy in
each of its two owners (the device search's frame step, the DeepSeek
rescorer's forward) at the owner's own capacity, kernel and counter, and
the rescorer's key, the padded shape. On the card
tests/test_torch_kernels_gpu.py holds both replayed graphs to their eager
runs. Imports neither JAX nor the JAX package."""

import weakref
from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode import deepseek_lm as D
from b2txt_tpu_torch.decode import lmbeam_device as lb
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


@pytest.mark.parametrize("owner,capacity,kernel,counter", [
    (_search, 8, beam_step, "search.graph_captures"),
    (_dsv2, 16, moe_experts, "dsv2.graph_captures"),
], ids=["search-8", "dsv2-16"])
def test_cache_reuses_refits_and_evicts(owner, capacity, kernel, counter):
    """An entry is made once for its key and served after; one that does not
    fit is dropped before its replacement is made (its graph's pool freed
    first); past the owner's capacity the least recently used goes."""
    cache = owner()._graphs
    assert isinstance(cache, GraphCache) and cache.capacity == capacity
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
