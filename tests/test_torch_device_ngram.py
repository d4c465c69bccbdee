"""The port's device n-gram model (b2txt_tpu_torch.lm.device_ngram) against
the JAX package's: the same keys bit for bit, the same packed table and
dense arrays, and the same probe results bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import device_ngram as jdn
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.lm import device_ngram as dn
from b2txt_tpu_torch.lm.ngram import BOS, EOS

LEX = {
    "the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
    "mat": ["M", "AE", "T"], "on": ["AA", "N"], "dog": ["D", "AO", "G"],
    "a": ["AH"], "and": ["AE", "N", "D"], "saw": ["S", "AO"],
    "rug": ["R", "AH", "G"], "play": ["P", "L", "EY"],
    "dogs": ["D", "AO", "G", "Z"], "cats": ["K", "AE", "T", "S"], "is": ["IH", "Z"],
}
CORPUS = [
    "the cat sat on the mat".split(),
    "the dog sat on the rug".split(),
    "a cat and a dog".split(),
    "the cat saw the dog".split(),
    "dogs and cats play".split(),
    "the dog is on the mat".split(),
] * 3
CONTEXTS = [[], [BOS], ["the"], ["the", "cat"], ["sat", "on"], [BOS, "the"],
            ["dogs", "and"], ["a"], ["on", "the"], ["the", "cat", "sat"]]
WORDS = ["cat", "dog", "mat", "play", "the", "is", EOS]


def _as_i32(u):
    return np.asarray(u, np.uint32).view(np.int32)


@pytest.fixture(scope="module", params=[1, 2, 3, 4])
def lms(request):
    order = request.param
    dev = dn.DeviceNGram.build(train_ngram(CORPUS, order=order), Lexicon.from_words(LEX),
                               device="cpu")
    jdev = jdn.DeviceNGram.build(jax_train_ngram(CORPUS, order=order),
                                 JaxLexicon.from_words(LEX))
    return order, Lexicon.from_words(LEX), dev, jdev


def _ctx_ids(dev, lexicon, words):
    """Left-padded (-1) context id array, most recent last."""
    ids = [dev.bos_id if w == BOS else lexicon.word_ids[w] for w in words]
    ids = ids[-(dev.order - 1):] if dev.order > 1 else []
    return np.asarray([-1] * ((max(dev.order - 1, 1)) - len(ids)) + ids, np.int32)


def test_mix_equals_numpy_bit_for_bit():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    c = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    c[:4] = [0xFFFFFFFF, 0, 0x80000001, 0x80000000]
    assert (h >> 31).any() and (c >> 31).any()
    for seed in (dn.SEED1, dn.SEED2):
        got = dn._mix(torch.from_numpy(_as_i32(h)), torch.from_numpy(_as_i32(c)), seed)
        np.testing.assert_array_equal(got.numpy(), _as_i32(jdn._mix_np(h, c, seed)))


def test_hash_extend_and_ctx_equal_jax():
    rng = np.random.default_rng(1)
    h1 = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
    wid = rng.integers(-3, 200_000, 512).astype(np.int32)
    j1, j2 = jdn.hash_extend_jnp(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(wid))
    p1, p2 = dn.hash_extend(torch.from_numpy(_as_i32(h1)), torch.from_numpy(_as_i32(h2)),
                            torch.from_numpy(wid))
    np.testing.assert_array_equal(p1.numpy(), _as_i32(j1))
    np.testing.assert_array_equal(p2.numpy(), _as_i32(j2))
    ctx = rng.integers(-1, 50, (3, 5, 2)).astype(np.int32)
    j1, j2 = jdn.hash_ctx_jnp(jnp.asarray(ctx))
    p1, p2 = dn.hash_ctx(torch.from_numpy(ctx))
    np.testing.assert_array_equal(p1.numpy(), _as_i32(j1))
    np.testing.assert_array_equal(p2.numpy(), _as_i32(j2))
    np.testing.assert_array_equal(
        np.asarray(dn.hash_ids_batch(ctx.reshape(-1, 2).astype(np.int64))),
        np.asarray(jdn.hash_ids_batch(ctx.reshape(-1, 2).astype(np.int64))))


def test_packed_table_and_dense_arrays_equal_jax(lms):
    order, _, dev, jdev = lms
    np.testing.assert_array_equal(dev.table[0].numpy(), np.asarray(jdev.table[0]))
    assert dev.table[1] == jdev.table[1]
    np.testing.assert_array_equal(dev.uni_logp.numpy(), np.asarray(jdev.uni_logp))
    np.testing.assert_array_equal(dev.uni_bow.numpy(), np.asarray(jdev.uni_bow))
    assert (dev.order, dev.n_words, dev.unk_logp, dev.n_entries) == (
        jdev.order, jdev.n_words, jdev.unk_logp, jdev.n_entries)


def test_bucket_table_build_equals_per_entry_build():
    """The batched hashing of BucketTable.build packs the array that the
    JAX package's per-entry loop packs, mixed key lengths included."""
    rng = np.random.default_rng(2)
    entries = {}
    for _ in range(3000):
        n = int(rng.integers(2, 6))
        entries[tuple(int(i) for i in rng.integers(0, 5000, n))] = (
            float(rng.normal()), float(rng.normal()))
    np.testing.assert_array_equal(dn.BucketTable.build(entries).packed,
                                  jdn.BucketTable.build(entries).packed)


def test_logp_probes_equal_jax_bit_for_bit(lms):
    order, lexicon, dev, jdev = lms
    ctx, wids = [], []
    for c in CONTEXTS:
        for w in WORDS:
            ctx.append(_ctx_ids(dev, lexicon, c))
            wids.append(dev.eos_id if w == EOS else lexicon.word_ids[w])
    ctx, wids = np.stack(ctx), np.asarray(wids, np.int32)
    import jax

    want = np.asarray(jax.vmap(jdev.logp)(jnp.asarray(ctx), jnp.asarray(wids)))
    got = dev.logp(torch.from_numpy(ctx), torch.from_numpy(wids)).numpy()
    np.testing.assert_array_equal(got, want)
    # per-context word sets, with and without the prepacked unigrams and n_exact
    sets = np.stack([[lexicon.word_ids[w] for w in ("cat", "mat", "dog", "the")]] * len(ctx))
    uni = np.asarray(jdev.uni_logp)[sets]
    for n_exact in (None, 1, 3):
        want = np.asarray(jax.vmap(lambda c, w, u: jdev.logp_words(c, w, u, n_exact=n_exact))(
            jnp.asarray(ctx), jnp.asarray(sets), jnp.asarray(uni)))
        got = dev.logp_words(torch.from_numpy(ctx), torch.from_numpy(sets),
                             torch.from_numpy(uni), n_exact=n_exact).numpy()
        np.testing.assert_array_equal(got, want)


def test_logp_matches_host_lm(lms):
    order, lexicon, dev, _ = lms
    lm = train_ngram(CORPUS, order=order)
    for c in CONTEXTS:
        for w in WORDS:
            wid = dev.eos_id if w == EOS else lexicon.word_ids[w]
            got = dev.logp(torch.from_numpy(_ctx_ids(dev, lexicon, c)), torch.tensor(wid))
            np.testing.assert_allclose(float(got), lm.logp(c, w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order", [2, 4])
def test_streaming_arpa_builder_matches_build(tmp_path, order):
    lexicon = Lexicon.from_words(LEX)
    lm = train_ngram(CORPUS, order=order)
    arpa = str(tmp_path / "lm.arpa")
    lm.to_arpa(arpa)
    built = dn.DeviceNGram.build(lm, lexicon, device="cpu")
    streamed = dn.DeviceNGram.from_arpa_streaming(arpa, lexicon, device="cpu")
    jstreamed = jdn.DeviceNGram.from_arpa_streaming(arpa, JaxLexicon.from_words(LEX))
    assert streamed.order == order
    np.testing.assert_array_equal(streamed.table[0].numpy(), np.asarray(jstreamed.table[0]))
    ctx = np.stack([_ctx_ids(built, lexicon, c) for c in CONTEXTS for _ in WORDS])
    wids = np.asarray([built.eos_id if w == EOS else lexicon.word_ids[w]
                       for _ in CONTEXTS for w in WORDS], np.int32)
    a = built.logp(torch.from_numpy(ctx), torch.from_numpy(wids)).numpy()
    b = streamed.logp(torch.from_numpy(ctx), torch.from_numpy(wids)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_builders_want_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dn.DeviceNGram.build(train_ngram(CORPUS, order=2), Lexicon.from_words(LEX))
