"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor b2txt_tpu, so it also runs where only the port is
installed: ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
Every test skips where there is no CUDA card.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.decode.lmbeam_device import live_beams
from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
from b2txt_tpu_torch.ops import gru as port_gru
from b2txt_tpu_torch.ops import preprocess as port_pre
from b2txt_tpu_torch.ops.augment import TransformArgs
from b2txt_tpu_torch.utils.config import TrainConfig


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _recurrent_inputs(B, H, weights, rng):
    """(W_hh, b_hh, h0) as float32 arrays. "contractive": random with
    spectral radius ~0.5, so a rounding difference between the two versions
    shrinks over the T steps instead of growing. "decoder_init": layer 0 of
    GRUDecoder at TrainConfig() defaults with its own (orthogonal) init."""
    if weights == "decoder_init":
        cfg = TrainConfig().model
        assert H == cfg.n_units
        model = GRUDecoder(cfg, 1, 41, device="cpu", generator=torch.Generator().manual_seed(0))
        h0 = np.broadcast_to(model.h0.detach().reshape(1, H).numpy(), (B, H))
        return [model.gru.weight_hh_l0.detach().numpy(), model.gru.bias_hh_l0.detach().numpy(), h0]
    return [rng.standard_normal((3 * H, H)) * (0.5 / np.sqrt(H)),
            rng.standard_normal((3 * H,)) * 0.1,
            rng.standard_normal((B, H))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,weights", [
    (1, 7, 16, "contractive"), (5, 33, 40, "contractive"), (40, 11, 72, "contractive"),
    (32, 125, 768, "contractive"), (16, 125, 768, "decoder_init"),
    # not multiples of the mma tiles (16 rows, k16), and H % 8 != 0 (element loads)
    (17, 9, 40, "contractive"), (1, 9, 40, "contractive"), (3, 6, 13, "contractive"),
    (17, 125, 768, "contractive"), (128, 125, 768, "decoder_init"),
    # the streaming hop: one patch window, one step per layer, carried state
    (1, 1, 768, "decoder_init"), (1, 4, 768, "decoder_init"),
    # the training drivers' largest batch
    (256, 125, 768, "decoder_init"),
])
def test_gru_kernel_matches_plain(B, T, H, weights, dtype, tol):
    _need_card()
    rng = np.random.default_rng(B * 1000 + H)
    arrays = [rng.standard_normal((B, T, 3 * H)), *_recurrent_inputs(B, H, weights, rng)]
    args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dtype)
            for a in arrays]
    before = port_gru.gru_layer_forward.launches
    out, hf = port_gru.gru_layer_forward(*args)
    torch.cuda.synchronize()
    assert port_gru.gru_layer_forward.launches == before + 1
    ref_out, ref_hf = port_gru.gru_layer_reference(*args)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (hf.float() - ref_hf.float()).abs().max().item() <= tol


def _rel_err(a, b):
    return ((a.double() - b.double()).abs().max() / max(1.0, b.double().abs().max().item())).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H,weights", [
    (1, 7, 16, "contractive"), (5, 33, 40, "contractive"), (40, 11, 72, "contractive"),
    (64, 125, 768, "contractive"), (64, 125, 768, "decoder_init"),
    (17, 9, 40, "contractive"), (1, 9, 40, "contractive"), (3, 6, 13, "contractive"),
    (17, 125, 768, "contractive"),
    # past one launch's rows (K2_MAX_ROWS): blocks of rows, the last ragged
    (256, 125, 768, "decoder_init"), (200, 9, 40, "contractive"),
])
def test_gru_backward_kernel_matches_plain(B, T, H, weights, dtype, tol):
    """K2 against gru_layer_backward_reference on the same forward outputs
    and cotangents: max |x - x_plain| / max(1, max |x_plain|) for dxp,
    dW_hh, db_hh and dh0 (the tolerances of chip_smoke.py's GRU_BWD_TOL).
    A batch past ``K2_MAX_ROWS`` takes one launch per block of rows."""
    _need_card()
    rng = np.random.default_rng(B * 1000 + H + 1)
    arrays = [rng.standard_normal((B, T, 3 * H)), *_recurrent_inputs(B, H, weights, rng)]
    args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dtype)
            for a in arrays]
    out, _ = port_gru.gru_layer_forward(*args)
    g_out = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32)).cuda()
    g_hf = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)).cuda()
    before = port_gru.gru_layer_backward.launches
    got = port_gru.gru_layer_backward(*args, out, g_out, g_hf)
    torch.cuda.synchronize()
    assert port_gru.gru_layer_backward.launches == before + -(-B // port_gru.K2_MAX_ROWS)
    want = port_gru.gru_layer_backward_reference(*args, out, g_out, g_hf)
    for name, a, b in zip(["dxp", "dw_hh", "db_hh", "dh0"], got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("label,kw,training,tol", [
    ("train", {}, True, 1e-5), ("eval", {}, False, 1e-5),
    ("walk", {"random_walk_std": 0.1}, True, 1e-4), ("gain", {"static_gain_std": 0.05}, True, 1e-4),
])
def test_fused_preprocess_kernel_matches_plain(label, kw, training, tol):
    """K3 with the normals passed in against its plain version on the same
    normals, gain and cut (drawn from two generators with one seed)."""
    _need_card()
    B, T, C = 8, 130, 96
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, T, C), generator=gen, device="cuda")
    nt = torch.full((B,), T, device="cuda")
    noise = torch.randn((B, 2 * T + 1, C), generator=gen, device="cuda")
    args = TransformArgs(**kw)
    g1, g2 = (torch.Generator(device="cuda").manual_seed(9) for _ in range(2))
    before = port_pre.fused_preprocess.launches
    got, nt_got = port_pre.fused_preprocess(x, nt, args, training, generator=g1, noise=noise)
    torch.cuda.synchronize()
    assert port_pre.fused_preprocess.launches == before + 1
    gain = cut = None
    if training and args.static_gain_std > 0:
        gain = torch.randn((B, C, C), generator=g2, device="cuda")
    if training and args.random_cut > 0:
        cut = torch.randint(0, args.random_cut, (), generator=g2, device="cuda")
    want, nt_want = port_pre.fused_preprocess_reference(x, nt, args, training, noise, cut, gain)
    assert torch.equal(nt_got, nt_want)
    assert (got - want).abs().max().item() <= tol


def _onchip_against_philox(B, T, C, kw, cut, seed=5, tol=None):
    """K3 with its own Philox noise (the cut read from a device integer)
    against the plain version fed ``philox_noise(seed, ...)`` and the same
    cut: max |difference|, with chip_smoke.py's tolerances (1e-5, 1e-4 with
    the walk: logf/sincosf against PyTorch's float32 functions, a few ulps on
    normals of size <= ~6)."""
    args = TransformArgs(**kw)
    gen = torch.Generator(device="cuda").manual_seed(B * 100 + C)
    x = torch.randn((B, T, C), generator=gen, device="cuda")
    got = port_pre.launch_preprocess(x, args, True, seed, None,
                                     torch.tensor(cut, device="cuda"))
    torch.cuda.synchronize()
    noise = port_pre.philox_noise(seed, B, T, C, args, device="cuda")
    want, _ = port_pre.fused_preprocess_reference(x, torch.full((B,), T, device="cuda"), args,
                                                  True, noise, cut)
    tol = tol if tol is not None else (1e-4 if args.random_walk_std > 0 else 1e-5)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("cut", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"random_walk_std": 0.1}], ids=["defaults", "walk"])
def test_fused_preprocess_on_chip_noise_matches_philox_plain(kw, cut):
    _need_card()
    _onchip_against_philox(4, 130, 512, kw, cut)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,C,kw", [
    (1, 57, 13, {}), (3, 130, 96, {}), (3, 130, 96, {"random_walk_std": 0.1}),
    (2, 70, 1024, {"random_walk_std": 0.1}), (1, 57, 13, {"random_walk_std": 0.1}),
    (2, 9, 300, {}), (1, 40, 8, {"smooth_kernel_std": 3.0}),
])
def test_fused_preprocess_ragged_shapes(B, T, C, kw):
    """T not a multiple of the kernel's chunk, C not a multiple of 4 or of
    its 128-channel slab, B = 1, K = 13 taps: on-chip noise against
    philox_noise, and the noise passed in against the plain version."""
    _need_card()
    _onchip_against_philox(B, T, C, kw, cut=2)
    args = TransformArgs(**kw)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, T, C), generator=gen, device="cuda")
    noise = torch.randn((B, 2 * T + 1, C), generator=gen, device="cuda")
    nt = torch.full((B,), T, device="cuda")
    g1, g2 = (torch.Generator(device="cuda").manual_seed(9) for _ in range(2))
    got, _ = port_pre.fused_preprocess(x, nt, args, True, generator=g1, noise=noise)
    cut = torch.randint(0, args.random_cut, (), generator=g2, device="cuda")
    want, _ = port_pre.fused_preprocess_reference(x, nt, args, True, noise, cut)
    tol = 1e-4 if args.random_walk_std > 0 else 1e-5
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
def test_fused_preprocess_walk_over_1024_channels_raises():
    _need_card()
    x = torch.zeros((1, 8, 1028), device="cuda")
    with pytest.raises(ValueError, match="1024 channels"):
        port_pre.fused_preprocess(x, torch.full((1,), 8, device="cuda"),
                                  TransformArgs(random_walk_std=0.1), True)


@pytest.mark.gpu
def test_fused_preprocess_card_equals_cpu_for_one_seed():
    """The same seed gives the same output on the card (Philox in K3) and
    on the CPU (philox_noise in the plain version); random_cut=1 draws cut
    0 on both devices."""
    _need_card()
    B, T, C = 3, 130, 96
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, T, C)).astype(np.float32))
    nt = torch.full((B,), T)
    args = TransformArgs(random_cut=1, random_walk_std=0.1)
    cpu, nt_cpu = port_pre.fused_preprocess(x, nt, args, True, seed=21)
    card, nt_card = port_pre.fused_preprocess(x.cuda(), nt.cuda(), args, True, seed=21)
    assert torch.equal(nt_card.cpu(), nt_cpu)
    assert (card.cpu() - cpu).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["preprocess.cu", "row_gather.cu", "moe_grouped.cu",
                                    "beam_step.cu"])
def test_kernel_builds_without_spills(source):
    """ptxas reports 0 spill bytes for every kernel of K3, K4, K5 and K6."""
    import re

    from b2txt_tpu_torch.ops import _build

    _need_card()
    report = {"preprocess.cu": _build.preprocess_library,
              "row_gather.cu": _build.row_gather_library,
              "moe_grouped.cu": _build.moe_grouped_library,
              "beam_step.cu": _build.beam_step_library}[source]().ptxas_report
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)]
    assert spills and not any(spills), report


@pytest.mark.gpu
def test_fused_preprocess_on_chip_noise_statistics():
    """Philox normals inside K3: white noise standard and independent
    across rows, the offset constant along time with the given std."""
    _need_card()
    B, T, C = 16, 256, 128
    zeros = torch.zeros((B, T, C), device="cuda")
    nt = torch.full((B,), T, device="cuda")
    w, _ = port_pre.fused_preprocess(
        zeros, nt, TransformArgs(constant_offset_std=0.0, random_cut=0, smooth_data=False),
        True, seed=1)
    assert abs(w.mean().item()) < 0.01 and abs(w.std().item() - 1.0) < 0.01
    assert abs(torch.corrcoef(torch.stack([w[0].flatten(), w[1].flatten()]))[0, 1].item()) < 0.05
    o, _ = port_pre.fused_preprocess(
        zeros, nt, TransformArgs(white_noise_std=0.0, constant_offset_std=0.5, random_cut=0,
                                 smooth_data=False), True, seed=2)
    assert o.std(dim=1).max().item() < 1e-6
    assert abs(o[:, 0, :].std().item() - 0.5) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_decoder_gradients_on_card_match_plain_path(dtype, tol):
    """Gradients through GRUDecoder on the card (K1 forward, K2 backward)
    equal the plain path's (both recurrences patched to their plain
    versions): ||g - g_plain|| / ||g_plain|| per parameter, the tolerances
    of chip_smoke.py's TRAIN_GRAD_TOL. Every parameter gets a gradient,
    the day layers and W_hh among them."""
    _need_card()
    cfg = TrainConfig().model
    cfg.n_input_features, cfg.n_units, cfg.n_layers = 64, 128, 3
    model = GRUDecoder(cfg, 2, 41, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((6, 90, 64), generator=gen, device="cuda")
    day = torch.tensor([0, 1, 0, 1, 1, 0], device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        logits = model(x, day, compute_dtype=dtype)
        (logits.float() ** 2).mean().backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    before = port_gru.gru_layer_backward.launches
    kernel = grads()
    assert port_gru.gru_layer_backward.launches == before + cfg.n_layers
    with mock.patch.object(port_gru, "gru_layer_forward", port_gru.gru_layer_reference), \
            mock.patch.object(port_gru, "gru_layer_backward",
                              port_gru.gru_layer_backward_reference):
        plain = grads()
    for n, g in plain.items():
        assert g.abs().max().item() > 0, n
        err = ((kernel[n].double() - g.double()).norm() / g.double().norm()).item()
        assert err <= tol, (n, err)


@pytest.mark.gpu
@pytest.mark.parametrize("rw", [4, 64, 128])
@pytest.mark.parametrize("g", [1, 37, 4096])
@pytest.mark.parametrize("in_flight", [1, 8, 32, 128])
def test_row_gather_kernel_matches_plain_bit_for_bit(rw, g, in_flight):
    from b2txt_tpu_torch.ops import gather as port_gather

    _need_card()
    rng = np.random.default_rng(rw * 7 + g)
    rows = 1 << 12
    table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (rows, rw), dtype=np.int64)
                             .astype(np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(0, rows, g).astype(np.int32)).cuda()
    idx[: g // 2] = idx[0]                       # repeated rows
    before = port_gather.row_gather.launches
    out = port_gather.row_gather(table, idx, in_flight=in_flight)
    torch.cuda.synchronize()
    assert port_gather.row_gather.launches == before + 1
    assert torch.equal(out, port_gather.row_gather_reference(table, idx.long()))


def _small_decode_world():
    """A 10-word lexicon, a trigram and three noisy planted utterances."""
    from b2txt_tpu_torch.lm import Lexicon, train_ngram

    lex = {"the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
           "mat": ["M", "AE", "T"], "on": ["AA", "N"], "their": ["DH", "EH", "R"],
           "there": ["DH", "EH", "R"], "is": ["IH", "Z"], "hat": ["HH", "AE", "T"],
           "a": ["AH"]}
    corpus = [s.split() for s in ("the cat sat on the mat", "there is the cat",
                                  "the cat is there", "there is a mat",
                                  "the cat sat on the hat", "a hat is on the mat")] * 3
    lexicon = Lexicon.from_words(lex)
    rng = np.random.default_rng(0)
    lps = []
    for s in ("there is the cat", "the cat sat on the mat", "a hat is on the mat"):
        rows = []
        for pid in lexicon.sentence_to_phonemes(s):
            for hot in (pid, pid, pid, 0):
                row = np.full(41, -4.0, np.float32)
                row[hot] = 0.0
                rows.append(row)
        lp = np.stack(rows) + 0.6 * rng.standard_normal((len(rows), 41)).astype(np.float32)
        lps.append(lp - np.log(np.exp(lp).sum(-1, keepdims=True)))
    T = max(lp.shape[0] for lp in lps)
    batch = np.full((len(lps), T, 41), -20.0, np.float32)
    for i, lp in enumerate(lps):
        batch[i, : lp.shape[0]] = lp
    return lexicon, train_ngram(corpus, order=3), train_ngram(corpus, order=2), batch, \
        np.asarray([lp.shape[0] for lp in lps], np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("sum_mode", [True, False])
def test_device_searcher_on_card_matches_cpu(sum_mode):
    """The same search on the card and on the CPU: n-best sentences equal,
    ac/lm scores within 1e-4 (batched path with the pool rescore, and the
    streaming path)."""
    from b2txt_tpu_torch.decode.lmbeam_device import NEG, DeviceLexiconBeamSearch
    from b2txt_tpu_torch.utils.config import DecodeConfig

    _need_card()
    lexicon, lm, lm2, batch, lens = _small_decode_world()
    cfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=2.0, nbest=10, beam_width=64,
                       first_beam_size=8, sum_mode=sum_mode)
    runs = {}
    for device in ("cuda", "cpu"):
        s = DeviceLexiconBeamSearch(lexicon, lm2, cfg, rescore_lm=lm, device=device)
        out = s.decode_batch(batch, lens)
        s.reset()
        s.decode(batch[0, : lens[0]])
        runs[device] = out + [s.finish_decoding()]
    for a, b in zip(runs["cuda"], runs["cpu"]):
        a = [r for r in a if r.ac_score > NEG / 2]
        b = [r for r in b if r.ac_score > NEG / 2]
        assert b and [r.sentence for r in a] == [r.sentence for r in b]
        np.testing.assert_allclose([[r.ac_score, r.lm_score] for r in a],
                                   [[r.ac_score, r.lm_score] for r in b], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_opt_scores_repeat_bit_for_bit(dtype):
    """Two ``score_packed_fn`` calls on the same packed rows give the same
    bits: the per-segment sums run in one fixed order (``ops/segment.py``),
    where ``index_add_``'s float atomics added in a varying one."""
    from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer, score_packed_fn

    _need_card()
    cfg = OPTConfig(vocab_size=1000, hidden_size=64, ffn_dim=128, num_layers=2, num_heads=4,
                    max_position_embeddings=128)
    resc = OPTRescorer(cfg, encode=lambda t, n: [], device="cuda", compute_dtype=dtype)
    rng = np.random.default_rng(0)
    ids = [rng.integers(4, cfg.vocab_size, int(rng.integers(3, 24))).tolist() for _ in range(100)]
    tokens, seg, pos, n_segments = resc._pack_arrays(ids)
    args = [torch.from_numpy(a).cuda() for a in (tokens, seg, pos)]
    fn = score_packed_fn(n_segments, dtype)
    with torch.inference_mode():
        runs = [fn(resc.model, *args) for _ in range(3)]
    for sums, cnt in runs[1:]:
        assert torch.equal(sums, runs[0][0]) and torch.equal(cnt, runs[0][1])
    assert torch.isfinite(runs[0][0]).all()
    counts = runs[0][1][1:].cpu().numpy()    # the bins' bucket: empty bins after the lists'
    np.testing.assert_array_equal(counts[:len(ids)], [len(s) for s in ids])
    assert not counts[len(ids):].any()


@pytest.mark.gpu
def test_segment_sums_repeat_and_match_float64():
    """The fixed-order segment sum on the card: the same bits on every call,
    within float32 rounding of a float64 sum, empty segments 0."""
    from b2txt_tpu_torch.ops.segment import segment_sum

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    seg = torch.randint(0, 700, (200_000,), device="cuda", generator=gen)
    values = torch.randn(200_000, device="cuda", generator=gen) * 10
    runs = [segment_sum(values, seg, 1000) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    ref = torch.zeros(1000, dtype=torch.float64, device="cuda").index_add_(0, seg, values.double())
    torch.testing.assert_close(runs[0].double(), ref, rtol=1e-5, atol=1e-3)
    assert torch.equal(runs[0][700:], torch.zeros(300, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("sum_mode", [False, True])
def test_device_search_graph_replay_equals_eager_loop(sum_mode):
    """The device search's frames replayed from one captured CUDA graph of
    K6 against the same frames issued op by op (``_expand``), at the session
    evaluation's search shape (B = 32 with padding rows, K = 48, first beam
    8): the final live beams bit for bit as a set, each with the words it
    emitted, and the n-best, for two batches through one graph; every frame
    replayed, one capture, one K6 launch a frame."""
    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.ops.beam_step import beam_step
    from b2txt_tpu_torch.utils.config import DecodeConfig
    from b2txt_tpu_torch.utils.profiling import counters, tracing

    _need_card()
    lexicon, lm, _, batch, lens = _small_decode_world()
    rows = np.arange(32) % 3
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, nbest=10, beam_width=48,
                       first_beam_size=8, sum_mode=sum_mode)
    s = DeviceLexiconBeamSearch(lexicon, lm, cfg, device="cuda")
    batches = []
    for shift in (0, 1):    # the second batch: other rows, shorter
        r = np.roll(rows, shift)
        lengths = np.where(np.arange(32) % 7 == 6, 0,
                           lens[r] - (np.arange(32) + shift) % 5 - 3 * shift).astype(np.int32)
        batches.append((torch.from_numpy(batch[r]).cuda(), lengths))
    before = beam_step.launches
    with tracing(), torch.inference_mode():
        replayed = [s._scan_batch(s._make_state(32), lp, n) for lp, n in batches]
    c = counters()
    frames = sum(int(n.max()) for _, n in batches)
    assert c["search.frames"] == c["search.graph_frames"] == frames
    assert c["search.graph_captures"] == 1
    assert beam_step.launches - before == frames + 2   # and the capture's two warm-ups
    for (lp, n), (st_g, recs_g) in zip(batches, replayed):
        with torch.inference_mode():
            n_dev = torch.from_numpy(n.astype(np.int64)).cuda()
            st_e, recs_e = s._scan_eager(s._make_state(32), lp, n, n_dev, int(n.max()))
        assert recs_g[0].dtype == torch.int16 and recs_g[0].shape == recs_e[0].shape
        assert live_beams(st_g, recs_g) == live_beams(st_e, recs_e)
        nbest = [s._extract_results(tuple(t.cpu().numpy() for t in s._finalize(st)),
                                    tuple(r.cpu().numpy() for r in recs), None)
                 for st, recs in ((st_g, recs_g), (st_e, recs_e))]
        assert nbest[0] == nbest[1] and any(nbest[0])


@functools.lru_cache(maxsize=None)
def _search_world(order: int, homophones: int = 5):
    """The session evaluation's search shape at a small vocabulary: 400
    words of 2-7 random phones, some prefixes of others, and 12 homophone
    classes of ``homophones`` (5: the trie keeps 4, H = 4, one dropped); an n-gram of
    ``order`` over 3,000 random sentences; 32 planted sentences as log-probs
    of unequal lengths (up to ~160 frames), half with the planted features'
    noise (0.6), half noisier (1.5), a quarter rounded to half nats (ties at
    the first beam's threshold), two rows cut short and one empty."""
    from b2txt_tpu_torch.lm import Lexicon, train_ngram
    from b2txt_tpu_torch.utils.phonemes import LOGIT_TO_PHONEME

    rng = np.random.default_rng(order)
    phones = LOGIT_TO_PHONEME[1:40]
    words = {}
    while len(words) < 340:
        pron = [phones[i] for i in rng.integers(0, 39, int(rng.integers(2, 8)))]
        words["w" + "".join(p.lower() for p in pron)] = pron
    for w in list(words)[:40]:           # prefixes of longer words
        if len(words[w]) > 3:
            words[w + "x"] = words[w][:-1]
    for g in range(12):                  # homophone classes
        pron = [phones[i] for i in rng.integers(0, 39, 4)]
        for j in range(homophones):
            words[f"h{g}v{j}"] = pron
    lexicon = Lexicon.from_words(words)
    wl = list(words)
    corpus = [[wl[i] for i in rng.integers(0, len(wl), int(rng.integers(3, 9)))]
              for _ in range(3000)]
    lm = train_ngram(corpus, order=order)
    rows = []
    for b in range(32):
        sent = " ".join(corpus[int(rng.integers(0, 3000))][:6])
        frames = []
        for pid in lexicon.sentence_to_phonemes(sent):
            for _ in range(int(rng.integers(1, 4))):
                frames.append(pid)
            frames += [0] * int(rng.integers(0, 3))
        lp = np.full((len(frames), 41), -4.0, np.float32)
        lp[np.arange(len(frames)), frames] = 0.0
        lp += (0.6 if b % 2 else 1.5) * rng.standard_normal(lp.shape).astype(np.float32)
        if b % 4 == 3:    # coarse values, as bf16 logits give: ties at the first beam's cut
            lp = np.round(lp * 2) / 2
        rows.append(lp - np.log(np.exp(lp).sum(-1, keepdims=True)))
    T = max(r.shape[0] for r in rows)
    batch = np.full((32, T, 41), -20.0, np.float32)
    lens = np.zeros(32, np.int32)
    for b, r in enumerate(rows):
        batch[b, :r.shape[0]] = r
        lens[b] = r.shape[0]
    lens[5], lens[11], lens[20] = lens[5] // 2, lens[11] // 3, 0
    return lexicon, lm, batch, lens


def _kernel_against_expand(s, lp, lens):
    """K6 against ``_expand`` with ``_scan_eager``'s masking, frame by frame
    from ``_expand``'s states: per row the live beams as a set with payload,
    scores, parent and word bit for bit; rows past their length unchanged
    with parents k and words -1; ``t`` advanced and the ticket back at 0
    after every launch. Returns the live beams seen."""
    from b2txt_tpu_torch.decode.lmbeam_device import NEG, LmBeamState, _select
    from b2txt_tpu_torch.ops.beam_step import beam_step, workspace

    B, T, V = lp.shape
    K = s.config.beam_width
    work = workspace(B, K, V, s.H, s.dev_lm.order, lp.device)
    lens_d = torch.from_numpy(lens.astype(np.int64)).cuda()
    t = torch.zeros((1,), dtype=torch.int64, device="cuda")
    ticket = torch.zeros((1,), dtype=torch.int32, device="cuda")
    parents = torch.full((T, B, K), -7, dtype=torch.int16, device="cuda")
    words = torch.full((T, B, K), -7, dtype=torch.int32, device="cuda")
    args = s._step_args()
    state = s._make_state(B)
    n_live, before = 0, beam_step.launches

    def rows(st, par, wd):
        """Per row its live beams' (h1, h2, node, last, ctx, scores and lm
        as bits, parent, word), in a canonical order; and the state's
        columns as int32."""
        st = [x.cpu() for x in st]
        bits = [x.view(torch.int32) if x.dtype == torch.float32 else x for x in st]
        m = torch.cat([x.reshape(B, K, -1) for x in bits]
                      + [par.to(torch.int32)[..., None], wd.to(torch.int32)[..., None]],
                      -1).numpy()
        live = (torch.maximum(st[5], st[6]) > NEG / 2).numpy()
        out = []
        for b in range(B):
            r = m[b][live[b]]
            out.append(r[np.lexsort(r.T[::-1])])
        return out, bits

    with torch.inference_mode():
        for f in range(int(lens.max())):
            new, par, _, wd = s._expand(state, lp[:, f], **args)
            active = (lens_d > f)
            want = _select(active, new, state)
            got = LmBeamState(*(x.clone() for x in state))
            s._kernel_step(got, lp, lens_d, t, ticket, parents, words, work)
            assert t.item() == f + 1 and ticket.item() == 0
            w_rows, _ = rows(want, par.cpu(), wd.cpu())
            g_rows, g_bits = rows(got, parents[f].cpu(), words[f].cpu())
            _, old_bits = rows(state, par.cpu(), wd.cpu())
            for b in range(B):
                if f < lens[b]:
                    assert np.array_equal(g_rows[b], w_rows[b]), (f, b)
                    n_live += len(g_rows[b])
                else:
                    for a, o in zip(g_bits, old_bits):
                        assert torch.equal(a[b], o[b]), (f, b)
                    assert parents[f, b].tolist() == list(range(K))
                    assert words[f, b].tolist() == [-1] * K
            state = want
    assert beam_step.launches - before == int(lens.max())
    return n_live


@pytest.mark.gpu
@pytest.mark.parametrize("sum_mode,first_beam,state_key,close_top,order", [
    (False, 8, "history", None, 3),       # the session evaluation's options
    (True, 8, "history", None, 3),
    (True, None, "history", None, 3),
    (True, 8, "history", 2, 3),
    (False, None, "history", 2, 3),
    (False, 8, "ngram", None, 3),
    (False, None, "ngram", None, 3),
    (False, 8, "ngram", 2, 3),
    (False, 8, "history", None, 2),       # the repo's other n-gram orders
    (False, 8, "history", None, 4),
    (True, 8, "history", None, 5),
])
def test_beam_step_kernel_matches_expand(sum_mode, first_beam, state_key, close_top, order):
    """K6 against ``_expand`` op by op on the card at the session
    evaluation's search shape (B = 32, K = 48, H = 4, first beam 8 or
    every phone), over planted and noisy frames and rows of unequal length."""
    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.utils.config import DecodeConfig

    _need_card()
    lexicon, lm, batch, lens = _search_world(order)
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, beam_width=48, nbest=10,
                       first_beam_size=first_beam or 0, sum_mode=sum_mode, length_penalty=-0.3)
    s = DeviceLexiconBeamSearch(lexicon, lm, cfg, close_probe_top=close_top,
                                state_key=state_key, device="cuda")
    assert s.H == 4 and s.trie.n_dropped > 0 and s.dev_lm.order == order
    n_live = _kernel_against_expand(s, torch.from_numpy(batch).cuda(), lens)
    assert n_live > 32 * 100


@pytest.mark.gpu
@pytest.mark.parametrize("sum_mode,first_beam", [(False, 8), (False, None), (True, None)])
def test_beam_step_kernel_matches_expand_at_the_widest_beams(sum_mode, first_beam):
    """K6 against ``_expand`` at the widest search the repo runs (the
    DecodeConfig default and the scripts': K = 128, H = 6, 5-gram): with the
    first beam of 8 the candidates stay in shared memory; with every phone
    (~6,000 candidates a row) they and their sorts take the workspace."""
    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.ops.beam_step import layout
    from b2txt_tpu_torch.utils.config import DecodeConfig

    _need_card()
    lexicon, lm, batch, lens = _search_world(5, homophones=7)
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, beam_width=128, nbest=10,
                       first_beam_size=first_beam or 0, sum_mode=sum_mode, length_penalty=-0.3)
    s = DeviceLexiconBeamSearch(lexicon, lm, cfg, max_homophones=6, device="cuda")
    assert s.H == 6 and s.trie.n_dropped > 0 and s.dev_lm.order == 5
    assert layout(128, 41, 6, 4, 5)[2] > 0
    n_live = _kernel_against_expand(s, torch.from_numpy(batch).cuda(), lens)
    assert n_live > 32 * 200


@pytest.mark.gpu
def test_beam_step_streaming_decode_matches_expand():
    """The streaming ``decode`` on the card (K6 a frame, the blank skip's
    reinserted frames unrecorded) against the same chunks through
    ``_expand`` (the kernel's dispatch switched off): the same n-best."""
    from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
    from b2txt_tpu_torch.ops.beam_step import beam_step
    from b2txt_tpu_torch.utils.config import DecodeConfig

    _need_card()
    lexicon, lm, batch, lens = _search_world(3)
    cfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, beam_width=48, nbest=10,
                       first_beam_size=8, ctc_blank_skip_threshold=0.9, sum_mode=False)
    s = DeviceLexiconBeamSearch(lexicon, lm, cfg, rescore_lm=lm, device="cuda")
    out = {}
    for kernel in (True, False):
        before = beam_step.launches
        with mock.patch.object(s, "_replays", return_value=kernel):
            res = []
            for b in (0, 1, 7):
                s.reset()
                for c0 in range(0, int(lens[b]), 32):
                    s.decode(batch[b, c0:min(c0 + 32, int(lens[b]))])
                res.append(s.finish_decoding())
        out[kernel] = res
        assert (beam_step.launches > before) == kernel
    assert out[True] == out[False] and all(out[True])


@pytest.mark.gpu
def test_beam_step_smem_matches_the_source():
    """The wrapper's count of shared memory and workspace is the kernel's,
    at the cell's shape, beside it and at the widest beams."""
    from b2txt_tpu_torch.ops import _build
    from b2txt_tpu_torch.ops.beam_step import layout

    _need_card()
    lib = _build.beam_step_library().lib
    for shape in [(48, 41, 4, 2, 3), (48, 41, 1, 2, 3), (64, 41, 4, 4, 5), (16, 41, 1, 1, 1),
                  (48, 41, 4, 1, 2), (128, 41, 6, 4, 5), (128, 41, 4, 2, 3)]:
        got = (lib.b2t_beam_step_smem(*shape), lib.b2t_beam_step_fixed(*shape),
               lib.b2t_beam_step_work(*shape))
        assert got == layout(*shape), shape


def _routing(T, E, k, kind, gen):
    """(weights (T, k), experts (T, k), counts (E + 1,)) of a routing kind:
    the router's softmax top-k on random logits ("uniform"); three experts
    favoured by most tokens ("skewed"); expert E // 2 every token's first
    choice ("one_expert"); a third of the tokens padding ("padding")."""
    logits = torch.randn(T, E, device="cuda", generator=gen)
    if kind == "skewed":
        logits[:, :3] += 2.5
    if kind == "one_expert":
        logits[:, E // 2] += 100.0
    w, idx = torch.topk(logits.softmax(-1), k, dim=-1)
    if kind == "padding":
        idx[T - T // 3:] = E
    counts = torch.zeros(E + 1, dtype=torch.int64, device="cuda")
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    return w, idx, counts


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_expert", "padding"])
@pytest.mark.parametrize("T,E,k,D,Fm", [
    (64, 64, 6, 2048, 1408),   # the rescorer's packed forward: DeepSeek-V2-Lite's widths
    (128, 64, 6, 2048, 1408),
    (37, 8, 3, 64, 32),        # ragged: rows and widths that are no multiple of the tiles
    (5, 4, 2, 80, 40),
])
def test_moe_grouped_kernel_matches_plain(T, E, k, D, Fm, kind):
    """K5 against ``moe_experts_plain`` (every expert over every token,
    weighted densely): bf16 products with float32 sums on both sides, so
    they differ by bf16 roundings of the hidden product, well inside 2% of
    the output's largest entry; no host sync inside the call; two calls
    give the same bits."""
    _need_card()
    from b2txt_tpu_torch.ops import moe

    gen = torch.Generator(device="cuda").manual_seed(T * 1000 + E)
    x = torch.randn(T, D, device="cuda", generator=gen).bfloat16()
    gate_up = (torch.randn(E, 2 * Fm, D, device="cuda", generator=gen) * D ** -0.5).bfloat16()
    down = (torch.randn(E, D, Fm, device="cuda", generator=gen) * Fm ** -0.5).bfloat16()
    w, idx, counts = _routing(T, E, k, kind, gen)
    before = moe.moe_experts.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_experts(x, idx, w, gate_up, down, counts)
        again = moe.moe_experts(x, idx, w, gate_up, down, counts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = moe.moe_experts_plain(x, idx, w, gate_up, down)
    assert moe.moe_experts.launches - before == 4
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err
    if kind == "padding":
        assert (got[T - T // 3:] == 0).all()


@pytest.mark.gpu
def test_deepseek_forward_on_card_matches_the_cpu():
    """The tiny DeepSeek-V2 in float32 on the card (K5 for its experts)
    against the CPU's plain path, and no host sync in its packed forward."""
    _need_card()
    from b2txt_tpu_torch.decode import deepseek_lm as D

    cfg = D.DeepseekV2Config.tiny()
    sd = D.init_params(cfg, "cpu", torch.float32, torch.Generator().manual_seed(0), std=0.1)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (3, 70), generator=g)
    seg = torch.repeat_interleave(torch.arange(1, 8), 10)[None].repeat(3, 1)
    seg[2, 40:] = 0
    pos = (torch.arange(70) % 10)[None].repeat(3, 1)
    mask = (seg > 0).float()
    cpu = D.DeepseekV2Model.from_state_dict(cfg, sd, "cpu")(tok, mask, positions=pos,
                                                            segment_ids=seg)
    model = D.DeepseekV2Model.from_state_dict(cfg, sd, "cuda")
    args = [t.cuda() for t in (tok, mask, pos, seg)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = model(args[0], args[1], positions=args[2], segment_ids=args[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    real = mask.bool()
    np.testing.assert_allclose(got.cpu()[real].numpy(), cpu[real].numpy(), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_deepseek_rescorer_graph_replay_equals_the_eager_forward():
    """The rescorer's captured forward against the same forward run op by op
    at the same padded shape (bf16, K5 on the tensor cores): two dispatches
    of one shape before either fetch keep their own scores, one capture
    serves both, no host sync after it, and K5 counts 2 launches a MoE layer
    a replay."""
    _need_card()
    from b2txt_tpu_torch.decode import deepseek_lm as D
    from b2txt_tpu_torch.decode.packed_scorer import word_hash_encode
    from b2txt_tpu_torch.ops.moe import moe_experts
    from b2txt_tpu_torch.utils import profiling
    from b2txt_tpu_torch.utils.device import upload

    cfg = D.DeepseekV2Config.tiny()
    sd = D.init_params(cfg, "cuda", torch.bfloat16,
                       torch.Generator(device="cuda").manual_seed(3), std=0.1)
    enc = word_hash_encode(cfg.vocab_size)
    resc = D.DeepseekV2Rescorer(cfg, enc, params=sd, device="cuda",
                                compute_dtype=torch.bfloat16)
    a = ["the cat sat on the mat", "a dog", "we will see it tomorrow", "hello there"]
    b = ["an apple a day", "the quick brown fox", "jumps over the lazy dog", "hi"]

    def eager(texts):
        tokens, seg, pos, n = resc._pack_arrays([enc(t, 256) for t in texts])
        with torch.inference_mode():
            sums, cnt, _ = resc._forward(n, *(upload(x, resc.device) for x in (tokens, seg, pos)))
        return (sums[1: 1 + len(texts)]).cpu().numpy()

    want_a, want_b = eager(a), eager(b)
    with profiling.tracing():
        first = resc.score(a)                        # captures this shape
        torch.cuda.synchronize()
        before = moe_experts.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            fetch_a, fetch_b = resc.score_async(a), resc.score_async(b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got_a, got_b = fetch_a(), fetch_b()
        captures = profiling.counters()["dsv2.graph_captures"]
    assert captures == 1 and len(resc._graphs) == 1
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    assert moe_experts.launches - before == 2 * 2 * n_moe
    for got, want in ((first, want_a), (got_a, want_a), (got_b, want_b)):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# the profiler's host events of a CUDA launch call (benchmark/metrics/online.llm_launches.py)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def _opt_on_a_mesh_of_one(texts):
    """``OPTRescorer(mesh=(1, 1))`` in one NCCL rank: whether it keeps no
    graph cache, the captures it counted, and its scores."""
    from b2txt_tpu_torch.decode import opt_lm as O
    from b2txt_tpu_torch.parallel import make_mesh
    from b2txt_tpu_torch.utils import profiling

    cfg = O.OPTConfig.tiny()
    with profiling.tracing():
        resc = O.OPTRescorer(cfg, encode=O.word_hash_encode(cfg.vocab_size), mesh=make_mesh(1),
                             compute_dtype=torch.bfloat16)
        scores = resc.score(texts)
        captures = profiling.counters().get("opt.graph_captures", 0)
    return resc._graphs is None, captures, scores


@pytest.mark.gpu
def test_opt_rescorer_graph_replay_equals_the_eager_forward():
    """OPT's captured packed forward (2 layers at OPT-6.7b's widths, bf16)
    against the same forward run op by op at the same padded shape, bit for
    bit, over n-best lists of 1, 9 and 33 texts: one capture a padded shape
    and none for a shape seen before; a dispatch issues at most 5 launch
    calls and no host sync, and two dispatches before either fetch keep
    their own scores; the prefix-KV context path and a mesh of one rank
    leave the graphs alone."""
    _need_card()
    from b2txt_tpu_torch.decode import opt_lm as O
    from b2txt_tpu_torch.parallel import spawn
    from b2txt_tpu_torch.utils import profiling
    from b2txt_tpu_torch.utils.device import upload

    cfg = O.OPTConfig(num_layers=2)
    sd = O.init_params(cfg, "cuda", torch.bfloat16, torch.Generator(device="cuda").manual_seed(4))
    enc = O.word_hash_encode(cfg.vocab_size)
    resc = O.OPTRescorer(cfg, params=sd, encode=enc, encode_cont=lambda t, n: enc(t, n + 1)[1:],
                         device="cuda", compute_dtype=torch.bfloat16)
    words = "the cat sat on a mat we will see it tomorrow hello there an apple".split()
    rng = np.random.default_rng(0)
    lists = [[" ".join(rng.choice(words, int(rng.integers(1, 14)))) for _ in range(n)]
             for n in (1, 9, 33)]

    def eager(texts):
        tokens, seg, pos, n = resc._pack_arrays([enc(t, resc.max_len) for t in texts])
        with torch.inference_mode():
            sums, _, _ = resc._forward(n, *(upload(x, resc.device) for x in (tokens, seg, pos)))
        return sums[1: 1 + len(texts)].cpu().numpy(), (tokens.shape, n)

    want = [eager(texts) for texts in lists]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    launches = []
    with profiling.tracing():
        first = [resc.score(texts) for texts in lists]           # captures each shape
        captured = profiling.counters()["opt.graph_captures"]
        for texts in lists:
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                fetch = resc.score_async(texts)
            launches.append(sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS))
            fetch()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fetches = [resc.score_async(texts) for texts in lists[::-1]]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again = [f() for f in fetches][::-1]
        before = len(resc._graphs)
        resc.score(lists[1], context="the shared conversation so far")
        captures = profiling.counters()["opt.graph_captures"]
    assert captured == captures == len({key for _, key in want}) == len(resc._graphs) == before
    assert resc.prefix_runs == 1
    assert all(1 <= n <= 5 for n in launches), launches
    for got, (w, _) in zip(first + again, want + want):
        np.testing.assert_array_equal(np.float32(got), w)

    no_graphs, mesh_captures, mesh_scores = spawn(_opt_on_a_mesh_of_one, 1, (lists[1],),
                                                  backend="nccl")[0]
    assert no_graphs and mesh_captures == 0 and np.isfinite(mesh_scores).all()


@pytest.mark.gpu
def test_graph_capture_warms_up_then_moves_the_launches_to_each_replay():
    """``utils/cuda_graphs``' capture on the card: the warm-up calls run,
    each after ``reset``; the captured call runs nothing, and its kernel
    launches count at each replay instead; one capture is counted by name,
    and ``out`` is the graph's own tensor, written anew by each replay."""
    from types import SimpleNamespace

    from b2txt_tpu_torch.utils import profiling
    from b2txt_tpu_torch.utils.cuda_graphs import GraphCache

    _need_card()
    kernel = SimpleNamespace(launches=0)
    x = torch.zeros(4, device="cuda")
    resets = []

    def step():
        kernel.launches += 1
        return x.add_(1) * 2

    cache = GraphCache(2, kernel, "test.graph_captures")
    with profiling.tracing():
        g = cache.get("k", lambda: cache.capture(step, x.device, warmups=3,
                                                 reset=lambda: resets.append(len(resets))))
        torch.cuda.synchronize()
        assert x.tolist() == [3.0] * 4 and resets == [0, 1, 2]
        assert kernel.launches == 3 and g.launches == 1
        g.replay(2)
        torch.cuda.synchronize()
        captures = profiling.counters()["test.graph_captures"]
    assert x.tolist() == [5.0] * 4 and g.out.tolist() == [10.0] * 4
    assert kernel.launches == 5 and captures == 1 and len(cache) == 1
