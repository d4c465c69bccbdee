"""The sharded paths over NCCL on 4 cards of one host, against the port's
unsharded paths on card 0: the CPU tests' case sets (tests/
test_torch_parallel.py, test_torch_sharded_decode.py,
test_torch_parallel_lm.py) with real peers, K1 and K2 in float32 on every
rank. Imports neither JAX nor b2txt_tpu:
``python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py``
on a host with 4 cards. Skips with fewer (NCCL refuses two ranks on one
card)."""

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.data.synthetic import synthetic_trials
from b2txt_tpu_torch.decode import opt_lm
from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.models.gru_decoder import GRUDecoder
from b2txt_tpu_torch.parallel import (build_sharded_forward, build_sharded_train_step,
                                      gather_params, make_mesh, spawn)
from b2txt_tpu_torch.train import Trainer
from b2txt_tpu_torch.train.optimizer import make_optimizer
from b2txt_tpu_torch.utils.config import DecodeConfig
from test_torch_parallel import N_LAYERS, _batch, _quiet_cfg, _tiny_cfg
from test_torch_parallel_lm import CTX, F32, TEXTS, enc
from test_torch_sharded_decode import CORPUS, KNOBS, LEX, _nbest, _utterances

WORLD = 4
SPAWN_DEADLINE_S = 300


def _rank_cases(sd_np, batch_np, opt_sd_np, arr, lens):
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = {k: torch.from_numpy(v) for k, v in sd_np.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    out = {}
    mesh = make_mesh(WORLD, model_parallel=2)
    step, place_params, place_batch = build_sharded_train_step(_quiet_cfg(), sd, make_optimizer,
                                                               mesh)
    state = place_params(sd)
    figs = [step(state, place_batch(batch)) for _ in range(2)]
    full = gather_params(state.params, mesh)
    out["step"] = {"loss": [float(f[0]) for f in figs], "grad_norm": [float(f[1]) for f in figs],
                   "w_hh": [full[f"gru.weight_hh_l{k}"].cpu().numpy() for k in range(N_LAYERS)]}
    fwd, place = build_sharded_forward(_tiny_cfg(), sd, mesh, compute_dtype=torch.float32)
    logits, ids = fwd(place(sd), batch["input_features"], batch["day_indicies"])
    out["forward"] = (logits.cpu().numpy(), ids.cpu().numpy())
    opt_sd = {k: torch.from_numpy(v) for k, v in opt_sd_np.items()}
    resc = opt_lm.OPTRescorer(opt_lm.OPTConfig.tiny(), params=opt_sd, encode=enc,
                              encode_cont=enc, max_len=64, mesh=mesh)
    out["opt"] = {"packed": resc.score(TEXTS), "context": resc.score(TEXTS, context=CTX)}
    dev = DeviceLexiconBeamSearch(Lexicon.from_words(LEX), train_ngram(CORPUS, order=3),
                                  DecodeConfig(**KNOBS))
    out["decode"] = _nbest(dev.sharded_decode_batch(arr, lens, mesh=make_mesh(WORLD),
                                                    axis="data"))
    return out


@pytest.mark.gpu
def test_sharded_paths_over_nccl_on_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards: NCCL refuses two ranks on one card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _quiet_cfg()
    model = GRUDecoder(cfg.model, 3, 41, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    batch = _batch(np.random.default_rng(0))
    opt_sd = {k: v.numpy() for k, v in opt_lm.init_params(
        opt_lm.OPTConfig.tiny(), "cpu", generator=torch.Generator().manual_seed(0)).items()}
    arr, lens = _utterances()
    ranks = spawn(_rank_cases, WORLD, args=(sd, batch, opt_sd, arr, lens), backend="nccl",
                  timeout_s=SPAWN_DEADLINE_S)

    # the unsharded paths on card 0
    cfg.dataset.sessions = ["a", "b", "c"]
    cfg.dataset.days_per_batch, cfg.use_amp, cfg.num_training_batches = 2, False, 2
    cfg.output_dir, cfg.checkpoint_dir = str(tmp_path), str(tmp_path / "ckpt")
    trainer = Trainer(cfg, device="cuda:0",
                      train_trials=synthetic_trials(cfg.dataset.sessions, 4, 16))
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    single = [trainer.train_step(tb) for _ in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r["step"]["loss"], [float(s[0]) for s in single], rtol=1e-5)
        np.testing.assert_allclose(r["step"]["grad_norm"], [float(s[1]) for s in single],
                                   rtol=1e-5)
        for k, w in enumerate(r["step"]["w_hh"]):
            np.testing.assert_allclose(
                w, trainer.model.state_dict()[f"gru.weight_hh_l{k}"].cpu().numpy(),
                rtol=1e-4, atol=1e-6)

    model = GRUDecoder(_tiny_cfg().model, 3, 41, device="cuda:0")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        ref = model(tb["input_features"], tb["day_indicies"]).cpu().numpy()
    for r in ranks:
        np.testing.assert_allclose(r["forward"][0], ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(r["forward"][1], ref.argmax(-1))

    resc = opt_lm.OPTRescorer(opt_lm.OPTConfig.tiny(),
                              params={k: torch.from_numpy(v) for k, v in opt_sd.items()},
                              encode=enc, encode_cont=enc, max_len=64, device="cuda:0")
    for r in ranks:
        np.testing.assert_allclose(r["opt"]["packed"], resc.score(TEXTS), **F32)
        np.testing.assert_allclose(r["opt"]["context"], resc.score(TEXTS, context=CTX), **F32)

    dev = DeviceLexiconBeamSearch(Lexicon.from_words(LEX), train_ngram(CORPUS, order=3),
                                  DecodeConfig(**KNOBS), device="cuda:0")
    want = _nbest(dev.decode_batch(arr, lens))
    assert all(want)
    for r in ranks:
        assert r["decode"] == want
