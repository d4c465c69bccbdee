"""The port's sharded paths on the CPU over gloo, against the JAX package on
conftest's 8 virtual devices: the counterpart of tests/test_parallel.py at
its tiny config (16 features, 2 × 32 units, 3 days, B = 8, T = 64).

One group of 4 ranks (``parallel.launch.spawn``) runs every case set once
(the module fixture); the tests read its results. JAX is imported inside the
tests and fixtures only, so the ranks, which import this module, never load
it."""

import numpy as np
import pytest
import torch

from b2txt_tpu_torch.data.synthetic import synthetic_trials
from b2txt_tpu_torch.parallel import (build_sharded_forward, build_sharded_train_step,
                                      gather_params, make_mesh, param_partition_specs, spawn)
from b2txt_tpu_torch.train import Trainer
from b2txt_tpu_torch.train.checkpoint import load_checkpoint
from b2txt_tpu_torch.train.optimizer import make_optimizer
from b2txt_tpu_torch.utils.config import TrainConfig

WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]
N_LAYERS = 2
SESSIONS = ["t15.2023.08.11", "t15.2023.08.13"]
TRAINER_STEPS = 10
SPAWN_DEADLINE_S = 120


def _tiny_cfg(cls=TrainConfig):
    """tests/test_parallel.py:20-31, for either package."""
    cfg = cls()
    cfg.model.n_input_features = 16
    cfg.model.n_units = 32          # 3H=96 divisible by model axis 2/4
    cfg.model.n_layers = N_LAYERS
    cfg.model.rnn_dropout = 0.0
    cfg.model.input_network.input_layer_dropout = 0.0
    cfg.dataset.data_transforms.random_cut = 0
    cfg.dataset.data_transforms.white_noise_std = 0.1
    cfg.epsilon = 1e-8
    return cfg


def _quiet_cfg(cls=TrainConfig):
    """Noise off, and the lr warm-up off so that both steps move the weights."""
    cfg = _tiny_cfg(cls)
    cfg.dataset.data_transforms.white_noise_std = 0.0
    cfg.dataset.data_transforms.constant_offset_std = 0.0
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 0
    return cfg


def _batch(rng, B=8, T=64, D=16, S=12):
    return {
        "input_features": rng.standard_normal((B, T, D)).astype(np.float32),
        "seq_class_ids": rng.integers(1, 41, (B, S)).astype(np.int32),
        "n_time_steps": np.full((B,), T, np.int32),
        "phone_seq_lens": rng.integers(4, S + 1, (B,)).astype(np.int32),
        "day_indicies": (rng.integers(0, 3, (B,))).astype(np.int32),
    }


def _trainer_cfg(out_dir: str):
    """tests/test_parallel.py:116-147's Trainer config, trials in memory."""
    cfg = _tiny_cfg()
    cfg.dataset.neural_dim = 16
    cfg.dataset.sessions = SESSIONS
    cfg.dataset.dataset_probability_val = [1, 1]
    cfg.dataset.batch_size = 8
    cfg.dataset.days_per_batch = 2
    cfg.num_training_batches = TRAINER_STEPS
    cfg.lr_decay_steps = cfg.lr_decay_steps_day = TRAINER_STEPS
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 2
    cfg.batches_per_train_log = 5
    cfg.batches_per_val_step = 100  # validation at the last step only
    cfg.use_amp = False
    cfg.output_dir = out_dir
    cfg.checkpoint_dir = out_dir + "/ckpt"
    return cfg


def _to_torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _rank_cases(sd_np, batch_np, trials, out_dir):
    """Every case set on one rank of 4; returns this rank's figures."""
    import torch.distributed as dist

    sd, batch = _to_torch(sd_np), _to_torch(batch_np)
    out = {"rank": dist.get_rank(), "runs": {}}

    # 2 steps at each mesh shape, noise on
    for shape in MESHES:
        mesh = make_mesh(WORLD, model_parallel=shape[1])
        cfg = _tiny_cfg()
        step, place_params, place_batch = build_sharded_train_step(cfg, sd, make_optimizer, mesh,
                                                                   device="cpu")
        state = place_params(sd)
        out["runs"][shape] = [float(step(state, place_batch(batch))[0]) for _ in range(2)]
        if shape == (1, 4):
            opt = state.optimizer.state[state.params["gru.weight_hh_l0"]]
            out["shards"] = {"w_hh": tuple(state.params["gru.weight_hh_l0"].shape),
                             "exp_avg": tuple(opt["exp_avg"].shape),
                             "exp_avg_sq": tuple(opt["exp_avg_sq"].shape),
                             "out_w": tuple(state.params["out.weight"].shape)}

    # noise off at (2, 2): 2 steps against the unsharded ones (in the parent)
    mesh = make_mesh(WORLD, model_parallel=2)
    step, place_params, place_batch = build_sharded_train_step(_quiet_cfg(), sd, make_optimizer,
                                                               mesh, device="cpu")
    state = place_params(sd)
    figs = [step(state, place_batch(batch)) for _ in range(2)]
    full = gather_params(state.params, mesh)
    out["equal"] = {"loss": [float(f[0]) for f in figs],
                    "grad_norm": [float(f[1]) for f in figs],
                    "w_hh": [full[f"gru.weight_hh_l{k}"].numpy() for k in range(N_LAYERS)]}

    # the sharded forward at (2, 2), f32
    fwd, place = build_sharded_forward(_tiny_cfg(), sd, mesh, compute_dtype=torch.float32,
                                       device="cpu")
    logits, ids = fwd(place(sd), batch["input_features"], batch["day_indicies"])
    out["forward"] = (logits.numpy(), ids.numpy())

    # Trainer(mesh=...) trains 10 steps and checkpoints at the end
    cfg = _trainer_cfg(out_dir)
    trainer = Trainer(cfg, device="cpu", mesh=mesh, train_trials=trials["train"],
                      val_trials=trials["val"])
    stats = trainer.train()
    val = trainer.validation()
    trainer.save(out_dir + "/final", val["avg_PER"], val["avg_loss"])   # collective
    out["trainer"] = {"losses": stats["train_losses"], "val_PER": val["avg_PER"],
                      "w_hh": tuple(trainer.sharded.params["gru.weight_hh_l0"].shape),
                      "params": {k: v.detach().numpy().copy()
                                 for k, v in trainer.model.state_dict().items()},
                      "step": trainer.step, "ckpt": out_dir + "/final"}
    # a mesh trainer resumed from that checkpoint holds the same shards,
    # moments and step
    cfg.init_from_checkpoint, cfg.init_checkpoint_path = True, out_dir + "/final"
    cfg.output_dir = cfg.checkpoint_dir = out_dir + "/resume"
    resumed = Trainer(cfg, device="cpu", mesh=mesh, train_trials=trials["train"])
    opt_a, opt_b = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    out["resumed"] = {
        "step": resumed.step,
        "params": all(torch.equal(resumed.sharded.params[n], p)
                      for n, p in trainer.sharded.params.items()),
        "moments": all(torch.equal(opt_a["state"][i][k], opt_b["state"][i][k])
                       for i in opt_a["state"] for k in ("exp_avg", "exp_avg_sq"))}
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's params, a batch, and its sharded step and forward."""
    import jax
    import jax.numpy as jnp

    from b2txt_tpu.models import gru_decoder
    from b2txt_tpu.parallel import build_sharded_forward as jax_forward
    from b2txt_tpu.parallel import build_sharded_train_step as jax_step
    from b2txt_tpu.parallel import make_mesh as jax_mesh
    from b2txt_tpu.train.optimizer import make_optimizer as jax_optimizer
    from b2txt_tpu.utils import TrainConfig as JaxTrainConfig
    from b2txt_tpu_torch.models import params_from_jax

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    cfg = _quiet_cfg(JaxTrainConfig)
    params = gru_decoder.init_params_from_config(jax.random.PRNGKey(0), cfg.model,
                                                 n_days=3, n_classes=41)
    params = jax.tree_util.tree_map(np.asarray, params)
    batch = _batch(np.random.default_rng(0))
    tx = jax_optimizer(cfg, params)
    mesh = jax_mesh(4, model_parallel=2)
    step, pp, pb = jax_step(cfg, params, tx, mesh)
    p = pp(params)
    opt_state = tx.init(p)
    losses, norms = [], []
    for i in range(2):
        p, opt_state, loss, norm = step(p, opt_state, jax.random.PRNGKey(5 + i), pb(batch))
        losses.append(float(loss))
        norms.append(float(norm))
    fwd, fpp = jax_forward(_tiny_cfg(JaxTrainConfig), params, mesh, compute_dtype=jnp.float32)
    logits, ids = fwd(fpp(params), jnp.asarray(batch["input_features"]),
                      jnp.asarray(batch["day_indicies"]))
    sd = {k: v.numpy() for k, v in params_from_jax(params).items()}
    return {"sd": sd, "batch": batch, "loss": losses, "grad_norm": norms,
            "w_hh": [np.asarray(p["layers"][k]["w_hh"]) for k in range(N_LAYERS)],
            "logits": np.asarray(logits), "ids": np.asarray(ids)}


@pytest.fixture(scope="module")
def trials():
    return {"train": synthetic_trials(SESSIONS, trials_per_session=8, neural_dim=16,
                                      split="train"),
            "val": synthetic_trials(SESSIONS, trials_per_session=4, neural_dim=16,
                                    split="val")}


@pytest.fixture(scope="module")
def ranks(jax_side, trials, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("mesh_trainer"))
    return spawn(_rank_cases, WORLD, args=(jax_side["sd"], jax_side["batch"], trials, out_dir),
                 timeout_s=SPAWN_DEADLINE_S)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_runs(ranks, shape):
    losses = ranks[0]["runs"][shape]
    assert len(losses) == 2 and np.isfinite(losses).all()
    # every rank returns the global batch's loss
    for r in ranks[1:]:
        np.testing.assert_allclose(r["runs"][shape], losses, rtol=1e-6)


def test_sharded_matches_jax_sharded_step(ranks, jax_side):
    """Noise off at mesh (2, 2): the JAX test's tolerances (:95-100)."""
    ours = ranks[0]["equal"]
    np.testing.assert_allclose(ours["loss"], jax_side["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], jax_side["grad_norm"], rtol=1e-5)
    for a, b in zip(ours["w_hh"], jax_side["w_hh"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_sharded_matches_unsharded_trainer_step(ranks, jax_side, trials, tmp_path):
    """The same two steps through the port's unsharded Trainer.train_step."""
    cfg = _quiet_cfg()
    cfg.dataset.sessions = SESSIONS + ["t15.2023.08.18"]   # the 3 days of the params
    cfg.dataset.days_per_batch = 2
    cfg.use_amp = False                 # f32, as the sharded step's default
    cfg.num_training_batches = 2
    cfg.output_dir = str(tmp_path)
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    trainer = Trainer(cfg, device="cpu", train_trials={**trials["train"], 2: trials["train"][1]})
    trainer.model.load_state_dict(_to_torch(jax_side["sd"]))
    batch = _to_torch(jax_side["batch"])
    figs = [trainer.train_step(batch) for _ in range(2)]
    ours = ranks[0]["equal"]
    np.testing.assert_allclose(ours["loss"], [float(f[0]) for f in figs], rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], [float(f[1]) for f in figs], rtol=1e-5)
    for k, a in enumerate(ours["w_hh"]):
        b = trainer.model.state_dict()[f"gru.weight_hh_l{k}"].numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_params_actually_sharded(ranks):
    """At model = 4 each rank holds 3H/4 rows of W_hh, and its AdamW
    moments have that shape; the head's weight splits its H columns."""
    H = 32
    for r in ranks:
        assert r["shards"] == {"w_hh": (3 * H // 4, H), "exp_avg": (3 * H // 4, H),
                               "exp_avg_sq": (3 * H // 4, H), "out_w": (41, H // 4)}


def test_partition_specs_cover_every_parameter(jax_side):
    specs = param_partition_specs(jax_side["sd"])
    assert set(specs) == set(jax_side["sd"])
    assert {n for n, d in specs.items() if d == 0} == {
        f"gru.{w}_l{k}" for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        for k in range(N_LAYERS)}
    assert specs["out.weight"] == 1 and specs["out.bias"] is None and specs["h0"] is None


def test_trainer_with_mesh(ranks):
    """tests/test_parallel.py:116-147: 10 finite steps, a sane trajectory,
    the parameters still sharded."""
    t = ranks[0]["trainer"]
    losses = t["losses"]
    assert len(losses) == TRAINER_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 1.5
    assert t["w_hh"] == (3 * 32 // 2, 32) and t["step"] == TRAINER_STEPS
    for r in ranks[1:]:
        assert r["trainer"]["losses"] == losses


def test_trainer_with_mesh_validation_and_checkpoint(ranks, trials, tmp_path_factory):
    """The mesh trainer's validation equals the unsharded trainer's on the
    same parameters, and its checkpoint (written by rank 0) holds them."""
    t = ranks[0]["trainer"]
    for r in ranks[1:]:
        assert r["trainer"]["val_PER"] == t["val_PER"]
    cfg = _trainer_cfg(str(tmp_path_factory.mktemp("unsharded")))
    trainer = Trainer(cfg, device="cpu", train_trials=trials["train"],
                      val_trials=trials["val"])
    trainer.model.load_state_dict(_to_torch(t["params"]))
    assert trainer.validation()["avg_PER"] == t["val_PER"]
    ckpt = load_checkpoint(t["ckpt"])
    assert ckpt["step"] == TRAINER_STEPS
    for name, v in t["params"].items():
        np.testing.assert_array_equal(ckpt["params"][name], v, err_msg=name)
    # the moments are gathered whole: an unsharded trainer loads them
    trainer.optimizer.load_state_dict(
        {"state": {int(i): _to_torch(st) for i, st in ckpt["opt_state"]["state"].items()},
         "param_groups": ckpt["opt_state"]["param_groups"]})
    shapes = {tuple(st["exp_avg"].shape) for st in ckpt["opt_state"]["state"].values()}
    assert (3 * 32, 32) in shapes and (41, 32) in shapes


def test_trainer_with_mesh_resumes_its_shards(ranks):
    for r in ranks:
        assert r["resumed"] == {"step": TRAINER_STEPS, "params": True, "moments": True}


def test_sharded_forward_matches_jax(ranks, jax_side):
    """build_sharded_forward at (2, 2) in f32: the model-forward tolerance
    (tests/test_gru_model.py:120) and the same greedy ids."""
    logits, ids = ranks[0]["forward"]
    np.testing.assert_allclose(logits, jax_side["logits"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ids, jax_side["ids"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["forward"][0], logits)


def test_make_mesh_raises_on_indivisible_model_parallel():
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(4, model_parallel=3)


def _rank_hangs():
    import torch.distributed as dist

    import time

    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))   # rank 1 never joins
    else:
        time.sleep(600)


def _rank_raises():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return dist.get_rank()


def test_spawn_kills_a_deadlock_at_its_deadline():
    with pytest.raises((TimeoutError, RuntimeError)):
        spawn(_rank_hangs, 2, timeout_s=6)


def test_spawn_reports_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(_rank_raises, 2, timeout_s=60)
