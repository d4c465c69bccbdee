"""The port's training slice against the JAX package on the CPU: CTC loss
and greedy decoding, schedules, optimizer groups, clipping, batch assembly,
and the Trainer itself (the same losses and parameters after 3 steps on the
same batches), plus learning, frozen parameters and checkpoints."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from b2txt_tpu.data import synthetic as jax_synthetic
from b2txt_tpu.ops import ctc as jax_ctc
from b2txt_tpu.train import Trainer as JaxTrainer
from b2txt_tpu.train import make_schedule as jax_make_schedule
from b2txt_tpu.train.optimizer import param_labels as jax_param_labels
from b2txt_tpu.utils.config import TrainConfig as JaxTrainConfig
from b2txt_tpu_torch.data import synthetic
from b2txt_tpu_torch.data.loader import BatchLoader, batch_to_device, prefetch_iterator
from b2txt_tpu_torch.models import GRUDecoder, params_from_jax, params_to_jax
from b2txt_tpu_torch.models.gru_decoder import dropout
from b2txt_tpu_torch.ops import ctc
from b2txt_tpu_torch.train import Trainer, load_checkpoint, make_schedule, param_label
from b2txt_tpu_torch.train.optimizer import clip_by_global_norm_, global_norm, trainability_mask
from b2txt_tpu_torch.utils.config import TrainConfig

SESSIONS = ["t15.2023.08.11", "t15.2023.08.13", "t15.2023.08.18"]
STEP_KEYS = ["input_features", "seq_class_ids", "n_time_steps", "phone_seq_lens", "day_indicies"]


def _small_cfg(cls, tmp_path, sessions, n_batches=40, augment=True):
    """tests/test_trainer.py:17-46's small config, for either package."""
    cfg = cls()
    cfg.model.n_input_features = 16
    cfg.model.n_units = 48
    cfg.model.n_layers = 2
    cfg.model.rnn_dropout = 0.0
    cfg.model.input_network.input_layer_dropout = 0.0
    cfg.model.input_network.input_layer_sizes = [16]
    cfg.dataset.neural_dim = 16
    cfg.dataset.sessions = sessions
    cfg.dataset.dataset_probability_val = [1] * len(sessions)
    cfg.dataset.batch_size = 8
    cfg.dataset.days_per_batch = 2
    cfg.dataset.dataset_dir = str(tmp_path)
    dt = cfg.dataset.data_transforms
    dt.white_noise_std, dt.constant_offset_std = (0.1, 0.02) if augment else (0.0, 0.0)
    if not augment:
        dt.random_cut = 0
    cfg.num_training_batches = n_batches
    cfg.lr_decay_steps = cfg.lr_decay_steps_day = n_batches
    cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 5
    cfg.lr_max = cfg.lr_max_day = 0.005
    cfg.epsilon = 1e-8
    cfg.batches_per_train_log = 10
    cfg.batches_per_val_step = 20
    cfg.use_amp = False
    cfg.output_dir = str(tmp_path / "out")
    cfg.checkpoint_dir = str(tmp_path / "out" / "checkpoint")
    return cfg


@pytest.fixture(scope="module")
def sessions_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sessions")
    jax_synthetic.write_synthetic_sessions(str(root), SESSIONS, trials_per_session=16,
                                           neural_dim=16)
    return root


def _ctc_inputs(rng, B=3, T=20, S=6, C=41):
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 2
    targets = rng.integers(1, C, (B, S)).astype(np.int32)
    in_lens = np.array([20, 17, 12], np.int32)
    tgt_lens = np.array([6, 4, 0], np.int32)
    return logits, targets, in_lens, tgt_lens


def test_ctc_loss_and_logit_gradient_match_jax(rng):
    logits, targets, in_lens, tgt_lens = _ctc_inputs(rng)
    jargs = [jnp.asarray(a) for a in (targets, in_lens, tgt_lens)]
    ref = jax_ctc.ctc_loss_from_logits(jnp.asarray(logits), *jargs)
    g_ref = jax.grad(lambda l: jnp.mean(jax_ctc.ctc_loss_from_logits(l, *jargs)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    targs = [torch.from_numpy(a) for a in (targets, in_lens, tgt_lens)]
    ours = ctc.ctc_loss_from_logits(lt, *targs)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ours.mean().backward()  # the trainer's plain mean, not reduction="mean"
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-4)


def test_greedy_decode_matches_jax(rng):
    logits, _, in_lens, _ = _ctc_inputs(rng)
    ref = jax_ctc.greedy_decode_ids(jnp.asarray(logits), jnp.asarray(in_lens))
    ours = ctc.greedy_decode_ids(torch.from_numpy(logits), torch.from_numpy(in_lens))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (ctc.batched_greedy_collapse(ours.numpy(), in_lens)
            == jax_ctc.batched_greedy_collapse(np.asarray(ref), in_lens))


@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("day", [False, True])
def test_schedules_match_jax(kind, day):
    cfgs = []
    for cls in (TrainConfig, JaxTrainConfig):
        cfg = cls()
        cfg.lr_scheduler_type = kind
        cfg.lr_max, cfg.lr_min, cfg.lr_decay_steps, cfg.lr_warmup_steps = 0.005, 0.0001, 1000, 100
        cfg.lr_max_day, cfg.lr_min_day = 0.004, 0.0002
        cfg.lr_decay_steps_day, cfg.lr_warmup_steps_day = 800, 50
        cfgs.append(cfg)
    ours, ref = make_schedule(cfgs[0], day), jax_make_schedule(cfgs[1], day)
    # the JAX schedules compute in float32, the port's in float64
    for step in [0, 1, 50, 100, 101, 500, 999, 1000, 1500]:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, err_msg=str(step))


def test_param_groups_and_mask_match_jax():
    cfg = TrainConfig()
    cfg.model.n_input_features, cfg.model.n_units, cfg.model.n_layers = 8, 8, 2
    cfg.model.rnn_trainable = False
    model = GRUDecoder(cfg.model, 3, 41, device="cpu")
    labels = {n: param_label(n) for n, _ in model.named_parameters()}
    params = jax.tree_util.tree_map(np.asarray, params_to_jax(model.state_dict()))
    jax_labels = jax_param_labels(params)
    # the JAX pytree → reference names, label by label
    flat = {}
    for i in range(3):
        flat[f"day_weights.{i}"] = jax_labels["day_w"]
        flat[f"day_biases.{i}"] = jax_labels["day_b"]
    for k, layer in enumerate(jax_labels["layers"]):
        for ours_name, jname in [("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                 ("bias_ih", "b_ih"), ("bias_hh", "b_hh")]:
            flat[f"gru.{ours_name}_l{k}"] = layer[jname]
    flat.update({"out.weight": jax_labels["out_w"], "out.bias": jax_labels["out_b"],
                 "h0": jax_labels["h0"]})
    assert labels == flat
    mask = trainability_mask(cfg, model)
    assert not any(v for n, v in mask.items() if n.startswith("gru."))
    assert all(v for n, v in mask.items() if not n.startswith("gru."))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(rng, max_norm):
    grads = [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = global_norm(ours)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    clip_by_global_norm_(ours, max_norm, norm)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_dropout_keeps_and_scales():
    x = torch.ones(200, 500)
    y = dropout(x, 0.4, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.6) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.6))


def test_batches_match_jax_loader_from_hdf5_and_memory(tmp_path, sessions_dir):
    """Same sampler → the JAX loader's batch == the port's from the same
    HDF5 files == the port's from the same trials drawn in memory."""
    cfg = _small_cfg(JaxTrainConfig, tmp_path, SESSIONS, n_batches=2)
    cfg.dataset.dataset_dir = str(sessions_dir)
    jt = JaxTrainer(cfg)
    ours = BatchLoader(jt.train_sampler)
    memory = BatchLoader(jt.train_sampler, trials=synthetic.synthetic_trials(
        SESSIONS, trials_per_session=16, neural_dim=16, split="train"))
    for i in range(2):
        ref = jt.train_loader.get_batch(i)
        for got in (ours.get_batch(i), memory.get_batch(i)):
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    moved = list(prefetch_iterator(ours, "cpu"))
    assert len(moved) == 2
    torch.testing.assert_close(moved[1]["input_features"],
                               torch.from_numpy(ours.get_batch(1)["input_features"]))


def test_trainer_matches_jax_trainer(tmp_path, sessions_dir):
    """Augmentation and dropout off, f32, the reference's epsilon 0.1 (with
    1e-8 Adam's first steps are ±lr on tiny noisy gradients), the JAX
    Trainer's initial parameters carried across: 3 steps on the same
    batches give losses within 1e-5 relative and parameters within 1e-5
    (both packages' arithmetic is f32; step 0 runs at lr 0)."""
    cfgs = []
    for cls in (JaxTrainConfig, TrainConfig):
        cfg = _small_cfg(cls, tmp_path, SESSIONS[:2], n_batches=3, augment=False)
        cfg.dataset.dataset_dir = str(sessions_dir)
        cfg.epsilon = 0.1
        cfg.lr_warmup_steps = cfg.lr_warmup_steps_day = 2
        cfgs.append(cfg)
    jt = JaxTrainer(cfgs[0])
    pt = Trainer(cfgs[1], device="cpu")
    pt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params)))
    for i in range(3):
        batch = jt.train_loader.get_batch(i)
        jt.params, jt.opt_state, j_loss, j_norm = jt._train_step(
            jt.params, jt.opt_state, jax.random.PRNGKey(i), *(jnp.asarray(batch[k]) for k in STEP_KEYS))
        p_loss, p_norm = pt.train_step(batch_to_device(batch, "cpu"))
        np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(float(p_norm), float(j_norm), rtol=1e-5)
    ours = jax.tree_util.tree_leaves(params_to_jax(pt.model.state_dict()))
    ref = jax.tree_util.tree_leaves(jt.params)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, sessions_dir):
    tmp_path = tmp_path_factory.mktemp("train")
    cfg = _small_cfg(TrainConfig, tmp_path, SESSIONS)
    cfg.dataset.dataset_dir = str(sessions_dir)
    trainer = Trainer(cfg, device="cpu")
    return cfg, trainer, trainer.train()


def test_training_learns(trained):
    _, _, stats = trained
    early = np.mean(stats["train_losses"][:5])
    late = np.mean(stats["train_losses"][-5:])
    assert late < early * 0.7, f"loss did not decrease: {early:.3f} -> {late:.3f}"
    assert stats["val_PERs"][-1] < stats["val_PERs"][0] or stats["val_PERs"][-1] < 0.5


def test_checkpoint_round_trip(trained, tmp_path):
    """The best checkpoint holds the parameters under the reference's names
    and the optimizer state; a fresh trainer loaded from it has the same
    parameters, optimizer state and step, and reproduces the val PER."""
    cfg, trainer, _ = trained
    path = str(tmp_path / "ckpt")
    trainer.save(path, 0.25, 1.5)
    ckpt = load_checkpoint(path)
    assert set(ckpt["params"]) == set(trainer.model.state_dict())
    assert ckpt["step"] == trainer.step and ckpt["val_PER"] == 0.25

    cfg2 = TrainConfig.from_dict(cfg.to_dict())
    cfg2.mode = "eval"
    cfg2.init_from_checkpoint = True
    cfg2.init_checkpoint_path = path
    cfg2.output_dir = str(tmp_path / "resume")
    cfg2.checkpoint_dir = str(tmp_path / "resume" / "ckpt")
    t2 = Trainer(cfg2, device="cpu")
    for (n, a), (_, b) in zip(trainer.model.state_dict().items(), t2.model.state_dict().items()):
        assert torch.equal(a, b), n
    s1, s2 = trainer.optimizer.state_dict(), t2.optimizer.state_dict()
    for k in s1["state"]:
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s1["state"][k][name], s2["state"][k][name])
    assert t2.step == trainer.step
    assert abs(t2.validation()["avg_PER"] - trainer.validation()["avg_PER"]) < 1e-9


def test_frozen_day_params(tmp_path, sessions_dir):
    """input_trainable=False: day parameters get zero gradients (not None),
    so AdamW moves them only by weight decay, which is 0 for the day group
    by default: they stay bit for bit; the GRU trains."""
    cfg = _small_cfg(TrainConfig, tmp_path, SESSIONS[:2], n_batches=3)
    cfg.dataset.dataset_dir = str(sessions_dir)
    cfg.model.input_network.input_trainable = False
    cfg.batches_per_val_step = 1000
    trainer = Trainer(cfg, device="cpu")
    day_before = trainer.model.day_weights[0].detach().clone()
    gru_before = trainer.model.gru.weight_ih_l0.detach().clone()
    trainer.train()
    assert torch.equal(trainer.model.day_weights[0], day_before)
    assert trainer.model.day_weights[0].grad is not None
    assert not torch.allclose(trainer.model.gru.weight_ih_l0, gru_before)
