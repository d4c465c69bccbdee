"""Sharded training step and sharded forward: data parallelism over "data"
and tensor parallelism of the GRU gate dimension over "model".

Counterpart of ``b2txt_tpu/parallel/dp.py``. Every rank is given what the
JAX callers pass (the global batch, the full parameters); each takes its
own rows (data rank r of D holds rows [r·B/D, (r+1)·B/D)) and its own
parameter shards (``mesh.shard_params``), and gathers the outputs back, so
every rank returns what the JAX function returns and all ranks issue the
same collectives in the same order.

The "model" axis: a layer's sharded W_ih, W_hh and biases (and the head's
weight) are all-gathered over the "model" group just before use (one
all-gather of all of them, ``comm.gather_flat_shards``), and the model
runs on the rank's rows with the full-width weights, so the recurrence
still goes through K1 and K2 (no collective can run inside the kernels'
time loop). The parameters and the AdamW moments stay sharded: 3H/M rows
of each gate tensor per rank. The gather's backward keeps this rank's
slice of the gradient; XLA must do the same gather under GSPMD, since
``pallas_call`` does not partition.

Three things the JAX program gets from XLA are written out here:

1. Gradients: every "model" rank of a data row computes the same forward,
   so a shard's gradient is the local slice (never a sum over "model");
   then every gradient, sharded or replicated, is averaged over "data"
   (one ``all_reduce`` of a flat buffer that also carries the loss, so the
   returned loss is the global batch's mean).
2. The global norm: squared norms of sharded gradients are summed over
   "model", replicated ones counted once, then summed in parameter order,
   as ``train.optimizer.global_norm`` sums them; clipping follows.
3. Randomness: the random cut is one scalar per batch, drawn on every rank
   from a generator seeded alike (with ``cfg.seed``, as the unsharded
   ``Trainer`` seeds its own generator); noise, offset and dropout are per
   row, drawn from a generator of this data rank (the same on its "model"
   ranks, other on other data rows).

Like the JAX step, the sharded step always augments with
``transform_data`` (never the fused kernel K3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from ..models.gru_decoder import GRUDecoder
from ..ops.augment import TransformArgs, draw_transform, transform_data
from ..ops.ctc import ctc_loss, greedy_decode_ids
from ..train.optimizer import clip_by_global_norm_, set_learning_rates
from ..utils.config import TrainConfig
from .comm import gather_flat_shards, gather_rows
from .mesh import batch_partition_specs, mesh_device, param_partition_specs, shard_params

StateDict = Dict[str, torch.Tensor]


def _skeleton(cfg: TrainConfig, params: Mapping[str, torch.Tensor]) -> GRUDecoder:
    """A GRUDecoder without storage, run with ``functional_call``."""
    n_days = sum(1 for k in params if k.startswith("day_weights."))
    return GRUDecoder(cfg.model, n_days, int(params["out.bias"].shape[0]), device="meta")


def _data_rows(mesh, B: int) -> slice:
    D, r = mesh["data"].size(), mesh.get_local_rank("data")
    if B % D:
        raise ValueError(f"batch {B} not divisible by data axis {D}")
    b = B // D
    return slice(r * b, (r + 1) * b)


@dataclass
class ShardedTrainState:
    """What JAX's (params, opt_state) hold, for one rank: its parameter
    shards (leaf tensors), the optimizer over them with its schedules, the
    step count, and the two generators (shared: the cut; own: per-row
    draws)."""

    params: StateDict
    optimizer: torch.optim.Optimizer
    schedules: Dict[str, Callable[[int], float]]
    shared: torch.Generator
    own: torch.Generator
    step: int = 0


def build_sharded_train_step(
    cfg: TrainConfig,
    params: Mapping[str, torch.Tensor],
    optimizer: Callable,
    mesh,
    compute_dtype: torch.dtype = torch.float32,
    trainable_mask: Optional[Mapping[str, bool]] = None,
    device=None,
):
    """Returns (step, place_params, place_batch).

    ``place_params(state_dict)`` → a ``ShardedTrainState``: this rank's
    shards of the full ``state_dict`` on the device, and ``optimizer(cfg,
    named_shards)`` over them (``train.optimizer.make_optimizer``: the
    optimizer and its schedules; JAX's ``tx``). ``place_batch(batch)`` → this rank's rows of a global batch, on
    the device. ``step(state, local_batch)`` → (loss, grad_norm) as device
    scalars: the global batch's mean loss and the norm of the full
    gradients after masking, before clipping; it updates ``state`` in
    place. ``trainable_mask`` zeroes the gradients of frozen parameters.
    ``cfg.seed`` (0 for -1) seeds the generators, as it seeds the unsharded
    ``Trainer``'s."""
    device = mesh_device(device)
    targs = TransformArgs.from_config(cfg.dataset.data_transforms)
    per_row = targs._replace(random_cut=0)
    specs = param_partition_specs(params)
    skeleton = _skeleton(cfg, params)
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    seed = cfg.seed if cfg.seed != -1 else 0
    is_sharded = torch.tensor([specs[n] is not None for n in params], device=device)

    def place_params(state_dict: Mapping[str, torch.Tensor]) -> ShardedTrainState:
        local = {n: t.detach().to(device, torch.float32).clone().requires_grad_(True)
                 for n, t in shard_params(state_dict, mesh).items()}
        opt, schedules = optimizer(cfg, local)
        own_seed = seed + 1_000_003 * (mesh.get_local_rank("data") + 1)
        return ShardedTrainState(
            params=local, optimizer=opt, schedules=schedules,
            shared=torch.Generator(device=device).manual_seed(seed),
            own=torch.Generator(device=device).manual_seed(own_seed))

    def place_batch(batch: Mapping[str, Any]) -> StateDict:
        rows = _data_rows(mesh, len(batch["input_features"]))
        return {k: torch.as_tensor(batch[k])[rows].to(device) for k in batch_partition_specs()}

    def step(state: ShardedTrainState, batch: Mapping[str, torch.Tensor]):
        feats = batch["input_features"].float()
        draws = draw_transform(feats, per_row, state.own)
        if targs.random_cut > 0:
            draws.cut = torch.randint(0, targs.random_cut, (), generator=state.shared,
                                      device=device)
        feats, n_time = transform_data(feats, batch["n_time_steps"], targs, True, draws=draws)
        adjusted = skeleton.adjusted_lengths(n_time)
        full = gather_flat_shards(state.params, specs, model_group, grad=True)
        logits = functional_call(skeleton, full, (feats, batch["day_indicies"]), dict(
            compute_dtype=compute_dtype, training=True, generator=state.own))
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        loss = ctc_loss(log_probs, batch["seq_class_ids"], adjusted,
                        batch["phone_seq_lens"]).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()

        grads = []
        for name, p in state.params.items():
            if p.grad is None or (trainable_mask is not None and not trainable_mask[name]):
                p.grad = torch.zeros_like(p)  # frozen: zeros, so AdamW still steps them
            grads.append(p.grad)
        # one all-reduce over "data": every gradient and the loss
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=data_group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        loss = flat[-1]

        # squared norms: shards summed over "model", replicated ones once
        sq = torch.stack([torch.sum(g.float() ** 2) for g in grads])
        sq_model = torch.where(is_sharded, sq, 0.0)
        dist.all_reduce(sq_model, op=dist.ReduceOp.SUM, group=model_group)
        grad_norm = torch.sqrt(sum(torch.where(is_sharded, sq_model, sq).unbind()))
        if cfg.grad_norm_clip_value > 0:
            clip_by_global_norm_(grads, cfg.grad_norm_clip_value, grad_norm)
        set_learning_rates(state.optimizer, state.schedules, state.step)
        state.optimizer.step()
        state.step += 1
        return loss, grad_norm

    return step, place_params, place_batch


def build_sharded_forward(
    cfg: TrainConfig,
    params: Mapping[str, torch.Tensor],
    mesh,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
):
    """Sharded inference: batch over "data", the GRU gate dimension over
    "model". Returns (fwd, place_params): ``place_params(state_dict)`` →
    this rank's shards on the device; ``fwd(local, x, day_idx)`` takes the
    global batch and returns (logits (B, P, C) in ``compute_dtype``, greedy
    ids (B, P) int32) for all of it, gathered over "data"."""
    device = mesh_device(device)
    specs = param_partition_specs(params)
    skeleton = _skeleton(cfg, params)
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")

    def place_params(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
        return {n: t.detach().to(device) for n, t in shard_params(state_dict, mesh).items()}

    @torch.inference_mode()
    def fwd(local: StateDict, x: torch.Tensor, day_idx: torch.Tensor):
        rows = _data_rows(mesh, x.shape[0])
        full = gather_flat_shards(local, specs, model_group, grad=False)
        logits = functional_call(skeleton, full, (x[rows].to(device), day_idx[rows].to(device)),
                                 dict(compute_dtype=compute_dtype))
        P_len = logits.shape[1]
        ids = greedy_decode_ids(logits.float(), torch.full((logits.shape[0],), P_len,
                                                          device=device))
        logits = gather_rows(logits, data_group)
        ids = gather_rows(ids, data_group)
        return logits.reshape((-1,) + logits.shape[2:]), ids.reshape((-1,) + ids.shape[2:])

    return fwd, place_params


def _optimizer_param_names(state: ShardedTrainState) -> Dict[int, str]:
    """The optimizer state_dict's parameter index → parameter name."""
    name_of = {id(p): n for n, p in state.params.items()}
    ps = [p for group in state.optimizer.param_groups for p in group["params"]]
    return {i: name_of[id(p)] for i, p in enumerate(ps)}


def gather_optimizer_state(state: ShardedTrainState, mesh) -> Dict[str, Any]:
    """The optimizer's ``state_dict`` with the moments of every sharded
    parameter gathered whole: the state an unsharded optimizer over the
    full parameters would hold (one all-gather over "model")."""
    sd = state.optimizer.state_dict()
    names = _optimizer_param_names(state)
    specs = param_partition_specs(state.params)
    moments = {(i, k): v for i, st in sd["state"].items() for k, v in st.items()
               if torch.is_tensor(v) and v.dim() > 0}
    full = gather_flat_shards(moments, {key: specs[names[key[0]]] for key in moments},
                              mesh.get_group("model"), grad=False)
    # new dicts: state_dict() hands out the optimizer's own per-parameter dicts
    sd["state"] = {i: {k: full.get((i, k), v) for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def shard_optimizer_state(full: Mapping[str, Any], state: ShardedTrainState,
                          mesh) -> Dict[str, Any]:
    """The inverse of ``gather_optimizer_state``: this rank's slices of an
    unsharded optimizer ``state_dict``, ready for ``load_state_dict``."""
    names = _optimizer_param_names(state)
    specs = param_partition_specs(state.params)
    M, r = mesh["model"].size(), mesh.get_local_rank("model")

    def cut(v, dim):
        if dim is None or not torch.is_tensor(v) or v.dim() == 0:
            return v
        n = v.shape[dim] // M
        return v.narrow(dim, r * n, n).contiguous()

    return {"state": {i: {k: cut(v, specs[names[int(i)]]) for k, v in st.items()}
                      for i, st in full["state"].items()},
            "param_groups": full["param_groups"]}
