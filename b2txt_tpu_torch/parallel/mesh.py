"""The ("data", "model") mesh and the GRU decoder's sharding rules.

Counterpart of ``b2txt_tpu/parallel/mesh.py``. The JAX package drives the
devices of a mesh from one process; here every mesh position is a process
of one ``torch.distributed`` group (``parallel/launch.py`` starts them),
and the mesh is a ``DeviceMesh`` over that group: rank ``i`` sits at
(data ``i // model_parallel``, model ``i % model_parallel``), the JAX
mesh's device layout. Batches shard over "data" on their leading axis; the
GRU gate dimension (the 3H rows of W_ih, W_hh and both biases) and the
head's hidden dimension shard over "model". Day parameters, the head's bias
and h0 are replicated.

A placement is the dimension a tensor splits along over its axis, or None
for a replicated tensor. Parameters carry the port's names, the reference
checkpoint's layout (``models/gru_decoder.py``); checkpoints and the
weight bridge (``models/torch_import.py``) keep the unsharded layout, which
``gather_params`` gives back.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .comm import gather_flat_shards

Placements = Dict[str, Optional[int]]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None):
    """A ("data", "model") ``DeviceMesh`` over the initialized default
    group, of ``n_devices`` ranks (None: the world size) as
    (n_devices // model_parallel, model_parallel). ``device_type`` None is
    "cuda" under NCCL and "cpu" otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if n != dist.get_world_size():
        raise ValueError(f"the mesh spans the whole group: {n} devices, "
                         f"world size {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_device(device=None) -> torch.device:
    """A rank's device: ``device`` if given, else the current CUDA card
    (``cuda:{current_device}``, which the caller or the launcher set)."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device())


def param_partition_specs(state_dict: Mapping[str, torch.Tensor]) -> Placements:
    """Each parameter's dimension split over "model", or None (replicated)."""
    specs: Placements = {}
    for name in state_dict:
        if name.startswith("gru."):
            specs[name] = 0           # (3H, in), (3H, H), (3H,)
        elif name == "out.weight":
            specs[name] = 1           # (C, H): C = 41 is indivisible, so H
        else:
            specs[name] = None        # day_weights.*, day_biases.*, out.bias, h0
    return specs


def batch_partition_specs() -> Placements:
    """Batch arrays shard over "data" on the leading (batch) axis."""
    return {"input_features": 0, "seq_class_ids": 0, "n_time_steps": 0,
            "phone_seq_lens": 0, "day_indicies": 0}


def data_rows(mesh, *arrays: np.ndarray) -> List[np.ndarray]:
    """Host arrays' rows padded with zeros to a multiple of the "data" axis,
    and this rank's block of them (rows the caller scores and discards)."""
    D, r = mesh["data"].size(), mesh.get_local_rank("data")
    b = -(-arrays[0].shape[0] // D)
    return [np.concatenate([a, np.zeros((b * D - a.shape[0],) + a.shape[1:], a.dtype)])
            [r * b:(r + 1) * b] for a in arrays]


def shard_tensors(tensors: Mapping[str, torch.Tensor], specs: Placements, mesh,
                  axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's slice along ``axis`` of each tensor of ``tensors`` by
    ``specs`` (a contiguous tensor; replicated ones and whole slices as
    they are, without a copy). Raises if a sharded dimension does not
    divide."""
    M, r = mesh[axis].size(), mesh.get_local_rank(axis)
    out = {}
    for name, t in tensors.items():
        dim = specs[name]
        if dim is None:
            out[name] = t
            continue
        if t.shape[dim] % M:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} not divisible by {axis}={M}")
        n = t.shape[dim] // M
        out[name] = t.narrow(dim, r * n, n).contiguous()
    return out


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of each GRU decoder parameter."""
    return shard_tensors(state_dict, param_partition_specs(state_dict), mesh)


def gather_params(local: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shards (one all-gather over
    "model": every rank of the mesh must call it)."""
    return gather_flat_shards({n: t.detach() for n, t in local.items()},
                              param_partition_specs(local), mesh.get_group("model"), grad=False)
