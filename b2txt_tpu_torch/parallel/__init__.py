"""Multi-device paths on ``torch.distributed``: one process per mesh
position (``launch.spawn``), a ("data", "model") ``DeviceMesh``
(``make_mesh``), the GRU decoder's sharding rules and the sharded train
step and forward. Counterpart of ``b2txt_tpu/parallel/``; its
``named_sharding_tree`` has no counterpart, since a placement here is a
plain dimension index, not a ``NamedSharding``."""

from .dp import ShardedTrainState, build_sharded_forward, build_sharded_train_step
from .launch import spawn
from .mesh import (batch_partition_specs, gather_params, make_mesh, mesh_device,
                   param_partition_specs, shard_params, shard_tensors)
