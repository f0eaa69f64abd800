"""Data-parallel, ZeRO-3, sequence- and tensor-parallel training and
tensor-parallel serving across GPUs (port of starvector_tpu/parallel/): the
mesh (mesh.py), the partition rules' machinery (sharding.py), the
collectives of a sharded step (zero.py), the sequence split of the
training forward (sequence.py) and a tensor rank's slices and collectives
(tensor.py). Pipeline parallelism is not ported yet (ROADMAP queue 1,
item 12)."""

from starvector_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_spec,
    create_mesh,
    local_mesh_summary,
)
from starvector_tpu_torch.parallel.sharding import (
    apply_partition_rules,
    make_param_shardings,
    shard_pytree,
)

__all__ = [
    "MeshConfig",
    "create_mesh",
    "batch_spec",
    "local_mesh_summary",
    "make_param_shardings",
    "apply_partition_rules",
    "shard_pytree",
]
