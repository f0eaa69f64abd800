"""Data-parallel, ZeRO-3, sequence-, tensor- and pipeline-parallel
training and tensor-parallel serving across GPUs (port of
starvector_tpu/parallel/): the mesh (mesh.py), the partition rules'
machinery (sharding.py), the collectives of a sharded step (zero.py), the
sequence split of the training forward (sequence.py), a tensor rank's
slices and collectives (tensor.py) and GPipe's ticks over the stage ranks'
blocks of layers (pipeline.py). Serving takes data and tensor meshes only
(ROADMAP queue 1, item 12)."""

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
