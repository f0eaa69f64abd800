"""The device mesh of data-parallel, ZeRO-3, sequence-, tensor- and
pipeline-parallel training and of sharded serving (port of
starvector_tpu/parallel/mesh.py).

The JAX package declares one global `Mesh` with the axes

    ("replica", "data", "fsdp", "sequence", "stage", "tensor")

and lets GSPMD insert every collective. The port runs one process a
device (torchrun), builds a `torch.distributed.device_mesh.DeviceMesh`
over the same axes and puts the collectives in by hand (parallel/zero.py):

  * DP    the batch is split over ("replica", "data", "fsdp"); gradients
          are summed over those ranks;
  * FSDP  parameters and their optimizer state are split over "fsdp"
          (ZeRO-3): each leaf is all-gathered at use and its gradient
          reduce-scattered back;
  * HSDP  "replica" keeps whole copies of the "fsdp" shards, as torch's
          HYBRID_SHARD;
  * SP    "sequence" splits the training activations' positions: each
          rank of a sequence group holds the same rows, computes its chunk
          of their positions and all-gathers K and V for its attention
          (parallel/sequence.py); weights split over ("fsdp", "sequence")
          where the dimension divides (ZeRO over sequence,
          sharding.widen_fsdp_over_sequence).

  * TP    "tensor" splits the heads and MLP columns of the decoder (and,
          in training, of the vision tower and the adapter): each rank
          holds its columns of the column-parallel projections and the
          same rows of the row-parallel ones, one all-reduce after each
          row-parallel product and, in training, one on the gradient at
          each column-parallel block's input (parallel/tensor.py); beside
          every other axis (the fastest axis: the ranks of a tensor group
          hold the same rows);

  * PP    "stage" cuts the decoder's stacked layers into contiguous blocks
          over the stage ranks, which hold the same rows; the training
          forward runs GPipe's microbatch ticks over them
          (parallel/pipeline.py), beside the batch axes and "tensor".

Axes of size 1 are always there, so the partition specs are those of the
JAX package whatever the mesh. A training mesh with `stage` and `sequence`
both above 1 raises ValueError, as the JAX pipeline does
(check_training_mesh). A serving mesh takes every axis, as the JAX worker
places its parameters on any mesh (tensor.serving_mesh_config): the ranks
of one (replica, data) coordinate serve one engine together, the
decoder's weights split as the rules place them and gathered at use
(zero.Layout.serve), and no axis splits a serving step's rows or
positions. A `PartitionSpec` here is
`P`, a tuple with one entry a dimension, each None, an axis name or a
tuple of names, as JAX's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import torch

AXIS_REPLICA = "replica"    # whole copies of the fsdp shards (HSDP's outer axis)
AXIS_DATA = "data"          # plain data parallelism
AXIS_FSDP = "fsdp"          # parameter and optimizer-state sharding (ZeRO-3)
AXIS_SEQUENCE = "sequence"  # context parallelism (training activations' positions)
AXIS_STAGE = "stage"        # pipeline parallelism (parallel/pipeline.py)
AXIS_TENSOR = "tensor"      # tensor parallelism (parallel/tensor.py)

MESH_AXES = (AXIS_REPLICA, AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE, AXIS_STAGE, AXIS_TENSOR)

# batch dims split over every axis but the model-parallel ones
BATCH_AXES = (AXIS_REPLICA, AXIS_DATA, AXIS_FSDP)


class P(tuple):
    """PartitionSpec stand-in: P("fsdp", None) is the tuple ("fsdp", None),
    entry for entry the JAX spec's, whose normal form it keeps: a list of
    names becomes a tuple, one name alone a string, no names None."""

    def __new__(cls, *entries):
        def normal(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (normal(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    replica: int = 1
    data: int = 1
    fsdp: int = -1  # -1: absorb all remaining devices
    sequence: int = 1
    stage: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        sizes = [self.replica, self.data, self.fsdp, self.sequence, self.stage, self.tensor]
        if sizes.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(s for s in sizes if s != -1)
        if -1 in sizes:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[sizes.index(-1)] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(f"mesh {sizes} does not cover {n_devices} devices")
        return tuple(sizes)


def mesh_config_from(config) -> MeshConfig:
    """The `mesh:` block of a training config, with the JAX main's defaults
    (no block: fsdp over every rank)."""
    g = config.get_path
    return MeshConfig(**{axis: int(g(f"mesh.{axis}", -1 if axis == AXIS_FSDP else 1))
                         for axis in MESH_AXES})


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a DeviceMesh over MESH_AXES, or of a mapping (a mesh
    shape, as the sharding functions take)."""
    if isinstance(mesh, Mapping):
        return {axis: int(mesh.get(axis, 1)) for axis in MESH_AXES}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def check_training_mesh(mesh) -> None:
    """Raise ValueError for a training mesh with `stage` and `sequence` both
    above 1: pipeline and sequence parallelism do not nest, in either
    package (the JAX pp_layer_scan raises the same words)."""
    sizes = axis_sizes(mesh)
    if sizes[AXIS_STAGE] > 1 and sizes[AXIS_SEQUENCE] > 1:
        raise ValueError("mesh has both stage > 1 and sequence > 1 — pipeline and "
                         "sequence parallelism cannot nest; pick one")


def create_mesh(config: MeshConfig | None = None, *, device_type: str | None = None):
    """The DeviceMesh over MESH_AXES of the default process group (ranks in
    row-major order, as the JAX package's reshape of its devices)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    shape = config.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def batch_spec(extra_dims: int = 0) -> P:
    """PartitionSpec of a [batch, ...] array: batch over all DP axes."""
    return P(BATCH_AXES, *([None] * extra_dims))


def seq_spec(extra_dims: int = 0) -> P:
    """PartitionSpec of a [batch, seq, ...] activation: batch over the DP
    axes and sequence over the context-parallel axis."""
    return P(BATCH_AXES, AXIS_SEQUENCE, *([None] * extra_dims))


def local_mesh_summary(mesh) -> str:
    sizes = axis_sizes(mesh)
    parts = [f"{name}={size}" for name, size in sizes.items()]
    return f"Mesh({', '.join(parts)}; {math.prod(sizes.values())} devices)"


def sanitize_for_mesh(spec, shape: tuple[int, ...], mesh) -> P:
    """The spec cut to the array's rank, with names the mesh lacks dropped
    and any entry whose axes do not divide its dimension replaced by None."""
    sizes = axis_sizes(mesh)
    entries = list(spec)[: len(shape)]
    entries += [None] * (len(shape) - len(entries))
    out = []
    for dim, axes in zip(shape, entries):
        if axes is None:
            out.append(None)
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(n for n in names if n in sizes)
        size = math.prod(sizes[n] for n in names)
        out.append(names if (names and dim % size == 0) else None)
    return P(*out)


def initialize_distributed(device) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    cuda:LOCAL_RANK over NCCL for a CUDA `device`, the CPU over gloo for
    "cpu". Without torchrun's variables it does nothing and returns
    `device`. A CUDA device without NCCL raises: nothing falls back to gloo
    or to the CPU."""
    import torch.distributed as dist

    device = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("training.device=cuda needs NCCL, which this torch lacks")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                **({"device_id": device} if backend == "nccl" else {}))
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, {device} needs {backend}")
    return device
