"""Tensor parallelism, Megatron style, for serving and training (the
`tensor` axis of starvector_tpu/parallel/mesh.py, which the JAX package
leaves to GSPMD).

A tensor group of tp ranks serves one decoder: each rank holds its columns
of the column-parallel projections (q/k/v_proj and c_fc, kernels and
biases) and the same rows of the row-parallel ones (o_proj and
mlp/c_proj), computes with them, and one all-reduce over the group follows
each row-parallel product (ops/layers.py::dense, for a leaf registered
here). Embeddings, the head, the norms and the row-parallel biases stay
whole on every rank, so every rank holds the same residual stream.

Attention heads split along whole heads (`head_layout`): where tp divides
the KV heads, rank r holds KV heads [r Hkv / tp, (r + 1) Hkv / tp) with
their query groups, which is the JAX package's device shard of each leaf;
where the KV heads divide tp, each KV head is held by tp / Hkv ranks that
split its query group as evenly as it goes (the 8B's 36 over 4 on 8 ranks:
5 + 4 query heads over one KV head a rank). The JAX shard there is 576
columns, 4.5 heads, and GSPMD reshards at the head reshape; the port keeps
heads whole instead. StarVector-1B's fused c_attn (2048 query columns, then
128 K and 128 V columns of its one KV head) gives a rank two ranges: its
query heads' columns, then the 256 KV columns, which every rank holds whole
(the JAX rules split the 2304 columns evenly and GSPMD reshards).

An int8-weight decoder (ops/quantization.py) splits its codes as their
kernel; a column-split leaf's per-column scales go with its columns, a
row-split leaf's stay whole. The scales are the whole tree's: slices of a
tree quantized whole, or a rank's own slices quantized with each
row-parallel column's maximum taken over the group (`quantize_slices`).

Training on a mesh with `tensor` above 1 splits the same leaves of the
decoder, and those of the vision tower and the adapter (their own
`tensor_units`), the tensor ranges first and then each rank's fsdp shard
of its slice (parallel/sharding.py::shard_pytree, the split recorded as a
`TensorSlice` beside the fsdp one in parallel/zero.py). Two collectives
carry the backward, Megatron's f and g (`copy_to_group` and
`reduce_from_group`): a column-parallel block's input (a norm's output,
which every rank of the group holds) is the identity in the forward and
sums its gradient over the group in the backward; a row-parallel product's
fp32 partial is summed in the forward and passes its gradient through.
Leaves every rank of the group holds whole (norms, tables, row-parallel
biases) then take the same whole gradient on each rank. A range of a leaf
that several ranks hold (the 1B's K and V columns of c_attn on every rank;
at tensor 8 the 8B's k/v_proj slice of a KV head on the pair of ranks that
split its query heads) takes on each only the part of its gradient that
comes from the rank's own query heads: that part is summed over exactly
its holders (`TensorSlice.sum_shared`), and a sum over the whole leaf (the
global norm, Adafactor's statistics) counts it once, on its first holder
(`TensorSlice.owned`). Beside `stage` each stage's block of layers is
split so (parallel/pipeline.py in training).

Serving runs one engine over every rank of a data group (`ServingGroup`:
the ranks of one (replica, data) coordinate, fsdp x sequence x stage x
tensor of them). Its leader runs the engine's threads and broadcasts each
device call to the others (serve/engine.py); the tensor group within it
(`TensorGroup`) only sums the row-parallel products. Where fsdp, sequence
or stage is above 1 the group's weights are also split as the rules place
them and gathered at use (`ServingGroup.layout`, parallel/zero.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from starvector_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_FSDP, AXIS_REPLICA, AXIS_SEQUENCE, AXIS_STAGE, AXIS_TENSOR, MESH_AXES,
    MeshConfig, axis_sizes, create_mesh,
)

# the axes whose ranks serve one engine together (a data group)
GROUP_AXES = (AXIS_FSDP, AXIS_SEQUENCE, AXIS_STAGE, AXIS_TENSOR)


@dataclasses.dataclass(frozen=True)
class Heads:
    """One rank's attention heads: query heads [q_start, q_start + q_count)
    and KV heads [kv_start, kv_start + kv_count) of the whole model."""
    q_start: int
    q_count: int
    kv_start: int
    kv_count: int


def head_layout(H: int, Hkv: int, tp: int) -> list[Heads]:
    """Each of tp ranks' heads of a model with H query heads over Hkv KV
    heads. Raises ValueError where whole heads cannot be split so: Hkv
    neither a multiple nor a divisor of tp, or fewer query heads in a group
    than ranks sharing it."""
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    G = H // Hkv
    if Hkv % tp == 0:
        n = Hkv // tp
        return [Heads(r * n * G, n * G, r * n, n) for r in range(tp)]
    if tp % Hkv == 0 and G >= tp // Hkv:
        per = tp // Hkv
        base, extra = divmod(G, per)
        out = []
        for r in range(tp):
            g, j = divmod(r, per)
            out.append(Heads(g * G + j * base + min(j, extra), base + (j < extra), g, 1))
        return out
    raise ValueError(f"cannot split {H} query heads over {Hkv} KV heads into whole heads on "
                     f"{tp} ranks: tp must divide the KV heads, or the KV heads divide tp "
                     f"with at least tp / Hkv query heads a group")


class TensorGroup:
    """This rank's tensor group: its size, this rank's place in it and the
    process group (None for one rank, or for slicing without one), over
    which the row-parallel products are summed."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    @classmethod
    def of(cls, mesh) -> "TensorGroup":
        """The tensor group of this rank on a DeviceMesh over MESH_AXES."""
        if axis_sizes(mesh)[AXIS_TENSOR] == 1:
            return cls(None, 1, 0)
        return cls(mesh.get_group(AXIS_TENSOR), axis_sizes(mesh)[AXIS_TENSOR],
                   mesh.get_local_rank(AXIS_TENSOR))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the group, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """t's elementwise maximum over the group, in place."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t


class ServingGroup:
    """This rank's serving group: the ranks of its data group (one
    (replica, data) coordinate; fsdp x sequence x stage x tensor ranks,
    row-major), which hold the same rows of every request and serve one
    engine. `rank` is this rank's place in it, `leader` the global rank of
    its first, which runs the engine's threads and host state and sends
    every device call to the others (serve/engine.py), `data_rank` the
    group's place among the data groups, `tensor` the rank's TensorGroup
    (the row-parallel sums) and `layout` the parallel/zero.py Layout of the
    weights' fsdp, sequence and stage splits (None where all three are 1:
    the decoder is then its tensor slices alone)."""

    def __init__(self, group, size: int, rank: int, leader: int, data_rank: int,
                 tensor: TensorGroup, layout=None):
        self.group, self.size, self.rank, self.leader = group, size, rank, leader
        self.data_rank, self.tensor, self.layout = data_rank, tensor, layout

    @classmethod
    def of_tensor(cls, tensor: TensorGroup, leader: int = 0, data_rank: int = 0):
        """The serving group of a data x tensor mesh: the tensor group
        itself (a group without a process group slices and registers
        without collectives)."""
        return cls(tensor.group, tensor.size, tensor.rank, leader, data_rank, tensor)

    @classmethod
    def of(cls, mesh) -> "ServingGroup":
        """This rank's serving group on a serving DeviceMesh over MESH_AXES."""
        from starvector_tpu_torch.parallel import zero

        sizes = axis_sizes(mesh)
        data_rank = mesh.get_local_rank(AXIS_REPLICA) * sizes[AXIS_DATA] + \
            mesh.get_local_rank(AXIS_DATA)
        if all(sizes[a] == 1 for a in (AXIS_FSDP, AXIS_SEQUENCE, AXIS_STAGE)):
            tensor = TensorGroup.of(mesh)
            leader = dist.get_rank() - tensor.rank
            return cls.of_tensor(tensor, leader, data_rank)
        layout = zero.Layout(mesh, serving=True)
        size = math.prod(sizes[a] for a in GROUP_AXES)
        rank = dist.get_rank() % size
        group = zero._subgroup(layout.grid, GROUP_AXES)
        return cls(group, size, rank, dist.get_rank() - rank, data_rank, layout.tensor_group,
                   layout)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The leader's t on every rank (a follower's t, contiguous, is
        overwritten). A collective sends a tensor's storage as it lies, so
        a strided view (a column of a tick's tokens) goes as a copy."""
        if self.group is not None:
            t = t.contiguous()
            dist.broadcast(t, src=self.leader, group=self.group)
        return t

    def broadcast_object(self, obj=None):
        """A small host object (a dict of ints and lists), the leader's."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]


def serving_mesh_config(axes: dict) -> MeshConfig:
    """The serving mesh of a serve config's `mesh:` block ({axis: size}),
    as the JAX worker's MeshConfig(**axes): the unnamed axes 1, except fsdp,
    which stays -1 and absorbs the ranks the named axes leave ({"tensor": 4}
    on 8 ranks is fsdp 2 x tensor 4). Raises ValueError for a name that is
    not a mesh axis."""
    unknown = sorted(set(axes) - set(MESH_AXES))
    if unknown:
        raise ValueError(f"serving mesh axes {unknown}: not among {MESH_AXES}")
    return MeshConfig(**{a: int(v) for a, v in axes.items()})


def serving_group(axes: dict, device_type: str | None = None) -> ServingGroup:
    """This rank's serving group on the serving mesh of `axes` over the
    default process group (ranks row-major over MESH_AXES)."""
    return ServingGroup.of(create_mesh(serving_mesh_config(axes), device_type=device_type))


# --- the row-parallel leaves ----------------------------------------------------

_ROW = WeakIdKeyDictionary()  # local tensor -> its TensorGroup


def register_row(t: torch.Tensor, group: TensorGroup) -> torch.Tensor:
    """Mark t as a row-parallel kernel: its product is summed over `group`."""
    if group.size > 1:
        _ROW[t] = group
    return t


def row_group(t: torch.Tensor) -> TensorGroup | None:
    """The group a row-parallel kernel's product is summed over, else None."""
    return _ROW.get(t) if _ROW else None


def note_views(stacked: torch.Tensor, views) -> None:
    """The layers of a stacked row-parallel kernel are row-parallel too."""
    if _ROW:
        group = _ROW.get(stacked)
        if group is not None:
            for v in views:
                _ROW[v] = group


# --- a rank's slices --------------------------------------------------------------

def _tensor_dim(spec, ndim: int) -> int | None:
    """The dimension a partition spec splits over `tensor`, if any."""
    for i, a in enumerate(tuple(spec)[:ndim]):
        names = (a,) if isinstance(a, str) else tuple(a or ())
        if AXIS_TENSOR in names:
            return i
    return None


def _ranges(unit) -> tuple[tuple[int, int], ...]:
    """A `tensor_units` entry as its ranges: one (start, length), or a list
    of them (the 1B's fused c_attn: its query heads' columns, then the KV
    columns whole)."""
    return (tuple(unit),) if isinstance(unit[0], int) else tuple(tuple(r) for r in unit)


def leaf_slice(path: str, ndim: int, rules, units: dict):
    """(dim, ranges) of this rank's slice of the leaf at `path`, ranges a
    tuple of (start, length) along dim whose concatenation is the slice, or
    None when every rank holds it whole. `rules` are the decoder's
    partition rules, first match wins (a quantized leaf's codes, kernel_q,
    match its kernel's rule); `units` maps each split projection's name, or
    "parent/name" where two projections share a name (GPTBigCode's
    attn/c_proj and mlp/c_proj), to this rank's range or ranges along its
    split dimension (the decoder's `tensor_units`), or None for a leaf
    that every rank holds whole although its rule names `tensor` (the
    towers' patch embedding in training; it may be keyed by the leaf's own
    name)."""
    from starvector_tpu_torch.parallel.sharding import spec_for_path

    dim = _tensor_dim(spec_for_path(path, rules), ndim)
    if dim is None:
        return None
    parts = path.split("/")
    for name in ("/".join(parts[-3:-1]), parts[-2], parts[-1]):
        if name in units:
            return None if units[name] is None else (dim, _ranges(units[name]))
    raise NotImplementedError(f"{path}: its rule splits it over {AXIS_TENSOR}, and the model's "
                              f"tensor_units give no range of it")


def take(t: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """A contiguous copy of t's `ranges` along dim, concatenated."""
    parts = [t.detach().narrow(dim, start, n) for start, n in ranges]
    return parts[0].clone() if len(parts) == 1 else torch.cat(parts, dim)


def is_row_parallel(path: str, dim: int, ndim: int) -> bool:
    """A kernel (or its int8 codes) split along its input (rows): its
    product is a partial sum."""
    return path.endswith(("/kernel", "/kernel_q")) and dim == ndim - 2


def _cut(path: str, leaf: torch.Tensor, leaves: dict, rules, units: dict):
    """leaf_slice of one leaf of a tree (`leaves`: path -> leaf). The
    per-column scales of a quantized kernel match no rule: they follow their
    codes' columns where those are split, and stay whole where the codes
    are split by rows (each scale belongs to a column every rank holds)."""
    codes = path[:-len("scale")] + "kernel_q"
    if path.endswith("/scale") and codes in leaves:
        cut = leaf_slice(codes, leaves[codes].dim(), rules, units)
        if cut is None or cut[0] != leaves[codes].dim() - 1:
            return None
        return leaf.dim() - 1, cut[1]
    return leaf_slice(path, leaf.dim(), rules, units)


def shard_tree(params: dict, rules, units: dict, group: TensorGroup) -> dict:
    """This rank's tree: a contiguous copy of its slice of each split leaf
    (the leaf itself where unsplit), row-parallel kernels registered with
    `group`. A quantized tree (ops/quantization.py::quantize_tree of the
    whole decoder) gives the slices of its codes and scales as they are
    (_cut): the rank computes with the whole tree's rounding."""
    from starvector_tpu_torch.parallel.sharding import _paths, _rebuild

    leaves = dict(_paths(params))
    out = []
    for path, leaf in leaves.items():
        cut = None if group.size == 1 else _cut(path, leaf, leaves, rules, units)
        if cut is None:
            out.append(leaf)
            continue
        dim, ranges = cut
        local = take(leaf, dim, ranges)
        if is_row_parallel(path, dim, leaf.dim()):
            register_row(local, group)
        out.append(local)
    return _rebuild(params, iter(out))


def register_rows(params: dict, rules, group: TensorGroup) -> dict:
    """Register the row-parallel kernels (or codes) of a tree that already
    holds this rank's slices (a per-rank checkpoint load)."""
    from starvector_tpu_torch.parallel.sharding import _paths, spec_for_path

    for path, leaf in _paths(params):
        dim = _tensor_dim(spec_for_path(path, rules), leaf.dim())
        if dim is not None and is_row_parallel(path, dim, leaf.dim()):
            register_row(leaf, group)
    return params


def quantize_slices(params: dict, rules, all_units: list, group: TensorGroup,
                    min_elems: int = 1 << 16) -> dict:
    """quantize_tree of a tree of this rank's slices (a per-rank load),
    made to equal the slices of the whole tree's quantize_tree bit for bit:
    a kernel is quantized where the whole leaf reaches `min_elems` (its
    split dimension the union of every rank's ranges, `all_units` being
    each rank's tensor_units in rank order), and a row-parallel kernel's
    per-column absolute maximum is a MAX all-reduce over the group before
    it rounds (this rank's rows alone would give another scale). A
    column-split kernel holds whole columns, so its own maxima are the
    whole leaf's. Row-parallel codes are registered with the group. Each
    quantized leaf's kernel leaves the input tree (quantize_tree's
    `consume`)."""
    from starvector_tpu_torch.ops.quantization import quantize_dense

    def whole_numel(path: str, w: torch.Tensor) -> tuple[int, int | None]:
        cut = leaf_slice(path, w.ndim, rules, all_units[group.rank])
        if cut is None:
            return w.numel(), None
        # the ranks' ranges are disjoint or the same (a range every rank holds)
        ranges = {r for units in all_units for r in leaf_slice(path, w.ndim, rules, units)[1]}
        return w.numel() // w.shape[cut[0]] * sum(n for _, n in ranges), cut[0]

    def rec(node, path):
        if not isinstance(node, dict):
            return node
        w = node.get("kernel")
        if not (isinstance(w, torch.Tensor) and w.ndim in (2, 3)):
            return {k: rec(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        numel, dim = whole_numel(f"{path}/kernel", w)
        if numel < min_elems:
            return node
        row = dim is not None and is_row_parallel(f"{path}/kernel", dim, w.ndim)
        out = quantize_dense(node, reduce=group.all_reduce_max if row else None)
        del node["kernel"], w
        if row:
            register_row(out["kernel_q"], group)
        return out

    return rec(params, "")


def even_split(n: int, tp: int, rank: int) -> tuple[int, int]:
    """(start, length) of rank's contiguous 1/tp of n (n divisible by tp)."""
    if n % tp:
        raise ValueError(f"{n} does not split over {tp} tensor ranks")
    return rank * (n // tp), n // tp


# --- training: a leaf's tensor split and the collectives under autograd -----------

def _spans(ranges) -> list[tuple[int, int]]:
    """(local offset, length) of each of `ranges` in their concatenation."""
    out, off = [], 0
    for _, n in ranges:
        out.append((off, n))
        off += n
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class TensorSlice:
    """Where a training leaf split over `tensor` lies: its dimension `dim`,
    every tensor rank's ranges of the whole leaf along it (`ranges[r]`, in
    the order their concatenation keeps), this rank's place `rank` in the
    group `group`, and, per range of this rank, the process group of the
    ranks that hold that range too (None: this rank alone, or the range's
    holders when it is not this rank's)."""
    dim: int
    ranges: tuple
    rank: int
    group: TensorGroup
    shared: tuple

    @property
    def mine(self) -> tuple:
        return self.ranges[self.rank]

    def holders(self, rng) -> tuple[int, ...]:
        """The tensor ranks that hold the range `rng`."""
        return tuple(r for r, rs in enumerate(self.ranges) if tuple(rng) in rs)

    def owned(self, t: torch.Tensor, dim: int | None = None) -> list[torch.Tensor]:
        """Views of t (this rank's slice, or a view of it whose split
        dimension is `dim`) covering the ranges it counts in a sum over the
        whole leaf: every range but those a lower rank holds too (an empty
        view where that leaves none)."""
        dim = self.dim if dim is None else dim
        keep = [(off, n) for (off, n), rng in zip(_spans(self.mine), self.mine)
                if self.holders(rng)[0] == self.rank]
        if keep == [(0, t.shape[dim])]:
            return [t]
        return [t.narrow(dim, off, n) for off, n in keep or [(0, 0)]]

    def sum_shared(self, g: torch.Tensor) -> None:
        """Sum, in place, each range of this rank's gradient g that other
        ranks hold too over exactly its holders."""
        for (off, n), group in zip(_spans(self.mine), self.shared):
            if group is not None:
                part = g.narrow(self.dim, off, n).contiguous()
                dist.all_reduce(part, group=group)
                g.narrow(self.dim, off, n).copy_(part)

    def narrow_view(self, dropped: int) -> "TensorSlice | None":
        """The split of a view or reduction of the leaf without dimension
        `dropped` (None when that is the split one)."""
        if dropped == self.dim:
            return None
        return dataclasses.replace(self, dim=self.dim - (self.dim > dropped))


def tensor_slices(params: dict, rules, all_units: list, group: TensorGroup,
                  holder_group) -> dict:
    """{path: TensorSlice} of every leaf of a tree that its rule splits
    over `tensor` and `all_units` (each tensor rank's units by the tree's
    top-level key: {"svg_transformer": ..., "image_encoder": ...,
    "image_projection": ...}) cuts, and of a quantized kernel's scales
    that follow their codes' columns (_cut); the other leaves are absent.
    `holder_group(lists)` makes the process groups of ranges several ranks
    hold (every rank calls it alike: the holders come from every rank's
    units)."""
    from starvector_tpu_torch.parallel.sharding import _paths

    out = {}
    leaves = dict(_paths(params))
    for path, leaf in leaves.items():
        comp = path.split("/", 1)[0]
        cuts = [_cut(path, leaf, leaves, rules, units.get(comp, {})) for units in all_units]
        if cuts[0] is None:
            continue
        dim = cuts[0][0]
        ranges = tuple(c[1] for c in cuts)
        sets = sorted({tuple(r for r, rs in enumerate(ranges) if rng in rs)
                       for rs in ranges for rng in rs} - {(r,) for r in range(group.size)})
        groups = holder_group(tuple(sets)) if sets else {}
        ts = TensorSlice(dim, ranges, group.rank, group, ())
        shared = tuple(groups.get(ts.holders(rng)) for rng in ts.mine)
        out[path] = dataclasses.replace(ts, shared=shared)
    return out


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity in the forward; in the backward the
    gradient, each rank's part from its own columns, summed over the
    group."""

    @staticmethod
    def forward(ctx, t, group: TensorGroup):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the sum over the group in the forward (a row-parallel
    product's fp32 partials); the identity in the backward, each rank's
    partial taking the whole sum's gradient. (torch.distributed.nn's
    all_reduce sums the gradient again in its backward: that is f's
    backward, and on a row-parallel output it multiplies every upstream
    gradient by the group's size.)"""

    @staticmethod
    def forward(ctx, t, group: TensorGroup):
        return group.all_reduce(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


def training_group() -> TensorGroup | None:
    """The tensor group of the active training layout (parallel/zero.py),
    None without one or at tensor 1."""
    from starvector_tpu_torch.parallel import zero

    layout = zero.active()
    group = None if layout is None else layout.tensor_group
    return group if group is not None and group.size > 1 else None


def copy_to_group(t: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel block (every rank of the training
    layout's tensor group holds it whole): t, its gradient summed over the
    group. t itself outside a tensor-parallel training step or without
    autograd."""
    group = training_group()
    if group is None or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group: TensorGroup) -> torch.Tensor:
    """A row-parallel product's partial t summed over `group`: in place
    without autograd (serving), through _ReduceFromGroup under it."""
    if not (torch.is_grad_enabled() and t.requires_grad):
        return group.all_reduce(t)
    return _ReduceFromGroup.apply(t, group)
