"""Data parallelism, ZeRO-3, sequence, tensor and pipeline parallelism at run
time:
the collectives that XLA inserts into the JAX package's GSPMD step, put in
by hand.

One process a device. Every parameter leaf is a plain local tensor, this
rank's shard (parallel/sharding.py::shard_pytree), and the registry here
records which of its dimensions is split and over which ranks (`Shard`):
the `fsdp` axis, or `fsdp` x `sequence` for a leaf widened over the
sequence axis (ZeRO over sequence). The kernels and the model code see
only plain contiguous tensors:

  * gather at use: `gathered(tree)` all-gathers each sharded leaf just
    before the model reads it (a decoder or ViT layer at a time, the small
    modules whole), through `_Gather`, whose backward reduce-scatters the
    gradient back to the shard. Nothing keeps the gathered weights for the
    backward: inside an activation checkpoint the gather is part of what
    the backward recomputes, and elsewhere `Layout.step()`'s saved-tensor
    hooks store the shard in its place and gather again when the backward
    reads it, as FSDP does;
  * gradients: a sharded leaf's shard is summed over the other ranks that
    hold the same shard; every other leaf over the ranks that split the
    step's work (`reduce_grads`);
  * the rank-local reductions of the step that must span the global batch:
    the loss's count of targets (`batch_sum`), the BatchNorm adapter's
    statistics (`batch_sum_grad`, summed in the forward and the backward),
    the rows of the dropout mask (`global_rows`), and the optimizer's
    reductions over a sharded leaf (train/optim.py through `Shard.sum`).

The ranks of a `sequence` group hold the same rows. Whether they also split
the rows' positions is decided each step, by the decoder, from the
sequence's length (parallel/sequence.py::split_sequence; the JAX package's
sanitize_for_mesh drops the axis where the length does not divide it), and
recorded on the layout (`Layout.seq_split`). With the split, each of them
holds a part of the loss and of every gradient, so the count of targets,
the loss and the gradients sum over batch x sequence; without it, each
computes the whole rows, its gradients are copies of its peers', and they
sum over the batch ranks only. The BatchNorm statistics and the dropout
rows always span the batch ranks only.

The ranks of a `tensor` group hold the same rows and the same positions;
each holds its slice of the leaves the rules split over `tensor`
(parallel/tensor.py::TensorSlice, recorded in the leaf's `Shard` beside
its fsdp split, which then cuts that slice), and the model's two tensor
collectives (tensor.copy_to_group, tensor.reduce_from_group) make every
whole leaf's gradient the same whole gradient on each of them. So no
reduction of the step's work spans the tensor ranks: the loss, its count,
the BatchNorm statistics, the dropout rows and the gradients of leaves
they hold whole sum over the batch (and sequence) ranks alone. A range of a
leaf that several tensor ranks hold sums its gradient over those ranks,
and the sums over a whole leaf count it once (`Shard.sum`).

The ranks of a `stage` group hold the same rows too, and each holds its
contiguous block of the decoder's stacked layers (`Shard.stage`, cut before
the tensor and fsdp splits); parallel/pipeline.py runs the layers over them.
The last stage alone differentiates the step's loss (`step_grads`): the
other stages differentiate only what the pipeline hands them (the end of
their chain of ticks, with a zero gradient), so a leaf every stage holds
whole (the towers, the adapter, the tables, ln_f) takes its gradient where
it arises, the part before the pipeline on stage 0 and the part after it on
the last stage, and sums it over the stage ranks once (`reduce_grads`); a
stage's layers take theirs on their own stage. The sums over a whole leaf
add the stage ranks' blocks of a stage-split leaf (`Shard.sum`), and a
leaf every stage holds whole counts once.

With no `Layout` active (`Layout.step()`), every function here returns
its input: the one-device path is the code it was.

Serving takes a Layout of its own (`Layout(mesh, serving=True)`, on a mesh
with any axes: stage and sequence may nest, since nothing splits a serving
step's rows or positions). Its ranks hold the same rows and positions of
every request; each holds its shards of the decoder as the rules place
them, and the cached forwards gather each layer whole just before they
read it (`layer_at`, `gathered`) and drop it after. `Layout.serve()` makes
it active on the calling thread alone (the engine's device calls, a
follower's replay), with no autograd: request threads that run beside it
see no layout and gather nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from starvector_tpu_torch.parallel import tensor as tp
from starvector_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, AXIS_REPLICA, \
    AXIS_SEQUENCE, AXIS_STAGE, AXIS_TENSOR, BATCH_AXES, MESH_AXES, axis_sizes, \
    check_training_mesh

# the collectives' newer names, where this torch has them
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _subgroup(grid: torch.Tensor, over: tuple[str, ...]):
    """This rank's group among the ranks of the mesh's rank grid that differ
    only in the axes `over` (every rank makes every such group); None when
    it holds this rank alone, the world when it holds every rank."""
    dims = [MESH_AXES.index(a) for a in over]
    rest = [i for i in range(grid.dim()) if i not in dims]
    lists = grid.permute(*rest, *dims).reshape(-1, math.prod(grid.shape[d] for d in dims))
    if lists.shape[1] == 1:
        return None
    if lists.shape[0] == 1:
        return dist.group.WORLD
    return dist.new_subgroups_by_enumeration(lists.tolist())[0]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """t summed in place over `group` (None: this rank alone)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _gather(shard: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The concatenation along `dim` of the n ranks' `shard` (group order)."""
    shard = shard.contiguous()
    out = shard.new_empty((n * shard.shape[0], *shard.shape[1:]))
    _all_gather(out, shard, group=group)
    if dim == 0:
        return out
    return out.view(n, *shard.shape).movedim(0, dim).flatten(dim, dim + 1)


def _scatter(full: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's part along `dim` of the sum of the n ranks' `full`."""
    parts = full.chunk(n, dim)
    out = parts[0].new_empty(parts[0].shape)
    _reduce_scatter(out, torch.cat(parts) if dim else full.contiguous(), group=group)
    return out


class Layout:
    """This rank's place on a DeviceMesh of the batch axes, `sequence`,
    `stage` and `tensor`, and its groups. Ranks are row-major over
    (replica, data, fsdp, sequence, stage, tensor): the sequence coordinate
    is `seq_rank`, the stage coordinate `stage_rank` (in `stage_group`),
    the tensor group `tensor_group` (parallel/tensor.py::TensorGroup), the
    batch coordinate (the row block of the global batch) `batch_rank` =
    rank // (sequence x stage x tensor). Every group below holds ranks of
    one tensor coordinate but `rows_group`, and ranks of one stage
    coordinate but `rows_group`, `stage_group` and the two stage_* groups.

      fsdp_group    the ranks that split a leaf over fsdp
      wide_group    the ranks that split a leaf widened over fsdp x
                    sequence, in the order f * sequence + s of JAX's
                    ("fsdp", "sequence")
      sequence_group  the ranks of one tensor coordinate that hold the same
                    rows
      rows_group    every rank that holds the same rows (sequence x stage x
                    tensor)
      batch_group   the ranks with this rank's sequence coordinate
      split_group   the ranks that split a step's work when its positions
                    are split (batch x sequence)
      shard_group   the ranks that hold the same shard of a leaf split over
                    fsdp x sequence, or of a fsdp leaf in a step without the
                    split (replica x data)
      fsdp_shard_group  the ranks that hold the same fsdp shard in a step
                    with the split (replica x data x sequence)
      stage_batch_group, stage_shard_group  batch_group and shard_group
                    with the stage ranks beside them: the sums of the
                    gradient of a leaf every stage holds whole

    A group of one rank is None (no collective); the world is
    dist.group.WORLD. A training mesh with stage and sequence both above 1
    raises ValueError (mesh.check_training_mesh); a `serving` layout takes
    any mesh."""

    def __init__(self, mesh, *, serving: bool = False):
        if not serving:
            check_training_mesh(mesh)
        self.serving = serving
        sizes = axis_sizes(mesh)
        self.mesh = mesh
        self.fsdp = sizes[AXIS_FSDP]
        self.sequence = sizes[AXIS_SEQUENCE]
        self.stage = sizes[AXIS_STAGE]
        self.tensor = sizes[AXIS_TENSOR]
        self.batch = math.prod(sizes[a] for a in BATCH_AXES)
        self.fsdp_group = mesh.get_group(AXIS_FSDP)
        self.fsdp_rank = mesh.get_local_rank(AXIS_FSDP)
        self.seq_rank = mesh.get_local_rank(AXIS_SEQUENCE)
        self.stage_rank = mesh.get_local_rank(AXIS_STAGE)
        self.tensor_group = tp.TensorGroup.of(mesh)
        self.batch_rank = dist.get_rank() // (self.sequence * self.stage * self.tensor)
        self.seq_split = False  # whether this step's decoder split the positions
        self.stage_roots: list = []  # what a stage but the last differentiates (step_grads)
        self.stage_token = None      # the leaf every pipeline chain starts from
        grid = mesh.mesh
        self.grid = grid
        rows = (AXIS_REPLICA, AXIS_DATA)
        self.shard_group = _subgroup(grid, rows)
        self.batch_group = _subgroup(grid, BATCH_AXES)
        self.rows_group = _subgroup(grid, (AXIS_SEQUENCE, AXIS_STAGE, AXIS_TENSOR))
        if self.stage == 1:
            self.stage_group = None
            self.stage_batch_group, self.stage_shard_group = self.batch_group, self.shard_group
        else:
            self.stage_group = mesh.get_group(AXIS_STAGE)
            self.stage_batch_group = _subgroup(grid, BATCH_AXES + (AXIS_STAGE,))
            self.stage_shard_group = _subgroup(grid, rows + (AXIS_STAGE,))
        if self.sequence == 1:
            self.sequence_group, self.wide_group = None, self.fsdp_group
            self.split_group, self.fsdp_shard_group = self.batch_group, self.shard_group
        else:
            self.sequence_group = mesh.get_group(AXIS_SEQUENCE)
            self.wide_group = _subgroup(grid, (AXIS_FSDP, AXIS_SEQUENCE))
            self.split_group = _subgroup(grid, BATCH_AXES + (AXIS_SEQUENCE,))
            self.fsdp_shard_group = _subgroup(grid, rows + (AXIS_SEQUENCE,))
        self._holders: dict = {}

    def holder_groups(self, sets: tuple) -> dict:
        """{tensor ranks: process group} of the sets of tensor ranks that
        hold one range of a leaf (disjoint, more than one rank each), in
        every tensor group of the mesh. Every rank calls it with the same
        sets in the same order (parallel/tensor.py::tensor_slices)."""
        if sets not in self._holders:
            if sets == (tuple(range(self.tensor)),):
                self._holders[sets] = {sets[0]: self.tensor_group.group}
            else:
                tensor_groups = self.grid.reshape(-1, self.tensor).tolist()
                lists = [[g[t] for t in s] for g in tensor_groups for s in sets]
                mine, _ = dist.new_subgroups_by_enumeration(lists)
                t = self.tensor_group.rank
                self._holders[sets] = {s: mine for s in sets if t in s}
        return self._holders[sets]

    # --- a leaf's split --------------------------------------------------------
    def split(self, wide: bool) -> tuple[object, int, int]:
        """(group, ranks, this rank's index) of a leaf split over fsdp, or
        widened over fsdp x sequence."""
        if wide:
            return self.wide_group, self.fsdp * self.sequence, \
                self.fsdp_rank * self.sequence + self.seq_rank
        return self.fsdp_group, self.fsdp, self.fsdp_rank

    def all_gather(self, shard: torch.Tensor, dim: int, wide: bool = False) -> torch.Tensor:
        """The whole leaf from each rank's shard, split along `dim`."""
        group, n, _ = self.split(wide)
        return _gather(shard, dim, group, n)

    def reduce_scatter(self, full: torch.Tensor, dim: int, wide: bool = False) -> torch.Tensor:
        """This rank's shard of the sum of `full` over the ranks that split
        the leaf. A widened leaf in a step without the split: its sequence
        peers' `full` are copies, so the sum spans the fsdp ranks, and this
        rank takes its part of their shard."""
        if wide and self.sequence > 1 and not self.seq_split:
            part = _scatter(full, dim, self.fsdp_group, self.fsdp)
            return part.chunk(self.sequence, dim)[self.seq_rank].contiguous()
        group, n, _ = self.split(wide)
        return _scatter(full, dim, group, n)

    def split_sum(self, t: torch.Tensor, wide: bool = False) -> torch.Tensor:
        """Sum of `t` over the ranks that split a leaf (a new tensor, no
        gradient)."""
        return _all_reduce(t.detach().clone(), self.split(wide)[0])

    # --- the stage axis ----------------------------------------------------------
    def stage_peer(self, s: int) -> int:
        """The global rank of stage s of this rank's stage group."""
        return dist.get_global_rank(self.stage_group, s)

    def stage_broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Stage `src`'s t on every stage rank (a new tensor; t gives the
        shape elsewhere)."""
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=self.stage_peer(src), group=self.stage_group)
        return out

    def stage_reduce(self, t: torch.Tensor, dst: int) -> torch.Tensor:
        """On stage `dst` the sum of the stage ranks' t, elsewhere zeros."""
        total = _all_reduce(t.detach().clone(memory_format=torch.contiguous_format),
                            self.stage_group)
        return total if self.stage_rank == dst else torch.zeros_like(total)

    # --- the sequence axis -----------------------------------------------------
    def seq_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sequence group's `t` concatenated along `dim`."""
        return _gather(t, dim, self.sequence_group, self.sequence)

    def seq_reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part along `dim` of the sum of the sequence group's `t`."""
        return _scatter(t, dim, self.sequence_group, self.sequence)

    def rows_broadcast(self, tree: dict) -> dict:
        """A dict of tensors and plain objects as the first of the ranks
        that hold this rank's rows (its sequence and tensor ranks) has it
        (through the host), each tensor on the device this rank's own value
        of it was on."""
        if self.rows_group is None:
            return tree
        devices = {k: v.device for k, v in tree.items() if isinstance(v, torch.Tensor)}
        box = [{k: v.cpu() if k in devices else v for k, v in tree.items()}]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.rows_group, 0),
                                   group=self.rows_group)
        return {k: v.to(devices[k]) if k in devices else v for k, v in box[0].items()}

    # --- the step's reductions -------------------------------------------------
    def work_group(self):
        """The ranks that split this step's work: batch x sequence with the
        split, else the batch ranks (never the tensor ranks, which hold the
        same work)."""
        return self.split_group if self.seq_split else self.batch_group

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks that split the step's work (a new
        tensor, no gradient)."""
        return _all_reduce(t.detach().clone(), self.work_group())

    def grad_group(self, info: "Shard"):
        """The ranks over which a leaf's gradient (a sharded leaf's after its
        reduce-scatter) is summed; a range several tensor ranks hold sums
        over them besides (TensorSlice.sum_shared). On a stage mesh a leaf
        every stage holds whole sums over the stage ranks too; a stage's
        layers over the ranks of their stage."""
        if self.stage > 1 and not info.stage:
            return self.stage_batch_group if info.dim is None else self.stage_shard_group
        if info.dim is None:
            return self.work_group()
        return self.fsdp_shard_group if self.seq_split and not info.wide else self.shard_group

    @contextlib.contextmanager
    def step(self):
        """Within: the model's gathers, reductions and dropout follow this
        layout, and a gathered weight that autograd saves is kept as its
        shard and gathered again in the backward. The step starts without
        the sequence split; the decoder records it. The pipeline records
        its roots and token (step_grads)."""
        self.seq_split = False
        self.stage_roots, self.stage_token = [], None
        _ACTIVE.append(self)
        try:
            with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
                yield self
        finally:
            _ACTIVE.pop()

    @contextlib.contextmanager
    def serve(self):
        """Within, on the calling thread only and under inference mode: the
        cached forwards gather this serving layout's shards at use. No
        saved-tensor hooks, no step state."""
        if not self.serving:
            raise ValueError("Layout.serve() takes a serving layout (Layout(mesh, serving=True))")
        stack = _LOCAL.__dict__.setdefault("serving", [])
        stack.append(self)
        try:
            with torch.inference_mode():
                yield self
        finally:
            stack.pop()


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """Where a local tensor lies: its layout, the dimension split over fsdp
    (None: none), the whole leaf's shape, whether that split spans fsdp x
    sequence (`wide`, ZeRO over sequence) or fsdp, its tensor split (None:
    every tensor rank holds the leaf whole), and whether its leading layer
    axis is cut into contiguous blocks over the stage ranks (`stage`). A
    leaf split several ways is this stage's block, its tensor slice, cut
    over fsdp. `owner`, on a layer view only: the view stands in for the
    same layer of stage `owner`'s block, which `gather` fetches from there
    (the pipeline's fallback, parallel/pipeline.py)."""
    layout: Layout
    dim: int | None
    full_shape: tuple[int, ...]
    wide: bool = False
    tensor: "tp.TensorSlice | None" = None
    stage: bool = False
    owner: int | None = None

    @property
    def n(self) -> int:
        """The ranks that split the leaf over fsdp."""
        return self.layout.split(self.wide)[1]

    @property
    def index(self) -> int:
        """This rank's fsdp shard among them."""
        return self.layout.split(self.wide)[2]

    def fsdp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks that split the leaf over fsdp (no
        gradient)."""
        return t if self.dim is None else self.layout.split_sum(t, self.wide)

    def tensor_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the tensor group (no gradient)."""
        return t if self.tensor is None else self.tensor.group.all_reduce(t.detach().clone())

    def stage_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the stage ranks of a stage-split leaf (no
        gradient)."""
        return _all_reduce(t.detach().clone(), self.layout.stage_group) if self.stage else t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over every rank that splits the leaf (no gradient).
        A range several tensor ranks hold must be in one rank's t only
        (`owned`)."""
        return self.stage_sum(self.tensor_sum(self.fsdp_sum(t)))

    def owned(self, t: torch.Tensor, dim: int | None = None) -> list[torch.Tensor]:
        """Views of t (this rank's piece, or a view of it whose tensor-split
        dimension is `dim`) that a sum over the whole leaf counts."""
        return [t] if self.tensor is None else self.tensor.owned(t, dim)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """This rank's tensor slice of the leaf (the whole leaf without a
        tensor split) from its fsdp shard (no gradient); the owner's, for a
        stand-in."""
        if self.owner is not None:
            shard = self.layout.stage_broadcast(shard, self.owner)
        return shard if self.dim is None else self.layout.all_gather(shard, self.dim, self.wide)

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from this rank's piece (no gradient): its fsdp
        shards gathered, the tensor ranks' slices put where their ranges
        lie (a range several hold taken from its first holder), then the
        stage ranks' blocks of layers concatenated."""
        if self.dim is not None:
            local = self.gather(local)
        if self.tensor is not None:
            local = self._tensor_whole(local)
        return _gather(local, 0, self.layout.stage_group, self.layout.stage) if self.stage \
            else local

    def _tensor_whole(self, local: torch.Tensor) -> torch.Tensor:
        ts = self.tensor
        d = ts.dim
        lens = [sum(n for _, n in rs) for rs in ts.ranges]
        pad = max(lens) - local.shape[d]
        if pad:
            local = torch.cat([local, local.new_zeros(
                (*local.shape[:d], pad, *local.shape[d + 1:]))], d)
        parts = _gather(local, d, ts.group.group, ts.group.size).chunk(ts.group.size, d)
        out = local.new_empty((local.shape[0], *self.full_shape[1:]) if self.stage
                              else self.full_shape)
        for r in reversed(range(ts.group.size)):  # the first holder writes last
            for (start, n), (off, _) in zip(ts.ranges[r], tp._spans(ts.ranges[r])):
                out.narrow(d, start, n).copy_(parts[r].narrow(d, off, n))
        return out

    def local_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole leaf (a view or a copy)."""
        if self.stage:
            n = full.shape[0] // self.layout.stage
            full = full.narrow(0, self.layout.stage_rank * n, n)
        if self.tensor is not None:
            full = tp.take(full, self.tensor.dim, self.tensor.mine)
        if self.dim is not None:
            n = full.shape[self.dim] // self.n
            full = full.narrow(self.dim, self.index * n, n)
        return full


_INFO = WeakIdKeyDictionary()      # local tensor -> Shard
_GATHERED = WeakIdKeyDictionary()  # gathered tensor -> (its shard, Shard, dtype)
_ACTIVE: list[Layout] = []         # training steps (Layout.step), process-wide
_LOCAL = threading.local()         # .serving: this thread's serving layouts (Layout.serve)


def active() -> Layout | None:
    """The calling thread's serving layout, else the training step's, else
    None."""
    serving = getattr(_LOCAL, "serving", None)
    if serving:
        return serving[-1]
    return _ACTIVE[-1] if _ACTIVE else None


def register(t: torch.Tensor, info: Shard | None) -> torch.Tensor:
    if info is not None:
        _INFO[t] = info
    return t


def info_of(t) -> Shard | None:
    return _INFO.get(t) if isinstance(t, torch.Tensor) else None


def sharded(t) -> Shard | None:
    """t's Shard when a dimension of it is split over ranks (fsdp, tensor
    or stage), else None."""
    info = info_of(t)
    return info if info is not None and (info.dim is not None or info.tensor is not None
                                         or info.stage) else None


def full_shape(t: torch.Tensor) -> tuple[int, ...]:
    info = info_of(t)
    return tuple(t.shape) if info is None else info.full_shape


def layout_of(tree) -> Layout | None:
    """The layout of a tree's first registered leaf (a tree that
    shard_pytree made), else None."""
    from starvector_tpu_torch.train.optim import tree_leaves

    for leaf in tree_leaves(tree):
        info = info_of(leaf)
        if info is not None:
            return info.layout
    return None


def register_like(t: torch.Tensor, like: torch.Tensor, dropped: int | None = None) -> torch.Tensor:
    """Register t as `like` lies, or, with `dropped`, as `like` with that
    dimension reduced away (a factored second moment)."""
    tp.note_views(like, (t,))
    info = info_of(like)
    if info is None:
        return t
    if dropped is None:
        return register(t, info)
    dim = info.dim
    if dim is not None:
        dim = None if dim == dropped else dim - (dim > dropped)
    shape = info.full_shape[:dropped] + info.full_shape[dropped + 1:]
    ts = None if info.tensor is None else info.tensor.narrow_view(dropped)
    return register(t, dataclasses.replace(info, dim=dim, full_shape=shape, tensor=ts,
                                           stage=info.stage and dropped != 0))


def note_views(stacked: torch.Tensor, views) -> None:
    """Register the layers of a stacked leaf (layer_unbind): each lies as
    the stack with its leading layer axis removed (split over no rank but
    the stage ranks, whose block each view is a layer of)."""
    info = info_of(stacked)
    if info is None:
        return
    if info.dim == 0 or (info.tensor is not None and info.tensor.dim == 0):
        raise ValueError("a stacked leaf's layer axis is split over fsdp or tensor")
    sub = dataclasses.replace(info, dim=None if info.dim is None else info.dim - 1,
                              full_shape=info.full_shape[1:], stage=False,
                              tensor=None if info.tensor is None else info.tensor.narrow_view(0))
    for v in views:
        _INFO[v] = sub


def stand_in(view: torch.Tensor, owner: int) -> torch.Tensor:
    """A view of a layer of this stage's block (layer_unbind's) that stands
    in for the same layer of stage `owner`'s block: `gather` broadcasts
    that layer from its owner, and its gradient sums back there
    (_Gather)."""
    v = view.view_as(view)
    _INFO[v] = dataclasses.replace(info_of(view), owner=owner)
    tp.note_views(view, (v,))
    return v


# --- gather at use ----------------------------------------------------------

class _Gather(torch.autograd.Function):
    """all-gather over the leaf's ranks in the forward (then the cast to
    `dtype`), the gradient reduce-scattered back to the shard in the
    backward; a stand-in's layer broadcast from its owner first, and its
    gradient summed back there last."""

    @staticmethod
    def forward(ctx, shard, info: Shard, dtype):
        ctx.info, ctx.shard_dtype = info, shard.dtype
        full = info.gather(shard)
        return full if dtype is None else full.to(dtype)

    @staticmethod
    def backward(ctx, g):
        info, g = ctx.info, g.to(ctx.shard_dtype)
        if info.dim is not None:
            g = info.layout.reduce_scatter(g, info.dim, info.wide)
        if info.owner is not None:
            g = info.layout.stage_reduce(g, info.owner)
        return g, None, None


def gather(t: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole leaf (this rank's tensor slice of it) of a local tensor
    split over fsdp, or the owner's layer of a stand-in (differentiable),
    else t. A row-parallel mark (parallel/tensor.py) goes with it."""
    info = info_of(t)
    if info is None or (info.dim is None and info.owner is None):
        return t
    if torch.is_grad_enabled():
        full = _Gather.apply(t, info, None if dtype == t.dtype else dtype)
        _GATHERED[full] = (t.detach(), info, full.dtype)
    else:  # serving, or a forward without autograd: nothing to save
        full = info.gather(t)
        full = full if dtype is None else full.to(dtype)
    tp.note_views(t, (full,))
    return full


def gathered(tree, policy=None):
    """The tree with every sharded leaf gathered (without an active layout,
    the tree itself). With a policy, dense kernels (leaves named
    "kernel") come in its compute dtype, the cast the model makes anyway, so
    that the tensor a product saves for its backward is the gathered one."""
    if active() is None:
        return tree
    dtype = None if policy is None else policy.compute_dtype

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return gather(node, dtype if key == "kernel" else None)

    return walk(tree)


def layer_at(layers: dict, i: int) -> dict:
    """Layer i of the stacked `layers` as a cached forward reads it: views
    of the stacks (as ops/layers.py::layer_slice) without an active layout;
    on one, each leaf of the layer whole (this rank's tensor slice of it),
    a leaf cut into stage blocks fetched from the stage that holds layer i
    (`stand_in`), a fsdp shard all-gathered (`gather`). Every rank of the
    layout calls it for the same layers in the same order."""
    if active() is None:
        from starvector_tpu_torch.ops.layers import layer_slice

        return layer_slice(layers, i)

    def leaf(t):
        info = info_of(t)
        n = t.shape[0]
        view = t[i % n if info is not None and info.stage else i]
        note_views(t, (view,))
        tp.note_views(t, (view,))
        if info is not None and info.stage:
            view = stand_in(view, i // n)
        return gather(view)

    return _map(layers, leaf)


class _Regather:
    """What a saved gathered weight is kept as until the backward reads it."""

    def __init__(self, shard, info: Shard, dtype):
        self.shard, self.info, self.dtype = shard, info, dtype

    def __call__(self) -> torch.Tensor:
        with torch.no_grad():
            return self.info.gather(self.shard).to(self.dtype)


def _pack(t):
    rec = _GATHERED.get(t)
    return t if rec is None else _Regather(*rec)


def _unpack(x):
    return x() if isinstance(x, _Regather) else x


# --- batch reductions -------------------------------------------------------

def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of a detached value (a count, a loss) over the ranks that split
    the step's work (Layout.batch_sum); t itself without an active layout."""
    layout = active()
    return t if layout is None else layout.batch_sum(t)


class _BatchSum(torch.autograd.Function):
    """Sum over the batch ranks; the gradient of each rank's addend is the
    sum of every batch rank's gradient of the result. A sequence group's
    ranks hold the same rows, so neither sum spans them: in a step with the
    split each holds a part of the gradient, which reduce_grads sums."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


def batch_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the batch ranks (requires an active layout)."""
    return _BatchSum.apply(t, active().batch_group)


def global_rows(n: int) -> tuple[int, int] | None:
    """(first row, rows of the global batch) of this rank's block of n rows,
    or None without an active layout."""
    layout = active()
    return None if layout is None else (layout.batch_rank * n, layout.batch * n)


def step_grads(loss: torch.Tensor, wrt: list) -> list:
    """The gradients of the step's loss with respect to `wrt` (None where a
    leaf takes none), as torch.autograd.grad(loss, wrt, allow_unused=True).
    On a stage mesh the last stage differentiates the loss and every other
    stage what the pipeline recorded (Layout.stage_roots) with a zero
    gradient (nothing, where it recorded none); both differentiate the
    pipeline's token too, so that no rank's autograd prunes a tick that
    another rank's waits on; and a leaf that takes none gets zeros."""
    layout = active()
    if layout is None or layout.stage == 1:
        return list(torch.autograd.grad(loss, wrt, allow_unused=True))
    last = layout.stage_rank == layout.stage - 1
    roots = [loss] if last else [r for r in layout.stage_roots if r.requires_grad]
    got = [None] * len(wrt)
    if roots and wrt:
        token = [] if layout.stage_token is None else [layout.stage_token]
        got = torch.autograd.grad(roots, wrt + token,
                                  None if last else [torch.zeros_like(r) for r in roots],
                                  allow_unused=True)
    # a leaf may take a gradient on one stage and none on another: every
    # stage sums each one (reduce_grads)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, got)]


def reduce_grads(params: list, grads: list) -> None:
    """Sum each gradient, in place, over the other ranks that hold the same
    piece of its parameter (Layout.grad_group): a sharded leaf's, already
    reduce-scattered over the ranks that split it, over replica x data (and
    sequence, for a fsdp leaf in a step with the split); any other over the
    ranks that split the step's work; and a range several tensor ranks hold
    over those ranks. On a stage mesh a leaf every stage holds whole sums
    over the stage ranks besides (step_grads). Call it after the step's
    forward: the split is the step's. Parameters outside a layout, and None
    gradients, are left alone."""
    for p, g in zip(params, grads):
        info = info_of(p)
        if info is None or g is None:
            continue
        group = info.layout.grad_group(info)
        if group is not None:
            t = g if g.is_contiguous() else g.contiguous()
            dist.all_reduce(t, group=group)
            if t is not g:
                g.copy_(t)
        if info.tensor is not None:
            info.tensor.sum_shared(g)


# --- whole trees for checkpoints ----------------------------------------------

def full_tree(tree, to_cpu: bool = False):
    """The tree with every sharded tensor gathered whole (no gradient), for
    a checkpoint: every rank must call it, leaf by leaf in the same order.
    `to_cpu` moves each gathered leaf to the host at once, so that no more
    than one whole leaf lies on the device."""
    def leaf(t):
        info = sharded(t)
        if info is None:
            return t
        with torch.no_grad():
            full = info.whole(t.detach())
        return full.cpu() if to_cpu else full

    return _map(tree, leaf)


def load_shards(local, full):
    """Copy a whole tree (a checkpoint) into the local tree of the same
    structure, each sharded tensor taking its own slice; leaves that are not
    tensors (step counts) come from `full`. Returns the local tree."""
    def leaf(t, f):
        if not isinstance(t, torch.Tensor):
            return f
        info = sharded(t)
        if info is not None:
            f = info.local_of(f)
        with torch.no_grad():
            t.copy_(f)
        return t

    return _map(local, leaf, full)


def _map(tree, fn, *rest):
    if isinstance(tree, dict):
        return {k: _map(v, fn, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
