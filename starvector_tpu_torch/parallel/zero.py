"""Data parallelism and ZeRO-3 at run time: the collectives that XLA
inserts into the JAX package's GSPMD step, put in by hand.

One process a device. Every parameter leaf is a plain local tensor, this
rank's shard (parallel/sharding.py::shard_pytree), and the registry here
records which of its dimensions is split over the `fsdp` axis (`Shard`).
The kernels and the model code see only plain contiguous tensors:

  * gather at use: `gathered(tree)` all-gathers each sharded leaf just
    before the model reads it (a decoder or ViT layer at a time, the small
    modules whole), through `_Gather`, whose backward reduce-scatters the
    gradient back to the shard. Nothing keeps the gathered weights for the
    backward: inside an activation checkpoint the gather is part of what
    the backward recomputes, and elsewhere `Layout.step()`'s saved-tensor
    hooks store the shard in its place and gather again when the backward
    reads it, as FSDP does;
  * gradients: a sharded leaf's shard is summed over the ranks that hold
    the same shard (`replica` x `data`); every other leaf over all batch
    ranks (`reduce_grads`);
  * the rank-local reductions of the step that must span the global batch:
    the loss's count of targets (`batch_sum`), the BatchNorm adapter's
    statistics (`batch_sum_grad`, summed in the forward and the backward),
    the rows of the dropout mask (`global_rows`), and the optimizer's
    reductions over a sharded leaf (train/optim.py through `fsdp_sum`).

With no `Layout` active (`Layout.step()`), every function here returns
its input: the one-device path is the code it was.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from starvector_tpu_torch.parallel.mesh import AXIS_FSDP, BATCH_AXES, axis_sizes, \
    require_batch_axes

# the collectives' newer names, where this torch has them
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class Layout:
    """This rank's place on a DeviceMesh of the batch axes, and its groups:
    `fsdp_group` (the ranks that split each sharded leaf), `shard_group`
    (the ranks that hold the same shard: replica x data; None when there is
    one) and the world, which is the batch group since every other axis is
    1."""

    def __init__(self, mesh):
        require_batch_axes(mesh, "the training mesh")
        sizes = axis_sizes(mesh)
        self.mesh = mesh
        self.fsdp = sizes[AXIS_FSDP]
        self.batch = math.prod(sizes[a] for a in BATCH_AXES)
        self.fsdp_group = mesh.get_group(AXIS_FSDP)
        self.fsdp_rank = mesh.get_local_rank(AXIS_FSDP)
        # ranks are row-major over (replica, data, fsdp): the fsdp coordinate
        # is rank % fsdp and the row block of the batch is the rank itself
        self.batch_rank = dist.get_rank()
        self.shard_group = None
        if self.batch > self.fsdp:
            self.shard_group, _ = dist.new_subgroups_by_enumeration(
                [list(range(f, self.batch, self.fsdp)) for f in range(self.fsdp)])

    # --- collectives ---------------------------------------------------------
    def all_gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from each fsdp rank's shard, split along `dim`."""
        shard = shard.contiguous()
        out = shard.new_empty((self.fsdp * shard.shape[0], *shard.shape[1:]))
        _all_gather(out, shard, group=self.fsdp_group)
        if dim == 0:
            return out
        return out.view(self.fsdp, *shard.shape).movedim(0, dim).flatten(dim, dim + 1)

    def reduce_scatter(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of the sum of `full` over the fsdp ranks."""
        parts = full.chunk(self.fsdp, dim)
        out = parts[0].new_empty(parts[0].shape)
        _reduce_scatter(out, torch.cat(parts) if dim else full.contiguous(),
                        group=self.fsdp_group)
        return out

    def fsdp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the fsdp ranks (a new tensor, no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.fsdp_group)
        return t

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the batch ranks (a new tensor, no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    @contextlib.contextmanager
    def step(self):
        """Within: the model's gathers, reductions and dropout follow this
        layout, and a gathered weight that autograd saves is kept as its
        shard and gathered again in the backward."""
        _ACTIVE.append(self)
        try:
            with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
                yield self
        finally:
            _ACTIVE.pop()


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """Where a local tensor lies: its layout, the dimension split over fsdp
    (None: the whole leaf on every rank) and the whole leaf's shape."""
    layout: Layout
    dim: int | None
    full_shape: tuple[int, ...]


_INFO = WeakIdKeyDictionary()      # local tensor -> Shard
_GATHERED = WeakIdKeyDictionary()  # gathered tensor -> (its shard, Shard, dtype)
_ACTIVE: list[Layout] = []


def active() -> Layout | None:
    return _ACTIVE[-1] if _ACTIVE else None


def register(t: torch.Tensor, info: Shard | None) -> torch.Tensor:
    if info is not None:
        _INFO[t] = info
    return t


def info_of(t) -> Shard | None:
    return _INFO.get(t) if isinstance(t, torch.Tensor) else None


def sharded(t) -> Shard | None:
    """t's Shard when a dimension of it is split over ranks, else None."""
    info = info_of(t)
    return info if info is not None and info.dim is not None else None


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
    info = info_of(like)
    if info is None:
        return t
    if dropped is None:
        return register(t, info)
    dim = info.dim
    if dim is not None:
        dim = None if dim == dropped else dim - (dim > dropped)
    shape = info.full_shape[:dropped] + info.full_shape[dropped + 1:]
    return register(t, Shard(info.layout, dim, shape))


def note_views(stacked: torch.Tensor, views) -> None:
    """Register the layers of a stacked leaf (layer_unbind): each lies as
    the stack with its leading layer axis, which is never split, removed."""
    info = info_of(stacked)
    if info is None:
        return
    if info.dim == 0:
        raise ValueError("a stacked leaf's layer axis is split over fsdp")
    sub = Shard(info.layout, None if info.dim is None else info.dim - 1, info.full_shape[1:])
    for v in views:
        _INFO[v] = sub


# --- gather at use ----------------------------------------------------------

class _Gather(torch.autograd.Function):
    """all-gather over fsdp in the forward (then the cast to `dtype`), the
    gradient reduce-scattered back to the shard in the backward."""

    @staticmethod
    def forward(ctx, shard, info: Shard, dtype):
        ctx.info, ctx.shard_dtype = info, shard.dtype
        full = info.layout.all_gather(shard, info.dim)
        return full if dtype is None else full.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.info.layout.reduce_scatter(g.to(ctx.shard_dtype), ctx.info.dim), None, None


def gather(t: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole leaf of a sharded local tensor (differentiable), else t."""
    info = sharded(t)
    if info is None:
        return t
    full = _Gather.apply(t, info, None if dtype == t.dtype else dtype)
    _GATHERED[full] = (t.detach(), info, full.dtype)
    return full


def gathered(tree, policy=None):
    """The tree with every sharded leaf gathered (without an active layout,
    the tree itself). With a policy, dense kernels (leaves named
    "kernel") come in its compute dtype, the cast the model makes anyway, so
    that the tensor a product saves for its backward is the gathered one."""
    if not _ACTIVE:
        return tree
    dtype = None if policy is None else policy.compute_dtype

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return gather(node, dtype if key == "kernel" else None)

    return walk(tree)


class _Regather:
    """What a saved gathered weight is kept as until the backward reads it."""

    def __init__(self, shard, info: Shard, dtype):
        self.shard, self.info, self.dtype = shard, info, dtype

    def __call__(self) -> torch.Tensor:
        with torch.no_grad():
            return self.info.layout.all_gather(self.shard, self.info.dim).to(self.dtype)


def _pack(t):
    rec = _GATHERED.get(t)
    return t if rec is None else _Regather(*rec)


def _unpack(x):
    return x() if isinstance(x, _Regather) else x


# --- batch reductions -------------------------------------------------------

def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the batch ranks of a detached value (a count); t itself
    without an active layout."""
    layout = active()
    return t if layout is None else layout.batch_sum(t)


class _BatchSum(torch.autograd.Function):
    """Sum over the batch ranks; the gradient of each rank's addend is the
    sum of every rank's gradient of the result."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def batch_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the batch ranks (requires an active layout)."""
    return _BatchSum.apply(t)


def global_rows(n: int) -> tuple[int, int] | None:
    """(first row, rows of the global batch) of this rank's block of n rows,
    or None without an active layout."""
    layout = active()
    return None if layout is None else (layout.batch_rank * n, layout.batch * n)


def reduce_grads(params: list, grads: list) -> None:
    """Sum each gradient, in place, over the ranks that hold the same piece
    of its parameter: a sharded leaf's (already reduce-scattered over fsdp)
    over replica x data, any other over every batch rank. Parameters
    outside a layout, and None gradients, are left alone."""
    for p, g in zip(params, grads):
        info = info_of(p)
        if info is None or g is None:
            continue
        group = info.layout.shard_group if info.dim is not None else dist.group.WORLD
        if group is None:
            continue
        t = g if g.is_contiguous() else g.contiguous()
        dist.all_reduce(t, group=group)
        if t is not g:
            g.copy_(t)


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
            full = info.layout.all_gather(t.detach(), info.dim)
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
            n = t.shape[info.dim]
            f = f.narrow(info.dim, info.layout.fsdp_rank * n, n)
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
