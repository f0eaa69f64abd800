"""Partition rules: parameter-tree paths -> PartitionSpecs (port of
starvector_tpu/parallel/sharding.py).

Each model module exports `partition_rules()`, an ordered list of
(path regex, P) pairs, first match wins, matched against the "/"-joined
path of a leaf in the parameter tree (dict keys and list indices), the same
lists over the same paths as the JAX package's. The spec functions are pure
functions of (path, shape, mesh shape), where a mesh is a DeviceMesh over
MESH_AXES or a mapping {axis: size}.

Conventions of the rules (the JAX package's):
  * 2-D weights shard (fsdp, tensor) or (tensor, fsdp), column- or
    row-parallel; a stacked leaf's leading layer axis is "stage" or None;
  * embedding tables shard their vocabulary over fsdp only;
  * biases and norms replicate, or shard over tensor with their weight.

The port keeps each rank's shard as a plain local tensor and records the
spec's split beside it (parallel/zero.py): `shard_pytree`. On a mesh with
sequence > 1 a weight entry widened to ("fsdp", "sequence") splits over
fsdp x sequence, rank f * sequence + s holding part f * sequence + s, as
JAX's devices do. On a mesh with stage > 1 a stacked leaf whose rule
leads with "stage" (the decoders' layers) is first cut into contiguous
blocks of L / stage layers, stage s holding block s; where stage does not
divide L the sanitizer drops the entry and every stage holds the stack
whole, as JAX's does. On a mesh with tensor > 1 a leaf whose rule names
`tensor` is then cut to the tensor rank's ranges along that dimension
(whole heads, the model's `tensor_units`, parallel/tensor.py), and its fsdp
split then cuts that slice along the spec's fsdp dimension.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Iterable

import torch

from starvector_tpu_torch.parallel import tensor, zero
from starvector_tpu_torch.parallel.mesh import (
    AXIS_FSDP, AXIS_SEQUENCE, AXIS_STAGE, AXIS_TENSOR, P, axis_sizes,
)

Rules = Iterable[tuple[str, P]]


def spec_for_path(path_s: str, rules: Rules, default: P = P()) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path_s):
            return spec
    return default


def _shrink_spec_to_shape(spec, ndim: int) -> P:
    """Drop trailing entries beyond the array's rank (one rule covers a
    weight and its bias)."""
    return P(*tuple(spec)[:ndim])


def _divisible(dim: int, axes, sizes: dict[str, int]) -> bool:
    if axes is None:
        return True
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return dim % math.prod(sizes[n] for n in names) == 0


def sanitize_spec(spec, shape: tuple[int, ...], mesh) -> P:
    """Entries whose axes do not divide their dimension become None (tiny
    heads and dims stay replicated)."""
    sizes = axis_sizes(mesh)
    entries = list(_shrink_spec_to_shape(spec, len(shape)))
    entries += [None] * (len(shape) - len(entries))
    return P(*(a if _divisible(d, a, sizes) else None for d, a in zip(shape, entries)))


# embedding tables keep single-axis sharding and are not widened
_TABLE_RE = r"wte$|wpe$|embed_tokens$|lm_head$"


def widen_fsdp_over_sequence(spec, path_s: str, shape: tuple[int, ...], mesh) -> P:
    """ZeRO over the `sequence` axis: on a mesh with sequence > 1 each plain
    "fsdp" weight entry whose dimension divides fsdp x sequence becomes
    ("fsdp", "sequence"), so that the gradient's combine over sequence is a
    reduce-scatter; tables are left alone. A no-op without a sequence axis."""
    sizes = axis_sizes(mesh)
    if sizes[AXIS_SEQUENCE] == 1 or re.search(_TABLE_RE, path_s):
        return P(*spec)
    combined = sizes[AXIS_FSDP] * sizes[AXIS_SEQUENCE]
    entries = list(_shrink_spec_to_shape(spec, len(shape)))
    entries += [None] * (len(shape) - len(entries))
    return P(*((AXIS_FSDP, AXIS_SEQUENCE) if a == AXIS_FSDP and dim % combined == 0 else a
               for dim, a in zip(shape, entries)))


def _paths(tree, prefix: str = ""):
    """(path, leaf) of every leaf, "/"-joined dict keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def apply_partition_rules(params: Any, rules: Rules, mesh) -> Any:
    """A tree of P matching `params`' structure."""
    rules = list(rules)

    def leaf_spec(path_s, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        s = spec_for_path(path_s, rules)
        s = widen_fsdp_over_sequence(s, path_s, shape, mesh)
        return sanitize_spec(s, shape, mesh)

    return _rebuild(params, iter([leaf_spec(p, leaf) for p, leaf in _paths(params)]))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec on a mesh, the one dimension it splits over fsdp
    ranks (None: none), whether that split is fsdp x sequence (`wide`)
    rather than fsdp, and whether its leading layer axis is cut over the
    stage ranks (`stage`)."""
    spec: P
    dim: int | None
    wide: bool = False
    stage: bool = False


def _sharding(spec: P, sizes: dict[str, int]) -> Sharding:
    """The spec's fsdp split: fsdp, or fsdp x sequence (each rule names
    fsdp once), and its stage split. Its `tensor` entry is the leaf's tensor
    split (shard_pytree)."""
    stage = bool(spec) and spec[0] == AXIS_STAGE and sizes[AXIS_STAGE] > 1
    split = [(i, names) for i, a in enumerate(spec) if a is not None
             for names in [tuple(n for n in ((a,) if isinstance(a, str) else a)
                                 if n not in (AXIS_TENSOR, AXIS_STAGE))]
             if math.prod(sizes[n] for n in names) > 1]
    if not split:
        return Sharding(spec, None, stage=stage)
    dim, names = split[0]
    return Sharding(spec, dim, AXIS_SEQUENCE in names, stage)


def make_param_shardings(params: Any, rules: Rules, mesh) -> Any:
    """A tree of Sharding matching `params`: each leaf's spec and the
    dimension it splits."""
    sizes = axis_sizes(mesh)
    specs = apply_partition_rules(params, rules, mesh)
    return zero._map(specs, lambda s: _sharding(s, sizes))


def shard_infos(params: Any, rules: Rules, layout: "zero.Layout",
                units: list | None = None) -> dict:
    """{path: zero.Shard} of every leaf of a whole tree on `layout`: the
    spec's fsdp (or fsdp x sequence) split and stage split, and on a mesh
    with tensor above 1 the leaf's tensor ranges (`units`, as
    shard_pytree takes them). The leaves' shapes are all it reads (a tree
    on the meta device will do)."""
    slices = {}
    if layout.tensor > 1:
        if units is None:
            raise ValueError("a mesh with tensor > 1 needs the model's tensor_units")
        slices = tensor.tensor_slices(params, rules, units, layout.tensor_group,
                                      layout.holder_groups)
    shardings = dict(_paths(make_param_shardings(params, rules, layout.mesh)))
    out = {}
    for path, leaf in _paths(params):
        sh, ts = shardings[path], slices.get(path)
        if ts is not None and ts.dim == sh.dim:
            raise ValueError(f"{path}: split over fsdp and tensor along one dimension")
        out[path] = zero.Shard(layout, sh.dim, tuple(leaf.shape), sh.wide, ts, sh.stage)
    return out


def register_local(path: str, local: torch.Tensor, info: "zero.Shard") -> torch.Tensor:
    """Register a leaf that holds this rank's piece as `info` places it,
    and a row-parallel kernel (or its codes) with the tensor group."""
    ts = info.tensor
    if ts is not None and tensor.is_row_parallel(path, ts.dim, len(info.full_shape)):
        tensor.register_row(local, info.layout.tensor_group)
    return zero.register(local, info)


def shard_pytree(params: Any, rules: Rules, mesh, units: list | None = None) -> Any:
    """This rank's shard of every leaf: a contiguous copy of its slice along
    the dimensions its spec splits (the leaf itself when it splits none),
    registered with the layout so that the model gathers it at use. `mesh`
    is a DeviceMesh or a zero.Layout over one. On a mesh with stage above
    1 a stacked leaf whose rule leads with "stage" (the decoders' layers)
    keeps this stage's contiguous block of layers (parallel/pipeline.py
    runs them in training; a serving layout fetches each from its stage at
    use), cut before the tensor and fsdp splits. On a mesh with tensor
    above 1, `units` gives each tensor rank's ranges of the split
    projections by the tree's top-level key (models/starvector.py::
    tensor_units); row-parallel kernels are registered with the tensor
    group (parallel/tensor.py), and a quantized kernel's scales follow its
    codes' columns."""
    layout = mesh if isinstance(mesh, zero.Layout) else zero.Layout(mesh)
    infos = iter(shard_infos(params, rules, layout, units).items())

    def shard(leaf):
        path, info = next(infos)
        if info.dim is None and info.tensor is None and not info.stage:
            return zero.register(leaf, info)
        local = info.local_of(leaf.detach()).clone(memory_format=torch.contiguous_format)
        local.requires_grad_(leaf.requires_grad)
        return register_local(path, local, info)

    return zero._map(params, shard)


def quantize_shards(params: Any, min_elems: int = 1 << 16) -> Any:
    """ops/quantization.py::quantize_tree of a tree of this rank's shards
    (shard_pytree's, or a per-rank checkpoint load), equal bit for bit to
    this rank's shards of the whole tree's quantize_tree as shard_pytree
    places it. A kernel is quantized where the whole leaf reaches
    `min_elems`; each column's absolute maximum is taken over the ranks
    that split the kernel's rows (K), a MAX all-reduce over its fsdp (or
    widened) ranks or, for a row-parallel kernel, its tensor group, before
    it rounds. The codes keep the kernel's split and marks. The per-column
    scales come out whole, as no rule names them: a rank's columns of a
    kernel split over fsdp along them are all-gathered, and a stage's block
    of layers gathered over the stage ranks (a tensor rank keeps its own
    columns' scales, as parallel/tensor.py cuts them). Each quantized
    leaf's kernel leaves the input tree (quantize_tree's `consume`)."""
    import torch.distributed as dist

    from starvector_tpu_torch.ops.quantization import quantize_dense

    def rec(node):
        if not isinstance(node, dict):
            return node
        w = node.get("kernel")
        if not (isinstance(w, torch.Tensor) and w.ndim in (2, 3)):
            return {k: rec(v) for k, v in node.items()}
        if math.prod(zero.full_shape(w)) < min_elems:
            return node
        info, row = zero.info_of(w), tensor.row_group(w)
        rows = w.ndim - 2
        reduce = None
        if info is not None and info.dim == rows:
            group = info.layout.split(info.wide)[0]

            def reduce(t):
                if group is not None:
                    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
                return t
        elif info is not None and info.tensor is not None and info.tensor.dim == rows:
            reduce = info.tensor.group.all_reduce_max
        out = quantize_dense(node, reduce=reduce)
        del node["kernel"], w
        if info is not None:
            zero.register(out["kernel_q"], info)
            scale = out["scale"]
            if info.dim == rows + 1:
                scale = info.layout.all_gather(scale, scale.dim() - 1, info.wide)
            if info.stage:
                scale = zero._gather(scale, 0, info.layout.stage_group, info.layout.stage)
            out["scale"] = scale
        if row is not None:
            tensor.register_row(out["kernel_q"], row)
        return out

    return rec(params)
