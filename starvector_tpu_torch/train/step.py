"""The train and eval steps (port of starvector_tpu/train/step.py).

One step is loss -> backward -> clip and update -> the BatchNorm adapter's
new running statistics merged into params["image_projection"]["norm"]
after the update, as the JAX step merges them. Clipping, accumulation and
freezing live in the optimizer (train/optim.py). Parameters and optimizer
state are updated in place; the step returns them for the JAX signature.

On a ZeRO-3 layout (`shard_train_state`, parallel/) the step runs on this
rank's shards and its block of the batch's rows (on a sequence-parallel
mesh, its chunk of their positions where the length divides): the model
gathers each sharded leaf at use and reduce-scatters its gradient
(parallel/zero.py), the other gradients are summed over the ranks that
split the step, the loss's count of targets and the BatchNorm statistics
are the global batch's, and the optimizer's reductions span the shards,
so that N ranks take the step one process takes on the whole batch. The
returned loss is the global one. On a mesh with tensor above 1 the ranks of
a tensor group take the same rows and each its slices of the split leaves
(the model reads its rank's decoder config, sv.decoder_config). On a mesh
with stage above 1 the ranks of a stage group take the same rows, each
its block of the decoder's layers, and the decoder pipelines the rows
over them (parallel/pipeline.py); the last stage differentiates the loss
(zero.step_grads).
"""

from __future__ import annotations

import contextlib

import torch

from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.parallel import zero
from starvector_tpu_torch.train.optim import Chain, global_norm, tree_leaves, tree_map

BN_STATS = ("running_mean", "running_var")


def _is_state(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in BN_STATS


def _paths(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    return [prefix]


def mark_trainable(params: dict) -> dict:
    """Set requires_grad on every floating leaf but the BatchNorm running
    statistics (state, not parameters: the JAX step gives them zero
    gradients). Returns params."""
    for path, p in zip(_paths(params), tree_leaves(params)):
        p.requires_grad_(p.is_floating_point() and not _is_state(path))
    return params


def make_train_step(cfg: sv.StarVectorConfig, opt: Chain, pad_token_id: int, *,
                    policy: DTypePolicy = DTypePolicy(), remat: bool | str = True,
                    grad_dtype: torch.dtype | None = None, kernels: bool = True):
    """Returns train_step(params, opt_state, batch, gen) -> (params,
    opt_state, {"loss", "grad_norm"}), params marked by mark_trainable.
    `gen` is the adapter dropout's torch.Generator (None: no dropout); the
    returned grad_norm is over all gradients, frozen ones included (on a
    layout, where frozen leaves take none, over the trainable ones).

    grad_dtype (e.g. torch.bfloat16), as the JAX step's: the loss is
    differentiated with respect to a cast of every floating leaf to
    grad_dtype, made once a step from the fp32 masters after the previous
    update; the masters keep the optimizer's math. The forward is the same
    (the model casts every weight to the compute type at use); the backward
    accumulates each gradient in grad_dtype. The cast goes once the
    backward is done, and the optimizer widens each gradient to its
    master's type leaf by leaf inside its update (train/optim.py), a layer
    at a time for stacked leaves: no fp32 copy of the gradient tree is
    made. That is what fits the 8B's full-depth step on one 80 GB card:
    fp32 masters (30 GB), the cast (15 GB) and bf16 gradients (15 GB).
    Gradient accumulation (the optimizer's grad_accum_steps > 1) adds
    optax's fp32 accumulator, another 30 GB at 8B, which does not fit.

    On a layout, leaves the optimizer freezes take no gradient and so no
    collective (loss_and_grads)."""

    def train_step(params: dict, opt_state: dict, batch: dict,
                   gen: torch.Generator | None = None):
        loss, aux, grads = loss_and_grads(params, cfg, batch, pad_token_id, policy=policy,
                                          remat=remat, grad_dtype=grad_dtype, kernels=kernels,
                                          gen=gen, trainable=opt._trainable(params))
        with torch.no_grad():
            grad_norm = global_norm(tree_leaves(grads), tree_leaves(params))
            opt.update(grads, opt_state, params)
            norm = params.get("image_projection", {}).get("norm", {})
            for key, value in aux.get("bn_stats", {}).items():
                norm[key].copy_(value)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return train_step


def loss_and_grads(params: dict, cfg: sv.StarVectorConfig, batch: dict, pad_token_id: int, *,
                   policy: DTypePolicy = DTypePolicy(), remat: bool | str = True,
                   grad_dtype: torch.dtype | None = None, kernels: bool = True,
                   gen: torch.Generator | None = None, trainable: list | None = None):
    """The step's loss (detached; the global batch's on a layout), its aux
    (the BatchNorm statistics) and the gradient of every leaf of params, in
    a tree like it: zeros where a leaf takes none (not requires_grad, and on
    a layout not `trainable`, the optimizer's mask as a list of leaves). On a
    layout each gradient lies as its parameter does (registered so), summed
    over the ranks (parallel/zero.py::reduce_grads)."""
    layout = zero.layout_of(params)
    if grad_dtype is None:
        wrt_tree = params
    else:
        wrt_tree = tree_map(
            lambda p: zero.register_like(
                p.detach().to(grad_dtype).requires_grad_(p.requires_grad), p)
            if p.is_floating_point() else p, params)
    leaves = tree_leaves(params)
    takes = [p.requires_grad and (layout is None or trainable is None or t)
             for p, t in zip(leaves, trainable or [True] * len(leaves))]
    wrt = [p for p, t in zip(tree_leaves(wrt_tree), takes) if t]
    with layout.step() if layout is not None else contextlib.nullcontext():
        loss, aux = sv.loss_fn_with_bn_stats(wrt_tree, cfg, batch, pad_token_id, policy=policy,
                                             dropout_gen=gen, remat=remat, kernels=kernels)
        got = zero.step_grads(loss, wrt)
        loss = zero.batch_sum(loss.detach())
    zero.reduce_grads(wrt, got)
    got = iter(got)
    del wrt, wrt_tree

    def grad_of(p, t):
        g = next(got) if t else None
        g = torch.zeros_like(p, dtype=grad_dtype or p.dtype) if g is None else g
        return zero.register_like(g, p)

    grads = tree_map(grad_of, params, _tree_like(params, takes))
    return loss, aux, grads


def _tree_like(tree, leaves: list):
    """`leaves` in the structure of `tree`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_eval_step(cfg: sv.StarVectorConfig, pad_token_id: int, *,
                   policy: DTypePolicy = DTypePolicy(), kernels: bool = True):
    """eval_step(params, batch) -> loss, with the adapter's running
    statistics and no dropout."""

    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        layout = zero.layout_of(params)
        if layout is None:
            return sv.loss_fn(params, cfg, batch, pad_token_id, policy=policy, kernels=kernels)
        with layout.step():
            return zero.batch_sum(sv.loss_fn(params, cfg, batch, pad_token_id, policy=policy,
                                             kernels=kernels))

    return eval_step


def shard_train_state(params: dict, opt: Chain, mesh,
                      cfg: sv.StarVectorConfig) -> tuple[dict, dict]:
    """This rank's shards of params by the model's partition rules and,
    on a mesh with tensor above 1, `cfg`'s tensor_units (sv.shard_params)
    and a fresh optimizer state made on them: every moment lies beside its
    parameter's shard (ZeRO-3). `mesh`: a DeviceMesh of the batch axes,
    `sequence`, `stage` and `tensor`, or a parallel.zero.Layout over one."""
    params = sv.shard_params(params, cfg, mesh)
    return params, opt.init(params)


def opt_state_shardings(opt_state: dict) -> dict:
    """Where each leaf of an optimizer state lies: a parallel.zero.Shard
    (the split dimension, None for a whole leaf, and the whole leaf's
    shape) or None for a leaf outside any layout (step counts, frozen
    leaves' None)."""
    return zero._map(opt_state, zero.info_of)
