"""The train and eval steps (port of starvector_tpu/train/step.py).

One step is loss -> backward -> clip and update -> the BatchNorm adapter's
new running statistics merged into params["image_projection"]["norm"]
after the update, as the JAX step merges them. Clipping, accumulation and
freezing live in the optimizer (train/optim.py). Parameters and optimizer
state are updated in place; the step returns them for the JAX signature.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy
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
    returned grad_norm is over all gradients, frozen ones included.

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
    optax's fp32 accumulator, another 30 GB at 8B, which does not fit."""

    def train_step(params: dict, opt_state: dict, batch: dict,
                   gen: torch.Generator | None = None):
        if grad_dtype is None:
            wrt_tree = params
        else:
            wrt_tree = tree_map(
                lambda p: p.detach().to(grad_dtype).requires_grad_(p.requires_grad)
                if p.is_floating_point() else p, params)
        wrt = [p for p in tree_leaves(wrt_tree) if p.requires_grad]
        loss, aux = sv.loss_fn_with_bn_stats(wrt_tree, cfg, batch, pad_token_id, policy=policy,
                                             dropout_gen=gen, remat=remat, kernels=kernels)
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        del wrt, wrt_tree

        def grad_of(p):
            g = next(got) if p.requires_grad else None
            return torch.zeros_like(p, dtype=grad_dtype or p.dtype) if g is None else g

        grads = tree_map(grad_of, params)
        with torch.no_grad():
            grad_norm = global_norm(tree_leaves(grads))
            opt.update(grads, opt_state, params)
            norm = params.get("image_projection", {}).get("norm", {})
            for key, value in aux.get("bn_stats", {}).items():
                norm[key].copy_(value)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def make_eval_step(cfg: sv.StarVectorConfig, pad_token_id: int, *,
                   policy: DTypePolicy = DTypePolicy(), kernels: bool = True):
    """eval_step(params, batch) -> loss, with the adapter's running
    statistics and no dropout."""

    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        return sv.loss_fn(params, cfg, batch, pad_token_id, policy=policy, kernels=kernels)

    return eval_step
