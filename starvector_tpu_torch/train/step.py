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
from starvector_tpu_torch.train.optim import AdamW, tree_leaves, tree_map

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


def make_train_step(cfg: sv.StarVectorConfig, opt: AdamW, pad_token_id: int, *,
                    policy: DTypePolicy = DTypePolicy(), remat: bool | str = True,
                    grad_dtype=None, kernels: bool = True):
    """Returns train_step(params, opt_state, batch, gen) -> (params,
    opt_state, {"loss", "grad_norm"}), params marked by mark_trainable.
    `gen` is the adapter dropout's torch.Generator (None: no dropout); the
    returned grad_norm is over all gradients, frozen ones included."""
    if grad_dtype is not None:
        raise NotImplementedError("grad_dtype is not ported yet: ROADMAP queue 1, item 4")

    def train_step(params: dict, opt_state: dict, batch: dict,
                   gen: torch.Generator | None = None):
        leaves = tree_leaves(params)
        wrt = [p for p in leaves if p.requires_grad]
        loss, aux = sv.loss_fn_with_bn_stats(params, cfg, batch, pad_token_id, policy=policy,
                                             dropout_gen=gen, remat=remat, kernels=kernels)
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))

        def grad_of(p):
            g = next(got) if p.requires_grad else None
            return torch.zeros_like(p) if g is None else g

        grads = tree_map(grad_of, params)
        with torch.no_grad():
            grad_norm = torch.stack([(g.float() ** 2).sum()
                                     for g in tree_leaves(grads)]).sum().sqrt()
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
