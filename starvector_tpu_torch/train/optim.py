"""Optimizer: AdamW with the HF-style warmup schedules, global-norm clipping,
gradient accumulation and component freezing, as plain tensor code (port of
starvector_tpu/train/optim.py, which builds the same from optax).

The JAX chain is
    [MultiSteps(k)]( [multi_transform(train | freeze)](
        clip_by_global_norm(c) -> adamw(schedule, b1, b2, eps, weight_decay)))
and `AdamW.update` follows optax step for step:
  * the schedule is read at the update count *before* it increments, so the
    first update has lr = schedule(0) (0 under warmup);
  * Adam's moments are bias-corrected, and eps is added outside the square
    root of the corrected second moment;
  * weight decay is decoupled, times the scheduled lr, on every trainable
    leaf, biases and norms included;
  * with frozen components the clip's global norm covers only the trainable
    leaves, and frozen leaves get no update and no decay;
  * with k > 1 the k micro-step gradients are averaged (Welford, as optax),
    the update is applied on every k-th call only, and the count advances
    once per k.
Parameters and optimizer state are updated in place: at 1B every copy of
the fp32 parameters is 5 GB.

Adafactor and a narrower first moment (`mu_dtype`) are not ported (ROADMAP
queue 1, item 4).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def tree_leaves(tree) -> list:
    """Leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def cosine_schedule_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                                num_cycles: float = 0.5) -> Schedule:
    """HF get_cosine_schedule_with_warmup: linear warmup, then cosine from
    1 to 0 over the remaining steps."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return lr * max(0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress)), 0.0)

    return schedule


def build_schedule(lr_scheduler: str, lr: float, warmup_steps: int,
                   total_steps: int) -> Schedule:
    """`training.lr_scheduler` (HF get_scheduler names) -> schedule."""
    if lr_scheduler == "cosine":
        return cosine_schedule_with_warmup(lr, warmup_steps, total_steps)
    if lr_scheduler == "linear":
        def linear(step: int) -> float:
            if step < warmup_steps:
                return lr * min(step / max(warmup_steps, 1), 1.0)
            return lr * min(max((total_steps - step) / max(total_steps - warmup_steps, 1), 0.0),
                            1.0)

        return linear
    if lr_scheduler == "constant":
        def constant(step: int) -> float:
            return lr * min(step / max(warmup_steps, 1), 1.0) if warmup_steps else lr

        return constant
    raise ValueError(f"unknown lr_scheduler {lr_scheduler!r}")


def freeze_mask(params: dict, *, train_image_encoder: bool, train_LLM: bool,
                train_connector: bool) -> dict:
    """True = trainable, per top-level component."""
    flags = {"image_encoder": train_image_encoder, "svg_transformer": train_LLM,
             "image_projection": train_connector}
    return {k: tree_map(lambda _, f=flags.get(k, True): f, v) for k, v in params.items()}


class AdamW:
    """The JAX package's optax chain (module docstring) on a dict of
    tensors. `init(params)` makes the state; `update(grads, state, params)`
    updates params and state in place."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float, eps: float,
                 weight_decay: float, grad_clip: float, grad_accum_steps: int = 1,
                 mask: dict | None = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.k = max(int(grad_accum_steps), 1)
        self.mask = mask

    def _trainable(self, params: dict) -> list[bool]:
        if self.mask is None:
            return [True] * len(tree_leaves(params))
        return [bool(m) for m in tree_leaves(self.mask)]

    def init(self, params: dict) -> dict:
        live = self._trainable(params)
        zeros = [torch.zeros_like(p) if t else None for p, t in zip(tree_leaves(params), live)]
        state = {"count": 0, "mu": zeros,
                 "nu": [None if z is None else torch.zeros_like(z) for z in zeros]}
        if self.k > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in tree_leaves(params)]
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        gs = tree_leaves(grads)
        if self.k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], gs):
                acc.add_((g - acc) / (n + 1))
            state["mini_step"] = (n + 1) % self.k
            if n != self.k - 1:
                return
            gs = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
        live = self._trainable(params)
        ps = tree_leaves(params)
        trained = [(p, g, m, v) for p, g, m, v, t in zip(ps, gs, state["mu"], state["nu"], live)
                   if t]
        if not trained:
            state["count"] += 1
            return
        norm = torch.stack([(g.float() ** 2).sum() for _, g, _, _ in trained]).sum().sqrt()
        clip = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        count = state["count"] + 1
        c1, c2 = 1 - self.b1**count, 1 - self.b2**count
        lr = self.schedule(state["count"])
        for p, g, mu, nu in trained:
            g = g * clip
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.sub_(lr * (u + self.weight_decay * p))
        state["count"] = count


def build_optimizer(params: dict, *, optimizer: str = "adamw", lr: float = 1e-4,
                    weight_decay: float = 0.01, betas: tuple[float, float] = (0.9, 0.999),
                    eps: float = 1e-8, warmup_steps: int = 0, total_steps: int = 100_000,
                    lr_scheduler: str = "cosine", grad_clip: float = 1.0,
                    grad_accum_steps: int = 1, train_image_encoder: bool = True,
                    train_LLM: bool = True, train_connector: bool = True,
                    mu_dtype=None) -> AdamW:
    """The JAX build_optimizer's keywords (train.py::optimizer_kwargs_from_config)."""
    if optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet: ROADMAP queue 1, item 4")
    if mu_dtype is not None:
        raise NotImplementedError("mu_dtype is not ported yet: ROADMAP queue 1, item 4")
    mask = freeze_mask(params, train_image_encoder=train_image_encoder, train_LLM=train_LLM,
                       train_connector=train_connector)
    if all(tree_leaves(mask)):
        mask = None
    return AdamW(build_schedule(lr_scheduler, lr, warmup_steps, total_steps), b1=betas[0],
                 b2=betas[1], eps=eps, weight_decay=weight_decay, grad_clip=grad_clip,
                 grad_accum_steps=grad_accum_steps, mask=mask)
