"""Optimizers: AdamW and Adafactor with the HF-style warmup schedules,
global-norm clipping, gradient accumulation and component freezing, as
plain tensor code (port of starvector_tpu/train/optim.py, which builds the
same from optax).

The JAX chain is
    [MultiSteps(k)]( [multi_transform(train | freeze)](
        clip_by_global_norm(c) -> core))
with core = adamw(schedule, b1, b2, eps, weight_decay, mu_dtype) or
adafactor(schedule). `Chain` holds the parts that both cores share, as optax
applies them:
  * with k > 1 the k micro-step gradients are averaged (Welford, as optax),
    the update is applied on every k-th call only, and the count advances
    once per k;
  * with frozen components the clip's global norm covers only the trainable
    leaves, and frozen leaves get no update and no state;
  * the schedule is read at the update count *before* it increments, so the
    first update has lr = schedule(0) (0 under warmup).
`AdamW` then follows optax.adamw: bias-corrected moments, eps outside the
square root, decoupled weight decay times the scheduled lr on every
trainable leaf; `mu_dtype` stores the first moment in that type, the update
itself taken from the fp32 moment before it is rounded, as optax does.
`Adafactor` follows optax.adafactor(schedule) at optax 0.2.6's defaults
(alias.py, factorized.py): scale_by_factored_rms (a leaf whose two largest
dims are both >= 128 keeps a row and a column mean of g^2 + 1e-30 over
those dims, any other a full second moment; decay 1 - (t + 1)^-0.8),
clip_by_block_rms(1), the scheduled lr, scale_by_param_block_rms (floor
1e-3), and the sign; no momentum and no weight decay.

Parameters and optimizer state are updated in place: at 1B every copy of
the fp32 parameters is 5 GB, at 8B 30 GB. Gradients may come in a narrower
type than their parameters (make_train_step's grad_dtype): each is widened
inside the update, leaf by leaf, so no fp32 copy of the gradient tree is
made. Adafactor, the 8B recipe's optimizer, goes further and widens a
stacked leaf a layer at a time (two passes: its clip needs the whole
leaf's sum of squares), so no fp32 temporary the size of the largest leaf
(the 8B's c_fc, 10.9 GB) is made either; AdamW's elementwise update takes
each leaf whole, fp32 temporaries of its size included. Accumulation
(k > 1) needs optax's acc_grads, an fp32 tree the size of the parameters
(30 GB at 8B), as state: each micro-step's gradient is added into it a
layer at a time, and on the k-th the core reads that buffer itself before
it is zeroed, so there is no second copy; but the buffer alone puts the
8B recipe (~56 GiB of state at k = 1) past one 80 GB card.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


def tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists (the convolutional towers' levels),
    in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
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


def _pieces(t: torch.Tensor) -> list[torch.Tensor]:
    """A tensor as the views an elementwise pass walks (and may write in
    place): the layers of a stacked (L, ...) leaf, else the tensor itself."""
    return [t[i] for i in range(t.shape[0])] if t.dim() >= 3 else [t]


def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    """sum(t^2) in fp32, a layer at a time."""
    return sum((x.float().square().sum() for x in _pieces(t)), torch.zeros((), device=t.device))


def global_norm(leaves: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square, in fp32."""
    return torch.stack([_sq_sum(g) for g in leaves]).sum().sqrt()


class Chain:
    """MultiSteps accumulation, the freeze mask and the global-norm clip
    around a core, as the JAX chain applies them. `init(params)` makes the
    state; `update(grads, state, params)` updates params and state in place.
    A core subclass defines `_init_leaf(p)`, a trainable leaf's state
    ({key: tensor or None}), and `_update(trained, state, clip, count)`,
    which applies it to [(param, grad, {key: the leaf's state})], each grad
    first divided by clip[0] and multiplied by clip[1], at update `count`."""

    def __init__(self, schedule: Schedule, *, grad_clip: float, grad_accum_steps: int = 1,
                 mask: dict | None = None):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.k = max(int(grad_accum_steps), 1)
        self.mask = mask

    def _trainable(self, params: dict) -> list[bool]:
        if self.mask is None:
            return [True] * len(tree_leaves(params))
        return [bool(m) for m in tree_leaves(self.mask)]

    def init(self, params: dict) -> dict:
        per_leaf = [self._init_leaf(p) if t else None
                    for p, t in zip(tree_leaves(params), self._trainable(params))]
        keys = next((list(s) for s in per_leaf if s is not None), [])
        state = {"count": 0, **{k: [None if s is None else s[k] for s in per_leaf]
                                for k in keys}}
        if self.k > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in tree_leaves(params)]
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        gs = tree_leaves(grads)
        if self.k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], gs):  # optax's acc + (g - acc) / (n + 1)
                for a, x in zip(_pieces(acc), _pieces(g)):
                    a.add_((x - a) / (n + 1))
            state["mini_step"] = (n + 1) % self.k
            if n != self.k - 1:
                return
            gs = state["acc"]  # read by the core below, zeroed after it
        keys = [k for k in state if k not in ("count", "mini_step", "acc")]
        trained = [(p, g, {k: state[k][i] for k in keys})
                   for i, (p, g, t) in enumerate(zip(tree_leaves(params), gs,
                                                     self._trainable(params))) if t]
        if trained:
            norm = global_norm([g for _, g, _ in trained])
            under = norm < self.grad_clip
            one = torch.ones_like(norm)
            # optax's g / norm * clip past the clip (g unchanged under it)
            clip = (torch.where(under, one, norm), torch.where(under, one, one * self.grad_clip))
            self._update(trained, state, clip, state["count"])
        state["count"] += 1
        if self.k > 1:
            for acc in state["acc"]:
                acc.zero_()


class AdamW(Chain):
    """The chain around optax.adamw (module docstring)."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float, eps: float,
                 weight_decay: float, mu_dtype: torch.dtype | None = None, **chain):
        super().__init__(schedule, **chain)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def _init_leaf(self, p: torch.Tensor) -> dict:
        return {"mu": torch.zeros_like(p, dtype=self.mu_dtype or p.dtype),
                "nu": torch.zeros_like(p)}

    def _update(self, trained, state, clip, count) -> None:
        c1, c2 = 1 - self.b1**(count + 1), 1 - self.b2**(count + 1)
        lr = self.schedule(count)
        for p, g, s in trained:
            mu, nu = s["mu"], s["nu"]
            g = g.to(p.dtype) / clip[0] * clip[1]
            if mu.dtype == p.dtype:
                mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
                m = mu
            else:  # optax's (1 - b1) g + b1 mu with b1 in mu's type (a weak-typed
                # constant): b1 mu is exact in fp32 and XLA fuses the sum into
                # one rounding (an fma), which float64 reproduces; stored rounded
                b1 = float(torch.tensor(self.b1, dtype=mu.dtype))
                m = (g.double() * float(np.float32(1 - self.b1))
                     + mu.double() * b1).to(p.dtype)
                mu.copy_(m)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (m / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.sub_(lr * (u + self.weight_decay * p))


class Adafactor(Chain):
    """The chain around optax.adafactor(schedule) (module docstring)."""

    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    EPS = 1e-30
    CLIPPING_THRESHOLD = 1.0
    MIN_PARAM_SCALE = 1e-3

    @classmethod
    def factored_dims(cls, shape) -> tuple[int, int] | None:
        """(d1, d0): the second-largest and the largest dim (ties in order),
        when the second-largest is at least MIN_DIM_SIZE_TO_FACTOR; else None."""
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: shape[i])
        if shape[order[-2]] < cls.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return order[-2], order[-1]

    def _init_leaf(self, p: torch.Tensor) -> dict:
        dims = self.factored_dims(p.shape)
        if dims is None:
            return {"v_row": None, "v_col": None, "v": torch.zeros_like(p)}
        d1, d0 = dims
        shape = list(p.shape)
        return {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:]), "v": None}

    def _update(self, trained, state, clip, count) -> None:
        decay = float(1.0 - np.float32(count + 1) ** np.float32(-self.DECAY_RATE))
        lr = self.schedule(count)
        for p, g, s in trained:
            dims = self.factored_dims(p.shape)
            # a stacked leaf goes a layer at a time when its layer axis is
            # not one it factors over: every statistic is then per layer
            by_layer = p.dim() >= 3 and (dims is None or 0 not in dims)
            shift = 1 if by_layer else 0
            views = [dict(p=p[i], g=g[i], **{k: None if v is None else v[i]
                                              for k, v in s.items()})
                     for i in range(p.shape[0])] if by_layer else [dict(p=p, g=g, **s)]

            def scaled(view, first: bool) -> torch.Tensor:
                """The view's update after the factored scaling; on the
                first pass also the new second-moment statistics."""
                gv = view["g"].to(p.dtype) / clip[0] * clip[1]
                sq = gv * gv + self.EPS if first else None
                if dims is None:
                    if first:
                        view["v"].mul_(decay).add_(sq, alpha=1 - decay)
                    return gv * view["v"] ** -0.5
                d1, d0 = dims[0] - shift, dims[1] - shift
                if first:
                    view["v_row"].mul_(decay).add_(sq.mean(dim=d0), alpha=1 - decay)
                    view["v_col"].mul_(decay).add_(sq.mean(dim=d1), alpha=1 - decay)
                vr, vc = view["v_row"], view["v_col"]
                row = (vr / vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)) ** -0.5
                return gv * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)

            # clip_by_block_rms over the whole leaf: a first pass for its
            # sum of squares, a second that recomputes and applies
            ss = sum(scaled(v, True).square().sum() for v in views)
            denom = torch.clamp(torch.sqrt(ss / p.numel()) / self.CLIPPING_THRESHOLD, min=1.0)
            rms = torch.linalg.vector_norm(p) / math.sqrt(p.numel())
            rms = torch.where(rms <= self.MIN_PARAM_SCALE,
                              torch.full_like(rms, self.MIN_PARAM_SCALE), rms)
            step = lr * rms / denom
            for v in views:
                v["p"].sub_(scaled(v, False) * step)


def build_optimizer(params: dict, *, optimizer: str = "adamw", lr: float = 1e-4,
                    weight_decay: float = 0.01, betas: tuple[float, float] = (0.9, 0.999),
                    eps: float = 1e-8, warmup_steps: int = 0, total_steps: int = 100_000,
                    lr_scheduler: str = "cosine", grad_clip: float = 1.0,
                    grad_accum_steps: int = 1, train_image_encoder: bool = True,
                    train_LLM: bool = True, train_connector: bool = True,
                    mu_dtype=None) -> Chain:
    """The JAX build_optimizer's keywords (train.py::optimizer_kwargs_from_config).
    Adafactor takes only the schedule from these, as optax.adafactor(schedule)
    does; `mu_dtype` is AdamW's."""
    mask = freeze_mask(params, train_image_encoder=train_image_encoder, train_LLM=train_LLM,
                       train_connector=train_connector)
    chain = dict(grad_clip=grad_clip, grad_accum_steps=grad_accum_steps,
                 mask=None if all(tree_leaves(mask)) else mask)
    schedule = build_schedule(lr_scheduler, lr, warmup_steps, total_steps)
    if optimizer == "adamw":
        return AdamW(schedule, b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay,
                     mu_dtype=mu_dtype, **chain)
    if optimizer == "adafactor":
        return Adafactor(schedule, **chain)
    raise ValueError(f"unknown optimizer {optimizer!r}")
