"""Pipeline parallelism over the decoder's layers in training (port of
starvector_tpu/parallel/pipeline.py).

On a training mesh with `stage` P above 1 the decoders' stacked layers are
cut into P contiguous blocks of L / P (parallel/sharding.py::shard_pytree),
stage s holding layers [s L / P, (s + 1) L / P), and the ranks of a stage
group hold the same rows. The uncached decoder forward hands its layer loop
to `pipeline_layers`, which runs GPipe's schedule as the JAX package's
pp_layer_scan does inside its shard_map:

  * the rank's rows split into n_micro microbatches, min(2 P, rows)
    lowered until it divides the rows (JAX's default; no caller of JAX's
    sets another);
  * T = n_micro + P - 1 ticks: at tick t stage 0 takes in microbatch t,
    stage s runs its layers on microbatch t - s when 0 <= t - s < n_micro,
    and the tick ends with one rotation, stage i -> i + 1, of what each
    stage ran; the batch-aligned context arrays (the key mask, the 8B's
    RoPE tables) go with their microbatch;
  * the last stage's outputs of ticks P - 1 ... T - 1 are microbatches
    0 ... n_micro - 1 in order; it broadcasts them to its stage group.

JAX runs every stage on every tick (SPMD) and masks the inactive ticks'
garbage out. Here each rank is its own process and every collective inside
a stage's layers (fsdp gathers, tensor all-reduces) spans ranks of one
stage coordinate, so a rank skips its layers on an inactive tick, and the
rotation moves only what the next stage runs on its next tick (JAX's ring
also moves the inactive ticks' garbage, and the last stage's round to the
first). No number changes.

Autograd runs the schedule backward. A tick's rotation is one autograd
Function (`_Rotate`: isend and irecv in the forward, the reverse in the
backward; gloo and NCCL both run them), and a rank's ticks form one chain
(buffer -> layers -> rotation -> next buffer; stage 0's intake of a
microbatch keeps the chain, `_Intake`), so every rank issues its sends and
receives in the same order, forward and backward: the autograd engine
cannot reorder them. Each chain starts from the layout's token, a zero leaf
that parallel/zero.py::step_grads differentiates too, so that no rank's
autograd prunes a rotation that a peer waits on. The last stage
differentiates the loss; every other stage the end of its chain, with a
zero gradient (Layout.stage_roots): its layers' gradients arrive from the
next stage through the rotations, and the head's arise on the last stage
alone (zero.reduce_grads sums a leaf every stage holds whole over them).

JAX's fallbacks run the plain layer loop: a stage count that does not
divide L (the sanitizer leaves the layers whole on every stage), or fewer
than 2 microbatches (the 8B recipe's one row a device). Where the layers
are stage-split there, each layer is fetched from its stage at use, one at
a time and inside the layer's own activation checkpoint, as fsdp gathers
(zero.stand_in), and its gradient summed back to that stage; the stages
but the last differentiate the loop's output, so that each joins those
sums. JAX's third fallback, a batch that the batch axes do not divide, is
train.rank_rows' ValueError here: a rank's x is its own rows already.

JAX checkpoints the whole stage block under remat; here each layer keeps
its own checkpoint (the decoders' `_train_block`), with the same numbers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from starvector_tpu_torch.ops.layers import layer_unbind
from starvector_tpu_torch.parallel import zero


def micro_count(rows: int, stages: int) -> int:
    """The microbatches of `rows` rows: min(2 stages, rows), lowered until
    it divides the rows (JAX's rule)."""
    nm = min(2 * stages, rows)
    while nm > 1 and rows % nm:
        nm -= 1
    return nm


def pipeline_layers(layers: dict, x: torch.Tensor, arrays: dict, body) -> torch.Tensor:
    """x (B, S, E) through the stacked `layers` (this stage's block on a
    stage mesh), body(h, layer, arrays) a layer at a time, `arrays` the
    batch-aligned context ({name: (B, ...)}): GPipe over the active
    layout's stage ranks where they split the layers and the rows make at
    least 2 microbatches, else the plain loop (the module docstring).
    Returns the last layer's output for x's rows on every rank."""
    first = layers
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_local = first.shape[0]
    layout = zero.active()
    info = zero.info_of(first)
    split = layout is not None and layout.stage > 1 and info is not None and info.stage
    nm = micro_count(x.shape[0], layout.stage) if split else 1
    if nm >= 2:
        return _gpipe(layout, layer_unbind(layers, n_local), x, arrays, body, nm)
    local = layer_unbind(layers, n_local)
    if split:  # every layer of the stack, fetched from its stage at use
        local = [zero._map(local[i % n_local], lambda v, o=i // n_local: zero.stand_in(v, o))
                 for i in range(zero.full_shape(first)[0])]
    h = x
    for layer in local:
        h = body(h, layer, arrays)
    if split:
        _root(layout, h)
    return h


def _root(layout: zero.Layout, t: torch.Tensor) -> None:
    """Record t for a stage but the last to differentiate (zero.step_grads)."""
    if torch.is_grad_enabled() and t.requires_grad and layout.stage_rank < layout.stage - 1:
        layout.stage_roots.append(t)


def _token(layout: zero.Layout, like: torch.Tensor) -> torch.Tensor:
    """The step's token: a zero leaf that requires a gradient."""
    if layout.stage_token is None:
        layout.stage_token = torch.zeros((), dtype=like.dtype, device=like.device,
                                         requires_grad=True)
    return layout.stage_token


def _gpipe(layout: zero.Layout, local: list, x: torch.Tensor, arrays: dict, body,
           nm: int) -> torch.Tensor:
    s, P = layout.stage_rank, layout.stage
    xs = x.chunk(nm)
    ctx = [{k: a.chunk(nm)[m] for k, a in arrays.items()} for m in range(nm)]
    to = layout.stage_peer(s + 1) if s < P - 1 else None
    frm = layout.stage_peer(s - 1) if s > 0 else None
    chain = torch.zeros_like(xs[0]) + _token(layout, x)
    outs = []
    for t in range(nm + P - 1):
        buf = _Intake.apply(chain, xs[t]) if s == 0 and t < nm else chain
        m = t - s
        active = 0 <= m < nm
        y = buf
        if active:
            for layer in local:
                y = body(y, layer, ctx[m])
            if s == P - 1:
                outs.append(y)
        # the next stage runs on its next tick what this one ran on this
        send = to if active else None
        recv = frm if 0 <= t - (s - 1) < nm else None
        chain = _Rotate.apply(y, send, recv) if send is not None or recv is not None else y
    if s == P - 1:
        out = torch.cat(outs)
        dist.broadcast(out.detach(), src=layout.stage_peer(s), group=layout.stage_group)
        return out
    out = torch.empty_like(x)
    dist.broadcast(out, src=layout.stage_peer(P - 1), group=layout.stage_group)
    _root(layout, chain)
    return out


class _Intake(torch.autograd.Function):
    """Stage 0's intake of a microbatch: `fresh` in the forward, and the
    chain's buffer, which it drops, an input besides, so that the ticks
    stay one chain for autograd."""

    @staticmethod
    def forward(ctx, carried, fresh):
        return fresh.view_as(fresh)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), g


class _Rotate(torch.autograd.Function):
    """One tick's rotation on this rank: y sent to global rank `to`, the
    previous stage's buffer received from `frm` (zeros where none comes).
    The backward sends the received buffer's gradient back to `frm` and
    receives y's from `to`."""

    @staticmethod
    def forward(ctx, y, to, frm):
        ctx.to, ctx.frm = to, frm
        got = _exchange(y if to is not None else None, to, y if frm is not None else None, frm)
        return torch.zeros_like(y) if got is None else got

    @staticmethod
    def backward(ctx, g):
        gy = _exchange(g if ctx.frm is not None else None, ctx.frm,
                       g if ctx.to is not None else None, ctx.to)
        return torch.zeros_like(g) if gy is None else gy, None, None


def _exchange(send, to, like, frm):
    """isend `send` to global rank `to` and irecv a tensor like `like` from
    `frm` (each where given), both posted before either is waited on; the
    received tensor, or None. gloo moves host memory: over gloo a CUDA
    tensor goes through the host."""
    host = dist.get_backend() == "gloo"
    works, out = [], None
    if send is not None:
        buf = send.detach().contiguous()
        buf = buf.cpu() if host else buf
        works.append(dist.isend(buf, to))
    if like is not None:
        out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
        works.append(dist.irecv(out, frm))
    for w in works:
        w.wait()
    return None if out is None else out.to(like.device)
