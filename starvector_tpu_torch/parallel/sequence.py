"""Sequence (context) parallelism of the training forward (port of
starvector_tpu/parallel/sequence.py).

On a mesh with sequence > 1 the ranks of a sequence group hold the same
rows. When the sequence's length S divides over them, the uncached decoder
forward splits the positions: rank s keeps positions [s c, (s + 1) c),
c = S / sequence, after the full sequence's positions are applied (the
1B's wpe rows, the 8B's RoPE angles), and runs every layer, ln_f and the
loss on that chunk (`split_sequence`). Activation memory and attention
work per rank fall by the sequence size.

Attention is all-gather-KV context parallelism, as in the JAX package: each
rank keeps its query chunk, all-gathers K and V over the sequence group
(the decoders are MQA / GQA-4, so a layer's K and V are small beside its
activations) and runs the training flash attention (kernel 4 forward, the
backward pair) with q_offset = s c against the full-length key mask, so
causal masking, the window and block skipping stay exact
(`sp_chunk_attention`). The gather's backward is a reduce-scatter: each
rank's dK and dV over the whole sequence are summed and each owner takes
its chunk. The gathered K and V are what the flash Function saves for its
backward, as JAX's residuals; under remat True the gather sits inside the
layer's checkpoint and runs again in the recompute.

In serving nothing is split: the JAX engine's arrays are not placed on
the mesh, so a serving mesh's sequence axis widens weight shards alone.
Where S does not divide (JAX's sanitize_for_mesh drops the axis), nothing
is split: each rank of the group computes the whole rows, and
sp_flash_attention is the plain trainable call. The split is decided per
step and recorded on the layout, whose reductions follow it
(parallel/zero.py).
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops.flash_attention import flash_prefill_trainable
from starvector_tpu_torch.parallel import zero


def sp_enabled(seq_len: int | None = None) -> bool:
    """True iff a training layout with a sequence axis above 1 is active
    (and, when given, the sequence's length divides over it). A serving
    layout's sequence ranks only split weight shards (ZeRO over sequence):
    no serving step's positions are split."""
    layout = zero.active()
    if layout is None or layout.sequence <= 1 or getattr(layout, "serving", False):
        return False
    return seq_len is None or seq_len % layout.sequence == 0


def chunk_span(seq_len: int) -> tuple[int, int] | None:
    """(first, end) of this rank's chunk of a training sequence's positions
    where the active layout splits it, else None."""
    if not sp_enabled(seq_len):
        return None
    layout = zero.active()
    c = seq_len // layout.sequence
    return layout.seq_rank * c, (layout.seq_rank + 1) * c


def split_sequence(seq_len: int) -> tuple[int, int] | None:
    """chunk_span, and where it splits, the active layout told that this
    step's positions are split (Layout.seq_split): the decoder calls it once
    a forward."""
    span = chunk_span(seq_len)
    if span is not None:
        zero.active().seq_split = True
    return span


class _GatherKV(torch.autograd.Function):
    """K and V (B, c, Hkv, D) all-gathered along S over the sequence group,
    in one collective; the backward reduce-scatters dK and dV (a sum)."""

    @staticmethod
    def forward(ctx, k, v, layout):
        ctx.layout = layout
        kv = layout.seq_all_gather(torch.stack([k, v]), 2)
        return kv[0], kv[1]

    @staticmethod
    def backward(ctx, dk, dv):
        dkv = ctx.layout.seq_reduce_scatter(torch.stack([dk, dv]), 2)
        return dkv[0], dkv[1], None


def sp_chunk_attention(q, k_full, v_full, kv_mask, seq_rank: int, *, causal: bool = True,
                       window: int | None = None, scale: float | None = None,
                       kernels: bool = True) -> torch.Tensor:
    """One sequence rank's attention: its query chunk q (B, c, H, D)
    against the gathered K and V (B, S, Hkv, D) and the full key mask
    (B, S), at q_offset = seq_rank * c. Differentiable: dK and dV come back
    over the whole sequence, for the gather's reduce-scatter to sum."""
    return flash_prefill_trainable(q, k_full, v_full, kv_mask, seq_rank * q.shape[1],
                                   causal=causal, window=window, scale=scale, kernels=kernels)


def sp_flash_attention(q, k, v, kv_mask, *, causal: bool = True, window: int | None = None,
                       scale: float | None = None, kernels: bool = True) -> torch.Tensor:
    """The training attention, sequence-parallel where the forward split
    the positions: q, k and v (B, c, ., D) are the rank's chunk, kv_mask
    (B, S) is full-length. Otherwise (no active layout, sequence 1, or an S
    that does not divide) exactly flash_prefill_trainable(q, k, v,
    kv_mask)."""
    span = chunk_span(kv_mask.shape[1])
    if span is None:
        return flash_prefill_trainable(q, k, v, kv_mask, causal=causal, window=window,
                                       scale=scale, kernels=kernels)
    if q.shape[1] != span[1] - span[0]:
        raise ValueError(f"sp_flash_attention: a query chunk of {q.shape[1]} positions, "
                         f"the split gives {span[1] - span[0]}")
    layout = zero.active()
    k_full, v_full = _GatherKV.apply(k, v, layout)
    return sp_chunk_attention(q, k_full, v_full, kv_mask, layout.seq_rank, causal=causal,
                              window=window, scale=scale, kernels=kernels)
