"""Plain attention: MQA/GQA, causal, fp32 softmax, cache-aware (port of
starvector_tpu/ops/attention.py).

This is the ViT's attention (the JAX package leaves it to XLA) and the
oracle that the flash-prefill kernel's plain version is built on: scores
scaled by head_dim**-0.5, softmax in fp32, masked positions filled with a
large finite negative before the softmax.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops.layers import einsum_f32

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_bias(
    pad_mask: torch.Tensor | None,  # (B, T_kv) 1 = attend
    q_len: int,
    kv_len: int,
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: int | None = None,
    device=None,
) -> torch.Tensor:
    """Additive (B|1, 1, q_len, kv_len) fp32 bias. `q_offset` is the absolute
    position of the first query row; `window` masks keys at positions
    <= q_pos - window (sliding-window attention)."""
    if device is None:
        device = pad_mask.device if pad_mask is not None else "cpu"
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    allowed = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        allowed &= k_pos <= q_pos
    if window is not None:
        allowed &= k_pos > q_pos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    bias = torch.where(allowed, zero, neg)[None, None]
    if pad_mask is not None:
        pb = torch.where(pad_mask[:, None, None, :].bool(), zero, neg)
        bias = bias + pb
    return bias


def multihead_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    bias: torch.Tensor | None = None,  # (B|1, 1|H, S, T) additive fp32
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Grouped-query attention with fp32 softmax. Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    G = H // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, S, Hkv, G, D)
    # both products accumulate in fp32 and leave it unrounded, as in JAX
    scores = einsum_f32("bskgd,btkd->bkgst", qg, k) * scale
    if bias is not None:
        b = bias[:, :, None] if bias.shape[1] == 1 else bias.reshape(bias.shape[0], Hkv, G, S, -1)
        scores = scores + b
    probs = torch.softmax(scores, dim=-1)
    out = einsum_f32("bkgst,btkd->bskgd", probs.to(q.dtype), v)
    return out.reshape(B, S, H, D).to(q.dtype)
