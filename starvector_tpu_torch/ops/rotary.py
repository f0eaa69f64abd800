"""Rotary position embeddings for the StarCoder2 decoder (port of
starvector_tpu/ops/rotary.py).

GPT-NeoX rotate-half over the whole head, theta from the config. Computed
in the JAX function's order, all in fp32: inv_freq = 1 / theta^(2i / D),
the angles as positions * inv_freq, and the rotation x cos + rotate_half(x)
sin, rounded once to x's dtype. At positions past 4096 one ulp of inv_freq
moves an angle by about 3e-4 rad, so inv_freq is held to JAX's bits.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    power = torch.pow(torch.tensor(theta, dtype=torch.float64), exponent.double()).float()
    return (1.0 / power).to(device)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device="cpu") -> torch.Tensor:
    """inv_freq (head_dim // 2,) fp32: 1 / theta^e with e = fp32(2i / D) and
    the power rounded once to fp32 from float64, on the host. That is the
    correctly rounded fp32 power, which XLA's pow gives; torch's fp32 pow is
    an ulp off at some exponents (i = 37 of 64 at D = 128, theta = 1e6), so
    the port does not use it. Cached per device: one copy to the card."""
    return _inv_freq(head_dim, float(theta), torch.device(device))


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions (...,) int -> cos, sin (..., head_dim) fp32."""
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions (B, S) or (S,) -> cos, sin (B|1, S, 1, head_dim) fp32, ready
    to broadcast over the heads of (B, S, H, D). A decoder computes them once
    a call and rotates every layer's q and k with them."""
    cos, sin = rope_cos_sin(positions, inv_freq)
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    return cos[:, :, None, :], sin[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by rope_tables' cos, sin: in fp32, rounded once
    to x's dtype."""
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) or (S,) -> x rotated, in x's dtype
    (the JAX function's signature)."""
    return rotate(x, *rope_tables(positions, inv_freq))
