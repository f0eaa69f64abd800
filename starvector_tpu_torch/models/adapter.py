"""Adapter, the vision -> LLM projector, inference (port of
starvector_tpu/models/adapter.py).

Linear(d -> 2d) -> Swish -> Linear(2d -> llm_d) -> Norm, where Norm is
  * `layer_norm`: LayerNorm over the last two dims jointly, with a (Q, llm_d)
    affine (torch LayerNorm([Q, llm_d])), or
  * `batch_norm`: BatchNorm1d(Q) with its running statistics (the 1B preset).
The input dropout is off at inference and not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from starvector_tpu_torch.ops.layers import DTypePolicy, dense, swish, uniform_


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    input_size: int          # vision hidden size
    output_size: int         # llm hidden size
    query_length: int        # number of visual tokens
    adapter_norm: str = "layer_norm"  # "layer_norm" | "batch_norm"
    bn_eps: float = 1e-5


def init_params(cfg: AdapterConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    """Glorot-uniform weights, zero biases, identity norm (running mean 0,
    running var 1 for batch_norm)."""
    d, o, Q = cfg.input_size, cfg.output_size, cfg.query_length

    def glorot(n_in, n_out):
        return uniform_((n_in, n_out), math.sqrt(6.0 / (n_in + n_out)), gen, device, dtype)

    params = {
        "c_fc": {"kernel": glorot(d, 2 * d), "bias": torch.zeros(2 * d, device=device, dtype=dtype)},
        "c_proj": {"kernel": glorot(2 * d, o), "bias": torch.zeros(o, device=device, dtype=dtype)},
    }
    if cfg.adapter_norm == "layer_norm":
        params["norm"] = {"scale": torch.ones((Q, o), device=device, dtype=dtype),
                          "bias": torch.zeros((Q, o), device=device, dtype=dtype)}
    elif cfg.adapter_norm == "batch_norm":
        params["norm"] = {
            "scale": torch.ones(Q, device=device, dtype=dtype),
            "bias": torch.zeros(Q, device=device, dtype=dtype),
            "running_mean": torch.zeros(Q, device=device, dtype=torch.float32),
            "running_var": torch.ones(Q, device=device, dtype=torch.float32),
        }
    else:
        raise ValueError(f"unknown adapter_norm {cfg.adapter_norm!r}")
    return params


def _layer_norm_2d(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last two dims (torch LayerNorm([Q, D]))."""
    x32 = x.float()
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _batch_norm_1d(p: dict, x: torch.Tensor, cfg: AdapterConfig) -> torch.Tensor:
    """BatchNorm1d(Q) on (B, Q, D) at inference: per-query running stats."""
    x32 = x.float()
    mean = p["running_mean"].float()[None, :, None]
    var = p["running_var"].float()[None, :, None]
    y = (x32 - mean) * torch.rsqrt(var + cfg.bn_eps)
    y = y * p["scale"].float()[None, :, None] + p["bias"].float()[None, :, None]
    return y.to(x.dtype)


def forward(params: dict, cfg: AdapterConfig, x: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy()) -> torch.Tensor:
    """(B, Q, input_size) -> (B, Q, output_size)."""
    h = swish(dense(params["c_fc"], policy.cast(x), policy))
    h = dense(params["c_proj"], h, policy)
    if cfg.adapter_norm == "layer_norm":
        return _layer_norm_2d(params["norm"], h)
    return _batch_norm_1d(params["norm"], h, cfg)
