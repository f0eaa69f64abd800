"""Adapter, the vision -> LLM projector (port of
starvector_tpu/models/adapter.py).

Dropout(p) -> Linear(d -> 2d) -> Swish -> Linear(2d -> llm_d) -> Norm, where
Norm is
  * `layer_norm`: LayerNorm over the last two dims jointly, with a (Q, llm_d)
    affine (torch LayerNorm([Q, llm_d])), or
  * `batch_norm`: BatchNorm1d(Q) (the 1B preset): running statistics at
    inference; in training the batch's statistics, with the running ones
    updated after the step (`forward_with_stats`).
The dropout applies only in training and only when a torch.Generator is
passed, as the JAX package applies it only when given a dropout key.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from starvector_tpu_torch.ops.layers import DTypePolicy, dense, dropout, swish, uniform_
from starvector_tpu_torch.parallel import zero
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.tensor import copy_to_group, even_split


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    input_size: int          # vision hidden size
    output_size: int         # llm hidden size
    query_length: int        # number of visual tokens
    adapter_norm: str = "layer_norm"  # "layer_norm" | "batch_norm"
    dropout_prob: float = 0.1
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1


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


def partition_rules() -> list[tuple[str, P]]:
    """Path regex -> PartitionSpec, the JAX package's list."""
    return [
        (r"c_fc/kernel", P("fsdp", "tensor")),
        (r"c_fc/bias", P("tensor")),
        (r"c_proj/kernel", P("tensor", "fsdp")),
        (r"c_proj/bias", P(None)),
        (r"norm/", P(None, None)),
    ]


def tensor_units(cfg: AdapterConfig, tp: int, rank: int) -> dict:
    """Tensor rank `rank` of tp's ranges, for training: an even 1/tp of
    c_fc's 2d columns and the same rows of c_proj."""
    hidden = even_split(2 * cfg.input_size, tp, rank)
    return {"c_fc": hidden, "c_proj": hidden}


def _layer_norm_2d(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last two dims (torch LayerNorm([Q, D]))."""
    x32 = x.float()
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _batch_stats(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(mean, biased variance, count) per query over (batch, feature) of
    the batch, as the JAX package takes them (the sum over the count, then
    the mean squared deviation). On a data-parallel layout x32 holds this
    rank's rows and the statistics are the global batch's, as JAX takes
    them over its batch-sharded array: each sum is summed over the batch
    ranks, in the forward and (for the gradient) in the backward. One batch
    rank computes what one process does, bit for bit."""
    rows = zero.global_rows(x32.shape[0])
    total = zero.batch_sum_grad if rows is not None else (lambda t: t)
    n = (x32.shape[0] if rows is None else rows[1]) * x32.shape[2]
    mean = total(x32.sum(dim=(0, 2))) / n
    var = total((x32 - mean[None, :, None]).square().sum(dim=(0, 2))) / n
    return mean, var, n


def _batch_norm_1d(p: dict, x: torch.Tensor, cfg: AdapterConfig,
                   train: bool = False) -> torch.Tensor:
    """BatchNorm1d(Q) on (B, Q, D): per-query statistics over (batch,
    feature), the running ones at inference, the batch's (biased variance)
    in training."""
    x32 = x.float()
    if train:
        mean, var, _ = _batch_stats(x32)
    else:
        mean, var = p["running_mean"].float(), p["running_var"].float()
    y = (x32 - mean[None, :, None]) * torch.rsqrt(var[None, :, None] + cfg.bn_eps)
    y = y * p["scale"].float()[None, :, None] + p["bias"].float()[None, :, None]
    return y.to(x.dtype)


def batch_norm_new_stats(p: dict, x: torch.Tensor, cfg: AdapterConfig) -> dict:
    """The running statistics after observing batch x (torch's momentum
    update: new = (1 - m) old + m batch, with the unbiased variance).
    Computed without a graph: they are state, not parameters."""
    with torch.no_grad():
        mean, var, n = _batch_stats(x.float())
        var = var * (n / max(n - 1, 1))
        m = cfg.bn_momentum
        return {"running_mean": (1 - m) * p["running_mean"] + m * mean,
                "running_var": (1 - m) * p["running_var"] + m * var}


def _project(params: dict, x: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
    """c_fc -> swish -> c_proj; on a tensor rank over its 1/tp of the 2d
    hidden units, x (which every rank holds) entering through
    copy_to_group."""
    h = swish(dense(params["c_fc"], copy_to_group(policy.cast(x)), policy))
    return dense(params["c_proj"], h, policy)


def forward(params: dict, cfg: AdapterConfig, x: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), train: bool = False,
            dropout_gen: torch.Generator | None = None) -> torch.Tensor:
    """(B, Q, input_size) -> (B, Q, output_size). `train` takes the
    BatchNorm batch statistics and, with `dropout_gen`, the input dropout."""
    params = zero.gathered(params, policy)
    if train:
        x = dropout(x, cfg.dropout_prob, dropout_gen)
    h = _project(params, x, policy)
    if cfg.adapter_norm == "layer_norm":
        return _layer_norm_2d(params["norm"], h)
    return _batch_norm_1d(params["norm"], h, cfg, train)


def forward_with_stats(params: dict, cfg: AdapterConfig, x: torch.Tensor, *,
                       policy: DTypePolicy = DTypePolicy(),
                       dropout_gen: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
    """Training forward: (out, the new running statistics to merge into
    params["norm"] after the update; {} for a layer_norm adapter)."""
    params = zero.gathered(params, policy)
    x = dropout(x, cfg.dropout_prob, dropout_gen)
    h = _project(params, x, policy)
    if cfg.adapter_norm == "layer_norm":
        return _layer_norm_2d(params["norm"], h), {}
    out = _batch_norm_1d(params["norm"], h, cfg, train=True)
    return out, batch_norm_new_stats(params["norm"], h, cfg)
