"""Primitive layers with an explicit dtype policy (port of
starvector_tpu/ops/layers.py).

Policy, as in the JAX package:
  * parameters are stored in `param_dtype` (fp32, or bf16 for serving)
  * matmuls run in `compute_dtype`
  * LayerNorm statistics accumulate in fp32 whatever the input type

Parameters are plain dicts of tensors in the JAX package's layout: dense
kernels are (in, out), so a dense layer is `x @ kernel`; norms are
{"scale", "bias"}. Training-only pieces (remat, initializers matched to the
JAX key streams) are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with an fp32 result that is never rounded to a
    narrower type (the JAX package's preferred_element_type=float32). For
    bf16 operands on the card cuBLAS accumulates in fp32 and writes fp32
    (`out_dtype`); the CPU has no such kernel, so there the operands are
    widened to fp32 first, which is exact for bf16 values."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        y = torch.mm(x2, w)
    elif x.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum with an fp32 result accumulated in fp32 from the exact
    products of the operands (preferred_element_type=float32): narrower
    operands are widened first, which is exact, and PyTorch's default keeps
    TF32 off for fp32 products."""
    return torch.einsum(eq, a.float(), b.float())


def dense(params: dict, x: torch.Tensor, policy: DTypePolicy | None = None) -> torch.Tensor:
    """x @ kernel (+ bias) in the compute dtype. As in the JAX version, the
    product accumulates in fp32 and the bias joins the fp32 sum before the
    one rounding to the compute dtype. When the bias is already in the
    compute dtype (fp32, or bf16 parameters on the card) one `addmm` does
    all of it, adding the bias in cuBLAS's fp32 epilogue; an fp32 bias under
    a bf16 policy, and any bf16 product on the CPU, take the fp32 sum
    explicitly."""
    w = params["kernel"]
    if policy is not None:
        x = x.to(policy.compute_dtype)
        w = w.to(policy.compute_dtype)
    bias = params.get("bias")
    if x.dtype == torch.float32 or (x.is_cuda and (bias is None or bias.dtype == x.dtype)):
        if bias is None:
            return torch.matmul(x, w)
        y = torch.addmm(bias.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    y = matmul_f32(x, w)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_slice(tree, i: int):
    """Layer i of a dict of parameters stacked on a leading layer axis
    (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim. PyTorch's kernel takes the statistics and
    the affine in fp32 for bf16 input and rounds once on output, as the JAX
    version does."""
    return F.layer_norm(x, x.shape[-1:], params["scale"].to(x.dtype),
                        params["bias"].to(x.dtype), eps)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh, the GPTBigCode activation."""
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the CLIP ViT activation."""
    return x * torch.sigmoid(1.702 * x)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the adapter activation."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# random initialisation (same distributions as the JAX package, not the same
# numbers: weights made here come from a torch.Generator)
# ---------------------------------------------------------------------------

def normal_(shape, std: float, gen: torch.Generator, device, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std).to(dtype)


def uniform_(shape, bound: float, gen: torch.Generator, device, dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return ((2 * u - 1) * bound).to(dtype)


def make_dense_params(
    gen: torch.Generator, d_in: int, d_out: int, *, std: float | None = None,
    lead: tuple[int, ...] = (), device="cpu", dtype=torch.float32,
) -> dict:
    """(lead..., d_in, d_out) kernel: normal(std), or torch.nn.Linear's
    U(-1/sqrt(d_in), 1/sqrt(d_in)) when std is None; zero bias."""
    shape = (*lead, d_in, d_out)
    if std is None:
        w = uniform_(shape, 1.0 / math.sqrt(d_in), gen, device, dtype)
    else:
        w = normal_(shape, std, gen, device, dtype)
    return {"kernel": w, "bias": torch.zeros((*lead, d_out), device=device, dtype=dtype)}


def make_layer_norm_params(dim: int, *, lead: tuple[int, ...] = (), device="cpu",
                           dtype=torch.float32) -> dict:
    return {"scale": torch.ones((*lead, dim), device=device, dtype=dtype),
            "bias": torch.zeros((*lead, dim), device=device, dtype=dtype)}
