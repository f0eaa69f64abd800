"""Primitive layers with an explicit dtype policy (port of
starvector_tpu/ops/layers.py).

Policy, as in the JAX package:
  * parameters are stored in `param_dtype` (fp32, or bf16 for serving)
  * matmuls run in `compute_dtype`
  * LayerNorm statistics accumulate in fp32 whatever the input type

Parameters are plain dicts of tensors in the JAX package's layout: dense
kernels are (in, out), so a dense layer is `x @ kernel`; norms are
{"scale", "bias"}. Training adds activation checkpointing (`maybe_checkpoint`)
and dropout drawn from an explicit torch.Generator; initializers are not
matched to the JAX key streams (weights cross with models/convert.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


class _MatmulF32(torch.autograd.Function):
    """x (M, K) @ w (K, N) of one narrow type with an fp32 result, through
    cuBLAS's fp32-output product (`out_dtype`), which has no derivative in
    PyTorch. The backward is two products of the same kind: the fp32
    cotangent is rounded once to the operands' type, as the JAX package's
    transposed dot runs at the TPU's default precision, and each gradient is
    rounded once from its fp32 sum to its operand's type."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        g = gy.to(x2.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.t(), out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.t(), g, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with an fp32 result that is never rounded to a
    narrower type (the JAX package's preferred_element_type=float32). For
    bf16 operands on the card cuBLAS accumulates in fp32 and writes fp32
    (`out_dtype`, differentiable through _MatmulF32); the CPU has no such
    kernel, so there the operands are widened to fp32 first, which is exact
    for bf16 values."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        y = torch.mm(x2, w)
    elif x.is_cuda:
        y = _MatmulF32.apply(x2, w)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum with an fp32 result accumulated in fp32 from the exact
    products of the operands (preferred_element_type=float32): narrower
    operands are widened first, which is exact, and PyTorch's default keeps
    TF32 off for fp32 products."""
    return torch.einsum(eq, a.float(), b.float())


def dense(params: dict, x: torch.Tensor, policy: DTypePolicy | None = None, *,
          kernels: bool = True) -> torch.Tensor:
    """x @ kernel (+ bias) in the compute dtype. As in the JAX version, the
    product accumulates in fp32 and the bias joins the fp32 sum before the
    one rounding to the compute dtype. When the bias is already in the
    compute dtype (fp32, or bf16 parameters on the card) one `addmm` does
    all of it, adding the bias in cuBLAS's fp32 epilogue; an fp32 bias under
    a bf16 policy, and any bf16 product on the CPU, take the fp32 sum
    explicitly.

    A quantized leaf ({"kernel_q", "scale"}, ops/quantization.py) goes
    through the int8 weight kernel in the policy's compute dtype (x's own
    without a policy), as the JAX dense dispatches on "kernel_q";
    `kernels=False` runs that kernel's plain version."""
    if "kernel_q" in params:
        from starvector_tpu_torch.ops.quantization import dense_quantized

        compute = policy.compute_dtype if policy is not None else x.dtype
        return dense_quantized(params, x, compute, kernels=kernels)
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


def layer_unbind(tree, n: int) -> list:
    """All n layers of a stacked parameter dict, as views. For training:
    one `unbind` per leaf has one backward node that stacks the n layers'
    gradients, where n `layer_slice` calls would each scatter into a
    zero-filled copy of the whole stack."""
    if isinstance(tree, dict):
        per_key = {k: layer_unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics, the affine applied
    in fp32 and one rounding to x's dtype, as the JAX version does. With
    parameters of x's own type (bf16 serving) PyTorch's kernel does exactly
    that; fp32 parameters under a bf16 policy (training's fp32 masters) take
    the fp32 path, so a scale such as 1 - 1e-5 is not rounded to bf16."""
    scale, bias = params["scale"], params["bias"]
    if scale.dtype == x.dtype and bias.dtype == x.dtype:
        return F.layer_norm(x, x.shape[-1:], scale, bias, eps)
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def maybe_checkpoint(fn, remat):
    """Activation checkpointing of a layer body, as the JAX package's
    maybe_checkpoint: False runs fn as it is; True recomputes the whole body
    in the backward (torch.utils.checkpoint, non-reentrant).

    "dots_flash", the 1B default, keeps the flash attention's out and lse
    so that the backward never re-runs the attention forward kernel. A
    checkpoint policy sees aten ops, not the kernel's ctypes launch, so the
    decoder builds that mode by structure instead
    (models/gpt_bigcode.py::_train_block): it checkpoints the parts before
    and after the attention and leaves the flash autograd Function outside.
    Here "dots_flash" checkpoints the whole body, which is what it means for
    a module without flash attention (the JAX mode saves that module's
    non-expansion matmul outputs; the numbers are the same). "dots" and
    "dots_slim" are not ported (ROADMAP queue 1, item 4)."""
    if not remat:
        return fn
    if remat in ("dots", "dots_slim"):
        raise NotImplementedError(
            f"gradient_checkpointing={remat!r} is not ported yet: ROADMAP queue 1, item 4")
    if isinstance(remat, str) and remat != "dots_flash":
        raise ValueError(
            f"unknown gradient_checkpointing mode {remat!r}; expected "
            "true | false | 'dots' | 'dots_slim' | 'dots_flash'")

    def checkpointed(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return checkpointed


def dropout(x: torch.Tensor, p: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with keep-probability 1 - p, drawn from `gen`
    (no generator, or p = 0: the identity). A torch.Generator does not give
    jax.random's bits: the distribution is the same, the mask is not."""
    if gen is None or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - p
    return torch.where(keep, x / (1 - p), torch.zeros((), dtype=x.dtype, device=x.device))


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
