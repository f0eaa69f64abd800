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

import contextlib
import dataclasses
import functools
import math
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)


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
          kernels: bool = True, tag: str | None = None) -> torch.Tensor:
    """x @ kernel (+ bias) in the compute dtype. As in the JAX version, the
    product accumulates in fp32 and the bias joins the fp32 sum before the
    one rounding to the compute dtype. When the bias is already in the
    compute dtype (fp32, or bf16 parameters on the card) one `addmm` does
    all of it, adding the bias in cuBLAS's fp32 epilogue; an fp32 bias under
    a bf16 policy, and any bf16 product on the CPU, take the fp32 sum
    explicitly.

    While a "dots" or "dots_slim" checkpoint runs (maybe_checkpoint), the
    op that makes the output runs under a name those modes save by, as the
    JAX dense tags its output: `tag`, else "dense_wide_out" for an
    expansion (out >= 4 x in: the MLP's c_fc) and "dense_out" for the rest.
    Elsewhere (inference, the other modes) nothing is named.

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
    name = tag or ("dense_wide_out" if w.shape[-1] >= 4 * w.shape[-2] else "dense_out")
    bias = params.get("bias")
    if x.dtype == torch.float32 or (x.is_cuda and (bias is None or bias.dtype == x.dtype)):
        x2 = x.reshape(-1, x.shape[-1])
        if bias is None:
            y = _named(name, torch.mm, x2, w)
        else:
            y = _named(name, torch.addmm, bias.to(x.dtype), x2, w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    y = matmul_f32(x, w)
    if bias is not None:
        y = y + bias.float()
    return _named(name, y.to, x.dtype)


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


# on this thread: .saving, whether a "dots"/"dots_slim" checkpoint is
# running (its forward or its recompute); .name, what dense is making its
# output under
_NAMING = threading.local()


def _named(name: str, op, *args):
    """op(*args), under `name` while a selective checkpoint is running (the
    only reader of the name); elsewhere just op(*args)."""
    if not getattr(_NAMING, "saving", False):
        return op(*args)
    _NAMING.name = name
    try:
        return op(*args)
    finally:
        _NAMING.name = None


@contextlib.contextmanager
def _saving(ctx):
    """`ctx` (a selective-checkpoint context) with dense naming its outputs."""
    prev = getattr(_NAMING, "saving", False)
    _NAMING.saving = True
    try:
        with ctx:
            yield
    finally:
        _NAMING.saving = prev


# the dense output names each mode saves (the JAX save_only_these_names)
SAVED_NAMES = {"dots": ("dense_out", "dense_qkv_out"), "dots_slim": ("dense_out",)}


def _save_named(names: tuple[str, ...]):
    """The contexts of a selective checkpoint that keeps what dense makes
    under one of `names` and recomputes every other op in the backward."""

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if getattr(_NAMING, "name", None) in names \
            else CheckpointPolicy.PREFER_RECOMPUTE

    forward, recompute = create_selective_checkpoint_contexts(policy)
    return _saving(forward), _saving(recompute)


def maybe_checkpoint(fn, remat):
    """Activation checkpointing of a layer body, as the JAX package's
    maybe_checkpoint: False runs fn as it is; True recomputes the whole body
    in the backward (torch.utils.checkpoint, non-reentrant).

    "dots" keeps every dense output but the expansions ("dense_out" and the
    attention's q/k/v, "dense_qkv_out") and recomputes the rest, the MLP's
    c_fc and the attention among it; "dots_slim" also recomputes q/k/v.
    Both are torch.utils.checkpoint's selective policy over the op that
    dense makes each output with (its name, `_named`, given only inside
    these checkpoints), which keeps exactly the compute-dtype tensors the
    JAX policy saves.

    "dots_flash", the 1B default, keeps the flash attention's out and lse
    so that the backward never re-runs the attention forward kernel. A
    checkpoint policy sees aten ops, not the kernel's ctypes launch, so the
    decoders build that mode by structure instead (remat_layer): it
    checkpoints the parts before and after the attention and leaves the
    flash autograd Function outside. Here "dots_flash" checkpoints the whole
    body, which is what it means for a module without flash attention (the
    JAX mode saves that module's non-expansion matmul outputs; the numbers
    are the same)."""
    if not remat:
        return fn
    if isinstance(remat, str) and remat not in SAVED_NAMES and remat != "dots_flash":
        raise ValueError(
            f"unknown gradient_checkpointing mode {remat!r}; expected "
            "true | false | 'dots' | 'dots_slim' | 'dots_flash'")
    kw = {}
    if remat in SAVED_NAMES:
        kw["context_fn"] = functools.partial(_save_named, SAVED_NAMES[remat])

    def checkpointed(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return checkpointed


def remat_layer(pre, attend, post, remat):
    """A decoder layer x -> post(x, attend(*pre(x))) under `remat`.
    "dots_flash" checkpoints pre (the norm and the q/k/v projections) and
    post (the output projection, residual and MLP) each, and leaves attend,
    the flash autograd Function, between them, so autograd keeps the
    attention's out and lse and the backward never re-runs its forward
    kernel; any other mode is maybe_checkpoint over the whole layer (under
    "dots" and "dots_slim" the attention forward is re-run, as in JAX)."""
    if remat == "dots_flash":
        pre_c, post_c = maybe_checkpoint(pre, True), maybe_checkpoint(post, True)
        return lambda x: post_c(x, attend(*pre_c(x)))
    return maybe_checkpoint(lambda x: post(x, attend(*pre(x))), remat)


def dropout(x: torch.Tensor, p: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with keep-probability 1 - p, drawn from `gen`
    (no generator, or p = 0: the identity). A torch.Generator does not give
    jax.random's bits: the distribution is the same, the mask is not."""
    if gen is None or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - p
    return torch.where(keep, x / (1 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def conv_nhwc(params: dict, x: torch.Tensor, *, stride: int = 1, padding="same",
              groups: int = 1) -> torch.Tensor:
    """A 2-D convolution of channels-last x (B, H, W, C) with the JAX
    package's HWIO kernel (kh, kw, C / groups, out) and its bias, in x's
    dtype; `padding` is "same" (stride 1), "valid" or F.conv2d's ints. The
    NHWC tensor goes in as a channels-last NCHW view, so the convolution
    keeps that memory format and the result comes back as NHWC without a
    copy."""
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, params["bias"].to(x.dtype), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


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
