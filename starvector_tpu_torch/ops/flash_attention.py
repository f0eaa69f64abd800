"""The attention kernels of the inference and training paths, each beside
its plain PyTorch version (port of starvector_tpu/ops/flash_attention.py).

Kernel 1, `flash_prefill` (csrc/flash_prefill.cu)
    Replaces the Pallas TPU kernel `flash_prefill` -> `_flash_kernel` /
    `_flash_fwd_cell` (starvector_tpu/ops/flash_attention.py:212, call :254).
    Causal flash attention with online fp32 softmax, key mask, absolute
    query offset and sliding window, MQA/GQA, head size 128 (the only
    one StarVector-1B has, and the only one built). On the H100 this first
    version runs its products on the fp32 CUDA cores, so it is bound by
    instruction issue, far below both the tensor-core and the HBM roof; it
    stages each 64-key tile of K and V in shared memory once for 64 query
    rows and stops at the causal bound (see the source's header).

Kernel 2, `decode_attention` (csrc/decode_attention.cu)
    Replaces the Pallas TPU kernel `mqa_decode_batched` ->
    `_decode_all_kernel` (:2049, call :2076; and `mqa_decode` ->
    `_decode_kernel`, :2202, which computes the same) and the XLA
    `models/decode_common.py::merged_decode_attention` that the JAX decoder
    runs for every generated token. One new query token per row against
    the cache, with the new token's key and value optionally merged into
    the same softmax. Built for StarVector-1B's 16 query heads per KV head
    and head size 128 only. Bound on the H100 by latency and by having one
    block per (row, KV head); eight warps per block split the keys between
    them (see the source's header). An int8 cache (codes with per
    (row, position, KV head) fp32 k_scale / v_scale, the JAX package's
    init_cache(dtype=int8)) takes its own instantiation of the same kernel.

Kernel 1 with the logsumexp, `flash_prefill_with_lse` (csrc/flash_prefill.cu)
    Replaces the Pallas TPU kernels `flash_prefill_with_lse` ->
    `_flash_lse_kernel` (:307, call :512) and `_flash_lse_tri_kernel` (:330,
    call :455): the training forward, which also writes each row's
    logsumexp (B, H, S) fp32 for the backward. The same CUDA kernel with its
    lse output switched on; its k loop stops at the causal bound, so it
    visits only the live triangle that the TPU's triangular grid enumerates.

Kernels 3 and 4, `flash_bwd_dkdv` and `flash_bwd_dq` (csrc/flash_backward.cu)
    Replace the Pallas TPU backward `flash_backward` (:1257): the fused
    `_flash_dqdkv_fused_kernel` (:968, call :1392) that the 1B training step
    runs at T = 769, and the one-pass, dq-partial and split variants that the
    TPU needs at longer T for its VMEM budget (same math). dK/dV per
    (batch, KV head, 64-key tile), summed over the G query heads in one
    block; dQ per (batch, head, 64-row tile). fp32 CUDA cores; see the
    source's header. `flash_backward` computes delta = rowsum(dO * O) in fp32
    with plain torch, as the JAX package computes it outside its kernels, and
    launches both.

`flash_prefill_trainable` is the autograd Function around them: its
forward runs `flash_prefill_with_lse` and saves q, k, v, the key mask, out
and lse; its backward runs `flash_backward`.

Every wrapper takes the plain version for a tensor on the CPU, or when
called with `kernels=False` (tests and chip_smoke.py compare the two on the
card). For a CUDA tensor it launches its kernel or raises: nothing falls
back. Each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from starvector_tpu_torch.ops import kernel_lib
from starvector_tpu_torch.ops.attention import NEG_INF, make_attention_bias, multihead_attention
from starvector_tpu_torch.ops.layers import einsum_f32

# the kernels' masked-score sentinel (csrc/common.cuh, the Pallas NEG_INF):
# a row that sees no key keeps it as its max, and lse = -1e30 + log(1e-30)
KERNEL_NEG_INF = -1e30


def _use_plain(x: torch.Tensor, kernels: bool) -> bool:
    if x.device.type == "cpu" or not kernels:
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    return False


def _check_operands(what: str, tensors: dict[str, torch.Tensor], dtype, device,
                    aligned: tuple[str, ...] = ()) -> None:
    """Raise unless every tensor is on `device`, of `dtype`, with a unit
    stride in its last dim; tensors named in `aligned` must also start on,
    and step every non-last dim by, a multiple of 16 bytes (the kernels'
    vector loads)."""
    if dtype not in kernel_lib.FLOAT_TYPES:
        raise TypeError(f"{what}: kernel takes float32 or bfloat16, not {dtype}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim, strides {t.stride()}")
        if name in aligned:
            size = t.element_size()
            if t.data_ptr() % 16 or any((s * size) % 16 for s in t.stride()[:-1]):
                raise ValueError(f"{what}: {name} is not 16-byte aligned (strides {t.stride()})")


def _check_mask(what: str, mask: torch.Tensor, shape: tuple[int, int], device) -> None:
    if mask.dtype != torch.int32 or mask.device != device:
        raise TypeError(f"{what}: kv_mask must be int32 on {device}, got {mask.dtype} on {mask.device}")
    if tuple(mask.shape) != shape or mask.stride(-1) != 1:
        raise ValueError(f"{what}: kv_mask shape {tuple(mask.shape)} strides {mask.stride()}, "
                         f"expected {shape} with unit stride along T")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# kernel 1: flash prefill
# ---------------------------------------------------------------------------

def flash_prefill_plain(q, k, v, kv_mask, q_offset: int = 0, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None):
    """Plain version of kernel 1: the masked fp32-softmax attention that the
    JAX package's Pallas kernel is validated against."""
    bias = make_attention_bias(kv_mask, q.shape[1], k.shape[1], q_offset=q_offset,
                               causal=causal, window=window, device=q.device)
    return multihead_attention(q, k, v, bias, scale=scale)


def _check_prefill(what, q, k, v, kv_mask, q_offset, window):
    """Raise unless the kernel takes these operands; (B, S, T, H, Hkv, D)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % Hkv or D != 128:
        raise ValueError(f"{what}: H={H}, Hkv={Hkv}, D={D} (the kernel takes D = 128)")
    _check_operands(what, {"q": q, "k": k, "v": v}, q.dtype, q.device)
    _check_mask(what, kv_mask, (B, T), q.device)
    if int(q_offset) < 0 or (window is not None and window <= 0):
        raise ValueError(f"{what}: q_offset={q_offset}, window={window}")
    return B, S, T, H, Hkv, D


def _launch_prefill(what, q, k, v, kv_mask, q_offset, causal, window, scale, lse):
    """One launch of csrc/flash_prefill.cu; out (B, S, H, D), and lse
    (B, H, S) fp32 written when given."""
    B, S, T, H, Hkv, D = _check_prefill(what, q, k, v, kv_mask, q_offset, window)
    scale = D**-0.5 if scale is None else float(scale)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    code = kernel_lib.library().sv_flash_prefill(
        kernel_lib.DTYPE_CODES[q.dtype], D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, S, T, H, Hkv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        kv_mask.stride(0), int(q_offset), int(causal), int(window or 0), scale, _stream(),
    )
    kernel_lib.check(code, what)
    return out


def flash_prefill(
    q: torch.Tensor,        # (B, S, H, D)
    k: torch.Tensor,        # (B, T, Hkv, D)
    v: torch.Tensor,        # (B, T, Hkv, D)
    kv_mask: torch.Tensor,  # (B, T) int32, 1 = valid key
    q_offset: int = 0,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Flash attention; returns (B, S, H, D) in q's dtype. `q_offset` is the
    absolute position of q[:, 0] in the key window, so a prefill attends
    over a whole preallocated cache of T slots: the kernel stops at the
    causal bound and never reads the unwritten tail. Rows that see no key
    are unspecified (the kernel writes zeros)."""
    if _use_plain(q, kernels):
        return flash_prefill_plain(q, k, v, kv_mask, q_offset, causal=causal,
                                   window=window, scale=scale)
    out = _launch_prefill("flash_prefill", q, k, v, kv_mask, q_offset, causal, window, scale,
                          None)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def _visible(kv_mask, S: int, T: int, q_offset: int, causal: bool, window, device):
    """(B, 1, 1, S, T) bool: query row s sees key t (the kernels' masks)."""
    q_pos = int(q_offset) + torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    allowed = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        allowed &= k_pos <= q_pos
    if window is not None:
        allowed &= k_pos > q_pos - window
    return (allowed[None] & (kv_mask[:, None, :] > 0))[:, None, None]


def flash_prefill_with_lse_plain(q, k, v, kv_mask, q_offset: int = 0, *, causal: bool = True,
                                 window: int | None = None, scale: float | None = None):
    """Plain version of the forward with the logsumexp: PR 1's masked
    fp32-softmax attention, written so that a row that sees no key gives
    what the kernel gives (zeros, lse = -1e30 + log(1e-30)). Returns
    (out (B, S, H, D) in q's dtype, lse (B, H, S) fp32). The (S, T) score
    block is updated in place: at the 8k context it is 4.6 GB in fp32."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    scale = D**-0.5 if scale is None else scale
    hidden = ~_visible(kv_mask, S, T, q_offset, causal, window, q.device)
    s = einsum_f32("bskgd,btkd->bkgst", q.reshape(B, S, Hkv, H // Hkv, D), k).mul_(scale)
    s.masked_fill_(hidden, KERNEL_NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_().masked_fill_(hidden, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    lse = (m + torch.log(l)).reshape(B, H, S)
    out = einsum_f32("bkgst,btkd->bskgd", p.div_(l).to(q.dtype), v)
    return out.reshape(B, S, H, D).to(q.dtype), lse


def flash_prefill_with_lse(
    q: torch.Tensor,        # (B, S, H, D)
    k: torch.Tensor,        # (B, T, Hkv, D)
    v: torch.Tensor,        # (B, T, Hkv, D)
    kv_mask: torch.Tensor,  # (B, T) int32
    q_offset: int = 0,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    kernels: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out (B, S, H, D) in q's dtype, lse (B, H, S)
    fp32), lse = m + log(max(l, 1e-30)) per row as the Pallas kernels write
    it, in the plain (B, H, S) layout rather than the TPU's 8-lane one."""
    if _use_plain(q, kernels):
        return flash_prefill_with_lse_plain(q, k, v, kv_mask, q_offset, causal=causal,
                                            window=window, scale=scale)
    B, S, H = q.shape[:3]
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    out = _launch_prefill("flash_prefill_with_lse", q, k, v, kv_mask, q_offset, causal, window,
                          scale, lse)
    flash_prefill_with_lse.launches += 1
    return out, lse


flash_prefill_with_lse.launches = 0


# ---------------------------------------------------------------------------
# kernels 3 and 4: the flash backward pair
# ---------------------------------------------------------------------------

def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 from the rounded forward output,
    (B, S, H, D) -> (B, H, S), as the JAX flash_backward computes it."""
    return (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _backward_plain(q, k, v, kv_mask, lse, delta, do, q_offset, causal, window, scale):
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D**-0.5 if scale is None else scale
    hidden = ~_visible(kv_mask, S, T, q_offset, causal, window, q.device)
    qg, dog = q.reshape(B, S, Hkv, G, D), do.reshape(B, S, Hkv, G, D)
    s = einsum_f32("bskgd,btkd->bkgst", qg, k).mul_(scale)
    p = s.sub_(lse.reshape(B, Hkv, G, S, 1)).exp_().masked_fill_(hidden, 0.0)
    del s
    # the JAX kernels' rounding points: P to dO's type, dS to q's type
    dv = einsum_f32("bkgst,bskgd->btkd", p.to(do.dtype), dog)
    dp = einsum_f32("bskgd,btkd->bkgst", dog, v)
    ds = dp.sub_(delta.reshape(B, Hkv, G, S, 1)).mul_(p).mul_(scale).to(q.dtype)
    del p, dp
    dq = einsum_f32("bkgst,btkd->bskgd", ds, k).reshape(B, S, H, D)
    dk = einsum_f32("bkgst,bskgd->btkd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, kv_mask, out, lse, do, q_offset: int = 0, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None):
    """Plain version of the backward pair: the recompute formulas on whole
    (S, T) blocks in fp32, P = exp(S - lse) under the masks, dV = P^T dO,
    dS = P (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q, with the JAX
    kernels' rounding points. Returns (dq, dk, dv) in the inputs' types."""
    return _backward_plain(q, k, v, kv_mask, lse, attention_delta(out, do), do, q_offset,
                           causal, window, scale)


def _check_backward(what, q, k, v, kv_mask, do, lse, delta, q_offset, window):
    B, S, T, H, Hkv, D = _check_prefill(what, q, k, v, kv_mask, q_offset, window)
    if do.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(do.shape)}, q {tuple(q.shape)}")
    _check_operands(what, {"dout": do}, q.dtype, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, H, S) or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a contiguous (B, H, S) fp32 tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *do.stride()[:3])
    return B, S, T, H, Hkv, D, strides


def flash_bwd_dkdv(q, k, v, kv_mask, do, lse, delta, q_offset: int = 0, *,
                   causal: bool = True, window: int | None = None,
                   scale: float | None = None, kernels: bool = True):
    """dk, dv (B, T, Hkv, D) in k's type, given the forward's lse and
    delta = rowsum(dO * O), both (B, H, S) fp32."""
    if _use_plain(q, kernels):
        return _backward_plain(q, k, v, kv_mask, lse, delta, do, q_offset, causal, window,
                               scale)[1:]
    B, S, T, H, Hkv, D, strides = _check_backward("flash_bwd_dkdv", q, k, v, kv_mask, do, lse,
                                                  delta, q_offset, window)
    scale = D**-0.5 if scale is None else float(scale)
    dk = torch.empty((B, T, Hkv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, T, Hkv, D), dtype=k.dtype, device=k.device)
    if B == 0 or T == 0:
        return dk, dv
    code = kernel_lib.library().sv_flash_bwd_dkdv(
        kernel_lib.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_mask.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, T, H, Hkv, strides, kv_mask.stride(0), int(q_offset), int(causal),
        int(window or 0), scale, _stream(),
    )
    kernel_lib.check(code, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, kv_mask, do, lse, delta, q_offset: int = 0, *,
                 causal: bool = True, window: int | None = None,
                 scale: float | None = None, kernels: bool = True):
    """dq (B, S, H, D) in q's type, given lse and delta as flash_bwd_dkdv."""
    if _use_plain(q, kernels):
        return _backward_plain(q, k, v, kv_mask, lse, delta, do, q_offset, causal, window,
                               scale)[0]
    B, S, T, H, Hkv, D, strides = _check_backward("flash_bwd_dq", q, k, v, kv_mask, do, lse,
                                                  delta, q_offset, window)
    scale = D**-0.5 if scale is None else float(scale)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return dq
    code = kernel_lib.library().sv_flash_bwd_dq(
        kernel_lib.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_mask.data_ptr(), dq.data_ptr(),
        B, S, T, H, Hkv, strides, kv_mask.stride(0), int(q_offset), int(causal),
        int(window or 0), scale, _stream(),
    )
    kernel_lib.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_backward(q, k, v, kv_mask, out, lse, do, q_offset: int = 0, *,
                   causal: bool = True, window: int | None = None,
                   scale: float | None = None, kernels: bool = True):
    """The JAX flash_backward contract: (dq, dk, dv) of the attention whose
    forward gave `out` and `lse`, for the output cotangent `do`."""
    if _use_plain(q, kernels):
        return flash_backward_plain(q, k, v, kv_mask, out, lse, do, q_offset, causal=causal,
                                    window=window, scale=scale)
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = attention_delta(out, do)
    kw = dict(causal=causal, window=window, scale=scale)
    dk, dv = flash_bwd_dkdv(q, k, v, kv_mask, do, lse, delta, q_offset, **kw)
    dq = flash_bwd_dq(q, k, v, kv_mask, do, lse, delta, q_offset, **kw)
    return dq, dk, dv


class _FlashPrefillTrainable(torch.autograd.Function):
    """Forward: flash_prefill_with_lse, saving q, k, v, the key mask, out and
    lse (the JAX custom-vjp residuals); backward: flash_backward. The key
    mask and the scalars get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_offset, causal, window, scale, kernels):
        out, lse = flash_prefill_with_lse(q, k, v, kv_mask, q_offset, causal=causal,
                                          window=window, scale=scale, kernels=kernels)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.options = (q_offset, causal, window, scale, kernels)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        q_offset, causal, window, scale, kernels = ctx.options
        dq, dk, dv = flash_backward(q, k, v, kv_mask, out, lse, g, q_offset, causal=causal,
                                    window=window, scale=scale, kernels=kernels)
        return dq, dk, dv, None, None, None, None, None, None


def flash_prefill_trainable(q, k, v, kv_mask, q_offset: int = 0, *, causal: bool = True,
                            window: int | None = None, scale: float | None = None,
                            kernels: bool = True) -> torch.Tensor:
    """Differentiable flash attention (the JAX flash_prefill_trainable):
    (B, S, H, D) in q's dtype. q, k and v may be strided views (of the fused
    c_attn output); their gradients come back in their shapes and autograd
    accumulates them into the projection's gradient."""
    return _FlashPrefillTrainable.apply(q, k, v, kv_mask, int(q_offset), causal, window, scale,
                                        kernels)


# ---------------------------------------------------------------------------
# kernel 2: decode attention
# ---------------------------------------------------------------------------

def decode_attention_plain(qg, k_cache, v_cache, kv_mask, *, k_new=None, v_new=None,
                           k_scale=None, v_scale=None, t_begin: int = 0,
                           t_end: int | None = None, scale: float | None = None):
    """Plain version of kernel 2, step for step the JAX
    merged_decode_attention: fp32 scores over the visible cache (times
    k_scale for an int8 cache), the self-score merged into one softmax, the
    probabilities (times v_scale for an int8 cache) cast to the compute
    dtype for the product with V, the self term in fp32. Returns
    (B, Hkv, G, D)."""
    B, Hkv, G, D = qg.shape
    T = k_cache.shape[1]
    dt = qg.dtype
    scale = D**-0.5 if scale is None else scale
    t_end = T if t_end is None else min(int(t_end), T)
    pos = torch.arange(T, device=qg.device)[None, :]
    visible = (kv_mask > 0) & (pos >= int(t_begin)) & (pos < t_end)
    s_c = einsum_f32("bkgd,btkd->bkgt", qg, k_cache.to(dt)) * scale
    if k_scale is not None:
        s_c = s_c * k_scale.permute(0, 2, 1)[:, :, None, :]
    s_c = torch.where(visible[:, None, None, :], s_c, torch.full_like(s_c, NEG_INF))
    m = s_c.amax(dim=-1)
    if k_new is not None:
        s_self = einsum_f32("bkgd,bkd->bkg", qg, k_new.to(dt)) * scale
        m = torch.maximum(m, s_self)
    p_c = torch.exp(s_c - m[..., None])
    denom = p_c.sum(dim=-1)
    if v_scale is not None:
        p_c = p_c * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = einsum_f32("bkgt,btkd->bkgd", p_c.to(dt), v_cache.to(dt))
    if k_new is not None:
        p_s = torch.exp(s_self - m)
        denom = denom + p_s
        out = out + p_s[..., None] * v_new[:, :, None].float()
    return (out / denom[..., None]).to(dt)


def _check_scales(k_cache, v_cache, k_scale, v_scale, B: int, T: int, Hkv: int, device):
    """Raise unless the scales fit the cache: both given, fp32 (B, T, Hkv)
    on the device, exactly when the cache holds int8 codes."""
    quant = k_cache.dtype == torch.int8
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: k cache {k_cache.dtype}, v cache {v_cache.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both k_scale and v_scale, or neither")
    if quant and k_scale is None:
        raise ValueError("decode_attention: an int8 cache needs k_scale and v_scale")
    if not quant and k_scale is not None:
        raise ValueError(f"decode_attention: k_scale / v_scale given with a {k_cache.dtype} "
                         "cache (scales go with an int8 cache only)")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (B, T, Hkv) or t.device != device:
            raise ValueError(f"decode_attention: {name} must be fp32 (B, T, Hkv) = "
                             f"{(B, T, Hkv)} on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def decode_attention(
    qg: torch.Tensor,       # (B, Hkv, G, D) the new token's query heads, grouped
    k_cache: torch.Tensor,  # (B, T, Hkv, D), qg's dtype or int8 codes
    v_cache: torch.Tensor,  # (B, T, Hkv, D)
    kv_mask: torch.Tensor,  # (B, T) int32
    *,
    k_new: torch.Tensor | None = None,  # (B, Hkv, D) the new token's key
    v_new: torch.Tensor | None = None,  # (B, Hkv, D)
    k_scale: torch.Tensor | None = None,  # (B, T, Hkv) fp32, int8 cache only
    v_scale: torch.Tensor | None = None,  # (B, T, Hkv) fp32
    t_begin: int = 0,
    t_end: int | None = None,
    scale: float | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Kernel 2's wrapper: one query token per row over the visible cache
    slots (t_begin <= t < t_end, kv_mask set), plus the self token when
    k_new/v_new are given. An int8 cache comes with its k_scale / v_scale.
    Returns (B, Hkv, G, D) in qg's dtype."""
    if (k_new is None) != (v_new is None):
        raise ValueError("decode_attention: give both k_new and v_new, or neither")
    B, Hkv, G, D = qg.shape
    T = k_cache.shape[1]
    _check_scales(k_cache, v_cache, k_scale, v_scale, B, T, Hkv, qg.device)
    if _use_plain(qg, kernels):
        return decode_attention_plain(qg, k_cache, v_cache, kv_mask, k_new=k_new, v_new=v_new,
                                      k_scale=k_scale, v_scale=v_scale, t_begin=t_begin,
                                      t_end=t_end, scale=scale)
    if k_cache.shape != (B, T, Hkv, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(qg.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if G != 16 or D != 128:
        raise ValueError(f"decode_attention: G={G}, D={D} (the kernel takes G = 16, D = 128)")
    quant = k_cache.dtype == torch.int8
    tensors = {"q": qg} if quant else {"q": qg, "k_cache": k_cache, "v_cache": v_cache}
    if k_new is not None:
        if k_new.shape != (B, Hkv, D) or v_new.shape != (B, Hkv, D):
            raise ValueError(f"decode_attention: k_new {tuple(k_new.shape)}, v_new {tuple(v_new.shape)}")
        tensors.update(k_new=k_new, v_new=v_new)
    _check_operands("decode_attention", tensors, qg.dtype, qg.device,
                    aligned=("k_cache", "v_cache"))
    if quant:
        for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
            if t.device != qg.device or t.stride(-1) != 1 or t.data_ptr() % 16 or \
                    any(s % 16 for s in t.stride()[:-1]):
                raise ValueError(f"decode_attention: int8 {name} must be on {qg.device} with a "
                                 f"contiguous last dim and 16-byte aligned rows, strides "
                                 f"{t.stride()}")
    _check_mask("decode_attention", kv_mask, (B, T), qg.device)
    t_begin = max(int(t_begin), 0)
    t_end = T if t_end is None else min(int(t_end), T)
    scale = D**-0.5 if scale is None else float(scale)
    out = torch.empty((B, Hkv, G, D), dtype=qg.dtype, device=qg.device)
    if B == 0:
        return out
    kn = k_new if k_new is not None else qg  # strides are unused without a self token
    vn = v_new if v_new is not None else qg
    ks = k_scale if quant else kv_mask[:, :, None]  # strides are unused without scales
    vs = v_scale if quant else kv_mask[:, :, None]
    lib = kernel_lib.library()
    code = lib.sv_decode_attention(
        kernel_lib.DTYPE_CODES[qg.dtype], kernel_lib.DTYPE_CODES[k_cache.dtype], G, D,
        qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(),
        kv_mask.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        out.data_ptr(), B, Hkv,
        qg.stride(0), qg.stride(1), qg.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        kn.stride(0), kn.stride(1), vn.stride(0), vn.stride(1),
        ks.stride(0), ks.stride(1), ks.stride(2), vs.stride(0), vs.stride(1), vs.stride(2),
        kv_mask.stride(0), t_begin, t_end, scale, _stream(),
    )
    kernel_lib.check(code, "decode_attention")
    decode_attention.launches += 1
    if quant:
        decode_attention.int8_launches += 1
    return out


decode_attention.launches = 0
decode_attention.int8_launches = 0  # of which with an int8 cache


def merged_decode_attention(qg, k_new, v_new, k_cached, v_cached, old_mask, scale,
                            k_scale=None, v_scale=None, *, kernels: bool = True) -> torch.Tensor:
    """The JAX decoder's decode attention (decode_common.merged_decode_attention):
    qg (B, Hkv, G, D), the new token's k_new/v_new (B, Hkv, D), the cache
    before the new token (B, T, Hkv, D) and its visibility old_mask (B, T);
    an int8 cache with its k_scale / v_scale (B, T, Hkv). Returns
    (B, 1, H*D)."""
    B, Hkv, G, D = qg.shape
    out = decode_attention(qg, k_cached, v_cached, old_mask, k_new=k_new, v_new=v_new,
                           k_scale=k_scale, v_scale=v_scale, scale=scale, kernels=kernels)
    return out.reshape(B, 1, Hkv * G * D)


def gqa_decode_batched(q, k_cache, v_cache, kv_mask, cache_len, window_start=0, *,
                       scale: float | None = None, kernels: bool = True) -> torch.Tensor:
    """The Pallas `gqa_decode_batched` contract: q (B, H, D) over the cache
    (B, T, Hkv, D); keys visible where kv_mask is set, below cache_len and
    at or after window_start. Returns (B, H, D)."""
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    out = decode_attention(q.unflatten(1, (Hkv, H // Hkv)), k_cache, v_cache, kv_mask,
                           t_begin=int(window_start), t_end=int(cache_len), scale=scale,
                           kernels=kernels)
    return out.reshape(B, H, D)


def mqa_decode(q, k_cache, v_cache, kv_mask, cache_len, window_start=0, *,
               scale: float | None = None, kernels: bool = True) -> torch.Tensor:
    """The Pallas `mqa_decode` contract: one KV head, cache (B, T, D)."""
    return gqa_decode_batched(q, k_cache[:, :, None], v_cache[:, :, None], kv_mask,
                              cache_len, window_start, scale=scale, kernels=kernels)

