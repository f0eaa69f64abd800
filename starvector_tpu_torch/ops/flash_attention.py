"""The attention kernels of the inference path, each beside its plain
PyTorch version (port of the inference half of
starvector_tpu/ops/flash_attention.py).

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
    them (see the source's header).

Every wrapper takes the plain version for a tensor on the CPU, or when
called with `kernels=False` (tests and chip_smoke.py compare the two on the
card). For a CUDA tensor it launches its kernel or raises: nothing falls
back. Each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops import kernel_lib
from starvector_tpu_torch.ops.attention import NEG_INF, make_attention_bias, multihead_attention
from starvector_tpu_torch.ops.layers import einsum_f32

# the kernels' storage types and their codes in csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    if dtype not in _DTYPE_CODES:
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
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % Hkv or D != 128:
        raise ValueError(f"flash_prefill: H={H}, Hkv={Hkv}, D={D} (the kernel takes D = 128)")
    _check_operands("flash_prefill", {"q": q, "k": k, "v": v}, q.dtype, q.device)
    _check_mask("flash_prefill", kv_mask, (B, T), q.device)
    q_offset = int(q_offset)
    if q_offset < 0 or (window is not None and window <= 0):
        raise ValueError(f"flash_prefill: q_offset={q_offset}, window={window}")
    scale = D**-0.5 if scale is None else float(scale)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    lib = kernel_lib.library()
    code = lib.sv_flash_prefill(
        _DTYPE_CODES[q.dtype], D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
        B, S, T, H, Hkv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        kv_mask.stride(0), q_offset, int(causal), int(window or 0), scale, _stream(),
    )
    kernel_lib.check(code, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: decode attention
# ---------------------------------------------------------------------------

def decode_attention_plain(qg, k_cache, v_cache, kv_mask, *, k_new=None, v_new=None,
                           t_begin: int = 0, t_end: int | None = None,
                           scale: float | None = None):
    """Plain version of kernel 2, step for step the JAX
    merged_decode_attention: fp32 scores over the visible cache, the
    self-score merged into one softmax, probabilities cast to the compute
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
    s_c = torch.where(visible[:, None, None, :], s_c, torch.full_like(s_c, NEG_INF))
    m = s_c.amax(dim=-1)
    if k_new is not None:
        s_self = einsum_f32("bkgd,bkd->bkg", qg, k_new.to(dt)) * scale
        m = torch.maximum(m, s_self)
    p_c = torch.exp(s_c - m[..., None])
    denom = p_c.sum(dim=-1)
    out = einsum_f32("bkgt,btkd->bkgd", p_c.to(dt), v_cache.to(dt))
    if k_new is not None:
        p_s = torch.exp(s_self - m)
        denom = denom + p_s
        out = out + p_s[..., None] * v_new[:, :, None].float()
    return (out / denom[..., None]).to(dt)


def decode_attention(
    qg: torch.Tensor,       # (B, Hkv, G, D) the new token's query heads, grouped
    k_cache: torch.Tensor,  # (B, T, Hkv, D)
    v_cache: torch.Tensor,  # (B, T, Hkv, D)
    kv_mask: torch.Tensor,  # (B, T) int32
    *,
    k_new: torch.Tensor | None = None,  # (B, Hkv, D) the new token's key
    v_new: torch.Tensor | None = None,  # (B, Hkv, D)
    t_begin: int = 0,
    t_end: int | None = None,
    scale: float | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Kernel 2's wrapper: one query token per row over the visible cache
    slots (t_begin <= t < t_end, kv_mask set), plus the self token when
    k_new/v_new are given. Returns (B, Hkv, G, D) in qg's dtype."""
    if (k_new is None) != (v_new is None):
        raise ValueError("decode_attention: give both k_new and v_new, or neither")
    if _use_plain(qg, kernels):
        return decode_attention_plain(qg, k_cache, v_cache, kv_mask, k_new=k_new, v_new=v_new,
                                      t_begin=t_begin, t_end=t_end, scale=scale)
    B, Hkv, G, D = qg.shape
    T = k_cache.shape[1]
    if k_cache.shape != (B, T, Hkv, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(qg.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if G != 16 or D != 128:
        raise ValueError(f"decode_attention: G={G}, D={D} (the kernel takes G = 16, D = 128)")
    tensors = {"q": qg, "k_cache": k_cache, "v_cache": v_cache}
    if k_new is not None:
        if k_new.shape != (B, Hkv, D) or v_new.shape != (B, Hkv, D):
            raise ValueError(f"decode_attention: k_new {tuple(k_new.shape)}, v_new {tuple(v_new.shape)}")
        tensors.update(k_new=k_new, v_new=v_new)
    _check_operands("decode_attention", tensors, qg.dtype, qg.device,
                    aligned=("k_cache", "v_cache"))
    _check_mask("decode_attention", kv_mask, (B, T), qg.device)
    t_begin = max(int(t_begin), 0)
    t_end = T if t_end is None else min(int(t_end), T)
    scale = D**-0.5 if scale is None else float(scale)
    out = torch.empty((B, Hkv, G, D), dtype=qg.dtype, device=qg.device)
    if B == 0:
        return out
    kn = k_new if k_new is not None else qg  # strides are unused without a self token
    vn = v_new if v_new is not None else qg
    lib = kernel_lib.library()
    code = lib.sv_decode_attention(
        _DTYPE_CODES[qg.dtype], G, D,
        qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(),
        kv_mask.data_ptr(), out.data_ptr(), B, Hkv,
        qg.stride(0), qg.stride(1), qg.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        kn.stride(0), kn.stride(1), vn.stride(0), vn.stride(1),
        kv_mask.stride(0), t_begin, t_end, scale, _stream(),
    )
    kernel_lib.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def merged_decode_attention(qg, k_new, v_new, k_cached, v_cached, old_mask, scale, *,
                            kernels: bool = True) -> torch.Tensor:
    """The JAX decoder's decode attention (decode_common.merged_decode_attention):
    qg (B, Hkv, G, D), the new token's k_new/v_new (B, Hkv, D), the cache
    before the new token (B, T, Hkv, D) and its visibility old_mask (B, T).
    Returns (B, 1, H*D)."""
    B, Hkv, G, D = qg.shape
    out = decode_attention(qg, k_cached, v_cached, old_mask, k_new=k_new, v_new=v_new,
                           scale=scale, kernels=kernels)
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

