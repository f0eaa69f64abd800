"""Weight-only int8 quantization (port of starvector_tpu/ops/quantization.py).

  * `quantize_dense(p)`: {"kernel": (K, N)} -> {"kernel_q": int8 (K, N),
    "scale": (N,) fp32[, "bias"]}, symmetric per output channel:
    scale = max(max_k |w| / 127, 1e-12), q = clip(round(w / scale), -127, 127)
    in fp32, rounding half to even; from the same weights the codes and
    scales equal the JAX package's bit for bit (its jit computes the / 127 as
    a product with fp32(1/127), and so does this port).
  * `quantize_tree(params)`: every {"kernel": ...} leaf of 2 or 3 dims with
    at least `min_elems` elements; a stacked (L, K, N) leaf gets (L, N)
    scales, quantized one layer at a time so the fp32 transient is one
    layer's (K, N).
  * `quant_matmul` (kernel 14, csrc/quant_matmul.cu) beside its plain
    version `quant_matmul_plain`, and `dense_quantized`, which
    `ops.layers.dense` calls for a leaf with "kernel_q".

Kernel 14 replaces the Pallas TPU kernel `quant_matmul` -> `_qmm_kernel`
(starvector_tpu/ops/quantization.py:139, call :169, body :117). Its function
is the Pallas kernel's: acc = sum_k x[m, k] * q[k, n] in fp32 (int8 -> bf16
or fp32 is exact), then acc * scale[n] in fp32; the port adds the bias in the
same epilogue and rounds once to the output type, so a quantized dense layer
is one call. M <= 16 (decode) runs an HBM-bound split-K GEMV, M > 16
(prefill) a tensor-core tile for bf16 x and a CUDA-core tile for fp32 x
(see the source's header).

Numerics against the JAX package's default `dense_quantized`
(`use_pallas=False`, quantization.py:205-207): that path forms the weight
q * scale in the compute dtype *before* the product. In fp32 that rounds
each weight once in fp32, so the port agrees to about 1e-6 relative; in bf16
it rounds the scale and each weight to bf16, up to one bf16 step per weight,
so the two differ by about that. The port does not copy the extra rounding:
the kernel's function is its contract.
"""

from __future__ import annotations

import functools
import math

import torch

from starvector_tpu_torch.ops import kernel_lib

GEMV_MAX_ROWS = 16   # rows of x up to which the GEMV path runs (decode)
_GEMV_COLS = 128     # columns per GEMV block
_GEMV_MAX_KC = 1024  # rows of K per GEMV block
_TARGET_BLOCKS = 2 * 132  # GEMV blocks resident at once on the H100 (2 per SM)
_INV_127 = 1.0 / 127.0  # applied in fp32, as XLA's rewrite of "/ 127" is


# ---------------------------------------------------------------------------
# quantization of the weights
# ---------------------------------------------------------------------------

def _quantize_2d(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    w32 = w.float()
    scale = (w32.abs().amax(dim=0) * _INV_127).clamp_min(1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) -> (codes, (N,) scales); (L, K, N) -> (codes, (L, N) scales),
    one layer at a time."""
    if w.ndim == 2:
        return _quantize_2d(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize_2d(w[i])
    return q, scale


def quantize_dense(p: dict) -> dict:
    """Per-output-channel symmetric int8 of p["kernel"] (K, N) or (L, K, N)."""
    q, scale = _quantize(p["kernel"])
    out = {"kernel_q": q, "scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_tree(params: dict, min_elems: int = 1 << 16, *, consume: bool = True) -> dict:
    """Quantize every {"kernel": ...} dict whose kernel has 2 or 3 dims and
    at least `min_elems` elements; the rest (norms, embeddings, small
    projections) is returned as it is. With `consume=True` (the default)
    each quantized leaf's "kernel" is removed from the input dict as soon as
    its codes exist, so the tree no longer holds the source weight and its
    memory is freed once no other reference holds it (the JAX version
    deletes the device buffer); `consume=False` leaves the input intact."""

    def rec(node):
        if not isinstance(node, dict):
            return node
        w = node.get("kernel")
        if isinstance(w, torch.Tensor) and w.ndim in (2, 3) and w.numel() >= min_elems:
            out = quantize_dense(node)
            if consume:
                del node["kernel"], w
            return out
        return {k: rec(v) for k, v in node.items()}

    return rec(params)


# ---------------------------------------------------------------------------
# kernel 14: the int8 weight matmul
# ---------------------------------------------------------------------------

def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor | None = None, *,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel 14: (x @ q) in fp32, times scale in fp32, plus
    the bias in fp32, rounded once to `out_dtype`. x (M, K), w_q (K, N)
    int8, scale (N,) fp32."""
    y = torch.mm(x.float(), w_q.float()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


@functools.lru_cache(maxsize=64)  # a few (K, N) shapes per model; looked up every call
def gemv_split(K: int, N: int) -> tuple[int, int]:
    """(splits, rows a split) of K for the GEMV path: up to two blocks for
    every SM, one wave (a second, partial wave would double the time), each
    split a multiple of 32 rows and at most 1024 (the x chunk a block stages
    in shared memory)."""
    col_blocks = -(-N // _GEMV_COLS)
    splits = max(_TARGET_BLOCKS // col_blocks, -(-K // _GEMV_MAX_KC), 1)
    kc = min(32 * -(-math.ceil(K / splits) // 32), _GEMV_MAX_KC)
    return -(-K // kc), kc


def _check_qmm(x, w_q, scale, bias, out_dtype):
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not "
                         "make an (M, K) @ (K, N) product")
    M, K = x.shape
    N = w_q.shape[1]
    if x.dtype not in kernel_lib.FLOAT_TYPES or out_dtype not in kernel_lib.FLOAT_TYPES:
        raise TypeError(f"quant_matmul: x {x.dtype} -> {out_dtype}; the kernel takes bf16 or "
                        "fp32 in and out")
    if w_q.dtype != torch.int8 or not w_q.is_contiguous() or w_q.data_ptr() % 16 or N % 16:
        raise ValueError(f"quant_matmul: w_q must be contiguous 16-byte aligned int8 with "
                         f"N % 16 == 0, got {w_q.dtype} {tuple(w_q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,) or not scale.is_contiguous():
        raise ValueError(f"quant_matmul: scale must be contiguous fp32 ({N},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype not in kernel_lib.FLOAT_TYPES or tuple(bias.shape) != (N,)
                             or not bias.is_contiguous()):
        raise ValueError(f"quant_matmul: bias must be contiguous fp32 or bf16 ({N},), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if x.stride(1) != 1:
        raise ValueError(f"quant_matmul: x needs a contiguous last dim, strides {x.stride()}")
    if M > GEMV_MAX_ROWS and x.dtype == torch.bfloat16 and (
            K % 8 or x.data_ptr() % 16 or x.stride(0) % 8):
        raise ValueError(f"quant_matmul: bf16 x with M > {GEMV_MAX_ROWS} must have K % 8 == 0 "
                         f"and 16-byte aligned rows, got K={K}, strides {x.stride()}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on {x.device}")
    return M, K, N


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None = None, *, out_dtype: torch.dtype = torch.float32,
                 kernels: bool = True) -> torch.Tensor:
    """Kernel 14's wrapper: round(x @ w_q * scale + bias) to `out_dtype`,
    x (M, K) bf16 or fp32, w_q (K, N) int8, scale (N,) fp32, bias (N,) fp32
    or bf16 or None. A CPU tensor, or `kernels=False`, takes the plain
    version; on the card it launches the kernel or raises."""
    if x.device.type == "cpu" or not kernels:
        return quant_matmul_plain(x, w_q, scale, bias, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for tensors on {x.device}")
    M, K, N = _check_qmm(x, w_q, scale, bias, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    gemv = M <= GEMV_MAX_ROWS
    splits, kc = gemv_split(K, N) if gemv else (0, 0)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if gemv else None
    codes = kernel_lib.DTYPE_CODES
    code = kernel_lib.library().sv_quant_matmul(
        codes[x.dtype], codes[out_dtype], codes[bias.dtype] if bias is not None else 0,
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        M, K, N, x.stride(0), out.stride(0), splits, kc, torch.cuda.current_stream().cuda_stream,
    )
    kernel_lib.check(code, "quant_matmul")
    quant_matmul.launches += 1
    path = "gemv" if gemv else ("mma" if x.dtype == torch.bfloat16 else "f32_tile")
    quant_matmul.path_launches[path] += 1
    return out


quant_matmul.launches = 0
quant_matmul.path_launches = {"gemv": 0, "mma": 0, "f32_tile": 0}


def dense_quantized(p: dict, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16, *,
                    kernels: bool = True) -> torch.Tensor:
    """The quantized dense layer: (..., K) @ int8 (K, N) * scale + bias in
    fp32, rounded once to `compute_dtype` (the unquantized dense's output
    type). One quant_matmul call."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).to(compute_dtype)
    y = quant_matmul(x2, p["kernel_q"], p["scale"], p.get("bias"), out_dtype=compute_dtype,
                     kernels=kernels)
    return y.reshape(*x.shape[:-1], y.shape[-1])
