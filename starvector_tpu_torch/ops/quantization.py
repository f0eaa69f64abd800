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
is one call. M <= 16 (decode) runs an HBM-bound GEMV: with bf16 x the
tensor-core GEMV (one launch; codes streamed by TMA and made bf16 as the A
operand of mma.sync; its blocks planned by `gemv_plan`), with fp32 x the
CUDA-core split-K pair (`gemv_split`), as `gemv_path` rules; M > 16
(prefill) with bf16 x a `wgmma` tile fed by TMA, its int8 codes made bf16
in registers as the product's A operand, its height and any split of K
chosen per shape by `tile_plan`; fp32 x a CUDA-core tile (see the source's
header).

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
from starvector_tpu_torch.parallel import tensor

GEMV_MAX_ROWS = 16   # rows of x up to which the GEMV path runs (decode)
_GEMV_COLS = 128     # columns per GEMV block
_GEMV_MAX_KC = 1024  # rows of K per GEMV block
_SMS = 132           # the H100 SXM's streaming multiprocessors
_TARGET_BLOCKS = 2 * _SMS  # GEMV blocks resident at once on the H100 (2 per SM)
TILE_Q, TILE_K = 128, 64  # the wgmma tile's columns of q a block and k rows a step
TILE_XS = (136, 256)      # its rows of x a block (the product's N)
_TILE_MAX_SPLITS = 8
_TILE_BLOCK_STEPS = 4     # a block's fill and epilogue, in k steps of 128 rows of x
# a 256-row block's time a row of x against a 136-row block's: its m64n256
# products issue fewer instructions a row (fitted on the H100 to the 16
# prefill cases of the 1B and 8B projections, PERF.md section 6)
_TILE_256_ROW_COST = 0.83
_TILE_FINISH_BYTES = 2 << 20  # fp32 partial-sum bytes moved in the time of a k step
_INV_127 = 1.0 / 127.0  # applied in fp32, as XLA's rewrite of "/ 127" is
# the tensor-core GEMV (M <= 16, bf16 x): its unit of work is ku x GEMV_TC_K
# rows of K by GEMV_TC_COLS columns of q (a TMA box of codes); one block an
# SM takes whole column tiles a wave, and the blocks share the units of the
# tiles left, at least 4 GEMV_TC_K rows a block; launches with
# _GEMV_TC_WIDE column tiles or more run units of 64 rows, the others of
# 256 (the faster in scripts/bench_gemv.py's sweep, PERF.md section 6)
GEMV_TC_COLS, GEMV_TC_K = 128, 64
_GEMV_TC_SLOTS = _SMS
_GEMV_TC_WIDE = 64
_GEMV_TC_PARTIAL = 16 * GEMV_TC_COLS  # floats of one block's part of a shared tile
# per device: the GEMV's (tickets, workspace), grown by replacement; a CUDA
# graph that launched with the old pair holds it (generation/graphs.py)
_GEMV_SCRATCH: dict = {}


# ---------------------------------------------------------------------------
# quantization of the weights
# ---------------------------------------------------------------------------

def _scale(amax: torch.Tensor) -> torch.Tensor:
    return (amax * _INV_127).clamp_min(1e-12)


def _codes(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)


def _quantize(w: torch.Tensor, reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) -> (codes, (N,) scales); (L, K, N) -> (codes, (L, N) scales),
    one layer at a time. `reduce` maps the per-column absolute maxima
    before the scales are taken (a tensor rank's row slice: the maximum
    over its group, parallel/tensor.py::quantize_slices)."""
    if w.ndim == 2:
        amax = w.float().abs().amax(dim=0)
    else:
        amax = torch.stack([w[i].float().abs().amax(dim=0) for i in range(w.shape[0])])
    scale = _scale(amax if reduce is None else reduce(amax))
    if w.ndim == 2:
        return _codes(w, scale), scale
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    for i in range(w.shape[0]):
        q[i] = _codes(w[i], scale[i])
    return q, scale


def quantize_dense(p: dict, reduce=None) -> dict:
    """Per-output-channel symmetric int8 of p["kernel"] (K, N) or (L, K, N)
    (`reduce` as in _quantize)."""
    q, scale = _quantize(p["kernel"], reduce)
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


def gemv_path(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """Which GEMV runs M <= 16 rows, a fixed rule of the shape and x's
    type: "gemv", the CUDA-core split-K pair, for fp32 x (a bf16
    tensor-core product would round it), K % 8 != 0 (TMA copies x rows of
    16-byte steps), and where the pair measured faster on the H100 (PERF.md
    section 6): one row of x unless the columns fill a wave of whole tiles
    (N >= 132 x 128), up to 4 rows at N <= 1024, up to 8 at N <= 128;
    else "gemv_tc", the tensor-core GEMV."""
    if dtype != torch.bfloat16 or K % 8:
        return "gemv"
    if M == 1:
        return "gemv_tc" if N >= _GEMV_TC_SLOTS * GEMV_TC_COLS else "gemv"
    if (M <= 4 and N <= 1024) or (M <= 8 and N <= 128):
        return "gemv"
    return "gemv_tc"


def gemv_units(K: int, N: int, ku: int = 1) -> tuple[int, int]:
    """(column tiles, units of K a column tile) of the tensor-core GEMV with
    units of ku GEMV_TC_K rows."""
    return -(-N // GEMV_TC_COLS), -(-K // (ku * GEMV_TC_K))


def gemv_shared_units(K: int, N: int, blocks: int, dp_waves: int, ku: int) -> int:
    """Units the blocks share after dp_waves waves of whole tiles."""
    tiles, k_units = gemv_units(K, N, ku)
    return (tiles - dp_waves * blocks) * k_units


def gemv_plan_ok(K: int, N: int, blocks: int, dp_waves: int, ku: int) -> bool:
    """Whether the kernel takes the plan: units of 64 or 256 rows, whole
    tiles for every block in each wave, and at least one shared unit a
    block (or none)."""
    shared = gemv_shared_units(K, N, blocks, dp_waves, ku)
    return ku in (1, 4) and blocks >= 1 and dp_waves >= 0 and shared >= 0 and \
        not 0 < shared < blocks


@functools.lru_cache(maxsize=256)  # a few (K, N) shapes per model; looked up every call
def gemv_plan(K: int, N: int) -> tuple[int, int, int]:
    """(blocks, dp_waves, ku) of the tensor-core GEMV: units of 64 rows of
    K (ku 1) where there are _GEMV_TC_WIDE column tiles or more, else of 256
    (ku 4); one block on each of the 132 SMs where the launch has 256 rows
    of K for each, else one for every 256; the blocks take as many waves of
    whole column tiles as there are, then share the units of the tiles left
    in runs that differ by one unit at most, so that they end together
    (gemv_runs)."""
    tiles = gemv_units(K, N)[0]
    ku = 1 if tiles >= _GEMV_TC_WIDE else 4
    k_units = gemv_units(K, N, ku)[1]
    blocks = max(1, min(_GEMV_TC_SLOTS, tiles * k_units // (4 // ku)))
    waves = tiles // blocks
    while not gemv_plan_ok(K, N, blocks, waves, ku):
        waves -= 1
    return blocks, waves, ku


def gemv_runs(K: int, N: int, blocks: int, dp_waves: int,
              ku: int) -> list[list[tuple[int, int, int]]]:
    """The kernel's split of the work, by column tile: the (block, first
    unit of K, end) runs that make it, in block order, which is k order
    (the order in which the tile's last block adds their partial sums): a
    whole tile of a wave, or the shared units, tile by tile."""
    tiles, k_units = gemv_units(K, N, ku)
    runs = [[] for _ in range(tiles)]
    for w in range(dp_waves):
        for b in range(blocks):
            runs[w * blocks + b].append((b, 0, k_units))
    first = dp_waves * blocks
    units = gemv_shared_units(K, N, blocks, dp_waves, ku)
    for b in range(blocks):
        u, end = units * b // blocks, units * (b + 1) // blocks
        while u < end:
            c = u // k_units
            stop = min(end, (c + 1) * k_units)
            runs[first + c].append((b, u - c * k_units, stop - c * k_units))
            u = stop
    return runs


def _gemv_scratch(device: torch.device, n_tickets: int,
                  n_partials: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(tickets, workspace) of the tensor-core GEMV, kept per device: the
    tickets are zero between launches (the last block of a column tile
    resets its own), so they are zeroed once, when they grow."""
    tickets, ws = _GEMV_SCRATCH.get(device, (None, None))
    if tickets is not None and tickets.numel() >= n_tickets and ws.numel() >= n_partials:
        return tickets, ws
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        # a zeroing captured in a graph would not run until its replay
        raise RuntimeError("quant_matmul: the GEMV's scratch buffers grow outside a CUDA graph "
                           "capture; make one call at the largest shape before capturing")
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 256), dtype=torch.int32, device=device)
    if ws is None or ws.numel() < n_partials:
        ws = torch.empty(max(n_partials, 2 * _GEMV_TC_SLOTS * _GEMV_TC_PARTIAL),
                         dtype=torch.float32, device=device)
    _GEMV_SCRATCH[device] = (tickets, ws)
    return tickets, ws


@functools.lru_cache(maxsize=256)  # one entry per prefill length and projection
def tile_plan(M: int, K: int, N: int) -> tuple[int, int, int]:
    """(tile_x, splits, kc) of the wgmma tile (M > 16, bf16 x): blocks of
    TILE_Q columns of q by tile_x rows of x, K cut into `splits` ranges of
    kc rows (a multiple of 2 TILE_K: the kernel runs its steps in pairs,
    none empty). The fixed rule: the least modelled time, counted in k
    steps of 128 rows of x along the busiest SM as if one block held an SM:
    waves of blocks times (steps a block + its fill and epilogue), a
    256-row block's rows at _TILE_256_ROW_COST, plus, for more than one
    split, the fp32 partial sums the blocks write and the finish pass reads,
    and its output. Ties go to fewer splits, then the shorter tile. On the
    H100 it picks the fastest of the plans it weighs at the four 1B
    projections at M = 260 and 1040 and the 8B's four shapes at M = 580
    and 2320 (chip_smoke.py's tile_plan_times)."""
    best = None
    for splits_wanted in range(1, _TILE_MAX_SPLITS + 1):
        kc = 2 * TILE_K * -(-K // (splits_wanted * 2 * TILE_K))
        splits = -(-K // kc)
        if splits != splits_wanted:
            continue
        for tile_x in TILE_XS:
            blocks = -(-N // TILE_Q) * -(-M // tile_x) * splits
            waves = -(-blocks // _SMS)
            rows = tile_x / 128 * (_TILE_256_ROW_COST if tile_x == 256 else 1.0)
            cost = waves * rows * (kc // TILE_K + _TILE_BLOCK_STEPS)
            if splits > 1:
                cost += (2 * splits + 1) * M * N * 4 / _TILE_FINISH_BYTES
            key = (cost, splits, tile_x)
            if best is None or key < best[0]:
                best = (key, (tile_x, splits, kc))
    return best[1]


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
    if M == 0:
        return torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M <= GEMV_MAX_ROWS:
        if gemv_path(M, K, N, x.dtype) == "gemv_tc":
            return launch_gemv_tc(x, w_q, scale, bias, out_dtype, *gemv_plan(K, N))
        return launch_kernel(x, w_q, scale, bias, out_dtype, "gemv", 0, *gemv_split(K, N))
    if x.dtype == torch.bfloat16:
        return launch_kernel(x, w_q, scale, bias, out_dtype, "wgmma", *tile_plan(M, K, N))
    return launch_kernel(x, w_q, scale, bias, out_dtype, "f32_tile", 0, 0, 0)


def launch_kernel(x, w_q, scale, bias, out_dtype, path: str, tile_x: int, splits: int,
                  kc: int) -> torch.Tensor:
    """One launch of kernel 14 on inputs that `_check_qmm` passed, by `path`
    ("gemv": splits, kc from gemv_split; "wgmma": tile_x, splits, kc from
    tile_plan; "f32_tile": none), counted on quant_matmul. quant_matmul
    chooses the plan; a measurement may time another."""
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = None
    if path == "gemv" or splits > 1:
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    codes = kernel_lib.DTYPE_CODES
    code = kernel_lib.library().sv_quant_matmul(
        codes[x.dtype], codes[out_dtype], codes[bias.dtype] if bias is not None else 0,
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        M, K, N, x.stride(0), out.stride(0), tile_x, splits, kc,
        torch.cuda.current_stream().cuda_stream,
    )
    kernel_lib.check(code, "quant_matmul")
    quant_matmul.launches += 1
    quant_matmul.path_launches[path] += 1
    return out


def launch_gemv_tc(x, w_q, scale, bias, out_dtype, blocks: int, dp_waves: int,
                   ku: int) -> torch.Tensor:
    """One launch of the tensor-core GEMV (bf16 x, M <= 16, K % 8 == 0) on
    inputs that `_check_qmm` passed, by a plan: `blocks` blocks, dp_waves
    waves of whole tiles before the shared units, units of ku GEMV_TC_K
    rows of K (gemv_plan's, or another that gemv_plan_ok takes, for a
    measurement); counted on quant_matmul as path "gemv_tc". x rows that
    TMA cannot copy where they lie (not on 16-byte boundaries) are copied
    first."""
    M, K = x.shape
    N = w_q.shape[1]
    if x.data_ptr() % 16 or (M > 1 and x.stride(0) % 8):
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    tickets, ws = _gemv_scratch(x.device, gemv_units(K, N)[0], blocks * 2 * _GEMV_TC_PARTIAL)
    codes = kernel_lib.DTYPE_CODES
    code = kernel_lib.library().sv_quant_gemv(
        codes[out_dtype], codes[bias.dtype] if bias is not None else 0,
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), M, K, N, x.stride(0), out.stride(0), blocks, dp_waves, ku,
        torch.cuda.current_stream().cuda_stream,
    )
    kernel_lib.check(code, "quant_matmul")
    quant_matmul.launches += 1
    quant_matmul.path_launches["gemv_tc"] += 1
    return out


quant_matmul.launches = 0
quant_matmul.path_launches = {"gemv_tc": 0, "gemv": 0, "wgmma": 0, "f32_tile": 0}


def dense_quantized(p: dict, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16, *,
                    kernels: bool = True) -> torch.Tensor:
    """The quantized dense layer: (..., K) @ int8 (K, N) * scale + bias in
    fp32, rounded once to `compute_dtype` (the unquantized dense's output
    type). One quant_matmul call. Row-parallel codes of a tensor group
    (parallel/tensor.py) follow ops/layers.py::dense's contract: this
    rank's fp32 partial (kernel 14 with no bias), summed over the group in
    fp32, the whole bias added once, one rounding."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).to(compute_dtype)
    group = tensor.row_group(p["kernel_q"])
    if group is None:
        y = quant_matmul(x2, p["kernel_q"], p["scale"], p.get("bias"), out_dtype=compute_dtype,
                         kernels=kernels)
    else:
        y = group.all_reduce(quant_matmul(x2, p["kernel_q"], p["scale"], None,
                                          out_dtype=torch.float32, kernels=kernels))
        if "bias" in p:
            y = y + p["bias"].float()
        y = y.to(compute_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])
