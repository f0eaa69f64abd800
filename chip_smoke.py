"""Chip smoke test of the PyTorch/CUDA port: StarVector-1B im2svg inference
(bf16, and int8 weights with an int8 KV cache) and training on one NVIDIA
H100, end to end through the hand-written kernels.

    python3 chip_smoke.py [--profile DIR]

Phases, one line each (any failure raises and exits non-zero):
  1. card: name and power limit, torch / CUDA / nvcc versions
  2. build: the CUDA sources of starvector_tpu_torch/csrc, one nvcc each in
     parallel; registers and spills per kernel from ptxas
  3. kernels against their plain PyTorch versions on the card, fp32 and
     bf16: the inference pair at the 1B prefill/decode shapes and ragged
     cases; the training forward-with-lse and backward pair at the 1B
     training shape (B=4, S=T=769), ragged cases, the 8k context
     (B=1, S=T=8450), sequence-parallel chunks of the 8k and 16k windows and
     the 16k triangle; the int8 weight matmul (kernel 14: GEMV at M = 1, 4,
     tile at M = 1040, the four 1B projection shapes, bf16 and fp32, with and
     without bias) and the int8-cache decode attention
  4. inference at full StarVector-1B width (GPTBigCode 2048 x 24 layers,
     CLIP ViT-L/14 at 224, BatchNorm adapter) on random weights from a
     seeded torch.Generator: 3 requests of 4 images through
     StarVectorForCausalLM.generate_im2svg_ids, with launch counts; fp32
     greedy ids against the plain attention; bf16 prefill logits against it.
     Then int8: the decoder quantized with quantize_tree, 3 requests of 4
     images with an int8 cache through engine.generate, with launch counts
     (96 int8 matmuls per prefill and per decode step, 24 int8-cache decode
     launches per step); fp32 greedy ids kernels vs plain; bf16 prefill
     logits against the fp32 plain int8 path; greedy agreement with bf16.
     Last, beside the card's name and power limit: p50 B=1 latency and B=4
     decode tokens/s for bf16 and int8, and the memory of both; the int8
     tree is then released
  5. training at full 1B width (fp32 masters, bf16 compute, dots_flash
     remat, AdamW): 8 steps of the port's train loop on one synthetic batch
     (T = 257 + 512 = 769), loss falling, 24 launches per step of each
     training kernel, peak memory (also above what was held before it);
     then 2 fp32 steps with the kernels against 2 with the plain attention
  6. times on the card, each beside the card's name and power limit: each
     kernel against its plain version, its bound and one PyTorch library
     call where there is one, the train step, also the training kernels at
     the long contexts phase 3 drives (with --profile DIR, also where a
     decode step's and a train step's device time goes)
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Fixed token ids stand in for the tokenizer: the "<svg" prompt and the
# "</svg>" stop sequence (no tokenizer file is needed on the card).
PROMPT_IDS = (44, 5727, 2262)
STOP_IDS = ((1053, 5727, 48),)
# Decoder projections are scaled up from the 0.02 init so that greedy
# decoding on random weights does not collapse onto one repeated token
# (tests/test_torch_im2svg.py scales them by 10 at tiny width); phase 4
# prints the distinct ids per row that this scale gives.
PROJ_SCALE = 3.0
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # atol = rtol, per dtype
# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W): the bound of
# a kernel is max(bytes / HBM rate, operations / dense bf16 tensor rate)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for work that must
    move `nbytes` and do `flops`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    """Device time of one fn() call in ms: `iters` calls captured in a CUDA
    graph and replayed between two CUDA events, so the host's per-call
    launch cost (tens of microseconds here) is not what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: cuBLAS handles, allocator
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


KERNEL_COUNTS = ("flash_prefill", "decode_attention", "flash_prefill_with_lse",
                 "flash_bwd_dkdv", "flash_bwd_dq")
TRAIN_KERNELS = ("flash_prefill_with_lse", "flash_bwd_dkdv", "flash_bwd_dq")
QMM_PATHS = ("gemv", "mma", "f32_tile")


def reset_counts(tfa) -> None:
    from starvector_tpu_torch.ops import quantization as tq

    for name in KERNEL_COUNTS:
        getattr(tfa, name).launches = 0
    tfa.decode_attention.int8_launches = 0
    tq.quant_matmul.launches = 0
    tq.quant_matmul.path_launches.update(dict.fromkeys(QMM_PATHS, 0))


def read_counts(tfa) -> dict:
    """Every wrapper's launches: the attention kernels, the int8-cache share
    of decode_attention, and quant_matmul in all and by path."""
    from starvector_tpu_torch.ops import quantization as tq

    counts = {name: getattr(tfa, name).launches for name in KERNEL_COUNTS}
    counts["decode_attention_int8"] = tfa.decode_attention.int8_launches
    counts["quant_matmul"] = tq.quant_matmul.launches
    counts.update({f"quant_matmul_{k}": v for k, v in tq.quant_matmul.path_launches.items()})
    return counts


def kernel_tag(mangled: str) -> str:
    """'<bf16>' or '<f32>' from a mangled kernel name's first template
    argument (the output type of the int8 matmul's tile and finish kernels,
    'out' marks it), then ' int8 cache' for decode_attention_kernel<T,
    int8_t, ...> and ' rows<=N' for qmm_gemv_kernel<T, N>."""
    first = re.search(r"kernelI(13__nv_bfloat16|f)", mangled)
    out = "out " if re.search(r"qmm_(mma|f32|finish)_kernel", mangled) else ""
    tag = f"<{out}bf16>" if first and first.group(1) != "f" else f"<{out}f32>"
    if re.search(r"decode_attention_kernelI(13__nv_bfloat16|f)a", mangled):
        tag += " int8 cache"
    rows = re.search(r"qmm_gemv_kernelI(?:13__nv_bfloat16|f)Li(\d+)E", mangled)
    return tag + (f" rows<={rows.group(1)}" if rows else "")


def ptxas_summary(log_text: str) -> list[str]:
    """'<kernel><type>: N registers, S bytes spilled' for each kernel ptxas
    compiled, read from its -v output."""
    out, name, spill = [], None, 0
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = next((k for k in ("flash_prefill_kernel", "decode_attention_kernel",
                                     "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                                     "qmm_gemv_kernel", "qmm_finish_kernel", "qmm_mma_kernel",
                                     "qmm_f32_kernel")
                         if k in mangled), mangled[:40])
            name = base + kernel_tag(mangled)
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name is not None:
            regs = int(line.split("Used")[1].split()[0])
            out.append(f"{name} {regs} registers, {spill} bytes spilled")
            name, spill = None, 0
    return out


def compare(what: str, out: torch.Tensor, ref: torch.Tensor, dtype, live=None) -> float:
    """Raise unless |out - ref| <= tol + tol*|ref| on the live rows; return max |out - ref|."""
    if live is not None:
        out, ref = out[live], ref[live]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    tol = TOL[dtype]
    err = (out - ref).abs()
    bad = err > tol + tol * ref.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max |diff| {err.max().item():.3e}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash_prefill(tfa, dev) -> float:
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # name, B, S, T, H, Hkv, q_offset, window, left_pad
        ("1B prefill", 4, 261, 261 + 128, 16, 1, 0, None, 0),
        ("S=37", 2, 37, 37, 16, 1, 0, None, 0),
        ("T=53 not a tile multiple", 2, 37, 53, 16, 1, 0, None, 0),
        ("q_offset=100", 2, 37, 200, 16, 1, 100, None, 0),
        ("left-padded keys", 2, 64, 100, 16, 1, 0, None, 9),
        ("window=32", 2, 100, 100, 16, 1, 0, 32, 0),
        ("GQA Hkv=4", 2, 70, 70, 16, 4, 0, None, 0),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, T, H, Hkv, q_off, window, pad in cases:
            # q as the decoder passes it: a strided view of the fused c_attn
            # output [q | k | v], rows H*D + 2*Hkv*D apart
            qkv = torch.randn((B, S, (H + 2 * Hkv) * 128), generator=g, device=dev).to(dtype)
            q = qkv[..., :H * 128].unflatten(-1, (H, 128))
            k = torch.randn((B, T, Hkv, 128), generator=g, device=dev).to(dtype)
            v = torch.randn((B, T, Hkv, 128), generator=g, device=dev).to(dtype)
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            mask[:, q_off + S:] = 0   # unwritten cache tail
            mask[:, :pad] = 0
            out = tfa.flash_prefill(q, k, v, mask, q_off, window=window)
            ref = tfa.flash_prefill(q, k, v, mask, q_off, window=window, kernels=False)
            torch.cuda.synchronize()
            live = torch.arange(S, device=dev)[None, :] + q_off >= pad  # rows that see a key
            live = live.expand(B, S)
            err = compare(f"flash_prefill {name} {dtype}", out, ref, dtype, live)
            worst = max(worst, err)
            log("kernels", f"flash_prefill {name} {str(dtype)[6:]}: max |diff| {err:.3e}")
    return worst


def check_decode_attention(tfa, dev) -> float:
    g = torch.Generator(device=dev).manual_seed(2)
    G, D = 16, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 4):
            for T in (1, 300, 2049):
                qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
                kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
                k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
                mask = torch.ones((B, T), dtype=torch.int32, device=dev)
                mask[:, : T // 5] = 0  # left padding
                # (b) merged_decode_attention: the cache plus the self token
                out = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5)
                ref = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, kernels=False)
                torch.cuda.synchronize()
                err_b = compare(f"merged decode B={B} T={T} {dtype}", out, ref, dtype)
                # (a) gqa_decode_batched: valid length and window start, no self token
                q = qg.reshape(B, G, D)
                lo, hi = T // 8, max(T - 3, 1)
                out = tfa.gqa_decode_batched(q, k, v, mask, hi, lo)
                ref = tfa.gqa_decode_batched(q, k, v, mask, hi, lo, kernels=False)
                torch.cuda.synchronize()
                live = (mask[:, lo:hi] > 0).any(dim=1)
                err_a = compare(f"gqa decode B={B} T={T} {dtype}", out, ref, dtype, live)
                worst = max(worst, err_a, err_b)
                log("kernels", f"decode_attention B={B} T={T} {str(dtype)[6:]}: "
                               f"merged max |diff| {err_b:.3e}, batched max |diff| {err_a:.3e}")
    return worst


QMM_SHAPES = (  # the 1B decoder's four projections: name, K, N
    ("attn.c_attn", 2048, 2304), ("attn.c_proj", 2048, 2048),
    ("mlp.c_fc", 2048, 8192), ("mlp.c_proj", 8192, 2048),
)


def check_quant_matmul(tq, dev) -> dict:
    """Kernel 14 against its plain version at M = 1, 4 (GEMV) and 1040 (the
    tile: 4 x 260 prefill rows), the four projection shapes, bf16 and fp32
    x, with a bias of x's type and without. Returns the worst max |diff| by
    path ("gemv", "tile")."""
    g = torch.Generator(device=dev).manual_seed(8)
    worst = {"gemv": 0.0, "tile": 0.0}
    for name, K, N in QMM_SHAPES:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = torch.randn((N,), generator=g, device=dev)
        errs = []
        for M in (1, 4, 1040):
            path = "gemv" if M <= tq.GEMV_MAX_ROWS else "tile"
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                for b in (None, bias.to(dtype)):
                    out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    err = compare(f"quant_matmul {name} M={M} {dtype} bias={b is not None}",
                                  out, ref, dtype)
                    worst[path] = max(worst[path], err)
                    errs.append(f"M={M} {str(dtype)[6:]}{'+bias' if b is not None else ''} "
                                f"{err:.2e}")
        log("kernels", f"quant_matmul {name} (K={K}, N={N}): max |diff| " + ", ".join(errs))
    return worst


def check_int8_decode(tfa, dc, dev) -> float:
    """The int8-cache decode attention against its plain version: B = 1, 4,
    T = 260, 389 cached tokens, left padding and a masked slot, fp32 and
    bf16 queries over codes and scales from quantize_kv."""
    g = torch.Generator(device=dev).manual_seed(9)
    G, D = 16, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 4):
            for T in (260, 389):
                qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
                kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
                (kq, ks), (vq, vs) = (dc.quantize_kv(torch.randn((B, T, 1, D), generator=g,
                                                                 device=dev)) for _ in "kv")
                mask = torch.ones((B, T), dtype=torch.int32, device=dev)
                mask[:, : T // 5] = 0
                mask[0, T // 2] = 0
                out = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs)
                ref = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs,
                                                  kernels=False)
                torch.cuda.synchronize()
                err = compare(f"int8 decode B={B} T={T} {dtype}", out, ref, dtype)
                worst = max(worst, err)
                log("kernels", f"decode_attention int8 cache B={B} T={T} {str(dtype)[6:]}: "
                               f"max |diff| {err:.3e}")
    return worst


TRAIN_CASES = [  # name, B, S, T, H, Hkv, q_offset, window, right_pad, left_pad
    ("1B train step", 4, 769, 769, 16, 1, 0, None, 0, 0),
    ("right-padded keys", 2, 300, 300, 16, 1, 0, None, 120, 0),
    ("S=37 not a tile multiple", 2, 37, 37, 16, 1, 0, None, 0, 0),
    ("S<T, q_offset=130", 2, 70, 200, 16, 1, 130, None, 0, 0),
    ("window=33", 2, 150, 150, 16, 1, 0, 33, 0, 0),
    ("GQA Hkv=4", 2, 130, 130, 16, 4, 0, None, 0, 0),
    ("left-padded keys, rows with no key", 2, 100, 100, 16, 1, 0, None, 0, 7),
    # the long contexts of the TPU's other backward variants: the 8k
    # triangle (one-pass tri), a sequence-parallel chunk at the end of the
    # 8k and of the 16k window (one-pass / dq-partials, and the split pair,
    # q_offset traced), and the 16k triangle (split tri) at 2 heads, whose
    # plain version's (H, T, T) fp32 blocks would not fit at 16
    ("8k context", 1, 8450, 8450, 16, 1, 0, None, 0, 0),
    ("8k SP chunk, S=1024 at q_offset=7426", 1, 1024, 8450, 16, 1, 7426, None, 0, 0),
    ("16k SP chunk, S=1024 at q_offset=15618", 1, 1024, 16642, 16, 1, 15618, None, 0, 0),
    ("16k context, H=2", 1, 16642, 16642, 2, 1, 0, None, 0, 0),
]


def compare_training(what: str, out, plain, ref32, dtype, live=None) -> float:
    """compare() at the dtype's tolerance; for bf16, failing that, the kernel
    may be no further from the fp32 plain result (on the same bf16 inputs)
    than twice the plain bf16 version's own distance, plus 1e-3: the kernels
    keep P and dS in fp32 where the plain version rounds them to bf16."""
    try:
        return compare(what, out, plain, dtype, live)
    except AssertionError:
        if dtype != torch.bfloat16:
            raise
    sel = (lambda t: t[live]) if live is not None else (lambda t: t)
    err_k = (sel(out).float() - sel(ref32)).abs().max().item()
    err_p = (sel(plain).float() - sel(ref32)).abs().max().item()
    if not torch.isfinite(out).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"{what}: kernel {err_k:.3e} from fp32, plain bf16 {err_p:.3e}")
    return (sel(out).float() - sel(plain).float()).abs().max().item()


def check_training_kernels(tfa, dev) -> dict:
    """The forward with lse and the backward pair against their plain
    versions. q is a strided view of a fused [q | k | v] projection, as the
    decoder passes it; the backward pair gets the plain forward's out and
    lse on both sides, so each comparison isolates one kernel."""
    g = torch.Generator(device=dev).manual_seed(6)
    worst = {name: 0.0 for name in TRAIN_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, T, H, Hkv, q_off, window, rpad, lpad in TRAIN_CASES:
            qkv = torch.randn((B, S, (H + 2 * Hkv) * 128), generator=g, device=dev).to(dtype)
            q = qkv[..., :H * 128].unflatten(-1, (H, 128))
            k, v = (torch.randn((B, T, Hkv, 128), generator=g, device=dev).to(dtype) for _ in "kv")
            do = torch.randn((B, S, H, 128), generator=g, device=dev).to(dtype)
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if rpad:
                mask[1, T - rpad:] = 0
            mask[:, :lpad] = 0
            kw = dict(window=window)
            out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, **kw)
            ro, rl = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, kernels=False, **kw)
            delta = tfa.attention_delta(ro, do)
            dk, dv = tfa.flash_bwd_dkdv(q, k, v, mask, do, rl, delta, q_off, **kw)
            dq = tfa.flash_bwd_dq(q, k, v, mask, do, rl, delta, q_off, **kw)
            pq, pk, pv = tfa.flash_backward(q, k, v, mask, ro, rl, do, q_off, kernels=False, **kw)
            torch.cuda.synchronize()
            ref32 = dict(out=ro, dq=pq, dk=pk, dv=pv)
            if dtype == torch.bfloat16:  # the plain version on the same values in fp32
                f = [t.float() for t in (q, k, v, do)]
                o32, l32 = tfa.flash_prefill_with_lse(*f[:3], mask, q_off, kernels=False, **kw)
                g32 = tfa.flash_backward(*f[:3], mask, o32, l32, f[3], q_off, kernels=False, **kw)
                ref32 = dict(out=o32, dq=g32[0], dk=g32[1], dv=g32[2])
            pos = q_off + torch.arange(S, device=dev)
            lo = (pos - (window or T) + 1).clamp_min(0)
            cum = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                             mask.long().cumsum(1)], 1)
            live = cum[:, (pos + 1).clamp_max(T)] - cum[:, lo] > 0  # rows that see a key
            tag = f"{name} {str(dtype)[6:]}"
            err_o = compare_training(f"out {tag}", out, ro, ref32["out"], dtype, live)
            err_l = compare(f"lse {tag}", lse.transpose(1, 2), rl.transpose(1, 2),
                            torch.float32, live)
            errs = [compare_training(f"{w} {tag}", a, b, ref32[w], dtype)
                    for w, a, b in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv))]
            if not live.all() and (dq.float()[~live] != 0).any():
                raise AssertionError(f"dq {tag}: rows that see no key are not zero")
            worst["flash_prefill_with_lse"] = max(worst["flash_prefill_with_lse"], err_o, err_l)
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[0])
            worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"], errs[1], errs[2])
            log("kernels", f"training {tag}: max |diff| out {err_o:.3e}, lse {err_l:.3e}, "
                           f"dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}"
                           + ("" if live.all() else f"; {int((~live).sum())} rows see no key: "
                              "finite, dq = 0"))
            del qkv, q, k, v, do, out, lse, ro, rl, delta, dk, dv, dq, pq, pk, pv, ref32
            torch.cuda.empty_cache()
    return worst


def check_bf16_rounding(dev) -> str:
    """The served bf16 path rounds as the JAX package does. A dense layer
    adds its bias to the fp32 sum before its one rounding to bf16, with bf16
    and with fp32 parameters; the tied head returns the fp32 sum itself.
    Checked at the 1B decoder's c_attn shape for a decode step (4 rows) and a
    prefill (4 x 261 rows), and at the head's, against float64 sums."""
    from starvector_tpu_torch.ops.layers import DTypePolicy, dense, matmul_f32

    g = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((2048, 2304), generator=g, device=dev) * 0.02
    b = torch.rand((2304,), generator=g, device=dev) + 1.0  # dwarfs x @ w: a bf16 bias shows
    parts = []
    for rows in (4, 4 * 261):
        x = torch.randn((rows, 2048), generator=g, device=dev).bfloat16()
        for pdt in (torch.bfloat16, torch.float32):
            wp, bp = w.to(pdt), b.to(pdt)
            y = dense({"kernel": wp, "bias": bp}, x, DTypePolicy(pdt, torch.bfloat16))
            ref = (x.double() @ wp.bfloat16().double() + bp.double()).bfloat16().double()
            diff = (y.double() - ref).abs()
            exact = (diff == 0).double().mean().item()
            # off by one bf16 step where the fp32 and float64 sums straddle a
            # rounding boundary, or by the fp32 sum's own error (~1e-6 over
            # 2048 terms) where the sum cancels to near zero
            if y.dtype != torch.bfloat16 or exact < 0.99 or (diff > ref.abs() * 2**-7 + 1e-4).any():
                raise AssertionError(f"dense rows={rows} {pdt} params: {y.dtype}, equal to the "
                                     f"rounded float64 sum on {exact:.4f}, max |diff| {diff.max():.3e}")
            parts.append(f"dense rows={rows} {str(pdt)[6:]} params {exact:.5f}")
    wte = (torch.randn((49152, 2048), generator=g, device=dev) * 0.02).bfloat16()
    x = torch.randn((4, 2048), generator=g, device=dev).bfloat16()
    logits = matmul_f32(x, wte.T)
    ref = x.double() @ wte.double().T
    err = (logits.double() - ref).abs().max().item()
    in_bf16 = (logits == logits.bfloat16().float()).double().mean().item()
    if logits.dtype != torch.float32 or in_bf16 > 0.05 or err > 1e-5 * ref.abs().max().item():
        raise AssertionError(f"head logits {logits.dtype}: {in_bf16:.4f} are bf16 values, "
                             f"max |diff| from float64 {err:.3e}")
    return (f"share equal to the float64 sum rounded once: {', '.join(parts)}; head logits fp32, "
            f"{in_bf16:.5f} of them bf16 values, max |diff| from float64 {err:.3e} "
            f"(max |logit| {ref.abs().max().item():.3f})")


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def synthetic_images(n: int, seed: int) -> list[np.ndarray]:
    """uint8 RGB images of assorted sizes: a gradient with a few flat
    rectangles, like a rendered icon."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(s) for s in rng.integers(180, 420, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 255 // w), (yy * 255 // h), np.full_like(xx, 200)], -1)
        for _ in range(3):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
        out.append(img.astype(np.uint8))
    return out


def full_width_params(sv, cfg, dev, dtype, seed: int = 0) -> dict:
    params = sv.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
                            dtype=dtype)
    for grp in (params["svg_transformer"]["layers"]["attn"], params["svg_transformer"]["layers"]["mlp"]):
        for p in grp.values():
            p["kernel"].mul_(PROJ_SCALE)
    return params


KERNEL_CLASSES = (  # (label, substrings of the CUDA kernel's name), first match wins
    ("decode_attention", ("decode_attention_kernel",)),
    ("flash_prefill", ("flash_prefill_kernel",)),
    ("GEMM/GEMV (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")),
    ("layer_norm", ("layer_norm",)),
)


def profile_request(request, card: str, out_dir: Path) -> None:
    """Where the device time of a B=4, 128-token greedy request goes:
    torch.profiler traces the whole request and a prefill-only request
    (max_new_tokens=1); their difference over the decode steps is the
    per-step cost. The wall times come from the same requests run just
    before without the profiler, whose own host cost would inflate them.
    Writes both kernel tables to out_dir and prints the per-step wall time,
    device time, busy share and kernel classes."""
    from torch.profiler import ProfilerActivity, profile

    images = synthetic_images(4, 21)

    def traced(**kw):
        _, _, wall = request(images, **kw)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, lengths, _ = request(images, **kw)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        by_class: dict[str, float] = {}
        for e in rows:
            label = next((lab for lab, keys in KERNEL_CLASSES
                          if any(k in e.key.lower() for k in keys)), "other")
            by_class[label] = by_class.get(label, 0.0) + e.self_device_time_total / 1e3
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
        return int(lengths.max()), wall * 1e3, by_class, table

    steps, wall, full, table_full = traced()
    _, wall0, prefill, table_prefill = traced(max_new_tokens=1)
    if not sum(full.values()):
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_im2svg.txt").write_text(
        f"{card}\nB=4, 128 new tokens greedy\n{table_full}\n\n"
        f"B=4, prefill only (max_new_tokens=1)\n{table_prefill}\n")
    n = steps - 1
    per_step = {k: (full.get(k, 0.0) - prefill.get(k, 0.0)) / n for k in full}
    dev_step, wall_step = sum(per_step.values()), (wall - wall0) / n
    shares = ", ".join(f"{k} {v * 1e3:.1f} us ({v / dev_step:.1%})"
                       for k, v in sorted(per_step.items(), key=lambda kv: -kv[1]))
    log("profile", f"{card}: B=4 decode step ({n} steps, tables in "
                   f"{out_dir / 'profile_im2svg.txt'}): wall {wall_step:.3f} ms without the "
                   f"profiler, device {dev_step:.3f} ms under it, busy {dev_step / wall_step:.1%}; "
                   f"device time per step: {shares}")
    log("profile", f"{card}: B=4 image+prefill+first token: wall "
                   f"{wall0:.1f} ms, device {sum(prefill.values()):.3f} ms: "
                   + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(prefill.items(),
                                                                   key=lambda kv: -kv[1])))


# ---------------------------------------------------------------------------
# phase 4, int8: quantized decoder weights and an int8 KV cache
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def quantized(params: dict) -> dict:
    """params with the decoder quantized as from_pretrained(quantize=True)
    does (quantize_tree at its default threshold, decoder only);
    consume=False keeps the source tree for the comparisons."""
    from starvector_tpu_torch.ops.quantization import quantize_tree

    return {**params, "svg_transformer": quantize_tree(params["svg_transformer"], consume=False)}


def int8_requester(model, cfg, params, policy, dev, kernels: bool = True):
    """request(images, max_new_tokens=128) -> (tokens, lengths, seconds):
    the model's processor, the im2svg prefix, then engine.generate with an
    int8 KV cache (kv_cache_dtype=torch.int8) and the API's greedy
    generation config, host clock around a synchronised request."""
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix

    def request(images, max_new_tokens: int = 128, prompt_ids=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = model.process_images(images)
        prompt = torch.tensor([PROMPT_IDS] * len(images), device=dev)
        emb, mask = im2svg_prefix(params, cfg, x, prompt, policy=policy)
        gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                               stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
        tokens, lengths = generate(params["svg_transformer"], cfg.llm, emb, mask, gen,
                                   prompt_ids=prompt, policy=policy, kernels=kernels,
                                   kv_cache_dtype=torch.int8)
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def int8_slice(model, tfa, cfg, p16, p32, dev) -> dict:
    """StarVector-1B with the decoder's projections in int8 (quantize_tree)
    and an int8 KV cache: 3 requests of 4 images, greedy, 128 new tokens,
    with exact launch counts; then fp32 greedy ids kernels vs plain, bf16
    prefill logits against the fp32 plain int8 path, and the share of
    greedy tokens on which int8 agrees with bf16 (random weights: printed,
    not checked)."""
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import gpt_bigcode
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    q16 = quantized(p16)
    request = int8_requester(model, cfg, q16, bf16, dev)
    request(synthetic_images(4, 99))  # warm-up
    reset_counts(tfa)
    served = [request(synthetic_images(4, seed)) for seed in range(3)]
    counts = read_counts(tfa)
    steps = [int(lengths.max()) - 1 for _, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape != (4, 128) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"int8: bad tokens {tuple(tokens.shape)} [{tokens.min()}, {tokens.max()}]")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"int8: bad lengths {lengths.tolist()}")
    n = sum(steps)
    expected = {"quant_matmul": 4 * L * (3 + n), "quant_matmul_gemv": 4 * L * n,
                "quant_matmul_mma": 4 * L * 3, "quant_matmul_f32_tile": 0,
                "flash_prefill": L * 3, "decode_attention": L * n, "decode_attention_int8": L * n,
                **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"int8 launches {got}, expected {expected}")
    log("slice", f"int8 weights + int8 KV cache, 3 requests x 4 images, greedy, 128 new tokens: "
                 f"decode steps {steps}, lengths {[l.tolist() for _, l, _ in served]}; launches "
                 f"quant_matmul {got['quant_matmul']} = 96 x ({3} prefills + {n} decode steps) "
                 f"(GEMV {got['quant_matmul_gemv']}, tile {got['quant_matmul_mma']}), int8 "
                 f"decode_attention {got['decode_attention_int8']} = {L} x {n}, flash_prefill "
                 f"{got['flash_prefill']} = {L} x 3, no training kernel")

    # fp32: greedy ids with the kernels against the plain versions
    q32 = quantized(p32)
    ids = {k: int8_requester(model, cfg, q32, f32, dev, kernels=k)(
        synthetic_images(2, 7), max_new_tokens=32)[0] for k in (True, False)}
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"int8 fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    log("slice", f"int8 fp32, B=2, 32 tokens: greedy ids with the kernels == with the plain "
                 f"versions ({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row)")
    del q32

    # bf16: prefill last-position logits against the fp32 plain int8 path
    images = model.process_images(synthetic_images(4, 11))
    prompt = torch.tensor([PROMPT_IDS] * 4, device=dev)

    def prefill_logits(params, policy, kernels):
        emb, mask = im2svg_prefix(params, cfg, images, prompt, policy=policy)
        cache = gpt_bigcode.init_cache(cfg.llm, 4, emb.shape[1], dtype=torch.int8, device=dev)
        return gpt_bigcode.forward(params["svg_transformer"], cfg.llm, emb, mask, cache=cache,
                                   policy=policy, last_logits_only=True, kernels=kernels)[0]

    ref32 = prefill_logits(_cast_tree(q16, torch.float32), f32, False)  # the same codes
    logits = {k: prefill_logits(q16, bf16, k) for k in (True, False)}
    err_k = (logits[True] - ref32).abs().max().item()
    err_p = (logits[False] - ref32).abs().max().item()
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"int8 bf16 prefill logits: kernels {err_k:.3e} from the fp32 "
                             f"plain int8 path, over twice the plain bf16 version's {err_p:.3e}")
    toks16 = model.generate_im2svg_ids({"image": images}, prompt_ids=[PROMPT_IDS] * 4,
                                       stop_sequences=STOP_IDS, max_new_tokens=128,
                                       use_nucleus_sampling=False)[1]
    toks8 = request(synthetic_images(4, 11))[0]
    agree = (toks8 == toks16).float().mean().item()
    log("slice", f"int8 bf16, B=4: prefill last-position logits from the fp32 plain int8 path "
                 f"(max |logit| {ref32.abs().max().item():.3e}): kernels {err_k:.4e}, plain "
                 f"{err_p:.4e} (bound: kernels <= 2 x plain + 1e-3); greedy tokens of the int8 "
                 f"path agree with the bf16 path's on {agree:.4f} of 4x128 positions (random "
                 f"weights: a printed figure, not a check)")
    return dict(counts=got, request=request, params=q16)


def serving_times(card: str, requests: dict, rounds: int = 2) -> dict:
    """For each model: p50 B=1 image -> SVG latency, and B=4 decode
    tokens/s from full and prefill-only (max_new_tokens=1) requests. The
    models take turns in the order a, b, b, a in each round, so that the
    host's drift within the call falls on both alike."""
    labels = list(requests)
    t = {label: dict(b1=[], tokens=[], full=[], prefill=[], steps=[]) for label in labels}
    slot = 0
    for _ in range(rounds):
        for label in labels + labels[::-1]:
            request, rec = requests[label], t[label]
            _, lengths, secs = request(synthetic_images(1, 100 + slot), prompt_ids=[PROMPT_IDS])
            rec["b1"].append(secs)
            rec["tokens"].append(int(lengths.max()))
            _, lengths, secs = request(synthetic_images(4, 200 + slot))
            rec["full"].append(secs)
            rec["steps"].append(int(lengths.max()) - 1)
            rec["prefill"].append(request(synthetic_images(4, 200 + slot), max_new_tokens=1)[2])
            slot += 1
    out = {}
    for label in labels:
        rec = t[label]
        p50 = statistics.median(rec["b1"])
        full, prefill = statistics.median(rec["full"]), statistics.median(rec["prefill"])
        rate = 4 * statistics.median(rec["steps"]) / (full - prefill)
        log("times", f"{card}: {label}: p50 image->SVG latency, B=1, 128 new tokens greedy: "
                     f"{p50 * 1e3:.1f} ms ({len(rec['b1'])} requests: "
                     f"{[round(x * 1e3, 1) for x in rec['b1']]} ms, tokens {rec['tokens']}); decode "
                     f"{rate:.1f} tokens/s at B=4 (request {full * 1e3:.1f} ms of "
                     f"{[round(x * 1e3, 1) for x in rec['full']]}, image+prefill+first token "
                     f"{prefill * 1e3:.1f} ms, decode steps {rec['steps']})")
        out[label] = dict(p50=p50, rate=rate)
    return out


def memory_times(card: str, requests: dict, trees: dict) -> None:
    """Each model's weights and its peak device memory above them during a
    B=4, 128-token request."""
    images = synthetic_images(4, 50)
    parts = []
    for label, request in requests.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        request(images)
        peak = torch.cuda.max_memory_allocated() - base
        params = trees[label]
        parts.append(f"{label}: decoder weights {tree_bytes(params['svg_transformer']) / 2**30:.3f}"
                     f" GiB, all weights {tree_bytes(params) / 2**30:.3f} GiB, request peak above "
                     f"them {peak / 2**20:.1f} MiB")
    log("times", f"{card}: memory, B=4 request with 128 new tokens: " + "; ".join(parts))


def library_ms(fn, what: str, timer=None):
    """Device ms of one PyTorch library call that computes a kernel's
    function (a yardstick: the port never calls it), or None, with the
    reason logged, where this torch has no such call for the card. Only the
    probe call is guarded; a failure while timing raises."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log("times", f"{what}: no such call on this card's torch ({str(e).splitlines()[0][:160]})")
        return None
    return (timer or cuda_ms)(fn)


def event_ms(fn, iters: int = 20) -> float:
    """ms per eager fn() call between two CUDA events (for the autograd
    backward, which is not captured in a graph): the host's per-op cost is
    small beside a millisecond of device work."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa_causal(S: int, T: int) -> dict:
    """SDPA's causal arguments with the last of S queries on the last of T
    keys (the kernels' q_offset = T - S)."""
    from torch.nn.attention.bias import causal_lower_right

    return dict(is_causal=True) if S == T else dict(attn_mask=causal_lower_right(S, T))


def sdpa_ms(q, k, v, causal: bool):
    """F.scaled_dot_product_attention (its flash or memory-efficient
    backend) on (B, H, S, D) queries over (B, H, T, D) keys, K/V expanded to
    all heads; causal with the last query on the last key (lower right,
    which is top left when S = T)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = _sdpa_causal(q.shape[2], k.shape[2]) if causal else {}

    def fn():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, **mask)

    return library_ms(fn, "scaled_dot_product_attention")


def quant_matmul_times(tq, dev, card: str, launches: dict, errs: dict) -> list[dict]:
    """Kernel 14 against its plain version, the library's int8 weight
    matmul (torch._weight_int8pack_mm, where this torch has it for CUDA) and
    the bf16 cuBLAS addmm, at M = 4 (decode) and 1040 (prefill) for the four
    projections, bf16 x with a bf16 bias, each beside its bound. The JSON
    rows are mlp.c_fc's, the largest."""
    g = torch.Generator(device=dev).manual_seed(10)
    rows = []
    for M, path in ((4, "gemv"), (1040, "tile")):
        total = dict(ms=0.0, plain=0.0, addmm=0.0, bound=0.0)
        for name, K, N in QMM_SHAPES:
            p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
            kq, sc = p["kernel_q"], p["scale"]
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            b = torch.randn((N,), generator=g, device=dev).bfloat16()
            plain_ms, ms = _turns(
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16, kernels=False),
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16))
            w16 = (kq.float() * sc).bfloat16()
            addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w16))
            kq_nk, sc16 = kq.t().contiguous(), sc.bfloat16()
            lib = library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                             "torch._weight_int8pack_mm")
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, 2 * M * K * N)
            for key, val in (("ms", ms), ("plain", plain_ms), ("addmm", addmm_ms), ("bound", b_ms)):
                total[key] += val
            log("times", f"{card}: quant_matmul {path} {name} M={M} K={K} N={N} bf16: kernel "
                         f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                         f"int8pack_mm {'n/a' if lib is None else f'{lib:.4f} ms'}, bf16 addmm "
                         f"{addmm_ms:.4f} ms (reads 2 bytes a weight)")
            if name == "mlp.c_fc":
                rows.append(dict(name=f"quant_matmul_{path}", route="cuda",
                                 source="starvector_tpu_torch/csrc/quant_matmul.cu",
                                 replaces="starvector_tpu/ops/quantization.py:139",
                                 launches=launches[path], max_abs_err=errs[path], ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib if lib is not None else addmm_ms))
        log("times", f"{card}: quant_matmul {path}, M={M}, one layer's four projections: kernel "
                     f"{total['ms']:.4f} ms, plain {total['plain']:.4f} ms, bf16 addmm "
                     f"{total['addmm']:.4f} ms, bound {total['bound']:.4f} ms; x 24 layers: "
                     f"kernel {24 * total['ms']:.3f} ms, bf16 addmm {24 * total['addmm']:.3f} ms")
    return rows


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS, LR = 8, 1e-4
SVG_LENGTHS = (512, 431, 300, 187)  # ragged rows; the longest sets T = 257 + 512


def training_batch(cfg, process_images, dev, seed: int = 0) -> dict:
    """One batch in the loader's format, from a seeded numpy generator:
    CLIP-normalised images (4, 224, 224, 3), svg ids in the vocabulary,
    right-padded to the longest row."""
    rng = np.random.default_rng(seed)
    B, S = len(SVG_LENGTHS), max(SVG_LENGTHS)
    ids = rng.integers(0, cfg.llm.vocab_size, (B, S))
    mask = (np.arange(S)[None, :] < np.asarray(SVG_LENGTHS)[:, None]).astype(np.int32)
    return {"image": process_images(synthetic_images(B, 1000 + seed)),
            "svg_ids": np.where(mask > 0, ids, 0), "svg_mask": mask}


def _optimizer(params):
    """AdamW with configs/models/default.yaml's betas, eps, weight decay and
    clip, at lr 1e-4 without warmup (its 500 warmup steps would give these
    few steps almost no learning rate); cosine over its 100000 steps."""
    from starvector_tpu_torch.train.optim import build_optimizer

    return build_optimizer(params, lr=LR, warmup_steps=0, betas=(0.95, 0.999), eps=1e-8,
                           weight_decay=1e-6, grad_clip=1.0, total_steps=100_000)


def _run_training(sv, tfa, cfg, dev, batch, steps: int, policy, kernels: bool = True,
                  hook=None):
    """`steps` steps of the port's train loop from fresh seeded weights;
    (params, per-step records of loss, grad_norm, wall time and launches).
    `hook(step)` runs after each step's record."""
    from starvector_tpu_torch.train.train import train_loop

    params = sv.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    recs = []
    t_last = [time.perf_counter()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        recs.append(dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                         seconds=now - t_last[0], launches=read_counts(tfa)))
        if hook is not None:
            hook(step)
        t_last[0] = time.perf_counter()

    torch.cuda.synchronize()
    t_last[0] = time.perf_counter()
    params, _, _ = train_loop(params, cfg, _optimizer(params),
                              ((0, batch) for _ in range(steps)), total_steps=steps, device=dev,
                              policy=policy, remat="dots_flash", kernels=kernels,
                              on_step=on_step)
    return params, recs


def train_slice(sv, tfa, dev, process_images) -> dict:
    """8 steps of full-width 1B training on one fixed batch (overfitting
    it): fp32 master weights, bf16 compute, dots_flash. Checks the loss
    falls, every value is finite, and each step launched each training
    kernel once per layer."""
    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = sv.starvector_1b_config()
    L = cfg.llm.n_layer
    batch = training_batch(cfg, process_images, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # the inference phases' weights, still held
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tfa)
    _, recs = _run_training(sv, tfa, cfg, dev, batch, TRAIN_STEPS,
                            DTypePolicy(torch.float32, torch.bfloat16))
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    per_step = [{k: b[k] - a[k] for k in TRAIN_KERNELS}
                for a, b in zip([dict.fromkeys(TRAIN_KERNELS, 0)] + [r["launches"] for r in recs],
                                [r["launches"] for r in recs])]
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses}, grad norms {norms}")
    if any(n != {k: L for k in TRAIN_KERNELS} for n in per_step) or \
            counts["flash_prefill"] or counts["decode_attention"] or counts["quant_matmul"]:
        raise AssertionError(f"training launches per step {per_step}, in all {counts}")
    T = 257 + max(SVG_LENGTHS)
    log("train", f"StarVector-1B at full width, B={len(SVG_LENGTHS)}, T={T} (svg lengths "
                 f"{list(SVG_LENGTHS)}), fp32 masters / bf16 compute, dots_flash, AdamW lr {LR}: "
                 f"{TRAIN_STEPS} steps on one batch, loss {[round(x, 4) for x in losses]}, "
                 f"grad_norm {[round(x, 4) for x in norms]}; launches per step "
                 f"{per_step[0]} (each = {L} layers), in all {counts}; peak memory "
                 f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
                 f"{base / 2**30:.2f} GiB held before the first step")
    return dict(recs=recs, counts=counts, T=T, B=len(SVG_LENGTHS), peak=peak, base=base)


def fp32_check(sv, tfa, dev, process_images) -> None:
    """From the same weights and batch, 2 fp32 steps with the kernels and 2
    with the plain attention. Bound on the updated weights: each AdamW step
    moves an element by at most about lr (the first by exactly lr x sign),
    so elements whose gradient is rounding noise may differ by up to
    2 lr a step; the bound is 3 lr x steps."""
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import tree_leaves

    cfg = sv.starvector_1b_config()
    batch = training_batch(cfg, process_images, dev)
    f32 = DTypePolicy(torch.float32, torch.float32)
    p_k, r_k = _run_training(sv, tfa, cfg, dev, batch, 2, f32, kernels=True)
    p_k = [t.detach() for t in tree_leaves(p_k)]
    p_p, r_p = _run_training(sv, tfa, cfg, dev, batch, 2, f32, kernels=False)
    diffs = [(a - b.detach()).abs() for a, b in zip(p_k, tree_leaves(p_p))]
    max_diff = max(d.max().item() for d in diffs)
    n = sum(d.numel() for d in diffs)
    close = sum((d <= 1e-6).sum().item() for d in diffs) / n
    bound = 3 * LR * 2
    for a, b in zip(r_k, r_p):
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or \
                abs(a["grad_norm"] - b["grad_norm"]) > 1e-3 * abs(b["grad_norm"]):
            raise AssertionError(f"fp32 training: kernels {r_k}, plain {r_p}")
    if max_diff > bound:
        raise AssertionError(f"fp32 training: updated weights differ by {max_diff:.3e} > {bound}")
    log("train", f"fp32, 2 steps, kernels vs plain attention: loss "
                 f"{[r['loss'] for r in r_k]} vs {[r['loss'] for r in r_p]} (rtol 1e-4), "
                 f"grad_norm {[r['grad_norm'] for r in r_k]} vs {[r['grad_norm'] for r in r_p]} "
                 f"(rtol 1e-3); updated weights: max |diff| {max_diff:.3e} (bound 3 lr x 2 steps "
                 f"= {bound:.1e}), {close:.6f} of {n} elements within 1e-6")
    del p_k, p_p, diffs
    torch.cuda.empty_cache()


TRAIN_KERNEL_CLASSES = (  # (label, substrings of the CUDA kernel's name), first match wins
    ("flash_bwd_dkdv", ("flash_bwd_dkdv_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_prefill_with_lse", ("flash_prefill_kernel",)),
    ("GEMM (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")),
    ("layer_norm", ("layer_norm",)),
)


def profile_train_step(sv, tfa, dev, process_images, card: str, step_wall: float,
                       out_dir: Path) -> None:
    """Where one full-width train step's device time goes: torch.profiler
    traces the 4th step of a fresh run (3 of warm-up); the wall time is
    phase 5's unprofiled median. Writes the kernel table to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = sv.starvector_1b_config()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def hook(step):
        if step == 3:
            prof.start()
        elif step == 4:
            prof.stop()

    _run_training(sv, tfa, cfg, dev, training_batch(cfg, process_images, dev), 4,
                  DTypePolicy(torch.float32, torch.bfloat16), hook=hook)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_class: dict[str, float] = {}
    for e in rows:
        label = next((lab for lab, keys in TRAIN_KERNEL_CLASSES
                      if any(k in e.key.lower() for k in keys)), "other")
        by_class[label] = by_class.get(label, 0.0) + e.self_device_time_total / 1e3
    device = sum(by_class.values())
    if not device:
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_train.txt").write_text(
        f"{card}\nStarVector-1B train step, B=4 T=769, bf16 compute, dots_flash\n"
        + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    log("profile", f"{card}: 1B train step (tables in {out_dir / 'profile_train.txt'}): wall "
                   f"{step_wall * 1e3:.1f} ms without the profiler, device {device:.1f} ms under "
                   f"it, busy {device / step_wall / 1e3:.1%}; device time: "
                   + ", ".join(f"{k} {v:.1f} ms ({v / device:.1%})"
                               for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))


def training_times(tfa, dev, card: str, train: dict, errs: dict) -> list[dict]:
    """Train step wall time and tokens/s from phase 5 (median of the 5 steps
    after 3 of warm-up), and the training kernels' device times against
    their plain versions at the 1B training shape in bf16."""
    secs = [r["seconds"] for r in train["recs"][3:]]
    step = statistics.median(secs)
    B, T = train["B"], train["T"]
    log("times", f"{card}: train step B={B} T={T} (1B, bf16 compute, dots_flash): "
                 f"{step * 1e3:.1f} ms median of {len(secs)} steps after 3 of warm-up "
                 f"({[round(x * 1e3, 1) for x in secs]} ms), {B * T / step:.0f} tokens/s, peak "
                 f"memory {train['peak'] / 2**30:.2f} GiB ({(train['peak'] - train['base']) / 2**30:.2f}"
                 f" GiB above the inference weights held before it)")
    g = torch.Generator(device=dev).manual_seed(7)
    H, D = 16, 128
    qkv = torch.randn((B, T, (H + 2) * D), generator=g, device=dev).bfloat16()
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k, v = (qkv[..., (H + i) * D:(H + i + 1) * D].unflatten(-1, (1, D)) for i in (0, 1))
    do = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    out, lse = tfa.flash_prefill_with_lse(q, k, v, mask)
    delta = tfa.attention_delta(out, do)
    shape = f"B={B} S=T={T} H=16 Hkv=1 D=128 bf16"
    # yardsticks: the flash forward op that also returns the logsumexp, and
    # SDPA's backward (dq, dk and dv in one op, against dkdv + dq), on
    # (B, H, T, D) copies with K/V expanded to the 16 heads
    qh, kh, vh, doh = (t.transpose(1, 2).expand(B, H, T, D).contiguous() for t in (q, k, v, do))
    lib_fwd = library_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qh, kh, vh, 0.0, True), "aten._scaled_dot_product_flash_attention")
    lib_bwd = sdpa_backward_ms(qh, kh, vh, doh)
    pairs = B * T * (T + 1) // 2 * H  # (query, key) pairs under the causal mask, all heads
    act, kv, stats = B * T * H * D * 2, B * T * D * 2, B * H * T * 4  # bytes of one of each
    rows = []
    for name, fn, replaces, nbytes, flops, lib in (
            ("flash_prefill_with_lse", lambda kn: tfa.flash_prefill_with_lse(q, k, v, mask,
                                                                             kernels=kn), 330,
             2 * act + 2 * kv + stats + B * T * 4, 4 * D * pairs, lib_fwd),
            ("flash_bwd_dkdv", lambda kn: tfa.flash_bwd_dkdv(q, k, v, mask, do, lse, delta,
                                                             kernels=kn), 968,
             2 * act + 4 * kv + 2 * stats + B * T * 4, 8 * D * pairs, lib_bwd),
            ("flash_bwd_dq", lambda kn: tfa.flash_bwd_dq(q, k, v, mask, do, lse, delta,
                                                         kernels=kn), 968,
             3 * act + 2 * kv + 2 * stats + B * T * 4, 6 * D * pairs, lib_bwd)):
        plain_ms, ms = _turns(lambda: fn(False), lambda: fn(True))
        b_ms, b_by = bound(nbytes, flops)
        log("times", f"{card}: {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
                     f"GFLOP), library {'n/a' if lib is None else f'{lib:.4f} ms'}")
        src = "flash_prefill.cu" if name == "flash_prefill_with_lse" else "flash_backward.cu"
        rows.append(dict(name=name, route="cuda", source=f"starvector_tpu_torch/csrc/{src}",
                         replaces=f"starvector_tpu/ops/flash_attention.py:{replaces}",
                         launches=train["counts"][name], max_abs_err=errs[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


def sdpa_backward_ms(q, k, v, do, iters: int = 20):
    """SDPA's backward (flash or memory-efficient backend) on (B, H, S, D)
    queries over (B, H, T, D) keys, causal with the last query on the last
    key (lower right, which is top left when S = T): one autograd call
    giving dq, dk and dv."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, T = q.shape[2], k.shape[2]
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    mask = _sdpa_causal(S, T)
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(qr, kr, vr, **mask)
    except RuntimeError as e:
        log("times", f"scaled_dot_product_attention at S={S}, T={T}: no backend "
                     f"({str(e).splitlines()[0][:160]})")
        return None
    return library_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True),
                      "scaled_dot_product_attention backward",
                      timer=lambda fn: event_ms(fn, iters))


LONG_CASES = (  # the TPU backward variants' contracts that phase 3 drives: name, rows, B, S, T, H, q_offset
    ("8k context", "8 (one-pass tri)", 1, 8450, 8450, 16, 0),
    ("8k SP chunk, S=1024 at q_offset=7426", "4 (rect fwd), 7 (dq partials), 9 (one-pass)",
     1, 1024, 8450, 16, 7426),
    ("16k SP chunk, S=1024 at q_offset=15618", "12, 13 (split dq, dkv)", 1, 1024, 16642, 16, 15618),
    ("16k context, H=2", "10, 11 (split tri dq, dkv)", 1, 16642, 16642, 2, 0),
)


def long_context_times(tfa, dev, card: str) -> None:
    """The training kernels at the long-context contracts of the TPU's other
    backward variants (kernel table rows 4, 7-13), bf16: each kernel, the
    plain versions and SDPA (forward, and its backward against dkdv + dq),
    each beside its bound. Eager calls between CUDA events (3 after 3 of
    warm-up): each is milliseconds to seconds of device work, and the plain
    version's (H, S, T) fp32 blocks are too large to capture 50 of in a
    graph."""
    g = torch.Generator(device=dev).manual_seed(12)
    D = 128
    timer = functools.partial(event_ms, iters=3)
    for name, rows, B, S, T, H, q_off in LONG_CASES:
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off)
        delta = tfa.attention_delta(out, do)
        t = {"fwd": timer(lambda: tfa.flash_prefill_with_lse(q, k, v, mask, q_off)),
             "dkdv": timer(lambda: tfa.flash_bwd_dkdv(q, k, v, mask, do, lse, delta, q_off)),
             "dq": timer(lambda: tfa.flash_bwd_dq(q, k, v, mask, do, lse, delta, q_off)),
             "plain fwd": timer(lambda: tfa.flash_prefill_with_lse(q, k, v, mask, q_off,
                                                                   kernels=False)),
             "plain bwd": timer(lambda: tfa.flash_backward(q, k, v, mask, out, lse, do, q_off,
                                                           kernels=False))}
        torch.cuda.empty_cache()
        qh, doh = (x.transpose(1, 2).contiguous() for x in (q, do))
        kh, vh = (x.transpose(1, 2).expand(B, H, T, D).contiguous() for x in (k, v))
        t["SDPA fwd"] = sdpa_ms(qh, kh, vh, causal=True)
        t["SDPA bwd"] = sdpa_backward_ms(qh, kh, vh, doh, iters=3)
        pairs = B * H * (S * q_off + S * (S + 1) // 2)
        act, kv, stats, m = B * S * H * D * 2, B * T * D * 2, B * H * S * 4, B * T * 4
        bounds = {"fwd": bound(2 * act + 2 * kv + stats + m, 4 * D * pairs),
                  "dkdv": bound(2 * act + 4 * kv + 2 * stats + m, 8 * D * pairs),
                  "dq": bound(3 * act + 2 * kv + 2 * stats + m, 6 * D * pairs)}
        log("times", f"{card}: long context {name} (kernel table rows {rows}), B={B} H={H} "
                     f"Hkv=1 D=128 bf16: " + ", ".join(
                         f"{k_} {'n/a' if v_ is None else f'{v_:.3f} ms'}" for k_, v_ in t.items())
                     + "; bounds " + ", ".join(f"{k_} {b_[0]:.4f} ms ({b_[1]})"
                                               for k_, b_ in bounds.items()))
        del q, k, v, do, out, lse, delta, qh, kh, vh, doh
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="also trace a B=4 request and a train step with torch.profiler "
                             "and write the kernel tables to DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on an H100", file=sys.stderr)
        return 2
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import decode_common as dc
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import kernel_lib
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    dev = torch.device("cuda")
    # --- 1. card -------------------------------------------------------------
    card = card_line()
    nvcc = subprocess.run([kernel_lib.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{card} | torch {torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc} | "
                f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernel_lib.library()
    built = kernel_lib.build_seconds()
    sources = sorted(p.name for p in kernel_lib.CSRC_DIR.glob("*.cu"))
    log("build", f"{kernel_lib.library_path().name} from {len(sources)} CUDA sources "
                 f"({', '.join(sources)}): "
                 f"{'built in %.1f s' % built if built is not None else 'reused'} "
                 f"(load {time.perf_counter() - t0:.1f} s); ptxas per kernel: "
                 + "; ".join(ptxas_summary(kernel_lib.build_log())))

    # --- 3. kernels against their plain versions --------------------------------
    err_prefill = check_flash_prefill(tfa, dev)
    err_decode = check_decode_attention(tfa, dev)
    log("kernels", f"both kernels match their plain versions (tolerance atol=rtol 1e-4 in "
                   f"fp32, 2e-2 in bf16); max |diff| prefill {err_prefill:.3e}, "
                   f"decode {err_decode:.3e}")
    err_qmm = check_quant_matmul(tq, dev)
    err_int8 = check_int8_decode(tfa, dc, dev)
    log("kernels", f"the int8 kernels match their plain versions (atol=rtol 1e-4 in fp32, 2e-2 "
                   f"in bf16); max |diff| quant_matmul GEMV {err_qmm['gemv']:.3e}, tile "
                   f"{err_qmm['tile']:.3e}, int8-cache decode {err_int8:.3e}")
    err_train = check_training_kernels(tfa, dev)
    log("kernels", "the training kernels match their plain versions (fp32 atol=rtol 1e-4; bf16 "
                   "2e-2, or no more than twice the plain bf16 version's own error from fp32 "
                   "plus 1e-3); max |diff| " + ", ".join(f"{k} {v:.3e}" for k, v in err_train.items()))
    log("rounding", check_bf16_rounding(dev))

    # --- 4. the slice at full width --------------------------------------------
    cfg = sv.starvector_1b_config()
    L = cfg.llm.n_layer
    p32 = full_width_params(sv, cfg, dev, torch.float32)
    p16 = _cast_tree(p32, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    model = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev)
    greedy = dict(prompt_ids=[PROMPT_IDS] * 4, stop_sequences=STOP_IDS, max_new_tokens=128,
                  use_nucleus_sampling=False)

    def request(images, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = {"image": model.process_images(images)}
        _, tokens, lengths = model.generate_im2svg_ids(batch, **{**greedy, **kw})
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    request(synthetic_images(4, 99))  # warm-up: cuBLAS handles, allocator
    reset_counts(tfa)
    served = [request(synthetic_images(4, seed)) for seed in range(3)]
    counts = read_counts(tfa)
    n_prefill, n_decode = counts["flash_prefill"], counts["decode_attention"]
    if any(counts[k] for k in TRAIN_KERNELS + ("quant_matmul", "decode_attention_int8")):
        raise AssertionError(f"bf16 inference launched training or int8 kernels: {counts}")
    steps = [int(lengths.max()) - 1 for _, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape != (4, 128) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"bad tokens {tuple(tokens.shape)} [{tokens.min()}, {tokens.max()}]")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"bad lengths {lengths.tolist()}")
    if n_prefill != L * 3 or n_decode != L * sum(steps):
        raise AssertionError(f"launches: flash_prefill {n_prefill} (expected {L * 3}), "
                             f"decode_attention {n_decode} (expected {L * sum(steps)})")
    distinct = [len(set(row.tolist())) for tokens, _, _ in served for row in tokens]
    log("slice", f"3 requests x 4 images, greedy, 128 new tokens at full 1B width: decode steps "
                 f"{steps}, lengths {[l.tolist() for _, l, _ in served]}, distinct ids per row "
                 f"{distinct}; launches flash_prefill {n_prefill} = {L} x 3 prefills, "
                 f"decode_attention {n_decode} = {L} x {sum(steps)} decode steps")

    # fp32: greedy ids with the kernels against the plain attention
    images = model.process_images(synthetic_images(2, 7))
    ids = {}
    for kernels in (True, False):
        m32 = StarVectorForCausalLM(p32, cfg, policy=f32, device=dev, kernels=kernels)
        _, ids[kernels], _ = m32.generate_im2svg_ids(
            {"image": images}, **{**greedy, "prompt_ids": [PROMPT_IDS] * 2, "max_new_tokens": 32})
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"fp32 greedy ids differ:\n{ids[True].tolist()}\n{ids[False].tolist()}")
    log("slice", f"fp32, B=2, 32 tokens: greedy ids with the kernels == with the plain attention "
                 f"({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row)")

    # bf16: prefill last-position logits and greedy tokens, kernels against plain
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import gpt_bigcode

    images = model.process_images(synthetic_images(4, 11))
    prompt = torch.tensor([PROMPT_IDS] * 4, device=dev)

    def prefill_logits(params, policy, kernels):
        emb, mask = im2svg_prefix(params, cfg, images, prompt, policy=policy)
        cache = gpt_bigcode.init_cache(cfg.llm, 4, emb.shape[1], dtype=policy.compute_dtype,
                                       device=dev)
        return gpt_bigcode.forward(params["svg_transformer"], cfg.llm, emb, mask, cache=cache,
                                   policy=policy, last_logits_only=True, kernels=kernels)[0]

    ref32 = prefill_logits(p32, f32, False)
    logits, toks = {}, {}
    for kernels in (True, False):
        logits[kernels] = prefill_logits(p16, bf16, kernels)
        _, toks[kernels], _ = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev,
                                                    kernels=kernels).generate_im2svg_ids(
            {"image": images}, **greedy)
    diff = (logits[True] - logits[False]).abs().max().item()
    err_k = (logits[True] - ref32).abs().max().item()
    err_p = (logits[False] - ref32).abs().max().item()
    # bound: the kernels may not add more error than bf16 itself does. Both
    # bf16 paths leave the fp32 logits by bf16 rounding compounded over 24
    # layers; the kernels keep P in fp32 where the plain version rounds it.
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"bf16 prefill logits: kernels {err_k:.3e} from fp32, over twice "
                             f"the plain version's {err_p:.3e}")
    agree = (toks[True] == toks[False]).float().mean().item()
    log("slice", f"bf16, B=4: prefill last-position logits, max |diff| kernels vs plain {diff:.4e}; "
                 f"from the fp32 plain logits (max |logit| {ref32.abs().max().item():.3e}): kernels "
                 f"{err_k:.4e}, plain {err_p:.4e} (bound: kernels <= 2 x plain + 1e-3); greedy "
                 f"tokens agree on {agree:.4f} of 4x128 positions")

    # int8 weights and an int8 KV cache
    int8 = int8_slice(model, tfa, cfg, p16, p32, dev)

    # serving times and memory, bf16 and int8 side by side; then the int8
    # tree goes, so that phase 5's peak holds only what training needs
    e2e = serving_times(card, {"bf16": request, "int8": int8["request"]})
    log("times", f"{card}: int8 (weights and KV cache) against bf16: p50 B=1 "
                 f"{e2e['int8']['p50'] * 1e3:.1f} vs {e2e['bf16']['p50'] * 1e3:.1f} ms, B=4 decode "
                 f"{e2e['int8']['rate']:.1f} vs {e2e['bf16']['rate']:.1f} tokens/s")
    memory_times(card, {"bf16": request, "int8": int8["request"]},
                 {"bf16": p16, "int8": int8["params"]})
    int8_counts = int8["counts"]
    del int8
    torch.cuda.empty_cache()

    # --- 5. training at full width ----------------------------------------------
    train = train_slice(sv, tfa, dev, model.process_images)
    fp32_check(sv, tfa, dev, model.process_images)

    # --- 6. kernel times on the card -----------------------------------------
    kernels_json = []
    g = torch.Generator(device=dev).manual_seed(3)
    B, P, T, H, D = 4, 261, 261 + 128, 16, 128
    q = torch.randn((B, P, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
    mask = torch.zeros((B, T), dtype=torch.int32, device=dev)
    mask[:, :P] = 1
    times = _turns(lambda: tfa.flash_prefill(q, k, v, mask, kernels=False),
                   lambda: tfa.flash_prefill(q, k, v, mask))
    # the visible keys are 0..P-1, causal from q_offset 0: SDPA on those
    lib = sdpa_ms(q.transpose(1, 2).contiguous(),
                  *(t[:, :P].transpose(1, 2).expand(B, H, P, D).contiguous() for t in (k, v)),
                  causal=True)
    # q and out, then K/V and the mask over the P keys the causal bound lets
    # the kernel read (the slots from P to T are never visible)
    b_ms, b_by = bound(2 * B * P * H * D * 2 + 2 * B * P * D * 2 + B * P * 4,
                       4 * D * H * B * P * (P + 1) // 2)
    log("times", f"{card}: flash_prefill B=4 S=261 T=389 H=16 Hkv=1 D=128 bf16: kernel "
                 f"{times[1]:.4f} ms, plain {times[0]:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                 f"SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}")
    kernels_json.append(dict(name="flash_prefill", route="cuda",
                             source="starvector_tpu_torch/csrc/flash_prefill.cu",
                             replaces="starvector_tpu/ops/flash_attention.py:212",
                             launches=n_prefill, max_abs_err=err_prefill,
                             ms=times[1], plain_ms=times[0], bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib))
    idx = P + 64  # mid-generation: 64 tokens decoded
    qg = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
    kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
    kc, vc, old = k[:, :idx], v[:, :idx], torch.ones((B, idx), dtype=torch.int32, device=dev)
    times = _turns(lambda: tfa.merged_decode_attention(qg, kn, vn, kc, vc, old, D**-0.5, kernels=False),
                   lambda: tfa.merged_decode_attention(qg, kn, vn, kc, vc, old, D**-0.5))
    # SDPA over the cache and the new token, every key visible
    keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).expand(B, H, idx + 1, D).contiguous()
            for c, n in ((kc, kn), (vc, vn))]
    lib = sdpa_ms(qg.reshape(B, H, 1, D), *keys, causal=False)
    small = 2 * B * H * D * 2 + 2 * B * D * 2 + B * idx * 4  # q, out, k_new, v_new, mask
    b_ms, b_by = bound(2 * B * idx * D * 2 + small, 4 * D * H * B * (idx + 1))
    log("times", f"{card}: decode_attention B=4 T={idx} G=16 D=128 bf16: kernel "
                 f"{times[1]:.4f} ms, plain {times[0]:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                 f"SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}")
    kernels_json.append(dict(name="decode_attention", route="cuda",
                             source="starvector_tpu_torch/csrc/decode_attention.cu",
                             replaces="starvector_tpu/ops/flash_attention.py:2049",
                             launches=n_decode, max_abs_err=err_decode,
                             ms=times[1], plain_ms=times[0], bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib))
    (kq, ks), (vq, vs) = dc.quantize_kv(kc), dc.quantize_kv(vc)
    times = _turns(
        lambda: tfa.merged_decode_attention(qg, kn, vn, kq, vq, old, D**-0.5, ks, vs,
                                            kernels=False),
        lambda: tfa.merged_decode_attention(qg, kn, vn, kq, vq, old, D**-0.5, ks, vs))
    b_ms, b_by = bound(2 * B * idx * D + 2 * B * idx * 4 + small, 4 * D * H * B * (idx + 1))
    log("times", f"{card}: decode_attention int8 cache B=4 T={idx} G=16 D=128, bf16 queries: "
                 f"kernel {times[1]:.4f} ms, plain {times[0]:.4f} ms, bound {b_ms:.5f} ms "
                 f"({b_by}); no single PyTorch call attends over an int8 cache")
    kernels_json.append(dict(name="decode_attention_int8", route="cuda",
                             source="starvector_tpu_torch/csrc/decode_attention.cu",
                             replaces="starvector_tpu/ops/flash_attention.py:2049",
                             launches=int8_counts["decode_attention_int8"],
                             max_abs_err=err_int8, ms=times[1], plain_ms=times[0],
                             bound_ms=b_ms, bound_by=b_by, library_ms=None))
    kernels_json += quant_matmul_times(
        tq, dev, card, {"gemv": int8_counts["quant_matmul_gemv"],
                        "tile": int8_counts["quant_matmul_mma"]}, err_qmm)

    kernels_json += training_times(tfa, dev, card, train, err_train)
    long_context_times(tfa, dev, card)

    if args.profile is not None:
        profile_request(request, card, args.profile)
        step_wall = statistics.median(r["seconds"] for r in train["recs"][3:])
        profile_train_step(sv, tfa, dev, model.process_images, card, step_wall, args.profile)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "starvector_tpu"))
    if leaked:
        raise AssertionError(f"the port pulled in the JAX package: {leaked}")
    print(card)
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _cast_tree(tree, dtype):
    """The tree in `dtype`, but for BatchNorm statistics, int8 codes and
    the fp32 scales of a quantized leaf."""
    if isinstance(tree, dict):
        keep = ("running_mean", "running_var") + (("scale",) if "kernel_q" in tree else ())
        return {k: (v if k in keep else _cast_tree(v, dtype)) for k, v in tree.items()}
    return tree if tree.dtype == torch.int8 else tree.to(dtype)


def _turns(plain, kernel) -> tuple[float, float]:
    """(plain ms, kernel ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain."""
    a = cuda_ms(plain)
    b = cuda_ms(kernel)
    c = cuda_ms(kernel)
    d = cuda_ms(plain)
    return (a + d) / 2, (b + c) / 2


if __name__ == "__main__":
    sys.exit(main())
