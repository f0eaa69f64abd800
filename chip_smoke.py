"""Chip smoke test of the PyTorch/CUDA port: StarVector-1B im2svg inference
(bf16, and int8 weights with an int8 KV cache), text2svg, beam search,
num_return_sequences, speculative decoding, continuous-batching serving
(the engine, its REST worker and controller), the eval harness (the
in-process and REST validators, LPIPS-VGG and InceptionV3), offline
pipelined generation, the other vision towers (vqgan, convnext, open-clip,
SigLIP at 512 and 256) behind the 1B decoder, GRPO and training, the
entry points (both quickstarts, the web UI, the GRPO driver), and
StarVector-8B im2svg
inference (bf16, and int8 weights with an int8 KV cache), text2svg, beam
search, speculative decoding, pipelined generation, serving and training,
on one NVIDIA H100, end to end through the hand-written kernels.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --times-only ROOT

The second form times only the decode step (decode_attention and the
quant_matmul GEMV beside their plain versions, bounds and library calls,
with their host cost a call), the quant_matmul prefill tile (M = 260 and
1040, each projection and one prefill's 96 as one graph) and the bf16 and
int8 serving of phase 4, for the package in the tree at ROOT; run for two
trees in turns (a, b, b, a) on one card, back to back, it compares them.

Phases, one line each (any failure raises and exits non-zero):
  1. card: name and power limit, torch / CUDA / nvcc versions
  2. build: the CUDA sources of starvector_tpu_torch/csrc, one nvcc each in
     parallel; registers and spills per kernel from ptxas; the tensor-core
     (HGMMA) instructions from cuobjdump: present in the bf16 attention
     kernels and the int8 wgmma tile, absent from the fp32 ones; the tile
     neither spills nor has its products serialized
  3. kernels against their plain PyTorch versions on the card, fp32 and
     bf16: the inference pair at the 1B prefill/decode shapes and ragged
     cases; the training forward-with-lse and backward pair at the 1B
     training shape (B=4, S=T=769; two bf16 launches bit for bit), ragged
     cases, the 8k context (B=1, S=T=8450), sequence-parallel chunks of the
     8k and 16k windows and the 16k triangle, the 8B's heads (H=36 Hkv=4,
     window 4096: B=2 S=T=1160, B=1 S=T=4700, and B=2 T=4700 with 700
     right-padded keys; bf16 bit for bit on relaunch); the int8 weight
     matmul (kernel 14: GEMV at M = 1, 4, 8, 16, the wgmma tile at M = 17,
     260, 1040, the four 1B projection shapes, bf16 and fp32, with and
     without bias; two launches bit for bit) and the int8-cache decode attention; the 8B's
     shapes: decode at G = 9 (36 query heads over 4 KV heads; B=4 T=708,
     B=1 T=8192 past the 4096 window, a ragged mask; over a bf16 and over
     an int8 cache, with the int8 P-rounding case) and flash_prefill at
     H=36 Hkv=4 with the window (B=4 S=T=580; B=1 S=1024 at q_offset 7168 of
     T=8192), kernel 14 at the six 8B projections' four shapes (M = 1, 4,
     580, 2320), fp32 and bf16, bf16 bit for bit on relaunch; flash_prefill
     and decode at phase 4f's prefix lengths, B=2, S=T in {51, 198, 1026}
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
     text2svg on the bf16 weights: a request of 4 captions (6-30 tokens
     through the byte-level test tokenizer) and one of 1 through
     generate_text2svg_ids, the prompts through the chunk step (no
     flash_prefill), 24 decode_attention a step; fp32 greedy ids kernels vs
     plain. Last, beside the card's name and power limit: p50 B=1 latency
     and B=4 decode tokens/s for bf16 im2svg, int8 and text2svg in turns,
     and the memory of bf16 and int8; the 1B inference trees are then
     released
  4b. the decoding variants at full 1B width on the first 8 of phase 4's 24
     layers (DEPTH_1B_EARLIER, as in 4c and 4d), each with exact launch
     counts: beam search (num_beams=2, B=2: flash_prefill over
     B x K = 4 rows, decode_attention a step; fp32 ids kernels == plain);
     num_return_sequences=4 over B=2 (the prefill once at 2 rows, the steps
     at 8; greedy groups identical, in fp32 equal to the n=1 rows), also
     over the int8 decoder and an int8 cache (kernel 14's GEMV at M = 8,
     kernel 2 over the tiled codes and scales); speculative decoding at B=1
     and B=4 (flash_prefill only; n_forwards; fp32 ids == plain greedy; the
     bf16 rows that part from it); B=1 latency of greedy, speculative and
     beam, and B=4 tokens/s of greedy and speculative, in turns; then GRPO:
     one GRPOTrainer.step (B=2, G=4, 64 new tokens, a synthetic target
     raster, on its own tree at all 24 layers: the rollout's kernels 1 and
     2, the update's 48 forwards and 24
     backward pairs under remat "dots"; the decoder alone moves; rollout,
     reward and update wall time, peak memory), and one fp32 update on one
     rollout with the kernels against the plain attention
  4c. continuous-batching serving (serve/engine.py) on phase 4's weights
     (their first 8 layers), before they are released: fp32, 4 concurrent
     requests of prefixes of 260-291 tokens (one admission group, one
     chunk), 32 greedy tokens with the stop: ids equal offline
     generate_im2svg_ids at B=1 and the engine with the plain attention,
     launches exactly 8 flash_prefill a chunk and 8 decode_attention a
     ragged step (ticks x steps_per_tick); int8 weights and cache: fp32 ids
     equal offline int8 generate's, bf16 launches 32 quant_matmul a step and
     a chunk and 8 int8-cache
     decode_attention a step; a bf16 mixed batch under speculative ticks
     (greedy, sampled, stop, logit_bias, beam K=2, drafts from prompt ids),
     every request done; the REST worker and controller (standard-library
     servers on 127.0.0.1): 4 concurrent streamed requests through the
     controller's relay and /v1/chat/completions; then, beside the card's
     name and power limit, 8 concurrent greedy requests of 128 tokens at
     steps_per_tick 1 and 4 in turns with offline generate at B=8 (tokens/s,
     p50 time to first token, p50 latency), int8 serving beside bf16 (with
     --profile DIR, a tick's device-busy share). Any request that ends in
     an error fails the run
  4d. the eval harness (validation/, metrics/) on phase 4's weights (their
     first 8 layers), before they are released: the in-process validator
     over 8 samples (the probe SVGs as ground truth, seeded synthetic
     images as input), B=2, 64
     greedy tokens, configs/metrics/im2svg.yaml's metrics with LPIPS and FID
     on full-size random VGG16 / InceptionV3 weights in a temporary
     STARVECTOR_METRICS_DIR: bf16 texts and ids equal offline
     generate_im2svg's on the same batches, 8 flash_prefill a batch and 8
     decode_attention a step, the output tree and every configured key;
     fp32 texts and ids with the kernels equal the plain attention's;
     LPIPS-VGG16 at 224 and InceptionV3 pool3 at 299 on the card against
     the CPU in fp32 without TF32, and the FID from either's features; the
     REST validator through the port's worker and controller serving the
     fp32 copy, each text equal to offline fp32 generate_im2svg at B=1;
     whether librsvg/cairo is there, and the validator's seconds a sample by
     stage, LPIPS and Inception ms on the card and the CPU, the REST
     validator's seconds a sample, beside the card's name and power limit
  4e. offline pipelined generation on phase 4's weights, before they are
     released: 4 batches of B=16, P=1024 random prompt embeddings, 128
     greedy tokens, C=8, through generate_pipelined (every step of a batch
     but the last one fused decode+chunk forward: kernel 2 and the chunk
     step); fp32 ids == per-batch generate's and == the plain attention's,
     launches exactly 24 flash_prefill (batch 0) and 24 decode_attention a
     decode step; bf16 launches and each row's first token parting from
     per-batch generate; int8 weights over an fp32 cache, fp32 ids ==
     per-batch generate's; an int8 KV cache, and int8 weights with it, in
     fp32: 16 teacher-forced fused steps' logits, kernels against plain,
     within twice generate's route's own gap, and batch 1's first decode
     step over the cache the chunk steps wrote, kernels against plain, to
     TOL; bf16 launches exact over kernel 2' and kernel 14 (GEMV and tile
     by rows); generate_pipelined_spec over 3 batches of 8 right-padded
     prompts (fp32 ids == generate_pipelined's
     and per-batch generate's; bf16 rounds, tokens a round, launches: kernel
     1 for batch 0 only, no kernel 2); tokens/s of serial generate,
     generate_pipelined and its int8 KV, one run each (two rounds in turns
     until PR 16); a fused step against
     the unfused pair (the decode forward, then the chunk step), 10 pairs
     of 8-step blocks in alternating order (with --profile DIR, a fused
     step's and a decode-only step's wall against device time)
  4f. the other vision towers behind phase 4's 1B decoder (all 24 layers):
     vqgan, convnext and open-clip at 224, siglip_512 and siglip_256, each
     at its stock geometry with seeded random tower and adapter weights: the
     bf16 tower forward within TOWER_REL_TOL of fp32 and both timed at B=2;
     bf16 greedy generate_im2svg_ids at B=2, 32 tokens, launches exactly 24
     flash_prefill at S = qlen + 2 (none at convnext's 51: the chunk step)
     and 24 decode_attention a step; fp32 greedy ids kernels == plain on
     the first 8 layers, 16 tokens
  5. training at full 1B width (fp32 masters, bf16 compute, dots_flash
     remat, AdamW): 8 steps of the port's train loop on one synthetic batch
     (T = 257 + 512 = 769), loss falling, 24 launches per step of each
     training kernel, peak memory (also above what was held before it);
     then 2 fp32 steps with the kernels against 2 with the plain attention
  5b. the export round trip: the trained 1B through train/hub.py's
     export_hf_checkpoint into a temporary directory (the reference HF
     layout), back through models/builder.py's load_pretrained_model at
     fp32: fp32 greedy ids for 2 images equal those of the in-memory
     weights, with flash_prefill and decode_attention launched
  5c. the entry points on 5b's directory (bf16, all 24 layers):
     quickstart.main (one image, 64 tokens, stdout captured: the SVG it
     prints, 24 flash_prefill, 24 decode_attention a step, its load and
     generation seconds); quickstart_serve.serve_images on the model it
     loaded (4 images, 128 tokens, every request done, 24 flash_prefill an
     engine chunk and 24 decode_attention a step); the web UI over a
     ModelWorker on 127.0.0.1 (one streamed im2svg request of 32 tokens
     through /api/generate, one vote in votes.jsonl); the directory is
     then deleted
  5d. the GRPO driver, train.grpo.main, on configs/models/starvector-1b/
     im2svg-grpo.yaml at full 1B width and depth (ToySVGDataset at 224 px,
     B=2, G=2, 64 tokens, 2 steps, a checkpoint at step 2): 2 steps logged,
     checkpoint-2 restored to the trainer's parameters bit for bit, kernels
     1, 2, 5 and 6 launched; its steps' seconds
  6. inference at full StarVector-8B width (StarCoder2-7B 4608 wide, GQA
     36/4, window 4096; SigLIP-L/16 at 384; LayerNorm adapter) and 8 of its
     32 decoder layers (DEPTH_8B) on random bf16 weights that
     StarVectorForCausalLM.from_config draws on the card from a seed: 3
     requests of 4 images with launch counts (8 flash_prefill a prefill, 8
     decode_attention a step); bf16 prefill logits against the fp32 plain
     ones and fp32 greedy ids kernels vs plain on an fp32 copy; the
     window at full width (2 layers, a 4700-token prefix, fp32
     ids kernels vs plain); text2svg as in phase 4 (8 decode_attention a
     step; its fp32 check on the same fp32 copy); beam search (num_beams=2,
     B=1: flash_prefill over 2 rows, decode_attention at G = 9) and
     speculative decoding (B=1, and B=4 through StarCoder2's
     forward_ragged_verify), fp32 ids kernels == plain on the same copy;
     p50 B=1 latency, B=4
     tokens/s of im2svg and text2svg in turns, and memory. Then int8: the
     decoder through quantize_tree, consuming the bf16 tree, with an int8
     KV cache: requests of 4 images and of 1 with launch counts (48
     quant_matmul a prefill and a decode step, 8 flash_prefill a prefill,
     8 int8-cache decode_attention a step); in fp32, kernels vs plain,
     greedy ids with an fp32 KV cache and, with the int8 cache, the logits
     of both fed the same tokens (INT8_CACHE_LOGIT_TOL); weights and
     memory, p50 and tokens/s beside bf16's. Pipelined generation
     (before 6d): 2 batches of B=2 prefixes, 32 tokens, each step the decode
     forward and the chunk step (StarCoder2 has no fused forward): fp32 ids
     == per-batch generate's and the plain attention's, bf16 launches 8
     flash_prefill (batch 0) and 8 decode_attention a step; the port's
     NotImplementedError from generate_pipelined_spec; tokens/s of serial
     and pipelined at 3 batches of B=4, 128 tokens. 6d, serving on the same
     weights: 4 concurrent bf16 requests (launches 8
     flash_prefill a chunk, 8 decode_attention at G = 9 a ragged step),
     fp32 engine ids equal offline generate's on the fp32 copy, the window
     at 2 layers in fp32 (a 4700-token prefix admitted in 8 chunks beside a
     579-token one, decoded past the 4096-key window in the row's mask: ids
     with the kernels == plain), tokens/s beside offline B=4
  6b. training at full StarVector-8B width and 8 of its 32 decoder layers
     (SigLIP-L/16 and the LayerNorm adapter trainable; fp32 masters, bf16
     compute, dots_flash, AdamW; B=1, T = 576 + 7616 = 8192, past the 4096
     window): 8 steps of the port's train loop on one batch, loss falling,
     8 launches a step of each training kernel, peak memory; one loss and
     backward with remat=True (16 forwards); then 2 fp32 steps at 2 layers,
     T = 4700, kernels against plain
  6c. the 8B's own recipe at full width and all 32 decoder layers, read
     from configs/models/starvector-8b/im2svg-stack-v5e8.yaml through the
     functions train.main uses: Adafactor, bf16 gradients (grad_dtype),
     dots_flash (or the yaml's fallback, full remat, if that does not fit;
     then the deepest depth that fits), fp32 masters, bf16 compute; lr
     raised and warmup dropped so that the loss falls in 5 steps; B=1,
     T = 8192 on phase 6b's batch: loss falling at every step, the training kernels'
     launches a step, step time, tokens/s and peak memory beside the
     state's bytes (masters, bf16 cast, bf16 gradients, Adafactor)
  7. times on the card, each beside the card's name and power limit: each
     kernel against its plain version, its bound and one PyTorch library
     call where there is one (the 8B's at its shapes too; kernel 14 also at
     M = 144, a fused step of phase 4e), the 1B and 8B
     train steps and the training kernels at the 8B's (S = T = 8192, H=36,
     Hkv=4, window 4096; dkdv at each head split beside the plan's pick),
     flash_prefill at siglip_512's prefix (B=2, S=T=1026) beside SDPA,
     also the training kernels at the long contexts phase 3 drives (with
     --profile DIR, also where a decode step's and the 1B and 8B train
     steps' device time goes)
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}  # (atol, rtol) per dtype
# decode_attention (bf16 or int8 cache): rtol 2^-7 is one bf16 step of the
# output, atol 2e-3 p rounded to bf16 against each warp's running max where
# the plain version uses the global max; 2e-2 would pass a dropped self
# token at T >= 1285, where outputs are ~0.02-0.04 (the CPU test
# test_decode_tolerance_tells_a_dropped_token_or_split holds this limit)
DECODE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 2**-7)}
# quant_matmul (kernel 14, GEMV and tile): the fp32 sums differ from the
# plain version's only in order, which can move a bf16 result across one
# rounding boundary (one bf16 step, 2^-7 relative at most; atol for results
# near zero); 2e-2 would pass a kernel that drops or repeats a 16-row slab
# of q (tests/test_torch_quantization.py::
# test_qmm_tolerance_tells_a_dropped_or_repeated_k_slab holds this limit)
QMM_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 2**-7)}
# the 8B's fp32 logits over an int8 KV cache, kernels against plain, fed the
# same tokens: the two paths' k/v differ by fp32 sum order, so some round to
# the next code (a scale step, 1/127 of the row's max |x|), and the flips
# grow layer by layer: 0.026-0.049 at 32 layers on the H100 (PERF.md
# section 6), against 2e-5-4e-5 with an fp32 cache; the limit is twice the
# largest
INT8_CACHE_LOGIT_TOL = 0.1
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
QMM_PATHS = ("gemv", "wgmma", "f32_tile")


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
    """What tells a kernel's instantiations apart, from its mangled name:
    ' int8 cache' for decode_attention_{bf16,f32}_kernel<int8_t, G> and
    ' G=9' or ' G=16' for its query heads per KV head; for the
    int8 matmul its first template argument ('<bf16>' or '<f32>': x's type
    for the GEMV, the output's for the tile and finish kernels, marked
    'out'), for the GEMV ' rows<=MR' and for the wgmma tile ' xBX' (its
    rows of x a block); nothing for the flash kernels, whose type is in
    their names."""
    if "decode_attention" in mangled:
        group = re.search(r"decode_attention_(?:bf16|f32)_kernelI(?:13__nv_bfloat16|a|f)Li(\d+)E",
                          mangled)
        int8 = re.search(r"decode_attention_(bf16|f32)_kernelIa", mangled)
        return (" int8 cache" if int8 else "") + (f" G={group.group(1)}" if group else "")
    if "qmm_" not in mangled:
        return ""
    first = re.search(r"kernelI(13__nv_bfloat16|f)", mangled)
    out = "out " if re.search(r"qmm_(wgmma|f32|finish)_kernel", mangled) else ""
    tag = f"<{out}bf16>" if first and first.group(1) != "f" else f"<{out}f32>"
    rows = re.search(r"qmm_gemv_kernelI(?:13__nv_bfloat16|f)Li(\d+)E", mangled)
    tile = re.search(r"qmm_wgmma_kernelI(?:13__nv_bfloat16|f)Li(\d+)E", mangled)
    return (tag + (f" rows<={rows.group(1)}" if rows else "")
            + (f" x{tile.group(1)}" if tile else ""))


KERNEL_NAMES = ("flash_prefill_bf16_kernel", "flash_prefill_f32_kernel",
                "decode_attention_bf16_kernel", "decode_attention_f32_kernel",
                "flash_bwd_dkdv_bf16_kernel", "flash_bwd_dkdv_f32_kernel",
                "flash_bwd_dkdv_finish_kernel", "flash_bwd_dq_bf16_kernel",
                "flash_bwd_dq_f32_kernel", "qmm_gemv_kernel", "qmm_finish_kernel",
                "qmm_wgmma_kernel", "qmm_f32_kernel")


def ptxas_summary(log_text: str) -> list[str]:
    """'<kernel><type>: N registers, S bytes spilled' for each kernel ptxas
    compiled, read from its -v output; then any kernel whose wgmma products
    ptxas serialized, with its reason."""
    out, name, spill, serialized = [], None, 0, []
    for line in log_text.splitlines():
        if "wgmma" in line and "serialized" in line:
            mangled = line.rsplit("'", 2)[-2] if line.count("'") >= 2 else ""
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled[:40])
            serialized.append(f"{base}: wgmma serialized ({line.split(':', 1)[-1].strip()[:160]})")
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled[:40])
            # the attention tensor-core and CUDA-core kernels carry their type in the name
            name = base + kernel_tag(mangled)
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name is not None:
            regs = int(line.split("Used")[1].split()[0])
            out.append(f"{name} {regs} registers, {spill} bytes spilled")
            name, spill = None, 0
    return out + serialized


TENSOR_CORE_KERNELS = ("flash_prefill_bf16_kernel", "flash_bwd_dkdv_bf16_kernel",
                       "flash_bwd_dq_bf16_kernel")
CUDA_CORE_KERNELS = ("flash_prefill_f32_kernel", "flash_bwd_dkdv_f32_kernel",
                     "flash_bwd_dq_f32_kernel")
# decode_attention's instantiations: bf16 queries on the warp-level tensor
# cores (mma.sync: HMMA), fp32 queries on the CUDA cores (none)
DECODE_TAGS = (" G=16", " int8 cache G=16", " G=9", " int8 cache G=9")
HMMA_KERNELS = tuple(f"decode_attention_bf16_kernel{tag}" for tag in DECODE_TAGS)
NO_HMMA_KERNELS = tuple(f"decode_attention_f32_kernel{tag}" for tag in DECODE_TAGS)


def sass_counts(lib: Path, nvcc: str) -> dict[str, dict[str, int]]:
    """The tensor-core instructions of each kernel instantiation in the
    built library's machine code, from the toolkit's cuobjdump beside nvcc:
    {name (+ kernel_tag): {"HGMMA": warpgroup products, "HMMA": warp products}}."""
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            mangled = line.split("Function : ", 1)[1].strip()
            base = next((k for k in KERNEL_NAMES if k in mangled), None)
            name = None if base is None else base + kernel_tag(mangled)
            if name is not None:
                counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
    return counts


def compare(what: str, out: torch.Tensor, ref: torch.Tensor, dtype, live=None,
            tols=TOL) -> float:
    """Raise unless |out - ref| <= atol + rtol*|ref| on the live rows, with
    (atol, rtol) = tols[dtype]; return max |out - ref|."""
    if live is not None:
        out, ref = out[live], ref[live]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    atol, rtol = tols[dtype]
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
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
        ("1B pipelined batch 0 (4e)", 16, 1024, 1024 + 128, 16, 1, 0, None, 0),
        ("S=37", 2, 37, 37, 16, 1, 0, None, 0),
        ("T=53 not a tile multiple", 2, 37, 53, 16, 1, 0, None, 0),
        ("q_offset=100", 2, 37, 200, 16, 1, 100, None, 0),
        ("left-padded keys", 2, 64, 100, 16, 1, 0, None, 9),
        ("window=32", 2, 100, 100, 16, 1, 0, 32, 0),
        ("GQA Hkv=4", 2, 70, 70, 16, 4, 0, None, 0),
        # phase 4f's prefixes: qlen + 2 prompt ids of convnext, vqgan, siglip_512
        *((f"tower prefix S=T={S}", 2, S, S, 16, 1, 0, None, 0) for S in TOWER_PREFIXES),
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


# phase 4f's prefix lengths at B = 2: qlen + 2 prompt ids of convnext (49),
# vqgan (196) and siglip_512 (1024); open-clip's and siglip_256's are 258
TOWER_PREFIXES = (51, 198, 1026)
# B, T; (16, 1152) is phase 4e's pipelined decode: B = 16, Pn 1024 + 128 new tokens
DECODE_CHECKS = ((1, 1), (4, 300), (1, 1285), (8, 1285), (16, 1152), (4, 2049), (4, 4100),
                 *((2, T) for T in TOWER_PREFIXES))


@functools.lru_cache(maxsize=1)
def p_rounding_cases():
    """tests/test_torch_flash_attention.py, loaded from its file (an
    installed package may own the name `tests`): the P-rounding cases its
    GPU-marked tests build (it imports no JAX at module level)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "test_torch_flash_attention.py"
    spec = importlib.util.spec_from_file_location("p_rounding_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_decode_attention(tfa, dev) -> float:
    """decode_attention against its plain version, fp32 and bf16: the cache
    with the self token (merged_decode_attention), then a window whose edges
    fall inside the grid's chunks (gqa_decode_batched); row 0 left-padded,
    and at T > 256 a masked run that empties a whole 128-key chunk of the last
    row. Then the P-rounding case (bf16 must give the rounded-P value
    exactly) and two bf16 launches at B=8 T=1285 bit for bit."""
    g = torch.Generator(device=dev).manual_seed(2)
    G, D = 16, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T in DECODE_CHECKS:
            qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            mask[:, : T // 5] = 0  # left padding
            if T > 256:
                mask[-1, 100:300] = 0  # a whole chunk of the grid sees no key
            # (b) merged_decode_attention: the cache plus the self token
            out = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5)
            ref = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, kernels=False)
            torch.cuda.synchronize()
            err_b = compare(f"merged decode B={B} T={T} {dtype}", out, ref, dtype,
                            tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16 and (B, T) == (8, 1285):
                again = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5)
                # what the limit refuses: the plain result without the self token
                dropped = tfa.decode_attention(qg, k, v, mask, kernels=False).reshape(ref.shape)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"decode B={B} T={T} {dtype}: two launches differ")
                atol, rtol = DECODE_TOL[dtype]
                gap = (dropped.float() - ref.float()).abs()
                n_off = int((gap > atol + rtol * ref.float().abs()).sum())
                if not n_off:
                    raise AssertionError("decode: the tolerance passes a dropped self token")
                same = (f"; a second launch gives the same bits; a dropped self token reads "
                        f"max |diff| {gap.max().item():.3e}, {n_off} elements past the limit")
            # (a) gqa_decode_batched: valid length and window start, no self token
            q = qg.reshape(B, G, D)
            lo, hi = T // 8, max(T - 3, 1)
            out = tfa.gqa_decode_batched(q, k, v, mask, hi, lo)
            ref = tfa.gqa_decode_batched(q, k, v, mask, hi, lo, kernels=False)
            torch.cuda.synchronize()
            live = (mask[:, lo:hi] > 0).any(dim=1)
            err_a = compare(f"gqa decode B={B} T={T} {dtype}", out, ref, dtype, live,
                            tols=DECODE_TOL)
            worst = max(worst, err_a, err_b)
            log("kernels", f"decode_attention B={B} T={T} {str(dtype)[6:]}: "
                           f"merged max |diff| {err_b:.3e}, batched max |diff| {err_a:.3e}{same}")
    # P rounded to bf16 before P V: the case the GPU-marked test builds
    (qg, k, v, mask), want, unrounded = p_rounding_cases()._p_rounding_inputs(dev)
    out = tfa.decode_attention(qg, k, v, mask)
    ref = tfa.decode_attention(qg, k, v, mask, kernels=False)
    torch.cuda.synchronize()
    got = out[..., 0].double().unique().tolist()
    if got != [want] or ref[..., 0].double().unique().tolist() != [want] or (out[..., 1:] != 0).any():
        raise AssertionError(f"P rounding: kernel {got}, plain {ref[..., 0].unique().tolist()}, "
                             f"JAX's value {want}, fp32 P's {unrounded}")
    log("kernels", f"decode_attention bf16 P rounding: two visible keys in one chunk of T=325 "
                   f"(the other chunks see none): kernel {want!r} == plain == JAX's rounded-P "
                   f"value, not the fp32-P value {unrounded!r}")
    return worst


# M of kernel 14's checks: the GEMV and its edge, phase 4e's chunk-only, fused and
# batch-0 prefill rows (B = 16: 16 x 8, 16 x 9, 16 x 1024), and 1B prefills
QMM_CHECK_ROWS = (1, 4, 8, 16, 17, 128, 144, 260, 1040, 16384)
QMM_SHAPES = (  # the 1B decoder's four projections: name, K, N
    ("attn.c_attn", 2048, 2304), ("attn.c_proj", 2048, 2048),
    ("mlp.c_fc", 2048, 8192), ("mlp.c_proj", 8192, 2048),
)


def check_quant_matmul(tq, dev) -> dict:
    """Kernel 14 against its plain version at M = 1, 4, 8, 16 (GEMV), 17,
    128 and 144 (phase 4e's chunk-only and fused decode+chunk steps: B = 16
    rows x C = 8, x (1 + C)), 260 (a B=1 prefill), 1040 (the wgmma tile:
    4 x 260 prefill rows) and 16384 (phase 4e's batch 0 prefill: 16 x
    1024), the four projection shapes, bf16 and fp32 x, with a bias of x's
    type and without, to QMM_TOL; the bf16 GEMV at M = 4 and tile at
    M = 144 and 260 (where tile_plan splits K, and the finish pass sums the
    splits) and 1040 launched twice, bit for bit. Returns the worst max
    |diff| by path ("gemv", "tile")."""
    g = torch.Generator(device=dev).manual_seed(8)
    worst = {"gemv": 0.0, "tile": 0.0}
    for name, K, N in QMM_SHAPES:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = torch.randn((N,), generator=g, device=dev)
        errs = []
        for M in QMM_CHECK_ROWS:
            path = "gemv" if M <= tq.GEMV_MAX_ROWS else "tile"
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                for b in (None, bias.to(dtype)):
                    out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    err = compare(f"quant_matmul {name} M={M} {dtype} bias={b is not None}",
                                  out, ref, dtype, tols=QMM_TOL)
                    if M in (4, 144, 260, 1040) and dtype == torch.bfloat16 and b is not None:
                        again = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                        torch.cuda.synchronize()
                        if not torch.equal(again, out):
                            raise AssertionError(f"quant_matmul {name} M={M}: two launches differ")
                    worst[path] = max(worst[path], err)
                    errs.append(f"M={M} {str(dtype)[6:]}{'+bias' if b is not None else ''} "
                                f"{err:.2e}")
        log("kernels", f"quant_matmul {name} (K={K}, N={N}): max |diff| " + ", ".join(errs))
    return worst


def check_int8_decode(tfa, dc, dev) -> float:
    """The int8-cache decode attention against its plain version: B = 1, 4,
    T = 260, 389 cached tokens, and the 1k-token cell's end (B = 1, 8,
    T = 1285), phase 4e's pipelined decode (B = 16, T = 1152), T = 4100; left padding, a masked slot and (T > 256) a masked
    run of whole chunks; fp32 and bf16 queries over codes and scales from
    quantize_kv; two bf16 launches at B=8 T=1285 bit for bit."""
    g = torch.Generator(device=dev).manual_seed(9)
    G, D = 16, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T in ((1, 260), (4, 260), (1, 389), (4, 389), (1, 1285), (8, 1285), (16, 1152),
                     (4, 4100)):
            qg = torch.randn((B, 1, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).to(dtype) for _ in "kv")
            (kq, ks), (vq, vs) = (dc.quantize_kv(torch.randn((B, T, 1, D), generator=g,
                                                             device=dev)) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            mask[:, : T // 5] = 0
            mask[0, T // 2] = 0
            if T > 256:
                mask[-1, 100:300] = 0
            out = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs)
            ref = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs,
                                              kernels=False)
            torch.cuda.synchronize()
            err = compare(f"int8 decode B={B} T={T} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16 and (B, T) == (8, 1285):
                again = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"int8 decode B={B} T={T}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention int8 cache B={B} T={T} {str(dtype)[6:]}: "
                           f"max |diff| {err:.3e}{same}")
    return worst


# StarVector-8B's attention: 36 query heads over 4 KV heads (G = 9), head
# size 128, a sliding window of 4096 keys
H8, HKV8, WINDOW8 = 36, 4, 4096
G9_DECODE_CHECKS = (  # name, B, T, t_begin, ragged mask
    ("B=4 T=708 (576 visual + 4 prompt + 128 new tokens)", 4, 708, 0, False),
    ("B=1 T=8192 past the window (t_begin 4097)", 1, 8192, 4097, False),
    ("B=4 T=708 ragged mask", 4, 708, 0, True),
)


def check_g9_decode(tfa, dev) -> float:
    """decode_attention at G = 9, Hkv = 4 against its plain version, fp32
    and bf16, the self token merged (rows 9-15 of the tensor-core product are
    zero padding): the 8B decode at T = 708, a step past the window (the
    first visible slot t_begin = idx - 4095), and a ragged mask (left
    padding, a masked run that empties whole chunks, a masked slot); each
    bf16 case launched twice, bit for bit. Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(14)
    G, D = H8 // HKV8, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, t_begin, ragged in G9_DECODE_CHECKS:
            qg = torch.randn((B, HKV8, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            k, v = (torch.randn((B, T, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if ragged:
                mask[0, : T // 5] = 0
                mask[-1, 100:400] = 0
                mask[:, T // 2] = 0
            out = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, t_begin=t_begin)
            ref = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, t_begin=t_begin,
                                              kernels=False)
            torch.cuda.synchronize()
            err = compare(f"decode G=9 {name} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16:
                again = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5,
                                                    t_begin=t_begin)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"decode G=9 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention G=9 Hkv=4 {name} {str(dtype)[6:]}: max |diff| "
                           f"{err:.3e}{same}")
    return worst


def check_g9_int8_decode(tfa, dc, dev) -> float:
    """Kernel 2's int8 instantiation at G = 9, Hkv = 4 (the 8B's int8 KV
    cache) against its plain version, fp32 and bf16 queries over codes and
    scales from quantize_kv, the self token merged: the cases of
    check_g9_decode (T = 708, a step past the window, a ragged mask), each
    bf16 case launched twice, bit for bit; then the int8 P-rounding case
    (bf16(bf16(c p) / (1 + p)) exactly: v_scale folded into P before the
    rounding). Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(19)
    G, D = H8 // HKV8, 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, t_begin, ragged in G9_DECODE_CHECKS:
            qg = torch.randn((B, HKV8, G, D), generator=g, device=dev).to(dtype)
            kn, vn = (torch.randn((B, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            (kq, ks), (vq, vs) = (dc.quantize_kv(torch.randn((B, T, HKV8, D), generator=g,
                                                             device=dev)) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            if ragged:
                mask[0, : T // 5] = 0
                mask[-1, 100:400] = 0
                mask[:, T // 2] = 0

            def run(kernels=True):
                return tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs,
                                                   t_begin=t_begin, kernels=kernels)

            out, ref = run(), run(False)
            torch.cuda.synchronize()
            err = compare(f"int8 decode G=9 {name} {dtype}", out, ref, dtype, tols=DECODE_TOL)
            same = ""
            if dtype == torch.bfloat16:
                again = run()
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"int8 decode G=9 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            log("kernels", f"decode_attention int8 cache G=9 Hkv=4 {name} {str(dtype)[6:]}: "
                           f"max |diff| {err:.3e}{same}")
    (qg, k, v, mask, ks, vs), want, others = p_rounding_cases()._int8_p_rounding_inputs(dev)
    out = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs)
    ref = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs, kernels=False)
    torch.cuda.synchronize()
    got, plain = (t[..., 0].double().unique().tolist() for t in (out, ref))
    if got != [want] or plain != [want] or (out[..., 1:] != 0).any():
        raise AssertionError(f"int8 P rounding G=9: kernel {got}, plain {plain}, JAX's value "
                             f"{want}, the other orderings' {others}")
    log("kernels", f"decode_attention int8 cache G=9 P rounding: two visible keys of T=325: "
                   f"kernel {want!r} == plain == JAX's bf16(bf16(c p) / (1 + p)), not the "
                   f"v_scale-after-rounding or fp32-P values {others}")
    return worst


QMM_SHAPES_8B = (  # the 8B decoder's six projections a layer, four shapes: name, K, N
    ("attn.q_proj, o_proj", 4608, 4608), ("attn.k_proj, v_proj", 4608, 512),
    ("mlp.c_fc", 4608, 18432), ("mlp.c_proj", 18432, 4608),
)
QMM_ROWS_8B = (1, 4, 580, 2320)  # decode at B = 1, 4; prefill of 580 tokens at B = 1, 4


def check_quant_matmul_8b(tq, dev) -> dict:
    """Kernel 14 at the 8B's shapes against its plain version, with a bias
    of x's type: M = 1, 4 (the GEMV) and 580, 2320 (the tile) in bf16, and
    fp32 x up to M = 580 (the fp32 greedy check's path), to QMM_TOL; the
    bf16 tile at M = 2320 launched twice, bit for bit. Returns the worst
    max |diff| by path ("gemv", "tile")."""
    g = torch.Generator(device=dev).manual_seed(20)
    worst = {"gemv": 0.0, "tile": 0.0}
    for name, K, N in QMM_SHAPES_8B:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = torch.randn((N,), generator=g, device=dev)
        errs = []
        for M in QMM_ROWS_8B:
            path = "gemv" if M <= tq.GEMV_MAX_ROWS else "tile"
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and M > 580:
                    continue
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                b = bias.to(dtype)
                out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                torch.cuda.synchronize()
                err = compare(f"quant_matmul 8B {name} M={M} {dtype}", out, ref, dtype,
                              tols=QMM_TOL)
                if M == 2320:
                    again = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
                    torch.cuda.synchronize()
                    if not torch.equal(again, out):
                        raise AssertionError(f"quant_matmul 8B {name} M={M}: two launches differ")
                worst[path] = max(worst[path], err)
                errs.append(f"M={M} {str(dtype)[6:]} {err:.2e}")
                del x, out, ref
        log("kernels", f"quant_matmul 8B {name} (K={K}, N={N}, bias), plans: GEMV "
                       f"{tq.gemv_split(K, N)} (splits, rows), tile "
                       f"{[tq.tile_plan(M, K, N) for M in QMM_ROWS_8B[2:]]} (rows of x, splits, "
                       f"rows of K): max |diff| " + ", ".join(errs))
    torch.cuda.empty_cache()
    return worst


PREFILL_8B_CHECKS = (  # name, B, S, T, q_offset
    ("B=4 S=T=580 (the 8B prefill)", 4, 580, 580, 0),
    ("B=1 S=1024 at q_offset 7168 of T=8192", 1, 1024, 8192, 7168),
)


def check_flash_prefill_8b(tfa, dev) -> float:
    """flash_prefill at H = 36, Hkv = 4 with the 4096-key window against its
    plain version, fp32 and bf16 (TOL): the 8B prefill, and a chunk past the
    window whose first rows' windows start inside a key tile; each bf16 case
    launched twice, bit for bit. Returns the worst max |diff|."""
    g = torch.Generator(device=dev).manual_seed(15)
    D = 128
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, T, q_off in PREFILL_8B_CHECKS:
            q = torch.randn((B, S, H8, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, T, HKV8, D), generator=g, device=dev).to(dtype) for _ in "kv")
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
            out = tfa.flash_prefill(q, k, v, mask, q_off, window=WINDOW8)
            ref = tfa.flash_prefill(q, k, v, mask, q_off, window=WINDOW8, kernels=False)
            torch.cuda.synchronize()
            err = compare(f"flash_prefill H=36 {name} {dtype}", out, ref, dtype)
            same = ""
            if dtype == torch.bfloat16:
                again = tfa.flash_prefill(q, k, v, mask, q_off, window=WINDOW8)
                torch.cuda.synchronize()
                if not torch.equal(again, out):
                    raise AssertionError(f"flash_prefill H=36 {name}: two launches differ")
                same = "; a second launch gives the same bits"
            worst = max(worst, err)
            del ref
            log("kernels", f"flash_prefill H=36 Hkv=4 window=4096 {name} {str(dtype)[6:]}: "
                           f"max |diff| {err:.3e}{same}")
    torch.cuda.empty_cache()
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
    # the 8B's training shapes: 36 query heads over 4 KV heads (G = 9, so
    # dkdv_head_split's divisors 3 and 9), the 4096-key window with GQA, a
    # short step (the TPU's fused backward, T <= 2048) and one past the
    # window (its one-pass backward), right-padded keys past the window, and
    # phase 6b's step itself (128 key tiles, the plan's head split)
    ("8B train, short", 2, 1160, 1160, 36, 4, 0, 4096, 0, 0),
    ("8B train past the window", 1, 4700, 4700, 36, 4, 0, 4096, 0, 0),
    ("8B right-padded keys past the window", 2, 4700, 4700, 36, 4, 0, 4096, 700, 0),
    ("8B train step", 1, 8192, 8192, 36, 4, 0, 4096, 0, 0),
]
# cases whose bf16 kernels are launched twice and held to the same bits
RELAUNCH_CASES = ("1B train step", "8B train, short", "8B train past the window",
                  "8B right-padded keys past the window", "8B train step")
# the case whose bf16 error each kernel's JSON row reports: the shape its
# times are taken at (phase 7), by the row name's suffix
ROW_CASES = {"": "1B train step", "_8b": "8B train step"}


def compare_training(what: str, out, plain, ref32, dtype, live=None) -> float:
    """compare() at the dtype's tolerance; for bf16, failing that, the kernel
    may be no further from the fp32 plain result (on the same bf16 inputs)
    than twice the plain bf16 version's own distance, plus 1e-3: the kernels
    round at the JAX kernels' points, which are not all the plain version's
    (the forward kernel rounds the unnormalised P to bf16 against the
    running max of its key tile, the plain version the normalised P; the
    backward kernels round P and dS where the plain version does)."""
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
    1B decoder passes it; the backward pair gets the plain forward's out and
    lse on both sides, so each comparison isolates one kernel. Returns each
    kernel's bf16 max |diff| at the 1B step's shape, and under
    "<kernel>_8b" at the 8B step's (ROW_CASES)."""
    g = torch.Generator(device=dev).manual_seed(6)
    at_rows = {}
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
            same = ""
            if name in RELAUNCH_CASES and dtype == torch.bfloat16:
                # no atomics: each output is written once, the backward's head
                # splits summed in a fixed order
                fwd = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, **kw)
                again = (tfa.flash_bwd_dq(q, k, v, mask, do, rl, delta, q_off, **kw),
                         *tfa.flash_bwd_dkdv(q, k, v, mask, do, rl, delta, q_off, **kw))
                torch.cuda.synchronize()
                if not (torch.equal(fwd[0], out) and torch.equal(fwd[1], lse)):
                    raise AssertionError(f"forward {tag}: two launches differ")
                if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
                    raise AssertionError(f"backward {tag}: two launches differ")
                same = "; a second launch gives bit-identical out, lse, dq, dk, dv"
                del again, fwd
            for sfx, case in ROW_CASES.items():
                if name == case and dtype == torch.bfloat16:
                    at_rows.update({"flash_prefill_with_lse" + sfx: max(err_o, err_l),
                                    "flash_bwd_dq" + sfx: errs[0],
                                    "flash_bwd_dkdv" + sfx: max(errs[1:])})
            log("kernels", f"training {tag}: max |diff| out {err_o:.3e}, lse {err_l:.3e}, "
                           f"dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}"
                           + ("" if live.all() else f"; {int((~live).sum())} rows see no key: "
                              "finite, dq = 0") + same)
            del qkv, q, k, v, do, out, lse, ro, rl, delta, dk, dv, dq, pq, pk, pv, ref32
            torch.cuda.empty_cache()
    return at_rows


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


GREEDY = dict(prompt_ids=[PROMPT_IDS] * 4, stop_sequences=STOP_IDS, max_new_tokens=128,
              use_nucleus_sampling=False)


def api_requester(model):
    """request(images, **kw) -> (tokens, lengths, seconds): the API's
    generate_im2svg_ids, greedy with 128 new tokens unless kw says
    otherwise, host clock around a synchronised request."""
    def request(images, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = {"image": model.process_images(images)}
        _, tokens, lengths = model.generate_im2svg_ids(batch, **{**GREEDY, **kw})
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def scale_projections(params: dict) -> dict:
    """The decoder's attention and MLP kernels times PROJ_SCALE, in place."""
    for grp in (params["svg_transformer"]["layers"]["attn"], params["svg_transformer"]["layers"]["mlp"]):
        for p in grp.values():
            p["kernel"].mul_(PROJ_SCALE)
    return params


def full_width_params(sv, cfg, dev, dtype, seed: int = 0) -> dict:
    return scale_projections(sv.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                            device=dev, dtype=dtype))


KERNEL_CLASSES = (  # (label, substrings of the CUDA kernel's name), first match wins
    ("decode_attention", ("decode_attention_bf16_kernel", "decode_attention_f32_kernel")),
    ("quant_matmul", ("qmm_gemv_kernel", "qmm_finish_kernel", "qmm_wgmma_kernel",
                      "qmm_f32_kernel")),
    ("flash_prefill", ("flash_prefill_bf16_kernel", "flash_prefill_f32_kernel")),
    ("GEMM/GEMV (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")),
    ("layer_norm", ("layer_norm",)),
)


def profile_request(request, card: str, out_dir: Path, label: str = "bf16") -> None:
    """Where the device time of a B=4, 128-token greedy request of the
    `label` model (bf16, or int8 weights and cache) goes:
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
    table = out_dir / ("profile_im2svg.txt" if label == "bf16" else f"profile_im2svg_{label}.txt")
    table.write_text(
        f"{card}\n{label}: B=4, 128 new tokens greedy\n{table_full}\n\n"
        f"B=4, prefill only (max_new_tokens=1)\n{table_prefill}\n")
    n = steps - 1
    per_step = {k: (full.get(k, 0.0) - prefill.get(k, 0.0)) / n for k in full}
    dev_step, wall_step = sum(per_step.values()), (wall - wall0) / n
    shares = ", ".join(f"{k} {v * 1e3:.1f} us ({v / dev_step:.1%})"
                       for k, v in sorted(per_step.items(), key=lambda kv: -kv[1]))
    log("profile", f"{card}: {label} B=4 decode step ({n} steps, tables in "
                   f"{table}): wall {wall_step:.3f} ms without the "
                   f"profiler, device {dev_step:.3f} ms under it, busy {dev_step / wall_step:.1%}; "
                   f"device time per step: {shares}")
    log("profile", f"{card}: {label} B=4 image+prefill+first token: wall "
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


def int8_requester(model, cfg, params, policy, dev, kernels: bool = True,
                   kv_cache_dtype=torch.int8):
    """request(images, max_new_tokens=128) -> (tokens, lengths, seconds):
    the model's processor, the im2svg prefix, then engine.generate with an
    int8 KV cache (or `kv_cache_dtype`) and the API's greedy generation
    config, host clock around a synchronised request."""
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
                                   kv_cache_dtype=kv_cache_dtype)
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def forced_logits(dec, params, llm_cfg, emb, mask, n: int, policy, kernels: bool, cache_dtype,
                  ids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, n, V) fp32, ids (B, n - 1)): a cached prefill over (emb,
    mask), then n - 1 decode steps, each fed ids[:, t] whatever the logits
    pick or, without `ids`, the greedy token (engine.generate's greedy
    loop without its stops)."""
    B = emb.shape[0]
    cache = dec.init_cache(llm_cfg, B, emb.shape[1] + n, dtype=cache_dtype, device=emb.device)
    logits, cache = dec.forward(params, llm_cfg, emb, mask, cache=cache, policy=policy,
                                last_logits_only=True, kernels=kernels)
    out, fed = [logits[:, -1]], []
    ones = torch.ones((B, 1), dtype=torch.int32, device=emb.device)
    for t in range(n - 1):
        fed.append(out[-1].argmax(-1) if ids is None else ids[:, t])
        x = dec.embed_tokens(params, fed[-1][:, None]).to(policy.compute_dtype)
        logits, cache = dec.forward(params, llm_cfg, x, ones, cache=cache, policy=policy,
                                    kernels=kernels)
        out.append(logits[:, -1])
    return torch.stack(out, 1), torch.stack(fed, 1)


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
                "quant_matmul_wgmma": 4 * L * 3, "quant_matmul_f32_tile": 0,
                "flash_prefill": L * 3, "decode_attention": L * n, "decode_attention_int8": L * n,
                **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"int8 launches {got}, expected {expected}")
    log("slice", f"int8 weights + int8 KV cache, 3 requests x 4 images, greedy, 128 new tokens: "
                 f"decode steps {steps}, lengths {[l.tolist() for _, l, _ in served]}; launches "
                 f"quant_matmul {got['quant_matmul']} = 96 x ({3} prefills + {n} decode steps) "
                 f"(GEMV {got['quant_matmul_gemv']}, wgmma tile {got['quant_matmul_wgmma']}), int8 "
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


# ---------------------------------------------------------------------------
# text2svg: captions in, no vision tower (phases 4 and 6)
# ---------------------------------------------------------------------------

# captions of 6, 13, 26 and 30 tokens through the byte-level test tokenizer
# (caption + <svg-start>; the last is cut at the API's max_length of 30)
CAPTIONS = ("heart", "a red circle", "a green triangle on white",
            "a minimalist icon of a blue house with a chimney")


def text2svg_requester(model):
    """request(images, max_new_tokens=128, prompt_ids=None) -> (tokens,
    lengths, seconds): the API's generate_text2svg_ids on as many captions
    as `images` has entries (so that serving_times drives it as it drives
    an im2svg request), greedy, host clock around a synchronised request."""
    calls = iter(range(1 << 30))

    def request(images, max_new_tokens: int = 128, prompt_ids=None):
        first = next(calls)  # each request starts one caption further on
        captions = [CAPTIONS[(first + i) % len(CAPTIONS)] for i in range(len(images))]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, tokens, lengths = model.generate_text2svg_ids(
            {"caption": captions}, max_new_tokens=max_new_tokens, use_nucleus_sampling=False)
        torch.cuda.synchronize()
        return tokens, lengths, time.perf_counter() - t

    return request


def text2svg_slice(tfa, label: str, model, p32, cfg32, dev, depth_note: str) -> dict:
    """text2svg through the API at full width: a request of 4 captions (6
    to 30 tokens, left-padded) and one of 1, greedy, 128 new tokens, with
    exact launch counts: a prompt of at most 64 tokens takes the chunk step
    (plain PyTorch: no flash_prefill), then one decode_attention a layer a
    step; then fp32 greedy ids of 2 captions, 32 tokens, kernels against
    plain, on the fp32 tree `p32` (cfg32's depth, told by `depth_note`).
    Returns the requester and the launch counts."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = model.cfg.llm.n_layer
    request = text2svg_requester(model)
    request([None] * 4, max_new_tokens=8)  # warm-up
    reset_counts(tfa)
    served = [request([None] * 4), request([None])]
    counts = read_counts(tfa)
    steps = [int(lengths.max()) - 1 for _, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape[1] != 128 or int(tokens.min()) < 0 or \
                int(tokens.max()) >= model.cfg.llm.vocab_size:
            raise AssertionError(f"{label} text2svg: bad tokens {tuple(tokens.shape)}")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"{label} text2svg: bad lengths {lengths.tolist()}")
    expected = {"flash_prefill": 0, "decode_attention": L * sum(steps),
                "decode_attention_int8": 0, "quant_matmul": 0, **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"{label} text2svg launches {got}, expected {expected}")
    prompt = [min(len(model.tokenizer.token_ids(c)) + 1, 30) for c in CAPTIONS]
    log("text2svg", f"{label}: requests of 4 captions and of 1 ({prompt} prompt tokens, "
                    f"left-padded), greedy, 128 new tokens: decode steps {steps}, "
                    f"lengths {[l.tolist() for _, l, _ in served]}; launches flash_prefill 0 (the "
                    f"prompts take the chunk step), decode_attention {got['decode_attention']} = "
                    f"{L} x {sum(steps)} decode steps, no int8 or training kernel")
    f32 = DTypePolicy(torch.float32, torch.float32)
    ids = {}
    for kernels in (True, False):
        m32 = StarVectorForCausalLM(p32, cfg32, model.tokenizer, policy=f32, device=dev,
                                    kernels=kernels)
        ids[kernels] = m32.generate_text2svg_ids({"caption": list(CAPTIONS[1:3])},
                                                 max_new_tokens=32,
                                                 use_nucleus_sampling=False)[1]
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"{label} text2svg fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    log("text2svg", f"{label}: fp32, B=2, 32 tokens, {depth_note}: greedy ids with the kernels "
                    f"== with the plain versions ({[len(set(r.tolist())) for r in ids[True]]} "
                    f"distinct ids per row)")
    return dict(request=request, counts=got)


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


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per eager fn() call between two CUDA events (for the autograd
    backward, which is not captured in a graph, and library calls that take
    tenths of a second): the host's per-op cost is small beside a
    millisecond of device work."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DECODE_TIMES = ((4, 325), (8, 1285), (1, 1285))  # the 1B decode mid-request; the end of a 1k-token one


def host_us(fn, iters: int = 10_000, rounds: int = 3) -> float:
    """The calling thread's CPU microseconds per eager fn() call (the
    wrapper's host cost, launch included): `iters` calls back to back after
    a synchronisation, the least of `rounds` such runs. CPU time, not wall
    time: the machine's host is shared, and a thread that waits for a core
    is not charged for the wait. The thread's CPU clock may tick as coarsely
    as 10 ms, hence the long runs (1 us a call at 10,000 calls)."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.thread_time()
        for _ in range(iters):
            fn()
        best = min(best, time.thread_time() - t)
    torch.cuda.synchronize()
    return best / iters * 1e6


def decode_times(tfa, dc, dev, card: str) -> dict:
    """decode_attention's device time against its plain version, its bound
    and SDPA, bf16 and over an int8 cache (bf16 queries), every key visible,
    the self token merged, at B=4 T=325 (64 tokens into a 1B request) and at
    B=8 and B=1, T=1285 (the end of a 1k-token request); with its host cost
    a call at B=4 T=325. Returns B=4 T=325's figures by cache
    ("bf16", "int8"): ms, plain_ms, bound_ms, bound_by, library_ms."""
    g = torch.Generator(device=dev).manual_seed(3)
    H, D = 16, 128
    rows = {}
    for B, T in DECODE_TIMES:
        qg = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
        kn, vn = (torch.randn((B, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        kc, vc = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        old = torch.ones((B, T), dtype=torch.int32, device=dev)
        (kq, ks), (vq, vs) = dc.quantize_kv(kc.float()), dc.quantize_kv(vc.float())
        shape = f"B={B} T={T} G=16 D=128"
        # q, out, k_new, v_new, mask; the cache read once
        small = 2 * B * H * D * 2 + 2 * B * D * 2 + B * T * 4
        flops = 4 * D * H * B * (T + 1)
        for label, cache in (("bf16", (kc, vc, None, None)), ("int8", (kq, vq, ks, vs))):
            kk, vv, sk, sv_ = cache

            def kernel():
                return tfa.merged_decode_attention(qg, kn, vn, kk, vv, old, D**-0.5, sk, sv_)

            times = _turns(
                lambda: tfa.merged_decode_attention(qg, kn, vn, kk, vv, old, D**-0.5, sk, sv_,
                                                    kernels=False), kernel)
            cache_bytes = 2 * B * T * D * (2 if label == "bf16" else 1) + \
                (0 if label == "bf16" else 2 * B * T * 4)
            b_ms, b_by = bound(cache_bytes + small, flops)
            lib = None
            if label == "bf16":  # SDPA over the cache and the new token
                keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).expand(B, H, T + 1, D)
                        .contiguous() for c, n in ((kc, kn), (vc, vn))]
                lib = sdpa_ms(qg.reshape(B, H, 1, D), *keys, causal=False)
            host = f", {host_us(kernel):.1f} us of host CPU a call" if B == 4 else ""
            log("times", f"{card}: decode_attention {label} cache {shape}, bf16 queries: kernel "
                         f"{times[1]:.4f} ms{host}, plain {times[0]:.4f} ms, bound {b_ms:.5f} ms "
                         f"({b_by}: {cache_bytes / 1e6:.3f} MB of cache), SDPA "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}"
                         + ("" if label == "bf16" else " (no single PyTorch call attends over an "
                            "int8 cache)"))
            if B == 4:
                rows[label] = dict(ms=times[1], plain_ms=times[0], bound_ms=b_ms, bound_by=b_by,
                                   library_ms=lib)
    return rows


def tower_prefix_times(tfa, dev, card: str, S: int = 1026) -> dict:
    """flash_prefill (bf16) at siglip_512's im2svg prefix, B = 2, S = T =
    1026 (1024 visual tokens and a 2-id prompt; phase 4f), H=16 Hkv=1,
    against its plain version, its bound and SDPA (K/V expanded to the 16
    heads), graph-replayed, in turns."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, D = 2, 16, 128
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    plain_ms, ms = _turns(lambda: tfa.flash_prefill(q, k, v, mask, kernels=False),
                          lambda: tfa.flash_prefill(q, k, v, mask))
    lib = sdpa_ms(q.transpose(1, 2).contiguous(),
                  *(t.transpose(1, 2).expand(B, H, S, D).contiguous() for t in (k, v)),
                  causal=True)
    nbytes = 2 * B * S * H * D * 2 + 2 * B * S * D * 2 + B * S * 4
    flops = 4 * D * H * B * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops)
    log("times", f"{card}: flash_prefill B={B} S=T={S} H={H} Hkv=1 D={D} bf16 (siglip_512's "
                 f"prefix): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                 f"{b_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                 f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), SDPA "
                 f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def _sdpa_causal(S: int, T: int) -> dict:
    """SDPA's causal arguments with the last of S queries on the last of T
    keys (the kernels' q_offset = T - S)."""
    from torch.nn.attention.bias import causal_lower_right

    return dict(is_causal=True) if S == T else dict(attn_mask=causal_lower_right(S, T))


def sdpa_ms(q, k, v, causal: bool, **kw):
    """F.scaled_dot_product_attention on (B, H, S, D) queries over
    (B, H, T, D) keys, K/V expanded to all heads (or (B, Hkv, T, D) with
    enable_gqa=True in `kw`); causal with the last query on the last key
    (lower right, which is top left when S = T). The faster of the backend
    it dispatches to by itself and its flash or memory-efficient backend
    (the two differ for one-token decode)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = _sdpa_causal(q.shape[2], k.shape[2]) if causal else {}

    def fused():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, **mask, **kw)

    times = [library_ms(lambda: F.scaled_dot_product_attention(q, k, v, **mask, **kw),
                        "scaled_dot_product_attention"),
             library_ms(fused, "scaled_dot_product_attention, flash/efficient")]
    times = [t for t in times if t is not None]
    return min(times) if times else None


# M = 144: a fused decode+chunk step of phase 4e (B = 16 rows x (1 + C = 8))
QMM_TIMES = ((1, "gemv"), (4, "gemv"), (8, "gemv"), (144, "tile"), (260, "tile"), (1040, "tile"))


def quant_matmul_times(tq, dev, card: str) -> dict:
    """Kernel 14 against its plain version, the library's int8 weight
    matmul (torch._weight_int8pack_mm, where this torch has it for CUDA) and
    the bf16 cuBLAS addmm, at M = 1, 4, 8 (the GEMV: decode at B = 1, 4, 8),
    144 (the tile: a fused decode+chunk step of phase 4e), 260 and 1040 (a
    B=1 and a B=4 prefill) for the four projections, bf16 x with a bf16
    bias, each beside its bound (the tile also in TFLOP/s and share of the
    bound, and at every width and split of K that tile_plan weighs); the
    host cost a call of the GEMV at M = 4; then one prefill's 96
    projections (prefill_projection_times). Returns mlp.c_fc's figures, the
    largest, by path ("gemv" at M = 4, "tile" at M = 1040, "tile_m144"):
    ms, plain_ms, bound_ms, bound_by, library_ms, addmm_ms."""
    g = torch.Generator(device=dev).manual_seed(10)
    rows = {}
    for M, path in QMM_TIMES:
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
            flops = 2 * M * K * N
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, flops)
            for key, val in (("ms", ms), ("plain", plain_ms), ("addmm", addmm_ms), ("bound", b_ms)):
                total[key] += val
            extra = ""
            if M == 4 and name == "mlp.c_fc":
                us = host_us(lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16))
                extra = f", {us:.1f} us of host CPU a call"
            if path == "tile":
                extra = f" ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound)"
            log("times", f"{card}: quant_matmul {path} {name} M={M} K={K} N={N} bf16: kernel "
                         f"{ms:.4f} ms{extra}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                         f"({b_by}), int8pack_mm {'n/a' if lib is None else f'{lib:.4f} ms'}, "
                         f"bf16 addmm {addmm_ms:.4f} ms (reads 2 bytes a weight)")
            if path == "tile" and hasattr(tq, "tile_plan"):
                tile_plan_times(tq, x, kq, sc, b, name, card)
            if name == "mlp.c_fc" and M in (4, 144, 1040):
                rows[path if M != 144 else "tile_m144"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib if lib is not None else addmm_ms, addmm_ms=addmm_ms)
        log("times", f"{card}: quant_matmul {path}, M={M}, one layer's four projections: kernel "
                     f"{total['ms']:.4f} ms, plain {total['plain']:.4f} ms, bf16 addmm "
                     f"{total['addmm']:.4f} ms, bound {total['bound']:.4f} ms; x 24 layers: "
                     f"kernel {24 * total['ms']:.3f} ms, bf16 addmm {24 * total['addmm']:.3f} ms")
    rows["prefill"] = prefill_projection_times(tq, dev, card)
    return rows


def tile_plan_times(tq, x, kq, sc, b, name: str, card: str) -> None:
    """The wgmma tile at each height (rows of x a block) and split of K that
    tile_plan weighs, launched directly (bf16 out), beside the plan
    tile_plan picks: the figures its fixed rule is held to."""
    M, K = x.shape
    N = kq.shape[1]
    parts, times = [], {}
    for tile_x in tq.TILE_XS:
        for want in range(1, 9):
            kc = 2 * tq.TILE_K * -(-K // (want * 2 * tq.TILE_K))
            splits = -(-K // kc)
            if (tile_x, splits) in times:
                continue
            times[tile_x, splits] = cuda_ms(lambda: tq.launch_kernel(
                x, kq, sc, b, torch.bfloat16, "wgmma", tile_x, splits, kc))
            parts.append(f"{tile_x} x{splits} {times[tile_x, splits]:.4f}")
    tile_x, splits, _ = tq.tile_plan(M, K, N)
    fastest = min(times, key=times.get)
    log("times", f"{card}: quant_matmul tile {name} M={M}: ms by rows of x a block x splits of "
                 f"K: {', '.join(parts)}; tile_plan picks {tile_x} x{splits} "
                 f"({times[tile_x, splits]:.4f} ms), the fastest is {fastest[0]} x{fastest[1]}")


def prefill_projection_times(tq, dev, card: str, layers: int = 24) -> dict:
    """One prefill's 96 int8 projections (24 layers x 4, each with its own
    codes: about 1 GB, so they come from HBM and not from the 50 MB L2, as
    a single reused weight would) captured as one graph, at M = 260 (B=1)
    and M = 1040 (B=4), beside the same 96 bf16 cuBLAS addmm calls over the
    dequantized weights (2 GB). Returns {M: (kernel ms, addmm ms)}."""
    g = torch.Generator(device=dev).manual_seed(12)
    weights = []
    for _ in range(layers):
        for _, K, N in QMM_SHAPES:
            kq = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            sc = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-4
            weights.append((kq, sc, torch.randn((N,), generator=g, device=dev).bfloat16()))
    w16 = [(kq.float() * sc).bfloat16() for kq, sc, _ in weights]
    out = {}
    for M in (260, 1040):
        xs = {K: torch.randn((M, K), generator=g, device=dev).bfloat16()
              for K in {K for _, K, _ in QMM_SHAPES}}

        def kernel():
            for kq, sc, b in weights:
                tq.quant_matmul(xs[kq.shape[0]], kq, sc, b, out_dtype=torch.bfloat16)

        def addmm():
            for (kq, _, b), w in zip(weights, w16):
                torch.addmm(b, xs[kq.shape[0]], w)

        ms, addmm_ms = cuda_ms(kernel, iters=4), cuda_ms(addmm, iters=4)
        flops = 2 * M * layers * sum(K * N for _, K, N in QMM_SHAPES)
        codes = sum(w.numel() for w, _, _ in weights) / 1e9
        log("times", f"{card}: quant_matmul, one prefill's {len(weights)} projections over "
                     f"{layers} layers' own weights ({codes:.2f} GB of codes), M={M}, one "
                     f"graph: kernel {ms:.3f} ms "
                     f"({flops / ms / 1e9:.1f} TFLOP/s), bf16 addmm {addmm_ms:.3f} ms "
                     f"({flops / addmm_ms / 1e9:.1f} TFLOP/s)")
        out[M] = (ms, addmm_ms)
    del weights, w16
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4b: the decoding variants and GRPO at full 1B width
# ---------------------------------------------------------------------------

class BatchSpy:
    """Within `with BatchSpy(module) as spy:`, spy.rows lists the batch of
    every call of module.forward (the decoders' cached and training
    forward), to show where a prefill ran at B rows and the steps at more."""

    def __init__(self, module):
        self.module, self.rows = module, []

    def __enter__(self):
        self.forward = self.module.forward

        def forward(params, cfg, x, *a, **kw):
            self.rows.append(x.shape[0])
            return self.forward(params, cfg, x, *a, **kw)

        self.module.forward = forward
        return self

    def __exit__(self, *exc):
        self.module.forward = self.forward


def expect_counts(what: str, counts: dict, **expected) -> dict:
    """Raise unless each named launch count is as given and every other
    kernel (the training ones, int8 decode, quant_matmul) launched none."""
    want = {"flash_prefill": 0, "decode_attention": 0, "decode_attention_int8": 0,
            "quant_matmul": 0, **dict.fromkeys(TRAIN_KERNELS, 0), **expected}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what} launches {got}, expected {want}")
    return got


def spec_ids(P: int, prompt: torch.Tensor) -> torch.Tensor:
    """The draft context of an im2svg prefix of P tokens: -1 over the
    visual tokens, then the prompt ids."""
    B, Sp = prompt.shape
    return torch.cat([torch.full((B, P - Sp), -1, dtype=torch.int64, device=prompt.device),
                      prompt], dim=1)


def first_parting(tokens: torch.Tensor, ref: torch.Tensor) -> int | None:
    """The first position where two rows of ids differ, or None."""
    diff = (tokens != ref).nonzero()
    return int(diff[0]) if len(diff) else None


def same_as_greedy(tokens, lengths, ref, ref_len) -> list[bool]:
    """Per row: the same length and the same ids up to it."""
    return [int(a) == int(b) and torch.equal(t[:int(a)], r[:int(b)])
            for t, a, r, b in zip(tokens, lengths, ref, ref_len)]


def request_turns(card: str, what: str, requests: dict, images_of, rounds: int = 2) -> dict:
    """{label: (median seconds, median tokens/s)} of requests taken in turns
    a, b, ..., b, a each round on the same images (images_of(round)); tokens/s
    counts each row's emitted tokens (its length) over the request's wall
    time."""
    labels = list(requests)
    secs = {k: [] for k in labels}
    rates = {k: [] for k in labels}
    for r in range(rounds):
        images = images_of(r)
        for label in labels + labels[::-1]:
            _, lengths, t = requests[label](images)
            secs[label].append(t)
            rates[label].append(float(lengths.sum()) / t)
    out = {k: (statistics.median(secs[k]), statistics.median(rates[k])) for k in labels}
    log("times", f"{card}: {what}, in turns ({2 * rounds} requests each): "
                 + "; ".join(f"{k} {v[0] * 1e3:.1f} ms ({[round(x * 1e3, 1) for x in secs[k]]}), "
                             f"{v[1]:.1f} tokens/s" for k, v in out.items()))
    return out


def decoding_1b(tfa, model, cfg, p16, p32, q16, dev, card: str) -> dict:
    """Phase 4b, the decoding variants at full 1B width on phase 4's weights
    (projections scaled by 3, the fixed "<svg" / "</svg>" ids), each with
    exact launch counts, through the API unless said:
      * beam search, num_beams=2, B=2, 128 new tokens: one flash_prefill a
        layer over B x K = 4 rows, one decode_attention a layer a step;
        fp32 ids kernels == plain;
      * num_return_sequences=4 over B=2, greedy: the prefill once at B=2
        rows, the steps at 8; each group of 4 rows the same, and in fp32
        equal to its n=1 row; fp32 ids kernels == plain. Then over the int8
        decoder and an int8 cache (engine.generate): kernel 14's GEMV at
        M = 8 and kernel 2's int8 instantiation over the tiled codes and
        scales;
      * speculative decoding, B=1 (linear cache) and B=4 (ragged):
        flash_prefill only (the verify is the chunk step, plain PyTorch);
        n_forwards and tokens a forward (generate_greedy_speculative*
        directly); fp32 ids == plain greedy generate with the kernels; in
        bf16, the rows that part from plain greedy (near-tie flips between
        the verify's and the decode step's arithmetic);
      * times in turns: B=1 latency of greedy, speculative and beam K=2;
        B=4 tokens/s of greedy and batched speculative;
      * GRPO: grpo_step (below).
    Random weights: an acceptance rate here is no forecast for real SVG."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.generation import speculative
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix
    from starvector_tpu_torch.models import gpt_bigcode
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = model.policy
    request = api_requester(model)
    m32 = {k: StarVectorForCausalLM(p32, cfg, policy=f32, device=dev, kernels=k)
           for k in (True, False)}
    two = synthetic_images(2, 31)
    x2 = model.process_images(two)
    greedy2 = {**GREEDY, "prompt_ids": [PROMPT_IDS] * 2}
    fp32_2 = {**greedy2, "max_new_tokens": 32}

    # --- beam search ---
    request(two, num_beams=2, max_new_tokens=4, prompt_ids=[PROMPT_IDS] * 2)  # warm-up
    reset_counts(tfa)
    with BatchSpy(gpt_bigcode) as spy:
        tokens, lengths, _ = request(two, num_beams=2, prompt_ids=[PROMPT_IDS] * 2)
    counts = read_counts(tfa)
    steps = len(spy.rows) - 1
    expect_counts("beam", counts, flash_prefill=L, decode_attention=L * steps)
    if spy.rows != [4] * (steps + 1) or not int(lengths.max()) - 1 <= steps <= 127 or \
            tokens.shape != (2, 128):
        raise AssertionError(f"beam: forwards at rows {spy.rows}, lengths {lengths.tolist()}")
    ids = {k: m32[k].generate_im2svg_ids({"image": x2}, num_beams=2, **fp32_2)[1:]
           for k in (True, False)}
    if not all(torch.equal(a, b) for a, b in zip(ids[True], ids[False])):
        raise AssertionError(f"beam fp32 ids differ:\n{ids[True]}\n{ids[False]}")
    log("decoding", f"beam search, num_beams=2, B=2, 128 new tokens, bf16: lengths "
                    f"{lengths.tolist()}; {steps + 1} forwards, all at B x K = 4 rows; launches "
                    f"flash_prefill {counts['flash_prefill']} = {L} x 1 prefill, decode_attention "
                    f"{counts['decode_attention']} = {L} x {steps} steps; fp32, 32 tokens: ids and "
                    f"lengths with the kernels == plain ({ids[True][1].tolist()})")

    # --- num_return_sequences ---
    n = 4
    reset_counts(tfa)
    with BatchSpy(gpt_bigcode) as spy:
        tokens, lengths, _ = request(two, num_return_sequences=n, prompt_ids=[PROMPT_IDS] * 2)
    counts = read_counts(tfa)
    steps = int(lengths.max()) - 1
    expect_counts("num_return_sequences", counts, flash_prefill=L, decode_attention=L * steps)
    if spy.rows != [2] + [2 * n] * steps or tokens.shape != (2 * n, 128):
        raise AssertionError(f"num_return_sequences: forwards at rows {spy.rows}")
    groups = tokens.view(2, n, -1)
    if not all(torch.equal(g[0], g[i]) for g in groups for i in range(n)):
        raise AssertionError("num_return_sequences: a greedy group's rows differ")
    one, one_len, _ = request(two, prompt_ids=[PROMPT_IDS] * 2)
    agree = (groups[:, 0] == one).float().mean().item()
    rep32 = {k: m32[k].generate_im2svg_ids({"image": x2}, num_return_sequences=n, **fp32_2)[1:]
             for k in (True, False)}
    one32 = m32[True].generate_im2svg_ids({"image": x2}, **fp32_2)[1:]
    if not all(torch.equal(a, b) for a, b in zip(rep32[True], rep32[False])) or \
            not torch.equal(rep32[True][0], one32[0].repeat_interleave(n, 0)) or \
            not torch.equal(rep32[True][1], one32[1].repeat_interleave(n, 0)):
        raise AssertionError(f"num_return_sequences fp32: kernels {rep32[True]}, plain "
                             f"{rep32[False]}, n=1 {one32}")
    log("decoding", f"num_return_sequences={n}, B=2, greedy, 128 new tokens, bf16: one prefill "
                    f"at 2 rows, {steps} steps at {2 * n}; launches flash_prefill "
                    f"{counts['flash_prefill']} = {L} x 1, decode_attention "
                    f"{counts['decode_attention']} = {L} x {steps}; each group's {n} rows "
                    f"identical, agreeing with the n=1 rows on {agree:.4f} of the positions "
                    f"(bf16: the decode kernel splits its keys by batch size); fp32, 32 tokens: "
                    f"kernels == plain, and every row == its n=1 row")

    prompt2 = torch.tensor([PROMPT_IDS] * 2, device=dev)

    def int8_rep(params, policy, kernels, max_new_tokens, kv_cache_dtype=torch.int8):
        emb, mask = im2svg_prefix(params, cfg, x2, prompt2, policy=policy)
        gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                               stop_sequences=STOP_IDS, num_return_sequences=n)
        return generate(params["svg_transformer"], cfg.llm, emb, mask, gen, prompt_ids=prompt2,
                        policy=policy, kernels=kernels, kv_cache_dtype=kv_cache_dtype)

    reset_counts(tfa)
    tokens, lengths = int8_rep(q16, bf16, True, 128)
    counts = read_counts(tfa)
    steps = int(lengths.max()) - 1
    got = expect_counts("num_return_sequences int8", counts, flash_prefill=L,
                        decode_attention=L * steps, decode_attention_int8=L * steps,
                        quant_matmul=4 * L * (1 + steps))
    if (counts["quant_matmul_gemv"], counts["quant_matmul_wgmma"]) != (4 * L * steps, 4 * L):
        raise AssertionError(f"num_return_sequences int8: quant_matmul paths {counts}")
    groups = tokens.view(2, n, -1)
    if not all(torch.equal(g[0], g[i]) for g in groups for i in range(n)):
        raise AssertionError("num_return_sequences int8: a greedy group's rows differ")
    # fp32 ids, kernels against plain, with the int8 weights and an fp32
    # cache: over an int8 cache the two paths' k/v differ in fp32 sum order,
    # some round to the next code, and greedy ids part by chance (PR 12,
    # call 1: at token 26 of 32 in one of the 2 prompts; PERF.md section 6)
    q32 = quantized(p32)
    ids = {k: int8_rep(q32, f32, k, 32, torch.float32) for k in (True, False)}
    del q32
    if not all(torch.equal(a, b) for a, b in zip(ids[True], ids[False])):
        raise AssertionError(f"num_return_sequences int8 fp32 ids differ:\n{ids[True]}\n"
                             f"{ids[False]}")
    log("decoding", f"num_return_sequences={n} over the int8 decoder and an int8 cache, B=2, "
                    f"128 new tokens: {steps} steps at {2 * n} rows; launches quant_matmul "
                    f"{got['quant_matmul']} (GEMV {counts['quant_matmul_gemv']} = 96 x {steps} "
                    f"steps at M = {2 * n}, tile {counts['quant_matmul_wgmma']} = 96 x 1 prefill), "
                    f"int8 decode_attention {got['decode_attention_int8']} = {L} x {steps} over "
                    f"the tiled codes and scales, flash_prefill {got['flash_prefill']}; groups "
                    f"identical; fp32, int8 weights and an fp32 cache, 32 tokens: ids kernels "
                    f"== plain")

    # --- speculative decoding ---
    four = synthetic_images(4, 41)
    x4 = model.process_images(four)
    prompt4 = torch.tensor([PROMPT_IDS] * 4, device=dev)
    spec = dict(use_speculative=True, draft_len=8)
    for B in (1, 4):
        request(four[:B], max_new_tokens=8, prompt_ids=[PROMPT_IDS] * B, **spec)  # warm-up
        reset_counts(tfa)
        tokens, lengths, _ = request(four[:B], prompt_ids=[PROMPT_IDS] * B, **spec)
        expect_counts(f"speculative B={B}", read_counts(tfa), flash_prefill=L)
    log("decoding", f"speculative decoding through the API (use_speculative, draft_len 8), bf16, "
                    f"B=1 and B=4, 128 new tokens: launches flash_prefill {L} a request (the "
                    f"prefill), no decode_attention: each verify is the chunk step, plain PyTorch")
    sp = speculative_checks("1B", cfg, p16, bf16, cfg, p32, f32, x4, prompt4)
    # --- times, in turns ---
    b1 = request_turns(card, "1B bf16 B=1 image -> SVG latency, 128 new tokens", {
        "greedy": lambda im: request(im, prompt_ids=[PROMPT_IDS]),
        "speculative": lambda im: request(im, prompt_ids=[PROMPT_IDS], **spec),
        "beam K=2": lambda im: request(im, prompt_ids=[PROMPT_IDS], num_beams=2),
    }, lambda r: synthetic_images(1, 300 + r), rounds=3)
    b4 = request_turns(card, "1B bf16 B=4 request, 128 new tokens (tokens/s = emitted tokens / "
                             "wall time)", {
        "greedy": lambda im: request(im),
        "speculative": lambda im: request(im, **spec),
    }, lambda r: synthetic_images(4, 400 + r))
    del m32
    return dict(b1=b1, b4=b4, **sp)


def speculative_checks(label: str, cfg, p16, bf16, cfg32, p32, f32, x, prompt) -> dict:
    """Speculative decoding through generate_greedy_speculative (row 0) and
    generate_greedy_speculative_batched (all rows of x), draft_len 8: in
    bf16 at 128 new tokens, n_forwards, tokens a verify forward and the
    rows that part from plain greedy generate (near-tie flips between the
    verify's chunk arithmetic and the decode kernel's; printed, not
    checked); in fp32 at 32 tokens on (cfg32, p32), ids and lengths equal
    to plain greedy generate with the kernels (checked)."""
    from starvector_tpu_torch.generation import speculative
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix

    out = {}
    for what, c, params, policy, new in (("bf16", cfg, p16, bf16, 128),
                                         ("fp32", cfg32, p32, f32, 32)):
        dec = params["svg_transformer"]
        emb, mask = im2svg_prefix(params, c, x, prompt, policy=policy)
        ids = spec_ids(emb.shape[1], prompt)
        kw = dict(max_new_tokens=new, draft_len=8, stop_sequences=STOP_IDS, policy=policy)
        ref, ref_len = generate(dec, c.llm, emb, mask, GenerationConfig(
            max_new_tokens=new, do_sample=False, stop_sequences=STOP_IDS), policy=policy)
        t1, l1, f1 = speculative.generate_greedy_speculative(dec, c.llm, emb[:1], mask[:1],
                                                             ids[:1], **kw)
        tb, lb, fb = speculative.generate_greedy_speculative_batched(dec, c.llm, emb, mask, ids,
                                                                     **kw)
        same = same_as_greedy(t1, l1, ref[:1], ref_len[:1]) + same_as_greedy(tb, lb, ref, ref_len)
        parts = [first_parting(t, r) for t, r in zip(torch.cat([t1[:, :new], tb]),
                                                      torch.cat([ref[:1], ref]))]
        if what == "fp32" and not all(same):
            raise AssertionError(f"{label} speculative fp32 ids differ from greedy:\n"
                                 f"{t1.tolist()}\n{tb.tolist()}\n{ref.tolist()}")
        B = x.shape[0]
        log("decoding", f"{label} speculative decoding, {what}, draft_len 8, {new} new tokens: "
                        f"B=1 length {int(l1[0])}, n_forwards {f1} "
                        f"({int(l1[0]) / max(f1 - 1, 1):.2f} tokens a verify forward); batched "
                        f"B={B}: lengths {lb.tolist()}, n_forwards {fb} "
                        f"({float(lb.sum()) / max(fb - 1, 1):.2f} tokens a round over {B} rows); "
                        + (f"rows parting from plain greedy generate: B=1 {int(not same[0])} of 1, "
                           f"batched {same[1:].count(False)} of {B}, at token {parts} (None: "
                           f"never; bf16 near-tie flips between the verify and the decode step)"
                           if what == "bf16" else "ids and lengths == plain greedy generate "
                                                  "with the kernels, every row"))
        out[what] = dict(n_forwards=(f1, fb), lengths=(l1.tolist(), lb.tolist()), parts=parts)
    log("decoding", f"{label}: random weights, so the acceptance above is no forecast for real "
                    f"SVG")
    return out


GRPO_B, GRPO_G, GRPO_NEW, GRPO_LR = 2, 4, 64, 1e-5


def grpo_rollout(roll: dict) -> dict:
    """The update's inputs from a generate_im2svg_grpo result, as
    GRPOTrainer.step builds them."""
    ids, P = roll["outputs"], roll["prompt_len"]
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    attn = (pos < P + roll["lengths"][:, None]).to(torch.int32)
    return {"vision_embeds": roll["inputs_embeds"][:, :roll["inputs_embeds"].shape[1] - P],
            "ids": ids, "attn_mask": attn, "loss_mask": attn * (pos >= P).to(torch.int32)}


def grpo_phase(sv, tfa, cfg, dev, card: str) -> dict:
    """GRPO at full 1B width: one GRPOTrainer.step (fp32 masters, bf16
    compute, remat "dots", AdamW at lr 1e-5; the decoder alone trains) at
    B=2 images, G=4 rollouts each, 64 new tokens, against a synthetic target
    raster (where this machine has no librsvg/cairo, a stand-in reward):
    the rollout launches flash_prefill once a layer (at B=2 rows) and
    decode_attention once a layer a step (at 8); the update 2 x 24
    forwards-with-lse (remat "dots" runs each layer's forward twice) and 24
    of each backward kernel; the loss finite; then the same step again,
    warm; the tower and the adapter unchanged, the decoder changed unless
    every group was scored alike; wall time split into rollout, reward and
    update for both steps, and peak memory. Then,
    on one rollout with fixed advantages, one fp32 update with the kernels
    against one with the plain attention from the same weights: loss rtol
    1e-4, grad_norm rtol 1e-3, updated weights within 3 lr (phase 5's
    bounds)."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.rasterize import rasterizer_available
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train import grpo
    from starvector_tpu_torch.train.optim import build_optimizer, tree_leaves

    L = cfg.llm.n_layer
    tok = build_test_tokenizer("v1")
    target = np.full((224, 224, 3), 255, np.uint8)  # a red square on white
    target[56:168, 56:168] = (220, 40, 40)
    p32 = full_width_params(sv, cfg, dev, torch.float32, seed=5)
    model = StarVectorForCausalLM(p32, cfg, tok, device=dev,
                                  policy=DTypePolicy(torch.float32, torch.bfloat16),
                                  generator=torch.Generator(device=dev).manual_seed(5))
    before = {k: [t.clone() for t in tree_leaves(v)] for k, v in p32.items()}
    trainer = grpo.GRPOTrainer(model, grpo.GRPOConfig(num_generations=GRPO_G,
                                                      max_new_tokens=GRPO_NEW),
                               lr=GRPO_LR, remat="dots")
    images = model.process_images(synthetic_images(GRPO_B, 51))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tfa)
    rewards = []
    batch_rewards = grpo.batch_rewards
    raster = rasterizer_available()
    if raster:
        reward_fn = batch_rewards
    else:
        # no librsvg/cairo here: every rollout would fall to the placeholder
        # and score 0 (after a worker process or two each), so the advantages
        # would be 0 and the update would move nothing. A stand-in reward,
        # the mean of each rollout's generated ids over the vocabulary's size
        # (its text says little: the byte-level test tokenizer decodes the
        # ids past its 261 to nothing), keeps the update real; the reward
        # chain itself is held to JAX's on the CPU (tests/test_torch_grpo.py)
        rollout = model.generate_im2svg_grpo

        def spied(*a, **kw):
            roll = rollout(*a, **kw)
            model.last_rollout = roll
            return roll

        model.generate_im2svg_grpo = spied

        def reward_fn(raw_svgs, targets, **kw):
            roll = model.last_rollout
            P = roll["prompt_len"]
            return np.asarray([row[P:P + n].double().mean().item() / cfg.llm.vocab_size
                               for row, n in zip(roll["outputs"].cpu(), roll["lengths"].tolist())],
                              np.float32)
    grpo.batch_rewards = lambda *a, **kw: rewards.append(reward_fn(*a, **kw)) or rewards[-1]
    try:
        with BatchSpy(cfg.decoder_module) as spy:
            out = trainer.step(images, [target] * GRPO_B)
        counts = read_counts(tfa)
        warm = trainer.step(images, [target] * GRPO_B)  # the same step again, warm
    finally:
        grpo.batch_rewards = batch_rewards
    peak = torch.cuda.max_memory_allocated()
    steps = len(spy.rows) - 2  # the rollout's prefill and steps, then the update's forward
    rows = [GRPO_B] + [GRPO_B * GRPO_G] * steps + [GRPO_B * GRPO_G]
    expect_counts("GRPO step", counts, flash_prefill=L, decode_attention=L * steps,
                  flash_prefill_with_lse=2 * L, flash_bwd_dkdv=L, flash_bwd_dq=L)
    if spy.rows != rows or not 0 <= steps < GRPO_NEW or not np.isfinite(out["loss"]):
        raise AssertionError(f"GRPO step: forwards at rows {spy.rows}, metrics {out}")
    source = ("svg_pixel_reward against the target" if raster else
              "a stand-in (no librsvg/cairo on this machine: rasterizer_available() is False)")
    moved = {k: [not torch.equal(a, b.detach()) for a, b in zip(before[k], tree_leaves(p32[k]))]
             for k in p32}
    # the updates move the decoder only if a group's rewards differ (a group
    # scored alike has advantages 0, and so no gradient)
    varies = any(bool((r.reshape(GRPO_B, GRPO_G).std(axis=1) > 0).any()) for r in rewards)
    if any(any(m) for k, m in moved.items() if k != "svg_transformer") or \
            varies != any(moved["svg_transformer"]) or not np.isfinite(warm["loss"]):
        raise AssertionError(f"GRPO step: leaves moved {moved}, metrics {out}")
    log("grpo", f"GRPOTrainer.step, StarVector-1B full width, B={GRPO_B} x G={GRPO_G}, "
                f"{GRPO_NEW} new tokens (sampled, T 1.0, top-p 0.9), fp32 masters / bf16 compute, "
                f"remat dots, AdamW lr {GRPO_LR}: rollout at rows {spy.rows[0]} then {steps} "
                f"steps at {GRPO_B * GRPO_G}; launches {counts['flash_prefill']} flash_prefill "
                f"+ {counts['decode_attention']} decode_attention (rollout), "
                f"{counts['flash_prefill_with_lse']} flash_prefill_with_lse + "
                f"{counts['flash_bwd_dkdv']} dkdv + {counts['flash_bwd_dq']} dq (update); "
                f"reward: {source}, "
                f"{[[round(float(x), 4) for x in r] for r in rewards]} over two steps (a group's "
                f"differ: {varies}); loss {out['loss']:.6f}, {warm['loss']:.6f}, grad_norm "
                f"{out['grad_norm']:.4e}, {warm['grad_norm']:.4e}; decoder leaves moved "
                f"{sum(moved['svg_transformer'])} of {len(moved['svg_transformer'])}, tower and "
                f"adapter none")
    log("times", f"{card}: GRPO step at 1B, B={GRPO_B} x G={GRPO_G}, {GRPO_NEW} new tokens, the "
                 f"first step and the same step again: "
                 + "; ".join(f"{(o['rollout_s'] + o['reward_s'] + o['update_s']) * 1e3:.1f} ms = "
                             f"rollout {o['rollout_s'] * 1e3:.1f} + reward "
                             f"{o['reward_s'] * 1e3:.1f} + update {o['update_s'] * 1e3:.1f} ms"
                             for o in (out, warm))
                 + f"; peak memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
                 f"the {base / 2**30:.2f} GiB held before (fp32 masters, their copy for the "
                 f"check, the decoder's AdamW state)")

    # fp32: one update with the kernels against one with the plain attention
    roll = grpo_rollout(model.generate_im2svg_grpo({"image": images}, num_return_sequences=GRPO_G,
                                                   max_new_tokens=GRPO_NEW))
    adv = torch.linspace(-1.0, 1.0, GRPO_B * GRPO_G, device=dev)
    del trainer, model, p32, before
    torch.cuda.empty_cache()
    f32 = DTypePolicy(torch.float32, torch.float32)
    res = {}
    for kernels in (True, False):
        params = full_width_params(sv, cfg, dev, torch.float32, seed=5)
        for t in tree_leaves(params["svg_transformer"]):
            t.requires_grad_()
        opt = build_optimizer(params, lr=GRPO_LR, weight_decay=0.0, train_image_encoder=False,
                              train_connector=False)
        step = grpo.make_grpo_step(cfg, opt, num_generations=GRPO_G, policy=f32, remat="dots",
                                   kernels=kernels)
        start = [t.detach().clone() for t in tree_leaves(params)]
        reset_counts(tfa)
        _, _, m = step(params, opt.init(params), roll, adv)
        n = {k: read_counts(tfa)[k] for k in TRAIN_KERNELS}
        moved = [not torch.equal(a, b.detach()) for a, b in zip(start, tree_leaves(params))]
        res[kernels] = (float(m["loss"]), float(m["grad_norm"]), n,
                        [t.detach() for t in tree_leaves(params["svg_transformer"])])
        del params, opt, step, start
    (l_k, g_k, n_k, w_k), (l_p, g_p, n_p, w_p) = res[True], res[False]
    diff = max((a - b).abs().max().item() for a, b in zip(w_k, w_p))
    n_dec = len(w_k)  # the decoder's leaves come first in the tree
    if not all(moved[:n_dec]) or any(moved[n_dec:]):
        raise AssertionError(f"GRPO fp32 update: leaves moved {moved}")
    if n_k != {"flash_prefill_with_lse": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L} or \
            any(n_p.values()) or abs(l_k - l_p) > 1e-4 * abs(l_p) or \
            abs(g_k - g_p) > 1e-3 * abs(g_p) or diff > 3 * GRPO_LR or not g_k > 0:
        raise AssertionError(f"GRPO fp32 update: kernels {l_k}, {g_k}, {n_k}; plain {l_p}, "
                             f"{g_p}, {n_p}; weights max |diff| {diff}")
    log("grpo", f"fp32 update on one rollout, advantages -1..1, kernels vs plain attention: loss "
                f"{l_k:.7f} vs {l_p:.7f} (rtol 1e-4), grad_norm {g_k:.6e} vs {g_p:.6e} (rtol "
                f"1e-3), updated decoder weights max |diff| {diff:.3e} (bound 3 lr = "
                f"{3 * GRPO_LR:.0e}); every decoder leaf moved, no tower or adapter leaf; "
                f"launches {n_k} with the kernels, none with plain")
    del res, w_k, w_p
    torch.cuda.empty_cache()
    return dict(out=out, peak=peak, counts=counts)


# ---------------------------------------------------------------------------
# phases 4c and 6d: continuous-batching serving (serve/engine.py, worker.py,
# controller.py) at full width
# ---------------------------------------------------------------------------

SERVE_PROMPTS = (  # prompt ids after the visual tokens: 4 prefixes of different lengths
    PROMPT_IDS, PROMPT_IDS + (312, 88), PROMPT_IDS + tuple(range(400, 412)),
    PROMPT_IDS + tuple(range(500, 531)))
SERVE_NEW = 128      # new tokens a request in the timed runs (no stop: every request runs them)
SERVE_CHECK_NEW = 32  # new tokens a request in the id checks


def serve_requests(engine, reqs, timeout: float = 600) -> list[dict]:
    """Submit `reqs` at once, then start the engine if it has not started
    (requests queued before the start admit as one group); read each
    request's events on a thread of its own and return, per request, its
    ids, time to first token and latency (host clock from the submission).
    Raises unless every request ended in ("done", ids) within `timeout`
    seconds an event."""
    import threading

    results: list = [None] * len(reqs)
    t0 = time.perf_counter()

    def consume(i, r):
        first = None
        while True:
            kind, payload = r.out_queue.get(timeout=timeout)
            now = time.perf_counter()
            if kind == "token" and first is None:
                first = now
            if kind != "token":
                results[i] = dict(kind=kind, ids=payload, ttft=(first or now) - t0,
                                  latency=now - t0)
                return

    threads = [threading.Thread(target=consume, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    for th in threads:
        th.start()
    for r in reqs:
        engine.submit(r)
    engine.start()
    for th in threads:
        th.join(timeout + 5)
    bad = [(i, res) for i, res in enumerate(results) if res is None or res["kind"] != "done"]
    if bad:
        raise AssertionError(f"serving: requests that did not end done: "
                             f"{[(i, None if r is None else (r['kind'], str(r['ids'])[:300])) for i, r in bad]}")
    return results


def serve_prefixes(params, cfg, images, policy, prompts=SERVE_PROMPTS) -> list[torch.Tensor]:
    """The im2svg prefix (1, P, E) of each image with its prompt ids."""
    from starvector_tpu_torch.generation.engine import im2svg_prefix

    dev = images.device
    return [im2svg_prefix(params, cfg, images[i:i + 1], torch.tensor([p], device=dev),
                          policy=policy)[0] for i, p in enumerate(prompts)]


def engine_ids(params, cfg, prefixes, policy, dev, tfa, *, kernels=True, kv=None):
    """(greedy ids of each prefix, SERVE_CHECK_NEW tokens with the stop,
    through a fresh engine at steps_per_tick 4; the launch counts; the
    engine's ticks): all requests queued before the start, so they admit as
    one group."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder, max_batch=8,
                         max_len=1024, policy=policy, kv_cache_dtype=kv, steps_per_tick=4,
                         device=dev, kernels=kernels)
    try:
        reqs = [Request(prefix_embeds=p, max_new_tokens=SERVE_CHECK_NEW, do_sample=False,
                        stop_sequences=STOP_IDS) for p in prefixes]
        reset_counts(tfa)
        res = serve_requests(engine, reqs)
        counts = read_counts(tfa)
        ticks = engine.stats()["ticks"]
    finally:
        engine.stop()
    return [r["ids"] for r in res], counts, ticks


def offline_ids(model_cls, params, cfg, images, policy, dev) -> list[list[int]]:
    """Offline greedy ids through generate_im2svg_ids at B = 1, a request
    an image with its SERVE_PROMPTS entry, cut at each one's length."""
    m = model_cls(params, cfg, policy=policy, device=dev)
    out = []
    for i, p in enumerate(SERVE_PROMPTS):
        _, toks, lengths = m.generate_im2svg_ids(
            {"image": images[i:i + 1]}, prompt_ids=[p], stop_sequences=STOP_IDS,
            max_new_tokens=SERVE_CHECK_NEW, use_nucleus_sampling=False)
        out.append(toks[0, :int(lengths[0])].tolist())
    return out


def serve_rates(card: str, label: str, runs: dict) -> dict:
    """Aggregate tokens/s, p50 time to first token and p50 latency of each
    serving run in `runs` {name: fn() -> per-request results, or (tokens,
    rows) of an offline call}, taken in turns a, b, ..., ..., b, a."""
    names = list(runs)
    rec = {n: [] for n in names}
    for n in names + names[::-1]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = runs[n]()
        torch.cuda.synchronize()
        rec[n].append((time.perf_counter() - t, res))
    out = {}
    for n in names:
        walls = [w for w, _ in rec[n]]
        res = rec[n][-1][1]
        if isinstance(res, tuple):  # offline: (tokens, rows)
            tokens = res[0]
            out[n] = dict(rate=tokens / statistics.median(walls), ttft=None, p50=None)
        else:
            tokens = sum(len(r["ids"]) for r in res)
            ttft = statistics.median(r["ttft"] for _, rs in rec[n] for r in rs)
            lat = statistics.median(r["latency"] for _, rs in rec[n] for r in rs)
            out[n] = dict(rate=tokens / statistics.median(walls), ttft=ttft, p50=lat)
        log("serve", f"{card}: {label} {n}: {out[n]['rate']:.1f} tokens/s ({tokens} tokens, "
                     f"walls {[round(w * 1e3, 1) for w in walls]} ms)"
                     + ("" if out[n]["ttft"] is None else
                        f", p50 time to first token {out[n]['ttft'] * 1e3:.1f} ms, p50 request "
                        f"latency {out[n]['p50'] * 1e3:.1f} ms"))
    return out


def throughput_runs(params, cfg, prefixes, policy, dev, *, kv=None, steps=(1, 4),
                    offline: bool = True) -> tuple[dict, list]:
    """{name: fn} of the timed runs: a warm engine a steps_per_tick value,
    all the prefixes submitted at once, greedy, SERVE_NEW tokens each
    without a stop; and offline generate at B = len(prefixes) over the same
    prefixes. Returns the runs and the engines (stop them after)."""
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    runs, engines = {}, []
    for spt in steps:
        engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder,
                             max_batch=max(8, len(prefixes)), max_len=2048, policy=policy,
                             kv_cache_dtype=kv, steps_per_tick=spt, device=dev)
        engines.append(engine)

        def run(engine=engine):
            return serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=SERVE_NEW,
                                                   do_sample=False) for p in prefixes])

        run()  # warm-up: the allocator's pools, cuBLAS handles
        runs[f"engine{' int8' if kv is not None else ''} steps_per_tick={spt}"] = run
    if offline:
        P = max(p.shape[1] for p in prefixes)
        emb = torch.cat([torch.nn.functional.pad(p, (0, 0, P - p.shape[1], 0)) for p in prefixes])
        mask = torch.stack([torch.arange(P, device=dev) >= P - p.shape[1] for p in prefixes]
                           ).to(torch.int32)
        gen = GenerationConfig(max_new_tokens=SERVE_NEW, min_new_tokens=SERVE_NEW,
                               do_sample=False, pad_token_id=0)

        def offline_run():
            toks, _ = generate(params["svg_transformer"], cfg.llm, emb, mask, gen, policy=policy,
                               kv_cache_dtype=kv)
            return (toks.numel(), len(prefixes))

        offline_run()
        runs[f"offline generate B={len(prefixes)}"] = offline_run
    return runs, engines


def png_b64(img: np.ndarray) -> str:
    """A uint8 RGB image as base64 PNG (the worker's im2svg payload)."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def rest_phase(p16, cfg, dev, card: str) -> None:
    """The port's worker and controller on 127.0.0.1 (standard-library HTTP
    servers in threads): the worker registers, then 4 concurrent streamed
    im2svg requests (base64 PNG payloads: PIL is on the card's machine)
    through the controller's relay, greedy, sampled, a beam group and
    text2svg, every chunk error_code 0; and /v1/chat/completions."""
    import concurrent.futures
    import threading

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.serve import controller as ctl
    from starvector_tpu_torch.serve import worker as wk
    from starvector_tpu_torch.serve.httpd import post_json, post_json_reply

    model = StarVectorForCausalLM(p16, cfg, build_test_tokenizer("v1"),
                                  policy=DTypePolicy(torch.bfloat16, torch.bfloat16), device=dev)
    worker = wk.ModelWorker(model, worker_addr="pending", max_batch=8, max_len=2048)
    servers = [wk.build_server(worker), ctl.build_server(ctl.Controller("shortest_queue"))]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for th in threads:
        th.start()
    wurl, curl = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)

    def stream(payload):
        t = time.perf_counter()
        with post_json(curl + "/worker_generate_stream", payload, 300) as resp:
            raw = resp.read()
        return [json.loads(c) for c in raw.split(b"\0") if c], time.perf_counter() - t

    try:
        worker.worker_addr, worker.controller_addr = wurl, curl
        worker.register()
        imgs = synthetic_images(3, 71)
        base = {"model": "starvector", "task": "im2svg", "max_new_tokens": SERVE_CHECK_NEW,
                "temperature": 0.0}
        payloads = [{**base, "image": png_b64(imgs[0])},
                    {**base, "image": png_b64(imgs[1]), "temperature": 0.8, "top_p": 0.9},
                    {**base, "image": png_b64(imgs[2]), "num_beams": 2},
                    {**base, "task": "text2svg", "prompt": "a red circle"}]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(stream, payloads, timeout=600))
        for (chunks, _), p in zip(outs, payloads):
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"REST: {p.get('task')} request failed: {chunks[-1:]}")
        chat = post_json_reply(wurl + "/v1/chat/completions", {
            "model": "starvector", "max_tokens": 8, "temperature": 0.0,
            "messages": [{"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": "data:image/png;base64," + png_b64(imgs[0])}}]}]}, 300)
        if chat.get("object") != "chat.completion" or not chat["choices"][0]["message"][
                "content"].startswith("<svg"):
            raise AssertionError(f"REST: /v1/chat/completions answered {str(chat)[:300]}")
        status = post_json_reply(wurl + "/worker_get_status", {}, 60)
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for th in threads:
            th.join(60)
        worker.shutdown()
    log("serve", f"{card}: REST: the port's worker and controller on 127.0.0.1; 4 concurrent "
                 f"streamed requests through the controller (greedy, sampled, beam K=2 im2svg "
                 f"as base64 PNG; text2svg), {SERVE_CHECK_NEW} new tokens, bf16: chunks "
                 f"{[len(c) for c, _ in outs]}, every error_code 0, seconds "
                 f"{[round(s, 2) for _, s in outs]}; /v1/chat/completions answered; the "
                 f"engine emitted {status['engine']['tokens_emitted']} tokens in "
                 f"{status['engine']['ticks']} ticks")


def mixed_batch(params, cfg, prefixes, policy, dev, card: str) -> None:
    """bf16, one engine with speculative ticks (spec_drafts=4): greedy,
    sampled, a stop sequence, a logit_bias, a beam group (K=2) and a
    greedy request whose prompt ids seed the drafts, all at once; every
    request must end done."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(params["svg_transformer"], cfg.llm, cfg.decoder, max_batch=8,
                         max_len=1024, policy=policy, spec_drafts=4, device=dev)
    p0, p1, p2, p3 = prefixes
    ref = serve_requests(engine, [Request(prefix_embeds=p0, max_new_tokens=24,
                                           do_sample=False)])[0]["ids"]
    reqs = dict(
        greedy=Request(prefix_embeds=p0, max_new_tokens=48, do_sample=False),
        sampled=Request(prefix_embeds=p1, max_new_tokens=48, temperature=0.9, top_p=0.9),
        stop=Request(prefix_embeds=p0, max_new_tokens=48, do_sample=False,
                     stop_sequences=((ref[10], ref[11]),)),
        logit_bias=Request(prefix_embeds=p2, max_new_tokens=48, do_sample=False,
                           logit_bias={ref[3]: 5.0}),
        beam=Request(prefix_embeds=p3, max_new_tokens=24, do_sample=False, num_beams=2),
        speculative=Request(prefix_embeds=p0, max_new_tokens=48, do_sample=False,
                            prompt_token_ids=list(PROMPT_IDS) + ref))
    try:
        res = dict(zip(reqs, serve_requests(engine, list(reqs.values()))))
        stats = engine.stats()
    finally:
        engine.stop()
    if res["greedy"]["ids"][:24] != ref or res["speculative"]["ids"][:24] != ref:
        log("serve", f"{card}: bf16 mixed batch: a greedy stream parted from the lone request's "
                     f"(bf16 verify and decode steps differ in sum order; not a check)")
    log("serve", f"{card}: bf16 mixed batch under speculative ticks (spec_drafts=4): "
                 + ", ".join(f"{k} {len(v['ids'])} tokens" for k, v in res.items())
                 + f", every request done; {stats['ticks']} ticks, {stats['spec_ticks']} "
                 f"speculative, {stats['spec_extra_tokens']} tokens from accepted drafts")


def profile_tick(engine_run, prefill_run, ticks: int, wall: float, wall0: float, card: str,
                 out_dir: Path, label: str) -> None:
    """The device-busy share of a serving tick: torch.profiler over a
    serving run and over an admission-only run (1 new token: no tick); the
    difference over the ticks against the unprofiled walls' difference."""
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        return sum(e.self_device_time_total for e in rows) / 1e3, prof

    full, prof = device_ms(engine_run)
    admit, _ = device_ms(prefill_run)
    if not full:
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_serve_{label}.txt").write_text(
        f"{card}\n{label}\n" + prof.key_averages().table(sort_by="self_device_time_total",
                                                         row_limit=50))
    dev_tick, wall_tick = (full - admit) / ticks, (wall - wall0) * 1e3 / ticks
    log("profile", f"{card}: serving tick, {label}: wall {wall_tick:.3f} ms without the "
                   f"profiler, device {dev_tick:.3f} ms under it, busy {dev_tick / wall_tick:.1%} "
                   f"({ticks} ticks; table in {out_dir}/profile_serve_{label}.txt)")


def serving_1b(tfa, cfg, p16, p32, q16, dev, card: str, profile_dir: Path | None) -> dict:
    """Phase 4c, on phase 4's 1B weights: the continuous-batching engine's
    id checks with exact launch counts, a mixed bf16 batch, int8 serving,
    the REST worker and controller, and the serving numbers."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    images = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch(
        synthetic_images(4, 31))
    # fp32: 4 concurrent requests (prefixes of 260 to 291 tokens: one
    # admission of 4 rows in bucket 512, one chunk) against offline B = 1
    # and against the engine with the plain attention
    pre32 = serve_prefixes(p32, cfg, images, f32)
    ids_k, counts, ticks = engine_ids(p32, cfg, pre32, f32, dev, tfa)
    ids_p, counts_p, _ = engine_ids(p32, cfg, pre32, f32, dev, tfa, kernels=False)
    ref = offline_ids(StarVectorForCausalLM, p32, cfg, images, f32, dev)
    if ids_k != ref or ids_p != ids_k:
        raise AssertionError(f"1B fp32 engine ids: kernels {ids_k}\nplain {ids_p}\noffline {ref}")
    expect_counts("1B engine fp32", counts, flash_prefill=L, decode_attention=L * 4 * ticks)
    expect_counts("1B engine fp32, plain", counts_p)
    log("serve", f"{card}: 1B engine, fp32, 4 concurrent requests (prefixes "
                 f"{[p.shape[1] for p in pre32]} tokens, one admission), {SERVE_CHECK_NEW} new "
                 f"tokens greedy with the stop: ids == offline generate_im2svg_ids B=1 == the "
                 f"engine with the plain attention (lengths {[len(i) for i in ids_k]}); "
                 f"launches flash_prefill {counts['flash_prefill']} = {L} x 1 chunk, "
                 f"decode_attention {counts['decode_attention']} = {L} x 4 x {ticks} ticks")
    # int8 weights and an int8 cache: fp32 ids against offline int8
    # generate; bf16 launch counts (96 kernel-14 launches a step and a chunk)
    q32 = _cast_tree(q16, torch.float32)
    i8k, _, _ = engine_ids(q32, cfg, pre32, f32, dev, tfa, kv=torch.int8)
    i8ref = offline_int8_ids(q32, cfg, pre32, f32)
    if i8k != i8ref:
        raise AssertionError(f"1B int8 fp32 engine ids {i8k}\noffline {i8ref}")
    del q32
    pre16 = serve_prefixes(p16, cfg, images, bf16)
    _, c8, ticks8 = engine_ids(q16, cfg, pre16, bf16, dev, tfa, kv=torch.int8)
    steps8 = 4 * ticks8
    expect_counts("1B engine int8", c8, flash_prefill=L, decode_attention=L * steps8,
                  decode_attention_int8=L * steps8, quant_matmul=4 * L * (1 + steps8))
    log("serve", f"{card}: 1B engine, int8 weights and an int8 KV cache: fp32 ids == offline "
                 f"int8 generate's ({[len(i) for i in i8k]} tokens); bf16 launches "
                 f"quant_matmul {c8['quant_matmul']} = {4 * L} x (1 chunk + {steps8} steps; GEMV "
                 f"{c8['quant_matmul_gemv']}, tile {c8['quant_matmul_wgmma']}), decode_attention "
                 f"{c8['decode_attention']} = {L} x {steps8}, all over the int8 cache")
    mixed_batch(p16, cfg, pre16, bf16, dev, card)
    rest_phase(p16, cfg, dev, card)
    # the numbers: 8 concurrent greedy requests of 128 new tokens
    imgs8 = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch(
        synthetic_images(8, 41))
    pre8 = serve_prefixes(p16, cfg, imgs8, bf16, prompts=(PROMPT_IDS,) * 8)
    runs, engines = throughput_runs(p16, cfg, pre8, bf16, dev)
    runs8, engines8 = throughput_runs(q16, cfg, pre8, bf16, dev, kv=torch.int8, steps=(4,),
                                      offline=False)
    try:
        rates = serve_rates(card, "1B bf16, 8 concurrent greedy im2svg requests of 128 tokens",
                            runs)
        rates.update(serve_rates(card, "1B, 8 concurrent requests, int8 against bf16",
                                 {**runs8, "engine steps_per_tick=4": runs["engine steps_per_tick=4"]}))
        if profile_dir is not None:
            from starvector_tpu_torch.serve.engine import Request

            engine = engines[1]
            t = time.perf_counter()
            ticks0 = engine.stats()["ticks"]
            runs["engine steps_per_tick=4"]()
            torch.cuda.synchronize()
            wall, ticks = time.perf_counter() - t, engine.stats()["ticks"] - ticks0

            def admit_only():
                return serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=1,
                                                       do_sample=False) for p in pre8])

            t = time.perf_counter()
            admit_only()
            torch.cuda.synchronize()
            wall0 = time.perf_counter() - t
            profile_tick(runs["engine steps_per_tick=4"], admit_only, ticks, wall, wall0, card,
                         profile_dir, "1b_bf16_steps4")
    finally:
        for e in engines + engines8:
            e.stop()
    # the serving path's launches (the fp32 run for kernels 1 and 2, the
    # bf16 int8 run for 2' and 14), beside phase 4's in the kernels' JSON
    launches = dict(flash_prefill=counts["flash_prefill"],
                    decode_attention=counts["decode_attention"],
                    decode_attention_int8=c8["decode_attention_int8"],
                    quant_matmul_gemv=c8["quant_matmul_gemv"],
                    quant_matmul_tile=c8["quant_matmul_wgmma"])
    return dict(rates=rates, launches=launches)


# ---------------------------------------------------------------------------
# phase 4d: the eval harness (validation/, metrics/) at full 1B width
# ---------------------------------------------------------------------------

EVAL_SEED = 51
EVAL_NEW = 64  # greedy new tokens a sample
EVAL_TOL = (1e-4, 1e-5)  # (rtol, atol): LPIPS and pool3 features, fp32 on the card against the CPU


class EvalDataset:
    """Phase 4d's in-memory dataset (a validator's `dataset.target`): the
    probe SVGs of validation/parity_samples.py as ground truth, and as the
    model's input seeded synthetic images (not rasters of those SVGs, so
    the inputs differ whether or not librsvg/cairo is there), processed by
    the port's processor on the host, beside the same images as PIL."""

    def __init__(self, n: int, seed: int, image_size: int):
        from PIL import Image

        from starvector_tpu_torch.data.processor import processor_for_encoder
        from starvector_tpu_torch.validation.parity_samples import SAMPLES

        raw = synthetic_images(n, seed)
        processed = processor_for_encoder("clip", image_size, device="cpu").batch(raw).numpy()
        self.items = [{"svg": SAMPLES[i][1], "id": f"{SAMPLES[i][0]}.svg", "caption": "",
                       "image": processed[i], "image_pil": Image.fromarray(raw[i])}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class IdsSpy:
    """Within `with IdsSpy(model) as spy:`, spy.calls lists (tokens,
    lengths) of every im2svg generation the API ran for `model`."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __enter__(self):
        inner = self.model._im2svg

        def run(*a, **kw):
            out = inner(*a, **kw)
            self.calls.append((out[1].clone(), out[2].clone()))
            return out

        self.model._im2svg = run
        return self

    def __exit__(self, *exc):
        del self.model._im2svg


def eval_config(out_dir: str, n: int, image_size: int, metrics: dict, engine: str = "jax",
                **model) -> dict:
    return {"run": {"out_dir": out_dir},
            "model": {"task": "im2svg", "name": "starvector-1b", "generation_engine": engine,
                      "from_checkpoint": None, **model},
            "dataset": {"target": f"{__name__}.EvalDataset", "dataset_name": "phase-4d",
                        "batch_size": 2, "num_samples": n,
                        "params": {"n": n, "seed": EVAL_SEED, "image_size": image_size}},
            "generation_params": {"max_new_tokens": EVAL_NEW, "temperature": 0.0,
                                  "generation_sweep": False},
            "metrics": metrics}


def timed_validator(v) -> dict:
    """Wrap the validator's stages in host-clock timers (synchronised);
    returns the dict they add seconds to."""
    secs: dict = {}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    v.generate_svg = timed("generation", v.generate_svg)
    v.post_process_svg = timed("post-processing", v.post_process_svg)
    v.save_results = timed("saving and rasterizing", v.save_results)
    v.calculate_and_save_metrics = timed("metrics", v.calculate_and_save_metrics)
    for name, m in v.metrics.active_metrics.items():
        if hasattr(m, "calculate_score"):
            m.calculate_score = timed(f"metric {name}", m.calculate_score)
    return secs


def within(a: torch.Tensor, b: torch.Tensor, tol=EVAL_TOL) -> tuple[bool, float, float]:
    """(|a - b| <= atol + rtol |b| everywhere, max |a - b|, max |a - b| / |b|)."""
    d = (a - b).abs()
    return (bool((d <= tol[1] + tol[0] * b.abs()).all()), d.max().item(),
            (d / b.abs().clamp_min(1e-30)).max().item())


def neural_metrics_card_vs_cpu(dev, card: str, weights: Path) -> dict:
    """LPIPS-VGG16 at 224 and InceptionV3 pool3 at 299 on the full-size
    random weights in `weights`, fp32 with TF32 off, on the card and on the
    CPU: per-pair distances and features within EVAL_TOL, the FID from the
    card's features against the CPU's, and ms per pair / per 16 images."""
    from PIL import Image

    from starvector_tpu_torch.metrics import inception_v3, lpips_vgg
    from starvector_tpu_torch.metrics.model_metrics import frechet_distance

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 leaves them
    torch.backends.cudnn.allow_tf32 = False
    gt = [Image.fromarray(im) for im in synthetic_images(8, EVAL_SEED)]
    gen = [Image.fromarray(im) for im in synthetic_images(8, EVAL_SEED + 1)]
    vgg_sd, lin_sd = (torch.load(weights / "lpips-vgg" / f, weights_only=True)
                      for f in ("vgg16.pth", "lpips_vgg.pth"))
    inc_sd = torch.load(weights / "inception" / "inception_v3.pth", weights_only=True)
    nets = {
        "LPIPS": (lambda d: lpips_vgg.LPIPSVGG.from_torch_state_dicts(vgg_sd, lin_sd, device=d),
                  (lpips_vgg.preprocess(gt[:4]), lpips_vgg.preprocess(gen[:4])),
                  lpips_vgg.lpips_distance, 1),
        "Inception": (lambda d: inception_v3.InceptionV3.from_torch_state_dict(inc_sd, device=d),
                      (inception_v3.preprocess(gt + gen),), inception_v3.features, 16)}
    out = {}
    for name, (make, inputs, run, timed_rows) in nets.items():
        res = {}
        for d in (dev, "cpu"):
            net = make(d)
            args = tuple(x.to(d) for x in inputs)
            res["card" if d is dev else "cpu"] = run(net, *args).cpu()
            one = tuple(x[:timed_rows] for x in args)
            if d is dev:
                res["card_ms"] = event_ms(lambda: run(net, *one), iters=10)
            else:
                t = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    run(net, *one)
                    t.append(time.perf_counter() - t0)
                res["cpu_ms"] = min(t) * 1e3
            del net
        ok, err, rel = within(res["card"], res["cpu"])
        if not ok or not torch.isfinite(res["card"]).all():
            raise AssertionError(f"{name} on the card against the CPU: max |diff| {err:.3e}, "
                                 f"max relative {rel:.3e}, over rtol {EVAL_TOL[0]} atol "
                                 f"{EVAL_TOL[1]}")
        out[name] = dict(res, err=err, rel=rel)
    fid = {}
    for d in ("card", "cpu"):
        f = out["Inception"][d].double().numpy()
        a, b = f[:8], f[8:]
        fid[d] = frechet_distance(a.mean(0), np.cov(a, rowvar=False), b.mean(0),
                                  np.cov(b, rowvar=False))
    if not np.isfinite(fid["card"]) or abs(fid["card"] - fid["cpu"]) > 1e-3 * abs(fid["cpu"]):
        raise AssertionError(f"FID from the card's features {fid['card']!r}, from the CPU's "
                             f"{fid['cpu']!r}: over rtol 1e-3")
    lp, inc = out["LPIPS"], out["Inception"]
    log("eval", f"{card}: full-size random weights, fp32, TF32 off, the card against the CPU: "
                f"LPIPS-VGG16 at 224, 4 pairs {[round(x, 6) for x in lp['card'].tolist()]}, max "
                f"|diff| {lp['err']:.3e} (relative {lp['rel']:.3e}); InceptionV3 pool3 at 299, "
                f"16 images x 2048 (max |feature| {inc['cpu'].abs().max().item():.3f}), max "
                f"|diff| {inc['err']:.3e} (relative {inc['rel']:.3e}); tolerance rtol "
                f"{EVAL_TOL[0]} atol {EVAL_TOL[1]}; FID (8 against 8) from the card's features "
                f"{fid['card']:.6f}, from the CPU's {fid['cpu']:.6f} (rtol 1e-3)")
    log("times", f"{card}: LPIPS-VGG16 a pair at 224: card {lp['card_ms']:.3f} ms (CUDA events, "
                 f"10 calls), CPU {lp['cpu_ms']:.1f} ms; InceptionV3 16 images at 299: card "
                 f"{inc['card_ms']:.3f} ms, CPU {inc['cpu_ms']:.1f} ms (host clock, best of 2)")
    return dict(lpips_ms=lp["card_ms"], lpips_cpu_ms=lp["cpu_ms"], inception_ms=inc["card_ms"],
                inception_cpu_ms=inc["cpu_ms"], fid=fid)


def eval_1b(tfa, cfg, p16, p32, dev, card: str) -> dict:
    """Phase 4d, on phase 4's 1B weights: the in-process validator over
    EvalDataset (8 samples, B = 2, EVAL_NEW greedy tokens, the
    configs/metrics/im2svg.yaml set with LPIPS and FID on full-size random
    weights in a temporary STARVECTOR_METRICS_DIR): bf16 texts and ids equal
    offline generate_im2svg's on the same batches, exact launch counts,
    every file of the output tree, every configured key; on the fp32 copy,
    ids and texts with the kernels equal those with the plain attention;
    the neural metrics on the card against the CPU; the REST validator
    through the port's worker and controller serving the fp32 copy, each
    text equal to offline fp32 generate_im2svg at B = 1; times beside the
    card's name and power limit."""
    import os
    import tempfile
    import threading

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.config import ConfigNode, load_yaml
    from starvector_tpu_torch.data.rasterize import rasterizer_available
    from starvector_tpu_torch.metrics import inception_v3, lpips_vgg
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.serve import controller as ctl
    from starvector_tpu_torch.serve import worker as wk
    from starvector_tpu_torch.validation.serve_validator import StarVectorServeValidator
    from starvector_tpu_torch.validation.torch_validator import StarVectorTorchValidator

    L, n, size = cfg.llm.n_layer, 8, cfg.image_size
    raster = rasterizer_available()
    log("eval", f"rasterizer_available() {raster}"
        + ("" if raster else ": no librsvg/cairo here, so every raster is the reference's white "
           "fallback and L2, Masked-L2, SSIM and LPIPS read white against white: their values "
           "below are no measure of quality"))
    tok = build_test_tokenizer("v1")
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    metrics = {**load_yaml("configs/metrics/im2svg.yaml")["metrics"], "LPIPS": True, "FID": True}
    light = {"L2": False}  # the ratio metrics only: the fp32 and REST runs check texts
    tmp = Path(tempfile.mkdtemp(prefix="phase4d_"))
    weights = tmp / "weights"
    (weights / "lpips-vgg").mkdir(parents=True)
    (weights / "inception").mkdir()
    vgg_sd, lin_sd = lpips_vgg.random_state_dicts(EVAL_SEED)
    torch.save(vgg_sd, weights / "lpips-vgg" / "vgg16.pth")
    torch.save(lin_sd, weights / "lpips-vgg" / "lpips_vgg.pth")
    torch.save(inception_v3.random_state_dict(EVAL_SEED), weights / "inception" / "inception_v3.pth")
    del vgg_sd, lin_sd
    saved_env = os.environ.get("STARVECTOR_METRICS_DIR")
    os.environ["STARVECTOR_METRICS_DIR"] = str(weights)
    try:
        # bf16: the validator against offline generate_im2svg on the same batches
        model = StarVectorForCausalLM(p16, cfg, tok, policy=bf16, device=dev)
        v = StarVectorTorchValidator(ConfigNode(eval_config(str(tmp / "bf16"), n, size, metrics)),
                                     model=model)
        secs = timed_validator(v)
        reset_counts(tfa)
        t = time.perf_counter()
        with IdsSpy(model) as spy:
            avg, per = v.validate()
        wall = time.perf_counter() - t
        counts = read_counts(tfa)
        steps = [int(lengths.max()) - 1 for _, lengths in spy.calls]
        expect_counts("eval bf16", counts, flash_prefill=L * len(spy.calls),
                      decode_attention=L * sum(steps))
        if len(spy.calls) != n // 2:
            raise AssertionError(f"eval: {len(spy.calls)} generations, expected {n // 2}")
        items = EvalDataset(n, EVAL_SEED, size)
        sids = [it["id"].split(".")[0] for it in items.items]
        texts = []
        with IdsSpy(model) as ref:
            for b in range(0, n, 2):
                images = np.stack([items[i]["image"] for i in (b, b + 1)])
                texts += model.generate_im2svg({"image": torch.as_tensor(images, device=dev)},
                                               max_new_tokens=EVAL_NEW, use_nucleus_sampling=False)
        same_ids = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(spy.calls, ref.calls)]
        raws = [v.results[s]["svg_raw"] for s in sids]
        if raws != texts or len(ref.calls) != len(spy.calls) or not all(same_ids):
            raise AssertionError(f"eval bf16: validator texts {raws}\noffline {texts}\nids equal "
                                 f"per batch {same_ids}")
        missing = [f"{s}/{s}{x}" for s in sids for x in (".svg", "_raw.svg", "_gt.svg",
                                                         "_generated.png", "_original.png")
                   if not os.path.exists(os.path.join(v.out_dir, s, s + x))]
        missing += [f"{s}/metadata.json" for s in sids
                    if not os.path.exists(os.path.join(v.out_dir, s, "metadata.json"))]
        missing += [f for f in ("results/results_avg.json", "results/all_results.csv",
                                "metrics.jsonl", "config.yaml")
                    if not os.path.exists(os.path.join(v.out_dir, f))]
        on_disk = json.load(open(os.path.join(v.out_dir, "results", "results_avg.json")))
        want = {k for k, on in metrics.items() if on}
        if missing or set(on_disk) != want or len(per) != n:
            raise AssertionError(f"eval output tree: missing {missing}; results_avg.json keys "
                                 f"{sorted(on_disk)}, configured {sorted(want)}; {len(per)} rows")
        distinct = [len(set(row[:int(l)].tolist())) for tk, ln in spy.calls for row, l in zip(tk, ln)]
        log("eval", f"in-process validator, bf16, {n} samples at B=2, {EVAL_NEW} greedy tokens: "
                    f"texts and ids == offline generate_im2svg on the same batches (lengths "
                    f"{[ln.tolist() for _, ln in spy.calls]}, distinct ids per row {distinct}); "
                    f"launches flash_prefill {counts['flash_prefill']} = {L} x {len(spy.calls)} "
                    f"batches, decode_attention {counts['decode_attention']} = {L} x {sum(steps)} "
                    f"steps; the output tree complete; results_avg.json "
                    + ", ".join(f"{k} {avg[k]:.6g}" for k in sorted(avg)))
        log("times", f"{card}: validator, bf16, {n} samples, {EVAL_NEW} greedy tokens at B=2: "
                     f"{wall / n:.3f} s a sample ({wall:.2f} s); a sample's seconds by stage: "
                     + ", ".join(f"{k} {s / n:.4f}" for k, s in secs.items()))
        eval_launches = {"flash_prefill": counts["flash_prefill"],
                         "decode_attention": counts["decode_attention"]}
        del model, v

        # fp32: the kernels against the plain attention, ids and texts
        runs = {}
        for kernels in (True, False):
            m32 = StarVectorForCausalLM(p32, cfg, tok, policy=f32, device=dev, kernels=kernels)
            v32 = StarVectorTorchValidator(ConfigNode(eval_config(
                str(tmp / f"fp32_{kernels}"), n, size, light)), model=m32)
            with IdsSpy(m32) as spy32:
                v32.validate()
            runs[kernels] = ([v32.results[s]["svg_raw"] for s in sids], spy32.calls)
        (tk, ik), (tp, ip) = runs[True], runs[False]
        if tk != tp or not all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                               for a, b in zip(ik, ip)):
            raise AssertionError(f"eval fp32: texts with the kernels {tk}\nplain {tp}")
        log("eval", f"in-process validator, fp32: texts and ids with the kernels == with the "
                    f"plain attention ({n} samples, lengths {[ln.tolist() for _, ln in ik]})")

        neural = neural_metrics_card_vs_cpu(dev, card, weights)

        # the REST validator through the port's worker and controller (fp32)
        m32 = StarVectorForCausalLM(p32, cfg, tok, policy=f32, device=dev)
        worker = wk.ModelWorker(m32, worker_addr="pending", max_batch=8, max_len=1024)
        servers = [wk.build_server(worker), ctl.build_server(ctl.Controller("shortest_queue"))]
        threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
        for th in threads:
            th.start()
        wurl, curl = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
        try:
            worker.worker_addr, worker.controller_addr = wurl, curl
            worker.register()
            rv = StarVectorServeValidator(ConfigNode(eval_config(
                str(tmp / "rest"), n, size, light, engine="vllm", api_endpoint=curl,
                name=worker.model_names[0])))
            t = time.perf_counter()
            rv.validate()
            rest_wall = time.perf_counter() - t
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()
            for th in threads:
                th.join(60)
            worker.shutdown()
        rest = [rv.results[s]["svg_raw"] for s in sids]
        offline = [m32.generate_im2svg({"image": m32.process_images([it["image_pil"]])},
                                       max_new_tokens=EVAL_NEW, use_nucleus_sampling=False)[0]
                   for it in items.items]
        if rest != offline:
            raise AssertionError(f"eval REST fp32 texts {rest}\noffline B=1 {offline}")
        log("eval", f"REST validator through the port's worker and controller on 127.0.0.1 "
                    f"(fp32): {n} requests done, every text == offline fp32 generate_im2svg at "
                    f"B=1 on the same PIL image")
        log("times", f"{card}: REST validator, fp32, {n} samples one request at a time, "
                     f"{EVAL_NEW} greedy tokens: {rest_wall / n:.3f} s a sample")
        del m32
    finally:
        if saved_env is None:
            os.environ.pop("STARVECTOR_METRICS_DIR", None)
        else:
            os.environ["STARVECTOR_METRICS_DIR"] = saved_env
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches=eval_launches, seconds=wall / n, stages={k: s / n for k, s in secs.items()},
                rest_seconds=rest_wall / n, neural=neural)


# ---------------------------------------------------------------------------
# phase 4e: offline pipelined generation (generate_pipelined, and with
# speculative rounds generate_pipelined_spec) at full 1B width
# ---------------------------------------------------------------------------

PIPE_BATCHES, PIPE_B, PIPE_P, PIPE_NEW = 4, 16, 1024, 128  # the JAX bench's offline 1k-prefill shape
SPEC_BATCHES, SPEC_B, SPEC_NEW, SPEC_DRAFT = 3, 8, 64, 8
SPEC_LENGTHS = (256, 243, 230, 217, 204, 191, 178, 165)  # right-padded rows of a spec batch
SPEC_IDS = (44, 5727, 2262, 1053, 48, 307, 912, 3001, 77, 1409, 2718, 8081)  # drafts recur


def pipe_batches(E: int, dev, n: int, B: int, P: int, seed: int = 15) -> list:
    """n batches of (embeds (B, P, E) fp32, mask (B, P) of ones): random
    prompt embeddings 0.02 N(0, 1) from a seeded generator on the card, as
    the JAX bench's offline workload builds them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((B, P, E), generator=g, device=dev) * 0.02,
             torch.ones((B, P), dtype=torch.int32, device=dev)) for _ in range(n)]


def cast_batches(batches: list, dtype) -> list:
    return [(e.to(dtype),) + tuple(rest) for e, *rest in batches]


def pipelined_steps(outs: list, n_chunks: int) -> dict:
    """Forwards of a generate_pipelined run by kind, from each batch's
    lengths: a batch decodes max(length) - 1 steps and, but for the last,
    carries n_chunks chunks of the next prompt; a step with both is fused,
    one with a chunk only writes the chunk, one with a decode only decodes."""
    counts = dict(decode=0, fused=0, chunk=0, decode_only=0)
    for i, (_, lengths) in enumerate(outs):
        d = int(lengths.max()) - 1
        c = n_chunks if i + 1 < len(outs) else 0
        counts["decode"] += d
        counts["fused"] += min(d, c)
        counts["chunk"] += max(c - d, 0)
        counts["decode_only"] += max(d - c, 0)
    return counts


def timed(fn):
    """(fn(), wall seconds of it, synchronised)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def same_ids(what: str, outs: list, refs: list) -> None:
    """Raise unless each batch's (tokens, lengths) equal the reference's."""
    for i, ((t, l), (rt, rl)) in enumerate(zip(outs, refs)):
        if not (torch.equal(t, rt) and torch.equal(l, rl)):
            raise AssertionError(f"{what}, batch {i}: first parting per row "
                                 f"{[first_parting(a, b) for a, b in zip(t, rt)]}, lengths "
                                 f"{l.tolist()} vs {rl.tolist()}")


def fused_step_logits(cfg, dec: dict, batches: list, policy, kernels: bool, kv,
                      tokens: torch.Tensor) -> torch.Tensor:
    """generate_pipelined's first steps teacher-forced: batch 0 prefilled,
    then one fused decode+chunk step a column of tokens (B, n) while batch
    1's first n chunks are written. Returns the decode logits (B, n, V)."""
    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode

    (e0, m0), (e1, m1) = batches[:2]
    B, Pn, _ = e0.shape
    C = engine._chunk_plan(Pn, PIPE_NEW, None)[0]
    _, cache = engine._prefill_full(dec, cfg.llm, e0, m0, Pn + PIPE_NEW, policy, kernels, kv)
    nxt = gpt_bigcode.init_cache(cfg.llm, B, Pn + PIPE_NEW, dtype=kv or policy.compute_dtype,
                                 device=e0.device)
    out = []
    for t in range(tokens.shape[1]):
        x = gpt_bigcode.embed_tokens(dec, tokens[:, t:t + 1]).to(policy.compute_dtype)
        logits, cache, _, nxt = gpt_bigcode.forward_decode_with_chunk(
            dec, cfg.llm, x, cache, policy.cast(e1[:, t * C:(t + 1) * C]),
            m1[:, t * C:(t + 1) * C], nxt, policy=policy, kernels=kernels, chunk_logits=False)
        out.append(logits)
    return torch.stack(out, 1)


def chunk_written_decode(cfg, dec: dict, batches: list, policy, kv) -> tuple:
    """Batch 1's decode over the cache that generate_pipelined's chunk
    steps wrote: batch 0 prefilled and decoded by _decode_overlap (the
    kernels on) with batch 1's n_chunks chunks fused into its steps; then
    batch 1's first decode step over that cache, once with the kernels
    (kernel 2, or 2' over an int8 cache) and once with the plain attention,
    each on its own copy of the cache. Both read the same codes and scales
    and the step's own k/v enter unquantized (the merged self token), so the
    logits differ by fp32 sum order alone: held to TOL, not to a
    quantization gap. Returns (max |diff|, a line for the log, batch 0's
    greedy tokens (B, PIPE_NEW), generate_pipelined's batch 0)."""
    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode

    (e0, m0), nxt = batches[:2]
    B, Pn, _ = e0.shape
    C, n_chunks = engine._chunk_plan(Pn, PIPE_NEW, None)
    gen = engine.GenerationConfig(max_new_tokens=PIPE_NEW, do_sample=False,
                                  stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    last, cache = engine._prefill_full(dec, cfg.llm, e0, m0, Pn + PIPE_NEW, policy, True, kv)
    tokens, _, cache, last = engine._decode_overlap(dec, cfg.llm, cache, last, None, nxt, gen,
                                                    None, C, n_chunks, policy, True, kv)
    x = gpt_bigcode.embed_tokens(dec, last.argmax(-1)[:, None]).to(policy.compute_dtype)
    ones = torch.ones((B, 1), dtype=torch.int32, device=e0.device)
    logits = {k: gpt_bigcode.forward(dec, cfg.llm, x, attention_mask=ones,
                                     cache={n: v.clone() if torch.is_tensor(v) else v
                                            for n, v in cache.items()},
                                     policy=policy, kernels=k)[0][:, -1] for k in (True, False)}
    torch.cuda.synchronize()
    err = compare(f"batch 1's decode over the chunk-written {kv or 'fp32'} cache", logits[True],
                  logits[False], torch.float32)
    return err, (f"batch 1's first decode step over the cache the {n_chunks} chunk steps wrote "
                 f"(B={B}, T={Pn + PIPE_NEW}), kernels against plain: logits max |diff| "
                 f"{err:.3e} (TOL, fp32)"), tokens


def spec_batches(dec: dict, embed, dev, seed: int = 25) -> list:
    """SPEC_BATCHES batches of SPEC_B right-padded rows of SPEC_LENGTHS ids
    drawn from SPEC_IDS (so that prompt-lookup drafts exist): (embeds fp32,
    mask, prompt ids -1 at the holes)."""
    rng = np.random.default_rng(seed)
    P = max(SPEC_LENGTHS)
    out = []
    for _ in range(SPEC_BATCHES):
        ids = torch.from_numpy(rng.choice(SPEC_IDS, (SPEC_B, P))).to(dev)
        mask = (torch.arange(P, device=dev)[None, :]
                < torch.tensor(SPEC_LENGTHS, device=dev)[:, None]).int()
        out.append((embed(dec, ids).float() * mask[:, :, None], mask,
                    torch.where(mask > 0, ids, -1)))
    return out


def left_padded(batch) -> tuple:
    """A right-padded (embeds, mask, ids) batch's rows moved to the right,
    pads on the left (generate's and generate_pipelined's layout)."""
    emb, mask, ids = batch
    P = mask.shape[1]
    shift = P - mask.sum(dim=1)
    src = (torch.arange(P, device=mask.device)[None, :] - shift[:, None]) % P
    return (emb.gather(1, src[:, :, None].expand_as(emb)), mask.gather(1, src),
            ids.gather(1, src))


def pipelined_1b(tfa, cfg, p16, p32, q16, dev, card: str, profile_dir: Path | None) -> dict:
    """Phase 4e, offline pipelined generation at full 1B width and depth on
    phase 4's trees: PIPE_BATCHES batches of B=16, P=1024 random prompt
    embeddings, 128 greedy new tokens, C = max(4, ceil(1024 / 128)) = 8,
    every step of a batch but the last's one fused forward
    (forward_decode_with_chunk: kernel 2 for the decode half, the chunk
    step for the next prompt's chunk); batch 0 prefills through kernel 1.
      * fp32: each batch's ids and lengths equal per-batch generate's (the
        kernels) and generate_pipelined's with kernels=False; launches
        exactly 24 flash_prefill (batch 0) and 24 decode_attention a decode
        step;
      * bf16: the launches, and each batch's first token that parts from
        per-batch generate (recorded: the fused GEMMs round M = 144 rows);
      * int8 weights over an fp32 cache: fp32 ids equal per-batch
        generate's. An int8 KV cache (fp32 weights), and int8 weights with
        it: per-batch int8 generate is no exact reference there (its one
        prefill attends over every prompt key quantized, a chunk step over
        its own chunk's keys unquantized, in both packages), so 16
        teacher-forced fused steps' logits, kernels against plain, within
        twice what generate's route shows on the same tokens (both share
        batch 0's int8 prefill, where the two's k/v round to neighbouring
        codes), and batch 1's first decode step over the cache the chunk
        steps wrote, kernels against plain on one copy each of that cache,
        to TOL (chunk_written_decode). In bf16 the
        launches over kernel 2' and kernel 14 (96 a forward: the tile at
        M = 16 x 1024 for the prefill and 144 a fused step, the GEMV at
        M = 16 a decode-only step);
      * generate_pipelined_spec, 3 batches of 8 right-padded prompts of
        165-256 ids from a set of 12, 64 new tokens, draft_len 8: fp32 ids
        equal generate_pipelined's on the same rows left-padded, and per-
        batch generate's (each row's plain greedy ids); in bf16 its rounds
        a batch, tokens a round and launches (kernel 1 for batch 0's adopt,
        no kernel 2: every verify is the chunk step);
      * times in turns (serial, pipelined, pipelined int8 KV, and back):
        tokens/s of each over the 4 batches; a fused step against the
        unfused pair in alternating blocks (pipelined_step_times), and
        with `profile_dir` a fused step's and a decode-only step's wall
        against device time.
    Returns the launch counts of the checked bf16 runs, the stream's
    tokens/s, the spec results and the step times."""
    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    gen = engine.GenerationConfig(max_new_tokens=PIPE_NEW, do_sample=False,
                                  stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    C, n_chunks = engine._chunk_plan(PIPE_P, PIPE_NEW, None)
    batches32 = pipe_batches(cfg.llm.hidden_size, dev, PIPE_BATCHES, PIPE_B, PIPE_P)
    batches16 = cast_batches(batches32, torch.bfloat16)
    d32, d16, dq16 = (t["svg_transformer"] for t in (p32, p16, q16))

    def pipelined(dec, batches, policy, kernels=True, kv=None):
        return engine.generate_pipelined(dec, cfg.llm, batches, gen, policy=policy,
                                         kernels=kernels, kv_cache_dtype=kv)

    def serial(dec, batches, policy, kv=None):
        return [engine.generate(dec, cfg.llm, e, m, gen, policy=policy, kv_cache_dtype=kv)
                for e, m in batches]

    def counted(fn):
        reset_counts(tfa)
        out = fn()
        return out, read_counts(tfa)

    # fp32: ids against per-batch generate and the plain attention
    out32, counts = counted(lambda: pipelined(d32, batches32, f32))
    steps = pipelined_steps(out32, n_chunks)
    expect_counts("pipelined fp32", counts, flash_prefill=L, decode_attention=L * steps["decode"])
    same_ids("pipelined fp32 against per-batch generate", out32, serial(d32, batches32, f32))
    same_ids("pipelined fp32, kernels against plain", out32,
             pipelined(d32, batches32, f32, kernels=False))
    log("pipelined", f"generate_pipelined, fp32, {PIPE_BATCHES} batches of B={PIPE_B}, P={PIPE_P}, "
                     f"{PIPE_NEW} new tokens, C={C} ({n_chunks} chunks a prompt): lengths per "
                     f"batch {[sorted(set(l.tolist())) for _, l in out32]}; {steps['fused']} fused "
                     f"steps, {steps['chunk']} chunk-only, {steps['decode_only']} decode-only; "
                     f"launches flash_prefill {counts['flash_prefill']} = {L} x 1 (batch 0), "
                     f"decode_attention {counts['decode_attention']} = {L} x {steps['decode']} "
                     f"decode steps; ids and lengths == per-batch generate's and == the plain "
                     f"attention's, every batch")

    # int8 weights over an fp32 cache: fp32 ids against per-batch generate
    q32 = quantized(p32)["svg_transformer"]
    two = batches32[:2]
    same_ids("pipelined fp32 int8 weights against per-batch generate",
             pipelined(q32, two, f32), serial(q32, two, f32))
    log("pipelined", "generate_pipelined, int8 weights and an fp32 cache, fp32, 2 batches: ids "
                     "and lengths == per-batch generate's")
    # an int8 KV cache, fp32: batch 1's first decode step over the cache the
    # chunk steps wrote, kernels against plain on one cache, to TOL; then,
    # fed batch 0's tokens, teacher-forced fused steps, kernels against
    # plain, within twice generate's route's own gap on the same tokens (the
    # floor: both routes share batch 0's int8 prefill, where the two's k/v
    # round to neighbouring codes)
    int8_fp32 = {}
    for label, dec32 in (("int8 KV", d32), ("int8 weights + int8 KV", q32)):
        _, step_text, fed = chunk_written_decode(cfg, dec32, two, f32, torch.int8)
        fed = fed[:, :16]
        forced = [fused_step_logits(cfg, dec32, two, f32, k, torch.int8, fed)
                  for k in (True, False)]
        floor = [forced_logits(gpt_bigcode, dec32, cfg.llm, *two[0], 17, f32, k, torch.int8,
                               ids=fed)[0][:, 1:] for k in (True, False)]
        err = (forced[0] - forced[1]).abs().max().item()
        err_floor = (floor[0] - floor[1]).abs().max().item()
        if not torch.isfinite(forced[0]).all() or err > 2.0 * err_floor + 1e-3:
            raise AssertionError(f"pipelined fp32 {label}: teacher-forced fused-step logits, "
                                 f"kernels against plain, max |diff| {err:.4e}, over twice "
                                 f"generate's route's {err_floor:.4e}")
        int8_fp32[label] = (f"fp32, 2 batches: 16 teacher-forced fused steps' logits, kernels "
                            f"against plain, max |diff| {err:.4e}, generate's route on the same "
                            f"tokens {err_floor:.4e} (bound: fused <= 2 x generate's + 1e-3); "
                            f"{step_text}")
    del q32

    # pipelined speculative decoding
    spec = pipelined_spec_1b(tfa, cfg, d16, d32, bf16, f32, dev)

    # bf16, timed once each, one after the other beside the card (one
    # round since PR 16: two, in turns, took 213-228 s of the script's
    # time); each run also gives its launches and ids
    runs = {"serial generate": lambda: serial(d16, batches16, bf16),
            "generate_pipelined": lambda: pipelined(d16, batches16, bf16),
            "generate_pipelined int8 KV": lambda: pipelined(d16, batches16, bf16, kv=torch.int8)}
    med, first = {}, {}
    for label, run in runs.items():
        reset_counts(tfa)
        out, wall = timed(run)
        first[label] = (out, read_counts(tfa))
        med[label] = sum(float(l.sum()) for _, l in out) / wall
    log("times", f"{card}: 1B offline, {PIPE_BATCHES} batches of B={PIPE_B}, P={PIPE_P}, "
                 f"{PIPE_NEW} greedy tokens, bf16, one run each (a, b, c), emitted tokens "
                 f"/ wall: " + "; ".join(f"{k} {v:.1f} tokens/s" for k, v in med.items())
                 + f"; pipelined / serial {med['generate_pipelined'] / med['serial generate']:.3f}"
                 f", int8 KV / serial "
                 f"{med['generate_pipelined int8 KV'] / med['serial generate']:.3f}")

    def bf16_launches(label, out, counts) -> tuple[dict, str]:
        """Exact launches of a bf16 run of the stream ("bf16", "int8 KV",
        "int8 weights + int8 KV"): kernel 1 for batch 0, kernel 2 (2' over
        the int8 cache) a decode step, kernel 14 (by rows: the GEMV up to
        GEMV_MAX_ROWS, else the tile) 96 a forward."""
        steps = pipelined_steps(out, n_chunks)
        int8, quant = label != "bf16", label.startswith("int8 weights")
        fwd = 1 + steps["fused"] + steps["chunk"] + steps["decode_only"]
        got = expect_counts(f"pipelined bf16 {label}", counts, flash_prefill=L,
                            decode_attention=L * steps["decode"],
                            decode_attention_int8=L * steps["decode"] if int8 else 0,
                            quant_matmul=4 * L * fwd if quant else 0)
        rows = {"decode_only": PIPE_B, "chunk": PIPE_B * C, "fused": PIPE_B * (1 + C)}
        gemv = 4 * L * sum(steps[k] for k, m in rows.items() if m <= tq.GEMV_MAX_ROWS)
        tile = 4 * L * fwd - gemv
        if quant and (counts["quant_matmul_gemv"], counts["quant_matmul_wgmma"]) != (gemv, tile):
            raise AssertionError(f"pipelined {label}: quant_matmul paths {counts}, expected GEMV "
                                 f"{gemv}, tile {tile}")
        text = (f"bf16 launches flash_prefill {got['flash_prefill']} = {L} x 1 (batch 0), "
                f"decode_attention {got['decode_attention']} = {L} x {steps['decode']} decode "
                f"steps ({steps['fused']} fused, {steps['decode_only']} decode-only; "
                f"{steps['chunk']} chunk-only steps)"
                + (f", of them over the int8 cache {got['decode_attention_int8']}" if int8 else "")
                + (f", quant_matmul {got['quant_matmul']} = 96 x {fwd} forwards (tile {tile}: "
                   f"the prefill at M = {PIPE_B * PIPE_P}, the fused steps at M = "
                   f"{PIPE_B * (1 + C)}, the chunk-only at M = {PIPE_B * C}; GEMV {gemv}: the "
                   f"decode-only steps at M = {PIPE_B})" if quant else ""))
        return {**got, **({"quant_matmul_gemv": gemv, "quant_matmul_wgmma": tile}
                          if quant else {})}, text

    out16 = first["generate_pipelined"][0]
    launches = {"spec": spec["launches"]}
    launches["bf16"], text = bf16_launches("bf16", *first["generate_pipelined"])
    ref16 = first["serial generate"][0]
    parts = [[first_parting(t, r) for t, r in zip(o[0], ref[0])] for o, ref in zip(out16, ref16)]
    agree = [round(float((o[0] == ref[0]).float().mean()), 4) for o, ref in zip(out16, ref16)]
    log("pipelined", f"generate_pipelined, bf16: {text}; against per-batch generate, ids agree "
                     f"on {agree} of each batch's positions; first parting token per row (None: "
                     f"never; the fused GEMMs round M = {PIPE_B * (1 + C)} rows where a decode "
                     f"step rounds {PIPE_B}, and the chunk step's attention is not kernel 1's): "
                     f"{parts}")
    launches["int8 KV"], text = bf16_launches("int8 KV", *first["generate_pipelined int8 KV"])
    log("pipelined", f"generate_pipelined, int8 KV: {int8_fp32['int8 KV']}; {text}")
    label = "int8 weights + int8 KV"
    launches[label], text = bf16_launches(label, *counted(
        lambda: pipelined(dq16, batches16, bf16, kv=torch.int8)))
    log("pipelined", f"generate_pipelined, {label}: {int8_fp32[label]}; {text}")
    step_ms = pipelined_step_times(cfg, d16, bf16, batches16, C, card, profile_dir)
    return dict(launches=launches, rates=med, spec=spec, step_ms=step_ms)


def pipelined_spec_1b(tfa, cfg, d16, d32, bf16, f32, dev) -> dict:
    """generate_pipelined_spec on phase 4e's trees (see pipelined_1b)."""
    from starvector_tpu_torch.generation import engine, speculative
    from starvector_tpu_torch.models import gpt_bigcode

    L = cfg.llm.n_layer
    gen = engine.GenerationConfig(max_new_tokens=SPEC_NEW, do_sample=False,
                                  stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    batches32 = spec_batches(d32, gpt_bigcode.embed_tokens, dev)
    out = speculative.generate_pipelined_spec(d32, cfg.llm, batches32, gen, policy=f32,
                                         draft_len=SPEC_DRAFT)
    left = [left_padded(b) for b in batches32]
    pipe = engine.generate_pipelined(d32, cfg.llm, [b[:2] for b in left], gen, policy=f32)
    plain = [engine.generate(d32, cfg.llm, e, m, gen, policy=f32) for e, m, _ in left]
    same_ids("pipelined_spec fp32 against generate_pipelined", out, pipe)
    same_ids("pipelined_spec fp32 against per-batch generate", out, plain)
    log("pipelined", f"generate_pipelined_spec, fp32, {SPEC_BATCHES} batches of {SPEC_B} "
                     f"right-padded rows of {min(SPEC_LENGTHS)}-{max(SPEC_LENGTHS)} ids from a set "
                     f"of {len(SPEC_IDS)}, {SPEC_NEW} new tokens, draft_len {SPEC_DRAFT}: ids and "
                     f"lengths == generate_pipelined's on the rows left-padded and == per-batch "
                     f"generate's, every batch")
    stats = []
    reset_counts(tfa)
    out16 = speculative.generate_pipelined_spec(d16, cfg.llm, cast_batches(batches32, torch.bfloat16),
                                           gen, policy=bf16, draft_len=SPEC_DRAFT, stats=stats)
    got = expect_counts("pipelined_spec bf16", read_counts(tfa), flash_prefill=L)
    emitted = [int(l.sum()) for _, l in out16]
    per_round = [round(e / (r * SPEC_B), 3) for e, r in zip(emitted, stats)]
    log("pipelined", f"generate_pipelined_spec, bf16: rounds a batch {stats} (verify and "
                     f"chunk-only), emitted tokens {emitted}, {per_round} tokens a row a round; "
                     f"launches flash_prefill {got['flash_prefill']} = {L} x 1 (batch 0's adopt), "
                     f"decode_attention {got['decode_attention']}: every verify is the chunk step; "
                     f"random weights, so the acceptance is no forecast for real SVG")
    return dict(launches=got, rounds=stats, per_round=per_round)


def pipelined_step_times(cfg, dec, policy, batches, C: int, card: str, out_dir: Path | None,
                         pairs: int = 10, n: int = 8) -> dict:
    """A fused decode+chunk step against the unfused pair that
    generate_pipelined runs where a decoder has no fused forward (the
    decode forward, then the chunk step), at phase 4e's bf16 shapes: batch
    0 prefilled, batch 1's chunks written from slot 0, each block of n
    steps from that same state; `pairs` pairs of blocks in alternating
    order after one warm-up block of each. Logs the wall ms a step of each
    (synchronised host clock), the ratio of the medians, the quartiles and
    how many pairs the fused step won. With `out_dir`, then a fused step's
    and a decode-only step's wall against device time (torch.profiler over
    n more). Returns the median ms a step by kind."""
    from torch.profiler import ProfilerActivity, profile

    from starvector_tpu_torch.generation import engine
    from starvector_tpu_torch.models import gpt_bigcode

    (e0, m0), (e1, m1) = batches[:2]
    B, Pn, _ = e0.shape
    _, cache = engine._prefill_full(dec, cfg.llm, e0, m0, Pn + PIPE_NEW, policy, True, None)
    nxt = gpt_bigcode.init_cache(cfg.llm, B, Pn + PIPE_NEW, dtype=policy.compute_dtype,
                                 device=e0.device)
    tok = gpt_bigcode.embed_tokens(dec, torch.full((B, 1), 44, device=e0.device)).to(
        policy.compute_dtype)
    ones = torch.ones((B, 1), dtype=torch.int32, device=e0.device)
    i0 = cache["index"]
    step = {"t": 0}

    def reset():
        cache["index"], nxt["index"], step["t"] = i0, 0, 0
        cache["kv_mask"][:, i0:] = 0
        nxt["kv_mask"].zero_()

    def chunk():
        t = step["t"]
        step["t"] += 1
        return e1[:, t * C:(t + 1) * C], m1[:, t * C:(t + 1) * C]

    def fused():
        ce, cm = chunk()
        gpt_bigcode.forward_decode_with_chunk(dec, cfg.llm, tok, cache, ce, cm, nxt,
                                              policy=policy, chunk_logits=False)

    def decode():
        gpt_bigcode.forward(dec, cfg.llm, tok, attention_mask=ones, cache=cache, policy=policy)

    def unfused():
        ce, cm = chunk()
        decode()
        gpt_bigcode.forward(dec, cfg.llm, ce, attention_mask=cm, cache=nxt, policy=policy,
                            return_hidden=True, last_logits_only=True)

    def block(fn) -> float:
        """ms a step over n steps of fn from the reset state."""
        reset()
        _, wall = timed(lambda: [fn() for _ in range(n)])
        return wall * 1e3 / n

    kinds = {"fused": fused, "unfused": unfused}
    for fn in kinds.values():
        block(fn)  # warm-up
    ms = {k: [] for k in kinds}
    for i in range(pairs):
        for k in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
            ms[k].append(block(kinds[k]))
    med = {k: statistics.median(v) for k, v in ms.items()}
    wins = sum(f < u for f, u in zip(ms["fused"], ms["unfused"]))
    quart = {k: [round(q, 3) for q in statistics.quantiles(v, n=4)] for k, v in ms.items()}
    log("times", f"{card}: 1B pipelined step, bf16, B={B}, C={C}, {pairs} pairs of {n}-step "
                 f"blocks in alternating order: fused decode+chunk {med['fused']:.3f} ms a step "
                 f"(quartiles {quart['fused']}), unfused (the decode forward, then the chunk "
                 f"step) {med['unfused']:.3f} ms (quartiles {quart['unfused']}); unfused ms / "
                 f"fused ms {med['unfused'] / med['fused']:.3f}; the fused step faster in {wins} of "
                 f"{pairs} pairs")
    if out_dir is None:
        return med
    parts = []
    for label, fn in (("fused decode+chunk", fused), ("decode-only", decode)):
        wall = block(fn)
        reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
        if not dev_ms:
            raise AssertionError("the profiler recorded no device time")
        out_dir.mkdir(parents=True, exist_ok=True)
        name = f"profile_pipelined_{label.split()[0].replace('-', '_')}.txt"
        (out_dir / name).write_text(f"{card}\n{label}, B={B}, C={C}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=50))
        parts.append(f"{label} wall {wall:.3f} ms, device {dev_ms:.3f} ms, busy "
                     f"{dev_ms / wall:.1%} ({name})")
    log("profile", f"{card}: 1B pipelined step, bf16, B={B}, C={C} (M = {B * (1 + C)} rows a "
                   f"fused projection): " + "; ".join(parts))
    return med


def offline_int8_ids(q32, cfg, prefixes, f32) -> list[list[int]]:
    """Offline greedy ids of each prefix at B = 1 through generate with an
    int8 KV cache, cut at the stop."""
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate

    gen = GenerationConfig(max_new_tokens=SERVE_CHECK_NEW, do_sample=False,
                           stop_sequences=STOP_IDS, eos_token_id=None, pad_token_id=0)
    out = []
    for p in prefixes:
        toks, lengths = generate(q32["svg_transformer"], cfg.llm, p,
                                 torch.ones(p.shape[:2], dtype=torch.int32, device=p.device),
                                 gen, policy=f32, kv_cache_dtype=torch.int8)
        out.append(toks[0, :int(lengths[0])].tolist())
    return out


def serving_8b(tfa, model, cfg, p16, p32, cfg32, dev, card: str, depth: str) -> dict:
    """Phase 6d, on phase 6's 8B weights (`depth`): 4 concurrent bf16
    requests with a decode_attention (G = 9) launch a layer a step; fp32
    engine ids against offline generate's on phase 6's fp32 copy; at 2
    layers in fp32, a 4700-token prefix beside a short one decoded past the
    4096-key window, kernels against plain; tokens/s beside offline B = 4."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    L = cfg.llm.num_hidden_layers
    f32 = DTypePolicy(torch.float32, torch.float32)
    images = model.process_images(synthetic_images(4, 33))
    pre16 = serve_prefixes(p16, cfg, images, model.policy)
    _, counts, ticks = engine_ids(p16, cfg, pre16, model.policy, dev, tfa)
    expect_counts("8B engine bf16", counts, flash_prefill=L, decode_attention=L * 4 * ticks)
    pre32 = serve_prefixes(p32, cfg32, images, f32)
    ids_k, _, _ = engine_ids(p32, cfg32, pre32, f32, dev, tfa)
    ref = offline_ids(StarVectorForCausalLM, p32, cfg32, images, f32, dev)
    if ids_k != ref:
        raise AssertionError(f"8B fp32 engine ids {ids_k}\noffline {ref}")
    log("serve", f"{card}: 8B engine, bf16 at {depth}, 4 concurrent requests (prefixes "
                 f"{[p.shape[1] for p in pre16]}): launches flash_prefill {counts['flash_prefill']}"
                 f" = {L} x 1 chunk, decode_attention (G = 9) {counts['decode_attention']} = {L} x "
                 f"4 x {ticks} ticks; fp32 at {depth}: ids == offline generate_im2svg_ids B=1 "
                 f"(lengths {[len(i) for i in ids_k]})")
    # the window: 2 layers, fp32, a 4700-token prefix beside a 579-token one
    q2, cfg2 = first_layers(p16, cfg, 2)
    p2 = _cast_tree(q2, torch.float32)
    n_visual = cfg.encoder_config.geometry[1]
    long_ids = tuple(np.random.default_rng(16).integers(0, cfg.llm.vocab_size,
                                                        PREFIX_8B - n_visual).tolist())
    pre = serve_prefixes(p2, cfg2, images[:2], f32, prompts=(long_ids, PROMPT_IDS))
    ids = {}
    for kernels in (True, False):
        engine = ServeEngine(p2["svg_transformer"], cfg2.llm, cfg2.decoder, max_batch=2,
                             max_len=8192, policy=f32, device=dev, kernels=kernels)
        try:
            reset_counts(tfa)
            res = serve_requests(engine, [Request(prefix_embeds=p, max_new_tokens=SERVE_CHECK_NEW,
                                                  do_sample=False) for p in pre])
            wc = read_counts(tfa)
        finally:
            engine.stop()
        ids[kernels] = [r["ids"] for r in res]
        if kernels:
            win_counts = wc
    if ids[True] != ids[False]:
        raise AssertionError(f"8B engine window: fp32 ids kernels {ids[True]}\nplain {ids[False]}")
    from starvector_tpu_torch.serve.engine import _bucket_len

    chunks = [max(min(_bucket_len(p.shape[1]), 8192) // 1024, 1) for p in pre]
    if win_counts["flash_prefill"] != 2 * sum(chunks) or not win_counts["decode_attention"]:
        raise AssertionError(f"8B engine window launches {win_counts}: expected 2 x {chunks} "
                             f"admission chunks of flash_prefill")
    log("serve", f"{card}: 8B engine, the window at full width, fp32, 2 layers: a {PREFIX_8B}-token "
                 f"prefix ({chunks[0]} admission chunks of 1024 through kernel 1, the later "
                 f"ones at q_offset > 0) beside a {pre[1].shape[1]}-token one, {SERVE_CHECK_NEW} tokens "
                 f"each, the long row past the {cfg.llm.sliding_window}-key window in its mask: "
                 f"ids with the kernels == plain; launches flash_prefill "
                 f"{win_counts['flash_prefill']}, decode_attention {win_counts['decode_attention']}")
    del p2, q2
    torch.cuda.empty_cache()
    runs, engines = throughput_runs(p16, cfg, pre16, model.policy, dev, steps=(4,))
    try:
        rates = serve_rates(card, "8B bf16, 4 concurrent greedy im2svg requests of 128 tokens",
                            runs)
    finally:
        for e in engines:
            e.stop()
    return rates


# ---------------------------------------------------------------------------
# phase 4f: the other vision towers behind the 1B decoder
# ---------------------------------------------------------------------------

TOWERS_4F = (("vqgan", 224), ("convnext", 224), ("open-clip", 224), ("siglip_512", 512),
             ("siglip_256", 256))  # image_encoder_type, its stock image size
TOWER_PROMPT = PROMPT_IDS[:2]  # so that S = qlen + 2: phase 3's TOWER_PREFIXES
# the bf16 tower forward's relative L2 distance from the fp32 one: a few
# bf16 steps (2^-8) compounded over a tower's layers
TOWER_REL_TOL = 3e-2
TOWER_NEW, TOWER_FP32_NEW = 32, 16


def towers_1b(sv, tfa, dc, cfg, p16, p32, dev, card: str) -> dict:
    """Phase 4f, on phase 4's 1B decoder (all 24 layers, its projections
    scaled): each of vqgan, convnext, open-clip (224 px), siglip_512 and
    siglip_256 at its stock geometry, with its tower and an adapter of its
    width (256 / 1024 / 1024 / 768 / 768 -> 2048) drawn from a seeded
    generator (sv.init_vision_params), 2 synthetic images through its own
    processor:
      * the bf16 tower forward within TOWER_REL_TOL (relative L2) of the
        fp32 one; each one's device time at B = 2 (graph-replayed);
      * bf16 greedy generate_im2svg_ids at B = 2, 32 new tokens, a 2-id
        prompt: 24 flash_prefill at S = qlen + 2 (none for convnext's 51,
        which is the chunk step's, as in the JAX package, S <= 64) and 24
        decode_attention a decode step, exactly;
      * fp32 greedy ids with the kernels equal those with the plain
        attention on the first DEPTH_1B_EARLIER layers, 16 tokens.
    Returns {tower: its launches and times}."""
    import dataclasses

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.models import image_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    req = dict(prompt_ids=[TOWER_PROMPT] * 2, stop_sequences=STOP_IDS, use_nucleus_sampling=False)
    out = {}
    for i, (t, size) in enumerate(TOWERS_4F):
        t0 = time.perf_counter()
        tcfg = dataclasses.replace(cfg, image_encoder_type=t, image_size=size)
        enc = tcfg.encoder_config
        hidden, qlen = enc.geometry
        v32 = sv.init_vision_params(tcfg, torch.Generator(device=dev).manual_seed(40 + i),
                                    device=dev)
        v16 = _cast_tree(v32, torch.bfloat16)
        images = processor_for_encoder(t, size, device=dev).batch(synthetic_images(2, 40 + i))
        fwd = {label: functools.partial(image_encoder.forward, v["image_encoder"], enc, images,
                                        policy=policy)
               for label, v, policy in (("fp32", v32, f32), ("bf16", v16, bf16))}
        with torch.no_grad():
            e32, e16 = fwd["fp32"](), fwd["bf16"]()
            torch.cuda.synchronize()
            if e32.shape != (2, qlen, hidden) or not torch.isfinite(e16).all():
                raise AssertionError(f"4f {t}: tower output {tuple(e32.shape)}, finite "
                                     f"{bool(torch.isfinite(e16).all())}")
            rel = ((e16.float() - e32).norm() / e32.norm()).item()
            if rel > TOWER_REL_TOL:
                raise AssertionError(f"4f {t}: bf16 tower forward {rel:.3e} (relative L2) from "
                                     f"fp32, over {TOWER_REL_TOL}")
            ms = {label: cuda_ms(fn, iters=5) for label, fn in fwd.items()}

        S = qlen + len(TOWER_PROMPT)
        m16 = StarVectorForCausalLM({"svg_transformer": p16["svg_transformer"], **v16}, tcfg,
                                    policy=bf16, device=dev)
        reset_counts(tfa)
        _, toks, lengths = m16.generate_im2svg_ids({"image": images}, max_new_tokens=TOWER_NEW,
                                                   **req)
        torch.cuda.synchronize()
        steps = int(lengths.max()) - 1
        got = expect_counts(f"4f {t} bf16", read_counts(tfa),
                            flash_prefill=L if S > dc.CHUNK_STEP_MAX else 0,
                            decode_attention=L * steps)

        s32, cut = first_layers({"svg_transformer": p32["svg_transformer"], **v32}, tcfg,
                                DEPTH_1B_EARLIER)
        ids = {}
        for kernels in (True, False):
            m32 = StarVectorForCausalLM(s32, cut, policy=f32, device=dev, kernels=kernels)
            _, ids[kernels], _ = m32.generate_im2svg_ids({"image": images},
                                                         max_new_tokens=TOWER_FP32_NEW, **req)
        if not torch.equal(ids[True], ids[False]):
            raise AssertionError(f"4f {t}: fp32 greedy ids differ, kernels against plain:\n"
                                 f"{ids[True].tolist()}\n{ids[False].tolist()}")
        out[t] = dict(S=S, launches=got, tower_ms=ms, rel=rel)
        log("towers", f"{card}: {t} at {size} px ({hidden} wide, {qlen} tokens) behind the 1B "
                      f"decoder: bf16 tower forward {rel:.3e} (relative L2) from fp32 (bound "
                      f"{TOWER_REL_TOL}); B=2 tower forward bf16 {ms['bf16']:.3f} ms, fp32 "
                      f"{ms['fp32']:.3f} ms; bf16 greedy, {TOWER_NEW} tokens, S = {S}: "
                      f"flash_prefill {got['flash_prefill']}"
                      + (f" = {L} x 1" if got["flash_prefill"] else
                         f" (S <= {dc.CHUNK_STEP_MAX}: the chunk step)")
                      + f", decode_attention {got['decode_attention']} = {L} x {steps} steps, "
                      f"{[len(set(r.tolist())) for r in toks]} distinct ids a row; fp32 greedy "
                      f"ids at {DEPTH_1B_EARLIER} layers, {TOWER_FP32_NEW} tokens, kernels == "
                      f"plain; {time.perf_counter() - t0:.1f} s")
        del v32, v16, m16, s32
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS, LR = 8, 1e-4
SVG_LENGTHS = (512, 431, 300, 187)  # ragged rows; the longest sets T = 257 + 512


def training_batch(cfg, process_images, dev, seed: int = 0, lengths=SVG_LENGTHS) -> dict:
    """One batch in the loader's format, from a seeded numpy generator:
    images normalised for the tower (len(lengths), size, size, 3), svg ids
    in the vocabulary, right-padded to the longest row."""
    rng = np.random.default_rng(seed)
    B, S = len(lengths), max(lengths)
    ids = rng.integers(0, cfg.llm.vocab_size, (B, S))
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
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
                  hook=None, *, optimizer=_optimizer, remat="dots_flash", grad_dtype=None):
    """`steps` steps of the port's train loop from fresh seeded weights;
    (params, per-step records of loss, grad_norm, wall time and launches).
    `optimizer(params)` builds the optimizer; `hook(step)` runs after each
    step's record."""
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
    params, _, _ = train_loop(params, cfg, optimizer(params),
                              ((0, batch) for _ in range(steps)), total_steps=steps, device=dev,
                              policy=policy, remat=remat, grad_dtype=grad_dtype, kernels=kernels,
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
    params, recs = _run_training(sv, tfa, cfg, dev, batch, TRAIN_STEPS,
                                 DTypePolicy(torch.float32, torch.bfloat16))
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    losses, norms, per_step = check_train_run("training", recs, counts, L)
    T = 257 + max(SVG_LENGTHS)
    log("train", f"StarVector-1B at full width, B={len(SVG_LENGTHS)}, T={T} (svg lengths "
                 f"{list(SVG_LENGTHS)}), fp32 masters / bf16 compute, dots_flash, AdamW lr {LR}: "
                 f"{TRAIN_STEPS} steps on one batch, loss {[round(x, 4) for x in losses]}, "
                 f"grad_norm {[round(x, 4) for x in norms]}; launches per step "
                 f"{per_step[0]} (each = {L} layers), in all {counts}; peak memory "
                 f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
                 f"{base / 2**30:.2f} GiB held before the first step")
    return dict(recs=recs, counts=counts, T=T, B=len(SVG_LENGTHS), peak=peak, base=base,
                params=params, cfg=cfg)


def check_train_run(what: str, recs: list, counts: dict, L: int, forwards: int = 1,
                    every_step: bool = False):
    """Raise unless every loss and grad norm is finite, the loss fell (the
    last below every loss of the first half; with `every_step`, each below
    the one before), and each step launched each training kernel once a
    layer (the forward `forwards` times) and no other kernel; (losses, grad
    norms, launches per step)."""
    losses = [r["loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    per_step = [{k: b[k] - a[k] for k in TRAIN_KERNELS}
                for a, b in zip([dict.fromkeys(TRAIN_KERNELS, 0)] + [r["launches"] for r in recs],
                                [r["launches"] for r in recs])]
    fell = losses[-1] < min(losses[:max(len(losses) // 2, 1)])
    if every_step:
        fell = fell and all(b < a for a, b in zip(losses, losses[1:]))
    if not all(np.isfinite(losses + norms)) or not fell:
        raise AssertionError(f"{what}: losses {losses}, grad norms {norms}")
    expected = {k: L * (forwards if k == "flash_prefill_with_lse" else 1) for k in TRAIN_KERNELS}
    if any(n != expected for n in per_step) or \
            counts["flash_prefill"] or counts["decode_attention"] or counts["quant_matmul"]:
        raise AssertionError(f"{what} launches per step {per_step}, in all {counts}")
    return losses, norms, per_step


def fp32_check(sv, tfa, dev, cfg, batch, what: str) -> None:
    """From the same weights and batch, 2 fp32 steps with the kernels and 2
    with the plain attention. Bound on the updated weights: each AdamW step
    moves an element by at most about lr (the first by exactly lr x sign),
    so elements whose gradient is rounding noise may differ by up to
    2 lr a step; the bound is 3 lr x steps. The kernels' run launches each
    training kernel once a layer a step, the plain run none."""
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import tree_leaves

    f32 = DTypePolicy(torch.float32, torch.float32)
    L = cfg.llm.n_layer
    reset_counts(tfa)
    p_k, r_k = _run_training(sv, tfa, cfg, dev, batch, 2, f32, kernels=True)
    p_k = [t.detach() for t in tree_leaves(p_k)]
    reset_counts(tfa)
    p_p, r_p = _run_training(sv, tfa, cfg, dev, batch, 2, f32, kernels=False)
    n_k, n_p = ({k: r[-1]["launches"][k] for k in TRAIN_KERNELS} for r in (r_k, r_p))
    if n_k != dict.fromkeys(TRAIN_KERNELS, 2 * L) or any(n_p.values()):
        raise AssertionError(f"{what} fp32 training launches: kernels {n_k}, plain {n_p}")
    diffs = [(a - b.detach()).abs() for a, b in zip(p_k, tree_leaves(p_p))]
    max_diff = max(d.max().item() for d in diffs)
    n = sum(d.numel() for d in diffs)
    close = sum((d <= 1e-6).sum().item() for d in diffs) / n
    bound = 3 * LR * 2
    for a, b in zip(r_k, r_p):
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or \
                abs(a["grad_norm"] - b["grad_norm"]) > 1e-3 * abs(b["grad_norm"]):
            raise AssertionError(f"{what} fp32 training: kernels {r_k}, plain {r_p}")
    if max_diff > bound:
        raise AssertionError(f"{what} fp32 training: updated weights differ by {max_diff:.3e} > "
                             f"{bound}")
    log("train", f"{what} fp32, 2 steps, kernels vs plain attention: loss "
                 f"{[r['loss'] for r in r_k]} vs {[r['loss'] for r in r_p]} (rtol 1e-4), "
                 f"grad_norm {[r['grad_norm'] for r in r_k]} vs {[r['grad_norm'] for r in r_p]} "
                 f"(rtol 1e-3); updated weights: max |diff| {max_diff:.3e} (bound 3 lr x 2 steps "
                 f"= {bound:.1e}), {close:.6f} of {n} elements within 1e-6; launches "
                 f"{n_k} with the kernels (2 steps x {L} layers), none with plain")
    del p_k, p_p, diffs
    torch.cuda.empty_cache()


def export_round_trip(sv, tfa, dev, train: dict, images, out: str) -> dict:
    """Phase 5b: the trained 1B (phase 5's fp32 masters) through
    train/hub.py's export_hf_checkpoint into the directory `out`, back
    through models/builder.py's load_pretrained_model at fp32; the loaded
    model's fp32 greedy ids for `images` (2, phase 4's) equal the in-memory
    weights', each generation launching flash_prefill once a layer and
    decode_attention once a layer a step. Phase 5c reads the directory;
    main deletes it after."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models.builder import load_pretrained_model
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.hub import export_hf_checkpoint
    from starvector_tpu_torch.train.optim import tree_map

    cfg = train["cfg"]
    L = cfg.llm.n_layer
    f32 = DTypePolicy(torch.float32, torch.float32)
    params = tree_map(lambda p: p.detach(), train.pop("params"))
    t0 = time.perf_counter()
    export_hf_checkpoint(params, cfg, build_test_tokenizer("v1"), out)
    t_export = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(out).iterdir())
    t0 = time.perf_counter()
    loaded, cfg2, tok, _, context_len = load_pretrained_model(out, torch.float32, dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if cfg2.llm != cfg.llm or context_len != cfg.max_length_train or tok.version != "v1":
        raise AssertionError(f"export round trip: config {cfg2.llm} vs {cfg.llm}, context "
                             f"{context_len} vs {cfg.max_length_train}, tokenizer {tok.version}")
    kw = {**GREEDY, "prompt_ids": [PROMPT_IDS] * 2, "max_new_tokens": 32}
    ids, launches = {}, {}
    for name, tree, c in (("in memory", params, cfg), ("reloaded", loaded, cfg2)):
        reset_counts(tfa)
        _, ids[name], lengths = StarVectorForCausalLM(tree, c, policy=f32, device=dev) \
            .generate_im2svg_ids({"image": images}, **kw)
        torch.cuda.synchronize()
        counts = read_counts(tfa)
        steps = int(lengths.max()) - 1
        launches[name] = {k: counts[k] for k in ("flash_prefill", "decode_attention")}
        if launches[name] != {"flash_prefill": L, "decode_attention": L * steps} or steps < 1:
            raise AssertionError(f"export round trip, {name}: launches {launches[name]}, "
                                 f"{steps} decode steps")
    if not torch.equal(ids["in memory"], ids["reloaded"]):
        raise AssertionError(f"export round trip: greedy ids differ\n{ids['in memory'].tolist()}"
                             f"\n{ids['reloaded'].tolist()}")
    log("export", f"the trained 1B through export_hf_checkpoint ({size / 1e9:.3f} GB written in "
                  f"{t_export:.1f} s) and load_pretrained_model at fp32 ({t_load:.1f} s; "
                  f"context_len {context_len}): fp32 greedy ids for 2 images, 32 tokens, equal "
                  f"to the in-memory weights' ({[len(set(r.tolist())) for r in ids['reloaded']]} "
                  f"distinct ids a row); launches {launches['reloaded']} (each = {L} layers)")
    del params, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return launches["reloaded"]


# ---------------------------------------------------------------------------
# phases 5c and 5d: the entry points at full 1B width and depth
# ---------------------------------------------------------------------------

class CallSpy:
    """Within `with CallSpy(owner, name) as spy:`, owner.name (a function
    of a module, or a classmethod) is wrapped: spy.calls lists (result,
    seconds) of each call, the card synchronised at its end."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        self.raw, fn = vars(self.owner)[self.name], getattr(self.owner, self.name)

        def spied(*a, **kw):
            t = time.perf_counter()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((result, time.perf_counter() - t))
            return result

        setattr(self.owner, self.name, spied)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.raw)


ENTRY_NEW, SERVE_IMAGES, SERVE_ENTRY_NEW, WEBUI_NEW = 64, 4, 128, 32


def entry_points_1b(tfa, dev, card: str, ckpt: str, work: Path) -> dict:
    """Phase 5c, on phase 5b's exported 1B (`ckpt`, all 24 layers):
      * `python -m starvector_tpu_torch.quickstart ckpt image 64` through its
        main, on one synthetic PNG, its stdout captured: the printed SVG
        starts with '<svg'; launches exactly 24 flash_prefill and 24
        decode_attention a decode step; the load's and the generation's
        seconds;
      * quickstart_serve's serve_images on the model main loaded, 4 images,
        128 new tokens: every request done; flash_prefill 24 an engine
        prefill chunk (stats()["prefill_chunks"]), decode_attention 24 a
        step (4 a tick), exactly;
      * the web UI (serve/webui.py) over a ModelWorker on that model, both on
        127.0.0.1: one greedy im2svg request of 32 tokens streams its chunks
        through /api/generate, each error_code 0; one vote lands in
        votes.jsonl.
    Returns the launches of each."""
    import threading

    from PIL import Image

    from starvector_tpu_torch import api, quickstart
    from starvector_tpu_torch.quickstart_serve import serve_images
    from starvector_tpu_torch.serve import webui, worker as wk
    from starvector_tpu_torch.serve.httpd import post_json

    paths = []
    for i, img in enumerate(synthetic_images(SERVE_IMAGES, 81)):
        paths.append(str(work / f"image{i}.png"))
        Image.fromarray(img).save(paths[-1])
    launches = {}

    reset_counts(tfa)
    with CallSpy(api.StarVectorForCausalLM, "from_pretrained") as load, \
            CallSpy(api, "generate") as gen, contextlib.redirect_stdout(io.StringIO()) as stdout:
        quickstart.main([ckpt, paths[0], str(ENTRY_NEW)])
    counts = read_counts(tfa)
    printed = stdout.getvalue()
    (model, t_load), = load.calls
    ((_, lengths), t_gen), = gen.calls
    L = model.cfg.llm.n_layer
    steps = int(lengths.max()) - 1
    launches["quickstart"] = expect_counts("5c quickstart", counts, flash_prefill=L,
                                           decode_attention=L * steps)
    if not printed.startswith("<svg"):
        raise AssertionError(f"5c quickstart printed {printed[:200]!r}")
    log("entry", f"{card}: quickstart.main on the exported 1B (bf16, {L} layers), one image, "
                 f"{ENTRY_NEW} greedy tokens: from_pretrained {t_load:.2f} s, generation "
                 f"{t_gen:.2f} s ({int(lengths[0])} tokens); printed {len(printed)} characters "
                 f"from '<svg'; launches {launches['quickstart']} ({L} x {steps} decode steps)")

    reset_counts(tfa)
    t0 = time.perf_counter()
    texts, stats = serve_images(model, paths, SERVE_ENTRY_NEW)
    wall = time.perf_counter() - t0
    counts = read_counts(tfa)
    launches["quickstart_serve"] = expect_counts(
        "5c quickstart_serve", counts, flash_prefill=L * stats["prefill_chunks"],
        decode_attention=L * 4 * stats["ticks"])
    if len(texts) != SERVE_IMAGES or not all(t.startswith("<svg") for t in texts):
        raise AssertionError(f"5c quickstart_serve: {[t[:40] for t in texts]}")
    log("entry", f"{card}: quickstart_serve.serve_images on that model, {SERVE_IMAGES} images, "
                 f"{SERVE_ENTRY_NEW} greedy tokens: every request done in {wall:.2f} s, "
                 f"{stats['tokens_emitted']} tokens in {stats['ticks']} ticks, "
                 f"{stats['prefill_chunks']} prefill chunks; launches "
                 f"{launches['quickstart_serve']} ({L} a chunk, {L} x 4 a tick)")

    worker = wk.ModelWorker(model, worker_addr="pending", max_batch=2, max_len=1024)
    votes = work / "votes"
    servers = [wk.build_server(worker)]
    servers.append(webui.build_server(f"http://127.0.0.1:{servers[0].server_address[1]}",
                                      str(votes)))
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for th in threads:
        th.start()
    ui = f"http://127.0.0.1:{servers[1].server_address[1]}"
    try:
        reset_counts(tfa)
        t0 = time.perf_counter()
        payload = {"task": "im2svg", "image": png_b64(synthetic_images(1, 82)[0]),
                   "max_new_tokens": WEBUI_NEW, "temperature": 0.0}
        with post_json(ui + "/api/generate", payload, 300) as resp:
            raw = resp.read()
        wall = time.perf_counter() - t0
        counts = read_counts(tfa)
        chunks = [json.loads(c) for c in raw.split(b"\0") if c]
        with post_json(ui + "/api/vote", {"vote": 1, "svg": chunks[-1]["text"] if chunks else ""},
                       60) as resp:
            resp.read()
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for th in threads:
            th.join(60)
        worker.shutdown()
    if not chunks or any(c["error_code"] != 0 or not c["text"].startswith("<svg")
                         for c in chunks):
        raise AssertionError(f"5c web UI: chunks {chunks[-1:]}")
    records = [json.loads(line) for line in open(votes / "votes.jsonl")]
    if len(records) != 1 or records[0]["vote"] != 1:
        raise AssertionError(f"5c web UI: votes.jsonl holds {records}")
    if counts["flash_prefill"] % L or not counts["flash_prefill"] or \
            counts["decode_attention"] % L or not counts["decode_attention"]:
        raise AssertionError(f"5c web UI: launches {counts}")
    launches["webui"] = {k: counts[k] for k in ("flash_prefill", "decode_attention")}
    log("entry", f"{card}: the web UI over a ModelWorker on that model (127.0.0.1): one greedy "
                 f"im2svg request of {WEBUI_NEW} tokens streamed {len(chunks)} chunks through "
                 f"/api/generate in {wall:.2f} s, every error_code 0; one vote in votes.jsonl; "
                 f"launches {launches['webui']}")
    del model, worker
    gc.collect()
    torch.cuda.empty_cache()
    return launches


GRPO_YAML = "configs/models/starvector-1b/im2svg-grpo.yaml"


def grpo_driver_1b(tfa, dev, card: str, work: Path, overrides: tuple = ()) -> dict:
    """Phase 5d: `python -m starvector_tpu_torch.train.grpo` through its
    main at full 1B width and all 24 layers, on GRPO_YAML (kl_beta 0.02:
    the KL reference's log-probs each step) with ToySVGDataset at 224 px,
    B = 2, G = 2, 64 new tokens, 2 steps, a checkpoint at step 2: 2 steps
    logged to metrics.jsonl; checkpoint-2 restores to the trainer's
    parameters bit for bit; kernels 1 and 2 (the rollouts) and 5 and 6 (the
    update and the reference log-probs) launched, each a multiple of 24.
    The card's machine has no librsvg/cairo, so every reward is 0 (the
    update's gradients are zero; its kernels run all the same). `overrides`
    are more dotlist entries (a rehearsal's smaller model). Returns the
    launches and the steps' seconds."""
    from starvector_tpu_torch.config import get_config
    from starvector_tpu_torch.train import grpo
    from starvector_tpu_torch.train.checkpoint import restore_checkpoint
    from starvector_tpu_torch.train.optim import tree_leaves

    out_dir = work / "grpo"
    argv = [f"config={Path(__file__).resolve().parent / GRPO_YAML}",
            "data.train.target=starvector_tpu.data.datasets.ToySVGDataset",
            "data.train.params.im_size=224", "data.batch_size=2", "grpo.num_generations=2",
            "grpo.max_new_tokens=64", "grpo.steps=2", "training.checkpointing_steps=2",
            f"project.out_dir={out_dir}", *overrides]
    reset_counts(tfa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as stdout:
        model, records = grpo.main(get_config(argv))
    wall = time.perf_counter() - t0
    counts = read_counts(tfa)
    L = model.cfg.llm.n_layer
    logged = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    if [r["step"] for r in logged if "loss" in r] != [1, 2] or len(records) != 2:
        raise AssertionError(f"5d: logged {logged}")
    ckpts = sorted(p.name for p in out_dir.iterdir() if p.name.startswith("checkpoint-"))
    if ckpts != ["checkpoint-2"]:
        raise AssertionError(f"5d: checkpoints {ckpts}")
    t0 = time.perf_counter()
    saved = restore_checkpoint(str(out_dir / "checkpoint-2"), dev)["params"]
    t_restore = time.perf_counter() - t0
    a, b = tree_leaves(saved), tree_leaves(model.params)
    if len(a) != len(b) or not all(torch.equal(x, y.detach()) for x, y in zip(a, b)):
        raise AssertionError("5d: checkpoint-2 does not restore the trainer's parameters")
    used = ("flash_prefill", "decode_attention", "flash_prefill_with_lse", "flash_bwd_dkdv",
            "flash_bwd_dq")
    got = {k: counts[k] for k in used}
    if any(not n or n % L for n in got.values()):
        raise AssertionError(f"5d: launches {got}")
    parts = [tuple(round(r[k], 3) for k in ("rollout_s", "reward_s", "update_s"))
             for r in records]
    step_s = [round(sum(p), 3) for p in parts]
    log("grpo", f"{card}: train.grpo.main on {GRPO_YAML}, StarVector-1B at full width and {L} "
                f"layers, ToySVGDataset at 224 px, B=2, G=2, 64 tokens, 2 steps: "
                f"{wall:.1f} s in all; steps {step_s} s (rollout / reward / update {parts}); "
                f"printed {len(stdout.getvalue().splitlines())} lines; 2 steps in metrics.jsonl; "
                f"checkpoint-2 restored ({len(a)} leaves, {t_restore:.1f} s) == the trainer's "
                f"parameters bit for bit; launches {got}")
    del model, saved
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=got, step_s=step_s)


TRAIN_KERNEL_CLASSES = (  # (label, substrings of the CUDA kernel's name), first match wins
    ("flash_bwd_dkdv", ("flash_bwd_dkdv",)),  # with its finish kernel
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_prefill_with_lse", ("flash_prefill_bf16_kernel", "flash_prefill_f32_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")),
    ("layer_norm", ("layer_norm",)),
)


PROFILE_FILES = {"1B": "profile_train.txt", "8B": "profile_train_8b.txt",
                 "8B recipe": "profile_train_8b_recipe.txt"}


def profile_train_step(sv, tfa, dev, cfg, batch, card: str, step_wall: float, out_dir: Path,
                       label: str, remat="dots_flash", **run) -> None:
    """Where one full-width train step's device time goes: torch.profiler
    traces the 4th step of a fresh run (3 of warm-up); the wall time is
    the unprofiled median of phase 5 (the 1B), 6b (the 8B) or 6c (the 8B
    recipe; `run` its optimizer and grad_dtype). Writes the kernel table to
    out_dir/PROFILE_FILES[label]."""
    from torch.profiler import ProfilerActivity, profile

    from starvector_tpu_torch.ops.layers import DTypePolicy

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def hook(step):
        if step == 3:
            prof.start()
        elif step == 4:
            prof.stop()

    _run_training(sv, tfa, cfg, dev, batch, 4, DTypePolicy(torch.float32, torch.bfloat16),
                  hook=hook, remat=remat, **run)
    gc.collect()
    torch.cuda.empty_cache()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_class: dict[str, float] = {}
    for e in rows:
        cls = next((lab for lab, keys in TRAIN_KERNEL_CLASSES
                    if any(k in e.key.lower() for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    device = sum(by_class.values())
    if not device:
        raise AssertionError("the profiler recorded no device time")
    out_dir.mkdir(parents=True, exist_ok=True)
    B, S = batch["svg_ids"].shape
    T = cfg.encoder_config.geometry[1] + S
    path = out_dir / PROFILE_FILES[label]
    path.write_text(
        f"{card}\nStarVector-{label} train step, B={B} T={T}, {cfg.llm.n_layer} decoder layers, "
        f"bf16 compute, remat {remat!r}, "
        + ("Adafactor, bf16 gradients\n" if label == "8B recipe" else "AdamW\n")
        + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    log("profile", f"{card}: {label} train step B={B} T={T} (tables in {path}): wall "
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
        log("times", f"{card}: {name} {shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                     f"TFLOP/s, {b_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
                     f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
                     f"GFLOP), library {'n/a' if lib is None else f'{lib:.4f} ms'}")
        src = "flash_prefill.cu" if name == "flash_prefill_with_lse" else "flash_backward.cu"
        rows.append(dict(name=name, route="cuda", source=f"starvector_tpu_torch/csrc/{src}",
                         replaces=f"starvector_tpu/ops/flash_attention.py:{replaces}",
                         launches=train["counts"][name], max_abs_err=errs[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


def sdpa_backward_ms(q, k, v, do, iters: int = 20, mask: dict | None = None, **kw):
    """SDPA's backward on (B, H, S, D) queries over (B, H, T, D) keys,
    causal with the last query on the last key (lower right, which is top
    left when S = T), or under `mask` (SDPA's mask arguments; `kw` such as
    enable_gqa=True go to SDPA too): one autograd call giving dq, dk and dv.
    The faster of the backward of the backend SDPA dispatches to by itself
    and of its flash or memory-efficient backend, as sdpa_ms."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, T = q.shape[2], k.shape[2]
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    mask = _sdpa_causal(S, T) if mask is None else mask
    times = []
    for fused in (False, True):
        try:
            with (sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])
                  if fused else contextlib.nullcontext()):
                out = F.scaled_dot_product_attention(qr, kr, vr, **mask, **kw)
        except RuntimeError as e:
            log("times", f"scaled_dot_product_attention at S={S}, T={T}"
                         f"{', flash/efficient' if fused else ''}: no backend "
                         f"({str(e).splitlines()[0][:160]})")
            continue
        times.append(library_ms(
            lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True),
            "scaled_dot_product_attention backward", timer=lambda fn: event_ms(fn, iters)))
        del out
    times = [t for t in times if t is not None]
    return min(times) if times else None


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
    each beside its bound. The kernels and SDPA's forward are graph-replayed
    (10 kernel calls a graph); the plain versions and SDPA's backward run
    eager between CUDA events (3 after 3 of warm-up): each is tens of
    milliseconds to seconds of device work, and the plain version's
    (H, S, T) fp32 blocks are too large to capture several of in a graph."""
    g = torch.Generator(device=dev).manual_seed(12)
    D = 128
    timer, graphed = functools.partial(event_ms, iters=3), functools.partial(cuda_ms, iters=10)
    for name, rows, B, S, T, H, q_off in LONG_CASES:
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, T, 1, D), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off)
        delta = tfa.attention_delta(out, do)
        t = {"fwd": graphed(lambda: tfa.flash_prefill_with_lse(q, k, v, mask, q_off)),
             "dkdv": graphed(lambda: tfa.flash_bwd_dkdv(q, k, v, mask, do, lse, delta, q_off)),
             "dq": graphed(lambda: tfa.flash_bwd_dq(q, k, v, mask, do, lse, delta, q_off)),
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
        flops = {"fwd": 4 * D * pairs, "dkdv": 8 * D * pairs, "dq": 6 * D * pairs}
        bounds = {"fwd": bound(2 * act + 2 * kv + stats + m, flops["fwd"]),
                  "dkdv": bound(2 * act + 4 * kv + 2 * stats + m, flops["dkdv"]),
                  "dq": bound(3 * act + 2 * kv + 2 * stats + m, flops["dq"])}
        log("times", f"{card}: long context {name} (kernel table rows {rows}), B={B} H={H} "
                     f"Hkv=1 D=128 bf16: " + ", ".join(
                         f"{k_} {'n/a' if v_ is None else f'{v_:.3f} ms'}" for k_, v_ in t.items())
                     + "; bounds " + ", ".join(f"{k_} {b_[0]:.4f} ms ({b_[1]})"
                                               for k_, b_ in bounds.items())
                     + "; kernels " + ", ".join(
                         f"{k_} {flops[k_] / t[k_] / 1e9:.1f} TFLOP/s ({bounds[k_][0] / t[k_]:.1%} "
                         "of the bound)" for k_ in bounds))
        del q, k, v, do, out, lse, delta, qh, kh, vh, doh
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: StarVector-8B inference at full width
# ---------------------------------------------------------------------------

PREFIX_8B = 4700  # the window check's prefix, past the 4096-key window
# the depths of earlier slices' paths, at full width: eager decoding is
# host-bound, so their wall time goes with the layers, and at full depth
# the script passed its 1200-s limit on a slow host (phase 6 alone took
# 200-400 s at all 32 layers)
DEPTH_1B_EARLIER = 8  # of 24: 4b's decoding variants, 4c's serving, 4d's eval
DEPTH_8B = 8  # of 32: phase 6's 8B inference


def first_layers(params: dict, cfg, n: int):
    """(params, cfg) of the model cut to its decoder's first n layers (views
    of the same weights, which keep the whole tree's storage alive)."""
    import dataclasses

    st = dict(params["svg_transformer"])
    st["layers"] = _map_tree(st["layers"], lambda t: t[:n])
    depth = "num_hidden_layers" if hasattr(cfg.llm, "num_hidden_layers") else "n_layer"
    return ({**params, "svg_transformer": st},
            dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **{depth: n})))


def slice_8b(sv, tfa, dev, card: str, profile_dir: Path | None = None) -> dict:
    """StarVector-8B im2svg at full width (StarCoder2-7B: 4608 wide, 36
    query heads over 4 KV heads, window 4096; SigLIP-L/16 at 384; LayerNorm
    adapter) and the first DEPTH_8B of its 32 decoder layers, on random bf16
    weights drawn on the card by StarVectorForCausalLM.from_config from a
    seed, projections scaled as in phase 4. 3 requests of 4 images through
    generate_im2svg_ids with exact launch counts (a flash_prefill a layer a
    prefill, a decode_attention a layer a step, no training or int8
    kernel); bf16 prefill logits against the fp32 plain ones and fp32 greedy
    ids, kernels against plain, on an fp32 copy of the same layers; the
    window at full width (2 layers,
    a 4700-token prefix, 32 greedy tokens, fp32 ids kernels == plain); then
    p50 latency, B=4 tokens/s and memory (with `profile_dir`, where a B=4
    request's device time goes). Returns the launch counts, p50, tokens/s
    and the tree's bytes."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.generation.engine import GenerationConfig, generate, im2svg_prefix
    from starvector_tpu_torch.models import starcoder2
    from starvector_tpu_torch.ops.layers import DTypePolicy

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = config_8b(sv, DEPTH_8B)
    L = cfg.llm.num_hidden_layers
    depth = f"{L} of {sv.starvector_8b_config().llm.num_hidden_layers} layers (DEPTH_8B)"
    model = StarVectorForCausalLM.from_config(cfg, seed=8, dtype=torch.bfloat16, device=dev)
    p16 = scale_projections(model.params)
    torch.cuda.synchronize()
    parts = {k: tree_bytes(v) / 2**30 for k, v in p16.items()}
    log("8b", f"StarVector-8B (StarCoder2-7B {cfg.llm.hidden_size} wide, {depth}, "
              f"{cfg.llm.num_attention_heads} heads over {cfg.llm.kv_heads}, window "
              f"{cfg.llm.sliding_window}; {cfg.image_encoder_type}; {cfg.adapter_norm} adapter) "
              f"from_config(seed=8) in bf16 on the card: weights "
              f"{tree_bytes(p16) / 2**30:.2f} GiB ("
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
              + f"), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing them, "
              f"{held / 2**30:.2f} GiB held before")

    request = api_requester(model)
    request(synthetic_images(4, 99), max_new_tokens=8)  # warm-up: cuBLAS handles, allocator
    reset_counts(tfa)
    served = [request(synthetic_images(4, seed)) for seed in range(3)]
    counts = read_counts(tfa)
    steps = [int(lengths.max()) - 1 for _, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape != (4, 128) or int(tokens.min()) < 0 or \
                int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"8B: bad tokens {tuple(tokens.shape)} [{tokens.min()}, "
                                 f"{tokens.max()}]")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"8B: bad lengths {lengths.tolist()}")
    expected = {"flash_prefill": L * 3, "decode_attention": L * sum(steps),
                "decode_attention_int8": 0, "quant_matmul": 0, **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"8B launches {got}, expected {expected}")
    distinct = [len(set(row.tolist())) for tokens, _, _ in served for row in tokens]
    log("8b", f"3 requests x 4 images, greedy, 128 new tokens: decode steps {steps}, lengths "
              f"{[l.tolist() for _, l, _ in served]}, distinct ids per row {distinct}; launches "
              f"flash_prefill {got['flash_prefill']} = {L} x 3 prefills, decode_attention "
              f"{got['decode_attention']} = {L} x {sum(steps)} decode steps, no training or int8 "
              f"kernel")

    # fp32 on a copy of the same weights
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    p32, cfg32 = _cast_tree(p16, torch.float32), cfg
    images = model.process_images(synthetic_images(4, 11))
    prompt = torch.tensor([PROMPT_IDS] * 4, device=dev)

    def prefill_logits(params, policy, kernels):
        emb, mask = im2svg_prefix(params, cfg32, images, prompt, policy=policy)
        cache = starcoder2.init_cache(cfg32.llm, 4, emb.shape[1], dtype=policy.compute_dtype,
                                      device=dev)
        return starcoder2.forward(params["svg_transformer"], cfg32.llm, emb, mask, cache=cache,
                                  policy=policy, last_logits_only=True, kernels=kernels)[0]

    ref32 = prefill_logits(p32, f32, False)
    logits = {k: prefill_logits(p16, bf16, k) for k in (True, False)}
    err_k = (logits[True] - ref32).abs().max().item()
    err_p = (logits[False] - ref32).abs().max().item()
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"8B bf16 prefill logits: kernels {err_k:.3e} from fp32, over twice "
                             f"the plain version's {err_p:.3e}")
    log("8b", f"bf16, B=4, {depth}: prefill last-position logits from the fp32 plain "
              f"logits (max |logit| {ref32.abs().max().item():.3e}): kernels {err_k:.4e}, plain "
              f"{err_p:.4e} (bound: kernels <= 2 x plain + 1e-3)")
    del logits, ref32
    ids = {}
    for kernels in (True, False):
        m32 = StarVectorForCausalLM(p32, cfg32, policy=f32, device=dev, kernels=kernels)
        _, ids[kernels], _ = m32.generate_im2svg_ids(
            {"image": images[:2]}, **{**GREEDY, "prompt_ids": [PROMPT_IDS] * 2,
                                      "max_new_tokens": 32})
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"8B fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    log("8b", f"fp32, B=2, 32 tokens, {depth}: greedy ids with the kernels == with the plain "
              f"attention ({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row)")

    # text2svg: captions through the v2 test tokenizer, the same bf16 weights;
    # its fp32 check on the fp32 copy above
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

    t2s = text2svg_slice(tfa, "8B", StarVectorForCausalLM(p16, cfg, build_test_tokenizer("v2"),
                                                          policy=model.policy, device=dev),
                         p32, cfg32, dev, depth)
    decoding_8b(tfa, model, cfg, p16, p32, cfg32, dev, depth)
    t_pipe = time.perf_counter()
    pipe_8b = pipelined_8b(tfa, model, cfg, p16, p32, cfg32, dev, card, depth)
    log("phase", f"6 (StarVector-8B pipelined generation) took "
                 f"{time.perf_counter() - t_pipe:.0f} s")
    t_6d = time.perf_counter()
    serve_8b = serving_8b(tfa, model, cfg, p16, p32, cfg32, dev, card, depth)
    log("phase", f"6d (StarVector-8B continuous-batching serving) took "
                 f"{time.perf_counter() - t_6d:.0f} s")
    del m32, p32
    torch.cuda.empty_cache()

    # the window at full width: 2 layers, a prefix past 4096 keys, fp32
    q2, cfg2 = first_layers(p16, cfg, 2)
    p2 = _cast_tree(q2, torch.float32)
    n_visual = cfg.encoder_config.geometry[1]
    long_ids = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.llm.vocab_size, (2, PREFIX_8B - n_visual))).to(dev)
    emb, mask = im2svg_prefix(p2, cfg2, model.process_images(synthetic_images(2, 17)), long_ids,
                              policy=f32)
    gen = GenerationConfig(max_new_tokens=32, do_sample=False, stop_sequences=(),
                           eos_token_id=None, pad_token_id=0)
    win = {}
    for kernels in (True, False):
        reset_counts(tfa)
        win[kernels] = generate(p2["svg_transformer"], cfg2.llm, emb, mask, gen, policy=f32,
                                kernels=kernels)[0]
        if kernels:
            win_counts = read_counts(tfa)
    if not torch.equal(win[True], win[False]):
        raise AssertionError(f"8B window: fp32 greedy ids differ:\n{win[True].tolist()}\n"
                             f"{win[False].tolist()}")
    if (win_counts["flash_prefill"], win_counts["decode_attention"]) != (2, 2 * 31):
        raise AssertionError(f"8B window launches {win_counts}")
    log("8b", f"the window at full width, fp32, 2 layers, B=2: a {PREFIX_8B}-token prefix "
              f"({n_visual} visual + {PREFIX_8B - n_visual} prompt ids), past "
              f"the {cfg.llm.sliding_window}-key window, then 32 greedy tokens (decode steps see "
              f"slots from {PREFIX_8B - cfg.llm.sliding_window + 1} on): ids with the kernels "
              f"== with the plain attention ({[len(set(r.tolist())) for r in win[True]]} "
              f"distinct ids per row; launches flash_prefill {win_counts['flash_prefill']}, "
              f"decode_attention {win_counts['decode_attention']} = 2 x 31)")
    del p2, q2, emb, mask
    torch.cuda.empty_cache()

    e2e = serving_times(card, {"8B bf16": request, "8B text2svg": t2s["request"]})
    log("times", f"{card}: 8B text2svg (prompts of 6-30 tokens, no vision tower) against "
                 f"im2svg, bf16: p50 B=1 {e2e['8B text2svg']['p50'] * 1e3:.1f} vs "
                 f"{e2e['8B bf16']['p50'] * 1e3:.1f} ms, B=4 decode "
                 f"{e2e['8B text2svg']['rate']:.1f} vs {e2e['8B bf16']['rate']:.1f} tokens/s")
    memory_times(card, {"8B bf16": request}, {"8B bf16": p16})
    if profile_dir is not None:
        profile_request(request, card, profile_dir, "8b")
    e2e = e2e["8B bf16"]
    out = dict(counts=got, p50=e2e["p50"], rate=e2e["rate"], weights=tree_bytes(p16),
               serve=serve_8b, pipelined=pipe_8b)
    del request, served, t2s
    out["int8"] = int8_slice_8b(model, tfa, cfg, p16, dev, card, e2e, depth, profile_dir)
    del model, p16
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decoding_8b(tfa, model, cfg, p16, p32, cfg32, dev, depth: str) -> None:
    """Phase 6's decoding variants on the 8B's bf16 tree (full width,
    `depth`) and its fp32 copy: beam search,
    num_beams=2 at B=1 through the API (flash_prefill once a layer over
    B x K = 2 rows, decode_attention at G = 9 once a layer a step), fp32 ids
    kernels == plain; speculative decoding at B=1 and B=4 through the API
    (flash_prefill only: every verify is the chunk step, B=4's through
    StarCoder2's forward_ragged_verify), then speculative_checks."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starcoder2
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.num_hidden_layers
    f32 = DTypePolicy(torch.float32, torch.float32)
    request = api_requester(model)
    one = synthetic_images(1, 61)
    request(one, num_beams=2, max_new_tokens=4, prompt_ids=[PROMPT_IDS])  # warm-up
    reset_counts(tfa)
    with BatchSpy(starcoder2) as spy:
        tokens, lengths, secs = request(one, num_beams=2, prompt_ids=[PROMPT_IDS])
    counts = read_counts(tfa)
    steps = len(spy.rows) - 1
    expect_counts("8B beam", counts, flash_prefill=L, decode_attention=L * steps)
    if spy.rows != [2] * (steps + 1) or not int(lengths.max()) - 1 <= steps <= 127:
        raise AssertionError(f"8B beam: forwards at rows {spy.rows}, lengths {lengths.tolist()}")
    x1 = model.process_images(one)
    ids = {k: StarVectorForCausalLM(p32, cfg32, policy=f32, device=dev, kernels=k)
           .generate_im2svg_ids({"image": x1}, num_beams=2, **{
               **GREEDY, "prompt_ids": [PROMPT_IDS], "max_new_tokens": 32})[1:]
           for k in (True, False)}
    if not all(torch.equal(a, b) for a, b in zip(ids[True], ids[False])):
        raise AssertionError(f"8B beam fp32 ids differ:\n{ids[True]}\n{ids[False]}")
    log("decoding", f"8B beam search, num_beams=2, B=1, 128 new tokens, bf16: length "
                    f"{int(lengths[0])}, {steps + 1} forwards at B x K = 2 rows, "
                    f"{secs * 1e3:.1f} ms; launches flash_prefill {counts['flash_prefill']} = {L} "
                    f"x 1, decode_attention (G = 9) {counts['decode_attention']} = {L} x {steps}; "
                    f"fp32, 32 tokens, {depth}: ids and lengths with the kernels == plain")
    four = synthetic_images(4, 62)
    for B in (1, 4):
        request(four[:B], max_new_tokens=4, prompt_ids=[PROMPT_IDS] * B, use_speculative=True)
        reset_counts(tfa)
        request(four[:B], prompt_ids=[PROMPT_IDS] * B, use_speculative=True)
        expect_counts(f"8B speculative B={B}", read_counts(tfa), flash_prefill=L)
    log("decoding", f"8B speculative decoding through the API, bf16, B=1 and B=4, 128 new "
                    f"tokens: launches flash_prefill {L} a request, no decode_attention")
    speculative_checks("8B", cfg, p16, model.policy, cfg32, p32, f32,
                       model.process_images(four), torch.tensor([PROMPT_IDS] * 4, device=dev))


PIPE_8B_NEW = 32  # new tokens of the 8B's checked pipelined runs


def pipelined_8b(tfa, model, cfg, p16, p32, cfg32, dev, card: str, depth: str) -> dict:
    """Phase 6's offline pipelined generation on the 8B's bf16 tree (full
    width, `depth`) and its fp32 copy:
    StarCoder2 has no fused forward, so each step is the cached decode
    forward (kernel 2 at G = 9) and then the next prompt's chunk through the
    chunk step. 2 batches of B=2 im2svg prefixes, 32 greedy new tokens
    (C = 19): fp32 ids and lengths equal per-batch generate's and the plain
    attention's; bf16 launches exactly a flash_prefill a layer (batch 0)
    and a decode_attention a layer a decode step; generate_pipelined_spec
    raises the port's NotImplementedError; then tokens/s of serial
    per-batch generate and generate_pipelined in turns (a, b, b, a) at 3
    batches of B=4, 128 new tokens. Returns the bf16 launches and the
    rates."""
    from starvector_tpu_torch.generation import engine, speculative
    from starvector_tpu_torch.ops.layers import DTypePolicy

    L = cfg.llm.num_hidden_layers
    f32, bf16 = DTypePolicy(torch.float32, torch.float32), model.policy

    def prefixes(params, c, policy, n, B, seed):
        out = []
        for i in range(n):
            x = model.process_images(synthetic_images(B, seed + i))
            prompt = torch.tensor([PROMPT_IDS] * B, device=dev)
            out.append(engine.im2svg_prefix(params, c, x, prompt, policy=policy))
        return out

    def gen(n):
        return engine.GenerationConfig(max_new_tokens=n, do_sample=False,
                                       stop_sequences=STOP_IDS, eos_token_id=None,
                                       pad_token_id=0)

    d32, d16 = p32["svg_transformer"], p16["svg_transformer"]
    b32 = prefixes(p32, cfg32, f32, 2, 2, 71)
    out = engine.generate_pipelined(d32, cfg32.llm, b32, gen(PIPE_8B_NEW), policy=f32)
    same_ids("8B pipelined fp32 against per-batch generate", out,
             [engine.generate(d32, cfg32.llm, e, m, gen(PIPE_8B_NEW), policy=f32)
              for e, m in b32])
    same_ids("8B pipelined fp32, kernels against plain", out,
             engine.generate_pipelined(d32, cfg32.llm, b32, gen(PIPE_8B_NEW), policy=f32,
                                       kernels=False))
    P = b32[0][0].shape[1]
    C, n_chunks = engine._chunk_plan(P, PIPE_8B_NEW, None)
    del b32
    b16 = prefixes(p16, cfg, bf16, 2, 2, 71)
    reset_counts(tfa)
    out = engine.generate_pipelined(d16, cfg.llm, b16, gen(PIPE_8B_NEW), policy=bf16)
    steps = pipelined_steps(out, n_chunks)
    got = expect_counts("8B pipelined bf16", read_counts(tfa), flash_prefill=L,
                        decode_attention=L * steps["decode"])
    log("pipelined", f"8B generate_pipelined, 2 batches of B=2 prefixes of {P} tokens, "
                     f"{PIPE_8B_NEW} new tokens, C={C} ({n_chunks} chunks; no fused forward: "
                     f"each step the decode forward, then the chunk step): fp32, {depth}: ids and "
                     f"lengths == per-batch generate's and == the plain attention's; bf16: "
                     f"launches flash_prefill {got['flash_prefill']} = {L} x 1 (batch 0), "
                     f"decode_attention (G = 9) {got['decode_attention']} = {L} x "
                     f"{steps['decode']} decode steps")
    e, m = b16[0]
    ids = torch.full(m.shape, -1, dtype=torch.int64, device=dev)
    try:
        speculative.generate_pipelined_spec(d16, cfg.llm, [(e, m, ids)] * 2, gen(4), policy=bf16)
    except NotImplementedError as err:
        log("pipelined", f"8B generate_pipelined_spec raises NotImplementedError: {err}")
    else:
        raise AssertionError("8B generate_pipelined_spec ran without a fused verify forward")
    b16 = prefixes(p16, cfg, bf16, 3, 4, 81)
    runs = {"serial generate": lambda: [engine.generate(d16, cfg.llm, e, m, gen(128), policy=bf16)
                                        for e, m in b16],
            "generate_pipelined": lambda: engine.generate_pipelined(d16, cfg.llm, b16, gen(128),
                                                                    policy=bf16)}
    rates = {k: [] for k in runs}
    for label in list(runs) + list(runs)[::-1]:
        res, wall = timed(runs[label])
        rates[label].append(sum(float(l.sum()) for _, l in res) / wall)
    med = {k: statistics.median(v) for k, v in rates.items()}
    log("times", f"{card}: 8B offline, {depth}, 3 batches of B=4 "
                 f"prefixes of {P} tokens, 128 greedy tokens, bf16, in turns (a, b, b, a), "
                 f"emitted tokens / wall: "
                 + "; ".join(f"{k} {med[k]:.1f} tokens/s ({[round(x, 1) for x in v]})"
                             for k, v in rates.items())
                 + f"; pipelined / serial {med['generate_pipelined'] / med['serial generate']:.3f}")
    return dict(launches=got, rates=med)


def int8_slice_8b(model, tfa, cfg, p16, dev, card: str, bf16_e2e: dict, depth: str,
                  profile_dir: Path | None = None) -> dict:
    """StarVector-8B with int8 decoder weights and an int8 KV cache at full
    width and phase 6's `depth`: quantize_tree on the bf16 decoder,
    consuming it (each bf16 leaf goes once its codes exist, so the two trees
    never coexist beyond one leaf); requests of 4 images and of 1, greedy,
    128 new tokens, with exact launch counts (6 kernel-14 calls a layer a prefill, on the
    tile, and a decode step, on the GEMV; a flash_prefill a layer a prefill
    over the dequantized window; an int8-cache decode_attention a layer a
    step); fp32 compute over the same codes (the rest cast to fp32),
    kernels vs plain: greedy ids with an fp32 KV cache, and teacher-forced
    logits with the int8 cache (see below); weights and a request's peak
    above them; p50 and B=4 tokens/s beside the bf16 figures of the same
    call (with `profile_dir`, where a B=4 decode step's device time goes).
    Returns the launch counts, p50, tokens/s and the tree's bytes."""
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import starcoder2
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.ops.quantization import quantize_tree

    L = cfg.llm.num_hidden_layers
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    decoder16 = tree_bytes(p16["svg_transformer"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    q8 = {**p16, "svg_transformer": quantize_tree(p16["svg_transformer"])}
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t, torch.cuda.max_memory_allocated() - held
    layers = q8["svg_transformer"]["layers"]
    leaves = {f"{grp}.{name}": leaf for grp in ("attn", "mlp")
              for name, leaf in layers[grp].items()}
    if len(leaves) != 6 or not all("kernel_q" in leaf and "bias" in leaf
                                   for leaf in leaves.values()):
        raise AssertionError(f"8B int8: quantize_tree took {sorted(leaves)}")
    log("8b-int8", f"quantize_tree on the 8B decoder in {secs:.1f} s, consuming it: the six "
                   f"projections a layer ({', '.join(leaves)}) as int8 codes with ({L}, N) fp32 "
                   f"scales and their biases; decoder {decoder16 / 2**30:.2f} -> "
                   f"{tree_bytes(q8['svg_transformer']) / 2**30:.2f} GiB, all weights "
                   f"{tree_bytes(q8) / 2**30:.2f} GiB; peak {peak / 2**30:.2f} GiB above the "
                   f"{held / 2**30:.2f} GiB held before")

    request = int8_requester(model, cfg, q8, bf16, dev)
    request(synthetic_images(4, 99), max_new_tokens=8)  # warm-up
    reset_counts(tfa)
    served = [request(synthetic_images(4, 0)), request(synthetic_images(1, 1))]
    counts = read_counts(tfa)
    steps = [int(lengths.max()) - 1 for _, lengths, _ in served]
    for tokens, lengths, _ in served:
        if tokens.shape[1] != 128 or int(tokens.min()) < 0 or \
                int(tokens.max()) >= cfg.llm.vocab_size:
            raise AssertionError(f"8B int8: bad tokens {tuple(tokens.shape)}")
        if not ((lengths >= 1) & (lengths <= 128)).all():
            raise AssertionError(f"8B int8: bad lengths {lengths.tolist()}")
    n = sum(steps)
    expected = {"quant_matmul": 6 * L * (2 + n), "quant_matmul_gemv": 6 * L * n,
                "quant_matmul_wgmma": 6 * L * 2, "quant_matmul_f32_tile": 0,
                "flash_prefill": L * 2, "decode_attention": L * n, "decode_attention_int8": L * n,
                **dict.fromkeys(TRAIN_KERNELS, 0)}
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f"8B int8 launches {got}, expected {expected}")
    log("8b-int8", f"requests of 4 images and of 1, greedy, 128 new tokens: decode steps {steps}, "
                   f"lengths {[l.tolist() for _, l, _ in served]}; launches quant_matmul "
                   f"{got['quant_matmul']} = {6 * L} x (2 prefills + {n} decode steps) (wgmma tile "
                   f"{got['quant_matmul_wgmma']} at M = 4 x 580 and 580, GEMV "
                   f"{got['quant_matmul_gemv']}), flash_prefill {got['flash_prefill']} = {L} x 2, "
                   f"int8-cache decode_attention {got['decode_attention_int8']} = {L} x {n}, no "
                   f"training kernel")

    # fp32 compute over the same codes and scales. With an fp32
    # KV cache: greedy ids, kernels against plain. With the int8 cache the
    # two paths' fp32 sums, which differ only in order, round some k/v to
    # the next code, and each flip moves the next layer's inputs by a scale
    # step, so flips grow layer by layer (tens in layer 0, a fifth of the
    # codes by layer 31 on the H100) and greedy ids over 32 tokens would
    # agree by chance; there the check is teacher-forced: both paths fed
    # the plain path's greedy ids, their logits within INT8_CACHE_LOGIT_TOL
    # at every step, and the same argmax wherever the plain path's top two
    # are further apart than twice that step's difference.
    q32 = _cast_tree(q8, torch.float32)
    ids = {k: int8_requester(model, cfg, q32, f32, dev, kernels=k,
                             kv_cache_dtype=torch.float32)(
        synthetic_images(2, 7), max_new_tokens=32)[0] for k in (True, False)}
    if not torch.equal(ids[True], ids[False]):
        raise AssertionError(f"8B int8 fp32 greedy ids differ:\n{ids[True].tolist()}\n"
                             f"{ids[False].tolist()}")
    emb, mask = im2svg_prefix(q32, cfg, model.process_images(synthetic_images(2, 7)),
                              torch.tensor([PROMPT_IDS] * 2, device=dev), policy=f32)
    tf, plain8 = {}, None
    for k in (False, True):
        tf[k], plain8 = forced_logits(starcoder2, q32["svg_transformer"], cfg.llm, emb, mask, 32,
                                      f32, k, torch.int8, plain8)
    diff = (tf[True] - tf[False]).abs().amax(-1)  # (B, 32)
    top2 = tf[False].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > 2 * diff
    agree = tf[True].argmax(-1) == tf[False].argmax(-1)
    if diff.max().item() > INT8_CACHE_LOGIT_TOL or not agree[clear].all():
        raise AssertionError(f"8B int8 cache, fp32, teacher-forced: max |logit diff| "
                             f"{diff.max().item():.3e} (limit {INT8_CACHE_LOGIT_TOL}), argmax "
                             f"differs at {int((~agree & clear).sum())} clear steps")
    log("8b-int8", f"fp32 compute over the same codes, B=2, 32 tokens, {depth}: "
                   f"with an fp32 KV cache greedy ids with the kernels == with the plain versions "
                   f"({[len(set(r.tolist())) for r in ids[True]]} distinct ids per row); with "
                   f"the int8 cache, fed the plain path's greedy ids: max |logit diff| per step "
                   f"{diff.min().item():.4f}-{diff.max().item():.4f} (limit "
                   f"{INT8_CACHE_LOGIT_TOL}; max |logit| {tf[False].abs().max().item():.2f}), "
                   f"argmax equal at all {int(clear.sum())} of 64 steps whose top-2 margin is "
                   f"over twice it, and at {int(agree.sum())} of 64 in all")
    del q32, tf
    torch.cuda.empty_cache()

    memory_times(card, {"8B int8": request}, {"8B int8": q8})
    e2e = serving_times(card, {"8B int8": request}, rounds=1)["8B int8"]
    log("times", f"{card}: 8B int8 (weights and KV cache) against the 8B bf16 figures earlier in "
                 f"this call: p50 B=1 {e2e['p50'] * 1e3:.1f} vs {bf16_e2e['p50'] * 1e3:.1f} ms, "
                 f"B=4 decode {e2e['rate']:.1f} vs {bf16_e2e['rate']:.1f} tokens/s")
    if profile_dir is not None:
        profile_request(request, card, profile_dir, "8b_int8")
    out = dict(counts=got, p50=e2e["p50"], rate=e2e["rate"], weights=tree_bytes(q8))
    del request, served, q8
    return out


# ---------------------------------------------------------------------------
# phase 6b: StarVector-8B training at full width, reduced depth
# ---------------------------------------------------------------------------

# 8 of the 32 decoder layers: AdamW's fp32 state at 16 bytes a parameter is
# ~120 GB for the whole 7.5 B, ~37 GB for the ~2.3 B of an 8-layer tree
TRAIN_8B_LAYERS = 8
# B = 1, T = 576 visual + 7616 svg tokens = 8192: the v5e-8 recipe's global
# batch of 4 over fsdp = 4 at its 8192 context, the reference's per-device shape
SVG_8B = (7616,)
# the fp32 check: 2 layers, T = 576 + 4124 = 4700, past the 4096-key window
SVG_8B_FP32 = (4124,)


def config_8b(sv, layers: int):
    """starvector_8b_config with its decoder cut to its first `layers`."""
    import dataclasses

    cfg = sv.starvector_8b_config()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_hidden_layers=layers))


def train_slice_8b(sv, tfa, dev) -> dict:
    """8 steps of StarVector-8B training at full width (StarCoder2 4608
    wide, 36/4 heads, head 128, window 4096; SigLIP-L/16 at 384 and the
    LayerNorm adapter, all trainable) and 8 of its 32 decoder layers, on
    one batch of B = 1, T = 8192, through the port's train loop: fp32
    masters, bf16 compute, dots_flash, AdamW. Checks the loss falls, every
    value is finite, and each step launched each training kernel once a
    layer; then one loss and backward with remat=True on the trained
    weights, which runs the forward kernel twice a layer. Then the fp32
    check (fp32_check) at 2 layers, T = 4700."""
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import tree_leaves
    from starvector_tpu_torch.train.train import to_device

    cfg = config_8b(sv, TRAIN_8B_LAYERS)
    L = cfg.llm.num_hidden_layers
    images = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch
    batch = training_batch(cfg, images, dev, lengths=SVG_8B)
    bf16 = DTypePolicy(torch.float32, torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what phase 6 leaves held
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tfa)
    params, recs = _run_training(sv, tfa, cfg, dev, batch, TRAIN_STEPS, bf16)
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    losses, norms, per_step = check_train_run("8B training", recs, counts, L)
    n_params = sum(p.numel() for p in tree_leaves(params))
    B, T = 1, cfg.encoder_config.geometry[1] + max(SVG_8B)
    log("train", f"StarVector-8B at full width, {L} of 32 decoder layers ({n_params / 1e9:.3f} B "
                 f"parameters, SigLIP and the adapter trainable), B={B}, T={T} ({T - max(SVG_8B)} visual "
                 f"+ {max(SVG_8B)} svg tokens), window {cfg.llm.sliding_window}, fp32 masters / bf16 "
                 f"compute, dots_flash, AdamW lr {LR}: {TRAIN_STEPS} steps on one batch, loss "
                 f"{[round(x, 4) for x in losses]}, grad_norm {[round(x, 4) for x in norms]}; "
                 f"launches per step {per_step[0]} (each = {L} layers), in all {counts}; peak "
                 f"memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
                 f"{base / 2**30:.2f} GiB held before the first step")

    reset_counts(tfa)
    loss, _ = sv.loss_fn_with_bn_stats(params, cfg, to_device(batch, dev), 0, policy=bf16,
                                       remat=True)
    grads = torch.autograd.grad(loss, [p for p in tree_leaves(params) if p.requires_grad])
    torch.cuda.synchronize()
    remat_counts = {k: read_counts(tfa)[k] for k in TRAIN_KERNELS}
    expected = {"flash_prefill_with_lse": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L}
    if remat_counts != expected or not torch.isfinite(loss) or \
            not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"8B remat=True: loss {loss.item()}, launches {remat_counts}, "
                             f"expected {expected}")
    log("train", f"8B remat=True, one loss and backward on the trained weights: loss "
                 f"{loss.item():.4f} (the last dots_flash step's {losses[-1]:.4f} was before its "
                 f"update), launches {remat_counts} (the forward re-run in the backward)")
    del params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = config_8b(sv, 2)
    fp32_check(sv, tfa, dev, cfg2, training_batch(cfg2, images, dev, lengths=SVG_8B_FP32),
               f"8B at 2 layers, B=1, T={cfg2.encoder_config.geometry[1] + max(SVG_8B_FP32)}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(recs=recs, counts=counts, T=T, B=B, peak=peak, base=base, cfg=cfg, batch=batch)


RECIPE_8B = "configs/models/starvector-8b/im2svg-stack-v5e8.yaml"
# lr 1e-3 without warmup: the yaml's 1e-5 after 10 warmup steps moves
# nothing in 5 steps (Adafactor's step is lr x a leaf's RMS); at 1e-2 and
# 3e-3 the loss rose again at the 4th step (the norms' scales, RMS 1, move
# by lr a step). The phase holds each step's loss below the one before.
RECIPE_LR, RECIPE_STEPS = 1e-3, 5


def train_recipe_8b(sv, tfa, dev, card: str, batch) -> dict:
    """Phase 6c: the 8B's own recipe (RECIPE_8B, read through the port's
    config loader and train.main's own functions: Adafactor, grad_dtype
    bfloat16, dots_flash, fp32 masters, bf16 compute) at full width and all
    32 decoder layers, RECIPE_STEPS steps of the port's train loop on phase
    6b's batch (B=1, T=8192). If dots_flash runs out of memory, the yaml's
    fallback (full remat), then the deepest depth that fits. Checks the
    loss falls at every step, every value is finite and each step launched each training
    kernel once a layer (the forward twice under full remat); logs step
    time, tokens/s and peak memory beside the state's bytes."""
    import dataclasses

    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.models.builder import config_from_yaml_block
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.train.optim import Adafactor, build_optimizer, tree_leaves
    from starvector_tpu_torch.train.train import (
        grad_dtype_from, optimizer_kwargs_from_config, remat_mode,
    )

    config = get_config([f"config={RECIPE_8B}"], default_path=resolve_repo_config())
    g = config.get_path
    kw = optimizer_kwargs_from_config(config)
    yaml_lr = (kw["lr"], kw["warmup_steps"])
    kw.update(lr=RECIPE_LR, warmup_steps=0)
    grad_dtype = grad_dtype_from(g("training.grad_dtype"))
    policy = DTypePolicy(torch.float32, torch.bfloat16 if g("training.bf16", True)
                         else torch.float32)
    full = config_from_yaml_block(dict(g("model")))
    if kw["optimizer"] != "adafactor" or grad_dtype != torch.bfloat16 or \
            full.llm.num_hidden_layers != 32:
        raise AssertionError(f"{RECIPE_8B}: {kw}, grad_dtype {grad_dtype}, {full.llm}")
    total_steps = int(g("training.steps", 10_000))

    def optimizer(p):
        return build_optimizer(p, total_steps=total_steps, **kw)

    tries = [(remat_mode(g("training.gradient_checkpointing", True)), 32), (True, 32),
             (True, 24), (True, 16)]
    notes = []
    for remat, layers in tries:
        cfg = dataclasses.replace(full, llm=dataclasses.replace(full.llm,
                                                               num_hidden_layers=layers))
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(tfa)
        try:
            params, recs = _run_training(sv, tfa, cfg, dev, batch, RECIPE_STEPS, policy,
                                         remat=remat, grad_dtype=grad_dtype, optimizer=optimizer)
        except torch.cuda.OutOfMemoryError as e:
            notes.append(f"remat={remat!r} at {layers} layers ran out of memory "
                         f"({str(e).splitlines()[0][:120]})")
            continue
        break
    else:
        raise AssertionError(f"8B recipe: nothing fits: {notes}")
    counts = read_counts(tfa)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.llm.num_hidden_layers
    losses, norms, per_step = check_train_run("8B recipe", recs, counts, L,
                                              forwards=2 if remat is True else 1,
                                              every_step=True)
    n = sum(p.numel() for p in tree_leaves(params))
    opt_state = sum(
        (p.numel() if Adafactor.factored_dims(p.shape) is None else
         p.numel() // p.shape[Adafactor.factored_dims(p.shape)[1]]
         + p.numel() // p.shape[Adafactor.factored_dims(p.shape)[0]]) * 4
        for p in tree_leaves(params))
    state = {"fp32 masters": 4 * n, "bf16 cast": 2 * n, "bf16 gradients": 2 * n,
             "Adafactor": opt_state}
    T = cfg.encoder_config.geometry[1] + batch["svg_ids"].shape[1]
    step = statistics.median(r["seconds"] for r in recs[1:])
    log("train", f"{card}: StarVector-8B, its own recipe ({RECIPE_8B}: Adafactor, grad_dtype "
                 f"bfloat16, gradient_checkpointing {remat!r}, fp32 masters, bf16 compute; lr "
                 f"{RECIPE_LR} without warmup in place of the yaml's {yaml_lr[0]} after "
                 f"{yaml_lr[1]} warmup steps) at full width and {L} of 32 decoder layers "
                 f"({n / 1e9:.3f} B parameters), B=1, T={T}"
                 + (f"; fell back: {'; '.join(notes)}" if notes else "")
                 + f": {RECIPE_STEPS} steps on one batch, loss {[round(x, 4) for x in losses]}, "
                 f"grad_norm {[round(x, 4) for x in norms]}; launches per step {per_step[0]} "
                 f"(each = {L} layers); step {step * 1e3:.1f} ms wall (median of steps 2-"
                 f"{RECIPE_STEPS}), {T / step:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
                 f"({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} held before); state "
                 + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in state.items())
                 + f" GiB, {sum(state.values()) / 2**30:.2f} GiB in all")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cfg=cfg, step=step, run=dict(remat=remat, grad_dtype=grad_dtype,
                                             optimizer=optimizer))


# flash_bwd_dkdv's head_split sweep: B, S, T, q_offset, Hkv, G, window. The
# 1B step, the 8k triangle and its SP chunk, the 16k SP chunk and triangle;
# the 8B's heads under its window from T = 769 to 16384
DKDV_SPLIT_SHAPES = (
    (4, 769, 769, 0, 1, 16, None), (1, 8450, 8450, 0, 1, 16, None),
    (1, 1024, 8450, 7426, 1, 16, None), (1, 1024, 16642, 15618, 1, 16, None),
    (1, 16642, 16642, 0, 1, 2, None),
    (2, 1160, 1160, 0, 4, 9, 4096), (1, 4700, 4700, 0, 4, 9, 4096),
    (1, 8192, 8192, 0, 4, 9, 4096), (2, 8192, 8192, 0, 4, 9, 4096),
    (1, 16384, 16384, 0, 4, 9, 4096), (4, 769, 769, 0, 4, 9, 4096),
    (1, 2048, 2048, 0, 4, 9, 4096),
)


def head_split_times(tfa, dev, card: str) -> None:
    """flash_bwd_dkdv, bf16, all keys valid, at every divisor of G as its
    head_split, beside the pick of dkdv_head_split (the default) for this
    card: each split graph-replayed (10 calls a graph) twice, the mean.
    tests/test_torch_flash_backward.py::DKDV_SWEEP holds these times."""
    g = torch.Generator(device=dev).manual_seed(23)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, S, T, q_off, Hkv, G, W in DKDV_SPLIT_SHAPES:
        H, D = Hkv * G, 128
        q, do = (torch.randn((B, S, H, D), generator=g, device=dev).bfloat16() for _ in "qo")
        k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).bfloat16() for _ in "kv")
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_off, window=W)
        delta = tfa.attention_delta(out, do)
        times = {}
        for hs in (d for d in range(1, G + 1) if G % d == 0):
            run = functools.partial(tfa.flash_bwd_dkdv, q, k, v, mask, do, lse, delta, q_off,
                                    window=W, head_split=hs)
            times[hs] = (cuda_ms(run, iters=10) + cuda_ms(run, iters=10)) / 2
        split = tfa.dkdv_head_split(B, T, Hkv, G, sms, S=S, q_offset=q_off, window=W)
        best = min(times, key=times.get)
        log("times", f"{card}: flash_bwd_dkdv by head_split at B={B} S={S} T={T} q_offset={q_off} "
                     f"Hkv={Hkv} G={G} window={W} bf16 ({sms} SMs): dkdv_head_split picks {split}, "
                     f"{times[split] / times[best] - 1:.1%} slower than the best, {best}: "
                     + ", ".join(f"{hs}: {ms:.4f} ms" for hs, ms in times.items()))
        del q, do, k, v, mask, out, lse, delta
        torch.cuda.empty_cache()


def _sdpa_window(T: int, window: int, dev) -> torch.Tensor:
    """(T, T) bool: query q sees key t for q - window < t <= q (the kernels'
    causal mask with the sliding window), for SDPA's attn_mask."""
    pos = torch.arange(T, device=dev)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


# the training kernels at the 8B's heads: B, T, and the line of the TPU
# backward kernel that shape runs: the phase-6b step (the one-pass kernel,
# 2048 < T <= 8704) and a short batch (the fused one, T <= 2048)
TRAIN_TIMES_8B = ((1, 8192, 1092), (2, 1160, 968))


def training_times_8b(tfa, dev, card: str, t8: dict, errs: dict) -> list[dict]:
    """The 8B train step's wall time and tokens/s from phase 6b (median of
    the 5 steps after 3 of warm-up), and the training kernels at the 8B's
    heads (H = 36 over Hkv = 4, window 4096), bf16, S = T, at the step's
    B = 1, T = 8192 and at B = 2, T = 1160: each beside its plain version,
    its bound and SDPA with enable_gqa and the window as an explicit mask
    (forward; backward against dkdv + dq). The kernels are graph-replayed
    (10 calls a graph); the plain versions, whose (H, S, T) fp32 blocks are
    9.7 GB at 8192, and SDPA's backward run eager between CUDA events (3
    after 3 of warm-up), in turns plain, kernel, kernel, plain. Returns
    the kernels' JSON rows at the step's shape."""
    secs = [r["seconds"] for r in t8["recs"][3:]]
    step = statistics.median(secs)
    log("times", f"{card}: 8B train step B={t8['B']} T={t8['T']} ({TRAIN_8B_LAYERS} of 32 layers, "
                 f"bf16 compute, dots_flash): {step * 1e3:.1f} ms median of {len(secs)} steps after "
                 f"3 of warm-up ({[round(x * 1e3, 1) for x in secs]} ms), "
                 f"{t8['B'] * t8['T'] / step:.0f} tokens/s, peak memory {t8['peak'] / 2**30:.2f} GiB "
                 f"({(t8['peak'] - t8['base']) / 2**30:.2f} GiB above what was held before it)")
    g = torch.Generator(device=dev).manual_seed(22)
    H, Hkv, D, W = H8, HKV8, 128, WINDOW8
    graphed, timer = functools.partial(cuda_ms, iters=10), functools.partial(event_ms, iters=3)
    rows = []
    for B, T, bwd_row in TRAIN_TIMES_8B:
        q = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, window=W)
        delta = tfa.attention_delta(out, do)
        shape = f"B={B} S=T={T} H={H} Hkv={Hkv} D={D} window={W} bf16"
        pos = torch.arange(T, device=dev)
        pairs = B * H * int(torch.minimum(pos + 1, torch.full_like(pos, W)).sum())  # visible
        qh, doh = (t.transpose(1, 2).contiguous() for t in (q, do))
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        win = dict(attn_mask=_sdpa_window(T, W, dev))
        lib_fwd = sdpa_ms(qh, kh, vh, causal=False, enable_gqa=True, **win)
        lib_bwd = sdpa_backward_ms(qh, kh, vh, doh, iters=3, mask=win, enable_gqa=True)
        del qh, kh, vh, doh, win
        torch.cuda.empty_cache()
        act, kv, stats, m = B * T * H * D * 2, B * T * Hkv * D * 2, B * H * T * 4, B * T * 4
        for name, fn, replaces, nbytes, flops, lib in (
                ("flash_prefill_with_lse", lambda kn: tfa.flash_prefill_with_lse(
                    q, k, v, mask, window=W, kernels=kn), 307,
                 2 * act + 2 * kv + stats + m, 4 * D * pairs, lib_fwd),
                ("flash_bwd_dkdv", lambda kn: tfa.flash_bwd_dkdv(
                    q, k, v, mask, do, lse, delta, window=W, kernels=kn), bwd_row,
                 2 * act + 4 * kv + 2 * stats + m, 8 * D * pairs, lib_bwd),
                ("flash_bwd_dq", lambda kn: tfa.flash_bwd_dq(
                    q, k, v, mask, do, lse, delta, window=W, kernels=kn), bwd_row,
                 3 * act + 2 * kv + 2 * stats + m, 6 * D * pairs, lib_bwd)):
            a = timer(lambda: fn(False))
            b, c = graphed(lambda: fn(True)), graphed(lambda: fn(True))
            plain_ms, ms = (a + timer(lambda: fn(False))) / 2, (b + c) / 2
            torch.cuda.empty_cache()
            b_ms, b_by = bound(nbytes, flops)
            log("times", f"{card}: {name} 8B train {shape}: kernel {ms:.4f} ms "
                         f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound), plain "
                         f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP over {pairs // (B * H)} visible pairs a head), "
                         f"SDPA {'n/a (no single PyTorch call)' if lib is None else f'{lib:.4f} ms'}")
            if (B, T) != (t8["B"], t8["T"]):
                continue
            src = "flash_prefill.cu" if name == "flash_prefill_with_lse" else "flash_backward.cu"
            rows.append(dict(name=f"{name}_8b", route="cuda",
                             source=f"starvector_tpu_torch/csrc/{src}",
                             replaces=f"starvector_tpu/ops/flash_attention.py:{replaces}",
                             launches=t8["counts"][name], max_abs_err=errs[f"{name}_8b"], ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def times_8b(tfa, dc, tq, dev, card: str, s8: dict, errs: dict) -> list[dict]:
    """The 8B's kernels at its shapes, bf16, graph-replayed: flash_prefill
    at B=4 S=T=580 (576 visual + 4 prompt tokens), H=36 over Hkv=4, window
    4096, and decode_attention at G=9, B=4 T=708 with the self token, each
    beside its plain version, its bound and SDPA with enable_gqa over the 4
    KV heads; decode_attention over an int8 cache at the same shape (no
    library call attends over int8 codes); kernel 14 at the six projections'
    four shapes (quant_matmul_times_8b). Returns their rows of the kernels'
    JSON, with launches from phase 6 (`s8`: bf16, and int8 under "int8")."""
    launches, launches8 = s8["counts"], s8["int8"]["counts"]
    g = torch.Generator(device=dev).manual_seed(18)
    D, rows = 128, []
    B, S = 4, 580
    q = torch.randn((B, S, H8, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, HKV8, D), generator=g, device=dev).bfloat16() for _ in "kv")
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    plain_ms, ms = _turns(lambda: tfa.flash_prefill(q, k, v, mask, window=WINDOW8, kernels=False),
                          lambda: tfa.flash_prefill(q, k, v, mask, window=WINDOW8))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = sdpa_ms(qh, kh, vh, causal=True, enable_gqa=True)
    nbytes = 2 * B * S * H8 * D * 2 + 2 * B * S * HKV8 * D * 2 + B * S * 4
    flops = 4 * D * H8 * B * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops)
    log("times", f"{card}: flash_prefill 8B B=4 S=T=580 H=36 Hkv=4 window=4096 D=128 bf16: kernel "
                 f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound), "
                 f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                 f"{flops / 1e9:.2f} GFLOP), SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}")
    rows.append(dict(name="flash_prefill_8b", route="cuda",
                     source="starvector_tpu_torch/csrc/flash_prefill.cu",
                     replaces="starvector_tpu/ops/flash_attention.py:212",
                     launches=launches["flash_prefill"], max_abs_err=errs["flash_prefill_8b"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    del q, k, v, qh, kh, vh
    B, T, G = 4, 708, H8 // HKV8
    qg = torch.randn((B, HKV8, G, D), generator=g, device=dev).bfloat16()
    kn, vn = (torch.randn((B, HKV8, D), generator=g, device=dev).bfloat16() for _ in "kv")
    kc, vc = (torch.randn((B, T, HKV8, D), generator=g, device=dev).bfloat16() for _ in "kv")
    old = torch.ones((B, T), dtype=torch.int32, device=dev)
    plain_ms, ms = _turns(
        lambda: tfa.merged_decode_attention(qg, kn, vn, kc, vc, old, D**-0.5, kernels=False),
        lambda: tfa.merged_decode_attention(qg, kn, vn, kc, vc, old, D**-0.5))
    keys = [torch.cat([c, n[:, None]], 1).transpose(1, 2).contiguous() for c, n in ((kc, kn),
                                                                                   (vc, vn))]
    lib = sdpa_ms(qg.reshape(B, H8, 1, D), *keys, causal=False, enable_gqa=True)
    cache_bytes = 2 * B * T * HKV8 * D * 2
    small = 2 * B * H8 * D * 2 + 2 * B * HKV8 * D * 2 + B * T * 4
    flops = 4 * D * H8 * B * (T + 1)
    b_ms, b_by = bound(cache_bytes + small, flops)
    log("times", f"{card}: decode_attention G=9 B=4 T=708 Hkv=4 D=128 bf16 cache and queries, "
                 f"the self token merged: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{b_ms:.5f} ms ({b_by}: {cache_bytes / 1e6:.3f} MB of cache), SDPA "
                 f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    rows.append(dict(name="decode_attention_g9", route="cuda",
                     source="starvector_tpu_torch/csrc/decode_attention.cu",
                     replaces="starvector_tpu/ops/flash_attention.py:2104",
                     launches=launches["decode_attention"], max_abs_err=errs["decode_g9"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    (kq, ks), (vq, vs) = dc.quantize_kv(kc.float()), dc.quantize_kv(vc.float())
    plain_ms, ms = _turns(
        lambda: tfa.merged_decode_attention(qg, kn, vn, kq, vq, old, D**-0.5, ks, vs,
                                            kernels=False),
        lambda: tfa.merged_decode_attention(qg, kn, vn, kq, vq, old, D**-0.5, ks, vs))
    cache_bytes = 2 * B * T * HKV8 * D + 2 * B * T * HKV8 * 4  # codes and fp32 scales
    b_ms, b_by = bound(cache_bytes + small, flops)
    log("times", f"{card}: decode_attention G=9 B=4 T=708 Hkv=4 D=128 int8 cache, bf16 queries, "
                 f"the self token merged: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{b_ms:.5f} ms ({b_by}: {cache_bytes / 1e6:.3f} MB of codes and scales; no "
                 f"single PyTorch call attends over an int8 cache)")
    rows.append(dict(name="decode_attention_int8_g9", route="cuda",
                     source="starvector_tpu_torch/csrc/decode_attention.cu",
                     replaces="starvector_tpu/ops/flash_attention.py:2104",
                     launches=launches8["decode_attention_int8"],
                     max_abs_err=errs["decode_g9_int8"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    del qg, kn, vn, kc, vc, kq, vq, ks, vs
    qmm = quant_matmul_times_8b(tq, dev, card)
    for path, count in (("gemv", "quant_matmul_gemv"), ("tile", "quant_matmul_wgmma")):
        rows.append(dict(name=f"quant_matmul_{path}_8b", route="cuda",
                         source="starvector_tpu_torch/csrc/quant_matmul.cu",
                         replaces="starvector_tpu/ops/quantization.py:139",
                         launches=launches8[count], max_abs_err=errs[f"qmm_{path}_8b"],
                         **qmm[path]))
    return rows


def quant_matmul_times_8b(tq, dev, card: str) -> dict:
    """Kernel 14 at the 8B's shapes against its plain version, the bf16
    cuBLAS addmm and torch._weight_int8pack_mm (where this torch has it for
    CUDA; timed over 2 calls between events at prefill sizes, where it takes
    tenths of a second), with a bf16 bias, at M = 1, 4 (the GEMV) and 580,
    2320 (the tile; with TFLOP/s, share of the bound, and every plan
    tile_plan weighs). Returns mlp.c_fc's figures, the largest, by path
    ("gemv" at M = 4, "tile" at M = 2320): ms, plain_ms, bound_ms, bound_by,
    library_ms (int8pack_mm, else addmm)."""
    g = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for name, K, N in QMM_SHAPES_8B:
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        kq, sc = p["kernel_q"], p["scale"]
        w16 = (kq.float() * sc).bfloat16()
        kq_nk, sc16 = kq.t().contiguous(), sc.bfloat16()
        b = torch.randn((N,), generator=g, device=dev).bfloat16()
        for M in QMM_ROWS_8B:
            path = "gemv" if M <= tq.GEMV_MAX_ROWS else "tile"
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            plain_ms, ms = _turns(
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16, kernels=False),
                lambda: tq.quant_matmul(x, kq, sc, b, out_dtype=torch.bfloat16))
            addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w16))
            timer = None if path == "gemv" else functools.partial(event_ms, iters=2, warmup=1)
            lib = library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                             "torch._weight_int8pack_mm", timer)
            flops = 2 * M * K * N
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, flops)
            extra = "" if path == "gemv" else f" ({flops / ms / 1e9:.1f} TFLOP/s)"
            log("times", f"{card}: quant_matmul 8B {path} {name} M={M} K={K} N={N} bf16: kernel "
                         f"{ms:.4f} ms{extra}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                         f"({b_by}, {b_ms / ms:.1%} of it), int8pack_mm "
                         f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bf16 addmm "
                         f"{addmm_ms:.4f} ms (reads 2 bytes a weight)")
            if path == "tile":
                tile_plan_times(tq, x, kq, sc, b, f"8B {name}", card)
            if name == "mlp.c_fc" and M in (4, 2320):
                rows[path] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib if lib is not None else addmm_ms)
            del x
        del p, kq, sc, w16, kq_nk
        torch.cuda.empty_cache()
    return rows


def times_only(card: str, dev) -> int:
    """--times-only ROOT: phase 6's decode-step and prefill-tile figures
    (decode_times, quant_matmul_times) and phase 4's serving times (serving_times) for the
    package under ROOT, on the same seeded weights; one JSON line last. Run
    it for two trees in turns (a, b, b, a) on one card to compare them."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import decode_common as dc
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    log("times", f"{card}: the package at {Path(tfa.__file__).resolve().parents[2]}")
    decode = decode_times(tfa, dc, dev, card)
    qmm = quant_matmul_times(tq, dev, card)
    cfg = sv.starvector_1b_config()
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    p16 = _cast_tree(full_width_params(sv, cfg, dev, torch.float32), torch.bfloat16)
    model = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev)
    requests = {"bf16": api_requester(model),
                "int8": int8_requester(model, cfg, quantized(p16), bf16, dev)}
    for request in requests.values():
        request(synthetic_images(4, 99))  # warm-up
    serving = serving_times(card, requests)
    print(json.dumps({"times": {"decode_attention": decode, "quant_matmul": qmm,
                                "serving": serving}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="also trace a B=4 request and a train step with torch.profiler "
                             "and write the kernel tables to DIR")
    parser.add_argument("--times-only", metavar="ROOT", type=Path,
                        help="only time the decode step's kernels, the int8 prefill tile and the "
                             "bf16 and int8 serving, for the package in the tree at ROOT (to "
                             "compare trees)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on an H100", file=sys.stderr)
        return 2
    if args.times_only is not None:
        sys.path.insert(0, str(args.times_only.resolve()))
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.data.processor import processor_for_encoder
    from starvector_tpu_torch.models import decode_common as dc
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import kernel_lib
    from starvector_tpu_torch.ops import quantization as tq
    from starvector_tpu_torch.ops.layers import DTypePolicy

    dev = torch.device("cuda")
    t_run = time.perf_counter()

    def phase(n: int | str, what: str) -> None:
        log("phase", f"{n}. {what}, {time.perf_counter() - t_run:.0f} s into the run")

    # --- 1. card -------------------------------------------------------------
    card = card_line()
    nvcc = subprocess.run([kernel_lib.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{card} | torch {torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc} | "
                f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if args.times_only is not None:
        kernel_lib.library()
        return times_only(card, dev)

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernel_lib.library()
    built = kernel_lib.build_seconds()
    summary = ptxas_summary(kernel_lib.build_log())
    sources = sorted(p.name for p in kernel_lib.CSRC_DIR.glob("*.cu"))
    log("build", f"{kernel_lib.library_path().name} from {len(sources)} CUDA sources "
                 f"({', '.join(sources)}): "
                 f"{'built in %.1f s' % built if built is not None else 'reused'} "
                 f"(load {time.perf_counter() - t0:.1f} s); ptxas per kernel: "
                 + "; ".join(summary))
    sass = sass_counts(kernel_lib.library_path(), kernel_lib.find_nvcc())
    hgmma = {k: v["HGMMA"] for k, v in sass.items()}
    hmma = {k: v["HMMA"] for k, v in sass.items()}
    if not all(hgmma.get(k) for k in TENSOR_CORE_KERNELS) or \
            any(hgmma.get(k) for k in CUDA_CORE_KERNELS):
        raise AssertionError(f"HGMMA instructions per kernel: {hgmma}")
    if not all(hmma.get(k) for k in HMMA_KERNELS) or any(hmma.get(k) for k in NO_HMMA_KERNELS) \
            or not all(k in hmma for k in NO_HMMA_KERNELS):
        raise AssertionError(f"HMMA instructions per decode kernel: {hmma}")
    qmm_tiles = sorted(k for k in hgmma if k.startswith("qmm_wgmma_kernel"))
    if len(qmm_tiles) != 4 or not all(hgmma[k] for k in qmm_tiles):
        raise AssertionError(f"HGMMA instructions in the int8 wgmma tile: {hgmma}")
    faults = [line for line in summary if line.startswith("qmm_wgmma_kernel")
              and ("serialized" in line or not line.endswith(" 0 bytes spilled"))]
    if faults:
        raise AssertionError(f"the int8 wgmma tile spills or its products are serialized: {faults}")
    log("build", "HGMMA (wgmma) instructions in the machine code (cuobjdump -sass): "
                 + ", ".join(f"{k} {hgmma.get(k, 0)}"
                             for k in TENSOR_CORE_KERNELS + CUDA_CORE_KERNELS + tuple(qmm_tiles))
                 + "; HMMA (mma.sync): " + ", ".join(f"{k} {hmma.get(k, 0)}"
                                                     for k in HMMA_KERNELS + NO_HMMA_KERNELS))

    # --- 3. kernels against their plain versions --------------------------------
    phase(3, "kernels against their plain versions")
    err_prefill = check_flash_prefill(tfa, dev)
    err_decode = check_decode_attention(tfa, dev)
    log("kernels", f"both kernels match their plain versions (atol=rtol 1e-4 in fp32; bf16 "
                   f"prefill atol=rtol 2e-2, decode atol 2e-3 and rtol 2^-7); max |diff| prefill "
                   f"{err_prefill:.3e}, decode {err_decode:.3e}")
    err_qmm = check_quant_matmul(tq, dev)
    err_int8 = check_int8_decode(tfa, dc, dev)
    log("kernels", f"the int8 kernels match their plain versions (atol=rtol 1e-4 in fp32; bf16 "
                   f"quant_matmul and int8-cache decode atol 2e-3 and rtol 2^-7; the GEMV at "
                   f"M=4 and the wgmma tile at M=260 and 1040 bit-identical on relaunch); max |diff| "
                   f"quant_matmul GEMV {err_qmm['gemv']:.3e}, tile {err_qmm['tile']:.3e}, "
                   f"int8-cache decode {err_int8:.3e}")
    err_8b = {"decode_g9": check_g9_decode(tfa, dev),
              "flash_prefill_8b": check_flash_prefill_8b(tfa, dev),
              "decode_g9_int8": check_g9_int8_decode(tfa, dc, dev)}
    qmm_8b = check_quant_matmul_8b(tq, dev)
    err_8b.update(qmm_gemv_8b=qmm_8b["gemv"], qmm_tile_8b=qmm_8b["tile"])
    log("kernels", f"the 8B's kernel shapes match their plain versions (decode G=9 over a bf16 "
                   f"or an int8 cache: fp32 1e-4, bf16 atol 2e-3 and rtol 2^-7; flash_prefill "
                   f"H=36 Hkv=4 window 4096: fp32 1e-4, bf16 2e-2; quant_matmul at the six "
                   f"projections' four shapes, M = 1, 4, 580, 2320: fp32 1e-4, bf16 atol 2e-3 and "
                   f"rtol 2^-7; bf16 bit-identical on relaunch); max |diff| decode G=9 "
                   f"{err_8b['decode_g9']:.3e}, int8-cache decode G=9 "
                   f"{err_8b['decode_g9_int8']:.3e}, flash_prefill H=36 "
                   f"{err_8b['flash_prefill_8b']:.3e}, quant_matmul 8B GEMV "
                   f"{qmm_8b['gemv']:.3e}, tile {qmm_8b['tile']:.3e}")
    err_train = check_training_kernels(tfa, dev)
    log("kernels", "the training kernels match their plain versions (fp32 atol=rtol 1e-4; bf16 "
                   "2e-2, or no more than twice the plain bf16 version's own error from fp32 "
                   "plus 1e-3); bf16 max |diff| at the 1B step's shape (B=4 T=769) and, _8b, "
                   "at the 8B step's (B=1 T=8192 H=36 Hkv=4 window 4096): "
                   + ", ".join(f"{k} {v:.3e}" for k, v in err_train.items()))
    log("rounding", check_bf16_rounding(dev))

    # --- 4. the slice at full width --------------------------------------------
    phase(4, "StarVector-1B inference")
    cfg = sv.starvector_1b_config()
    L = cfg.llm.n_layer
    p32 = full_width_params(sv, cfg, dev, torch.float32)
    p16 = _cast_tree(p32, torch.bfloat16)
    f32 = DTypePolicy(torch.float32, torch.float32)
    bf16 = DTypePolicy(torch.bfloat16, torch.bfloat16)
    model = StarVectorForCausalLM(p16, cfg, policy=bf16, device=dev)
    greedy = GREEDY
    request = api_requester(model)
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
    # layers; the prefill kernel rounds the unnormalised P where the JAX
    # kernel does, the plain version the normalised P.
    if not torch.isfinite(logits[True]).all() or err_k > 2.0 * err_p + 1e-3:
        raise AssertionError(f"bf16 prefill logits: kernels {err_k:.3e} from fp32, over twice "
                             f"the plain version's {err_p:.3e}")
    agree = (toks[True] == toks[False]).float().mean().item()
    log("slice", f"bf16, B=4: prefill last-position logits, max |diff| kernels vs plain {diff:.4e}; "
                 f"from the fp32 plain logits (max |logit| {ref32.abs().max().item():.3e}): kernels "
                 f"{err_k:.4e}, plain {err_p:.4e} (bound: kernels <= 2 x plain + 1e-3); greedy "
                 f"tokens agree on {agree:.4f} of 4x128 positions")

    # text2svg: captions through the v1 test tokenizer, the same bf16 weights
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

    t2s = text2svg_slice(tfa, "1B", StarVectorForCausalLM(p16, cfg, build_test_tokenizer("v1"),
                                                          policy=bf16, device=dev),
                         p32, cfg, dev, "full depth")

    # int8 weights and an int8 KV cache
    int8 = int8_slice(model, tfa, cfg, p16, p32, dev)

    # serving times and memory, bf16, int8 and text2svg in turns; then the
    # int8 tree goes, so that phase 5's peak holds only what training needs
    e2e = serving_times(card, {"bf16": request, "int8": int8["request"],
                               "text2svg": t2s["request"]})
    log("times", f"{card}: int8 (weights and KV cache) against bf16: p50 B=1 "
                 f"{e2e['int8']['p50'] * 1e3:.1f} vs {e2e['bf16']['p50'] * 1e3:.1f} ms, B=4 decode "
                 f"{e2e['int8']['rate']:.1f} vs {e2e['bf16']['rate']:.1f} tokens/s")
    log("times", f"{card}: 1B text2svg (prompts of 6-30 tokens, no vision tower) against "
                 f"im2svg, bf16: p50 B=1 {e2e['text2svg']['p50'] * 1e3:.1f} vs "
                 f"{e2e['bf16']['p50'] * 1e3:.1f} ms, B=4 decode {e2e['text2svg']['rate']:.1f} vs "
                 f"{e2e['bf16']['rate']:.1f} tokens/s")
    memory_times(card, {"bf16": request, "int8": int8["request"]},
                 {"bf16": p16, "int8": int8["params"]})

    # --- 4b. the decoding variants and GRPO -------------------------------------
    # 4b's decoding variants, 4c and 4d on the first DEPTH_1B_EARLIER layers
    # of phase 4's trees (GRPO builds its own, at full depth)
    phase("4b", f"StarVector-1B decoding variants ({DEPTH_1B_EARLIER} of {L} layers) and GRPO")
    t_4b = time.perf_counter()
    s16, cfg_cut = first_layers(p16, cfg, DEPTH_1B_EARLIER)
    s32, sq16 = (first_layers(t, cfg, DEPTH_1B_EARLIER)[0] for t in (p32, int8["params"]))
    decoding_1b(tfa, StarVectorForCausalLM(s16, cfg_cut, policy=bf16, device=dev), cfg_cut, s16,
                s32, sq16, dev, card)
    phase("4c", f"StarVector-1B continuous-batching serving, {DEPTH_1B_EARLIER} of {L} layers")
    t_4c = time.perf_counter()
    serve_1b = serving_1b(tfa, cfg_cut, s16, s32, sq16, dev, card, args.profile)
    t_4c = time.perf_counter() - t_4c
    log("phase", f"4c took {t_4c:.0f} s")
    phase("4d", f"StarVector-1B eval harness, {DEPTH_1B_EARLIER} of {L} layers")
    t_4d = time.perf_counter()
    eval1b = eval_1b(tfa, cfg_cut, s16, s32, dev, card)
    t_4d = time.perf_counter() - t_4d
    log("phase", f"4d took {t_4d:.0f} s")
    del s16, s32, sq16
    phase("4e", "StarVector-1B offline pipelined generation")
    t_4e = time.perf_counter()
    pipe_1b = pipelined_1b(tfa, cfg, p16, p32, int8["params"], dev, card, args.profile)
    t_4e = time.perf_counter() - t_4e
    log("phase", f"4e took {t_4e:.0f} s")
    phase("4f", "the other vision towers behind the StarVector-1B decoder")
    t_4f = time.perf_counter()
    towers = towers_1b(sv, tfa, dc, cfg, p16, p32, dev, card)
    t_4f = time.perf_counter() - t_4f
    log("phase", f"4f took {t_4f:.0f} s")
    if args.profile is not None:
        profile_request(request, card, args.profile)
        profile_request(int8["request"], card, args.profile, "int8")
    int8_counts = int8["counts"]
    del int8, t2s
    # the 1B inference trees go, so that phases 5 and 6 hold only their own
    clip_images = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=dev).batch
    del model, m32, p16, p32, request, logits, ref32
    gc.collect()
    torch.cuda.empty_cache()
    grpo_phase(sv, tfa, cfg, dev, card)
    log("phase", f"4b took {time.perf_counter() - t_4b - t_4c - t_4d - t_4e - t_4f:.0f} s (4c, "
                 f"4d, 4e and 4f apart)")
    gc.collect()
    torch.cuda.empty_cache()

    # --- 5. training at full width ----------------------------------------------
    phase(5, "StarVector-1B training")
    train = train_slice(sv, tfa, dev, clip_images)

    # --- 5b. the trained 1B out as an HF checkpoint and back in ------------------
    phase("5b", "the export round trip")
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    try:
        export_round_trip(sv, tfa, dev, train, clip_images(synthetic_images(2, 7)),
                          str(work / "ckpt"))
        cfg1 = sv.starvector_1b_config()
        fp32_check(sv, tfa, dev, cfg1, training_batch(cfg1, clip_images, dev), "1B")
        gc.collect()
        torch.cuda.empty_cache()

        # --- 5c. the quickstarts and the web UI on 5b's checkpoint ---------------
        phase("5c", "the quickstarts and the web UI on the exported 1B")
        t_5c = time.perf_counter()
        entry = entry_points_1b(tfa, dev, card, str(work / "ckpt"), work)
        log("phase", f"5c took {time.perf_counter() - t_5c:.0f} s")

        # --- 5d. the GRPO driver ---------------------------------------------------
        phase("5d", "the GRPO driver at full 1B width and depth")
        t_5d = time.perf_counter()
        grpo_run = grpo_driver_1b(tfa, dev, card, work)
        log("phase", f"5d took {time.perf_counter() - t_5d:.0f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # --- 6. StarVector-8B inference at full width ---------------------------------
    phase(6, f"StarVector-8B inference, {DEPTH_8B} of 32 layers")
    s8 = slice_8b(sv, tfa, dev, card, args.profile)

    # --- 6b. StarVector-8B training at full width, 8 layers -------------------------
    phase("6b", "StarVector-8B training")
    t8 = train_slice_8b(sv, tfa, dev)

    # --- 6c. the 8B's own recipe at full depth -----------------------------------
    phase("6c", "StarVector-8B training, its own recipe at full depth")
    recipe = train_recipe_8b(sv, tfa, dev, card, t8["batch"])

    # --- 7. kernel times on the card -----------------------------------------
    phase(7, "times")
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
    nbytes = 2 * B * P * H * D * 2 + 2 * B * P * D * 2 + B * P * 4
    flops = 4 * D * H * B * P * (P + 1) // 2
    b_ms, b_by = bound(nbytes, flops)
    log("times", f"{card}: flash_prefill B=4 S=261 T=389 H=16 Hkv=1 D=128 bf16: kernel "
                 f"{times[1]:.4f} ms ({flops / times[1] / 1e9:.1f} TFLOP/s, "
                 f"{b_ms / times[1]:.1%} of the bound), plain {times[0]:.4f} ms, bound "
                 f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                 f"SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}")
    s1026 = tower_prefix_times(tfa, dev, card)
    kernels_json.append(dict(name="flash_prefill", route="cuda",
                             source="starvector_tpu_torch/csrc/flash_prefill.cu",
                             replaces="starvector_tpu/ops/flash_attention.py:212",
                             launches=n_prefill, max_abs_err=err_prefill,
                             ms=times[1], plain_ms=times[0], bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib,
                             serve_launches=serve_1b["launches"]["flash_prefill"],
                             eval_launches=eval1b["launches"]["flash_prefill"],
                             pipelined_launches=pipe_1b["launches"]["bf16"]["flash_prefill"],
                             pipelined_spec_launches=pipe_1b["launches"]["spec"]["flash_prefill"],
                             s1026=s1026))
    decode = decode_times(tfa, dc, dev, card)
    for label, name, launches, err in (
            ("bf16", "decode_attention", n_decode, err_decode),
            ("int8", "decode_attention_int8", int8_counts["decode_attention_int8"], err_int8)):
        kernels_json.append(dict(name=name, route="cuda",
                                 source="starvector_tpu_torch/csrc/decode_attention.cu",
                                 replaces="starvector_tpu/ops/flash_attention.py:2049",
                                 launches=launches, max_abs_err=err, **decode[label],
                                 serve_launches=serve_1b["launches"][name],
                                 pipelined_launches=pipe_1b["launches"][
                                     "bf16" if label == "bf16" else "int8 KV"][name],
                                 **({"eval_launches": eval1b["launches"][name]}
                                    if name in eval1b["launches"] else {})))
    qmm = quant_matmul_times(tq, dev, card)
    for path, count in (("gemv", "quant_matmul_gemv"), ("tile", "quant_matmul_wgmma")):
        kernels_json.append(dict(name=f"quant_matmul_{path}", route="cuda",
                                 source="starvector_tpu_torch/csrc/quant_matmul.cu",
                                 replaces="starvector_tpu/ops/quantization.py:139",
                                 launches=int8_counts[count], max_abs_err=err_qmm[path],
                                 **qmm[path],
                                 serve_launches=serve_1b["launches"][f"quant_matmul_{path}"],
                                 pipelined_launches=pipe_1b["launches"][
                                     "int8 weights + int8 KV"][count],
                                 **({"m144": qmm["tile_m144"]} if path == "tile" else {})))

    # the launches of phases 4f, 5c and 5d beside each kernel they ran
    for row in kernels_json:
        if row["name"] in ("flash_prefill", "decode_attention"):
            row["tower_launches"] = {t: r["launches"][row["name"]] for t, r in towers.items()}
            row["entry_launches"] = {k: v[row["name"]] for k, v in entry.items()}
    kernels_json += training_times(tfa, dev, card, train, err_train)
    for row in kernels_json:
        if row["name"] in grpo_run["launches"]:
            row["grpo_driver_launches"] = grpo_run["launches"][row["name"]]
    kernels_json += times_8b(tfa, dc, tq, dev, card, s8, err_8b)
    kernels_json += training_times_8b(tfa, dev, card, t8, err_train)
    long_context_times(tfa, dev, card)
    head_split_times(tfa, dev, card)

    if args.profile is not None:
        for label, run, cfg_t in (("1B", train, cfg1), ("8B", t8, t8["cfg"])):
            batch = t8["batch"] if label == "8B" else training_batch(cfg1, clip_images, dev)
            step_wall = statistics.median(r["seconds"] for r in run["recs"][3:])
            profile_train_step(sv, tfa, dev, cfg_t, batch, card, step_wall, args.profile, label)
        profile_train_step(sv, tfa, dev, recipe["cfg"], t8["batch"], card, recipe["step"],
                           args.profile, "8B recipe", **recipe["run"])

    log("phase", f"done, {time.perf_counter() - t_run:.0f} s into the run")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "starvector_tpu"))
    if leaked:
        raise AssertionError(f"the port pulled in the JAX package: {leaked}")
    print(card)
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):  # the convolutional towers' levels and blocks
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _cast_tree(tree, dtype):
    """The tree in `dtype`, but for BatchNorm statistics, int8 codes and
    the fp32 scales of a quantized leaf."""
    if isinstance(tree, dict):
        keep = ("running_mean", "running_var") + (("scale",) if "kernel_q" in tree else ())
        return {k: (v if k in keep else _cast_tree(v, dtype)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
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
