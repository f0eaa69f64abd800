"""starvector_tpu_torch: the PyTorch/CUDA port of starvector_tpu for NVIDIA
Hopper (H100).

The module paths mirror the JAX package's. The port imports torch and never
jax, and nothing of the JAX package: where it needs one of that package's
jax-free modules (config, tokenizer, datasets, loader, rasterizer) it keeps
its own copy. Its entry points run on the card unless asked for the CPU.

Layer map:
  api.py        -- StarVectorForCausalLM: process_images, generate_im2svg,
                   generate_text2svg (beams, speculative decoding,
                   num_return_sequences), generate_im2svg_grpo, forward
                   (the loss); StarVectorPipeline
  quickstart.py, quickstart_serve.py -- the quickstarts' mains
  serve/        -- continuous-batching serving: the engine (engine.py),
                   the REST worker, controller and web UI on the standard
                   library (worker.py, controller.py, webui.py, httpd.py)
  generation/   -- the cached generation loop (engine.py), beam search
                   (beam.py), prompt-lookup speculative decoding
                   (speculative.py)
  models/       -- StarVector task model, the seven vision towers (CLIP
                   ViT, SigLIP at 384/512/256, open-clip ViT, VQGAN,
                   ConvNeXt), adapter, GPTBigCode and StarCoder2 decoders,
                   KV cache, weights in (convert.py) and out (export.py),
                   the builder (builder.py)
  ops/          -- layers, plain attention, sampling, int8 weights
                   (quantization.py), and the wrappers of the hand-written
                   CUDA kernels (flash_attention.py, quantization.py)
  csrc/         -- the CUDA C++ kernels for sm_90a, built at first use by
                   ops/kernel_lib.py into _build/
  data/, train/, config.py -- datasets, rasterizer (native/), loader, the
                   training entry point, optimizers, HF export (train/hub.py),
                   GRPO and its driver (train/grpo.py)
  parallel/     -- data-parallel and ZeRO-3 training under torchrun: the
                   mesh, the partition rules' machinery, the collectives
                   of a sharded step (zero.py)
  validation/   -- the eval harness: the validator base and registry, the
                   in-process (torch_validator.py) and REST
                   (serve_validator.py) validators, the CLI (validate.py),
                   the real-checkpoint harness (parity_real.py)
  metrics/      -- L2, SSIM, LPIPS-VGG, InceptionV3 (FID), DINO/CLIP
                   scores and the SVGMetrics orchestrator (also GRPO's
                   reward)
  utils/        -- run identity, code snapshot, metrics sink, plots
"""

import torch


def require_device(device, cpu_option: str) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no card is
    visible, naming the option (`cpu_option`) that asks for the CPU. The
    port never moves to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is visible: pass {cpu_option} to run on the CPU")
    return device
