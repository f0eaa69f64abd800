"""starvector_tpu_torch: the PyTorch/CUDA port of starvector_tpu for NVIDIA
Hopper (H100).

The module paths mirror the JAX package's. The port imports torch and never
jax; of the JAX package it reuses only the jax-free models/tokenizer.py, and
only when a tokenizer is loaded (api.from_pretrained).

Layer map:
  api.py        -- StarVectorForCausalLM: process_images, generate_im2svg
  generation/   -- the cached generation loop (engine.py)
  models/       -- StarVector task model, CLIP ViT, adapter, GPTBigCode
                   decoder, KV cache, weight conversion
  ops/          -- layers, plain attention, sampling, and the wrappers of the
                   hand-written CUDA kernels (flash_attention.py)
  csrc/         -- the CUDA C++ kernels for sm_90a, built at first use by
                   ops/kernel_lib.py into _build/
"""
