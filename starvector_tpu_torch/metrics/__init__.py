"""Metrics the port needs so far: SSIM (GRPO's pixel reward) and its
per-sample loop, numpy copies of the JAX package's jax-free modules. The
eval harness's others come with ROADMAP queue 1, item 8."""
