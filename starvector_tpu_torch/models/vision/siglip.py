"""SigLIP vision tower, the StarVector-8B's image encoder (port of
starvector_tpu/models/vision/siglip.py).

HF `SiglipVisionModel.vision_model` as the reference uses it: a conv
patchify with bias (a reshape and a matmul here), patch 16, no CLS token;
learned positions over all patches; pre-LN blocks layer_norm1 -> MHA
(separate q/k/v/out with bias) -> +res, layer_norm2 -> MLP (fc1 ->
gelu_tanh -> fc2) -> +res; `post_layernorm` on the last hidden state, every
LayerNorm at eps 1e-6. google/siglip-large-patch16-384 (the 8B's tower):
width 1024, 24 layers, 16 heads, intermediate 4096, 576 tokens; the
base-patch16 towers at 512 and 256 (`siglip_base_512`, `siglip_base_256`):
width 768, 12 layers, 12 heads, intermediate 3072, 1024 and 256 tokens. The
attention is plain torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models.vision.clip_vit import patchify
from starvector_tpu_torch.ops.attention import multihead_attention
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, gelu_tanh, layer_norm, layer_unbind, make_dense_params,
    make_layer_norm_params, matmul_f32, maybe_checkpoint, normal_,
)


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate_size: int = 4096
    ln_eps: float = 1e-6

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def width(self) -> int:
        return self.hidden_size


def siglip_large_384(**kw) -> SigLIPConfig:
    return SigLIPConfig(**kw)


def siglip_base_512(**kw) -> SigLIPConfig:
    base = dict(image_size=512, hidden_size=768, layers=12, heads=12, intermediate_size=3072)
    base.update(kw)
    return SigLIPConfig(**base)


def siglip_base_256(**kw) -> SigLIPConfig:
    base = dict(image_size=256, hidden_size=768, layers=12, heads=12, intermediate_size=3072)
    base.update(kw)
    return SigLIPConfig(**base)


def tiny_config(**kw) -> SigLIPConfig:
    base = dict(image_size=32, patch_size=8, hidden_size=32, layers=2, heads=4,
                intermediate_size=64)
    base.update(kw)
    return SigLIPConfig(**base)


def init_params(cfg: SigLIPConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    """torch.nn.Linear's uniform init for the projections (the JAX
    make_dense_params default), normal 0.02 for the patch and position
    embeddings, zero biases, identity norms."""
    W, L = cfg.hidden_size, cfg.layers
    kw = dict(lead=(L,), device=device, dtype=dtype)
    return {
        "patch_embed": {
            "kernel": normal_((cfg.patch_size * cfg.patch_size * 3, W), 0.02, gen, device, dtype),
            "bias": torch.zeros(W, device=device, dtype=dtype),
        },
        "position_embedding": normal_((cfg.num_tokens, W), 0.02, gen, device, dtype),
        "layers": {
            "layer_norm1": make_layer_norm_params(W, **kw),
            "attn": {name: make_dense_params(gen, W, W, **kw)
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": make_layer_norm_params(W, **kw),
            "mlp": {"fc1": make_dense_params(gen, W, cfg.intermediate_size, **kw),
                    "fc2": make_dense_params(gen, cfg.intermediate_size, W, **kw)},
        },
        "post_layernorm": make_layer_norm_params(W, device=device, dtype=dtype),
    }


def _block(p: dict, cfg: SigLIPConfig, x: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
    B, N, W = x.shape
    H = cfg.heads
    h = layer_norm(p["layer_norm1"], x, cfg.ln_eps)
    q, k, v = (dense(p["attn"][name], h, policy).reshape(B, N, H, W // H)
               for name in ("q_proj", "k_proj", "v_proj"))
    x = x + dense(p["attn"]["out_proj"], multihead_attention(q, k, v).reshape(B, N, W), policy)
    h = gelu_tanh(dense(p["mlp"]["fc1"], layer_norm(p["layer_norm2"], x, cfg.ln_eps), policy))
    return x + dense(p["mlp"]["fc2"], h, policy)


def forward(params: dict, cfg: SigLIPConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> last_hidden_state
    (B, num_tokens, hidden_size), post_layernorm included. The patch
    product accumulates in fp32 and takes its bias in fp32 before the one
    rounding, as the JAX einsum does."""
    x = patchify(policy.cast(images), cfg.patch_size)
    x = matmul_f32(x, policy.cast(params["patch_embed"]["kernel"]))
    x = (x + params["patch_embed"]["bias"].float()).to(policy.compute_dtype)
    x = x + policy.cast(params["position_embedding"])[None]
    for layer in layer_unbind(params["layers"], cfg.layers):
        x = maybe_checkpoint(lambda x, p=layer: _block(p, cfg, x, policy), remat)(x)
    return layer_norm(params["post_layernorm"], x, cfg.ln_eps)
