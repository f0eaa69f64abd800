"""CLIP ViT vision tower, the 1B model's image encoder (port of
starvector_tpu/models/vision/clip_vit.py).

Patchify is a reshape and a matmul (no convolution); CLS token and learned
positions; pre-LN (`ln_pre`); blocks ln_1 -> MHA (fused in_proj split into
q, k, v) -> +res, ln_2 -> MLP(`act`) -> +res: QuickGELU for the LAVIS tower,
exact GELU for open_clip's ViTs (models/vision/open_clip_vit.py). No
`ln_post`: the image encoder applies its own `ln_vision`. Returns all tokens
(257 at 224/14).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from starvector_tpu_torch.ops.attention import multihead_attention
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, layer_norm, layer_unbind, make_dense_params, make_layer_norm_params,
    maybe_checkpoint, normal_, quick_gelu,
)


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 23
    heads: int = 16
    ln_eps: float = 1e-5
    act: str = "quick_gelu"   # the LAVIS tower; open_clip's ViTs take "gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1


def tiny_config(**kw) -> CLIPViTConfig:
    base = dict(image_size=28, patch_size=7, width=32, layers=2, heads=4)
    base.update(kw)
    return CLIPViTConfig(**base)


def init_params(cfg: CLIPViTConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    W, L = cfg.width, cfg.layers
    scale = W**-0.5
    kw = dict(lead=(L,), device=device, dtype=dtype)
    return {
        "patch_embed": normal_((cfg.patch_size * cfg.patch_size * 3, W), scale, gen, device, dtype),
        "class_embedding": normal_((W,), scale, gen, device, dtype),
        "positional_embedding": normal_((cfg.num_tokens, W), scale, gen, device, dtype),
        "ln_pre": make_layer_norm_params(W, device=device, dtype=dtype),
        "layers": {
            "ln_1": make_layer_norm_params(W, **kw),
            "attn": {
                "in_proj": make_dense_params(gen, W, 3 * W, **kw),
                "out_proj": make_dense_params(gen, W, W, **kw),
            },
            "ln_2": make_layer_norm_params(W, **kw),
            "mlp": {
                "c_fc": make_dense_params(gen, W, 4 * W, **kw),
                "c_proj": make_dense_params(gen, 4 * W, W, **kw),
            },
        },
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, 3*patch*patch), ordered (C, ph, pw) within a
    patch like a Conv2d weight."""
    B, H, Wd, C = images.shape
    gh, gw = H // patch, Wd // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, C * patch * patch)


def _block(p: dict, cfg: CLIPViTConfig, x: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
    B, N, W = x.shape
    H = cfg.heads
    D = W // H
    h = layer_norm(p["ln_1"], x, cfg.ln_eps)
    q, k, v = dense(p["attn"]["in_proj"], h, policy).chunk(3, dim=-1)
    attn = multihead_attention(q.reshape(B, N, H, D), k.reshape(B, N, H, D),
                               v.reshape(B, N, H, D)).reshape(B, N, W)
    x = x + dense(p["attn"]["out_proj"], attn, policy)
    h = dense(p["mlp"]["c_fc"], layer_norm(p["ln_2"], x, cfg.ln_eps), policy)
    h = quick_gelu(h) if cfg.act == "quick_gelu" else F.gelu(h, approximate="none")
    return x + dense(p["mlp"]["c_proj"], h, policy)


def forward(params: dict, cfg: CLIPViTConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, num_tokens, width), before
    ln_vision. Differentiable; `remat` checkpoints each block
    (layers.maybe_checkpoint: any mode the tower takes recomputes the whole
    block, since its attention is plain torch)."""
    B = images.shape[0]
    x = patchify(policy.cast(images), cfg.patch_size)
    x = torch.matmul(x, policy.cast(params["patch_embed"]))
    cls = policy.cast(params["class_embedding"]).expand(B, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + policy.cast(params["positional_embedding"])[None]
    x = layer_norm(params["ln_pre"], x, cfg.ln_eps)
    for layer in layer_unbind(params["layers"], cfg.layers):
        x = maybe_checkpoint(lambda x, p=layer: _block(p, cfg, x, policy), remat)(x)
    return x
