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
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.tensor import copy_to_group
from starvector_tpu_torch.parallel.zero import gathered
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


def partition_rules() -> list[tuple[str, P]]:
    """Path regex -> PartitionSpec, the JAX package's list."""
    return [
        (r"patch_embed/kernel", P(None, "tensor")),
        (r"position_embedding$", P(None, None)),
        (r"layers/.*(q_proj|k_proj|v_proj)/kernel", P(None, "fsdp", "tensor")),
        (r"layers/.*(q_proj|k_proj|v_proj)/bias", P(None, "tensor")),
        (r"layers/.*out_proj/kernel", P(None, "tensor", "fsdp")),
        (r"layers/.*fc1/kernel", P(None, "fsdp", "tensor")),
        (r"layers/.*fc1/bias", P(None, "tensor")),
        (r"layers/.*fc2/kernel", P(None, "tensor", "fsdp")),
        (r"layers/.*", P(None, None)),
        (r"post_layernorm/", P(None)),
    ]


def tensor_units(cfg: SigLIPConfig, tp: int, rank: int) -> dict:
    """Tensor rank `rank` of tp's ranges along each split projection, for
    training: q/k/v_proj's columns and out_proj's rows of the rank's whole
    heads, an even 1/tp of fc1's columns and fc2's rows; the patch
    embedding whole on every rank (clip_vit.tensor_units)."""
    from starvector_tpu_torch.parallel.tensor import even_split, head_layout

    D = cfg.hidden_size // cfg.heads
    h = head_layout(cfg.heads, cfg.heads, tp)[rank]
    q = (h.q_start * D, h.q_count * D)
    mlp = even_split(cfg.intermediate_size, tp, rank)
    return {"q_proj": q, "k_proj": q, "v_proj": q, "out_proj": q, "fc1": mlp, "fc2": mlp,
            "patch_embed": None}


def _block(p: dict, cfg: SigLIPConfig, x: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
    """One block; on a tensor rank (tensor_units) over its own heads and
    MLP columns, the normed inputs entering through copy_to_group."""
    B, N, W = x.shape
    D = W // cfg.heads
    h = copy_to_group(layer_norm(p["layer_norm1"], x, cfg.ln_eps))
    q, k, v = (dense(p["attn"][name], h, policy).unflatten(-1, (-1, D))
               for name in ("q_proj", "k_proj", "v_proj"))
    x = x + dense(p["attn"]["out_proj"], multihead_attention(q, k, v).flatten(-2), policy)
    h = copy_to_group(layer_norm(p["layer_norm2"], x, cfg.ln_eps))
    h = gelu_tanh(dense(p["mlp"]["fc1"], h, policy))
    return x + dense(p["mlp"]["fc2"], h, policy)


def forward(params: dict, cfg: SigLIPConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> last_hidden_state
    (B, num_tokens, hidden_size), post_layernorm included. The patch
    product accumulates in fp32 and takes its bias in fp32 before the one
    rounding, as the JAX einsum does. On a ZeRO-3 layout each block gathers
    its weights inside its checkpoint (parallel/zero.py)."""
    top = gathered({k: v for k, v in params.items() if k != "layers"}, policy)
    x = patchify(policy.cast(images), cfg.patch_size)
    x = matmul_f32(x, policy.cast(top["patch_embed"]["kernel"]))
    x = (x + top["patch_embed"]["bias"].float()).to(policy.compute_dtype)
    x = x + policy.cast(top["position_embedding"])[None]
    for layer in layer_unbind(params["layers"], cfg.layers):
        x = maybe_checkpoint(lambda x, p=layer: _block(gathered(p, policy), cfg, x, policy),
                             remat)(x)
    return layer_norm(top["post_layernorm"], x, cfg.ln_eps)
