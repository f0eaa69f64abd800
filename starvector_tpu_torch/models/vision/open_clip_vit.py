"""open_clip ViT visual tower (port of
starvector_tpu/models/vision/open_clip_vit.py), a thin layer over
clip_vit.

The reference's 'open-clip' backend takes the 256 patch tokens (CLS
dropped) of an open_clip VisionTransformer, then its external ln_vision
(models/image_encoder.py). Against the LAVIS tower: exact GELU in place of
QuickGELU (the trunk is clip_vit with act="gelu"), an in-tower `ln_post`,
and no CLS token in the output. Weights load from an open_clip state dict
(`from_torch_state_dict`, prefix "visual."); none ships with the repo.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models.vision import clip_vit
from starvector_tpu_torch.ops.layers import DTypePolicy, layer_norm, make_layer_norm_params
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.zero import gathered


@dataclasses.dataclass(frozen=True)
class OpenCLIPViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    ln_eps: float = 1e-5

    @property
    def trunk(self) -> clip_vit.CLIPViTConfig:
        return clip_vit.CLIPViTConfig(image_size=self.image_size, patch_size=self.patch_size,
                                      width=self.width, layers=self.layers, heads=self.heads,
                                      ln_eps=self.ln_eps, act="gelu")

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2  # CLS excluded


def tiny_config(**kw) -> OpenCLIPViTConfig:
    base = dict(image_size=28, patch_size=7, width=32, layers=2, heads=4)
    base.update(kw)
    return OpenCLIPViTConfig(**base)


def init_params(cfg: OpenCLIPViTConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    params = clip_vit.init_params(cfg.trunk, gen, device=device, dtype=dtype)
    params["ln_post"] = make_layer_norm_params(cfg.width, device=device, dtype=dtype)
    return params


def partition_rules() -> list[tuple[str, P]]:
    """The trunk's rules and ln_post, the JAX package's list."""
    return clip_vit.partition_rules() + [(r"ln_post/", P(None))]


def forward(params: dict, cfg: OpenCLIPViTConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> the patch tokens (B, num_tokens,
    width), ln_post applied, before ln_vision."""
    x = clip_vit.forward(params, cfg.trunk, images, policy=policy, remat=remat)
    return layer_norm(gathered(params["ln_post"]), x, cfg.ln_eps)[:, 1:]


def from_torch_state_dict(sd, cfg: OpenCLIPViTConfig, *, dtype=None, prefix: str = "visual.",
                          device="cpu") -> dict:
    """An open_clip VisionTransformer state dict: the LAVIS tower's module
    names (models/convert.py::clip_vit_from_hf) plus ln_post."""
    from starvector_tpu_torch.models.convert import clip_vit_from_hf, to_tensor

    params = clip_vit_from_hf(sd, prefix, dtype=dtype, device=device)
    params["ln_post"] = {"scale": to_tensor(sd[prefix + "ln_post.weight"], dtype, device),
                         "bias": to_tensor(sd[prefix + "ln_post.bias"], dtype, device)}
    return params
