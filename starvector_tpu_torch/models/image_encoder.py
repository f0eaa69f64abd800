"""Image encoder dispatch, CLIP branch (port of
starvector_tpu/models/image_encoder.py).

'clip' is the in-repo ViT followed by an external `ln_vision` LayerNorm. The
other towers (SigLIP for the 8B model; vqgan, convnext, open-clip) are not
ported yet: ROADMAP queue 1, items 6 and 11.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models.vision import clip_vit
from starvector_tpu_torch.ops.layers import DTypePolicy, layer_norm, make_layer_norm_params

ENCODER_GEOMETRY = {
    # type -> (hidden_size, query_length)
    "clip": (1024, 257),
    "open-clip": (1024, 256),
    "vqgan": (256, 196),
    "convnext": (1024, 49),
    "siglip_512": (768, 1024),
    "siglip_384": (1024, 576),
    "siglip_256": (768, 256),
}


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    image_encoder_type: str = "clip"
    image_size: int = 224
    tower: object = None  # explicit tower geometry (checkpoint-derived, tiny towers)

    @property
    def geometry(self) -> tuple[int, int]:
        if self.tower is not None:
            return (self.tower.width, self.tower.num_tokens)
        if self.image_encoder_type not in ENCODER_GEOMETRY:
            raise ValueError(f"unknown image encoder {self.image_encoder_type!r}; "
                             f"one of {sorted(ENCODER_GEOMETRY)}")
        return ENCODER_GEOMETRY[self.image_encoder_type]

    @property
    def tower_config(self) -> clip_vit.CLIPViTConfig:
        if self.tower is not None:
            return self.tower
        if self.image_encoder_type != "clip":
            raise NotImplementedError(
                f"image encoder {self.image_encoder_type!r} is not ported yet "
                "(ROADMAP queue 1, items 6 and 11)")
        return clip_vit.CLIPViTConfig(image_size=self.image_size)


def init_params(cfg: ImageEncoderConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    tower = cfg.tower_config
    return {
        "visual_encoder": clip_vit.init_params(tower, gen, device=device, dtype=dtype),
        "ln_vision": make_layer_norm_params(tower.width, device=device, dtype=dtype),
    }


def forward(params: dict, cfg: ImageEncoderConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized, channels-last -> (B, query_length, hidden)."""
    embeds = clip_vit.forward(params["visual_encoder"], cfg.tower_config, images, policy=policy,
                              remat=remat)
    return layer_norm(params["ln_vision"], embeds)
