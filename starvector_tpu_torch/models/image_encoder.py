"""Image encoder dispatch, CLIP and SigLIP-384 (port of
starvector_tpu/models/image_encoder.py).

'clip' (the 1B tower) is the in-repo ViT followed by an external
`ln_vision` LayerNorm; 'siglip_384' (the 8B tower) is SigLIP-large-patch16-384,
whose own `post_layernorm` ends it, with no `ln_vision`. The other towers
(siglip_512, siglip_256, vqgan, convnext, open-clip) are not ported yet:
ROADMAP queue 1, item 11.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models.vision import clip_vit, siglip
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
PORTED = ("clip", "siglip_384")


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
    def tower_config(self):
        if self.tower is not None:
            return self.tower
        if self.image_encoder_type == "clip":
            return clip_vit.CLIPViTConfig(image_size=self.image_size)
        if self.image_encoder_type == "siglip_384":
            return siglip.siglip_large_384()
        raise NotImplementedError(
            f"image encoder {self.image_encoder_type!r} is not ported yet "
            "(ROADMAP queue 1, item 11)")

    @property
    def uses_ln_vision(self) -> bool:
        """The CLIP tower ends in the external ln_vision; SigLIP in its own
        post_layernorm."""
        return self.image_encoder_type == "clip"


def _tower_module(cfg: ImageEncoderConfig):
    if cfg.image_encoder_type not in PORTED:
        raise NotImplementedError(
            f"image encoder {cfg.image_encoder_type!r} is not ported yet "
            "(ROADMAP queue 1, item 11)")
    return clip_vit if cfg.image_encoder_type == "clip" else siglip


def init_params(cfg: ImageEncoderConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    tower = cfg.tower_config
    params = {"visual_encoder": _tower_module(cfg).init_params(tower, gen, device=device,
                                                               dtype=dtype)}
    if cfg.uses_ln_vision:
        params["ln_vision"] = make_layer_norm_params(tower.width, device=device, dtype=dtype)
    return params


def forward(params: dict, cfg: ImageEncoderConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized, channels-last -> (B, query_length, hidden)."""
    embeds = _tower_module(cfg).forward(params["visual_encoder"], cfg.tower_config, images,
                                        policy=policy, remat=remat)
    if cfg.uses_ln_vision:
        embeds = layer_norm(params["ln_vision"], embeds)
    return embeds
