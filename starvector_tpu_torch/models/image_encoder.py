"""Image encoder dispatch over the seven towers (port of
starvector_tpu/models/image_encoder.py).

  * 'clip' (the 1B tower): the in-repo ViT, then an external `ln_vision`.
  * 'siglip_384' (the 8B tower), 'siglip_512', 'siglip_256': SigLIP, ended
    by its own `post_layernorm`.
  * 'open-clip': an open_clip ViT's 256 patch tokens (ln_post in the tower),
    then `ln_vision`.
  * 'vqgan': the taming encoder, 196 tokens of width 256.
  * 'convnext': open_clip's ConvNeXt-Base trunk, 49 tokens of width 1024.

The towers are plain torch (XLA in the JAX package). Weights for vqgan,
convnext and open-clip load from their own checkpoints
(`params_from_checkpoint`); none ships with the repo.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models.vision import clip_vit, convnext, open_clip_vit, siglip, vqgan
from starvector_tpu_torch.ops.layers import DTypePolicy, layer_norm, make_layer_norm_params
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.zero import gathered

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
# a tower checkpoint's own prefix, where the caller gives none
CHECKPOINT_PREFIX = {"vqgan": "encoder.", "convnext": "visual.trunk.", "open-clip": "visual."}


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    image_encoder_type: str = "clip"
    image_size: int = 224
    tower: object = None  # explicit tower geometry (checkpoint-derived, tiny towers)

    @property
    def geometry(self) -> tuple[int, int]:
        """(hidden, query length): the tower override's, when it states its
        token count (ViTs and SigLIP), else the stock table's, whatever the
        override (vqgan and convnext give only `tokens_for`), as in the JAX
        package."""
        if self.tower is not None and hasattr(self.tower, "num_tokens"):
            hidden = getattr(self.tower, "hidden_size", None) or self.tower.width
            return (hidden, self.tower.num_tokens)
        if self.image_encoder_type not in ENCODER_GEOMETRY:
            raise ValueError(f"unknown image encoder {self.image_encoder_type!r}; "
                             f"one of {sorted(ENCODER_GEOMETRY)}")
        return ENCODER_GEOMETRY[self.image_encoder_type]

    @property
    def tower_config(self):
        if self.tower is not None:
            return self.tower
        t = self.image_encoder_type
        stock = {
            "clip": lambda: clip_vit.CLIPViTConfig(image_size=self.image_size),
            "open-clip": lambda: open_clip_vit.OpenCLIPViTConfig(image_size=self.image_size),
            "vqgan": vqgan.VQGANEncoderConfig,
            "convnext": convnext.ConvNeXtConfig,
            "siglip_384": siglip.siglip_large_384,
            "siglip_512": siglip.siglip_base_512,
            "siglip_256": siglip.siglip_base_256,
        }
        if t not in stock:
            raise ValueError(f"unknown image encoder {t!r}; one of {sorted(stock)}")
        return stock[t]()

    @property
    def uses_ln_vision(self) -> bool:
        """clip and open-clip end in the external ln_vision; the others in
        their own last norm (or none)."""
        return self.image_encoder_type in ("clip", "open-clip")


def _tower_module(t: str):
    """The module of image_encoder_type `t` (SigLIP for every siglip_*)."""
    return {"clip": clip_vit, "open-clip": open_clip_vit, "vqgan": vqgan,
            "convnext": convnext}.get(t, siglip)


def init_params(cfg: ImageEncoderConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    tower = cfg.tower_config
    params = {"visual_encoder": _tower_module(cfg.image_encoder_type).init_params(
        tower, gen, device=device, dtype=dtype)}
    if cfg.uses_ln_vision:
        params["ln_vision"] = make_layer_norm_params(tower.width, device=device, dtype=dtype)
    return params


def params_from_checkpoint(cfg: ImageEncoderConfig, sd, *, dtype=None, prefix: str = "",
                           device="cpu") -> dict:
    """Encoder parameters from a torch state dict in the tower's own layout:
    a taming checkpoint for vqgan ("encoder."), an open_clip one for
    convnext ("visual.trunk.") and open-clip ("visual."), a StarVector
    subtree for clip and SigLIP. ln_vision, where the tower takes it, starts
    as the identity (the JAX rule: the tower checkpoint holds none)."""
    from starvector_tpu_torch.models.convert import clip_vit_from_hf, siglip_from_hf

    t = cfg.image_encoder_type
    prefix = prefix or CHECKPOINT_PREFIX.get(t, "")
    if t == "clip":
        enc = clip_vit_from_hf(sd, prefix, dtype=dtype, device=device)
    elif t.startswith("siglip"):
        enc = siglip_from_hf(sd, prefix, dtype=dtype, device=device)
    else:
        enc = _tower_module(t).from_torch_state_dict(sd, cfg.tower_config, dtype=dtype,
                                                     prefix=prefix, device=device)
    params = {"visual_encoder": enc}
    if cfg.uses_ln_vision:
        params["ln_vision"] = make_layer_norm_params(cfg.tower_config.width, device=device,
                                                     dtype=dtype or torch.float32)
    return params


def partition_rules() -> list[tuple[str, P]]:
    """Every tower's specific rules first, then the towers' catch-alls
    (first match wins: clip's `layers/.*` must not shadow SigLIP's
    projections), as the JAX package orders them."""
    specific, catchall = [], []
    for mod in (clip_vit, siglip, vqgan, convnext):
        for pattern, spec in mod.partition_rules():
            full = r"visual_encoder/" + pattern.lstrip("^")
            is_catchall = pattern.rstrip("$") in (r"layers/.*", r".*")
            (catchall if is_catchall else specific).append((full, spec))
    specific.append((r"visual_encoder/ln_post/", P(None)))
    specific.append((r"ln_vision/", P(None)))
    return specific + catchall


def tensor_units(cfg: ImageEncoderConfig, tp: int, rank: int) -> dict:
    """Tensor rank `rank` of tp's ranges of the tower's split projections
    in training (a CLIP trunk's, open-clip's included, or SigLIP's); the
    convolutional towers have no `tensor` rules and stay whole."""
    tower = cfg.tower_config
    if cfg.image_encoder_type in ("clip", "open-clip"):
        trunk = tower.trunk if cfg.image_encoder_type == "open-clip" else tower
        return clip_vit.tensor_units(trunk, tp, rank)
    if cfg.image_encoder_type.startswith("siglip"):
        return siglip.tensor_units(tower, tp, rank)
    return {}


def forward(params: dict, cfg: ImageEncoderConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized, channels-last -> (B, query_length, hidden)."""
    embeds = _tower_module(cfg.image_encoder_type).forward(
        params["visual_encoder"], cfg.tower_config, images, policy=policy, remat=remat)
    if cfg.uses_ln_vision:
        embeds = layer_norm(gathered(params["ln_vision"]), embeds)
    return embeds
