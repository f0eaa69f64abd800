"""StarVector task model, im2svg inference: vision tower + adapter +
GPTBigCode decoder (port of starvector_tpu/models/starvector.py).

Only the v1 model (GPTBigCode decoder, CLIP tower) is ported; the v2 model
(StarCoder2 decoder, SigLIP tower) is ROADMAP queue 1, item 5. Generation
lives in starvector_tpu_torch/generation/engine.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from starvector_tpu_torch.models import adapter as adapter_mod
from starvector_tpu_torch.models import gpt_bigcode, image_encoder
from starvector_tpu_torch.models.vision.clip_vit import CLIPViTConfig
from starvector_tpu_torch.ops.layers import DTypePolicy


@dataclasses.dataclass(frozen=True)
class StarVectorConfig:
    decoder: str = "gpt_bigcode"
    image_encoder_type: str = "clip"
    adapter_norm: str = "layer_norm"
    image_size: int = 224
    task: str = "im2svg"
    llm: Any = None            # decoder geometry; None -> GPTBigCode 1B
    vision_tower: Any = None   # tower geometry override (a CLIPViTConfig)

    def __post_init__(self):
        if self.decoder != "gpt_bigcode":
            raise NotImplementedError(
                f"decoder {self.decoder!r} is not ported yet (ROADMAP queue 1, item 5)")
        if self.llm is None:
            object.__setattr__(self, "llm", gpt_bigcode.GPTBigCodeConfig())

    @property
    def use_image_encoder(self) -> bool:
        return self.task == "im2svg"

    @property
    def hidden_size(self) -> int:
        return self.llm.hidden_size

    @property
    def vision_geometry(self) -> tuple[int, int]:
        return image_encoder.ImageEncoderConfig(self.image_encoder_type, self.image_size).geometry

    @property
    def encoder_config(self) -> image_encoder.ImageEncoderConfig:
        return image_encoder.ImageEncoderConfig(self.image_encoder_type, self.image_size,
                                                tower=self.vision_tower)

    @property
    def adapter_config(self) -> adapter_mod.AdapterConfig:
        hidden, qlen = self.vision_geometry
        return adapter_mod.AdapterConfig(input_size=hidden, output_size=self.hidden_size,
                                         query_length=qlen, adapter_norm=self.adapter_norm)


def starvector_1b_config(**kw) -> StarVectorConfig:
    base = dict(
        decoder="gpt_bigcode",
        image_encoder_type="clip",
        adapter_norm="batch_norm",
    )
    base.update(kw)
    return StarVectorConfig(**base)


def tiny_config(task: str = "im2svg", decoder: str = "gpt_bigcode", **kw) -> StarVectorConfig:
    base = dict(decoder=decoder, image_encoder_type="clip", image_size=28, task=task,
                llm=gpt_bigcode.tiny_config())
    base.update(kw)
    return StarVectorConfig(**base)


def _encoder_cfg(cfg: StarVectorConfig):
    """(encoder config, tower config). A CLIP tower at an image size other
    than 224 without an explicit tower is the tiny test tower: patch 7,
    width 32, 2 layers, 4 heads (the JAX package's rule)."""
    enc = cfg.encoder_config
    if enc.tower is None and cfg.image_encoder_type == "clip" and cfg.image_size != 224:
        tower = CLIPViTConfig(image_size=cfg.image_size, patch_size=7, width=32, layers=2, heads=4)
        return dataclasses.replace(enc, tower=tower), tower
    return enc, enc.tower_config


def _adapter_cfg_for(cfg: StarVectorConfig, params: dict) -> adapter_mod.AdapterConfig:
    """Adapter geometry read from the parameters (tiny towers included)."""
    norm = params["image_projection"]["norm"]["scale"]
    qlen = norm.shape[0]
    d_in = params["image_projection"]["c_fc"]["kernel"].shape[0]
    return adapter_mod.AdapterConfig(input_size=d_in, output_size=cfg.hidden_size,
                                     query_length=qlen, adapter_norm=cfg.adapter_norm)


def init_params(cfg: StarVectorConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    params = {"svg_transformer": gpt_bigcode.init_params(cfg.llm, gen, device=device, dtype=dtype)}
    if cfg.use_image_encoder:
        enc, tower = _encoder_cfg(cfg)
        params["image_encoder"] = image_encoder.init_params(enc, gen, device=device, dtype=dtype)
        ad_cfg = dataclasses.replace(cfg.adapter_config, input_size=tower.width,
                                     query_length=tower.num_tokens)
        params["image_projection"] = adapter_mod.init_params(ad_cfg, gen, device=device,
                                                             dtype=dtype)
    return params


def encode_image(params: dict, cfg: StarVectorConfig, images: torch.Tensor, *,
                 policy: DTypePolicy = DTypePolicy()) -> torch.Tensor:
    """Vision tower + ln_vision + adapter -> (B, query_length, llm_hidden)."""
    enc, _ = _encoder_cfg(cfg)
    embeds = image_encoder.forward(params["image_encoder"], enc, images, policy=policy)
    return adapter_mod.forward(params["image_projection"], _adapter_cfg_for(cfg, params), embeds,
                               policy=policy)
