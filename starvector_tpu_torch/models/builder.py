"""Model builder (port of starvector_tpu/models/builder.py).

  * `config_from_yaml_block(block)` maps a `model` yaml block, or a
    checkpoint's config.json, onto StarVectorConfig: the one table of
    overrides that training (train/train.py) and checkpoint loading
    (models/convert.py::config_from_hf) both read.
  * `model_builder(config, device)`: the training path, random weights
    from the block's seed or a local HF-layout checkpoint directory.
  * `load_pretrained_model(path)`: the serving path, returning (params,
    cfg, tokenizer, processor, context_len).

The loaders run on the card unless the caller passes device="cpu".

The checkpoint directory is the reference HF layout that train/hub.py
writes: model*.safetensors, config.json, tokenizer.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.models import starvector as sv

# config.json / yaml key -> StarVectorConfig field
OVERRIDES = {"image_encoder_type": "image_encoder_type", "adapter_norm": "adapter_norm",
             "image_size": "image_size", "max_length": "max_length_train", "task": "task"}


def is_v2(block: dict) -> bool:
    """StarCoder2 (the 8B) when its name says so, as the JAX builder detects
    it (some checkpoints carry only _name_or_path)."""
    name = str(block.get("starcoder_model_name", "")) + str(block.get("_name_or_path", ""))
    return "starcoder2" in name


def config_from_yaml_block(block: dict) -> sv.StarVectorConfig:
    """The reference's model block (configs/models/*.yaml) or a checkpoint's
    config.json -> StarVectorConfig: the preset (tiny, tiny-v2, or the full
    1B / 8B by the decoder's name), then OVERRIDES. `attn_impl` is not
    read: the port's attention is always its flash kernels."""
    preset = block.get("preset")
    if preset in ("tiny", "tiny-v2"):
        base = sv.tiny_config(decoder="starcoder2" if preset == "tiny-v2" else "gpt_bigcode")
    elif preset in (None, "", "full"):
        base = sv.starvector_8b_config() if is_v2(block) else sv.starvector_1b_config()
    else:
        raise ValueError(f"unknown model.preset {preset!r}")
    overrides: dict[str, Any] = {field: block[key] for key, field in OVERRIDES.items()
                                 if key in block}
    if "max_length_train" in overrides:
        overrides["max_length_train"] = int(overrides["max_length_train"])
    return dataclasses.replace(base, **overrides)


def load_hf_starvector_checkpoint(path: str, dtype=torch.bfloat16, device="cuda"):
    """(params, cfg, tokenizer) from an HF-layout StarVector checkpoint
    directory: the weights converted into the port's layout (convert.py),
    the config from config.json and the weights' shapes, and the
    decoder's tokenizer version from tokenizer.json."""
    from safetensors.numpy import load_file

    from starvector_tpu_torch.api import tokenizer_version
    from starvector_tpu_torch.models.convert import config_from_hf, from_hf_state_dict
    from starvector_tpu_torch.models.tokenizer import load_tokenizer

    device = require_device(device, 'device="cpu"')
    sd: dict = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            sd.update(load_file(os.path.join(path, name)))
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(sd, hf_cfg)
    params = from_hf_state_dict(sd, cfg, dtype=dtype, device=device)
    del sd
    return params, cfg, load_tokenizer(path, version=tokenizer_version(cfg))


def model_builder(config, device) -> tuple[dict, sv.StarVectorConfig, Any]:
    """The training path: (fp32 params on `device`, config, the checkpoint's
    tokenizer or None). Random weights from a torch.Generator seeded with
    model.seed, or a local checkpoint directory (model.model_name /
    model.pretrained_path), whose own tokenizer the run then takes."""
    block = dict(config["model"] if "model" in config else config)
    cfg = config_from_yaml_block(block)
    pretrained = block.get("model_name") or block.get("pretrained_path")
    if pretrained and os.path.isdir(str(pretrained)):
        return load_hf_starvector_checkpoint(str(pretrained), torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(int(block.get("seed", 0)))
    return sv.init_params(cfg, gen, device=device), cfg, None


def load_pretrained_model(path: str, dtype=torch.bfloat16, device="cuda"):
    """The serving path: (params, cfg, tokenizer, processor, context_len),
    context_len being the checkpoint's max_length_train."""
    from starvector_tpu_torch.data.processor import processor_for_encoder

    device = require_device(device, 'device="cpu"')
    params, cfg, tokenizer = load_hf_starvector_checkpoint(path, dtype, device)
    processor = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=device)
    return params, cfg, tokenizer, processor, cfg.max_length_train
