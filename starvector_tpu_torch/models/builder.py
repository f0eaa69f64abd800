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

import contextlib
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


def load_hf_starvector_checkpoint(path: str, dtype=torch.bfloat16, device="cuda", *,
                                  group=None, quantize: bool = False):
    """(params, cfg, tokenizer) from an HF-layout StarVector checkpoint
    directory: the weights converted into the port's layout (convert.py),
    the config from config.json and the weights' shapes, and the
    decoder's tokenizer version from tokenizer.json. `quantize=True`
    quantizes the decoder (ops/quantization.py::quantize_tree, its default
    threshold).

    With a serving `group` (parallel/tensor.py::ServingGroup) the rank
    reads only its own pieces of the decoder through safetensors'
    get_slice (convert.serving_state_dict: its tensor slices, and on a
    group with a layout its stage block's layers and fsdp shards of them),
    the tower and adapter on the leader only (with the token table whole
    where the decoder's is split), and returns starvector.serving_params'
    tree and config; with `quantize` it quantizes its own pieces to the
    whole tree's codes and scales (parallel/tensor.py::quantize_slices on
    tensor slices alone, parallel/sharding.py::quantize_shards on a
    layout's shards)."""
    from safetensors import safe_open

    from starvector_tpu_torch.api import tokenizer_version
    from starvector_tpu_torch.models.convert import (
        config_from_hf, from_hf_state_dict, serving_state_dict, stored_state_dict, to_tensor,
    )
    from starvector_tpu_torch.models.tokenizer import load_tokenizer
    from starvector_tpu_torch.ops.quantization import quantize_tree
    from starvector_tpu_torch.parallel import zero
    from starvector_tpu_torch.parallel.sharding import _paths, quantize_shards, register_local
    from starvector_tpu_torch.parallel.tensor import quantize_slices, register_rows

    device = require_device(device, 'device="cpu"')
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    infos, prompt = {}, None
    with contextlib.ExitStack() as files:
        handles = [files.enter_context(safe_open(os.path.join(path, name), framework="np"))
                   for name in sorted(os.listdir(path)) if name.endswith(".safetensors")]
        stored = stored_state_dict(handles)
        cfg = config_from_hf(stored, hf_cfg)
        sd = stored
        if group is not None:
            sd, infos = serving_state_dict(stored, cfg, group)
        params = from_hf_state_dict(sd, cfg, dtype=dtype, device=device)
        table = "wte" if cfg.decoder == "gpt_bigcode" else "embed_tokens"
        if group is not None and group.is_leader and infos.get(table) is not None \
                and infos[table].dim is not None:
            key = next(k for k in stored if k.endswith(f".{table}.weight"))
            prompt = {table: to_tensor(stored[key], dtype, device)}
    dec = cfg.decoder_module
    tg = None if group is None else group.tensor
    if infos:
        for p, leaf in _paths(params["svg_transformer"]):
            info = infos[p]
            want = tuple(info.local_of(torch.empty(info.full_shape, device="meta")).shape)
            if tuple(leaf.shape) != want:
                raise ValueError(f"{p}: read {tuple(leaf.shape)}, its shard is {want}")
            register_local(p, leaf, info)
        if prompt is not None:
            params["prompt_decoder"] = prompt
    elif tg is not None:
        register_rows(params["svg_transformer"], dec.partition_rules(), tg)
    if quantize and infos:
        params["svg_transformer"] = quantize_shards(params["svg_transformer"])
    elif quantize and tg is not None and tg.size > 1:
        params["svg_transformer"] = quantize_slices(
            params["svg_transformer"], dec.partition_rules(),
            [dec.tensor_units(cfg.llm, tg.size, r) for r in range(tg.size)], tg)
    elif quantize:
        params["svg_transformer"] = quantize_tree(params["svg_transformer"])
    if tg is not None:
        cfg = dataclasses.replace(cfg, llm=dec.tensor_config(cfg.llm, tg.size, tg.rank))
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


def load_pretrained_model(path: str, dtype=torch.bfloat16, device="cuda", *, group=None,
                          quantize: bool = False):
    """The serving path: (params, cfg, tokenizer, processor, context_len),
    context_len being the checkpoint's max_length_train; with a serving
    `group`, this rank's; `quantize`: an int8-weight decoder
    (load_hf_starvector_checkpoint)."""
    from starvector_tpu_torch.data.processor import processor_for_encoder

    device = require_device(device, 'device="cpu"')
    params, cfg, tokenizer = load_hf_starvector_checkpoint(path, dtype, device, group=group,
                                                           quantize=quantize)
    processor = processor_for_encoder(cfg.image_encoder_type, cfg.image_size, device=device)
    return params, cfg, tokenizer, processor, cfg.max_length_train
