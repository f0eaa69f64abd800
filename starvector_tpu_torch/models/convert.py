"""Weights into the port (port of starvector_tpu/models/convert.py, the
SigLIP converter of starvector_tpu/models/vision/siglip.py, and the weight half of
starvector_tpu/models/builder.py::load_hf_starvector_checkpoint, whose
port is models/builder.py).

The port keeps the JAX package's parameter layout: layers stacked on a
leading axis, dense kernels (in, out), norms {"scale", "bias"}.

  * `from_jax_params(tree)` takes the JAX pytree as numpy arrays (nested
    dicts) and returns the same tree as torch tensors.
  * `from_hf_state_dict(sd, cfg)` takes the reference HF layout, as
    starvector_tpu/models/export.py writes it: torch Linear weights
    (out, in), one key per layer, the prefixes
    `model.svg_transformer.transformer.transformer.` (1B) or
    `model.svg_transformer.transformer.model.` and an optional
    `model.svg_transformer.transformer.lm_head.weight` (8B),
    `model.image_encoder.visual_encoder.` (CLIP's or SigLIP's keys, or a
    vqgan, convnext or open-clip tower in its own checkpoint's layout),
    `model.image_encoder.ln_vision.` (CLIP only) and
    `model.image_projection.` (the leading `model.` is optional).
  * `config_from_hf(sd, hf_cfg)` derives the StarVectorConfig from the
    weights and the checkpoint's config.json, as the JAX package's
    models/builder.py does.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import numpy as np
import torch

from starvector_tpu_torch.models import gpt_bigcode, image_encoder, starcoder2, starvector as sv
from starvector_tpu_torch.models.builder import config_from_yaml_block, is_v2
from starvector_tpu_torch.models.vision.clip_vit import CLIPViTConfig
from starvector_tpu_torch.models.vision.siglip import SigLIPConfig

DECODER_PREFIX = "svg_transformer.transformer.transformer."
V2_DECODER_PREFIX = "svg_transformer.transformer.model."
V2_HEAD = "svg_transformer.transformer.lm_head.weight"
TOWER_PREFIX = "image_encoder.visual_encoder."
# towers whose StarVector checkpoint keys are in their own source's layout
OWN_LAYOUT_TOWERS = ("vqgan", "convnext", "open-clip")


def to_tensor(x, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))  # copy: the source may alias foreign buffers
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree, *, dtype: torch.dtype | None = None, device="cpu"):
    """JAX parameter pytree (numpy leaves) -> the port's tensors, same tree
    (lists stay lists). Floating leaves are cast to `dtype` when given;
    BatchNorm running statistics and the fp32 scales of a quantized leaf
    ({"kernel_q", "scale"}, whose codes stay int8) keep their type, as in
    the JAX package."""
    if isinstance(tree, Mapping):
        keep = {"running_mean", "running_var"} | ({"scale"} if "kernel_q" in tree else set())
        return {k: from_jax_params(v, dtype=None if k in keep else dtype, device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # the convolutional towers' levels and blocks
        return [from_jax_params(v, dtype=dtype, device=device) for v in tree]
    return to_tensor(tree, dtype, device)


def _strip_model(sd: Mapping[str, np.ndarray]) -> dict:
    return {k.removeprefix("model."): v for k, v in sd.items()}


def _n_layers(sd, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    return 1 + max(int(m.group(1)) for k in sd if (m := pat.match(k)))


def _dense(sd, fmt: str, L: int, dtype, device, weight="weight", bias="bias") -> dict:
    """Stack per-layer torch Linear weights (out, in) as (L, in, out) kernels."""
    w = np.stack([np.asarray(sd[fmt.format(i) + weight]).T for i in range(L)])
    b = np.stack([np.asarray(sd[fmt.format(i) + bias]) for i in range(L)])
    return {"kernel": to_tensor(w, dtype, device), "bias": to_tensor(b, dtype, device)}


def _norm(sd, fmt: str, L: int, dtype, device) -> dict:
    return {"scale": to_tensor(np.stack([sd[fmt.format(i) + "weight"] for i in range(L)]), dtype, device),
            "bias": to_tensor(np.stack([sd[fmt.format(i) + "bias"] for i in range(L)]), dtype, device)}


def gpt_bigcode_from_hf(sd, prefix: str = DECODER_PREFIX, *, dtype=None, device="cpu") -> dict:
    L = _n_layers(sd, prefix + "h.")
    h = prefix + "h.{}."
    return {
        "wte": to_tensor(sd[prefix + "wte.weight"], dtype, device),
        "wpe": to_tensor(sd[prefix + "wpe.weight"], dtype, device),
        "layers": {
            "ln_1": _norm(sd, h + "ln_1.", L, dtype, device),
            "attn": {"c_attn": _dense(sd, h + "attn.c_attn.", L, dtype, device),
                     "c_proj": _dense(sd, h + "attn.c_proj.", L, dtype, device)},
            "ln_2": _norm(sd, h + "ln_2.", L, dtype, device),
            "mlp": {"c_fc": _dense(sd, h + "mlp.c_fc.", L, dtype, device),
                    "c_proj": _dense(sd, h + "mlp.c_proj.", L, dtype, device)},
        },
        "ln_f": {"scale": to_tensor(sd[prefix + "ln_f.weight"], dtype, device),
                 "bias": to_tensor(sd[prefix + "ln_f.bias"], dtype, device)},
    }


def starcoder2_from_hf(sd, prefix: str = V2_DECODER_PREFIX, head: str = V2_HEAD, *, dtype=None,
                       device="cpu") -> dict:
    """HF Starcoder2ForCausalLM weights (the 8B decoder); an `lm_head` only
    when the state dict holds one (an untied head)."""
    L = _n_layers(sd, prefix + "layers.")
    h = prefix + "layers.{}."
    params = {
        "embed_tokens": to_tensor(sd[prefix + "embed_tokens.weight"], dtype, device),
        "layers": {
            "input_layernorm": _norm(sd, h + "input_layernorm.", L, dtype, device),
            "attn": {name: _dense(sd, h + f"self_attn.{name}.", L, dtype, device)
                     for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "post_attention_layernorm": _norm(sd, h + "post_attention_layernorm.", L, dtype,
                                              device),
            "mlp": {"c_fc": _dense(sd, h + "mlp.c_fc.", L, dtype, device),
                    "c_proj": _dense(sd, h + "mlp.c_proj.", L, dtype, device)},
        },
        "norm": {"scale": to_tensor(sd[prefix + "norm.weight"], dtype, device),
                 "bias": to_tensor(sd[prefix + "norm.bias"], dtype, device)},
    }
    if head in sd:
        params["lm_head"] = to_tensor(sd[head], dtype, device)
    return params


def siglip_from_hf(sd, prefix: str = TOWER_PREFIX, *, dtype=None, device="cpu") -> dict:
    """HF SiglipVisionModel.vision_model weights (the 8B tower): the conv
    patch_embedding (W, 3, P, P) becomes the (3*P*P, W) patchify matmul."""
    L = _n_layers(sd, prefix + "encoder.layers.")
    r = prefix + "encoder.layers.{}."
    conv = np.asarray(sd[prefix + "embeddings.patch_embedding.weight"])
    return {
        "patch_embed": {"kernel": to_tensor(conv.reshape(conv.shape[0], -1).T, dtype, device),
                        "bias": to_tensor(sd[prefix + "embeddings.patch_embedding.bias"], dtype,
                                        device)},
        "position_embedding": to_tensor(sd[prefix + "embeddings.position_embedding.weight"], dtype,
                                      device),
        "layers": {
            "layer_norm1": _norm(sd, r + "layer_norm1.", L, dtype, device),
            "attn": {name: _dense(sd, r + f"self_attn.{name}.", L, dtype, device)
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": _norm(sd, r + "layer_norm2.", L, dtype, device),
            "mlp": {"fc1": _dense(sd, r + "mlp.fc1.", L, dtype, device),
                    "fc2": _dense(sd, r + "mlp.fc2.", L, dtype, device)},
        },
        "post_layernorm": {"scale": to_tensor(sd[prefix + "post_layernorm.weight"], dtype, device),
                           "bias": to_tensor(sd[prefix + "post_layernorm.bias"], dtype, device)},
    }


def clip_vit_from_hf(sd, prefix: str = TOWER_PREFIX, *, dtype=None, device="cpu") -> dict:
    """The reference VisionTransformer weights: conv1 (W, 3, P, P) becomes the
    (3*P*P, W) patchify matmul, fused in_proj (3W, W) becomes (W, 3W)."""
    L = _n_layers(sd, prefix + "transformer.resblocks.")
    r = prefix + "transformer.resblocks.{}."
    conv = np.asarray(sd[prefix + "conv1.weight"])
    return {
        "patch_embed": to_tensor(conv.reshape(conv.shape[0], -1).T, dtype, device),
        "class_embedding": to_tensor(sd[prefix + "class_embedding"], dtype, device),
        "positional_embedding": to_tensor(sd[prefix + "positional_embedding"], dtype, device),
        "ln_pre": {"scale": to_tensor(sd[prefix + "ln_pre.weight"], dtype, device),
                   "bias": to_tensor(sd[prefix + "ln_pre.bias"], dtype, device)},
        "layers": {
            "ln_1": _norm(sd, r + "ln_1.", L, dtype, device),
            "attn": {"in_proj": _dense(sd, r + "attn.", L, dtype, device,
                                       weight="in_proj_weight", bias="in_proj_bias"),
                     "out_proj": _dense(sd, r + "attn.out_proj.", L, dtype, device)},
            "ln_2": _norm(sd, r + "ln_2.", L, dtype, device),
            "mlp": {"c_fc": _dense(sd, r + "mlp.c_fc.", L, dtype, device),
                    "c_proj": _dense(sd, r + "mlp.c_proj.", L, dtype, device)},
        },
    }


def adapter_from_hf(sd, prefix: str = "image_projection.", *, dtype=None, device="cpu") -> dict:
    g = lambda n: sd[prefix + n]  # noqa: E731
    norm = {"scale": to_tensor(g("norm.weight"), dtype, device),
            "bias": to_tensor(g("norm.bias"), dtype, device)}
    if prefix + "norm.running_mean" in sd:
        norm["running_mean"] = to_tensor(g("norm.running_mean"), torch.float32, device)
        norm["running_var"] = to_tensor(g("norm.running_var"), torch.float32, device)
    return {
        "c_fc": {"kernel": to_tensor(np.asarray(g("c_fc.weight")).T, dtype, device),
                 "bias": to_tensor(g("c_fc.bias"), dtype, device)},
        "c_proj": {"kernel": to_tensor(np.asarray(g("c_proj.weight")).T, dtype, device),
                   "bias": to_tensor(g("c_proj.bias"), dtype, device)},
        "norm": norm,
    }


def _is_v2(sd) -> bool:
    return V2_DECODER_PREFIX + "embed_tokens.weight" in sd


def from_hf_state_dict(sd: Mapping[str, np.ndarray], cfg: sv.StarVectorConfig | None = None, *,
                       dtype: torch.dtype | None = None, device="cpu") -> dict:
    """A StarVector-1B or -8B HF state dict -> the port's parameters (the
    decoder, and the tower that the keys hold). CLIP and SigLIP towers are
    found by their keys. A vqgan, convnext or open-clip tower is in its own
    checkpoint's layout under `image_encoder.visual_encoder.` and is loaded
    by `cfg`'s image_encoder_type through
    image_encoder.params_from_checkpoint at cfg's tower geometry, which
    config_from_hf makes the stock one (the JAX builder's fourth branch:
    open-clip's ln_vision starts as the identity there, whatever the state
    dict holds)."""
    sd = _strip_model(sd)
    decoder = starcoder2_from_hf if _is_v2(sd) else gpt_bigcode_from_hf
    params = {"svg_transformer": decoder(sd, dtype=dtype, device=device)}
    t = cfg.image_encoder_type if cfg is not None and cfg.use_image_encoder else None
    if t in OWN_LAYOUT_TOWERS:
        params["image_encoder"] = image_encoder.params_from_checkpoint(
            cfg.encoder_config, sd, dtype=dtype, prefix=TOWER_PREFIX, device=device)
    elif TOWER_PREFIX + "conv1.weight" in sd:
        params["image_encoder"] = {
            "visual_encoder": clip_vit_from_hf(sd, dtype=dtype, device=device),
            "ln_vision": {"scale": to_tensor(sd["image_encoder.ln_vision.weight"], dtype, device),
                          "bias": to_tensor(sd["image_encoder.ln_vision.bias"], dtype, device)},
        }
    elif TOWER_PREFIX + "embeddings.patch_embedding.weight" in sd:
        params["image_encoder"] = {"visual_encoder": siglip_from_hf(sd, dtype=dtype,
                                                                    device=device)}
    if "image_encoder" in params:
        params["image_projection"] = adapter_from_hf(sd, dtype=dtype, device=device)
    return params


def _gpt_bigcode_config(sd) -> gpt_bigcode.GPTBigCodeConfig:
    vocab, _ = np.shape(sd[DECODER_PREFIX + "wte.weight"])
    n_pos, hidden = np.shape(sd[DECODER_PREFIX + "wpe.weight"])
    attn_out = np.shape(sd[DECODER_PREFIX + "h.0.attn.c_attn.weight"])[0]
    head_dim = max((attn_out - hidden) // 2, 1)  # MQA: E + 2 * head_dim
    return gpt_bigcode.GPTBigCodeConfig(
        vocab_size=vocab, n_positions=n_pos, hidden_size=hidden,
        n_layer=_n_layers(sd, DECODER_PREFIX + "h."), n_head=max(hidden // head_dim, 1))


def _starcoder2_config(sd, hf_cfg: dict) -> starcoder2.StarCoder2Config:
    """The JAX builder's rule: vocab from the weights (the reference adds
    special tokens, ~49157), head size 128 unless llm_geometry says otherwise,
    rope_theta and the window from llm_geometry (1e6 and 4096 without it),
    untied when the state dict holds lm_head.weight."""
    p = V2_DECODER_PREFIX
    vocab, hidden = np.shape(sd[p + "embed_tokens.weight"])
    geo = hf_cfg.get("llm_geometry", {})
    head_dim = int(geo.get("head_dim") or 128)
    return starcoder2.StarCoder2Config(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=_n_layers(sd, p + "layers."),
        num_attention_heads=np.shape(sd[p + "layers.0.self_attn.q_proj.weight"])[0] // head_dim,
        num_key_value_heads=np.shape(sd[p + "layers.0.self_attn.k_proj.weight"])[0] // head_dim,
        intermediate_size=np.shape(sd[p + "layers.0.mlp.c_fc.weight"])[0],
        rope_theta=float(geo.get("rope_theta") or 1e6),
        sliding_window=geo["sliding_window"] if "sliding_window" in geo else 4096,
        tie_word_embeddings=V2_HEAD not in sd)


def _clip_tower(sd, heads) -> CLIPViTConfig:
    width, _, patch, _ = np.shape(sd[TOWER_PREFIX + "conv1.weight"])
    grid = math.isqrt(np.shape(sd[TOWER_PREFIX + "positional_embedding"])[0] - 1)
    if heads is None:  # not recoverable from shapes: CLIP's head_dim-64 convention
        heads = max(width // (64 if width % 64 == 0 else 16), 1)
    return CLIPViTConfig(image_size=grid * patch, patch_size=patch, width=width,
                         layers=_n_layers(sd, TOWER_PREFIX + "transformer.resblocks."),
                         heads=heads)


# SigLIP widths whose head count is known (so400m's 1152 has 16 heads of 72,
# which the head_dim-64 rule would split as 18)
SIGLIP_HEADS = {768: 12, 1024: 16, 1152: 16, 1280: 16}


def _siglip_tower(sd, heads) -> SigLIPConfig:
    p = TOWER_PREFIX
    width, _, patch, _ = np.shape(sd[p + "embeddings.patch_embedding.weight"])
    grid = math.isqrt(np.shape(sd[p + "embeddings.position_embedding.weight"])[0])  # no CLS
    if heads is None:  # not in the weights: known widths, else the JAX package's rule
        head_dim = 64 if width % 64 == 0 else max(width // 4, 1)
        heads = SIGLIP_HEADS.get(width) or max(width // head_dim, 1)
    return SigLIPConfig(image_size=grid * patch, patch_size=patch, hidden_size=width,
                        layers=_n_layers(sd, p + "encoder.layers."), heads=heads,
                        intermediate_size=np.shape(sd[p + "encoder.layers.0.mlp.fc1.weight"])[0])


def config_from_hf(sd: Mapping[str, np.ndarray], hf_cfg: dict) -> sv.StarVectorConfig:
    """StarVectorConfig from the weights' shapes and config.json, as the JAX
    package's models/builder.py derives it: config.json through
    builder.config_from_yaml_block (the decoder from its name, starcoder2
    in starcoder_model_name or _name_or_path being the 8B; the overrides,
    max_length as max_length_train among them), then the decoder's geometry
    and the tower's from the weights."""
    cfg = config_from_yaml_block(hf_cfg)
    v2 = is_v2(hf_cfg)
    sd = _strip_model(sd)
    llm = _starcoder2_config(sd, hf_cfg) if v2 else _gpt_bigcode_config(sd)
    cfg = dataclasses.replace(cfg, llm=llm, decoder="starcoder2" if v2 else "gpt_bigcode")
    if cfg.use_image_encoder:
        heads = hf_cfg.get("vision_geometry", {}).get("heads")
        t = cfg.image_encoder_type
        if t == "clip":
            tower = _clip_tower(sd, heads)
        elif t.startswith("siglip"):
            tower = _siglip_tower(sd, heads)
        else:  # vqgan, convnext, open-clip: the stock tower, as the JAX builder takes it
            tower = cfg.encoder_config.tower_config
        cfg = dataclasses.replace(cfg, vision_tower=tower)
    return cfg
