"""Weights into the port (port of starvector_tpu/models/convert.py and the
v1 branch of starvector_tpu/models/builder.py::load_hf_starvector_checkpoint).

The port keeps the JAX package's parameter layout: layers stacked on a
leading axis, dense kernels (in, out), norms {"scale", "bias"}.

  * `from_jax_params(tree)` takes the JAX pytree as numpy arrays (nested
    dicts) and returns the same tree as torch tensors.
  * `from_hf_state_dict(sd)` takes the reference HF layout, as
    starvector_tpu/models/export.py writes it: torch Linear weights
    (out, in), one key per layer, the prefixes
    `model.svg_transformer.transformer.transformer.`,
    `model.image_encoder.visual_encoder.`, `model.image_encoder.ln_vision.`
    and `model.image_projection.` (the leading `model.` is optional).
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

from starvector_tpu_torch.models import gpt_bigcode, starvector as sv
from starvector_tpu_torch.models.vision.clip_vit import CLIPViTConfig

DECODER_PREFIX = "svg_transformer.transformer.transformer."
TOWER_PREFIX = "image_encoder.visual_encoder."


def _tensor(x, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))  # copy: the source may alias foreign buffers
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree, *, dtype: torch.dtype | None = None, device="cpu"):
    """JAX parameter pytree (numpy leaves) -> the port's tensors, same tree.
    Floating leaves are cast to `dtype` when given; BatchNorm running
    statistics stay fp32 as in the JAX package."""
    if isinstance(tree, Mapping):
        return {k: (from_jax_params(v, dtype=None, device=device)
                    if k in ("running_mean", "running_var")
                    else from_jax_params(v, dtype=dtype, device=device))
                for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def _strip_model(sd: Mapping[str, np.ndarray]) -> dict:
    return {k.removeprefix("model."): v for k, v in sd.items()}


def _n_layers(sd, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    return 1 + max(int(m.group(1)) for k in sd if (m := pat.match(k)))


def _dense(sd, fmt: str, L: int, dtype, device, weight="weight", bias="bias") -> dict:
    """Stack per-layer torch Linear weights (out, in) as (L, in, out) kernels."""
    w = np.stack([np.asarray(sd[fmt.format(i) + weight]).T for i in range(L)])
    b = np.stack([np.asarray(sd[fmt.format(i) + bias]) for i in range(L)])
    return {"kernel": _tensor(w, dtype, device), "bias": _tensor(b, dtype, device)}


def _norm(sd, fmt: str, L: int, dtype, device) -> dict:
    return {"scale": _tensor(np.stack([sd[fmt.format(i) + "weight"] for i in range(L)]), dtype, device),
            "bias": _tensor(np.stack([sd[fmt.format(i) + "bias"] for i in range(L)]), dtype, device)}


def gpt_bigcode_from_hf(sd, prefix: str = DECODER_PREFIX, *, dtype=None, device="cpu") -> dict:
    L = _n_layers(sd, prefix + "h.")
    h = prefix + "h.{}."
    return {
        "wte": _tensor(sd[prefix + "wte.weight"], dtype, device),
        "wpe": _tensor(sd[prefix + "wpe.weight"], dtype, device),
        "layers": {
            "ln_1": _norm(sd, h + "ln_1.", L, dtype, device),
            "attn": {"c_attn": _dense(sd, h + "attn.c_attn.", L, dtype, device),
                     "c_proj": _dense(sd, h + "attn.c_proj.", L, dtype, device)},
            "ln_2": _norm(sd, h + "ln_2.", L, dtype, device),
            "mlp": {"c_fc": _dense(sd, h + "mlp.c_fc.", L, dtype, device),
                    "c_proj": _dense(sd, h + "mlp.c_proj.", L, dtype, device)},
        },
        "ln_f": {"scale": _tensor(sd[prefix + "ln_f.weight"], dtype, device),
                 "bias": _tensor(sd[prefix + "ln_f.bias"], dtype, device)},
    }


def clip_vit_from_hf(sd, prefix: str = TOWER_PREFIX, *, dtype=None, device="cpu") -> dict:
    """The reference VisionTransformer weights: conv1 (W, 3, P, P) becomes the
    (3*P*P, W) patchify matmul, fused in_proj (3W, W) becomes (W, 3W)."""
    L = _n_layers(sd, prefix + "transformer.resblocks.")
    r = prefix + "transformer.resblocks.{}."
    conv = np.asarray(sd[prefix + "conv1.weight"])
    return {
        "patch_embed": _tensor(conv.reshape(conv.shape[0], -1).T, dtype, device),
        "class_embedding": _tensor(sd[prefix + "class_embedding"], dtype, device),
        "positional_embedding": _tensor(sd[prefix + "positional_embedding"], dtype, device),
        "ln_pre": {"scale": _tensor(sd[prefix + "ln_pre.weight"], dtype, device),
                   "bias": _tensor(sd[prefix + "ln_pre.bias"], dtype, device)},
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
    norm = {"scale": _tensor(g("norm.weight"), dtype, device),
            "bias": _tensor(g("norm.bias"), dtype, device)}
    if prefix + "norm.running_mean" in sd:
        norm["running_mean"] = _tensor(g("norm.running_mean"), torch.float32, device)
        norm["running_var"] = _tensor(g("norm.running_var"), torch.float32, device)
    return {
        "c_fc": {"kernel": _tensor(np.asarray(g("c_fc.weight")).T, dtype, device),
                 "bias": _tensor(g("c_fc.bias"), dtype, device)},
        "c_proj": {"kernel": _tensor(np.asarray(g("c_proj.weight")).T, dtype, device),
                   "bias": _tensor(g("c_proj.bias"), dtype, device)},
        "norm": norm,
    }


def from_hf_state_dict(sd: Mapping[str, np.ndarray], *, dtype: torch.dtype | None = None,
                       device="cpu") -> dict:
    """A StarVector-1B HF state dict -> the port's parameters."""
    sd = _strip_model(sd)
    params = {"svg_transformer": gpt_bigcode_from_hf(sd, dtype=dtype, device=device)}
    if TOWER_PREFIX + "conv1.weight" in sd:
        params["image_encoder"] = {
            "visual_encoder": clip_vit_from_hf(sd, dtype=dtype, device=device),
            "ln_vision": {"scale": _tensor(sd["image_encoder.ln_vision.weight"], dtype, device),
                          "bias": _tensor(sd["image_encoder.ln_vision.bias"], dtype, device)},
        }
        params["image_projection"] = adapter_from_hf(sd, dtype=dtype, device=device)
    return params


def config_from_hf(sd: Mapping[str, np.ndarray], hf_cfg: dict) -> sv.StarVectorConfig:
    """StarVectorConfig from the weights' shapes and config.json."""
    name = str(hf_cfg.get("starcoder_model_name", "")) + str(hf_cfg.get("_name_or_path", ""))
    if "starcoder2" in name:
        raise NotImplementedError("StarVector-8B (StarCoder2) is not ported yet "
                                  "(ROADMAP queue 1, item 6)")
    sd = _strip_model(sd)
    vocab, _ = np.shape(sd[DECODER_PREFIX + "wte.weight"])
    n_pos, hidden = np.shape(sd[DECODER_PREFIX + "wpe.weight"])
    attn_out = np.shape(sd[DECODER_PREFIX + "h.0.attn.c_attn.weight"])[0]
    head_dim = max((attn_out - hidden) // 2, 1)  # MQA: E + 2 * head_dim
    llm = gpt_bigcode.GPTBigCodeConfig(
        vocab_size=vocab, n_positions=n_pos, hidden_size=hidden,
        n_layer=_n_layers(sd, DECODER_PREFIX + "h."), n_head=max(hidden // head_dim, 1))
    base = sv.tiny_config() if hf_cfg.get("preset") == "tiny" else sv.starvector_1b_config()
    overrides = {k: hf_cfg[k] for k in ("image_encoder_type", "adapter_norm", "image_size", "task")
                 if k in hf_cfg}
    cfg = dataclasses.replace(base, llm=llm, **overrides)
    if cfg.use_image_encoder:
        width, _, patch, _ = np.shape(sd[TOWER_PREFIX + "conv1.weight"])
        grid = math.isqrt(np.shape(sd[TOWER_PREFIX + "positional_embedding"])[0] - 1)
        heads = hf_cfg.get("vision_geometry", {}).get("heads")
        if heads is None:  # not recoverable from shapes: CLIP's head_dim-64 convention
            heads = max(width // (64 if width % 64 == 0 else 16), 1)
        tower = CLIPViTConfig(image_size=grid * patch, patch_size=patch, width=width,
                              layers=_n_layers(sd, TOWER_PREFIX + "transformer.resblocks."),
                              heads=heads)
        cfg = dataclasses.replace(cfg, vision_tower=tower)
    return cfg
