"""The port's parameters back to the reference HF state-dict layout (port of
starvector_tpu/models/export.py, the inverse of models/convert.py).

Each function takes the port's tensors (any device) and returns numpy
arrays under the reference's names: dense kernels transposed back to torch
Linear's (out, in), stacked layer axes unstacked into per-layer keys, the
1B's fused MQA `c_attn` kept fused, a conv patch embedding rebuilt from the
patchify matmul. numpy has no bfloat16: bf16 tensors are written as fp32,
as the JAX package's torch_state_dict_to_numpy reads them.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x).T)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return _np(tree)


def _stacked(sd: dict, fmt: str, L: int, dense: dict, norm: dict) -> None:
    """Per-layer keys fmt.format(i) + name of the stacked dense leaves
    ({name: {"kernel", "bias"}}, transposed) and norms ({name: {"scale",
    "bias"}})."""
    for i in range(L):
        base = fmt.format(i)
        for name, p in dense.items():
            sd[base + name + ".weight"] = _t(p["kernel"][i])
            if "bias" in p:
                sd[base + name + ".bias"] = np.asarray(p["bias"][i])
        for name, p in norm.items():
            sd[base + name + ".weight"] = np.asarray(p["scale"][i])
            sd[base + name + ".bias"] = np.asarray(p["bias"][i])


def gpt_bigcode_to_hf(params: dict, cfg, prefix: str = "transformer.") -> dict:
    """The 1B decoder: wte, wpe, h.<i>.{ln_1, attn.c_attn, attn.c_proj,
    ln_2, mlp.c_fc, mlp.c_proj}, ln_f. Tied: no lm_head key."""
    params = _numpy_tree(params)
    sd: dict[str, np.ndarray] = {prefix + "wte.weight": params["wte"],
                                 prefix + "wpe.weight": params["wpe"]}
    layers = params["layers"]
    _stacked(sd, prefix + "h.{}.", cfg.n_layer,
             {"attn.c_attn": layers["attn"]["c_attn"], "attn.c_proj": layers["attn"]["c_proj"],
              "mlp.c_fc": layers["mlp"]["c_fc"], "mlp.c_proj": layers["mlp"]["c_proj"]},
             {"ln_1": layers["ln_1"], "ln_2": layers["ln_2"]})
    sd[prefix + "ln_f.weight"] = params["ln_f"]["scale"]
    sd[prefix + "ln_f.bias"] = params["ln_f"]["bias"]
    return sd


def starcoder2_to_hf(params: dict, cfg, prefix: str = "model.") -> dict:
    """The 8B decoder: embed_tokens, layers.<i>.{input_layernorm,
    self_attn.{q,k,v,o}_proj, post_attention_layernorm, mlp.c_fc,
    mlp.c_proj}, norm; an untied head as lm_head.weight, a sibling of the
    "model." subtree."""
    params = _numpy_tree(params)
    sd: dict[str, np.ndarray] = {prefix + "embed_tokens.weight": params["embed_tokens"]}
    layers = params["layers"]
    attn = {f"self_attn.{n}": layers["attn"][n] for n in ("q_proj", "k_proj", "v_proj", "o_proj")}
    _stacked(sd, prefix + "layers.{}.", cfg.num_hidden_layers,
             {**attn, "mlp.c_fc": layers["mlp"]["c_fc"], "mlp.c_proj": layers["mlp"]["c_proj"]},
             {"input_layernorm": layers["input_layernorm"],
              "post_attention_layernorm": layers["post_attention_layernorm"]})
    sd[prefix + "norm.weight"] = params["norm"]["scale"]
    sd[prefix + "norm.bias"] = params["norm"]["bias"]
    if "lm_head" in params:
        head_prefix = prefix[:-len("model.")] if prefix.endswith("model.") else prefix
        sd[head_prefix + "lm_head.weight"] = params["lm_head"]
    return sd


def _conv(kernel: np.ndarray) -> np.ndarray:
    """The (3*P*P, W) patchify matmul as the conv weight (W, 3, P, P)."""
    W = kernel.shape[1]
    p = int(np.sqrt(kernel.shape[0] // 3))
    return np.ascontiguousarray(kernel.T.reshape(W, 3, p, p))


def _siglip_to_hf(enc: dict, pfx: str) -> dict:
    """The 8B tower under HF SiglipVisionModel.vision_model's names (the
    reference's visual_encoder is that vision_model: no 'vision_model.')."""
    sd = {pfx + "embeddings.patch_embedding.weight": _conv(enc["patch_embed"]["kernel"]),
          pfx + "embeddings.patch_embedding.bias": enc["patch_embed"]["bias"],
          pfx + "embeddings.position_embedding.weight": enc["position_embedding"]}
    layers = enc["layers"]
    _stacked(sd, pfx + "encoder.layers.{}.", layers["layer_norm1"]["scale"].shape[0],
             {**{f"self_attn.{n}": layers["attn"][n]
                 for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
              "mlp.fc1": layers["mlp"]["fc1"], "mlp.fc2": layers["mlp"]["fc2"]},
             {"layer_norm1": layers["layer_norm1"], "layer_norm2": layers["layer_norm2"]})
    sd[pfx + "post_layernorm.weight"] = enc["post_layernorm"]["scale"]
    sd[pfx + "post_layernorm.bias"] = enc["post_layernorm"]["bias"]
    return sd


def _clip_to_hf(enc: dict, pfx: str) -> dict:
    """The 1B tower under the reference VisionTransformer's names (fused
    in_proj, conv1)."""
    sd = {pfx + "conv1.weight": _conv(enc["patch_embed"]),
          pfx + "class_embedding": enc["class_embedding"],
          pfx + "positional_embedding": enc["positional_embedding"],
          pfx + "ln_pre.weight": enc["ln_pre"]["scale"],
          pfx + "ln_pre.bias": enc["ln_pre"]["bias"]}
    layers = enc["layers"]
    L = layers["ln_1"]["scale"].shape[0]
    _stacked(sd, pfx + "transformer.resblocks.{}.", L,
             {"attn.out_proj": layers["attn"]["out_proj"], "mlp.c_fc": layers["mlp"]["c_fc"],
              "mlp.c_proj": layers["mlp"]["c_proj"]},
             {"ln_1": layers["ln_1"], "ln_2": layers["ln_2"]})
    for i in range(L):
        base = pfx + f"transformer.resblocks.{i}."
        sd[base + "attn.in_proj_weight"] = _t(layers["attn"]["in_proj"]["kernel"][i])
        sd[base + "attn.in_proj_bias"] = np.asarray(layers["attn"]["in_proj"]["bias"][i])
    return sd


def vision_to_hf(params: dict, cfg) -> dict:
    """The tower and the adapter under the reference's names
    (model.image_encoder.visual_encoder.*, model.image_encoder.ln_vision.*
    for CLIP, model.image_projection.*): CLIP (the 1B) or siglip_* (the 8B);
    other towers are load-only in the JAX package too."""
    params = _numpy_tree({k: params[k] for k in ("image_encoder", "image_projection")})
    enc = params["image_encoder"]["visual_encoder"]
    pfx = "model.image_encoder.visual_encoder."
    if cfg.image_encoder_type.startswith("siglip"):
        sd = _siglip_to_hf(enc, pfx)
    elif cfg.image_encoder_type == "clip":
        sd = _clip_to_hf(enc, pfx)
        ln = params["image_encoder"]["ln_vision"]
        sd["model.image_encoder.ln_vision.weight"] = ln["scale"]
        sd["model.image_encoder.ln_vision.bias"] = ln["bias"]
    else:
        raise NotImplementedError(
            f"vision export for {cfg.image_encoder_type!r} not implemented; "
            "clip (1B) and siglip (8B) towers are")
    sd.update(_adapter_to_hf(params["image_projection"]))
    return sd


def _adapter_to_hf(ad: dict, apfx: str = "model.image_projection.") -> dict:
    sd: dict[str, np.ndarray] = {}
    for mm in ("c_fc", "c_proj"):
        sd[apfx + mm + ".weight"] = _t(ad[mm]["kernel"])
        sd[apfx + mm + ".bias"] = ad[mm]["bias"]
    sd[apfx + "norm.weight"] = ad["norm"]["scale"]
    sd[apfx + "norm.bias"] = ad["norm"]["bias"]
    if "running_mean" in ad["norm"]:
        sd[apfx + "norm.running_mean"] = ad["norm"]["running_mean"]
        sd[apfx + "norm.running_var"] = ad["norm"]["running_var"]
        # torch BatchNorm1d serializes this counter; strict torch loads need it
        sd[apfx + "norm.num_batches_tracked"] = np.asarray(
            ad["norm"].get("num_batches_tracked", 0), np.int64)
    return sd


def save_safetensors(sd: dict, path: str) -> None:
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)
