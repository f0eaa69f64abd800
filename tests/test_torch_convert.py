"""Weight carry-over into the port: from_jax_params, and the reference HF
layout that starvector_tpu/models/export.py writes, through
from_hf_state_dict, config_from_hf and StarVectorForCausalLM.from_pretrained,
for StarVector-1B (GPTBigCode, CLIP) and StarVector-8B (StarCoder2, SigLIP,
tied or untied head)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from starvector_tpu.models import export
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.models.vision import siglip as jsig
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import convert


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def jax_model():
    cfg = jsv.tiny_config(image_size=56, adapter_norm="batch_norm",
                          llm=jgbc.tiny_config(attn_impl="mixed"))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree["image_projection"]["norm"]["running_mean"] = rng.standard_normal(65).astype(np.float32)
    tree["image_projection"]["norm"]["running_var"] = (1 + rng.random(65)).astype(np.float32)
    return cfg, tree


def test_from_jax_params_keeps_tree_and_values(jax_model):
    _, tree = jax_model
    params = convert.from_jax_params(tree)
    ref = dict(_leaves(tree))
    out = dict(_leaves(params))
    assert out.keys() == ref.keys()
    for k, v in out.items():
        assert isinstance(v, torch.Tensor) and tuple(v.shape) == ref[k].shape, k
        np.testing.assert_array_equal(v.numpy(), ref[k])
    bf16 = convert.from_jax_params(tree, dtype=torch.bfloat16)
    assert bf16["svg_transformer"]["wte"].dtype == torch.bfloat16
    assert bf16["image_projection"]["norm"]["running_var"].dtype == torch.float32


def _export(cfg, tree, prefix="model."):
    sd = export.gpt_bigcode_to_hf(tree["svg_transformer"], cfg.llm,
                                  prefix=prefix + "svg_transformer.transformer.transformer.")
    sd.update(export.vision_to_hf(tree, cfg))
    return sd


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_hf_state_dict_round_trip(jax_model, prefix):
    """export.py's HF layout loads into exactly the from_jax_params tree."""
    cfg, tree = jax_model
    sd = _export(cfg, tree)
    if not prefix:
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    params = convert.from_hf_state_dict(sd)
    ref = dict(_leaves(convert.from_jax_params(tree)))
    out = dict(_leaves(params))
    assert out.keys() == ref.keys()
    for k, v in out.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


def test_config_from_hf_derives_geometry(jax_model):
    cfg, tree = jax_model
    hf_cfg = {"starcoder_model_name": "bigcode/starcoderbase-1b", "vision_geometry": {"heads": 4},
              "image_encoder_type": "clip", "adapter_norm": "batch_norm", "image_size": 56,
              "max_length": 128, "task": "im2svg"}
    tcfg = convert.config_from_hf(_export(cfg, tree), hf_cfg)
    for f in ("vocab_size", "n_positions", "hidden_size", "n_layer", "n_head", "kv_heads"):
        assert getattr(tcfg.llm, f) == getattr(cfg.llm, f), f
    jtower = jsv._encoder_cfg(cfg)[1]
    for f in dataclasses.fields(tcfg.vision_tower):
        assert getattr(tcfg.vision_tower, f.name) == getattr(jtower, f.name), f.name
    assert (tcfg.adapter_norm, tcfg.image_size, tcfg.task) == ("batch_norm", 56, "im2svg")
    # a StarCoder2 checkpoint name gives the 8B's geometry (untied, from the weights)
    cfg8, tree8 = _jax_8b_model(tied=False)
    tcfg8 = convert.config_from_hf(_export_8b(cfg8, tree8), _hf_cfg_8b(cfg8))
    assert (tcfg8.decoder, tcfg8.llm.vocab_size, tcfg8.llm.kv_heads) == ("starcoder2", 517, 2)
    assert not tcfg8.llm.tie_word_embeddings and tcfg8.llm.sliding_window == 16


def test_from_pretrained_loads_an_exported_checkpoint(jax_model, tmp_path):
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu.train.hub import export_hf_checkpoint
    from starvector_tpu_torch.api import StarVectorForCausalLM

    cfg, tree = jax_model
    export_hf_checkpoint(tree, cfg, build_test_tokenizer("v1"), str(tmp_path))
    model = StarVectorForCausalLM.from_pretrained(str(tmp_path), dtype=torch.float32,
                                                  device="cpu")
    assert model.cfg.vision_tower.num_tokens == 65 and model.cfg.llm.n_layer == cfg.llm.n_layer
    np.testing.assert_array_equal(model.params["svg_transformer"]["wte"].numpy(),
                                  tree["svg_transformer"]["wte"])
    img = np.random.default_rng(1).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    text = model.generate_im2svg({"image": model.process_images([img])}, max_length=6,
                                 use_nucleus_sampling=False)
    assert len(text) == 1 and text[0].startswith("<svg")


def _jax_8b_model(tied: bool):
    """A tiny 8B-shaped JAX model: StarCoder2 with 4 query heads over 2 KV
    heads, a vocabulary of 517 (the reference adds special tokens to the
    base 49152: the loader reads it from the weights), rope_theta 5e5 and a
    window of 16 (both through llm_geometry), a tiny SigLIP tower."""
    cfg = jsv.tiny_config(
        decoder="starcoder2", image_encoder_type="siglip_384", image_size=32,
        adapter_norm="layer_norm", vision_tower=jsig.tiny_config(),
        llm=jsc.tiny_config(vocab_size=517, rope_theta=5e5, sliding_window=16,
                            tie_word_embeddings=tied, max_position_embeddings=16384))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    tree["image_projection"]["norm"]["scale"] = (
        1 + 0.1 * rng.standard_normal((16, 64))).astype(np.float32)
    return cfg, tree


def _export_8b(cfg, tree):
    sd = export.starcoder2_to_hf(tree["svg_transformer"], cfg.llm,
                                 prefix="model.svg_transformer.transformer.model.")
    sd.update(export.vision_to_hf(tree, cfg))
    return sd


def _hf_cfg_8b(cfg):
    """config.json as starvector_tpu/train/hub.py writes it."""
    return {"starcoder_model_name": "bigcode/starcoder2-7b", "vision_geometry": {"heads": 4},
            "llm_geometry": {"head_dim": cfg.llm.head_dim, "rope_theta": cfg.llm.rope_theta,
                             "sliding_window": cfg.llm.sliding_window},
            "image_encoder_type": "siglip_384", "adapter_norm": "layer_norm", "image_size": 32,
            "max_length": 128, "task": "im2svg"}


@pytest.mark.parametrize("tied", [True, False])
def test_8b_hf_round_trip_gives_the_same_model(tied):
    """JAX tiny-8B params -> export.starcoder2_to_hf + vision_to_hf -> the
    port's config_from_hf / from_hf_state_dict: the same geometry (vocab from
    the weights, KV heads, the head tied or not, window and rope_theta from
    llm_geometry, the tower from the weights), the from_jax_params tree, and
    the JAX model's prefill logits on an image (2e-4, fp32)."""
    from starvector_tpu_torch.generation.engine import im2svg_prefix
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

    cfg, tree = _jax_8b_model(tied)
    sd = _export_8b(cfg, tree)
    assert ("model.svg_transformer.transformer.lm_head.weight" in sd) == (not tied)
    tcfg = convert.config_from_hf(sd, _hf_cfg_8b(cfg))
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim", "rope_theta",
              "sliding_window", "tie_word_embeddings", "max_position_embeddings"):
        assert getattr(tcfg.llm, f) == getattr(cfg.llm, f), f
    for f in dataclasses.fields(tcfg.vision_tower):
        assert getattr(tcfg.vision_tower, f.name) == getattr(cfg.vision_tower, f.name), f.name
    assert (tcfg.decoder, tcfg.image_encoder_type, tcfg.adapter_norm) == \
        ("starcoder2", "siglip_384", "layer_norm")
    assert tcfg.encoder_config.geometry == (32, 16)
    params = convert.from_hf_state_dict(sd)
    ref = dict(_leaves(convert.from_jax_params(tree)))
    out = dict(_leaves(params))
    assert out.keys() == ref.keys()
    for k, v in out.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)

    images = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    prompt = np.array([[60, 116, 119, 104]] * 2, np.int32)
    f32 = JPolicy(compute_dtype=jax.numpy.float32)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    cond = jsv.encode_image(jp, cfg, jax.numpy.asarray(images), policy=f32)
    emb = jax.numpy.concatenate([cond, jsc.embed_tokens(jp["svg_transformer"], prompt)], 1)
    S = emb.shape[1]
    cache = jsc.init_cache(cfg.llm, 2, S, dtype=jax.numpy.float32)
    jl, _ = jsc.forward(jp["svg_transformer"], cfg.llm, emb, cache=cache, policy=f32)
    t32 = TPolicy(compute_dtype=torch.float32)
    temb, mask = im2svg_prefix(params, tcfg, torch.from_numpy(images),
                               torch.from_numpy(prompt).long(), policy=t32)
    tl, _ = tsc.forward(params["svg_transformer"], tcfg.llm, temb, mask,
                        cache=tsc.init_cache(tcfg.llm, 2, S, dtype=torch.float32), policy=t32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)


def test_from_pretrained_loads_an_exported_8b_checkpoint(tmp_path):
    """An 8B checkpoint written by the JAX package's hub export loads with
    the v2 tokenizer (<svg-end>, left padding), as the JAX API chooses it,
    and generates; with quantize=True (refused before the 8B's int8 path
    was ported) it loads the decoder through quantize_tree, as the JAX
    from_pretrained does, and generates too."""
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu.train.hub import export_hf_checkpoint
    from starvector_tpu_torch.api import StarVectorForCausalLM

    cfg, tree = _jax_8b_model(tied=False)
    export_hf_checkpoint(tree, cfg, build_test_tokenizer("v2"), str(tmp_path))
    model = StarVectorForCausalLM.from_pretrained(str(tmp_path), dtype=torch.float32,
                                                  device="cpu")
    assert model.cfg.decoder == "starcoder2" and "lm_head" in model.params["svg_transformer"]
    assert model.tokenizer.version == "v2" and model.tokenizer.padding_side == "left"
    img = np.random.default_rng(1).integers(0, 256, (40, 30, 3), dtype=np.uint8)
    text = model.generate_im2svg({"image": model.process_images([img])}, max_length=6,
                                 use_nucleus_sampling=False)
    assert len(text) == 1 and text[0].startswith("<svg")
    from starvector_tpu_torch.ops.quantization import quantize_tree

    q = StarVectorForCausalLM.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu",
                                              quantize=True)
    ref = dict(_leaves(quantize_tree(model.params["svg_transformer"], consume=False)))
    out = dict(_leaves(q.params["svg_transformer"]))
    assert out.keys() == ref.keys()
    for k, v in out.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)
    text = q.generate_im2svg({"image": q.process_images([img])}, max_length=6,
                             use_nucleus_sampling=False)
    assert len(text) == 1 and text[0].startswith("<svg")


def test_8b_weights_quantize_as_the_jax_package():
    """A tiny 8B-shaped decoder carried across in the HF layout
    (export.starcoder2_to_hf -> from_hf_state_dict), its projections scaled
    by 10, quantized by the port and by the JAX package (min_elems=1<<12
    takes all six a layer): codes and scales equal bit for bit."""
    from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree
    from starvector_tpu_torch.ops.quantization import quantize_tree

    cfg, tree = _jax_8b_model(tied=True)
    st = tree["svg_transformer"]
    for grp in st["layers"]["attn"], st["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    ref = jax.tree_util.tree_map(np.asarray, jquantize_tree(st, min_elems=1 << 12,
                                                            consume=False))
    params = convert.from_hf_state_dict(_export_8b(cfg, tree))
    ours = quantize_tree(params["svg_transformer"], min_elems=1 << 12)
    names = [(grp, name) for grp in ("attn", "mlp") for name in st["layers"][grp]]
    assert len(names) == 6
    for grp, name in names:
        for key in ("kernel_q", "scale", "bias"):
            np.testing.assert_array_equal(ours["layers"][grp][name][key].numpy(),
                                          ref["layers"][grp][name][key], err_msg=f"{name} {key}")


def test_quantize_tree_takes_the_8b_six_projections():
    """At StarVector-8B's shapes (meta tensors: no memory), quantize_tree at
    its default threshold takes all six stacked projections of a layer,
    each with (32, N) scales and its bias, and leaves the embeddings and
    the norms alone, as the JAX package's quantize_tree does."""
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.ops.quantization import quantize_tree

    cfg = tsc.starcoder2_7b_config()
    L, E, F = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.kv_heads * cfg.head_dim
    shapes = {("attn", "q_proj"): (E, E), ("attn", "k_proj"): (E, kvd),
              ("attn", "v_proj"): (E, kvd), ("attn", "o_proj"): (E, E),
              ("mlp", "c_fc"): (E, F), ("mlp", "c_proj"): (F, E)}
    meta = dict(device="meta")
    layers = {"input_layernorm": {"scale": torch.empty((L, E), **meta),
                                  "bias": torch.empty((L, E), **meta)},
              "attn": {}, "mlp": {}}
    for (grp, name), (K, N) in shapes.items():
        layers[grp][name] = {"kernel": torch.empty((L, K, N), **meta),
                             "bias": torch.empty((L, N), **meta)}
    tree = {"embed_tokens": torch.empty((cfg.vocab_size, E), **meta), "layers": layers,
            "norm": {"scale": torch.empty((E,), **meta), "bias": torch.empty((E,), **meta)}}
    out = quantize_tree(tree)
    assert kvd == 512  # the K/V projections are 4608 x 512
    for (grp, name), (K, N) in shapes.items():
        leaf = out["layers"][grp][name]
        assert set(leaf) == {"kernel_q", "scale", "bias"}, name
        assert leaf["kernel_q"].dtype == torch.int8 and leaf["kernel_q"].shape == (L, K, N)
        assert leaf["scale"].shape == (L, N), name
    assert out["embed_tokens"] is tree["embed_tokens"] and "kernel_q" not in out["norm"]
    assert set(out["layers"]["input_layernorm"]) == {"scale", "bias"}


@pytest.mark.parametrize("decoder", ["gpt_bigcode", "starcoder2"])
def test_max_length_survives_a_checkpoint(decoder, tmp_path):
    """A checkpoint's config.json `max_length` (written by the JAX package's
    hub export from max_length_train) loads as max_length_train in both
    packages. The port's config_from_hf used to drop it, so a checkpoint
    trained at 1024 loaded as the preset's 8192 (1B) or 16000 (8B), and
    train.main from it truncated SVGs at another length than the JAX main."""
    from starvector_tpu.models.builder import load_hf_starvector_checkpoint
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu.train.hub import export_hf_checkpoint
    from starvector_tpu_torch.api import StarVectorForCausalLM

    if decoder == "gpt_bigcode":
        cfg = jsv.tiny_config(image_size=56, llm=jgbc.tiny_config(attn_impl="mixed"))
        tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(0)))
    else:
        cfg, tree = _jax_8b_model(tied=True)
    cfg = dataclasses.replace(cfg, max_length_train=1024)
    version = "v2" if decoder == "starcoder2" else "v1"
    export_hf_checkpoint(tree, cfg, build_test_tokenizer(version), str(tmp_path))
    assert load_hf_starvector_checkpoint(str(tmp_path))[1].max_length_train == 1024
    model = StarVectorForCausalLM.from_pretrained(str(tmp_path), dtype=torch.float32,
                                                  device="cpu")
    assert model.cfg.max_length_train == 1024
