"""Weight carry-over into the port: from_jax_params, and the reference HF
layout that starvector_tpu/models/export.py writes, through
from_hf_state_dict, config_from_hf and StarVectorForCausalLM.from_pretrained."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from starvector_tpu.models import export
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starvector as jsv
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.config_from_hf({}, {"starcoder_model_name": "bigcode/starcoder2-7b"})


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
