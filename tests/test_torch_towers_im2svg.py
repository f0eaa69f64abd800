"""The other vision towers behind a tiny StarVector, port against the JAX
package, in fp32:

  * for each of vqgan, convnext, open-clip, siglip_512 and siglip_256 (a
    `vision_tower=` override): JAX sv.init_params, then
    convert.from_jax_params, then greedy im2svg ids through both packages'
    generate_im2svg, which must be identical;
  * the builders' fourth branch: a StarVector checkpoint directory whose
    tower keys are in the tower's own layout (taming for vqgan, open_clip for
    convnext and open-clip) loads through both packages'
    load_hf_starvector_checkpoint to the same config and the same logits
    (atol=rtol 1e-5). That branch takes the stock tower whatever the
    weights, so both packages' stock configs are shrunk to the tiny towers
    for the test (monkeypatch);
  * export refuses the three towers in both packages;
  * the geometry rule: a tower override without `num_tokens` (vqgan,
    convnext) takes the stock table's (hidden, tokens), in both packages, so
    a tiny whole model with such a tower fails in both unless its tower
    gives the stock width and token count (the fixtures' vqgan gives 196
    tokens of 256, convnext 49 of 1024).

At random init a tiny decoder echoes one token, so its projection kernels
are scaled by 10 (as tests/test_torch_im2svg.py does)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import adapter as jadapter
from starvector_tpu.models import builder as jbuilder
from starvector_tpu.models import export as jexport
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import image_encoder as jie
from starvector_tpu.models import starvector as jsv
from starvector_tpu.models.tokenizer import build_test_tokenizer
from starvector_tpu.models.vision import convnext as jcnx
from starvector_tpu.models.vision import open_clip_vit as joc
from starvector_tpu.models.vision import siglip as jsig
from starvector_tpu.models.vision import vqgan as jvq
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu.train.hub import export_hf_checkpoint
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import builder as tbuilder
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import export as texport
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import image_encoder as tie
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.vision import convnext as tcnx
from starvector_tpu_torch.models.vision import open_clip_vit as toc
from starvector_tpu_torch.models.vision import siglip as tsig
from starvector_tpu_torch.models.vision import vqgan as tvq
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from test_torch_vision_towers import convnext_sd, open_clip_sd, taming_sd

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
PROMPT = [60, 116, 119, 104]
NEW = 16

# name -> (image size, JAX tower, port tower): the stock (hidden, tokens)
# for vqgan and convnext, whose overrides cannot state their own
TOWERS = {
    "vqgan": (28, jvq.tiny_config(z_channels=256), tvq.tiny_config(z_channels=256)),
    "convnext": (56, jcnx.tiny_config(dims=(8, 1024)), tcnx.tiny_config(dims=(8, 1024))),
    "open-clip": (28, joc.tiny_config(), toc.tiny_config()),
    "siglip_512": (32, jsig.tiny_config(), tsig.tiny_config()),
    "siglip_256": (16, jsig.tiny_config(image_size=16, patch_size=4),
                   tsig.tiny_config(image_size=16, patch_size=4)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(TOWERS))
def model(request):
    """(name, JAX config, port config, the JAX weights as numpy, images,
    JAX's greedy tokens and lengths)."""
    size, jtower, ttower = TOWERS[request.param]
    llm = dict(n_positions=256)
    jcfg = jsv.tiny_config(image_encoder_type=request.param, image_size=size,
                           vision_tower=jtower, llm=jgbc.tiny_config(**llm))
    tcfg = tsv.tiny_config(image_encoder_type=request.param, image_size=size,
                           vision_tower=ttower, llm=tgbc.tiny_config(**llm))
    tree = _np_tree(jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    images = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    gen = jengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    tokens, lengths = jengine.generate_im2svg(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(images),
        jnp.asarray([PROMPT] * 2, jnp.int32), gen, jax.random.PRNGKey(1), policy=JF32)
    return request.param, jcfg, tcfg, tree, images, np.asarray(tokens), np.asarray(lengths)


def test_greedy_im2svg_ids_match_jax(model):
    name, jcfg, tcfg, tree, images, ref_tokens, ref_lengths = model
    assert tcfg.query_length == jcfg.query_length
    params = convert.from_jax_params(tree)
    assert tcfg.encoder_config.geometry == jcfg.encoder_config.geometry
    gen = tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    tokens, lengths = tengine.generate_im2svg(params, tcfg, torch.from_numpy(images),
                                              torch.tensor([PROMPT] * 2), gen, policy=TF32)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_array_equal(lengths.numpy(), ref_lengths)
    assert all(len(set(row.tolist())) >= 3 for row in ref_tokens), ref_tokens


@pytest.mark.parametrize("name", ["vqgan", "convnext", "open-clip"])
def test_export_refuses_the_other_towers(name):
    size, jtower, ttower = TOWERS[name]
    tcfg = tsv.tiny_config(image_encoder_type=name, image_size=size, vision_tower=ttower)
    params = tsv.init_params(tcfg, torch.Generator().manual_seed(0))
    jcfg = jsv.tiny_config(image_encoder_type=name, image_size=size, vision_tower=jtower)
    with pytest.raises(NotImplementedError, match=name):
        jexport.vision_to_hf(params, jcfg)
    with pytest.raises(NotImplementedError, match=name):
        texport.vision_to_hf(params, tcfg)


@pytest.mark.parametrize("enc_mod", [jie, tie], ids=["jax", "port"])
def test_tower_override_without_num_tokens_takes_the_stock_geometry(enc_mod):
    vq, cnx, oc = ((jvq, jcnx, joc) if enc_mod is jie else (tvq, tcnx, toc))
    assert enc_mod.ImageEncoderConfig("vqgan", 28, tower=vq.tiny_config()).geometry == (256, 196)
    assert enc_mod.ImageEncoderConfig("convnext", 32,
                                      tower=cnx.tiny_config()).geometry == (1024, 49)
    assert enc_mod.ImageEncoderConfig("open-clip", 28,
                                      tower=oc.tiny_config()).geometry == (32, 16)


def test_a_tiny_vqgan_of_its_own_width_fails_in_both_packages():
    """z_channels 16 against the table's 256: both packages size the
    adapter by the table and fail at its first product."""
    images = np.zeros((1, 28, 28, 3), np.float32)
    jcfg = jsv.tiny_config(image_encoder_type="vqgan", vision_tower=jvq.tiny_config())
    with pytest.raises(ValueError, match="does not match"):
        jsv.encode_image(jsv.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                         jnp.asarray(images), policy=JF32)
    tcfg = tsv.tiny_config(image_encoder_type="vqgan", vision_tower=tvq.tiny_config())
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        tsv.encode_image(tsv.init_params(tcfg, torch.Generator().manual_seed(0)), tcfg,
                         torch.from_numpy(images), policy=TF32)


# -- the builders' fourth branch ----------------------------------------------------

OWN_LAYOUT = {  # name -> (tower's own state dict, JAX tiny, port tiny, image size)
    "vqgan": (taming_sd, jvq.tiny_config(), tvq.tiny_config(), 28),
    "convnext": (convnext_sd, jcnx.tiny_config(), tcnx.tiny_config(), 32),
    "open-clip": (open_clip_sd, joc.tiny_config(), toc.tiny_config(), 28),
}
STOCK = {  # name -> (JAX module, port module, config class name)
    "vqgan": (jvq, tvq, "VQGANEncoderConfig"),
    "convnext": (jcnx, tcnx, "ConvNeXtConfig"),
    "open-clip": (joc, toc, "OpenCLIPViTConfig"),
}


def _tokens(name, tower, size):
    return (tower.num_tokens if name == "open-clip" else tower.tokens_for(size)), \
        (tower.width if name == "open-clip" else
         tower.z_channels if name == "vqgan" else tower.dims[-1])


@pytest.mark.parametrize("name", sorted(OWN_LAYOUT))
def test_builders_load_a_tower_in_its_own_layout(name, tmp_path, monkeypatch):
    make_sd, jtiny, ttiny, size = OWN_LAYOUT[name]
    jmod, tmod, cls = STOCK[name]
    # both packages' stock tower, shrunk to the tiny one
    stock = {"open-clip": lambda tiny: lambda **kw: dataclasses.replace(tiny, **kw)}.get(
        name, lambda tiny: lambda: tiny)
    monkeypatch.setattr(jmod, cls, stock(jtiny))
    monkeypatch.setattr(tmod, cls, stock(ttiny))
    jtiny = jie.ImageEncoderConfig(name, size).tower_config
    tokens, width = _tokens(name, jtiny, size)

    # a 1B checkpoint without a tower, then the tower's own keys, an adapter
    # of its geometry and (open-clip) an ln_vision that the branch ignores
    jcfg = jsv.tiny_config(image_size=size)
    tree = jsv.init_params(jcfg, jax.random.PRNGKey(0))
    tree.pop("image_encoder")
    tree.pop("image_projection")
    export_hf_checkpoint(tree, dataclasses.replace(jcfg, task="text2svg"),
                         build_test_tokenizer("v1"), str(tmp_path))
    from safetensors.numpy import load_file, save_file

    sd = load_file(str(tmp_path / "model.safetensors"))
    own = make_sd(jtiny, seed=7)
    prefix = tie.CHECKPOINT_PREFIX[name]
    sd.update({"model.image_encoder.visual_encoder." + k[len(prefix):]: v for k, v in own.items()})
    ad_cfg = jadapter.AdapterConfig(input_size=width, output_size=jcfg.hidden_size,
                                    query_length=tokens, adapter_norm="layer_norm")
    ad = _np_tree(jadapter.init_params(ad_cfg, jax.random.PRNGKey(3)))
    sd.update(jexport._adapter_to_hf(ad))
    if name == "open-clip":
        sd["model.image_encoder.ln_vision.weight"] = np.full(width, 2.0, np.float32)
        sd["model.image_encoder.ln_vision.bias"] = np.full(width, 0.5, np.float32)
    save_file(sd, str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    hf.update(image_encoder_type=name, task="im2svg", adapter_norm="layer_norm")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)

    jparams, jcfg, _ = jbuilder.load_hf_starvector_checkpoint(str(tmp_path), jnp.float32)
    tparams, tcfg, _ = tbuilder.load_hf_starvector_checkpoint(str(tmp_path), torch.float32,
                                                              device="cpu")
    assert (tcfg.image_encoder_type, tcfg.image_size, tcfg.adapter_norm, tcfg.decoder) == \
        (jcfg.image_encoder_type, jcfg.image_size, jcfg.adapter_norm, jcfg.decoder)
    assert type(tcfg.vision_tower).__name__ == type(jcfg.vision_tower).__name__
    assert dataclasses.asdict(tcfg.vision_tower) == dataclasses.asdict(jcfg.vision_tower)
    for f in ("vocab_size", "n_positions", "hidden_size", "n_layer", "n_head"):
        assert getattr(tcfg.llm, f) == getattr(jcfg.llm, f), f
    if name == "open-clip":  # the identity in both, whatever the checkpoint holds
        assert np.asarray(jparams["image_encoder"]["ln_vision"]["scale"]).tolist() == [1.0] * width
        assert tparams["image_encoder"]["ln_vision"]["scale"].tolist() == [1.0] * width

    images = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    ids = np.asarray([PROMPT] * 2, np.int32)
    cond = jsv.encode_image(jparams, jcfg, jnp.asarray(images), policy=JF32)
    emb = jnp.concatenate([cond, jgbc.embed_tokens(jparams["svg_transformer"],
                                                   jnp.asarray(ids))], axis=1)
    ref, _ = jgbc.forward(jparams["svg_transformer"], jcfg.llm, emb, policy=JF32)
    tcond = tsv.encode_image(tparams, tcfg, torch.from_numpy(images), policy=TF32)
    temb = torch.cat([tcond, tgbc.embed_tokens(tparams["svg_transformer"],
                                               torch.from_numpy(ids).long())], dim=1)
    out, _ = tgbc.forward(tparams["svg_transformer"], tcfg.llm, temb, policy=TF32)
    assert out.shape == (2, tokens + len(PROMPT), jcfg.llm.vocab_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
