"""The other vision towers against the JAX package: vqgan (taming),
convnext and open-clip (open_clip), siglip_512 and siglip_256 (HF SigLIP),
at tiny geometry.

Each tower's weights are a torch-layout state dict in the tower's own
source's naming, drawn from a numpy seed with non-trivial norms, biases
and layer scales; they go through the JAX package's loader and
image_encoder.forward and through the port's (params_from_checkpoint).
fp32 outputs agree to atol=rtol 1e-5; bf16 outputs to atol=rtol
4e-2 of JAX's bf16 forward (a few bf16 steps at the outputs' magnitude, up
to 4), and no further from JAX's fp32 output than twice JAX's own bf16
output is. Also: the stock geometry of all seven towers from their configs
alone, every tower's image processor against JAX's on one PIL image (2/255
in pixel units, the resize's rounding gap; tests/test_torch_vision_adapter.py),
and exact GELU in the port's clip_vit (act="gelu", open-clip's
activation), which the port's config lacked."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.data import processor as jproc
from starvector_tpu.models import image_encoder as jie
from starvector_tpu.models.vision import clip_vit as jvit
from starvector_tpu.models.vision import convnext as jcnx
from starvector_tpu.models.vision import open_clip_vit as joc
from starvector_tpu.models.vision import siglip as jsig
from starvector_tpu.models.vision import vqgan as jvq
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.data import processor as tproc
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import image_encoder as tie
from starvector_tpu_torch.models.vision import clip_vit as tvit
from starvector_tpu_torch.models.vision import convnext as tcnx
from starvector_tpu_torch.models.vision import open_clip_vit as toc
from starvector_tpu_torch.models.vision import siglip as tsig
from starvector_tpu_torch.models.vision import vqgan as tvq
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32, JBF16 = JPolicy(compute_dtype=jnp.float32), JPolicy(compute_dtype=jnp.bfloat16)
TF32, TBF16 = TPolicy(compute_dtype=torch.float32), TPolicy(compute_dtype=torch.bfloat16)
BF16_TOL = 4e-2
TYPES = ("clip", "open-clip", "vqgan", "convnext", "siglip_512", "siglip_384", "siglip_256")


class StateDict(dict):
    """A torch-layout state dict drawn from a numpy generator."""

    def __init__(self, seed: int, prefix: str):
        super().__init__()
        self.rng, self.prefix = np.random.default_rng(seed), prefix

    def weight(self, name, shape, fan_in):
        self[self.prefix + name] = (self.rng.standard_normal(shape)
                                    * fan_in ** -0.5).astype(np.float32)

    def vec(self, name, n, center=0.0, scale=0.1):
        self[self.prefix + name] = (center + scale * self.rng.standard_normal(n)).astype(np.float32)

    def conv(self, name, cin, cout, k, groups=1):
        self.weight(name + ".weight", (cout, cin // groups, k, k), k * k * cin // groups)
        self.vec(name + ".bias", cout)

    def linear(self, name, cin, cout, weight="weight", bias="bias"):
        self.weight(f"{name}{weight}", (cout, cin), cin)
        self.vec(f"{name}{bias}", cout)

    def norm(self, name, c):
        self.vec(name + ".weight", c, 1.0)
        self.vec(name + ".bias", c)


def taming_sd(cfg, seed=0) -> StateDict:
    """A taming Encoder's state dict at cfg's geometry, prefix "encoder."."""
    sd = StateDict(seed, "encoder.")

    def res(name, cin, cout):
        sd.norm(name + ".norm1", cin)
        sd.conv(name + ".conv1", cin, cout, 3)
        sd.norm(name + ".norm2", cout)
        sd.conv(name + ".conv2", cout, cout, 3)
        if cin != cout:
            sd.conv(name + ".nin_shortcut", cin, cout, 1)

    def attn(name, c):
        sd.norm(name + ".norm", c)
        for n in ("q", "k", "v", "proj_out"):
            sd.conv(f"{name}.{n}", c, c, 1)

    sd.conv("conv_in", 3, cfg.ch, 3)
    cin = cfg.ch
    for lvl, mult in enumerate(cfg.ch_mult):
        cout = cfg.ch * mult
        for i in range(cfg.num_res_blocks):
            res(f"down.{lvl}.block.{i}", cin, cout)
            if lvl in cfg.attn_levels:
                attn(f"down.{lvl}.attn.{i}", cout)
            cin = cout
        if lvl != len(cfg.ch_mult) - 1:
            sd.conv(f"down.{lvl}.downsample.conv", cout, cout, 3)
    res("mid.block_1", cin, cin)
    attn("mid.attn_1", cin)
    res("mid.block_2", cin, cin)
    sd.norm("norm_out", cin)
    sd.conv("conv_out", cin, cfg.z_channels, 3)
    return sd


def convnext_sd(cfg, seed=0) -> StateDict:
    """An open_clip ConvNeXt trunk's state dict, prefix "visual.trunk."."""
    sd = StateDict(seed, "visual.trunk.")
    sd.conv("stem.0", 3, cfg.dims[0], cfg.patch)
    sd.norm("stem.1", cfg.dims[0])
    for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        if si > 0:
            sd.norm(f"stages.{si}.downsample.0", cfg.dims[si - 1])
            sd.conv(f"stages.{si}.downsample.1", cfg.dims[si - 1], dim, 2)
        for bi in range(depth):
            b = f"stages.{si}.blocks.{bi}"
            sd.conv(b + ".conv_dw", dim, dim, 7, groups=dim)
            sd.norm(b + ".norm", dim)
            sd.linear(b + ".mlp.fc1.", dim, 4 * dim)
            sd.linear(b + ".mlp.fc2.", 4 * dim, dim)
            sd.vec(b + ".gamma", dim, 0.5)
    return sd


def open_clip_sd(cfg, seed=0) -> StateDict:
    """An open_clip VisionTransformer's state dict, prefix "visual."."""
    sd = StateDict(seed, "visual.")
    W, n = cfg.width, (cfg.image_size // cfg.patch_size) ** 2 + 1
    sd.weight("conv1.weight", (W, 3, cfg.patch_size, cfg.patch_size), 3 * cfg.patch_size ** 2)
    sd.vec("class_embedding", W, scale=W ** -0.5)
    sd.weight("positional_embedding", (n, W), W)
    sd.norm("ln_pre", W)
    for i in range(cfg.layers):
        r = f"transformer.resblocks.{i}."
        sd.norm(r + "ln_1", W)
        sd.linear(r + "attn.", W, 3 * W, weight="in_proj_weight", bias="in_proj_bias")
        sd.linear(r + "attn.out_proj.", W, W)
        sd.norm(r + "ln_2", W)
        sd.linear(r + "mlp.c_fc.", W, 4 * W)
        sd.linear(r + "mlp.c_proj.", 4 * W, W)
    sd.norm("ln_post", W)
    return sd


def siglip_sd(cfg, seed=0) -> StateDict:
    """An HF SiglipVisionModel's state dict, prefix "vision_model."."""
    sd = StateDict(seed, "vision_model.")
    W, P = cfg.hidden_size, cfg.patch_size
    sd.conv("embeddings.patch_embedding", 3, W, P)
    sd.weight("embeddings.position_embedding.weight", (cfg.num_tokens, W), W)
    for i in range(cfg.layers):
        r = f"encoder.layers.{i}."
        sd.norm(r + "layer_norm1", W)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.linear(f"{r}self_attn.{n}.", W, W)
        sd.norm(r + "layer_norm2", W)
        sd.linear(r + "mlp.fc1.", W, cfg.intermediate_size)
        sd.linear(r + "mlp.fc2.", cfg.intermediate_size, W)
    sd.norm("post_layernorm", W)
    return sd


# name -> (type, image size, JAX tiny tower, port tiny tower, state dict,
#          prefix of the tower's own checkpoint)
TOWERS = {
    "vqgan": ("vqgan", 28, jvq.tiny_config(), tvq.tiny_config(), taming_sd, ""),
    "convnext": ("convnext", 32, jcnx.tiny_config(), tcnx.tiny_config(), convnext_sd, ""),
    "open-clip": ("open-clip", 28, joc.tiny_config(), toc.tiny_config(), open_clip_sd, ""),
    # 12 heads of 4: the port's SigLIP at the base towers' head count
    "siglip_512": ("siglip_512", 32, jsig.tiny_config(hidden_size=48, heads=12),
                   tsig.tiny_config(hidden_size=48, heads=12), siglip_sd, "vision_model."),
    "siglip_256": ("siglip_256", 16, jsig.tiny_config(image_size=16, patch_size=4, heads=12,
                                                      hidden_size=48),
                   tsig.tiny_config(image_size=16, patch_size=4, heads=12, hidden_size=48),
                   siglip_sd, "vision_model."),
}


def jax_params_from_checkpoint(enc, sd, prefix):
    """The JAX package's loader of the tower: image_encoder.params_from_checkpoint,
    or for SigLIP its builder's siglip.from_hf_state_dict (the JAX
    params_from_checkpoint reaches siglip.from_torch_state_dict, which the
    JAX siglip module does not define)."""
    if enc.image_encoder_type.startswith("siglip"):
        return {"visual_encoder": jsig.from_hf_state_dict(sd, enc.tower_config, prefix=prefix)}
    return jie.params_from_checkpoint(enc, sd, prefix=prefix)


@pytest.fixture(scope="module", params=sorted(TOWERS))
def tower(request):
    """(name, JAX encoder config and params, port encoder config and params,
    images): open-clip's ln_vision made non-trivial in both."""
    t, size, jtower, ttower, make_sd, prefix = TOWERS[request.param]
    sd = make_sd(jtower, seed=3)
    jenc = jie.ImageEncoderConfig(t, size, tower=jtower)
    tenc = tie.ImageEncoderConfig(t, size, tower=ttower)
    jparams = jax_params_from_checkpoint(jenc, sd, prefix)
    tparams = tie.params_from_checkpoint(tenc, sd, prefix=prefix)
    if "ln_vision" in jparams:
        rng = np.random.default_rng(4)
        W = jparams["ln_vision"]["scale"].shape[0]
        ln = {"scale": (1 + 0.1 * rng.standard_normal(W)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(W)).astype(np.float32)}
        jparams["ln_vision"] = jax.tree_util.tree_map(jnp.asarray, ln)
        tparams["ln_vision"] = convert.from_jax_params(ln)
    images = np.random.default_rng(5).standard_normal((2, size, size, 3)).astype(np.float32)
    return request.param, jenc, jparams, tenc, tparams, images


def test_tower_loads_as_the_jax_package_does(tower):
    """The port's params_from_checkpoint gives the JAX loader's tree, leaf
    for leaf, bit for bit."""
    _, _, jparams, _, tparams, _ = tower
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jleaves}
    port = {jax.tree_util.keystr(k): v.numpy() for k, v in
            jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_tower_forward_fp32_matches_jax(tower):
    _, jenc, jparams, tenc, tparams, images = tower
    ref = np.asarray(jie.forward(jparams, jenc, jnp.asarray(images), policy=JF32))
    out = tie.forward(tparams, tenc, torch.from_numpy(images), policy=TF32).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_tower_forward_bf16_matches_jax(tower):
    _, jenc, jparams, tenc, tparams, images = tower
    x = jnp.asarray(images)
    ref32 = np.asarray(jie.forward(jparams, jenc, x, policy=JF32))
    ref = np.asarray(jie.forward(jparams, jenc, x, policy=JBF16).astype(jnp.float32))
    out = tie.forward(tparams, tenc, torch.from_numpy(images), policy=TBF16)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=BF16_TOL, atol=BF16_TOL)
    assert np.abs(out - ref32).max() <= 2 * np.abs(ref - ref32).max()


def test_siglip_params_from_checkpoint_in_the_jax_package_raises():
    """The JAX image_encoder.params_from_checkpoint reaches a
    from_torch_state_dict that its siglip module lacks; the port's loads the
    HF layout (test_tower_loads_as_the_jax_package_does)."""
    enc = jie.ImageEncoderConfig("siglip_512", 32, tower=jsig.tiny_config())
    with pytest.raises(AttributeError, match="from_torch_state_dict"):
        jie.params_from_checkpoint(enc, siglip_sd(jsig.tiny_config()), prefix="vision_model.")


def test_stock_geometry_from_configs_alone():
    """Every tower's (hidden, tokens) and stock config equal the JAX
    package's, without initialising a tower; the convolutional towers'
    tokens_for at 224 and the ViTs' num_tokens give the table's counts."""
    assert tie.ENCODER_GEOMETRY == jie.ENCODER_GEOMETRY
    for t in TYPES:
        size = 384 if t == "siglip_384" else 224
        tenc, jenc = tie.ImageEncoderConfig(t, size), jie.ImageEncoderConfig(t, size)
        assert tenc.geometry == jenc.geometry == jie.ENCODER_GEOMETRY[t], t
        tt, jt = tenc.tower_config, jenc.tower_config
        assert type(tt).__name__ == type(jt).__name__
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt), t
    assert tie.ImageEncoderConfig("vqgan").tower_config.tokens_for(224) == 196
    assert tie.ImageEncoderConfig("vqgan").tower_config.z_channels == 256
    assert tie.ImageEncoderConfig("convnext").tower_config.tokens_for(224) == 49
    assert tie.ImageEncoderConfig("convnext").tower_config.dims[-1] == 1024
    assert tie.ImageEncoderConfig("open-clip").tower_config.num_tokens == 256
    for t, tokens in (("siglip_512", 1024), ("siglip_256", 256)):
        tower = tie.ImageEncoderConfig(t).tower_config
        assert (tower.hidden_size, tower.layers, tower.heads, tower.intermediate_size,
                tower.num_tokens) == (768, 12, 12, 3072, tokens)
    with pytest.raises(ValueError, match="unknown image encoder"):
        tie.ImageEncoderConfig("dino").tower_config


@pytest.mark.parametrize("t", TYPES)
def test_processor_for_encoder_matches_jax(t):
    """The same size and statistics as JAX's, and the same pixels to the
    resize's rounding gap, on one PIL image."""
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(9).integers(0, 256, (37, 61, 3), np.uint8))
    jp, tp = jproc.processor_for_encoder(t), tproc.processor_for_encoder(t)
    assert tp.size == jp.size
    np.testing.assert_array_equal(tp.mean.numpy(), np.asarray(jp.mean, np.float32))
    np.testing.assert_array_equal(tp.std.numpy(), np.asarray(jp.std, np.float32))
    out, ref = tp(img).numpy(), np.asarray(jp(img))
    assert out.shape == ref.shape == (jp.size, jp.size, 3)
    gap = np.abs(out - ref) * np.asarray(jp.std) * 255.0
    assert gap.max() <= 2.0 + 1e-3, gap.max()


def test_clip_vit_exact_gelu():
    """clip_vit with act="gelu" (open-clip's trunk) against the JAX
    package's, and apart from the QuickGELU tower on the same weights."""
    jcfg = jvit.tiny_config(act="gelu")
    params = jax.tree_util.tree_map(np.asarray, jvit.init_params(jcfg, jax.random.PRNGKey(2)))
    x = np.random.default_rng(2).standard_normal((2, 28, 28, 3)).astype(np.float32)
    ref = np.asarray(jvit.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                  jnp.asarray(x), policy=JF32))
    tparams = convert.from_jax_params(params)
    out = tvit.forward(tparams, tvit.tiny_config(act="gelu"), torch.from_numpy(x), policy=TF32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    quick = tvit.forward(tparams, tvit.tiny_config(), torch.from_numpy(x), policy=TF32)
    assert np.abs(quick.numpy() - ref).max() > 1e-3
