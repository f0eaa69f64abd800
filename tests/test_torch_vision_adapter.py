"""Port parity: image processor, CLIP ViT, adapter and the composed
encode_image against starvector_tpu's, in fp32 on the same weights.
Tolerance 2e-4 for the modules; 2/255 in pixel units for the processor, the
rounding gap between PIL's bicubic resize and torch's antialiased one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from starvector_tpu.data.processor import CLIP_STD, ImageProcessor as JProcessor
from starvector_tpu.models import adapter as jadapter
from starvector_tpu.models import starvector as jsv
from starvector_tpu.models.vision import clip_vit as jvit
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.data.processor import ImageProcessor as TProcessor
from starvector_tpu_torch.models import adapter as tadapter
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.vision import clip_vit as tvit
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_processor_statistics_are_the_jax_packages():
    from starvector_tpu.data import processor as jproc
    from starvector_tpu_torch.data import processor as tproc

    assert (tproc.CLIP_MEAN, tproc.CLIP_STD) == (jproc.CLIP_MEAN, jproc.CLIP_STD)


@pytest.mark.parametrize("channels,shape", [(3, (37, 61)), (4, (50, 29)), (3, (20, 20))])
def test_processor_matches_pil(channels, shape):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (*shape, channels), dtype=np.uint8)
    if channels == 4:
        img[..., 3] = rng.choice([0, 128, 255], shape).astype(np.uint8)
    ref = JProcessor(size=56)(Image.fromarray(img, "RGBA" if channels == 4 else "RGB"))
    out = TProcessor(size=56)(img)
    assert out.shape == (56, 56, 3) and out.dtype == torch.float32
    pixel_gap = np.abs(out.numpy() - ref) * np.asarray(CLIP_STD) * 255.0
    assert pixel_gap.max() <= 2.0 + 1e-3, pixel_gap.max()
    # a PIL image goes through the same path
    pil = TProcessor(size=56)(Image.fromarray(img))
    np.testing.assert_array_equal(pil.numpy(), out.numpy())


def test_patchify_matches():
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvit.patchify(torch.from_numpy(x), 7).numpy(),
                                  np.asarray(jvit.patchify(jnp.asarray(x), 7)))


def test_clip_vit_matches_jax():
    cfg = jvit.tiny_config(image_size=56)
    params = jvit.init_params(cfg, jax.random.PRNGKey(1))
    x = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref = jvit.forward(params, cfg, jnp.asarray(x), policy=JF32)
    out = tvit.forward(convert.from_jax_params(_np_tree(params)),
                       tvit.tiny_config(image_size=56), torch.from_numpy(x), policy=TF32)
    assert out.shape == (2, cfg.num_tokens, cfg.width)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm", ["batch_norm", "layer_norm"])
def test_adapter_matches_jax(norm):
    jcfg = jadapter.AdapterConfig(input_size=32, output_size=48, query_length=17, adapter_norm=norm)
    tree = _np_tree(jadapter.init_params(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    for k in tree["norm"]:  # non-trivial affine and running statistics
        base = 1.0 if k in ("scale", "running_var") else 0.0
        tree["norm"][k] = (base + 0.3 * np.abs(rng.standard_normal(tree["norm"][k].shape))
                           ).astype(np.float32)
    x = rng.standard_normal((3, 17, 32)).astype(np.float32)
    ref = jadapter.forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(x),
                           policy=JF32)
    tcfg = tadapter.AdapterConfig(**{f.name: getattr(jcfg, f.name)
                                     for f in dataclasses.fields(tadapter.AdapterConfig)})
    out = tadapter.forward(convert.from_jax_params(tree), tcfg, torch.from_numpy(x), policy=TF32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm", ["batch_norm", "layer_norm"])
def test_encode_image_matches_jax(norm):
    """Tower + ln_vision + adapter, with the tiny-tower rule of _encoder_cfg."""
    jcfg = jsv.tiny_config(image_size=56, adapter_norm=norm)
    tcfg = tsv.tiny_config(image_size=56, adapter_norm=norm)
    jtower = jsv._encoder_cfg(jcfg)[1]
    assert tsv._encoder_cfg(tcfg)[1] == tvit.CLIPViTConfig(
        **{f.name: getattr(jtower, f.name) for f in dataclasses.fields(tvit.CLIPViTConfig)})
    params = jsv.init_params(jcfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(3).standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref = jsv.encode_image(params, jcfg, jnp.asarray(x), policy=JF32)
    out = tsv.encode_image(convert.from_jax_params(_np_tree(params)), tcfg, torch.from_numpy(x),
                           policy=TF32)
    assert out.shape == (2, 65, tcfg.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
