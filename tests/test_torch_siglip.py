"""Port parity for the StarVector-8B's vision side: the SigLIP tower
against starvector_tpu's and against HF SiglipVisionModel, the siglip_384
image-encoder dispatch and processor, and the LayerNorm adapter at the 8B's
(576, 4608) normalised shape. Inputs are seeded with numpy; fp32.
Tolerance 2e-4 (the JAX package's HF parity tolerance), 1e-5 for the
adapter norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import adapter as jad
from starvector_tpu.models import image_encoder as jie
from starvector_tpu.models.vision import siglip as jsig
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.data import processor as tproc
from starvector_tpu_torch.models import adapter as tad
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import image_encoder as tie
from starvector_tpu_torch.models.vision import siglip as tsig
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)


def _images(cfg, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def test_siglip_matches_jax():
    """A tiny tower (32 px, patch 8: 16 tokens, width 32, 2 layers) on the
    JAX package's weights, with its position embeddings and biases made
    non-trivial."""
    cfg = jsig.tiny_config()
    tree = jax.tree_util.tree_map(np.asarray, jsig.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree["patch_embed"]["bias"] = rng.standard_normal(32).astype(np.float32) * 0.1
    tree["layers"]["attn"]["q_proj"]["bias"] = rng.standard_normal((2, 32)).astype(np.float32)
    tree["post_layernorm"]["scale"] = (1 + rng.standard_normal(32) * 0.1).astype(np.float32)
    images = _images(cfg)
    ref = jsig.forward(jax.tree_util.tree_map(jnp.asarray, tree), cfg, jnp.asarray(images),
                       policy=JF32)
    tcfg = tsig.tiny_config()
    out = tsig.forward(convert.from_jax_params(tree), tcfg, torch.from_numpy(images), policy=TF32)
    assert out.shape == (2, tcfg.num_tokens, tcfg.hidden_size) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_siglip_matches_hf_siglip_vision_model():
    """HF SiglipVisionModel's last_hidden_state (post_layernorm included) on
    its own random weights, through the port's siglip_from_hf."""
    from transformers import SiglipVisionConfig, SiglipVisionModel

    tcfg = tsig.tiny_config()
    hf_cfg = SiglipVisionConfig(hidden_size=tcfg.hidden_size, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4, image_size=32,
                                patch_size=8, layer_norm_eps=1e-6,
                                hidden_act="gelu_pytorch_tanh", attn_implementation="eager")
    torch.manual_seed(2)
    model = SiglipVisionModel(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert.siglip_from_hf(sd, "vision_model.")
    images = _images(tcfg, 3)
    with torch.no_grad():
        ref = model(pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2)).last_hidden_state
    out = tsig.forward(params, tcfg, torch.from_numpy(images), policy=TF32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_siglip_384_encoder_and_processor():
    """The 8B tower's dispatch: siglip_384 is SigLIP-large-patch16-384 at
    (1024 wide, 576 tokens) with no ln_vision, as in the JAX package; its
    processor resizes to 384 with SigLIP's statistics (0.5, 0.5)."""
    enc = tie.ImageEncoderConfig("siglip_384", 384)
    jenc = jie.ImageEncoderConfig("siglip_384", 384)
    assert enc.geometry == jenc.geometry == (1024, 576)
    tower = enc.tower_config
    for f in ("image_size", "patch_size", "hidden_size", "layers", "heads", "intermediate_size",
              "ln_eps"):
        assert getattr(tower, f) == getattr(jenc.tower_config, f), f
    small = tie.ImageEncoderConfig("siglip_384", 32, tower=tsig.tiny_config())
    params = tie.init_params(small, torch.Generator().manual_seed(0))
    assert set(params) == {"visual_encoder"}
    out = tie.forward(params, small, torch.zeros((1, 32, 32, 3)), policy=TF32)
    assert out.shape == (1, 16, 32)
    proc = tproc.processor_for_encoder("siglip_384")
    assert proc.size == 384 and proc.mean.tolist() == proc.std.tolist() == [0.5] * 3
    img = np.full((20, 30, 3), 255, np.uint8)
    assert torch.allclose(proc(img), torch.ones((384, 384, 3)))  # white -> (1 - 0.5) / 0.5
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
        tproc.processor_for_encoder("siglip_512")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
        tie.ImageEncoderConfig("siglip_256").tower_config


def test_layer_norm_adapter_at_the_8b_shape():
    """The adapter's LayerNorm over (576, 4608) jointly, 2.65M elements a
    row, with a non-trivial affine, against the JAX function (fp32)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 576, 4608)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal((576, 4608))).astype(np.float32),
         "bias": (0.1 * rng.standard_normal((576, 4608))).astype(np.float32)}
    ref = jad._layer_norm_2d(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    out = tad._layer_norm_2d({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
