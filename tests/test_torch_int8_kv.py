"""Port parity: the int8 KV cache and int8 inference of the 1B decoder
against starvector_tpu, on the same numpy inputs and weights.

- quantize_kv / dequantize_kv and the scaled merged decode attention (the
  plain version of kernel 2's int8 instantiation) at 1e-5;
- the cached decoder with int8 weights and an int8 cache: a 70-token
  prefill (> 64, so the JAX decoder takes its flash path over the
  dequantized window) and decode steps, fp32 policy. Codes are never more
  than one code apart (a value within rounding of a half step can flip);
  the first layer's are equal on >= 99.9% with scales within 1e-5, and
  since a flipped code moves the next layer's inputs by a scale step, the
  whole cache's on >= 99% with scales within one scale step (1/127);
- greedy generate with int8 weights and an int8 cache: the same token ids;
- StarVector-8B's int8 path at tiny width: the scaled merged decode
  attention at G = 9 with the window as t_begin (1e-5), and a tiny
  8B-shaped model (SigLIP tower, StarCoder2 with G = 9 and a window of 32)
  with int8 weights and an int8 cache: greedy generate_im2svg gives JAX's
  ids.

The tests marked `gpu` hold the int8 decode kernel (G = 16 and G = 9)
against its plain version and skip without a card (on the card:
python -m pytest --noconftest -m gpu tests/test_torch_int8_kv.py).
"""

import numpy as np
import pytest
import torch

from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from starvector_tpu_torch.ops.quantization import quantize_tree

TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-3, atol=5e-3)
P, STEPS, NEW = 70, 4, 12


def _rand(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


@pytest.fixture(scope="module")
def jdc():
    return pytest.importorskip("starvector_tpu.models.decode_common")


def test_quantize_kv_matches_jax(jdc):
    import jax.numpy as jnp

    x = _rand(np.random.default_rng(0), (2, 9, 3, 16), 2.0)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = jdc.quantize_kv(jnp.asarray(x))
    tq, ts = tdc.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (2, 9, 3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    assert (tq.numpy() == np.asarray(jq)).mean() >= 0.999
    np.testing.assert_allclose(tdc.dequantize_kv(tq, ts, torch.float32).numpy(),
                               np.asarray(jdc.dequantize_kv(jq, js, jnp.float32)), **TOL)


@pytest.mark.parametrize("Hkv", [1, 2])
def test_scaled_merged_decode_attention_matches_jax(jdc, Hkv):
    import jax.numpy as jnp

    rng = np.random.default_rng(Hkv)
    B, G, D, T = 2, 4, 16, 11
    qg = _rand(rng, (B, Hkv, G, D))
    kn, vn = _rand(rng, (B, Hkv, D)), _rand(rng, (B, Hkv, D))
    (kq, ks), (vq, vs) = (tdc.quantize_kv(torch.from_numpy(_rand(rng, (B, T, Hkv, D), 3.0)))
                          for _ in range(2))
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0
    ref = jdc.merged_decode_attention(
        jnp.asarray(qg), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(mask), D**-0.5, k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy()))
    out = tfa.merged_decode_attention(
        torch.from_numpy(qg), torch.from_numpy(kn), torch.from_numpy(vn), kq, vq,
        torch.from_numpy(mask), D**-0.5, ks, vs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # scales go with an int8 cache, and an int8 cache needs them
    with pytest.raises(ValueError, match="int8 cache only"):
        tfa.decode_attention(torch.from_numpy(qg), kq.float(), vq.float(),
                             torch.from_numpy(mask), k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="needs k_scale"):
        tfa.decode_attention(torch.from_numpy(qg), kq, vq, torch.from_numpy(mask))


@pytest.mark.parametrize("idx,window", [(90, 32), (60, 200)])
def test_scaled_g9_decode_attention_with_window_matches_jax(jdc, idx, window):
    """Kernel 2's int8 instantiation at the 8B's G = 9 (plain version): the
    window as t_begin = max(idx - window + 1, 0) over the idx cached slots,
    where JAX folds it into old_mask (starcoder2._decode_step)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(idx + window)
    B, Hkv, G, D, T = 2, 2, 9, 32, 100
    qg = _rand(rng, (B, Hkv, G, D))
    kn, vn = _rand(rng, (B, Hkv, D)), _rand(rng, (B, Hkv, D))
    (kq, ks), (vq, vs) = (tdc.quantize_kv(torch.from_numpy(_rand(rng, (B, T, Hkv, D), 3.0)))
                          for _ in range(2))
    mask = np.ones((B, T), np.int32)
    mask[0, :5] = 0
    mask[1, idx - 3] = 0
    slot = np.arange(T)[None, :]
    old = ((mask > 0) & (slot < idx) & (slot > idx - window)).astype(np.int32)
    ref = jdc.merged_decode_attention(
        jnp.asarray(qg), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(old), D**-0.5, k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy()))
    out = tfa.merged_decode_attention(
        torch.from_numpy(qg), torch.from_numpy(kn), torch.from_numpy(vn), kq[:, :idx],
        vq[:, :idx], torch.from_numpy(mask)[:, :idx], D**-0.5, ks[:, :idx], vs[:, :idx],
        t_begin=max(idx - window + 1, 0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def model():
    """A tiny decoder with its projections scaled by 10 (so greedy decoding
    does not echo one token), quantized by the JAX package with
    min_elems=1<<12 (the default threshold quantizes nothing at this
    width), handed over as numpy."""
    import jax

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree

    jcfg = jgbc.tiny_config(attn_impl="mixed", n_positions=256)
    tree = jax.tree_util.tree_map(np.asarray, jgbc.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    qtree = jax.tree_util.tree_map(np.asarray, jquantize_tree(tree, min_elems=1 << 12,
                                                              consume=False))
    rng = np.random.default_rng(0)
    embeds = _rand(rng, (2, P + STEPS, jcfg.hidden_size), 0.5)
    mask = np.ones((2, P), np.int32)
    mask[1, :6] = 0  # row 1 is left-padded
    return jcfg, tgbc.tiny_config(n_positions=256), tree, qtree, embeds, mask


def test_port_quantizes_as_the_jax_package(model):
    _, _, tree, qtree, _, _ = model
    ours = quantize_tree(convert.from_jax_params(tree), min_elems=1 << 12)
    for grp, name in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"), ("mlp", "c_proj")):
        for key in ("kernel_q", "scale"):
            np.testing.assert_array_equal(ours["layers"][grp][name][key].numpy(),
                                          qtree["layers"][grp][name][key])


def test_int8_cache_prefill_and_decode_match_jax(model):
    """Logits at atol 5e-3, rtol 1e-3: a code that flips at a half step moves
    one cached value by one scale step (1/127 of its row's max |x|)."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy

    jcfg, tcfg, _, qtree, embeds, mask = model
    jf32 = JPolicy(compute_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, qtree)
    tparams = convert.from_jax_params(qtree)
    T = P + STEPS
    jcache = jgbc.init_cache(jcfg, 2, T, dtype=jnp.int8)
    tcache = tgbc.init_cache(tcfg, 2, T, dtype=torch.int8)
    jl, jcache = jgbc.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                              attention_mask=jnp.asarray(mask), cache=jcache, policy=jf32)
    tl, tcache = tgbc.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                              attention_mask=torch.from_numpy(mask), cache=tcache, policy=TF32)
    live = mask.astype(bool)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **LOGIT_TOL)
    for t in range(STEPS):
        x = embeds[:, P + t:P + t + 1]
        jl, jcache = jgbc.forward(jparams, jcfg, jnp.asarray(x), cache=jcache, policy=jf32)
        tl, tcache = tgbc.forward(tparams, tcfg, torch.from_numpy(x), cache=tcache, policy=TF32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tcache["index"] == int(jcache["index"]) == T
    # the padded slots of row 1 hold the k/v of rows that see no key
    # (unspecified outputs, never visible): compare the live slots
    live = np.asarray(jcache["kv_mask"]).astype(bool)
    np.testing.assert_array_equal(tcache["kv_mask"].numpy(), np.asarray(jcache["kv_mask"]))
    for key in ("k", "v"):
        assert tcache[key].dtype == torch.int8
        ours = tcache[key].numpy().astype(int)[:, live]
        ref = np.asarray(jcache[key]).astype(int)[:, live]
        assert np.abs(ours - ref).max() <= 1, key
        # layer 0 sees bit-equal inputs, so only ties flip; a flipped code
        # there moves the next layer's inputs by a scale step, so later
        # layers flip more (1 of 4544 layer-0 codes here gives 30 in layer 1)
        assert (ours[0] == ref[0]).mean() >= 0.999, key
        assert (ours == ref).mean() >= 0.99, key
        np.testing.assert_allclose(tcache[f"{key}_scale"].numpy()[0, live],
                                   np.asarray(jcache[f"{key}_scale"])[0, live], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tcache[f"{key}_scale"].numpy()[:, live],
                                   np.asarray(jcache[f"{key}_scale"])[:, live], rtol=1 / 127)


def test_int8_greedy_generate_matches_jax(model):
    import jax
    import jax.numpy as jnp

    from starvector_tpu.generation import engine as jengine
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy

    jcfg, tcfg, _, qtree, embeds, mask = model
    emb, m = embeds[:, :P], mask
    jgen = jengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    ref, ref_len = jengine.generate(
        jax.tree_util.tree_map(jnp.asarray, qtree), jcfg, "gpt_bigcode", jnp.asarray(emb),
        jnp.asarray(m), jgen, jax.random.PRNGKey(1), policy=JPolicy(compute_dtype=jnp.float32),
        kv_cache_dtype=jnp.int8)
    launches = tfa.decode_attention.launches
    tokens, lengths = tengine.generate(
        convert.from_jax_params(qtree), tcfg, torch.from_numpy(emb), torch.from_numpy(m),
        tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False), policy=TF32,
        kv_cache_dtype=torch.int8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert all(len(set(row.tolist())) >= 3 for row in np.asarray(ref))
    assert tfa.decode_attention.launches == launches  # on the CPU, the plain version


def test_int8_8b_greedy_generate_im2svg_matches_jax():
    """A tiny 8B-shaped model (tests/test_torch_im2svg_8b.py's: a 68-token
    prefix past the window of 32) with its decoder quantized by the JAX
    package (projections scaled by 10, min_elems=1<<12: all six a layer)
    and an int8 KV cache: the port's generate_im2svg gives the JAX
    generate's greedy ids, fp32 policy."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.generation import engine as jengine
    from starvector_tpu.models import starcoder2 as jsc
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.vision import siglip as jsig
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy
    from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.vision import siglip as tsig

    geometry = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288,
                    sliding_window=32)
    vision = dict(decoder="starcoder2", image_encoder_type="siglip_384", image_size=64,
                  adapter_norm="layer_norm")
    jcfg = jsv.tiny_config(**vision, vision_tower=jsig.tiny_config(image_size=64),
                           llm=jsc.tiny_config(attn_impl="mixed", **geometry))
    tcfg = tsv.tiny_config(**vision, vision_tower=tsig.tiny_config(image_size=64),
                           llm=tsc.tiny_config(**geometry))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    st = tree["svg_transformer"]
    for grp in st["layers"]["attn"], st["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    tree["svg_transformer"] = jax.tree_util.tree_map(
        np.asarray, jquantize_tree(st, min_elems=1 << 12, consume=False))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        assert all("kernel_q" in p for p in grp.values())
    images = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    prompt = np.array([[60, 116, 119, 104]] * 2, np.int32)
    jf32 = JPolicy(compute_dtype=jnp.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    cond = jsv.encode_image(jp, jcfg, jnp.asarray(images), policy=jf32)
    emb = jnp.concatenate([cond, jf32.cast(jsc.embed_tokens(jp["svg_transformer"], prompt))], 1)
    assert emb.shape[1] > 64  # the prefill, past the window
    gen = dict(max_new_tokens=NEW, do_sample=False)
    ref, ref_len = jengine.generate(
        jp["svg_transformer"], jcfg.llm, "starcoder2", emb, jnp.ones(emb.shape[:2], jnp.int32),
        jengine.GenerationConfig(**gen), jax.random.PRNGKey(1), prompt_ids=jnp.asarray(prompt),
        policy=jf32, kv_cache_dtype=jnp.int8)
    tokens, lengths = tengine.generate_im2svg(
        convert.from_jax_params(tree), tcfg, torch.from_numpy(images),
        torch.from_numpy(prompt).long(), tengine.GenerationConfig(**gen), policy=TF32,
        kv_cache_dtype=torch.int8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert all(len(set(row.tolist())) >= 3 for row in np.asarray(ref))


# ---------------------------------------------------------------------------
# on the card: kernel 2's int8 instantiation against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T", [260, 389])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_decode_kernel_matches_plain(cuda, B, T, dtype):
    """Tolerance atol = rtol: fp32 1e-4, bf16 2e-2 (the P.V operand is
    rounded to bf16 at another softmax max than the plain version's)."""
    rng = np.random.default_rng(B * T)
    G, D = 16, 128
    qg = torch.from_numpy(_rand(rng, (B, 1, G, D))).to(cuda, dtype)
    kn, vn = (torch.from_numpy(_rand(rng, (B, 1, D))).to(cuda, dtype) for _ in range(2))
    (kq, ks), (vq, vs) = (tdc.quantize_kv(torch.from_numpy(_rand(rng, (B, T, 1, D))).to(cuda))
                          for _ in range(2))
    mask = torch.ones((B, T), dtype=torch.int32, device=cuda)
    mask[:, : T // 5] = 0  # left padding
    mask[0, T // 2] = 0
    out = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs)
    ref = tfa.merged_decode_attention(qg, kn, vn, kq, vq, mask, D**-0.5, ks, vs, kernels=False)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
