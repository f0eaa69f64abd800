"""Port parity: the cached GPTBigCode decoder against starvector_tpu's, in
fp32 on the same weights (the JAX pytree handed over with from_jax_params).

The prefix is 70 tokens (> 64), so the JAX decoder under attn_impl="mixed"
prefills through the Pallas flash kernel (interpret mode on the CPU); each
decode step runs the merged-softmax attention. Tolerance 2e-4 on logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0, atol=2e-3)
P, STEPS = 70, 8


@pytest.fixture(scope="module")
def setup():
    jcfg = jgbc.tiny_config(attn_impl="mixed", n_positions=256)
    tcfg = tgbc.tiny_config(n_positions=256)
    jparams = jgbc.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    embeds = (rng.standard_normal((2, P + STEPS, jcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((2, P), np.int32)
    mask[1, :6] = 0  # row 1 is left-padded
    return jcfg, tcfg, jparams, convert.from_jax_params(tree), embeds, mask


def test_compute_position_ids():
    m = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 0, 1]], np.int32)
    ref = jgbc.compute_position_ids(jnp.asarray(m))
    out = tgbc.compute_position_ids(torch.from_numpy(m))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_prefill_and_decode_steps_match_jax(setup):
    jcfg, tcfg, jparams, tparams, embeds, mask = setup
    T = P + STEPS
    jcache = jgbc.init_cache(jcfg, 2, T, dtype=jnp.float32)
    tcache = tgbc.init_cache(tcfg, 2, T, dtype=torch.float32)
    jl, jcache = jgbc.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                              attention_mask=jnp.asarray(mask), cache=jcache, policy=JF32)
    tl, tcache = tgbc.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                              attention_mask=torch.from_numpy(mask), cache=tcache, policy=TF32)
    live = mask.astype(bool)  # padded query rows see no key: unspecified
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    for t in range(STEPS):
        x = embeds[:, P + t:P + t + 1]
        jl, jcache = jgbc.forward(jparams, jcfg, jnp.asarray(x), cache=jcache, policy=JF32)
        tl, tcache = tgbc.forward(tparams, tcfg, torch.from_numpy(x), cache=tcache, policy=TF32)
        assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the cache was written in place to the same contents
    assert tcache["index"] == int(jcache["index"]) == T
    np.testing.assert_array_equal(tcache["kv_mask"].numpy(), np.asarray(jcache["kv_mask"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy()[:, 0], np.asarray(jcache[key])[:, 0], **TOL)


def test_last_logits_and_chunked_prefill_match_jax(setup):
    """last_logits_only, then a 5-token chunk after the prefix (the JAX
    decoder's XLA chunk step; the port's flash path)."""
    jcfg, tcfg, jparams, tparams, embeds, mask = setup
    T = P + 5
    jcache = jgbc.init_cache(jcfg, 2, T, dtype=jnp.float32)
    tcache = tgbc.init_cache(tcfg, 2, T, dtype=torch.float32)
    jl, jcache = jgbc.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                              attention_mask=jnp.asarray(mask), cache=jcache, policy=JF32,
                              last_logits_only=True)
    tl, tcache = tgbc.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                              attention_mask=torch.from_numpy(mask), cache=tcache, policy=TF32,
                              last_logits_only=True)
    assert tl.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    x = embeds[:, P:P + 5]
    jl, _ = jgbc.forward(jparams, jcfg, jnp.asarray(x), cache=jcache, policy=JF32)
    tl, _ = tgbc.forward(tparams, tcfg, torch.from_numpy(x), cache=tcache, policy=TF32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)



def test_bf16_policy_logits_are_fp32_and_match_jax(setup):
    """Under the default policy (fp32 parameters, bf16 compute, bf16 cache)
    the tied head still returns the fp32 accumulator, as JAX does: logits
    that went through bf16 would all be bf16 values and tie over the
    vocabulary. Prefill (last position) and one decode step. Tolerance
    BF16_TOL: the two sides round the bf16 activations of two layers in
    different orders."""
    jcfg, tcfg, jparams, tparams, embeds, mask = setup
    jcache = jgbc.init_cache(jcfg, 2, P + 1, dtype=jnp.bfloat16)
    tcache = tgbc.init_cache(tcfg, 2, P + 1, dtype=torch.bfloat16)
    jl, jcache = jgbc.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                              attention_mask=jnp.asarray(mask), cache=jcache,
                              policy=JPolicy(), last_logits_only=True)
    tl, tcache = tgbc.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                              attention_mask=torch.from_numpy(mask), cache=tcache,
                              policy=TPolicy(), last_logits_only=True)
    pairs = [(tl, jl)]
    x = embeds[:, P:P + 1]
    jl, _ = jgbc.forward(jparams, jcfg, jnp.asarray(x), cache=jcache, policy=JPolicy())
    tl, _ = tgbc.forward(tparams, tcfg, torch.from_numpy(x), cache=tcache, policy=TPolicy())
    pairs.append((tl, jl))
    for tl, jl in pairs:
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, jcfg.vocab_size)
        assert (tl == tl.bfloat16().float()).float().mean() < 0.05
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)

def test_uncached_forward_and_cache_overflow_raise(setup):
    """The uncached (training) forward, refused before it was ported, runs:
    its logits match the JAX decoder's uncached forward (the Pallas
    trainable flash path in interpret mode). An unknown remat mode, and a
    cache too short for the new tokens, raise."""
    jcfg, tcfg, jparams, tparams, embeds, mask = setup
    jl, _ = jgbc.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                         attention_mask=jnp.asarray(mask), policy=JF32)
    tl, cache = tgbc.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                             attention_mask=torch.from_numpy(mask), policy=TF32)
    assert cache is None and tl.dtype == torch.float32
    live = mask.astype(bool)  # padded query rows see no key: unspecified
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    x = torch.from_numpy(embeds[:, :4])
    with pytest.raises(ValueError, match="unknown gradient_checkpointing"):
        tgbc.forward(tparams, tcfg, x, policy=TF32, remat="dots-flash")
    with pytest.raises(ValueError, match="cannot take"):
        tgbc.forward(tparams, tcfg, x, cache=tgbc.init_cache(tcfg, 2, 3, torch.float32),
                     policy=TF32)
