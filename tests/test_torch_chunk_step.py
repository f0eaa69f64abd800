"""Port parity for the cached call of 1 < S <= 64 new tokens, which both JAX
decoders send through their chunk step (`_chunk_step` / `_verify_layer_fn`
with decode_common.merged_verify_attention): the chunk attends to the
cached slots (P rounded to the compute dtype before P.V) and to its own
keys unquantized (P and V in fp32, the division after), and its k/v are
written to the cache once after all layers (quantized only then, for an
int8 cache).

Each case runs the same numpy weights and inputs through the JAX `forward`
and the port's:
  * "prefix": a 20-token left-padded prefix (itself a chunk step), then a
    12-token chunk at index 20;
  * "from_zero": a 9-token left-padded chunk at index 0 (a text2svg prompt).
StarCoder2's window (16) is shorter than prefix + chunk, so the chunk's
queries drop cached keys one by one (the JAX per-query window mask), and
S <= window keeps the chunk step.

Tolerances on the live logits: fp32 atol = rtol = 1e-5; bf16 atol 2e-3,
rtol 2^-7 (the two sides round bf16 activations in different orders). With
an int8 cache in fp32 the codes are compared too: never more than one code
apart, and equal on >= 99% (in bf16 a k or v one bf16 step apart moves its
row's scale, and with it most of the row's codes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

TOLS = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2**-7, atol=2e-3)}
POLICIES = {"fp32": (JPolicy(compute_dtype=jnp.float32), TPolicy(compute_dtype=torch.float32)),
            "bf16": (JPolicy(), TPolicy())}
WINDOW = 16
SCENARIOS = {"prefix": (20, 12, 4), "from_zero": (0, 9, 3)}  # prefix, chunk, row 1's pads


def _decoder(name):
    if name == "gpt_bigcode":
        return (jgbc, jgbc.tiny_config(attn_impl="mixed", n_positions=256), tgbc,
                tgbc.tiny_config(n_positions=256))
    kw = dict(num_attention_heads=4, num_key_value_heads=2, sliding_window=WINDOW)
    return jsc, jsc.tiny_config(**kw), tsc, tsc.tiny_config(**kw)


@pytest.fixture(scope="module", params=["gpt_bigcode", "starcoder2"])
def decoder(request):
    jmod, jcfg, tmod, tcfg = _decoder(request.param)
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    return jmod, jcfg, tmod, tcfg, tree


@pytest.mark.parametrize("cache", ["compute", "int8"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_chunk_step_matches_jax(decoder, monkeypatch, scenario, policy, cache):
    jmod, jcfg, tmod, tcfg, tree = decoder
    prefix, S, pads = SCENARIOS[scenario]
    jpol, tpol = POLICIES[policy]
    jdt = jnp.int8 if cache == "int8" else jpol.compute_dtype
    tdt = torch.int8 if cache == "int8" else tpol.compute_dtype
    rng = np.random.default_rng(prefix + S)
    embeds = (rng.standard_normal((2, prefix + S, jcfg.hidden_size)) * 0.5).astype(np.float32)
    masks = [np.ones((2, n), np.int32) for n in (prefix, S)]
    masks[0 if prefix else 1][1, :pads] = 0  # row 1 is left-padded
    T = prefix + S
    jcache = jmod.init_cache(jcfg, 2, T, dtype=jdt)
    tcache = tmod.init_cache(tcfg, 2, T, dtype=tdt)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree)
    prefills = []  # kernel 1 (its plain version here) is not the chunk step's
    plain = tfa.flash_prefill_plain
    monkeypatch.setattr(tfa, "flash_prefill_plain",
                        lambda *a, **kw: prefills.append(1) or plain(*a, **kw))
    start = 0
    for mask in masks:
        n = mask.shape[1]
        if n == 0:
            continue
        x = embeds[:, start:start + n]
        jl, jcache = jmod.forward(jparams, jcfg, jnp.asarray(x), attention_mask=jnp.asarray(mask),
                                  cache=jcache, policy=jpol)
        tl, tcache = tmod.forward(tparams, tcfg, torch.from_numpy(x),
                                  attention_mask=torch.from_numpy(mask), cache=tcache,
                                  policy=tpol)
        live = mask.astype(bool)  # padded query rows see no key: unspecified
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl, np.float32)[live],
                                   **TOLS[policy])
        # the chunk step; StarCoder2 prefills a prefix longer than its window
        assert bool(prefills) == (n > (getattr(tcfg, "sliding_window", None) or n)), n
        prefills.clear()
        start += n
    assert tcache["index"] == int(jcache["index"]) == T
    kv_mask = np.asarray(jcache["kv_mask"])
    np.testing.assert_array_equal(tcache["kv_mask"].numpy(), kv_mask)
    if cache == "int8" and policy == "fp32":
        live = kv_mask.astype(bool)
        for key in ("k", "v"):
            ours = tcache[key].numpy().astype(int)[:, live]
            ref = np.asarray(jcache[key]).astype(int)[:, live]
            assert np.abs(ours - ref).max() <= 1, key
            assert (ours == ref).mean() >= 0.99, key
