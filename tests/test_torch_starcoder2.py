"""Port parity for the StarVector-8B decoder: rotary embeddings, and the
cached StarCoder2 (GQA, RoPE, sliding window) against starvector_tpu's and
against HF Starcoder2ForCausalLM, in fp32 on the same weights.

The prefix is 70 tokens (> 64), so the JAX decoder prefills through its
scan path: XLA attention under attn_impl="xla", the Pallas flash kernel
(interpret mode) under "mixed"; each decode step runs the merged-softmax
attention with the window folded into its mask. The window (8) is shorter
than the prefix, so both the prefill and every decode step drop keys.
Tolerance 2e-4 on logits (the JAX and HF parity tests' own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops import rotary as jrot
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops import rotary as trot
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=2e-4, atol=2e-4)
P, STEPS, WINDOW = 70, 6, 8
# (query heads, KV heads, width): GQA with G = 2, and G = 9 as the 8B's 36 over 4
GEOMETRIES = {"G=2": (4, 2, 64), "G=9": (18, 2, 288)}


@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (256, 1e6), (16, 1e4)])
def test_rope_frequencies_are_jax_bits(head_dim, theta):
    """inv_freq equals JAX's bit for bit (torch's fp32 pow is an ulp off at
    i = 37 of the 7B's 64 frequencies)."""
    ref = np.asarray(jrot.rope_frequencies(head_dim, theta))
    np.testing.assert_array_equal(trot.rope_frequencies(head_dim, theta).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    """The rotation at the 7B's head (D = 128, theta 1e6) up to position
    16383: fp32 within 2e-6 (cos and sin of the same fp32 angles, each
    within an ulp); bf16 within one bf16 step of the output (each side
    rounds the fp32 rotation once)."""
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 64, 3, 128
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 16384, (B, S)).astype(np.int32)
    inv = jrot.rope_frequencies(D, 1e6)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(jrot.apply_rope(jx, jnp.asarray(pos), inv).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = trot.apply_rope(tx, torch.from_numpy(pos), trot.rope_frequencies(D, 1e6))
    assert out.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out.float().numpy() - ref) <= step).all()


def _configs(geometry, impl):
    H, Hkv, E = GEOMETRIES[geometry]
    kw = dict(num_attention_heads=H, num_key_value_heads=Hkv, hidden_size=E,
              sliding_window=WINDOW)
    return jsc.tiny_config(attn_impl=impl, **kw), tsc.tiny_config(**kw)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((2, P + STEPS, cfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((2, P), np.int32)
    mask[1, :6] = 0  # row 1 is left-padded: its positions start later
    return embeds, mask


@pytest.mark.parametrize("impl", ["xla", "mixed"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_prefill_and_windowed_decode_match_jax(geometry, impl):
    jcfg, tcfg = _configs(geometry, impl)
    jparams = jsc.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    embeds, mask = _inputs(jcfg)
    T = P + STEPS
    jcache = jsc.init_cache(jcfg, 2, T, dtype=jnp.float32)
    tcache = tsc.init_cache(tcfg, 2, T, dtype=torch.float32)
    jl, jcache = jsc.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                             attention_mask=jnp.asarray(mask), cache=jcache, policy=JF32)
    tl, tcache = tsc.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                             attention_mask=torch.from_numpy(mask), cache=tcache, policy=TF32)
    live = mask.astype(bool)  # padded query rows see no key: unspecified
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    for t in range(STEPS):
        x = embeds[:, P + t:P + t + 1]
        jl, jcache = jsc.forward(jparams, jcfg, jnp.asarray(x), cache=jcache, policy=JF32)
        tl, tcache = tsc.forward(tparams, tcfg, torch.from_numpy(x), cache=tcache, policy=TF32)
        assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["index"] == int(jcache["index"]) == T
    np.testing.assert_array_equal(tcache["kv_mask"].numpy(), np.asarray(jcache["kv_mask"]))
    for key in ("k", "v"):  # row 1's padded slots hold layer 1's unspecified rows
        np.testing.assert_allclose(tcache[key].numpy()[:, 0], np.asarray(jcache[key])[:, 0],
                                   **TOL)


def test_decode_sees_only_the_window(monkeypatch):
    """Each decode step hands kernel 2 the window's first slot: t_begin =
    max(index - window + 1, 0) over the index cached slots."""
    from starvector_tpu_torch.ops import flash_attention as tfa

    _, tcfg = _configs("G=9", "xla")
    params = tsc.init_params(tcfg, torch.Generator().manual_seed(0))
    seen = []
    plain = tfa.decode_attention_plain

    def spy(qg, k, v, mask, **kw):
        seen.append((k.shape[1], kw["t_begin"]))
        return plain(qg, k, v, mask, **kw)

    monkeypatch.setattr(tfa, "decode_attention_plain", spy)
    cache = tsc.init_cache(tcfg, 1, P + 3, dtype=torch.float32)
    x = torch.randn((1, P + 3, tcfg.hidden_size), generator=torch.Generator().manual_seed(1))
    tsc.forward(params, tcfg, x[:, :P], cache=cache, policy=TF32)
    for t in range(3):
        tsc.forward(params, tcfg, x[:, P + t:P + t + 1], cache=cache, policy=TF32)
    L = tcfg.num_hidden_layers
    assert seen == [(P + t, P + t - WINDOW + 1) for t in range(3) for _ in range(L)]
    assert tsc.window_begin(tsc.tiny_config(sliding_window=None), 500) == 0
    assert tsc.window_begin(tsc.tiny_config(sliding_window=4096), 708) == 0


def test_unported_paths_raise_naming_roadmap():
    """The uncached (training) forward, which raised naming ROADMAP queue 1,
    item 6 before it was ported, gives the cached prefill's logits on the
    same weights and inputs (S = 70 past the window of 8, a left-padded
    row; its padded query rows see no key and are unspecified); the cached
    5-token call, which raised before the chunk step was ported (item 5),
    runs it (tests/test_torch_chunk_step.py holds it to JAX)."""
    _, tcfg = _configs("G=2", "xla")
    params = tsc.init_params(tcfg, torch.Generator().manual_seed(0))
    embeds, mask = _inputs(tcfg)
    x, m = torch.from_numpy(embeds[:, :P]), torch.from_numpy(mask)
    uncached, none = tsc.forward(params, tcfg, x, attention_mask=m, policy=TF32)
    cached, _ = tsc.forward(params, tcfg, x, attention_mask=m, policy=TF32,
                            cache=tsc.init_cache(tcfg, 2, P, dtype=torch.float32))
    assert none is None and uncached.shape == (2, P, tcfg.vocab_size)
    live = mask.astype(bool)
    np.testing.assert_allclose(uncached.detach().numpy()[live], cached.numpy()[live], **TOL)
    x = torch.zeros((1, 5, tcfg.hidden_size))
    logits, cache = tsc.forward(params, tcfg, x,
                                cache=tsc.init_cache(tcfg, 1, 8, dtype=torch.float32))
    assert logits.shape == (1, 5, tcfg.vocab_size) and cache["index"] == 5


@pytest.fixture(scope="module")
def hf_model():
    from transformers import Starcoder2Config as HFConfig
    from transformers import Starcoder2ForCausalLM

    H, Hkv, E = GEOMETRIES["G=9"]
    hf_cfg = HFConfig(
        vocab_size=512, hidden_size=E, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=H, num_key_value_heads=Hkv, max_position_embeddings=128,
        rope_theta=10000.0, sliding_window=WINDOW, attn_implementation="eager",
        tie_word_embeddings=True, attention_dropout=0.0, residual_dropout=0.0,
        embedding_dropout=0.0)
    torch.manual_seed(3)
    model = Starcoder2ForCausalLM(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert.starcoder2_from_hf(sd, "model.", head="lm_head.weight")
    _, tcfg = _configs("G=9", "xla")
    return model, tcfg, params


def test_logits_match_hf_starcoder2_past_the_window(hf_model):
    """HF's full-sequence logits over P + STEPS tokens (S > window: its
    sliding-window mask drops keys) against the port's cached prefill of P
    tokens and STEPS decode steps, on HF's random weights."""
    model, tcfg, params = hf_model
    ids = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, P + STEPS))
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
    embeds = tsc.embed_tokens(params, torch.from_numpy(ids))
    cache = tsc.init_cache(tcfg, 2, P + STEPS, dtype=torch.float32)
    logits, cache = tsc.forward(params, tcfg, embeds[:, :P], cache=cache, policy=TF32)
    out = [logits]
    for t in range(STEPS):
        logits, cache = tsc.forward(params, tcfg, embeds[:, P + t:P + t + 1], cache=cache,
                                    policy=TF32)
        out.append(logits)
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), ref, **TOL)


def test_uncached_logits_match_hf_starcoder2_past_the_window(hf_model):
    """The uncached (training) forward over P + STEPS tokens against HF's
    full-sequence logits (its sliding-window mask drops keys), on HF's
    random weights, with a right-padded row whose real tokens HF sees alone."""
    model, tcfg, params = hf_model
    ids = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, P + STEPS))
    mask = np.ones((2, P + STEPS), np.int32)
    mask[1, P:] = 0
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
        ref1 = model(torch.from_numpy(ids[1:, :P])).logits.numpy()
    embeds = tsc.embed_tokens(params, torch.from_numpy(ids))
    logits, _ = tsc.forward(params, tcfg, embeds, attention_mask=torch.from_numpy(mask),
                            policy=TF32)
    np.testing.assert_allclose(logits[0].numpy(), ref[0], **TOL)
    np.testing.assert_allclose(logits[1, :P].numpy(), ref1[0], **TOL)
