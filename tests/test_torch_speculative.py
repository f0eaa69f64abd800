"""Port parity for prompt-lookup speculative decoding
(generation/speculative.py) and the ragged cache's verify forward
(forward_ragged_verify, decode_common.commit_verify), against
starvector_tpu on the same numpy weights and inputs, fp32.

Two tiny decoders: the 1B's GPTBigCode and an 8B-shaped StarCoder2 (18
query heads over 2 KV heads, G = 9, a window of 16 that the prompts and
the new tokens run past), projections scaled by 3 (greedy decoding then
repeats itself in part, without echoing one token). Prompts repeat a
4-token motif, and drafts are found and partly accepted. Must be identical: the B = 1 path's ids,
lengths and n_forwards (a visual prefix whose positions have no id, -1,
and a stop sequence) against generate_greedy_speculative; the batched
path's (right-padded rows of 12, 9 and 5 tokens) against
generate_greedy_speculative_batched; both against plain greedy generate
row by row; accept_margin = 1e9 (no draft accepted: one token a forward)
giving the same ids. forward_ragged_verify's logits and the committed
cache (k, v at the committed slots at 1e-5; kv_mask, lengths exactly) over
two rounds past StarCoder2's window; a chunk longer than the window raises. The API's speculative text (im2svg at B = 1 and 3, text2svg for
both decoders) equals the JAX API's, and with sampling on (or a logit
bias) use_speculative falls back to plain decoding, as JAX's spec_ok.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import engine as jengine
from starvector_tpu.generation import speculative as jspec
from starvector_tpu.models import decode_common as jdc
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.generation import speculative as tspec
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
NEW, K = 24, 4
TOL = dict(rtol=1e-5, atol=1e-5)
G9 = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288, sliding_window=16)
DECODERS = {
    "gpt_bigcode": (jgbc, jgbc.tiny_config(attn_impl="mixed"), tgbc, tgbc.tiny_config()),
    "starcoder2": (jsc, jsc.tiny_config(attn_impl="mixed", **G9), tsc, tsc.tiny_config(**G9)),
}
MOTIF = [7, 9, 11, 13]
# projections x 3: greedy output neither echoes one token (x 1) nor never
# repeats (x 10), so drafts are partly accepted
SCALE = 3.0


def _scaled_tree(jmod, jcfg):
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * SCALE
    return tree


@pytest.fixture(scope="module", params=list(DECODERS))
def decoder(request):
    jmod, jcfg, tmod, tcfg = DECODERS[request.param]
    tree = _scaled_tree(jmod, jcfg)
    return request.param, jmod, jcfg, tmod, tcfg, tree


def _embed(jmod, tree, ids):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return np.array(jmod.embed_tokens(params, jnp.asarray(np.maximum(ids, 0))), np.float32)


def _greedy(tcfg, params, embeds, mask, n=NEW, **kw):
    tokens, lengths = tengine.generate(params, tcfg, torch.from_numpy(embeds),
                                       torch.from_numpy(mask),
                                       tengine.GenerationConfig(max_new_tokens=n, do_sample=False,
                                                                **kw), policy=TF32)
    return tokens.numpy(), lengths.numpy()


def _b1_inputs(jmod, jcfg, tree, visual: int):
    prompt = np.asarray([MOTIF * 2 + [5]])
    ids = np.concatenate([np.full((1, visual), -1), prompt], axis=1)
    embeds = _embed(jmod, tree, ids)
    embeds[:, :visual] = np.random.default_rng(7).standard_normal(
        (1, visual, jcfg.hidden_size)).astype(np.float32)
    return embeds, np.ones(ids.shape, np.int32), ids


@pytest.mark.parametrize("case", ["visual", "stop"])
def test_b1_speculative_matches_jax(decoder, case):
    name, jmod, jcfg, _, tcfg, tree = decoder
    params = convert.from_jax_params(tree)
    embeds, mask, ids = _b1_inputs(jmod, jcfg, tree, visual=4 if case == "visual" else 0)
    free, _ = _greedy(tcfg, params, embeds, mask)
    stops = ((int(free[0, 9]), int(free[0, 10])),) if case == "stop" else ()
    kw = dict(max_new_tokens=NEW, draft_len=K, stop_sequences=stops, pad_token_id=0)
    ref, ref_len, ref_fwd = jspec.generate_greedy_speculative(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(embeds), jnp.asarray(mask),
        jnp.asarray(ids, jnp.int32), dec_name=name, llm_cfg=jcfg, policy=JF32, **kw)
    tokens, lengths, n_fwd = tspec.generate_greedy_speculative(
        params, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask), torch.from_numpy(ids),
        policy=TF32, **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert n_fwd == int(ref_fwd) < NEW  # drafts were accepted
    greedy, g_len = _greedy(tcfg, params, embeds, mask, stop_sequences=stops)
    n = int(g_len[0])
    assert int(lengths[0]) == n and (n < NEW) == (case == "stop")
    np.testing.assert_array_equal(tokens.numpy()[0, :n], greedy[0, :n])


def _ragged_inputs(jmod, tree, lens=(12, 9, 5)):
    P = max(lens)
    rows = [(MOTIF * 4)[r:r + n] for r, n in enumerate(lens)]
    ids = np.full((len(lens), P), -1)
    for b, row in enumerate(rows):
        ids[b, :len(row)] = row
    mask = (ids >= 0).astype(np.int32)
    return _embed(jmod, tree, ids), mask, ids


def test_batched_speculative_matches_jax(decoder):
    """With accept_margin 0 and 1e9 (every draft rejected: one token a row a
    round, so 1 + NEW forwards), the same ids, lengths and forwards as JAX,
    and every row its plain greedy row."""
    name, jmod, jcfg, _, tcfg, tree = decoder
    params = convert.from_jax_params(tree)
    embeds, mask, ids = _ragged_inputs(jmod, tree)
    args = (torch.from_numpy(embeds), torch.from_numpy(mask), torch.from_numpy(ids))
    free = tspec.generate_greedy_speculative_batched(params, tcfg, *args, max_new_tokens=NEW,
                                                     draft_len=K, policy=TF32)[0]
    stops = ((int(free[1, 6]), int(free[1, 7])),)  # row 1 stops early
    n_fwd = {}
    for margin in (0.0, 1e9):
        kw = dict(max_new_tokens=NEW, draft_len=K, stop_sequences=stops, pad_token_id=0,
                  accept_margin=margin)
        ref, ref_len, ref_fwd = jspec.generate_greedy_speculative_batched(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(embeds), jnp.asarray(mask),
            jnp.asarray(ids, jnp.int32), dec_name=name, llm_cfg=jcfg, policy=JF32, **kw)
        tokens, lengths, n_fwd[margin] = tspec.generate_greedy_speculative_batched(
            params, tcfg, *args, policy=TF32, **kw)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
        assert n_fwd[margin] == int(ref_fwd)
        assert (lengths.numpy() < NEW).any()
        for b in range(len(ids)):  # each row alone, unpadded, through plain greedy
            n = int(mask[b].sum())
            greedy, g_len = _greedy(tcfg, params, embeds[b:b + 1, :n], mask[b:b + 1, :n],
                                    stop_sequences=stops)
            assert int(lengths[b]) == int(g_len[0])
            np.testing.assert_array_equal(tokens.numpy()[b], greedy[0])
    assert n_fwd[1e9] == NEW + 1 and n_fwd[0.0] < n_fwd[1e9], n_fwd


def test_accept_margin_bounds_b1_chains(decoder):
    """accept_margin = 1e9 rejects every draft: one token a forward, the
    same ids as with margin 0."""
    _, jmod, jcfg, _, tcfg, tree = decoder
    params = convert.from_jax_params(tree)
    embeds, mask, ids = _b1_inputs(jmod, jcfg, tree, visual=0)
    args = (params, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask),
            torch.from_numpy(ids))
    t0, l0, f0 = tspec.generate_greedy_speculative(*args, max_new_tokens=NEW, draft_len=K,
                                                   policy=TF32)
    t1, l1, f1 = tspec.generate_greedy_speculative(*args, max_new_tokens=NEW, draft_len=K,
                                                   policy=TF32, accept_margin=1e9)
    assert torch.equal(t0, t1) and torch.equal(l0, l1)
    assert f1 == NEW + 1 and f0 < f1


def _prefilled_ragged(jmod, jcfg, tmod, tcfg, tree, embeds, mask, T):
    """Both packages' ragged caches after a linear prefill of right-padded
    rows (the batched speculative path's start)."""
    B = embeds.shape[0]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jc = jmod.init_cache(jcfg, B, T, dtype=jnp.float32)
    _, jc = jmod.forward(jparams, jcfg, jnp.asarray(embeds), attention_mask=jnp.asarray(mask),
                         cache=jc, policy=JF32)
    jrag = {"k": jc["k"], "v": jc["v"], "kv_mask": jc["kv_mask"],
            "lengths": jnp.asarray(mask.sum(1), jnp.int32)}
    tparams = convert.from_jax_params(tree)
    tc = tmod.init_cache(tcfg, B, T, dtype=torch.float32)
    _, tc = tmod.forward(tparams, tcfg, torch.from_numpy(embeds),
                         attention_mask=torch.from_numpy(mask), cache=tc, policy=TF32)
    del tc["index"]
    tc["lengths"] = torch.from_numpy(mask.sum(1).astype(np.int32))
    return jparams, jrag, tparams, tc


def test_forward_ragged_verify_and_commit_match_jax(decoder):
    name, jmod, jcfg, tmod, tcfg, tree = decoder
    embeds, mask, _ = _ragged_inputs(jmod, tree)
    W, T = 6, 32  # two rounds take the 12-token row to slot 24, past the window of 16
    jparams, jrag, tparams, trag = _prefilled_ragged(jmod, jcfg, tmod, tcfg, tree, embeds, mask, T)
    assert tmod.init_ragged_cache(tcfg, 3, T)["lengths"].shape == (3,)
    rng = np.random.default_rng(3)
    for accepted in ([6, 2, 0], [3, 6, 1]):
        toks = rng.integers(1, jcfg.vocab_size, (3, W))
        jl, jrag = jmod.forward_ragged_verify(jparams, jcfg, jnp.asarray(toks, jnp.int32), jrag,
                                              jnp.ones(3, bool), policy=JF32)
        tl, trag = tmod.forward_ragged_verify(tparams, tcfg, torch.from_numpy(toks), trag,
                                              policy=TF32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jrag = jdc.commit_verify(jrag, jnp.asarray(accepted, jnp.int32))
        tdc.commit_verify(trag, torch.tensor(accepted))
        np.testing.assert_array_equal(trag["lengths"].numpy(), np.asarray(jrag["lengths"]))
        kv_mask = np.asarray(jrag["kv_mask"])
        np.testing.assert_array_equal(trag["kv_mask"].numpy(), kv_mask)
        for key in ("k", "v"):
            np.testing.assert_allclose(trag[key].numpy()[:, kv_mask > 0],
                                       np.asarray(jrag[key])[:, kv_mask > 0], **TOL)
    assert int(trag["lengths"].max()) == 21 and (name == "gpt_bigcode" or
                                                 int(trag["lengths"].max()) > G9["sliding_window"])
    if name == "starcoder2":
        with pytest.raises(ValueError, match="exceeds sliding window"):
            tmod.forward_ragged_verify(tparams, tcfg, torch.ones((3, 17), dtype=torch.int64),
                                       trag, policy=TF32)


# ---------------------------------------------------------------------------
# the API's routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def im2svg_model():
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu_torch.models import starvector as tsv

    jcfg = jsv.tiny_config(image_size=56, llm=jgbc.tiny_config(attn_impl="mixed"))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    images = np.random.default_rng(0).standard_normal((3, 56, 56, 3)).astype(np.float32)
    return jcfg, tsv.tiny_config(image_size=56), tree, images


@pytest.mark.parametrize("B", [1, 3])
def test_api_im2svg_speculative_matches_jax_api(im2svg_model, B):
    from starvector_tpu.api import StarVectorForCausalLM as JModel
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.api import StarVectorForCausalLM as TModel

    jcfg, tcfg, tree, images = im2svg_model
    tok = build_test_tokenizer("v1")
    batch = {"image": images[:B]}
    kw = dict(max_length=16, use_nucleus_sampling=False, use_speculative=True, draft_len=4)
    ref = JModel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, tok,
                 policy=JF32).generate_im2svg(batch, **kw)
    port = TModel(convert.from_jax_params(tree), tcfg, tok, policy=TF32, device="cpu")
    out = port.generate_im2svg(batch, **kw)
    assert out == ref and len(out) == B
    plain = port.generate_im2svg(batch, **{**kw, "use_speculative": False})
    assert out == plain  # greedy: the same text


def test_api_speculative_falls_back_when_sampling(im2svg_model):
    """use_speculative with sampling on (or a logit bias) is plain decoding:
    the same ids from the same generator seed as without it."""
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.api import StarVectorForCausalLM as TModel

    _, tcfg, tree, images = im2svg_model
    tok = build_test_tokenizer("v1")
    for kw in (dict(use_nucleus_sampling=True, temperature=0.8),
               dict(use_nucleus_sampling=False, logit_bias={5: 1.0})):
        out = {}
        for spec in (True, False):
            port = TModel(convert.from_jax_params(tree), tcfg, tok, policy=TF32, device="cpu",
                          generator=torch.Generator().manual_seed(4))
            out[spec] = port.generate_im2svg_ids({"image": images[:2]}, max_length=12,
                                                 use_speculative=spec, **kw)
        for a, b in zip(out[True], out[False]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["1b", "8b"])
def test_api_text2svg_speculative_matches_jax_api(name):
    """text2svg's speculative route (rows moved to right padding, the
    batched path) against the JAX API's, for a tiny 1B (v1 tokenizer, rows
    padded right and moved left by the API) and a tiny 8B-shaped model (v2,
    left-padded, a window of 16 that the prompts and output run past)."""
    from starvector_tpu.api import StarVectorForCausalLM as JModel
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtokenizer
    from starvector_tpu_torch.api import StarVectorForCausalLM as TModel
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer as ttokenizer

    decoder, version = ("gpt_bigcode", "v1") if name == "1b" else ("starcoder2", "v2")
    jmod, jllm, _, tllm = DECODERS[decoder]
    jcfg = jsv.tiny_config(task="text2svg", decoder=decoder, llm=jllm)
    tcfg = tsv.tiny_config(task="text2svg", decoder=decoder, llm=tllm)
    tree = {"svg_transformer": _scaled_tree(jmod, jllm)}
    batch = {"caption": ["a red circle", "two blue squares on a white background", "star"]}
    kw = dict(max_new_tokens=NEW, use_nucleus_sampling=False, use_speculative=True, draft_len=K)
    ref = JModel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jtokenizer(version),
                 policy=JF32).generate_text2svg(batch, **kw)
    port = TModel(convert.from_jax_params(tree), tcfg, ttokenizer(version), policy=TF32,
                  device="cpu")
    out = port.generate_text2svg(batch, **kw)
    assert out == ref
    assert out == port.generate_text2svg(batch, **{**kw, "use_speculative": False})
