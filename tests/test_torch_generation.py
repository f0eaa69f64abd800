"""Port parity for num_return_sequences (generation/engine.py): the prompt
prefills once per distinct row and the filled cache, last logits and
presence table tile n times, rows grouped [p0 x n, p1 x n, ...].

Against starvector_tpu.generation.engine on the same numpy weights (the
tiny GPTBigCode, projections scaled by 10 so that greedy decoding does not
echo one token; 8-token prompts, the chunk step), fp32, greedy: the port's
ids and lengths equal JAX's num_return_sequences = 3 rows, with an fp32
cache and with int8 weights and an int8 cache (quantize_tree,
min_elems 1 << 12), and every row equals its prompt's n = 1 row (the JAX
package's prefill-once tests). The prefill runs at B rows, not B x n. The
tiled cache's n copies of a row are bit-identical, its scales too. Sampled
rows (the port draws from a torch.Generator, JAX from jax.random, so they
cannot match across packages) are held to properties: a seed gives one
result and top_k = 1 gives the greedy rows; greedy rows under repetition,
frequency and presence penalties equal JAX's. The API's text repeats each
prompt before its rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from starvector_tpu_torch.ops.quantization import quantize_tree

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
NEW, N_REP = 10, 3
PROMPTS = [[5, 9, 2, 7, 7, 1, 3, 8], [3, 1, 4, 1, 5, 9, 2, 6]]


@pytest.fixture(scope="module")
def model():
    jcfg = jgbc.tiny_config(attn_impl="mixed")
    tree = jax.tree_util.tree_map(np.asarray, jgbc.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    return jcfg, tgbc.tiny_config(), tree


def _jax(jcfg, tree, ids, kv=None, **kw):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ids = jnp.asarray(ids, jnp.int32)
    gen = jengine.GenerationConfig(max_new_tokens=NEW, do_sample=False, **kw)
    tokens, lengths = jengine.generate(params, jcfg, "gpt_bigcode", jgbc.embed_tokens(params, ids),
                                       jnp.ones(ids.shape, jnp.int32), gen,
                                       jax.random.PRNGKey(1), prompt_ids=ids, policy=JF32,
                                       kv_cache_dtype=kv)
    return np.asarray(tokens), np.asarray(lengths)


def _port(tcfg, params, ids, kv=None, generator=None, **kw):
    ids = torch.tensor(ids)
    gen = tengine.GenerationConfig(max_new_tokens=NEW, **{"do_sample": False, **kw})
    tokens, lengths = tengine.generate(params, tcfg, tgbc.embed_tokens(params, ids),
                                       torch.ones(ids.shape, dtype=torch.int32), gen, generator,
                                       prompt_ids=ids, policy=TF32, kv_cache_dtype=kv)
    return tokens.numpy(), lengths.numpy()


@pytest.mark.parametrize("cache", ["fp32", "int8"])
@pytest.mark.parametrize("B", [1, 2])
def test_num_return_sequences_matches_jax(model, monkeypatch, B, cache):
    from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree

    jcfg, tcfg, tree = model
    ids = PROMPTS[:B]
    if cache == "int8":
        jtree = jax.tree_util.tree_map(np.asarray, jquantize_tree(tree, min_elems=1 << 12,
                                                                  consume=False))
        params = quantize_tree(convert.from_jax_params(tree), min_elems=1 << 12)
        jkv, tkv = jnp.int8, torch.int8
    else:
        jtree, params, jkv, tkv = tree, convert.from_jax_params(tree), None, None
    ref, ref_len = _jax(jcfg, jtree, ids, jkv, num_return_sequences=N_REP)
    one, one_len = _port(tcfg, params, ids, tkv)

    rows = []  # the batch of every decoder call
    forward = tgbc.forward
    monkeypatch.setattr(tgbc, "forward",
                        lambda p, c, x, *a, **kw: rows.append(x.shape[0]) or forward(p, c, x, *a,
                                                                                      **kw))
    tokens, lengths = _port(tcfg, params, ids, tkv, num_return_sequences=N_REP)
    np.testing.assert_array_equal(tokens, ref)
    np.testing.assert_array_equal(lengths, ref_len)
    assert tokens.shape == (B * N_REP, NEW)
    np.testing.assert_array_equal(tokens, one.repeat(N_REP, axis=0))  # grouped, as HF expands
    np.testing.assert_array_equal(lengths, one_len.repeat(N_REP))
    assert all(len(set(row.tolist())) >= 3 for row in one)
    assert rows == [B] + [B * N_REP] * (NEW - 1)  # one prefill at B rows


def test_tiled_int8_cache_rows_share_their_prefill_bits(model):
    _, tcfg, tree = model
    params = quantize_tree(convert.from_jax_params(tree), min_elems=1 << 12)
    ids = torch.tensor(PROMPTS)
    cache = tgbc.init_cache(tcfg, 2, 12, dtype=torch.int8)
    tgbc.forward(params, tcfg, tgbc.embed_tokens(params, ids), cache=cache, policy=TF32)
    tiled = tdc.tile_rows(cache, N_REP)
    assert tiled["index"] == cache["index"] == 8
    for key in ("k", "v", "k_scale", "v_scale", "kv_mask"):
        dim = 0 if key == "kv_mask" else 1
        assert tiled[key].shape[dim] == 2 * N_REP
        for r in range(2 * N_REP):
            assert torch.equal(tiled[key].select(dim, r), cache[key].select(dim, r // N_REP)), key


def test_sampled_return_sequences(model):
    """Sampling: rows come grouped per prompt (top_k = 1: each row its
    prompt's greedy row), and a seed gives one result."""
    _, tcfg, tree = model
    params = convert.from_jax_params(tree)
    greedy, _ = _port(tcfg, params, PROMPTS)
    top1, _ = _port(tcfg, params, PROMPTS, generator=torch.Generator().manual_seed(0),
                    do_sample=True, top_k=1, num_return_sequences=N_REP)
    np.testing.assert_array_equal(top1, greedy.repeat(N_REP, axis=0))
    kw = dict(do_sample=True, temperature=0.9, top_p=0.95, num_return_sequences=4,
              repetition_penalty=1.3, frequency_penalty=0.1)
    a, la = _port(tcfg, params, PROMPTS, generator=torch.Generator().manual_seed(3), **kw)
    b, lb = _port(tcfg, params, PROMPTS, generator=torch.Generator().manual_seed(3), **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert a.shape == (8, NEW) and len({tuple(r) for r in a}) > 2


def test_penalized_return_sequences_match_jax(model):
    """Greedy under a repetition penalty (the presence table, the prompt's
    ids in it, tiled with the cache) and frequency / presence penalties
    (counts over the B x n rows): JAX's rows."""
    jcfg, tcfg, tree = model
    kw = dict(repetition_penalty=1.3, frequency_penalty=0.4, presence_penalty=0.2,
              num_return_sequences=N_REP)
    ref, ref_len = _jax(jcfg, tree, PROMPTS, **kw)
    tokens, lengths = _port(tcfg, convert.from_jax_params(tree), PROMPTS, **kw)
    np.testing.assert_array_equal(tokens, ref)
    np.testing.assert_array_equal(lengths, ref_len)
    plain, _ = _port(tcfg, convert.from_jax_params(tree), PROMPTS)
    assert (tokens != plain.repeat(N_REP, axis=0)).any()  # the penalties acted


def test_api_num_return_sequences_matches_jax_api():
    """The API's greedy num_return_sequences=2 text, each with its prompt,
    equals the JAX API's, on the tiny 1B of tests/test_torch_im2svg.py."""
    from starvector_tpu.api import StarVectorForCausalLM as JModel
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.api import StarVectorForCausalLM as TModel
    from starvector_tpu_torch.models import starvector as tsv

    jcfg = jsv.tiny_config(image_size=56, llm=jgbc.tiny_config(attn_impl="mixed"))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    images = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)
    tok = build_test_tokenizer("v1")
    kw = dict(max_length=8, use_nucleus_sampling=False, num_return_sequences=2)
    ref = JModel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, tok,
                 policy=JF32).generate_im2svg({"image": images}, **kw)
    port = TModel(convert.from_jax_params(tree), tsv.tiny_config(image_size=56), tok,
                  policy=TF32, device="cpu")
    out = port.generate_im2svg({"image": images}, **kw)
    assert out == ref and len(out) == 4 and out[0] == out[1] and out[2] == out[3]
    prompt, tokens, lengths = port.generate_im2svg_ids({"image": images}, **kw)
    assert prompt.shape[0] == tokens.shape[0] == lengths.shape[0] == 4


def test_pipelined_generation_is_not_ported():
    for fn in (tengine.generate_pipelined, tengine.generate_pipelined_spec):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
            fn()
