"""Port parity for beam search (generation/beam.py) against
starvector_tpu.generation.beam on the same numpy weights and prefixes, fp32.

Two tiny decoders: the 1B's GPTBigCode and an 8B-shaped StarCoder2 (18
query heads over 2 KV heads, G = 9, and a window of 16 that the 12-token
prefix and 20 new tokens run past). Projections are scaled by 10 so that
the beam scores are not all near-ties; the prefix (12 tokens) takes both
packages' chunk step. Token ids and lengths must be identical: with
K in {1, 2, 3}, ending on a stop sequence and on eos (ids the port's own
unstopped beams emit, so that the pool fills), K = 1 equal to greedy
generate, a model whose logits all tie (the pool and the dead beams' NEG_INF
candidates tie too), a decoder quantized by quantize_tree (min_elems 1 << 12:
every projection), HF GPTBigCode's generate(num_beams=2), and the API's
num_beams=2 text against the JAX API's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import beam as jbeam
from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.generation import beam as tbeam
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
P, NEW = 12, 20
G9 = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288, sliding_window=16)
DECODERS = {
    "gpt_bigcode": (jgbc, jgbc.tiny_config(attn_impl="mixed"), tgbc, tgbc.tiny_config()),
    "starcoder2": (jsc, jsc.tiny_config(attn_impl="mixed", **G9), tsc, tsc.tiny_config(**G9)),
}


def _scaled_tree(jmod, jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(seed)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    return tree


@pytest.fixture(scope="module", params=list(DECODERS))
def decoder(request):
    jmod, jcfg, tmod, tcfg = DECODERS[request.param]
    tree = _scaled_tree(jmod, jcfg)
    ids = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, P))
    embeds = np.asarray(jmod.embed_tokens(jax.tree_util.tree_map(jnp.asarray, tree),
                                          jnp.asarray(ids)), np.float32)
    return request.param, jcfg, tcfg, tree, embeds


def _jax_beams(name, jcfg, tree, embeds, **kw):
    tokens, lengths = jbeam.beam_search(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(embeds),
        jnp.ones(embeds.shape[:2], jnp.int32), dec_name=name, llm_cfg=jcfg, policy=JF32, **kw)
    return np.asarray(tokens), np.asarray(lengths)


def _port_beams(tcfg, params, embeds, **kw):
    tokens, lengths = tbeam.beam_search(params, tcfg, torch.from_numpy(embeds.copy()),
                                        torch.ones(embeds.shape[:2], dtype=torch.int32),
                                        policy=TF32, **kw)
    return tokens.numpy(), lengths.numpy()


@pytest.mark.parametrize("end", ["stop", "eos"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_beam_search_matches_jax(decoder, K, end):
    name, jcfg, tcfg, tree, embeds = decoder
    params = convert.from_jax_params(tree)
    free, _ = _port_beams(tcfg, params, embeds, num_beams=K, max_new_tokens=NEW)
    # an end the beams reach: row 0's tokens 3-4 as a stop, or its token 5 as eos
    kw = (dict(stop_sequences=((int(free[0, 3]), int(free[0, 4])),)) if end == "stop"
          else dict(eos_token_id=int(free[0, 5])))
    kw.update(num_beams=K, max_new_tokens=NEW, pad_token_id=0)
    ref, ref_len = _jax_beams(name, jcfg, tree, embeds, **kw)
    launches = (tfa.flash_prefill.launches, tfa.decode_attention.launches)
    tokens, lengths = _port_beams(tcfg, params, embeds, **kw)
    np.testing.assert_array_equal(tokens, ref)
    np.testing.assert_array_equal(lengths, ref_len)
    # the end changed the search: a row ends on it, or the beams went elsewhere
    assert (ref_len < NEW).any() or (ref != free).any(), ref_len
    assert all(len(set(row[:n].tolist())) >= 3 for row, n in zip(ref, ref_len))
    # on the CPU the kernels' plain versions ran
    assert (tfa.flash_prefill.launches, tfa.decode_attention.launches) == launches


def test_beam1_equals_greedy(decoder):
    _, _, tcfg, tree, embeds = decoder
    params = convert.from_jax_params(tree)
    greedy, _ = tengine.generate(params, tcfg, torch.from_numpy(embeds.copy()),
                                 torch.ones(embeds.shape[:2], dtype=torch.int32),
                                 tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False),
                                 policy=TF32)
    tokens, lengths = _port_beams(tcfg, params, embeds, num_beams=1, max_new_tokens=NEW)
    np.testing.assert_array_equal(tokens, greedy.numpy())
    assert (lengths == NEW).all()


def test_top_k_puts_the_lower_index_first_on_ties():
    x = np.asarray([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9, 0.5, -1e9]], np.float32)
    for k in (2, 5, 8):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = tbeam._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


def test_beams_over_tied_logits_match_jax():
    """A zero embedding table: every logit is 0, so all K x V candidates tie
    at each step (the dead beams' near-NEG_INF ones among themselves), and
    eos = 3 is among the 2K first: the JAX order, the lower index first,
    decides every pick and what enters the pool."""
    jmod, jcfg, _, tcfg = DECODERS["gpt_bigcode"]
    tree = _scaled_tree(jmod, jcfg)
    tree["wte"] = np.zeros_like(tree["wte"])
    embeds = np.zeros((2, P, jcfg.hidden_size), np.float32)
    kw = dict(num_beams=3, max_new_tokens=8, eos_token_id=3, pad_token_id=0)
    ref, ref_len = _jax_beams("gpt_bigcode", jcfg, tree, embeds, **kw)
    tokens, lengths = _port_beams(tcfg, convert.from_jax_params(tree), embeds, **kw)
    np.testing.assert_array_equal(tokens, ref)
    np.testing.assert_array_equal(lengths, ref_len)


def test_beams_over_a_quantized_decoder_match_jax(decoder):
    from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree
    from starvector_tpu_torch.ops.quantization import quantize_tree

    name, jcfg, tcfg, tree, embeds = decoder
    qtree = jax.tree_util.tree_map(np.asarray, jquantize_tree(tree, min_elems=1 << 12,
                                                              consume=False))
    kw = dict(num_beams=2, max_new_tokens=12, pad_token_id=0)
    ref, ref_len = _jax_beams(name, jcfg, qtree, embeds, **kw)
    params = quantize_tree(convert.from_jax_params(tree), min_elems=1 << 12)
    assert "kernel_q" in params["layers"]["mlp"]["c_fc"]
    tokens, lengths = _port_beams(tcfg, params, embeds, **kw)
    np.testing.assert_array_equal(tokens, ref)
    np.testing.assert_array_equal(lengths, ref_len)


def test_beam_search_matches_hf_generate():
    """HF GPTBigCodeForCausalLM.generate(num_beams=2, early_stopping=False)
    on the same weights (the JAX package's tests/test_hf_parity.py case):
    tokens equal up to the port's length."""
    from transformers import GPTBigCodeConfig, GPTBigCodeForCausalLM

    hf_cfg = GPTBigCodeConfig(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=4,
                              multi_query=True, attn_implementation="eager", resid_pdrop=0.0,
                              embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    model = GPTBigCodeForCausalLM(hf_cfg).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert.gpt_bigcode_from_hf(sd, prefix="transformer.")
    B, NEW_HF, eos = 2, 24, 7
    ids = np.random.RandomState(0).randint(1, 512, size=(B, 6))
    with torch.no_grad():
        hf = model.generate(torch.from_numpy(ids), max_new_tokens=NEW_HF, num_beams=2,
                            do_sample=False, eos_token_id=eos, pad_token_id=0,
                            length_penalty=1.0, early_stopping=False).numpy()[:, 6:]
    tcfg = tgbc.tiny_config()
    embeds = tgbc.embed_tokens(params, torch.from_numpy(ids)).numpy()
    tokens, lengths = _port_beams(tcfg, params, embeds, num_beams=2, max_new_tokens=NEW_HF,
                                  eos_token_id=eos, pad_token_id=0)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_array_equal(tokens[b, :n], hf[b, :n])


def test_api_num_beams_matches_jax_api():
    """The API's num_beams=2 route (beam_search over the [visual ‖ prompt]
    prefix, the prompt before the text) against the JAX API's, on the tiny
    1B of tests/test_torch_im2svg.py (a 56 px tower: 65 visual tokens, so
    both prefill through their flash paths)."""
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
    kw = dict(max_length=10, use_nucleus_sampling=False, num_beams=2)
    ref = JModel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, tok,
                 policy=JF32).generate_im2svg({"image": images}, **kw)
    port = TModel(convert.from_jax_params(tree), tsv.tiny_config(image_size=56), tok,
                  policy=TF32, device="cpu")
    out = port.generate_im2svg({"image": images}, **kw)
    assert out == ref and all(t.startswith("<svg") for t in out)
