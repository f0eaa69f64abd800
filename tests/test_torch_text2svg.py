"""text2svg end to end on the CPU: captions -> SVG token ids through the
port against starvector_tpu on the same weights, for a tiny 1B (GPTBigCode,
the v1 tokenizer, right padding moved left) and a tiny 8B-shaped model
(StarCoder2 with 18 query heads over 2 KV heads, G = 9 as the 8B's 36 over
4, a window of 32; the v2 tokenizer, left padding). There is no vision
tower: the caption + <svg-start> ids (truncated to max_length 30) are the
whole prefix, at most 30 tokens, so both decoders prefill through their
chunk step (plain PyTorch here, XLA in JAX) and decode through kernel 2
(its plain version on the CPU).

The decoders' projection kernels are scaled by 10 (greedy decoding then
does not echo one token). Generation stops on eos: the tiny 1B emits it
unprompted on one caption; the tiny 8B gets an eos logit bias of 0.8 (the
API's logit_bias) under which two of four rows stop. Token ids and API
text must be identical in fp32; bf16 logits (unscaled weights) no further
from JAX's fp32 logits than 1.5 x JAX's own bf16 logits are, plus 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.api import StarVectorForCausalLM as JModel
from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.models.tokenizer import build_test_tokenizer as jtokenizer
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.api import StarVectorForCausalLM as TModel
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.tokenizer import build_test_tokenizer as ttokenizer
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
NEW = 24
# ragged captions: the second is cut at max_length (its <svg-start> with it)
CAPTIONS = ["a red circle", "two blue squares on a white background", "star",
            "a green triangle"]
G9 = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288, sliding_window=32)
MODELS = {  # name: (decoder, tokenizer version, eos logit bias)
    "1b": ("gpt_bigcode", "v1", 0.0),
    "8b": ("starcoder2", "v2", 0.8),
}


def _configs(name):
    decoder, _, _ = MODELS[name]
    if decoder == "gpt_bigcode":
        return (jsv.tiny_config(task="text2svg", llm=jgbc.tiny_config(attn_impl="mixed")),
                tsv.tiny_config(task="text2svg", llm=tgbc.tiny_config()))
    return (jsv.tiny_config(task="text2svg", decoder=decoder,
                            llm=jsc.tiny_config(attn_impl="mixed", **G9)),
            tsv.tiny_config(task="text2svg", decoder=decoder, llm=tsc.tiny_config(**G9)))


def _tree(jcfg, scale: float):
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    assert set(tree) == {"svg_transformer"}  # text2svg has no vision tower
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * scale
    return tree


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name = request.param
    jcfg, tcfg = _configs(name)
    return name, jcfg, tcfg, _tree(jcfg, 10.0)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_caption_ids_match_the_jax_tokenizer(version):
    """caption + <svg-start>, truncated to max_length, no special tokens:
    the port's tokenizer gives the JAX one's ids and mask (v1 pads right,
    v2 left)."""
    jt, tt = jtokenizer(version), ttokenizer(version)
    texts = [c + tt.svg_start_token for c in CAPTIONS]
    for max_length in (30, 8):
        ref = jt(texts, max_length=max_length, add_special_tokens=False)
        out = tt(texts, max_length=max_length, add_special_tokens=False)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(out[key], ref[key])
    assert (tt.svg_start_token, tt.eos_token_id, tt.pad_token_id) == \
        (jt.svg_start_token, jt.eos_token_id, jt.pad_token_id)
    assert tt.padding_side == ("left" if version == "v2" else "right")


def test_text2svg_inputs_match_jax(model):
    name, jcfg, tcfg, tree = model
    tok = ttokenizer(MODELS[name][1])
    enc = tok([c + tok.svg_start_token for c in CAPTIONS], max_length=30,
              add_special_tokens=False)
    ids, mask = enc["input_ids"], enc["attention_mask"]
    ref = jsv.text2svg_inputs(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(ids),
                              jnp.asarray(mask), tok.pad_token_id, policy=JF32)
    out = tsv.text2svg_inputs(convert.from_jax_params(tree), tcfg, torch.from_numpy(ids).long(),
                              torch.from_numpy(mask), tok.pad_token_id, policy=TF32)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert out[1].dtype == torch.int32 and (out[2][torch.from_numpy(mask) == 0] == -100).all()


def test_greedy_text2svg_ids_match_jax(model, monkeypatch):
    """The engine's generate_text2svg on the API's left-padded caption ids,
    against the JAX engine's, with eos stopping and a repetition penalty
    (the prompt's pads count as seen tokens in both)."""
    name, jcfg, tcfg, tree = model
    _, version, bias = MODELS[name]
    port = TModel(convert.from_jax_params(tree), tcfg, ttokenizer(version), policy=TF32,
                  device="cpu")
    ids, mask = port._caption_ids(CAPTIONS, 30)
    assert (mask[:, -1] == 1).all() and (mask == 0).any()  # ragged, left-padded
    eos = port.tokenizer.eos_token_id
    plain = {"flash_prefill_plain": 0, "decode_attention_plain": 0}
    for fn_name in plain:
        fn = getattr(tfa, fn_name)

        def counted(*a, _fn=fn, _name=fn_name, **kw):
            plain[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tfa, fn_name, counted)
    for penalty in (1.0, 1.3):
        kw = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=eos, repetition_penalty=penalty,
                  logit_bias=((eos, bias),), pad_token_id=port.tokenizer.pad_token_id)
        ref, ref_len = jengine.generate_text2svg(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(ids.numpy()),
            jnp.asarray(mask.numpy()), jengine.GenerationConfig(**kw), jax.random.PRNGKey(1),
            policy=JF32)
        plain.update(dict.fromkeys(plain, 0))
        tokens, lengths = tengine.generate_text2svg(
            port.params, tcfg, ids, mask, tengine.GenerationConfig(**kw), policy=TF32)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
        L = tcfg.llm.n_layer
        assert plain == {"flash_prefill_plain": 0,
                         "decode_attention_plain": L * (int(ref_len.max()) - 1)}
        if penalty == 1.0:  # some rows stop on eos, not all
            ref, ref_len = np.asarray(ref), np.asarray(ref_len)
            stopped = [ref[b, n - 1] == eos for b, n in enumerate(ref_len)]
            assert any(stopped) and not all(stopped) and (ref_len < NEW).any()


def test_api_text2svg_matches_jax_api(model):
    """The API's text (generated tokens only, no caption) equals the JAX
    API's; use_speculative raises, naming its ROADMAP item."""
    name, jcfg, tcfg, tree = model
    _, version, bias = MODELS[name]
    jt, tt = jtokenizer(version), ttokenizer(version)
    batch = {"caption": CAPTIONS}
    kw = dict(max_new_tokens=NEW, use_nucleus_sampling=False, logit_bias={jt.eos_token_id: bias})
    ref = JModel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jt,
                 policy=JF32).generate_text2svg(batch, **kw)
    port = TModel(convert.from_jax_params(tree), tcfg, tt, policy=TF32, device="cpu")
    assert port.generate_text2svg(batch, **kw) == ref
    assert not any(t.startswith(c) for t, c in zip(ref, CAPTIONS))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        port.generate_text2svg(batch, **kw, use_speculative=True)


def _prompt_and_step_logits(mod, params, cfg, ids, mask, nxt, policy, cache_dtype):
    """The decoder's logits over the caption prompt (the chunk step), then
    for one more token `nxt` (a decode step), with either package (`mod`
    its decoder module; ids, mask and nxt its arrays)."""
    B, S = ids.shape
    emb = policy.cast(mod.embed_tokens(params, ids))
    cache = mod.init_cache(cfg, B, S + 1, dtype=cache_dtype)
    prompt, cache = mod.forward(params, cfg, emb, mask, cache=cache, policy=policy)
    step, _ = mod.forward(params, cfg, policy.cast(mod.embed_tokens(params, nxt)), cache=cache,
                          policy=policy)
    return np.asarray(prompt, np.float32), np.asarray(step, np.float32)


def test_bf16_text2svg_logits_match_jax(model):
    """bf16 compute and cache, unscaled weights: the prompt's logits at its
    live positions and one decode step's. Both packages round bf16
    activations, in different orders, so each lands about one bf16 step
    of the logits from the fp32 logits (4e-3 on the 1B's |logits| <= 0.93,
    9e-3 on the 8B's <= 1.37): the port's bf16 logits may be no further
    from JAX's fp32 ones than 1.5 x JAX's bf16 logits are, plus 1e-3."""
    name, jcfg, tcfg, _ = model
    tree = _tree(jcfg, 1.0)
    tok = ttokenizer(MODELS[name][1])
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)["svg_transformer"]
    tparams = convert.from_jax_params(tree)
    ids, mask = TModel(tparams, tcfg, tok, device="cpu")._caption_ids(CAPTIONS, 30)
    jmod, tmod = jcfg.decoder_module, tcfg.decoder_module
    jids, jmask = jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy())

    def jax_logits(nxt, policy, dtype):
        return _prompt_and_step_logits(jmod, jparams, jcfg.llm, jids, jmask, jnp.asarray(nxt),
                                       policy, dtype)

    nxt = jax_logits(np.zeros((4, 1), np.int32), JF32, jnp.float32)[0][:, -1].argmax(-1)[:, None]
    ref, jax16 = jax_logits(nxt, JF32, jnp.float32), jax_logits(nxt, JPolicy(), jnp.bfloat16)
    ours = _prompt_and_step_logits(tmod, tparams["svg_transformer"], tcfg.llm, ids, mask,
                                   torch.from_numpy(nxt).long(), TPolicy(), torch.bfloat16)
    live = mask.numpy().astype(bool)
    for k, (r, j, o) in enumerate(zip(ref, jax16, ours)):
        r, j, o = (x[live] if k == 0 else x for x in (r, j, o))
        jerr, err = np.abs(j - r).max(), np.abs(o - r).max()
        assert err <= 1.5 * jerr + 1e-3, (k, err, jerr)
        assert (o == o.astype(jnp.bfloat16).astype(np.float32)).mean() < 0.05  # an fp32 head
