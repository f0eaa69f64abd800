"""The slice end to end: image -> SVG token ids through the port against
starvector_tpu on the same weights and images, greedy, in fp32.

Tiny config: a 56 px CLIP tower gives 65 visual tokens, plus 4 prompt ids,
so the 69-token prefix (> 64) takes the JAX decoder's Pallas flash prefill
(interpret mode) under attn_impl="mixed". At random init a tiny decoder
echoes one token forever, so the decoder's projection kernels are scaled
by 10 until every row emits at least 3 distinct ids. Token ids must be
identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
PROMPT = [60, 116, 119, 104]
STOP = ((250, 380),)
NEW = 16


@pytest.fixture(scope="module")
def model():
    jcfg = jsv.tiny_config(image_size=56, llm=jgbc.tiny_config(attn_impl="mixed"))
    tcfg = tsv.tiny_config(image_size=56)
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    images = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)
    return jcfg, tcfg, tree, images


@pytest.fixture(scope="module")
def jax_ids(model):
    jcfg, _, tree, images = model
    gen = jengine.GenerationConfig(max_new_tokens=NEW, do_sample=False, stop_sequences=STOP)
    tokens, lengths = jengine.generate_im2svg(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(images),
        jnp.asarray([PROMPT] * 2, jnp.int32), gen, jax.random.PRNGKey(1), policy=JF32)
    return np.asarray(tokens), np.asarray(lengths)


def test_greedy_im2svg_ids_match_jax(model, jax_ids, monkeypatch):
    _, tcfg, tree, images = model
    plain_calls = {"flash_prefill_plain": 0, "decode_attention_plain": 0}
    for name in plain_calls:
        fn = getattr(tfa, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            plain_calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    launches = (tfa.flash_prefill.launches, tfa.decode_attention.launches)

    gen = tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False, stop_sequences=STOP)
    tokens, lengths = tengine.generate_im2svg(
        convert.from_jax_params(tree), tcfg, torch.from_numpy(images),
        torch.tensor([PROMPT] * 2), gen, policy=TF32)

    ref_tokens, ref_lengths = jax_ids
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_array_equal(lengths.numpy(), ref_lengths)
    for row, n in zip(ref_tokens, ref_lengths):
        assert len(set(row[:n].tolist())) >= 3, row
    assert (ref_lengths < NEW).any() and (ref_lengths == NEW).any()  # one row stopped on STOP
    # on the CPU the kernels' plain versions ran, once per layer per forward
    n_layer = tcfg.llm.n_layer
    assert plain_calls == {"flash_prefill_plain": n_layer,
                           "decode_attention_plain": n_layer * (int(ref_lengths.max()) - 1)}
    assert (tfa.flash_prefill.launches, tfa.decode_attention.launches) == launches


def test_api_generate_im2svg_matches_jax_api(model):
    from starvector_tpu.api import StarVectorForCausalLM as JModel
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.api import StarVectorForCausalLM as TModel

    jcfg, tcfg, tree, images = model
    tok = build_test_tokenizer("v1")
    batch = {"image": images}
    kw = dict(max_length=8, use_nucleus_sampling=False)
    ref = JModel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, tok,
                 policy=JF32).generate_im2svg(batch, **kw)
    port = TModel(convert.from_jax_params(tree), tcfg, tok, policy=TF32, device="cpu")
    assert port.generate_im2svg(batch, **kw) == ref
    for unported in (dict(num_beams=2), dict(use_speculative=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.generate_im2svg(batch, **kw, **unported)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.generate_text2svg({"caption": ["a red circle"]}, use_speculative=True)


def test_from_config_draws_weights_from_the_seed():
    from starvector_tpu_torch.api import StarVectorForCausalLM

    cfg = tsv.tiny_config(image_size=56, adapter_norm="batch_norm")
    a = StarVectorForCausalLM.from_config(cfg, seed=5, device="cpu")
    b = StarVectorForCausalLM.from_config(cfg, seed=5, device="cpu")
    wa = a.params["svg_transformer"]["layers"]["mlp"]["c_fc"]["kernel"]
    assert wa.shape == (2, 64, 256) and a.policy.compute_dtype == torch.float32
    assert torch.equal(wa, b.params["svg_transformer"]["layers"]["mlp"]["c_fc"]["kernel"])
    img = np.random.default_rng(2).integers(0, 256, (30, 45, 4), dtype=np.uint8)
    prompt, tokens, lengths = a.generate_im2svg_ids(
        {"image": a.process_images([img])}, prompt_ids=[PROMPT], stop_sequences=STOP,
        max_new_tokens=5, use_nucleus_sampling=False)
    assert tokens.shape == (1, 5) and prompt.tolist() == [PROMPT] and int(lengths[0]) <= 5


def test_sampled_generation(model, jax_ids):
    """Sampling draws from a torch.Generator: top_k=1 must reproduce the
    greedy ids, one seed gives one sequence, and the penalty, bias and
    min-p processors run through the loop."""
    _, tcfg, tree, images = model
    params = convert.from_jax_params(tree)
    args = (params, tcfg, torch.from_numpy(images), torch.tensor([PROMPT] * 2))

    def run(seed, **kw):
        gen = tengine.GenerationConfig(max_new_tokens=NEW, stop_sequences=STOP, **kw)
        return tengine.generate_im2svg(*args, gen, torch.Generator().manual_seed(seed),
                                       policy=TF32)

    tokens, _ = run(0, top_k=1)
    np.testing.assert_array_equal(tokens.numpy(), jax_ids[0])
    a, la = run(3, temperature=0.8, top_p=0.95, repetition_penalty=1.3, frequency_penalty=0.2,
                presence_penalty=0.1, min_p=0.01, logit_bias=((5, 2.0),))
    b, lb = run(3, temperature=0.8, top_p=0.95, repetition_penalty=1.3, frequency_penalty=0.2,
                presence_penalty=0.1, min_p=0.01, logit_bias=((5, 2.0),))
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.llm.vocab_size
