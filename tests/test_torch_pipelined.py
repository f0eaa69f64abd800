"""Port parity for offline pipelined generation (generation/engine.py::
generate_pipelined): batch k + 1's prompt prefilled C positions a decode
step of batch k, through GPTBigCode's fused forward_decode_with_chunk (the
1B) or, for StarCoder2, the cached decode forward and the chunk step.

Against starvector_tpu on the same numpy weights and inputs, fp32 compute:
  * forward_decode_with_chunk on the same caches, a compute-dtype (fp32)
    cache and an int8 one: the decode logits and the chunk's last-position
    logits (JAX's chunk_logits[:, -1]) at rtol = atol = 1e-5; both caches'
    k/v at the slots their key masks show at rtol = atol = 1e-5 (an int8
    cache's scales at that tolerance, its codes at most one code apart and
    equal on >= 99%: fp32 sums in another order move a value across a
    rounding boundary); key masks and indices exactly. The slots a mask
    hides are never read: a left-padded row's all-pad chunk attends over
    nothing real, and the two packages average different hidden slots
    there. Mismatched cache types raise ValueError.
  * generate_pipelined over 3 batches of 2 rows, one of them left-padded,
    with a stop sequence that fires: ids and lengths equal JAX's for the
    tiny 1B (default chunk, chunk_positions 4 and 5, a prompt that the
    chunks do not divide, and 1, which would need more chunks than decode
    steps and is re-derived by the rule), repetition_penalty 1.3 with prompt_ids, int8
    weights (quantize_tree, min_elems 1 << 12), an int8 KV cache, both;
    each batch also equals the port's generate on that left-padded batch.
    The same for a tiny 8B-shaped StarCoder2 (window 16) whose Pn +
    max_new_tokens passes its window, which has no fused forward.
  * a later prompt wider than batch 0's padded width raises ValueError;
    a narrower one is left-padded.
  * JAX's own generate_pipelined over an int8 KV cache parts from JAX's
    per-batch generate (a chunk attends over its own keys unquantized),
    while over an fp32 cache the two agree.
  * sampling: do_sample with top_k = 1 gives greedy's ids, and one
    torch.Generator seed gives one result (the port samples from torch's
    generator, JAX from jax.random: sampled ids cannot match across them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from starvector_tpu_torch.ops.quantization import quantize_tree

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
NEW = 8
SC2 = dict(num_attention_heads=4, num_key_value_heads=2, sliding_window=16)
DECODERS = {
    "gpt_bigcode": (jgbc, jgbc.tiny_config(), tgbc, tgbc.tiny_config()),
    "starcoder2": (jsc, jsc.tiny_config(**SC2), tsc, tsc.tiny_config(**SC2)),
}
# projections x 10: tiny greedy decoding does not echo one token
SCALE = 10.0


def _tree(name):
    jmod, jcfg, _, _ = DECODERS[name]
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * SCALE
    return tree


@pytest.fixture(scope="module")
def bigcode():
    return _tree("gpt_bigcode")


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batches(jmod, tree, P, seed=0, n=3):
    """n batches of 2 rows of P ids' embeddings, row 1 left-padded by 3;
    with their ids (pads 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(5, 512, (2, P))
        ids[1, :3] = 0
        emb = np.array(jmod.embed_tokens(_jparams(tree), jnp.asarray(ids)), np.float32)
        mask = np.ones((2, P), np.int32)
        mask[1, :3] = 0
        emb[1, :3] = 0.0
        out.append((emb, mask, ids))
    return out


def _jax_pipelined(name, tree, batches, kv=None, prompt=False, **kw):
    jmod, jcfg, _, _ = DECODERS[name]
    gen = jengine.GenerationConfig(**{"max_new_tokens": NEW, "do_sample": False,
                                      **kw.pop("gen", {})})
    out = jengine.generate_pipelined(
        _jparams(tree), jcfg, name, [(jnp.asarray(e), jnp.asarray(m)) for e, m, _ in batches],
        gen, jax.random.PRNGKey(1), policy=JF32, kv_cache_dtype=kv,
        prompt_ids=[ids for _, _, ids in batches] if prompt else None, **kw)
    return [(np.asarray(t), np.asarray(l)) for t, l in out]


def _port_pipelined(name, params, batches, kv=None, prompt=False, generator=None, **kw):
    _, _, _, tcfg = DECODERS[name]
    gen = tengine.GenerationConfig(**{"max_new_tokens": NEW, "do_sample": False,
                                      **kw.pop("gen", {})})
    out = tengine.generate_pipelined(
        params, tcfg, [(torch.from_numpy(e), torch.from_numpy(m)) for e, m, _ in batches], gen,
        generator, policy=TF32, kv_cache_dtype=kv,
        prompt_ids=[torch.from_numpy(ids) for _, _, ids in batches] if prompt else None, **kw)
    return [(t.numpy(), l.numpy()) for t, l in out]


def _stop(name, params, batches):
    """A stop sequence that fires in batch 0's row 0: its free run's tokens
    2 and 3."""
    free = _port_pipelined(name, params, batches[:1])[0][0]
    return ((int(free[0, 2]), int(free[0, 3])),)


# name: (P, chunk_positions, repetition penalty with prompt ids, int8 weights, int8 cache)
CASES = {
    "default_chunk": (12, None, False, False, False),
    "chunk4": (12, 4, False, False, False),
    "chunk5_undivided": (13, 5, False, False, False),
    "chunk1_rederived": (12, 1, False, False, False),  # 12 chunks > 8 steps: C = 4
    "repetition": (12, None, True, False, False),
    "int8_weights": (12, 4, False, True, False),
    "int8_kv": (12, None, False, False, True),
    "int8_weights_and_kv": (13, None, False, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_matches_jax(bigcode, monkeypatch, case):
    P, chunk, rep, q_weights, q_kv = CASES[case]
    tree = bigcode
    params = convert.from_jax_params(tree)
    if q_weights:
        tree = jax.tree_util.tree_map(np.asarray, jquantize_tree(tree, min_elems=1 << 12,
                                                                 consume=False))
        params = quantize_tree(params, min_elems=1 << 12)
    batches = _batches(jgbc, bigcode, P)
    gen = dict(stop_sequences=_stop("gpt_bigcode", params, batches),
               **({"repetition_penalty": 1.3} if rep else {}))
    kw = dict(prompt=rep, chunk_positions=chunk, gen=gen)
    ref = _jax_pipelined("gpt_bigcode", tree, batches, jnp.int8 if q_kv else None, **dict(kw))
    fused = []
    forward = tgbc.forward_decode_with_chunk_static
    monkeypatch.setattr(tgbc, "forward_decode_with_chunk_static",
                        lambda *a, **k: fused.append(1) or forward(*a, **k))
    out = _port_pipelined("gpt_bigcode", params, batches, torch.int8 if q_kv else None,
                          **dict(kw))
    assert len(out) == 3 and fused  # the 1B's steps went through the fused forward
    for i, ((rt, rl), (pt, pl)) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(pt, rt, err_msg=f"batch {i}")
        np.testing.assert_array_equal(pl, rl, err_msg=f"batch {i}")
    assert (ref[0][1] < NEW).any()  # the stop fired
    if case == "default_chunk":
        assert len({tuple(r) for t, _ in out for r in t}) == 6  # rows differ
        # each batch is what generate gives on it (P = 12 = 3 chunks of 4: no padding)
        for (emb, mask, _), (pt, pl) in zip(batches, out):
            gt, gl = tengine.generate(params, tgbc.tiny_config(), torch.from_numpy(emb),
                                      torch.from_numpy(mask), tengine.GenerationConfig(
                                          max_new_tokens=NEW, do_sample=False, **gen),
                                      policy=TF32)
            np.testing.assert_array_equal(pt, gt.numpy())
            np.testing.assert_array_equal(pl, gl.numpy())


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_pipelined_8b_past_its_window_matches_jax(kv):
    """A tiny StarCoder2 (window 16): C = 4, Pn = 16 and 10 new tokens, so
    both caches run past the window; each step is the cached decode
    forward (kernel 2's t_begin from the window) and the chunk step (RoPE
    positions from the chunk's mask, the window per query)."""
    tree = _tree("starcoder2")
    batches = _batches(jsc, tree, 13, seed=1)
    params = convert.from_jax_params(tree)
    ref = _jax_pipelined("starcoder2", tree, batches, jnp.int8 if kv == "int8" else None,
                         gen=dict(max_new_tokens=10))
    out = _port_pipelined("starcoder2", params, batches, torch.int8 if kv == "int8" else None,
                          gen=dict(max_new_tokens=10))
    assert not hasattr(tsc, "forward_decode_with_chunk")
    for i, ((rt, rl), (pt, pl)) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(pt, rt, err_msg=f"batch {i}")
        np.testing.assert_array_equal(pl, rl, err_msg=f"batch {i}")
    assert 16 + 10 > SC2["sliding_window"]


def test_pipelined_sampling(bigcode):
    params = convert.from_jax_params(bigcode)
    batches = _batches(jgbc, bigcode, 12)
    greedy = _port_pipelined("gpt_bigcode", params, batches)
    top1 = _port_pipelined("gpt_bigcode", params, batches,
                           generator=torch.Generator().manual_seed(0),
                           gen=dict(do_sample=True, top_k=1))
    kw = dict(gen=dict(do_sample=True, temperature=1.5, top_p=0.95))
    a = _port_pipelined("gpt_bigcode", params, batches, generator=torch.Generator().manual_seed(5),
                        **kw)
    b = _port_pipelined("gpt_bigcode", params, batches, generator=torch.Generator().manual_seed(5),
                        **kw)
    for (gt, gl), (tt, tl), (at, al), (bt, bl) in zip(greedy, top1, a, b):
        np.testing.assert_array_equal(tt, gt)
        np.testing.assert_array_equal(tl, gl)
        np.testing.assert_array_equal(at, bt)
        np.testing.assert_array_equal(al, bl)
    assert any((at != gt).any() for (gt, _), (at, _) in zip(greedy, a))  # it sampled


def test_pipelined_edges(bigcode, monkeypatch):
    params = convert.from_jax_params(bigcode)
    gen = tengine.GenerationConfig(max_new_tokens=4, do_sample=False)
    assert tengine.generate_pipelined(params, tgbc.tiny_config(), [], gen) == []
    with pytest.raises(ValueError, match="num_return_sequences=1"):
        tengine.generate_pipelined(params, tgbc.tiny_config(), [], tengine.GenerationConfig(
            num_return_sequences=2))
    # a later prompt wider than batch 0's Pn (8 = 2 chunks of 4) raises before any forward,
    # where padding it would crop its first positions; a narrower one is left-padded
    short, wide = _batches(jgbc, bigcode, 8, n=1)[0], _batches(jgbc, bigcode, 9, n=1)[0]
    monkeypatch.setattr(tgbc, "forward", None)
    with pytest.raises(ValueError, match=r"\[8, 9\] exceed"):
        _port_pipelined("gpt_bigcode", params, [short, wide])
    with pytest.raises(ValueError, match="does not fit"):
        tengine.pad_time(torch.zeros((2, 9)), 8)
    monkeypatch.undo()
    narrow = _batches(jgbc, bigcode, 5, seed=1, n=1)[0]
    out = _port_pipelined("gpt_bigcode", params, [short, narrow])
    (gt, gl), = _port_pipelined("gpt_bigcode", params, [tuple(
        np.pad(x, ((0, 0), (3, 0)) + ((0, 0),) * (x.ndim - 2)) for x in narrow)])
    np.testing.assert_array_equal(out[1][0], gt)
    np.testing.assert_array_equal(out[1][1], gl)


def test_jax_pipelined_int8_kv_parts_from_its_own_generate(bigcode):
    """Per-batch generate is no exact reference for generate_pipelined over
    an int8 KV cache, in the JAX package itself: generate's one prefill
    attends over every prompt key quantized, a chunk step over its own
    chunk's keys unquantized. At P = 24 (6 chunks of 4) batch 2's ids part
    from JAX's generate on the same left-padded batch with an int8 cache,
    while with an fp32 cache every batch's equal it."""
    batches = _batches(jgbc, bigcode, 24)
    jgen = jengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    same = {}
    for kv in (None, jnp.int8):
        pipe = _jax_pipelined("gpt_bigcode", bigcode, batches, kv)
        same[kv] = [bool(np.array_equal(pt, np.asarray(jengine.generate(
            _jparams(bigcode), jgbc.tiny_config(), "gpt_bigcode", jnp.asarray(e),
            jnp.asarray(m), jgen, jax.random.PRNGKey(1), policy=JF32, kv_cache_dtype=kv)[0])))
            for (e, m, _), (pt, _) in zip(batches, pipe)]
    assert same == {None: [True, True, True], jnp.int8: [True, True, False]}


# ---------------------------------------------------------------------------
# forward_decode_with_chunk
# ---------------------------------------------------------------------------

def _caches(jcfg, tcfg, B, T, kv):
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    return jgbc.init_cache(jcfg, B, T, dtype=jdt), tgbc.init_cache(tcfg, B, T, dtype=tdt)


def _to_numpy(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def assert_caches_match(jc, tc):
    """k/v (and an int8 cache's scales) at the slots the key mask shows,
    at TOL; codes at most one apart and equal on >= 99%; masks and index
    exactly."""
    jc = _to_numpy(jc)
    mask = jc["kv_mask"]
    np.testing.assert_array_equal(tc["kv_mask"].numpy(), mask)
    assert tc["index"] == int(jc["index"])
    shown = mask.astype(bool)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in jc:
            continue
        j, t = jc[key][:, shown], tc[key].numpy()[:, shown]
        if t.dtype == np.int8:
            diff = np.abs(j.astype(np.int32) - t.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, key
        else:
            np.testing.assert_allclose(t, j, **TOL, err_msg=key)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_decode_with_chunk_matches_jax(bigcode, kv):
    """The current batch: 10 tokens (row 1 left-padded by 3) prefilled, then
    a decode step fused with the next batch's second chunk (its first, of
    4 positions with row 1 all pads, already written)."""
    jcfg, tcfg = jgbc.tiny_config(), tgbc.tiny_config()
    jp, tp = _jparams(bigcode), convert.from_jax_params(bigcode)
    rng = np.random.default_rng(3)
    B, S, C, E = 2, 10, 4, jcfg.hidden_size
    emb = rng.standard_normal((B, S + 1 + 2 * C, E)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0
    cmask = np.ones((B, 2 * C), np.int32)
    cmask[1, :5] = 0  # row 1's first chunk is all pads
    jcur, tcur = _caches(jcfg, tcfg, B, S + 4, kv)
    jnext, tnext = _caches(jcfg, tcfg, B, 2 * C + 4, kv)
    _, jcur = jgbc.forward(jp, jcfg, jnp.asarray(emb[:, :S]), attention_mask=jnp.asarray(mask),
                           cache=jcur, policy=JF32)
    _, jnext = jgbc.forward(jp, jcfg, jnp.asarray(emb[:, S + 1:S + 1 + C]),
                            attention_mask=jnp.asarray(cmask[:, :C]), cache=jnext, policy=JF32)
    tgbc.forward(tp, tcfg, torch.from_numpy(emb[:, :S]), attention_mask=torch.from_numpy(mask),
                 cache=tcur, policy=TF32)
    tgbc.forward(tp, tcfg, torch.from_numpy(emb[:, S + 1:S + 1 + C]),
                 attention_mask=torch.from_numpy(cmask[:, :C]), cache=tnext, policy=TF32)
    args = (emb[:, S:S + 1], emb[:, S + 1 + C:], cmask[:, C:])
    jd, jcur, jcl, jnext = jgbc.forward_decode_with_chunk(
        jp, jcfg, jnp.asarray(args[0]), jcur, jnp.asarray(args[1]), jnp.asarray(args[2]), jnext,
        policy=JF32)
    x_d, x_c, m_c = (torch.from_numpy(a) for a in args)
    td, tcur, tcl, tnext = tgbc.forward_decode_with_chunk(tp, tcfg, x_d, tcur, x_c, m_c, tnext,
                                                          policy=TF32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl)[:, -1], **TOL)
    assert td.dtype == tcl.dtype == torch.float32 and td.shape == (B, jcfg.vocab_size)
    assert_caches_match(jcur, tcur)
    assert_caches_match(jnext, tnext)
    # a step whose chunk is not the last projects no chunk logits
    _, _, none, _ = tgbc.forward_decode_with_chunk(tp, tcfg, x_d, tcur, x_c, m_c, tnext,
                                                   policy=TF32, chunk_logits=False)
    assert none is None and tcur["index"] == S + 2 and tnext["index"] == 3 * C


def test_decode_with_chunk_rejects_mismatched_caches(bigcode):
    tcfg = tgbc.tiny_config()
    tp = convert.from_jax_params(bigcode)
    x1, xc = torch.zeros(2, 1, 64), torch.zeros(2, 4, 64)
    cm = torch.ones(2, 4, dtype=torch.int32)
    for a, b in ((torch.int8, torch.float32), (torch.float32, torch.int8)):
        with pytest.raises(ValueError, match="cache dtypes must match"):
            tgbc.forward_decode_with_chunk(tp, tcfg, x1, tgbc.init_cache(tcfg, 2, 8, dtype=a),
                                           xc, cm, tgbc.init_cache(tcfg, 2, 8, dtype=b),
                                           policy=TF32)
