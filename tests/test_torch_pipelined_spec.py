"""Port parity for pipelined speculative generation (generation/speculative.py::
generate_pipelined_spec): batched prompt-lookup verify rounds over a
ragged cache with a chunk of the next batch's right-padded prompt fused
into each round (gpt_bigcode.forward_ragged_verify_with_chunk).

Against starvector_tpu on the same numpy weights and inputs, fp32 compute,
the tiny GPTBigCode with its projections scaled by 3 (greedy output
repeats itself in part, so drafts are partly accepted):
  * forward_ragged_verify_with_chunk on the same caches (a prefill adopted
    as a ragged cache, a linear next cache with one chunk written), an fp32
    and an int8 cache: the verify logits (B, W, V) and the chunk's hidden
    states (B, C, E) at rtol = atol = 1e-5, both caches at the slots their
    masks show plus the verify's written slots (lengths + [0, W)) at that
    tolerance (int8 codes at most one code apart, equal on >= 99%), masks,
    lengths and index exactly. Mismatched cache types raise ValueError.
  * generate_pipelined_spec on the batches of tests/test_spec_pipelined.py
    (3 batches of 3 right-padded rows, draft_len 5, chunk_positions 2, a
    stop id), fp32 and int8 caches: ids, lengths and `stats` (rounds a
    batch) equal JAX's; in fp32 each row equals the port's plain greedy
    generate on that row alone, and the default chunk too.
  * do_sample raises ValueError, as does a later batch wider than batch
    0's padded width; a stream of StarCoder2 batches raises the
    port's NotImplementedError (the JAX package has no fused verify for
    it), while one StarCoder2 batch runs its plain verify rounds.
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
from starvector_tpu_torch.generation import speculative as tspec
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS_BATCHES = [
    [[3, 1, 4], [9, 2, 6, 5, 3], [7, 8, 1, 2]],
    [[5, 5, 2], [1, 2, 3, 4], [8, 3]],
    [[2, 7], [6, 6, 6, 1, 2], [4, 4, 9]],
]
N, K = 14, 5
SCALE = 3.0


@pytest.fixture(scope="module")
def tree():
    cfg = jgbc.tiny_config()
    tree = jax.tree_util.tree_map(np.asarray, jgbc.init_params(cfg, jax.random.PRNGKey(0)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * SCALE
    return tree


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _make_batch(tree, rows):
    """(embeds, mask, prompt ids -1 at the holes) of right-padded rows."""
    P = max(len(r) for r in rows)
    ids = np.zeros((len(rows), P), np.int32)
    pid = np.full((len(rows), P), -1, np.int32)
    mask = np.zeros((len(rows), P), np.int32)
    for b, r in enumerate(rows):
        ids[b, :len(r)] = r
        pid[b, :len(r)] = r
        mask[b, :len(r)] = 1
    emb = np.array(jgbc.embed_tokens(_jparams(tree), jnp.asarray(ids)), np.float32)
    return emb * mask[:, :, None], mask, pid


def _spec(tree, params, batches, kv, stops, **kw):
    """(JAX's [(tokens, lengths)], stats; the port's, stats)."""
    jstats, tstats = [], []
    jgen = jengine.GenerationConfig(max_new_tokens=N, do_sample=False, eos_token_id=None,
                                    stop_sequences=stops)
    ref = jengine.generate_pipelined_spec(
        _jparams(tree), jgbc.tiny_config(), "gpt_bigcode",
        [tuple(map(jnp.asarray, b)) for b in batches], jgen, policy=JF32, draft_len=K,
        kv_cache_dtype=jnp.int8 if kv == "int8" else None, stats=jstats, **kw)
    tgen = tengine.GenerationConfig(max_new_tokens=N, do_sample=False, stop_sequences=stops)
    out = tspec.generate_pipelined_spec(
        params, tgbc.tiny_config(), [tuple(map(torch.from_numpy, b)) for b in batches], tgen,
        policy=TF32, draft_len=K, kv_cache_dtype=torch.int8 if kv == "int8" else None,
        stats=tstats, **kw)
    return ([(np.asarray(t), np.asarray(l)) for t, l in ref], [int(r) for r in jstats],
            [(t.numpy(), l.numpy()) for t, l in out], tstats)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("chunk", [2, None])
def test_pipelined_spec_matches_jax(tree, kv, chunk):
    params = convert.from_jax_params(tree)
    batches = [_make_batch(tree, rows) for rows in ROWS_BATCHES]
    stops = ((11,),)
    ref, jstats, out, tstats = _spec(tree, params, batches, kv, stops, chunk_positions=chunk)
    assert tstats == jstats and len(out) == 3
    for i, ((rt, rl), (pt, pl)) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(pt, rt, err_msg=f"batch {i}")
        np.testing.assert_array_equal(pl, rl, err_msg=f"batch {i}")
    if kv == "int8":
        return
    # every row is its own plain greedy decoding, and drafts were accepted
    for rows, (pt, pl) in zip(ROWS_BATCHES, out):
        for b, r in enumerate(rows):
            ids = torch.tensor([r])
            gt, gl = tengine.generate(params, tgbc.tiny_config(), tgbc.embed_tokens(params, ids),
                                      torch.ones(ids.shape, dtype=torch.int32),
                                      tengine.GenerationConfig(max_new_tokens=N, do_sample=False,
                                                               stop_sequences=stops),
                                      policy=TF32)
            assert int(pl[b]) == int(gl[0])
            np.testing.assert_array_equal(pt[b], gt[0].numpy())
    assert sum(tstats) < 3 * N


def test_pipelined_spec_rejects_sampling(tree):
    params = convert.from_jax_params(tree)
    batch = tuple(map(torch.from_numpy, _make_batch(tree, ROWS_BATCHES[0])))
    with pytest.raises(ValueError, match="greedy-only"):
        tspec.generate_pipelined_spec(params, tgbc.tiny_config(), [batch],
                                      tengine.GenerationConfig(max_new_tokens=4),
                                      policy=TF32)
    assert tspec.generate_pipelined_spec(params, tgbc.tiny_config(), [],
                                         tengine.GenerationConfig(do_sample=False)) == []
    # a later batch wider than batch 0's Pn (8: one chunk of C = 8) raises before any
    # forward, where padding it would crop it
    wide = tuple(map(torch.from_numpy, _make_batch(tree, [list(range(1, 10)), [2, 3]])))
    with pytest.raises(ValueError, match="does not fit"):
        tspec.generate_pipelined_spec(params, tgbc.tiny_config(), [batch, wide],
                                      tengine.GenerationConfig(max_new_tokens=4,
                                                               do_sample=False),
                                      policy=TF32)


def test_pipelined_spec_8b_raises_the_ports_error():
    """StarCoder2 has no forward_ragged_verify_with_chunk in either
    package: a stream of batches raises; one batch runs the plain verify
    rounds and equals generate_greedy_speculative_batched."""
    cfg = tsc.tiny_config(num_attention_heads=4, num_key_value_heads=2, sliding_window=16)
    params = tsc.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 0, 0]])
    mask = (torch.arange(5)[None, :] < torch.tensor([[5], [3]])).int()
    pid = torch.where(mask > 0, ids, -1)
    batch = (tsc.embed_tokens(params, ids) * mask[:, :, None], mask, pid)
    gen = tengine.GenerationConfig(max_new_tokens=6, do_sample=False)
    with pytest.raises(NotImplementedError, match="no fused verify"):
        tspec.generate_pipelined_spec(params, cfg, [batch, batch], gen, policy=TF32)
    assert not hasattr(tsc, "forward_ragged_verify_with_chunk")
    (tokens, lengths), = tspec.generate_pipelined_spec(params, cfg, [batch], gen, policy=TF32,
                                                       draft_len=3, chunk_positions=8)
    ref, ref_len, _ = tspec.generate_greedy_speculative_batched(
        params, cfg, *(t for t in batch[:2]), torch.cat(
            [pid, torch.full((2, 3), -1)], dim=1), max_new_tokens=6, draft_len=3, policy=TF32)
    assert torch.equal(tokens, ref) and torch.equal(lengths, ref_len)


# ---------------------------------------------------------------------------
# forward_ragged_verify_with_chunk
# ---------------------------------------------------------------------------

def assert_caches_match(jc, tc, extra=None):
    """k/v (and scales) at the slots the mask shows, plus `extra` (B, T)
    bool, at TOL; int8 codes at most one apart and equal on >= 99%; the
    mask, lengths and index exactly."""
    jc = {k: np.asarray(v) for k, v in jc.items()}
    np.testing.assert_array_equal(tc["kv_mask"].numpy(), jc["kv_mask"])
    for key in ("lengths", "index"):
        if key in jc:
            np.testing.assert_array_equal(np.asarray(tc[key]), jc[key])
    shown = jc["kv_mask"].astype(bool) | (False if extra is None else extra)
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
def test_verify_with_chunk_matches_jax(tree, kv):
    """Batch 0 of ROWS_BATCHES prefilled and adopted as a ragged cache (the
    shared adoption: JAX's _spec_prefill_adopt_jit, the port's
    _spec_prefill_adopt), a proposal of W = 5 a row, fused with the second
    chunk of batch 1's right-padded prompt (its first already written)."""
    jcfg, tcfg = jgbc.tiny_config(), tgbc.tiny_config()
    jp, tp = _jparams(tree), convert.from_jax_params(tree)
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    T, C, W = 24, 2, 5
    emb, mask, _ = _make_batch(tree, ROWS_BATCHES[0])
    jrag, jpend = jengine._spec_prefill_adopt_jit(
        jp, jnp.asarray(emb), jnp.asarray(mask), dec_name="gpt_bigcode", llm_cfg=jcfg,
        max_new_tokens=N, draft_len=K, policy=JF32, total_next=T, kv_dtype=jdt)
    trag, tpend = tspec._spec_prefill_adopt(tp, tcfg, torch.from_numpy(emb),
                                              torch.from_numpy(mask), T, TF32, True, tdt)
    np.testing.assert_array_equal(tpend.numpy(), np.asarray(jpend))
    assert_caches_match(jrag, trag)
    nemb, nmask, _ = _make_batch(tree, ROWS_BATCHES[1])
    assert nemb.shape[1] == 2 * C  # two chunks, row 2's second all pads
    jnext = jgbc.init_cache(jcfg, 3, T, dtype=jdt or jnp.float32)
    tnext = tgbc.init_cache(tcfg, 3, T, dtype=tdt or torch.float32)
    _, jnext = jgbc.forward(jp, jcfg, jnp.asarray(nemb[:, :C]), attention_mask=jnp.asarray(
        nmask[:, :C]), cache=jnext, policy=JF32, return_hidden=True)
    tgbc.forward(tp, tcfg, torch.from_numpy(nemb[:, :C]), attention_mask=torch.from_numpy(
        nmask[:, :C]), cache=tnext, policy=TF32, return_hidden=True)
    proposal = np.concatenate([np.asarray(jpend)[:, None], np.asarray(
        [[7, 9, 11, 13], [1, 2, 3, 4], [5, 5, 5, 5]])], 1).astype(np.int32)
    jl, jrag, jh, jnext = jgbc.forward_ragged_verify_with_chunk(
        jp, jcfg, jnp.asarray(proposal), jrag, jnp.asarray(nemb[:, C:]),
        jnp.asarray(nmask[:, C:]), jnext, policy=JF32)
    tl, trag, th, tnext = tgbc.forward_ragged_verify_with_chunk(
        tp, tcfg, torch.from_numpy(proposal).long(), trag, torch.from_numpy(nemb[:, C:]),
        torch.from_numpy(nmask[:, C:]), tnext, policy=TF32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert tl.shape == (3, W, jcfg.vocab_size) and th.shape == (3, C, jcfg.hidden_size)
    lengths = np.asarray(jrag["lengths"])
    slot = np.arange(T)[None, :]
    written = (slot >= lengths[:, None]) & (slot < lengths[:, None] + W)
    assert_caches_match(jrag, trag, written)
    assert_caches_match(jnext, tnext)
    with pytest.raises(ValueError, match="cache dtypes must match"):
        tgbc.forward_ragged_verify_with_chunk(
            tp, tcfg, torch.from_numpy(proposal).long(), trag, torch.from_numpy(nemb[:, C:]),
            torch.from_numpy(nmask[:, C:]),
            tgbc.init_cache(tcfg, 3, T, dtype=torch.float32 if tdt else torch.int8), policy=TF32)
