"""Port parity for the ragged cache's decode half, the serving engine's
device path (models/decode_common.py's ragged functions, each decoder's
forward_ragged_decode, ops/sampling.py's pruned chain), against
starvector_tpu on the same numpy weights and inputs, fp32.

- insert_prefill_rows: the port's own prefills of right-padded rows landed
  in rows of a ragged cache equal the JAX package's (k, v at 1e-5; kv_mask
  and lengths exactly), bf16-typed and int8 caches, and a prefill cache of
  another type is refused; ragged_step_masks' write slots, new mask and old
  mask (with and without a window) equal JAX's exactly;
- forward_ragged_decode over 4 steps with rows at lengths 12, 5 and 9 (one
  row inactive on one step, one row never): logits at 1e-4 and the cache
  (k, v at 1e-5, kv_mask and lengths exactly) for GPTBigCode and for an
  8B-shaped StarCoder2 (G = 9) whose window of 8 the 12-token row is past
  and the 5-token row is not; the same over an int8 ragged cache (logits
  at 1e-4: both start from JAX's codes; the codes written are never more
  than one code apart, scales within 1e-5);
- the key bounds from the caller (the engine's host bookkeeping) give what
  the bounds read from `lengths` give;
- a step and a verify's commit_verify write the key mask and lengths into
  the cache's own tensors (the serving engine's CUDA graphs hold them),
  with JAX's values;
- sample_token(pruned=True): the filtered top-64 slab equals JAX's chain
  on the same logits (1e-6), temperature 0 and top_k=1 are the argmax,
  and one seed draws the same tokens twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import decode_common as jdc
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops import sampling as jsampling
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops import sampling as tsampling
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
G9 = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288, sliding_window=8)
DECODERS = {
    "gpt_bigcode": (jgbc, jgbc.tiny_config(), tgbc, tgbc.tiny_config()),
    "starcoder2": (jsc, jsc.tiny_config(**G9), tsc, tsc.tiny_config(**G9)),
}
LENS = (12, 5, 9)   # rows 0, 1, 3 of a 4-row cache; row 2 stays empty
SLOTS = (0, 1, 3)
T = 32
ACTIVE = ([1, 1, 0, 1], [1, 1, 0, 1], [1, 0, 0, 1], [1, 1, 0, 1])


@pytest.fixture(scope="module", params=list(DECODERS))
def decoder(request):
    jmod, jcfg, tmod, tcfg = DECODERS[request.param]
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    return request.param, jmod, jcfg, tmod, tcfg, tree


def _rows(jmod, tree, lens=LENS, seed=1):
    """Right-padded prompt embeddings (k, max(lens), E) and their mask."""
    rng = np.random.default_rng(seed)
    P = max(lens)
    ids = rng.integers(0, 512, (len(lens), P))
    emb = np.array(jmod.embed_tokens(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids)),
                   np.float32)
    mask = (np.arange(P)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return emb, mask


def _jax_ragged(jmod, jcfg, tree, emb, mask, dtype=jnp.float32):
    """JAX: one right-padded prefill of the rows, landed in SLOTS."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    small = jmod.init_cache(jcfg, emb.shape[0], emb.shape[1], dtype=dtype)
    _, small = jmod.forward(params, jcfg, jnp.asarray(emb), attention_mask=jnp.asarray(mask),
                            cache=small, policy=JF32)
    rag = jmod.init_ragged_cache(jcfg, 4, T, dtype=dtype)
    return jdc.insert_prefill_rows(rag, small, jnp.asarray(SLOTS),
                                   jnp.asarray(mask.sum(1), jnp.int32))


def _torch_ragged(tmod, tcfg, params, emb, mask, dtype=torch.float32):
    small = tmod.init_cache(tcfg, emb.shape[0], emb.shape[1], dtype=dtype)
    _, small = tmod.forward(params, tcfg, torch.from_numpy(emb),
                            attention_mask=torch.from_numpy(mask), cache=small, policy=TF32)
    rag = tmod.init_ragged_cache(tcfg, 4, T, dtype=dtype)
    tdc.insert_prefill_rows(rag, small, torch.tensor(SLOTS), torch.from_numpy(mask.sum(1)))
    return rag


def _to_torch(cache) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}


def _assert_cache(tc, jc, codes: bool = False):
    for key in ("kv_mask", "lengths"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), err_msg=key)
    for key in tdc._payload_keys(tc):
        if codes and key in ("k", "v"):
            diff = np.abs(tc[key].numpy().astype(np.int32) - np.asarray(jc[key]).astype(np.int32))
            assert diff.max() <= 1, key
        else:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_insert_prefill_rows_matches_jax(decoder, int8):
    _, jmod, jcfg, tmod, tcfg, tree = decoder
    emb, mask = _rows(jmod, tree)
    jc = _jax_ragged(jmod, jcfg, tree, emb, mask, jnp.int8 if int8 else jnp.float32)
    tc = _torch_ragged(tmod, tcfg, convert.from_jax_params(tree), emb, mask,
                       torch.int8 if int8 else torch.float32)
    _assert_cache(tc, jc, codes=int8)
    assert set(tc) == set(jc)


def test_insert_refuses_a_cache_of_another_type():
    cfg = tgbc.tiny_config()
    rag = tgbc.init_ragged_cache(cfg, 2, 16, dtype=torch.int8)
    small = tgbc.init_cache(cfg, 1, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="silently corrupt"):
        tdc.insert_prefill_rows(rag, small, torch.tensor([0]), torch.tensor([3]))
    # a prefill longer than the ragged cache is cropped, one shorter padded
    small = tgbc.init_cache(cfg, 1, 24, dtype=torch.int8)
    small["kv_mask"][:] = 1
    tdc.insert_prefill(rag, small, 1, 16)
    assert int(rag["kv_mask"][1].sum()) == 16 and int(rag["lengths"][1]) == 16


@pytest.mark.parametrize("window", [None, 8])
def test_ragged_step_masks_match_jax(window):
    rng = np.random.default_rng(5)
    mask = (rng.random((4, T)) < 0.7).astype(np.int32)
    lengths = np.asarray([12, 5, 0, T], np.int32)  # the last row is full: it writes at T - 1
    active = np.asarray([1, 0, 1, 1], np.int32)
    jc = {"kv_mask": jnp.asarray(mask), "lengths": jnp.asarray(lengths)}
    tc = {"kv_mask": torch.from_numpy(mask.copy()), "lengths": torch.from_numpy(lengths)}
    ref = jdc.ragged_step_masks(jc, jnp.asarray(active), window)
    out = tdc.ragged_step_masks(tc, torch.from_numpy(active), window)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tc["kv_mask"].numpy(), mask)  # the cache is not changed


def _decode_both(decoder, int8: bool, key_bounds: bool = True):
    name, jmod, jcfg, tmod, tcfg, tree = decoder
    emb, mask = _rows(jmod, tree)
    jc = _jax_ragged(jmod, jcfg, tree, emb, mask, jnp.int8 if int8 else jnp.float32)
    tc = _to_torch(jc)  # both start from JAX's cache: the steps alone are compared
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree)
    rng = np.random.default_rng(9)
    lens = np.asarray([12, 5, 0, 9])
    window = getattr(tcfg, "sliding_window", None)
    for step, act in enumerate(ACTIVE):
        toks = rng.integers(0, 512, (4,))
        active = np.asarray(act, np.int32)
        jl, jc = jmod.forward_ragged_decode(jparams, jcfg, jnp.asarray(toks, jnp.int32), jc,
                                            jnp.asarray(active), policy=JF32)
        live = lens[active > 0]
        bounds = None
        if key_bounds:  # the engine's: the longest live row, the shortest's window start
            t_lo = 0 if window is None else max(int(live.min()) - window + 1, 0)
            bounds = (t_lo, int(live.max()))
        tl, tc = tmod.forward_ragged_decode(tparams, tcfg, torch.from_numpy(toks), tc,
                                            torch.from_numpy(active), policy=TF32,
                                            key_bounds=bounds)
        rows = active > 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], **LOGIT_TOL,
                                   err_msg=f"{name} step {step}")
        lens = lens + active
    return tc, jc


def test_forward_ragged_decode_matches_jax(decoder):
    """Several steps at ragged lengths; StarCoder2's rows on both sides of
    its window of 8 (12 + 4 and 5 + 3 tokens)."""
    tc, jc = _decode_both(decoder, int8=False)
    _assert_cache(tc, jc)
    assert tc["lengths"].tolist() == [16, 8, 0, 13]


def test_ragged_step_and_commit_keep_the_cache_tensors(decoder):
    """forward_ragged_decode (a beam round's step) and commit_verify (a
    verify round's) advance the key mask and lengths in place, to JAX's
    values: the serving engine's CUDA graphs hold those tensors, so an
    eager round between two replays must leave its result there."""
    _, jmod, jcfg, tmod, tcfg, tree = decoder
    emb, mask = _rows(jmod, tree)
    jc = _jax_ragged(jmod, jcfg, tree, emb, mask)
    tc = _to_torch(jc)
    held = {key: tc[key] for key in ("kv_mask", "lengths")}
    toks, active = np.asarray([3, 5, 7, 11]), np.asarray([1, 0, 1, 1], np.int32)
    _, jc = jmod.forward_ragged_decode(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                       jnp.asarray(toks, jnp.int32), jc, jnp.asarray(active),
                                       policy=JF32)
    tmod.forward_ragged_decode(convert.from_jax_params(tree), tcfg, torch.from_numpy(toks), tc,
                               torch.from_numpy(active), policy=TF32)
    n_commit = np.asarray([2, 0, 1, 30])  # the last row's clamped at T
    jc = jdc.commit_verify(jc, jnp.asarray(n_commit))
    tdc.commit_verify(tc, torch.from_numpy(n_commit))
    assert all(tc[key] is t for key, t in held.items())
    _assert_cache(tc, jc)


def test_forward_ragged_decode_int8_cache_matches_jax(decoder):
    tc, jc = _decode_both(decoder, int8=True)
    _assert_cache(tc, jc, codes=True)


def test_key_bounds_from_lengths_equal_the_callers(decoder):
    """Without key_bounds the decoders read them from `lengths` (a host
    transfer); with the engine's they give the same logits and cache."""
    a, _ = _decode_both(decoder, int8=False, key_bounds=True)
    b, _ = _decode_both(decoder, int8=False, key_bounds=False)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_pruned_slab_matches_jax():
    rng = np.random.default_rng(3)
    B, V, K = 5, 512, 64
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    knobs = dict(temperature=np.asarray([0.7, 1.0, 1.3, 0.5, 2.0], np.float32),
                 top_p=np.asarray([0.9, 1.0, 0.5, 0.95, 0.8], np.float32),
                 top_k=np.asarray([0, 5, 40, 0, 1], np.int32),
                 min_p=np.asarray([0.0, 0.05, 0.0, 0.1, 0.0], np.float32))
    slab, slab_ids = jax.lax.top_k(jnp.asarray(logits), K)  # the JAX pruned branch's chain
    ref = jsampling.apply_temperature(slab, jnp.asarray(knobs["temperature"]))
    ref = jsampling.apply_top_k(ref, jnp.asarray(knobs["top_k"]), K)
    ref = jsampling.apply_top_p(ref, jnp.asarray(knobs["top_p"]))
    ref = jsampling.apply_min_p(ref, jnp.asarray(knobs["min_p"]))
    out, ids = tsampling.pruned_slab(torch.from_numpy(logits), max_top_k=K,
                                     **{k: torch.from_numpy(v) for k, v in knobs.items()})
    np.testing.assert_array_equal(ids.numpy(), np.asarray(slab_ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

    t = {k: torch.from_numpy(v) for k, v in knobs.items()}
    greedy = torch.from_numpy(logits).argmax(-1)
    zero = tsampling.sample_token(torch.from_numpy(logits), do_sample=True, pruned=True,
                                  **{**t, "temperature": torch.zeros(B)})
    top1 = tsampling.sample_token(torch.from_numpy(logits), do_sample=True, pruned=True,
                                  **{**t, "top_k": torch.ones(B, dtype=torch.int32)},
                                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(zero, greedy) and torch.equal(top1, greedy)
    draws = [tsampling.sample_token(torch.from_numpy(logits), do_sample=True, pruned=True, **t,
                                    generator=torch.Generator().manual_seed(11))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert bool((ids == draws[0][:, None]).any(dim=1).all())  # each row's draw is in its slab
