"""Port parity for the static decode loops that the card replays as CUDA
graphs (generation/graphs.py): generate's loop (generation/engine.py::
decode_static over the decoders' forward_decode_static) and the serving
engine's static tick (serve/engine.py::_static_ragged_step over
forward_ragged_decode_static), with every loop-varying scalar on the
device and kernel 2 taking its key bounds from there.

On the CPU the static steps run uncaptured (no graph exists there), through
the kernels' plain versions; each is held to the JAX package on the same
numpy weights and inputs:
  * kernel 2's plain version with device `bounds` equals the host-int
    version bit for bit and the JAX merged_decode_attention over the same
    visible slots (2e-6), over a hypothesis sweep of (t_begin, t_end, t_cap),
    int8 cache included; graphs.kernel_scratch names every cached kernel
    scratch buffer (what a graph holds from its capture);
  * the static decode step equals the JAX decoder's cached decode step, the
    logits and the cache slot it writes, for a tiny 1B and a tiny 8B-shaped
    StarCoder2 past its window: fp32 at 1e-5, bf16 at the chunk step's
    tolerances (atol 2e-3, rtol 2^-7: the two sides round bf16 activations
    in different orders), atol 2^-8 for the 8B shape's 18 heads and hidden
    288, where the port's eager step (forward at S = 1, the host index,
    held to the same tolerance here) is itself up to 2.9e-3 from JAX: half
    a bf16 step at the logits' size (about 1);
  * the static generate gives the JAX generate's ids and lengths, greedy,
    fp32, at DECODE_GRAPH_STEPS = 4 so that the plan has a first step, whole blocks
    and a short last one (n - 1 = 10 steps: 1 + 4 + 4 + 1): im2svg, a left-padded
    text2svg, the 8B-shaped decoder past its window, int8 weights with an
    int8 cache, num_return_sequences = 2, stop sequences with eos and
    min_new_tokens, repetition and frequency penalties with a logit bias,
    one row stopping early, and every row stopping before n (the loop then
    runs to the end of the block in which the last row stopped, and no
    further);
  * the serving engine's static tick gives the tokens of the same tick with
    each step the decoder's eager forward_ragged_decode (host key bounds),
    greedy and sampled under one seed (the two share every sampling op and
    the generator's draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import decode_common as jdc
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu.ops.quantization import quantize_tree as jquantize_tree
from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops import quantization as tq
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from starvector_tpu_torch.ops.quantization import quantize_tree
from starvector_tpu_torch.serve.engine import Request, ServeEngine

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOLS = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2**-7, atol=2e-3),
        "bf16 8B shape": dict(rtol=2**-7, atol=2**-8)}
POLICIES = {"fp32": (JF32, TF32), "bf16": (JPolicy(), TPolicy())}
WINDOW = 16
G9 = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288, sliding_window=WINDOW)
NEW, K = 11, 4  # n - 1 = 10 decode steps: 1 + 4 + 4 + 1
PROMPTS = [[5, 9, 2, 7, 7, 1, 3, 8], [3, 1, 4, 1, 5, 9, 2, 6]]


def _decoders(name):
    if name == "gpt_bigcode":
        return (jgbc, jgbc.tiny_config(attn_impl="mixed", n_positions=256), tgbc,
                tgbc.tiny_config(n_positions=256))
    return jsc, jsc.tiny_config(**G9), tsc, tsc.tiny_config(**G9)


@pytest.fixture(scope="module", params=["gpt_bigcode", "starcoder2"])
def decoder(request):
    """(name, jax module, jax config, port module, port config, numpy tree,
    the tree with its projections x 10: greedy decoding then neither echoes
    one token nor ties)."""
    jmod, jcfg, tmod, tcfg = _decoders(request.param)
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    scaled = jax.tree_util.tree_map(lambda a: a, tree)
    for grp in scaled["layers"]["attn"], scaled["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    return request.param, jmod, jcfg, tmod, tcfg, tree, scaled


# ---------------------------------------------------------------------------
# kernel 2's plain version with device bounds
# ---------------------------------------------------------------------------

def _decode_operands(seed: int, int8: bool, B=2, Hkv=2, G=4, T=40, D=16):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    qg, kn, vn, k, v = f(B, Hkv, G, D), f(B, Hkv, D), f(B, Hkv, D), f(B, T, Hkv, D), f(B, T, Hkv, D)
    mask = np.ones((B, T), np.int32)
    mask[0, :5] = 0
    mask[1, T // 2] = 0
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = (tuple(t.numpy() for t in tdc.quantize_kv(torch.from_numpy(x)))
                            for x in (k, v))
    return qg, kn, vn, k, v, ks, vs, mask


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(t_begin=st.integers(0, 40), t_len=st.integers(0, 40), slack=st.integers(0, 40),
       int8=st.booleans())
def test_decode_plain_device_bounds_match_host_bounds(t_begin, t_len, slack, int8):
    """bounds [t_begin, t_end] as an int32 tensor (t_end the host's cap,
    t_cap >= t_end) gives the host-int version's bits; both equal the JAX
    merged_decode_attention over the same visible slots."""
    T = 40
    t_begin = min(t_begin, T)
    t_end = min(t_begin + t_len, T)
    t_cap = min(t_end + slack, T)
    qg, kn, vn, k, v, ks, vs, mask = _decode_operands(t_begin * 41 + t_len, int8)
    tq = [None if a is None else torch.from_numpy(a) for a in (qg, kn, vn, k, v, ks, vs, mask)]
    kw = dict(k_new=tq[1], v_new=tq[2], k_scale=tq[5], v_scale=tq[6])
    host = tfa.decode_attention_plain(tq[0], tq[3], tq[4], tq[7], t_begin=t_begin, t_end=t_end,
                                      **kw)
    dev = tfa.decode_attention(tq[0], tq[3], tq[4], tq[7], t_end=t_cap,
                               bounds=torch.tensor([t_begin, t_end], dtype=torch.int32), **kw)
    assert torch.equal(dev, host)
    pos = np.arange(T)[None, :]
    visible = (mask > 0) & (pos >= t_begin) & (pos < t_end)
    ref = jdc.merged_decode_attention(
        *(jnp.asarray(a) for a in (qg, kn, vn, k, v)), jnp.asarray(visible.astype(np.int32)),
        qg.shape[-1] ** -0.5, *(None if a is None else jnp.asarray(a) for a in (ks, vs)))
    np.testing.assert_allclose(dev.reshape(2, 1, -1).numpy(), np.asarray(ref), rtol=0, atol=2e-6)


def test_kernel_scratch_lists_the_cached_buffers():
    """graphs.kernel_scratch, which a StepGraph holds from its capture, is
    every cached kernel-2 and GEMV buffer; a larger launch's growth
    replaces the workspace it names."""
    dev = torch.device("cpu")
    saved = tfa._DECODE_SCRATCH.pop(dev, None), tq._GEMV_SCRATCH.pop(dev, None)
    try:
        cached = (*tfa._decode_scratch(dev, 4, 100), *tq._gemv_scratch(dev, 4, 100))
        assert all(any(t is h for h in graphs.kernel_scratch()) for t in cached)
        tfa._decode_scratch(dev, 4, 10**5)
        assert not any(cached[1] is h for h in graphs.kernel_scratch())
    finally:
        for cache, pair in zip((tfa._DECODE_SCRATCH, tq._GEMV_SCRATCH), saved):
            cache.pop(dev, None)
            if pair is not None:
                cache[dev] = pair


def test_decode_bounds_are_checked():
    qg, kn, vn, k, v, _, _, mask = (torch.from_numpy(a) if a is not None else None
                                    for a in _decode_operands(0, False))
    with pytest.raises(ValueError, match="bounds"):
        tfa.decode_attention(qg, k, v, mask, bounds=torch.tensor([0, 5]))  # int64
    with pytest.raises(ValueError, match="t_begin"):
        tfa.decode_attention(qg, k, v, mask, t_begin=3,
                             bounds=torch.tensor([0, 5], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the static decode step against the JAX decoder's decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["compute", "int8"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_static_step_matches_jax_decode_step(decoder, policy, cache):
    """A 20-token prefix (row 1 left-padded by 3; past StarCoder2's window
    of 16), then 6 decode steps: the JAX forward at S = 1 against
    forward_decode_static at the device slot pos, each step's logits and
    the k/v it writes at its slot; the port's eager step (its own cache)
    alike."""
    name, jmod, jcfg, tmod, tcfg, tree, _ = decoder
    jpol, tpol = POLICIES[policy]
    tol = TOLS["bf16 8B shape" if policy == "bf16" and name == "starcoder2" else policy]
    P, steps = 20, 6
    T = P + steps
    jdt = jnp.int8 if cache == "int8" else jpol.compute_dtype
    tdt = torch.int8 if cache == "int8" else tpol.compute_dtype
    rng = np.random.default_rng(7)
    E = jcfg.hidden_size
    embeds = (rng.standard_normal((2, T, E)) * 0.5).astype(np.float32)
    mask = np.ones((2, P), np.int32)
    mask[1, :3] = 0
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree)
    jcache = jmod.init_cache(jcfg, 2, T, dtype=jdt)
    tcache, ecache = (tmod.init_cache(tcfg, 2, T, dtype=tdt) for _ in range(2))
    _, jcache = jmod.forward(jparams, jcfg, jnp.asarray(embeds[:, :P]),
                             attention_mask=jnp.asarray(mask), cache=jcache, policy=jpol)
    for c in (tcache, ecache):
        tmod.forward(tparams, tcfg, torch.from_numpy(embeds[:, :P]),
                     attention_mask=torch.from_numpy(mask), cache=c, policy=tpol)
    pos = torch.tensor([P], dtype=torch.int32)
    for s in range(steps):
        x = embeds[:, P + s:P + s + 1]
        jl, jcache = jmod.forward(jparams, jcfg, jnp.asarray(x), cache=jcache, policy=jpol)
        tl = tmod.forward_decode_static(tparams, tcfg, torch.from_numpy(x), tcache, pos,
                                        t_cap=min(graphs.bucket_len(P + s + 1), T), policy=tpol)
        el, ecache = tmod.forward(tparams, tcfg, torch.from_numpy(x), cache=ecache, policy=tpol)
        for out in (tl, el[:, 0]):
            np.testing.assert_allclose(out.numpy(), np.asarray(jl, np.float32)[:, 0], **tol)
        slot = P + s
        for key in ("k", "v", "k_scale", "v_scale"):
            if key not in tcache:
                continue
            ours = tcache[key][:, :, slot].float().numpy()
            ref = np.asarray(jcache[key][:, :, slot], np.float32)
            if key in ("k", "v") and cache == "int8":
                assert np.abs(ours - ref).max() <= 1, (key, s)  # codes: an fp32 sum-order flip
            else:
                np.testing.assert_allclose(ours, ref, **tol)
        pos += 1
    assert int(pos) == T
    np.testing.assert_array_equal(tcache["kv_mask"].numpy(), np.asarray(jcache["kv_mask"]))


# ---------------------------------------------------------------------------
# the static generate against the JAX generate
# ---------------------------------------------------------------------------

def _greedy_rows(name, jmod, jcfg, tree, ids):
    """The JAX greedy rows of ids, NEW tokens, no stop: where the cases take
    their stop sequences and eos from."""
    return _jax_generate(name, jmod, jcfg, tree, ids)[0]


def _jax_generate(name, jmod, jcfg, tree, ids, kv=None, **kw):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ids = jnp.asarray(ids, jnp.int32)
    gen = jengine.GenerationConfig(**{"max_new_tokens": NEW, "do_sample": False, **kw})
    tokens, lengths = jengine.generate(params, jcfg, name, jmod.embed_tokens(params, ids),
                                       jnp.ones(ids.shape, jnp.int32), gen,
                                       jax.random.PRNGKey(1), prompt_ids=ids, policy=JF32,
                                       kv_cache_dtype=kv)
    return np.asarray(tokens), np.asarray(lengths)


def _port_generate(tmod, tcfg, params, ids, kv=None, **kw):
    assert tengine.DECODE_GRAPH_STEPS == K  # set by the test (monkeypatch)
    ids = torch.tensor(ids)
    gen = tengine.GenerationConfig(**{"max_new_tokens": NEW, "do_sample": False, **kw})
    tokens, lengths = tengine.generate(params, tcfg, tmod.embed_tokens(params, ids),
                                       torch.ones(ids.shape, dtype=torch.int32), gen,
                                       prompt_ids=ids, policy=TF32, kv_cache_dtype=kv)
    return tokens.numpy(), lengths.numpy()


def _case_kwargs(case, rows):
    """GenerationConfig fields of a case, from the unconstrained greedy rows
    (so that a stop is one the rows really emit)."""
    if case == "stops_min_new":
        # eos is row 0's first token, masked at tokens 0 and 1; row 1 stops
        # on its tokens 4-5
        return dict(stop_sequences=((int(rows[1, 4]), int(rows[1, 5])),),
                    eos_token_id=int(rows[0, 0]), min_new_tokens=2)
    if case == "penalties_bias":
        return dict(repetition_penalty=1.3, frequency_penalty=0.4, presence_penalty=0.2,
                    logit_bias=((int(rows[0, 2]), -5.0), (7, 2.0)))
    if case == "one_row_early":
        # the first of row 1's tokens that row 0 never emits
        tok = next(int(t) for t in rows[1, 1:] if t not in rows[0])
        return dict(stop_sequences=((tok,),))
    if case == "all_rows_early":
        # both rows stop by token 5, inside the second block (steps 1-4)
        return dict(stop_sequences=((int(rows[0, 3]),), (int(rows[1, 4]),)))
    if case == "num_return_sequences":
        return dict(num_return_sequences=2)
    return {}


GENERATE_CASES = ["greedy", "int8", "num_return_sequences", "stops_min_new", "penalties_bias",
                  "one_row_early", "all_rows_early"]


@pytest.mark.parametrize("case", GENERATE_CASES)
def test_static_generate_matches_jax(decoder, monkeypatch, case):
    """The static generate's ids and lengths are the JAX generate's; the
    decode steps run are the plan's: every one of decode_blocks' n - 1
    while a row is live, else up to the end of the block in which the last
    row stopped, each at its step_cap. The StarCoder2 prompt is 40 ids,
    past its window."""
    name, jmod, jcfg, tmod, tcfg, _, tree = decoder
    monkeypatch.setattr(tengine, "DECODE_GRAPH_STEPS", K)
    ids = PROMPTS if name == "gpt_bigcode" else [p * 5 for p in PROMPTS]
    rows = _greedy_rows(name, jmod, jcfg, tree, ids)
    assert all(len(set(r.tolist())) >= 4 for r in rows)
    kw = _case_kwargs(case, rows)
    jtree, params, jkv, tkv = tree, convert.from_jax_params(tree), None, None
    if case == "int8":
        jtree = jax.tree_util.tree_map(np.asarray, jquantize_tree(tree, min_elems=1 << 12,
                                                                  consume=False))
        params = quantize_tree(convert.from_jax_params(tree), min_elems=1 << 12)
        jkv, tkv = jnp.int8, torch.int8
    ref, ref_len = _jax_generate(name, jmod, jcfg, jtree, ids, jkv, **kw)
    steps = []
    static = tmod.forward_decode_static
    monkeypatch.setattr(tmod, "forward_decode_static",
                        lambda *a, **k: steps.append(k["t_cap"]) or static(*a, **k))
    tokens, lengths = _port_generate(tmod, tcfg, params, ids, tkv, **kw)
    np.testing.assert_array_equal(tokens, ref)
    np.testing.assert_array_equal(lengths, ref_len)
    P = len(ids[0])
    blocks = tengine.decode_blocks(NEW, K)
    assert blocks == [1, 4, 4, 1]
    last = int(lengths.max())
    if last < NEW:  # every row done after token last - 1, in step last - 1's block
        ends = np.cumsum(blocks)
        want = int(ends[np.searchsorted(ends, last)])
    else:
        want = NEW - 1
    assert len(steps) == want, (case, lengths)
    assert steps == [tengine.step_cap(P + i, P + NEW) for i in range(want)]
    if case == "one_row_early":
        assert lengths[1] < NEW and lengths[0] == NEW
    if case == "stops_min_new":
        assert tokens[0, 0] != rows[0, 0] and lengths[1] <= 6  # eos masked; row 1's stop
    if case == "all_rows_early":
        assert (lengths < NEW).all() and want < NEW - 1


def test_static_im2svg_and_left_padded_text2svg_match_jax():
    """The tiny StarVector-1B (CLIP tower at 56 px: 65 visual tokens + 3
    prompt ids, a kernel-1 prefill) through generate_im2svg, and a
    left-padded text2svg (the chunk step's prefill) through
    generate_text2svg: the JAX package's ids and lengths."""
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu_torch.models import starvector as tsv

    jcfg = jsv.tiny_config(image_size=56, llm=jgbc.tiny_config(attn_impl="mixed"))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    tcfg = tsv.tiny_config(image_size=56)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.from_jax_params(tree)
    images = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)
    prompt = [[60, 116, 119]] * 2
    jgen = jengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    tgen = tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    ref = jengine.generate_im2svg(jparams, jcfg, jnp.asarray(images), jnp.asarray(prompt),
                                  jgen, jax.random.PRNGKey(1), policy=JF32)
    out = tengine.generate_im2svg(tparams, tcfg, torch.from_numpy(images), torch.tensor(prompt),
                                  tgen, policy=TF32)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = np.array([[0, 0, 0, 5, 9, 2, 7, 7], [3, 1, 4, 1, 5, 9, 2, 6]])
    mask = (np.arange(8)[None, :] >= np.array([[3], [0]])).astype(np.int32)
    ref = jengine.generate_text2svg(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), jgen,
                                    jax.random.PRNGKey(1), policy=JF32)
    out = tengine.generate_text2svg(tparams, tcfg, torch.from_numpy(ids),
                                    torch.from_numpy(mask), tgen, policy=TF32)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_static_generate_without_new_tokens_steps():
    """max_new_tokens 1 samples from the prefill alone, 0 samples nothing."""
    tcfg = tgbc.tiny_config()
    params = tgbc.init_params(tcfg, torch.Generator().manual_seed(0))
    ids = torch.tensor(PROMPTS)
    emb, ones = tgbc.embed_tokens(params, ids), torch.ones(ids.shape, dtype=torch.int32)
    for n in (0, 1):
        gen = tengine.GenerationConfig(max_new_tokens=n, do_sample=False)
        tokens, lengths = tengine.generate(params, tcfg, emb, ones, gen, policy=TF32)
        assert tokens.shape == (2, n) and lengths.tolist() == [n, n]
    assert tengine.decode_blocks(1, K) == tengine.decode_blocks(0, K) == []
    assert tengine.decode_blocks(2, K) == [1] and tengine.decode_blocks(6, K) == [1, 4]
    assert [tengine.step_cap(p, 100) for p in (8, 63, 64, 70, 99)] == [64, 64, 100, 100, 100]


# ---------------------------------------------------------------------------
# the serving engine's static tick against eager steps
# ---------------------------------------------------------------------------

def _serve(name, tmod, tcfg, params, prefixes, eager, **req):
    """Each prefix's tokens from a CPU engine, and the key caps its static
    steps took. `eager`: every step of the tick runs the decoder's eager
    forward_ragged_decode (host key bounds over the sliced key mask) in
    place of the static step."""
    engine = ServeEngine(params, tcfg, name, max_batch=4, max_len=96, policy=TF32,
                         device="cpu", seed=5)
    static = []
    fn = tmod.forward_ragged_decode_static

    def tmod_calls(params, cfg, tokens, cache, active, *, t_cap, policy, kernels):
        if eager:
            return tmod.forward_ragged_decode(params, cfg, tokens, cache, active, policy=policy,
                                              kernels=kernels)[0]
        static.append(t_cap)
        return fn(params, cfg, tokens, cache, active, t_cap=t_cap, policy=policy,
                  kernels=kernels)

    try:
        tmod.forward_ragged_decode_static = tmod_calls
        reqs = [engine.submit(Request(prefix_embeds=p, max_new_tokens=9, **req))
                for p in prefixes]
        engine.start()
        outs = []
        for r in reqs:
            while True:
                kind, payload = r.out_queue.get(timeout=120)
                if kind != "token":
                    assert kind == "done", payload
                    outs.append(payload)
                    break
    finally:
        engine.stop()
        tmod.forward_ragged_decode_static = fn
    return outs, static


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_static_tick_matches_eager_tick(decoder, mode):
    """Four requests admitted as one group (prompts of 5, 20, 12 and 9
    tokens: StarCoder2's longer ones past its window; queued before the
    engine starts, so that every run admits them at the same tick), 9
    tokens each at 4 steps a tick: the static tick's tokens equal those of
    the tick with eager steps (_serve's `eager`), greedy (and then
    the JAX package's offline greedy ids) and sampled at temperature 0.8,
    top-p 0.9 under one engine seed. The static ticks' key buckets hold
    every row's length."""
    name, jmod, jcfg, tmod, tcfg, _, tree = decoder
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    prefixes = [np.asarray(jmod.embed_tokens(jparams, jnp.asarray([rng.integers(0, 512, n)])),
                           np.float32) for n in (5, 20, 12, 9)]
    req = (dict(do_sample=False) if mode == "greedy"
           else dict(do_sample=True, temperature=0.8, top_p=0.9))
    params = convert.from_jax_params(tree)
    static, caps = _serve(name, tmod, tcfg, params, prefixes, False, **req)
    eager, none = _serve(name, tmod, tcfg, params, prefixes, True, **req)
    assert static == eager and not none and caps
    assert all(len(o) == 9 for o in static)
    assert set(caps) <= {64, 96}  # the bucket above 20 + 9 tokens, at most max_len
    if mode == "greedy":
        for p, out in zip(prefixes, static):
            gen = jengine.GenerationConfig(max_new_tokens=9, do_sample=False, min_new_tokens=9)
            ref, _ = jengine.generate(jparams, jcfg, name, jnp.asarray(p),
                                      jnp.ones(p.shape[:2], jnp.int32), gen,
                                      jax.random.PRNGKey(0), policy=JF32)
            assert out == np.asarray(ref[0]).tolist()
