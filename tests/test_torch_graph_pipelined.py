"""Port parity for the static steps and loops that the card replays as CUDA
graphs beyond generate's: the pipelined streams (generation/engine.py::
generate_pipelined, generation/speculative.py::generate_pipelined_spec)
and speculative decoding (generate_greedy_speculative, B = 1, and
generate_greedy_speculative_batched), every loop-varying scalar on the
device.

On the CPU the static steps run uncaptured, through the kernels' plain
versions; each is held to the JAX package on the same numpy weights and
inputs (the JAX side as its own tests run it), at the tolerances of
tests/test_torch_chunk_step.py, test_torch_pipelined.py and
test_torch_speculative.py:
  * the static chunk step (forward_chunk_static: write index idx on the
    device, keys over the span chunk_cap(idx)) against the JAX cached
    forward's chunk step, six chunks of 4 from slot 0 (row 1's first three
    positions pads), a tiny 1B and a tiny StarCoder2 (4 heads over 2,
    window 16) that the chunks run past: logits at fp32 atol = rtol = 1e-5,
    bf16 atol 2e-3, rtol 2^-7; compute and int8 caches, the written slots'
    k/v at that tolerance (int8 codes in fp32 at most one code apart and
    equal on >= 99%, as test_torch_chunk_step.py), key masks exactly;
  * the 1B's fused static step (forward_decode_with_chunk_static) against
    JAX's forward_decode_with_chunk over three steps, the last chunk's
    logits on the last: logits and caches at 1e-5 (fp32, compute and int8
    caches);
  * the static ragged verify (forward_ragged_verify given key_bounds (0,
    t_cap): no host read) and the 1B's static verify with a chunk against
    JAX's forward_ragged_verify[_with_chunk] and commit_verify, two rounds
    past StarCoder2's window: logits, chunk hidden states and committed
    caches at 1e-5;
  * the four static loops against JAX's generate_pipelined,
    generate_pipelined_spec, generate_greedy_speculative and _batched, with
    DECODE_GRAPH_STEPS = 4 so that blocks end mid-run: ids, lengths,
    n_forwards and stats rounds equal, in streams of 3 batches and in a
    case where every row stops mid-block (the loop runs to the end of that
    block and no further: the decode forwards are counted); a stream of 3
    batches runs the steps of the same (kind, key) set as a stream of 2, so
    the card captures no more graphs for it.
"""

import functools

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
from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.generation import speculative as tspec
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
TOLS = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2**-7, atol=2e-3)}
TOL = TOLS["fp32"]
POLICIES = {"fp32": (JF32, TF32), "bf16": (JPolicy(), TPolicy())}
SC2 = dict(num_attention_heads=4, num_key_value_heads=2, sliding_window=16)
DECODERS = {
    "gpt_bigcode": (jgbc, jgbc.tiny_config(), tgbc, tgbc.tiny_config()),
    "starcoder2": (jsc, jsc.tiny_config(**SC2), tsc, tsc.tiny_config(**SC2)),
}
BLOCK = 4  # DECODE_GRAPH_STEPS in the loop tests


@functools.lru_cache(maxsize=None)
def _tree(name: str, scale: float = 1.0):
    """The decoder's numpy weights, projections times `scale` (x 10: tiny
    greedy decoding neither echoes one token nor ties; x 3: it repeats
    itself in part, so drafts are partly accepted)."""
    jmod, jcfg, _, _ = DECODERS[name]
    tree = jax.tree_util.tree_map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * scale
    return tree


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _shown_match(jc, tc, shown, tol, fp32_codes=True):
    """k/v (and scales) at the `shown` (B, T) slots at tol; int8 codes at
    most one apart and equal on >= 99% (fp32 only: in bf16 a k or v one
    step apart moves its row's scale)."""
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in tc:
            continue
        j, t = np.asarray(jc[key], np.float32)[:, shown], tc[key].float().numpy()[:, shown]
        if tc[key].dtype == torch.int8:
            if fp32_codes:
                diff = np.abs(j - t)
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, key
        elif tol is not None:
            np.testing.assert_allclose(t, j, **tol, err_msg=key)


# ---------------------------------------------------------------------------
# Part A: the static chunk step and the 1B's fused static step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["compute", "int8"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(DECODERS))
def test_static_chunk_step_matches_jax(name, policy, cache):
    """Six chunks of 4 from slot 0 of an 80-slot cache (row 1's first three
    positions pads): the JAX cached forward at S = 4 (its chunk step)
    against forward_chunk_static at the device index, key span chunk_cap
    (0, then 64 of the 80 slots); StarCoder2's 24 positions pass its window
    of 16."""
    jmod, jcfg, tmod, tcfg = DECODERS[name]
    tree = _tree(name)
    jpol, tpol = POLICIES[policy]
    tol = TOLS[policy]
    B, C, n, T = 2, 4, 6, 80
    jdt = jnp.int8 if cache == "int8" else jpol.compute_dtype
    tdt = torch.int8 if cache == "int8" else tpol.compute_dtype
    rng = np.random.default_rng(11)
    embeds = (rng.standard_normal((B, n * C, jcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((B, n * C), np.int32)
    mask[1, :3] = 0
    jp, tp = _jparams(tree), convert.from_jax_params(tree)
    jcache, tcache = jmod.init_cache(jcfg, B, T, dtype=jdt), tmod.init_cache(tcfg, B, T, dtype=tdt)
    idx = torch.zeros(1, dtype=torch.int32)
    for c in range(n):
        x, m = embeds[:, c * C:(c + 1) * C], mask[:, c * C:(c + 1) * C]
        jl, jcache = jmod.forward(jp, jcfg, jnp.asarray(x), attention_mask=jnp.asarray(m),
                                  cache=jcache, policy=jpol)
        tl = tmod.forward_chunk_static(tp, tcfg, torch.from_numpy(x), torch.from_numpy(m),
                                       tcache, idx, t_cap=tengine.chunk_cap(c * C, T),
                                       policy=tpol)
        live = m.astype(bool)  # a pad query of row 1's first chunk sees no real key
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl, np.float32)[live], **tol,
                                   err_msg=f"chunk {c}")
        idx += C
    assert tengine.chunk_cap(0, T) == 0 and tengine.chunk_cap(20, T) == 64
    assert n * C > SC2["sliding_window"]
    np.testing.assert_array_equal(tcache["kv_mask"].numpy(), np.asarray(jcache["kv_mask"]))
    _shown_match(jcache, tcache, np.asarray(jcache["kv_mask"]) > 0,
                 tol if cache == "compute" else None, fp32_codes=policy == "fp32")
    assert tcache["index"] == 0  # the static step moves no host index


def _prefilled(jcfg, tcfg, tree, emb, mask, T, kv):
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    jc, tc = jgbc.init_cache(jcfg, emb.shape[0], T, dtype=jdt), tgbc.init_cache(
        tcfg, emb.shape[0], T, dtype=tdt)
    if emb.shape[1]:
        _, jc = jgbc.forward(_jparams(tree), jcfg, jnp.asarray(emb), cache=jc, policy=JF32,
                             attention_mask=jnp.asarray(mask))
        tgbc.forward(convert.from_jax_params(tree), tcfg, torch.from_numpy(emb), cache=tc,
                     attention_mask=torch.from_numpy(mask), policy=TF32)
    return jc, tc


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_fused_static_step_matches_jax(kv):
    """The current batch: 10 tokens (row 1 left-padded by 3) prefilled; then
    three fused steps, each a decode step and a chunk of 4 of the next
    batch's prompt (row 1's first chunk all pads, the second one part), the
    last one with the chunk's last-position logits."""
    jcfg, tcfg = jgbc.tiny_config(), tgbc.tiny_config()
    tree = _tree("gpt_bigcode")
    jp, tp = _jparams(tree), convert.from_jax_params(tree)
    rng = np.random.default_rng(3)
    B, S, C, E, steps = 2, 10, 4, jcfg.hidden_size, 3
    emb = rng.standard_normal((B, S + steps * (1 + C), E)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0
    cmask = np.ones((B, steps * C), np.int32)
    cmask[1, :6] = 0
    T = S + steps + 2
    jcur, tcur = _prefilled(jcfg, tcfg, tree, emb[:, :S], mask, T, kv)
    jnext, tnext = _prefilled(jcfg, tcfg, tree, emb[:, :0], mask[:, :0], steps * C + 2, kv)
    pos, idx = torch.tensor([S], dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    dec = emb[:, S:S + steps]
    chunks = emb[:, S + steps:]
    for s in range(steps):
        x_d, x_c, m_c = dec[:, s:s + 1], chunks[:, s * C:(s + 1) * C], cmask[:, s * C:(s + 1) * C]
        jd, jcur, jcl, jnext = jgbc.forward_decode_with_chunk(
            jp, jcfg, jnp.asarray(x_d), jcur, jnp.asarray(x_c), jnp.asarray(m_c), jnext,
            policy=JF32)
        td, tcl = tgbc.forward_decode_with_chunk_static(
            tp, tcfg, torch.from_numpy(x_d), tcur, pos, torch.from_numpy(x_c),
            torch.from_numpy(m_c), tnext, idx, t_cap=tengine.step_cap(S + s, T),
            chunk_cap=tengine.chunk_cap(s * C, steps * C + 2), policy=TF32,
            chunk_logits=s == steps - 1)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL, err_msg=f"step {s}")
        assert (tcl is None) == (s < steps - 1)
        pos += 1
        idx += C
    np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl)[:, -1], **TOL)
    for jc, tc in ((jcur, tcur), (jnext, tnext)):
        shown = np.asarray(jc["kv_mask"])
        np.testing.assert_array_equal(tc["kv_mask"].numpy(), shown)
        _shown_match(jc, tc, shown > 0, TOL)
    assert int(pos) == S + steps and int(idx) == steps * C


# ---------------------------------------------------------------------------
# Part B: the static ragged verify, and the 1B's with a chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DECODERS))
def test_static_verify_matches_jax(name):
    """Right-padded rows of 12, 9 and 5 tokens prefilled and adopted as a
    ragged cache; two rounds of W = 6 proposals through
    forward_ragged_verify over the key span [0, 64) of 40 slots (key_bounds
    (0, t_cap): nothing read on the host), committing [6, 2, 0] and [3, 6,
    1]: the 12-token row reaches slot 21, past StarCoder2's window."""
    jmod, jcfg, tmod, tcfg = DECODERS[name]
    tree = _tree(name)
    jp, tp = _jparams(tree), convert.from_jax_params(tree)
    lens, T, W = (12, 9, 5), 40, 6
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((3, 12, jcfg.hidden_size)).astype(np.float32)
    mask = (np.arange(12)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    emb *= mask[:, :, None]
    jc = jmod.init_cache(jcfg, 3, T, dtype=jnp.float32)
    _, jc = jmod.forward(jp, jcfg, jnp.asarray(emb), attention_mask=jnp.asarray(mask), cache=jc,
                         policy=JF32)
    jrag = {"k": jc["k"], "v": jc["v"], "kv_mask": jc["kv_mask"],
            "lengths": jnp.asarray(lens, jnp.int32)}
    trag = tmod.init_cache(tcfg, 3, T, dtype=torch.float32)
    tmod.forward(tp, tcfg, torch.from_numpy(emb), attention_mask=torch.from_numpy(mask),
                 cache=trag, policy=TF32)
    tspec._as_ragged(trag, torch.tensor(lens))
    for accepted in ([6, 2, 0], [3, 6, 1]):
        toks = rng.integers(1, jcfg.vocab_size, (3, W))
        jl, jrag = jmod.forward_ragged_verify(jp, jcfg, jnp.asarray(toks, jnp.int32), jrag,
                                              jnp.ones(3, bool), policy=JF32)
        tl, _ = tmod.forward_ragged_verify(tp, tcfg, torch.from_numpy(toks), trag, policy=TF32,
                                           key_bounds=(0, 64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jrag = jdc.commit_verify(jrag, jnp.asarray(accepted, jnp.int32))
        tdc.commit_verify(trag, torch.tensor(accepted))
        np.testing.assert_array_equal(trag["lengths"].numpy(), np.asarray(jrag["lengths"]))
        shown = np.asarray(jrag["kv_mask"])
        np.testing.assert_array_equal(trag["kv_mask"].numpy(), shown)
        _shown_match(jrag, trag, shown > 0, TOL)
    assert int(trag["lengths"].max()) == 21 > SC2["sliding_window"]


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_static_verify_with_chunk_matches_jax(kv):
    """Rows of 3, 5 and 4 tokens adopted as a ragged cache (the shared
    adoption, JAX's _spec_prefill_adopt_jit), then two rounds of W = 5
    proposals fused with the two chunks of 2 of the next batch's
    right-padded prompt (row 2's second chunk all pads) at the device index:
    forward_ragged_verify_with_chunk_static against JAX's
    forward_ragged_verify_with_chunk, and commit_verify after each."""
    jcfg, tcfg = jgbc.tiny_config(), tgbc.tiny_config()
    tree = _tree("gpt_bigcode", 3.0)
    jp, tp = _jparams(tree), convert.from_jax_params(tree)
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    T, C, W = 24, 2, 5
    rng = np.random.default_rng(9)

    def batch(lens):
        P = max(lens)
        mask = (np.arange(P)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
        return (rng.standard_normal((3, P, jcfg.hidden_size)).astype(np.float32)
                * mask[:, :, None], mask)

    emb, mask = batch((3, 5, 4))
    jrag, jpend = jengine._spec_prefill_adopt_jit(
        jp, jnp.asarray(emb), jnp.asarray(mask), dec_name="gpt_bigcode", llm_cfg=jcfg,
        max_new_tokens=8, draft_len=W, policy=JF32, total_next=T, kv_dtype=jdt)
    trag, tpend = tspec._spec_prefill_adopt(tp, tcfg, torch.from_numpy(emb),
                                              torch.from_numpy(mask), T, TF32, True, tdt)
    np.testing.assert_array_equal(tpend.numpy(), np.asarray(jpend))
    nemb, nmask = batch((4, 3, 2))
    jnext = jgbc.init_cache(jcfg, 3, T, dtype=jdt or jnp.float32)
    tnext = tgbc.init_cache(tcfg, 3, T, dtype=tdt or torch.float32)
    idx = torch.zeros(1, dtype=torch.int32)
    for r, accepted in enumerate(([5, 2, 0], [1, 4, 3])):
        toks = np.concatenate([np.asarray(jpend)[:, None],
                               rng.integers(1, jcfg.vocab_size, (3, W - 1))], 1)
        ce, cm = nemb[:, r * C:(r + 1) * C], nmask[:, r * C:(r + 1) * C]
        jl, jrag, jh, jnext = jgbc.forward_ragged_verify_with_chunk(
            jp, jcfg, jnp.asarray(toks, jnp.int32), jrag, jnp.asarray(ce), jnp.asarray(cm), jnext,
            policy=JF32)
        tl, th = tgbc.forward_ragged_verify_with_chunk_static(
            tp, tcfg, torch.from_numpy(toks), trag, torch.from_numpy(ce), torch.from_numpy(cm),
            tnext, idx, t_cap=16, chunk_cap=tengine.chunk_cap(r * C, T), policy=TF32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"round {r}")
        live = cm.astype(bool)  # an all-pad chunk row attends over no real key
        np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live], **TOL)
        jrag = jdc.commit_verify(jrag, jnp.asarray(accepted, jnp.int32))
        tdc.commit_verify(trag, torch.tensor(accepted))
        idx += C
    for jc, tc in ((jrag, trag), (jnext, tnext)):
        shown = np.asarray(jc["kv_mask"])
        np.testing.assert_array_equal(tc["kv_mask"].numpy(), shown)
        _shown_match(jc, tc, shown > 0, TOL)
    np.testing.assert_array_equal(trag["lengths"].numpy(), np.asarray(jrag["lengths"]))


# ---------------------------------------------------------------------------
# Part C: the static loops
# ---------------------------------------------------------------------------

class KeySpy:
    """Records every (kind, key) a StepLoop runs and the decoders' decode
    forwards (kernel 2's steps: forward_decode_static, and the fused
    step)."""

    def __init__(self, monkeypatch):
        self.keys, self.decodes = set(), 0
        run = graphs.StepLoop.run

        def spied_run(loop, kind, key, fn):
            self.keys.add((kind, key))
            return run(loop, kind, key, fn)

        monkeypatch.setattr(graphs.StepLoop, "run", spied_run)
        for mod, names in ((tgbc, ("forward_decode_static", "forward_decode_with_chunk_static")),
                           (tsc, ("forward_decode_static",))):
            for fn_name in names:
                monkeypatch.setattr(mod, fn_name, self._count(getattr(mod, fn_name)))

    def _count(self, fn):
        def call(*a, **kw):
            self.decodes += 1
            return fn(*a, **kw)
        return call


def _pipe_batches(name, n=3, P=12, seed=0):
    """n batches of 2 rows of P ids' embeddings, row 1 left-padded by 3."""
    jmod = DECODERS[name][0]
    tree = _tree(name, 10.0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(5, 512, (2, P))
        ids[1, :3] = 0
        emb = np.array(jmod.embed_tokens(_jparams(tree), jnp.asarray(ids)), np.float32)
        mask = np.ones((2, P), np.int32)
        mask[1, :3] = 0
        emb[1, :3] = 0.0
        out.append((emb, mask))
    return out


def _pipelined(name, batches, **gen_kw):
    """(JAX's [(tokens, lengths)], the port's) at chunk_positions 4: 3
    chunks of the 12-position prompts, 12 new tokens."""
    jmod, jcfg, _, tcfg = DECODERS[name]
    tree = _tree(name, 10.0)
    kw = dict(max_new_tokens=12, do_sample=False, **gen_kw)
    ref = jengine.generate_pipelined(
        _jparams(tree), jcfg, name, [(jnp.asarray(e), jnp.asarray(m)) for e, m in batches],
        jengine.GenerationConfig(**kw), jax.random.PRNGKey(1), policy=JF32, chunk_positions=4)
    out = tengine.generate_pipelined(
        convert.from_jax_params(tree), tcfg,
        [(torch.from_numpy(e), torch.from_numpy(m)) for e, m in batches],
        tengine.GenerationConfig(**kw), policy=TF32, chunk_positions=4)
    return ([(np.asarray(t), np.asarray(l)) for t, l in ref],
            [(t.numpy(), l.numpy()) for t, l in out])


def _pipelined_decodes(lengths: list, n: int, n_chunks: int) -> int:
    """The decode forwards of a static stream: n_chunks fused steps a batch
    but the last; then, while a row is live, decode steps up to token n - 2
    in blocks of BLOCK, to the end of the block in which the last row
    stopped."""
    total = 0
    for i, ln in enumerate(lengths):
        t0 = n_chunks if i + 1 < len(lengths) else 0
        total += t0
        last = int(max(ln)) - 1  # the step that samples the last row's last token
        if last < t0:
            continue
        end = t0
        while end < n - 1:
            end = min(end + BLOCK, n - 1)
            if end > last:
                break
        total += end - t0
    return total


@pytest.mark.parametrize("case", ["run_to_n", "all_stop_mid_block"])
@pytest.mark.parametrize("name", list(DECODERS))
def test_static_pipelined_matches_jax(name, case, monkeypatch):
    """Streams of 3 batches: each batch's ids and lengths are JAX's; the
    decode forwards are the static plan's; with every row stopping at or
    before token 5 (single-id stops taken from each row's free run) the
    decode-only steps end with the block that holds it. A stream of 2
    batches runs the same (kind, key) set as the stream of 3."""
    monkeypatch.setattr(tengine, "DECODE_GRAPH_STEPS", BLOCK)
    batches = _pipe_batches(name)
    gen_kw = {}
    if case == "all_stop_mid_block":
        free = _pipelined(name, batches)[1]
        gen_kw = dict(stop_sequences=tuple((int(t[r, 5]),) for t, _ in free for r in range(2)))
    spy = KeySpy(monkeypatch)
    ref, out = _pipelined(name, batches, **gen_kw)
    for i, ((rt, rl), (pt, pl)) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(pt, rt, err_msg=f"batch {i}")
        np.testing.assert_array_equal(pl, rl, err_msg=f"batch {i}")
    lengths = [l for _, l in out]
    assert spy.decodes == _pipelined_decodes(lengths, 12, 3)
    if case == "all_stop_mid_block":
        assert all(int(max(l)) <= 6 for l in lengths)
        return
    assert all((l == 12).all() for l in lengths)
    keys3, spy.keys = spy.keys, set()
    _pipelined(name, batches[:2])
    assert spy.keys == keys3 and {k for k, _ in keys3} == {"fused", "decode"}


def _spec_batches(seed=3):
    """3 batches of 3 right-padded rows of ids from a small set (drafts
    recur), with their ids -1 at the holes."""
    tree = _tree("gpt_bigcode", 3.0)
    rng = np.random.default_rng(seed)
    out = []
    for lens in ((5, 3, 4), (4, 5, 2), (3, 3, 5)):
        ids = rng.choice([3, 7, 9, 11, 13], (3, 5))
        mask = (np.arange(5)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
        emb = np.array(jgbc.embed_tokens(_jparams(tree), jnp.asarray(ids)), np.float32)
        out.append((emb * mask[:, :, None], mask, np.where(mask > 0, ids, -1).astype(np.int32)))
    return out


@pytest.mark.parametrize("case", ["run_to_n", "all_stop_mid_block"])
def test_static_pipelined_spec_matches_jax(case, monkeypatch):
    """generate_pipelined_spec over 3 batches (draft_len 5, 14 new tokens,
    chunk_positions 2: 3 chunks a prompt): ids, lengths and stats rounds
    are JAX's. With stops that end every row by token 4 and chunk_positions
    1 (5 chunks, more than a block of 4 rounds), the chunk left after the
    first block runs alone (JAX's tail loop). A stream of 2 batches runs the
    same (kind, key) set as the stream of 3."""
    monkeypatch.setattr(tspec, "DECODE_GRAPH_STEPS", BLOCK)
    tree = _tree("gpt_bigcode", 3.0)
    batches = _spec_batches()
    N, K, C = 14, 5, 2
    stops = ()
    if case == "all_stop_mid_block":
        C = 1
        free = tspec.generate_pipelined_spec(
            convert.from_jax_params(tree), tgbc.tiny_config(),
            [tuple(map(torch.from_numpy, b)) for b in batches],
            tengine.GenerationConfig(max_new_tokens=N, do_sample=False), policy=TF32,
            draft_len=K, chunk_positions=C)
        stops = tuple((int(t[r, 3]),) for t, _ in free for r in range(3))
    jstats, tstats = [], []
    ref = jengine.generate_pipelined_spec(
        _jparams(tree), jgbc.tiny_config(), "gpt_bigcode",
        [tuple(map(jnp.asarray, b)) for b in batches],
        jengine.GenerationConfig(max_new_tokens=N, do_sample=False, stop_sequences=stops),
        policy=JF32, draft_len=K, chunk_positions=C, stats=jstats)
    spy = KeySpy(monkeypatch)

    def port(bs, stats):
        return tspec.generate_pipelined_spec(
            convert.from_jax_params(tree), tgbc.tiny_config(),
            [tuple(map(torch.from_numpy, b)) for b in bs],
            tengine.GenerationConfig(max_new_tokens=N, do_sample=False, stop_sequences=stops),
            policy=TF32, draft_len=K, chunk_positions=C, stats=stats)

    out = port(batches, tstats)
    assert tstats == [int(r) for r in jstats]
    for i, ((rt, rl), (pt, pl)) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt), err_msg=f"batch {i}")
        np.testing.assert_array_equal(pl.numpy(), np.asarray(rl), err_msg=f"batch {i}")
    kinds = {k for k, _ in spy.keys}
    if case == "all_stop_mid_block":
        assert all(int(l.max()) <= 4 for _, l in out) and "chunk" in kinds
        return
    assert sum(tstats) < 3 * N  # drafts were accepted
    keys3, spy.keys = spy.keys, set()
    port(batches[:2], [])
    assert spy.keys == keys3 and kinds == {"fused", "verify"}


def _motif_rows(name, lens):
    """Right-padded rows of a repeating 4-id motif (drafts found and partly
    accepted), ids -1 at the holes."""
    motif = [7, 9, 11, 13]
    P = max(lens)
    ids = np.full((len(lens), P), -1)
    for b, n in enumerate(lens):
        ids[b, :n] = (motif * 4)[b:b + n]
    mask = (ids >= 0).astype(np.int32)
    emb = np.array(DECODERS[name][0].embed_tokens(_jparams(_tree(name, 3.0)),
                                                  jnp.asarray(np.maximum(ids, 0))), np.float32)
    return emb * mask[:, :, None], mask, ids


@pytest.mark.parametrize("name", list(DECODERS))
def test_static_b1_speculative_matches_jax(name, monkeypatch):
    """generate_greedy_speculative, B = 1, draft_len 4, 24 new tokens: ids,
    lengths and n_forwards are JAX's without a stop and with one that fires
    mid-block (the rounds after it change nothing and count no forward)."""
    monkeypatch.setattr(tspec, "DECODE_GRAPH_STEPS", BLOCK)
    jmod, jcfg, _, tcfg = DECODERS[name]
    tree = _tree(name, 3.0)
    emb, mask, ids = _motif_rows(name, (9,))
    args = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(ids))
    kw = dict(max_new_tokens=24, draft_len=4, pad_token_id=0)
    free = tspec.generate_greedy_speculative(convert.from_jax_params(tree), tcfg, *args,
                                             policy=TF32, **kw)[0]
    for stops in ((), ((int(free[0, 9]), int(free[0, 10])),)):
        ref, ref_len, ref_fwd = jspec.generate_greedy_speculative(
            _jparams(tree), jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(ids, jnp.int32),
            dec_name=name, llm_cfg=jcfg, policy=JF32, stop_sequences=stops, **kw)
        tokens, lengths, n_fwd = tspec.generate_greedy_speculative(
            convert.from_jax_params(tree), tcfg, *args, policy=TF32, stop_sequences=stops, **kw)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
        assert n_fwd == int(ref_fwd) < 24, (n_fwd, int(ref_fwd))
    assert int(lengths[0]) <= 11


@pytest.mark.parametrize("name", list(DECODERS))
def test_static_batched_speculative_matches_jax(name, monkeypatch):
    """generate_greedy_speculative_batched over right-padded rows of 12, 9
    and 5 ids, draft_len 4, 24 new tokens, every row stopping mid-block
    (single-id stops from each row's free run): ids, lengths and n_forwards
    are JAX's, a round after the last row stopped counting no forward."""
    monkeypatch.setattr(tspec, "DECODE_GRAPH_STEPS", BLOCK)
    jmod, jcfg, _, tcfg = DECODERS[name]
    tree = _tree(name, 3.0)
    emb, mask, ids = _motif_rows(name, (12, 9, 5))
    args = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(ids))
    kw = dict(max_new_tokens=24, draft_len=4, pad_token_id=0)
    free = tspec.generate_greedy_speculative_batched(convert.from_jax_params(tree), tcfg, *args,
                                                     policy=TF32, **kw)[0]
    stops = tuple((int(free[b, 7]),) for b in range(3))
    ref, ref_len, ref_fwd = jspec.generate_greedy_speculative_batched(
        _jparams(tree), jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(ids, jnp.int32),
        dec_name=name, llm_cfg=jcfg, policy=JF32, stop_sequences=stops, **kw)
    tokens, lengths, n_fwd = tspec.generate_greedy_speculative_batched(
        convert.from_jax_params(tree), tcfg, *args, policy=TF32, stop_sequences=stops, **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert n_fwd == int(ref_fwd) and (lengths.numpy() <= 8).all()
