"""Port parity for the training attention: the forward with the logsumexp,
the backward pair and the autograd Function around them.

On the CPU the wrappers take their plain PyTorch versions, held here
against the JAX package's Pallas kernels run in interpret mode, each Pallas
backward variant driven by its explicit arguments at tiny shapes with small
blocks, so that T spans several blocks: fused; one-pass rectangular and
triangular; dq partials ("dqp"); the split pair, rectangular and
triangular. The cases cover MQA/GQA, padded keys, ragged S, q_offset > 0 and
window. Tolerance 1e-4 (rtol and atol) for the kernels' outputs; autograd
through flash_prefill_trainable against jax.vjp of the JAX one at 1e-5.
Rows that see no key are compared only in the test that is about them.

Tests marked `gpu` hold each CUDA kernel against its plain version on the
card and skip without one. They import no JAX, so on the card they run as
    python -m pytest --noconftest -m gpu tests/test_torch_flash_backward.py
"""

import numpy as np
import pytest
import torch

from starvector_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=1e-4, atol=1e-4)
VJP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def jfa():
    return pytest.importorskip("starvector_tpu.ops.flash_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(name, seed=0, D=16):
    """(q, k, v, kv_mask, q_offset, window, dout, live) for a named case;
    live (B, S) marks the query rows that see at least one key."""
    rng = np.random.default_rng(seed)
    B, H, Hkv, q_offset, window = 2, 4, 1, 0, None
    S, T = {"ragged": (37, 37), "q_offset": (16, 48), "q_offset_window": (16, 48)}.get(name,
                                                                                       (40, 40))
    if name in ("gqa", "window", "gqa_ragged"):
        Hkv = 2
    if name == "gqa_ragged":
        S = T = 37
    if name in ("window", "q_offset_window"):
        window = 7
    if name.startswith("q_offset"):
        q_offset = 16
    mask = np.ones((B, T), np.int32)
    if name == "padded_keys":
        mask[1, 33:] = 0   # right padding, as the loader pads SVGs
    if name == "no_visible_key":
        mask[1, :6] = 0    # left padding: row 1's first queries see no key
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = q_offset + np.arange(S)
    live = np.stack([[mask[b, max(0, p - (window or T) + 1): p + 1].any() for p in pos]
                     for b in range(B)])
    return q, k, v, mask, q_offset, window, g, live


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("name,tri", [("mqa", False), ("gqa", False), ("padded_keys", False),
                                      ("ragged", False), ("q_offset", False), ("window", False),
                                      ("ragged", True)])
def test_flash_prefill_with_lse_plain_matches_pallas(jfa, name, tri):
    """out and lse (B, H, S) against kernels 4 (rectangular) and 5
    (triangular, S == T, q_offset 0, block_q == block_k)."""
    q, k, v, mask, q_offset, window, _, live = _case(name)
    ref_out, ref_lse = jfa.flash_prefill_with_lse(*_j(q, k, v, mask), q_offset, window=window,
                                                  block_q=16, block_k=16, interpret=True,
                                                  tri=tri)
    out, lse = tfa.flash_prefill_with_lse(*_t(q, k, v, mask), q_offset, window=window)
    assert out.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy()[live], np.asarray(ref_out)[live], **TOL)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[live],
                               np.asarray(ref_lse).transpose(0, 2, 1)[live], **TOL)


@pytest.mark.parametrize("fn", ["flash_prefill", "flash_prefill_with_lse"])
@pytest.mark.parametrize("name", ["mqa", "gqa", "padded_keys", "ragged", "q_offset", "window"])
def test_bf16_forward_plain_matches_pallas_in_bf16(jfa, name, fn):
    """bf16 inputs through the Pallas forward kernels (interpret mode, 16-key
    blocks, so T spans several tiles) and the port's plain versions. The
    Pallas cell rounds the unnormalised P to bf16 before the P V product
    (the bf16 kernel's rounding point); the plain versions round the
    normalised P. Outputs agree within one or two bf16 steps (atol = rtol
    2e-2); lse, an fp32 sum of fp32 exponentials, within 1e-4."""
    import jax.numpy as jnp

    q, k, v, mask, q_offset, window, _, live = _case(name, seed=7)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    blocks = dict(block_q=16, block_k=16, interpret=True)
    if fn == "flash_prefill":
        ref = jfa.flash_prefill(jq, jk, jv, jnp.asarray(mask), q_offset, window=window, **blocks)
        out = tfa.flash_prefill(tq, tk, tv, tmask, q_offset, window=window)
    else:
        ref, ref_lse = jfa.flash_prefill_with_lse(jq, jk, jv, jnp.asarray(mask), q_offset,
                                                  window=window, **blocks)
        out, lse = tfa.flash_prefill_with_lse(tq, tk, tv, tmask, q_offset, window=window)
        np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[live],
                                   np.asarray(ref_lse).transpose(0, 2, 1)[live], **TOL)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy()[live], np.asarray(ref, np.float32)[live],
                               rtol=2e-2, atol=2e-2)


# (variant, case): each Pallas backward variant with the explicit arguments
# that select it, over a matrix that covers every case at least once
BACKWARD = {
    "fused": dict(fused=True, block_q=16),
    "onepass": dict(onepass=True, block_q=16, block_k=16),
    "onepass_tri": dict(onepass=True, tri=True, block_q=16, block_k=16),
    "dqp": dict(onepass="dqp", block_q=16, block_k=16),
    "split": dict(onepass=False, block_q=16, block_k=16),
    "split_tri": dict(onepass=False, tri=True, block_q=16, block_k=32),
}
BACKWARD_CASES = [("fused", "mqa"), ("fused", "padded_keys"), ("fused", "window"),
                  ("onepass", "gqa"), ("onepass", "q_offset_window"), ("onepass_tri", "ragged"),
                  ("dqp", "q_offset"), ("split", "padded_keys"), ("split", "q_offset_window"),
                  ("split_tri", "gqa_ragged")]


@pytest.mark.parametrize("variant,name", BACKWARD_CASES)
def test_flash_backward_plain_matches_pallas(jfa, variant, name):
    q, k, v, mask, q_offset, window, g, _ = _case(name)
    jq, jk, jv, jmask, jg = _j(q, k, v, mask, g)
    jout, jlse = jfa.flash_prefill_with_lse(jq, jk, jv, jmask, q_offset, window=window,
                                            interpret=True)
    ref = jfa.flash_backward(jq, jk, jv, jmask, jout, jlse, jg, q_offset, window=window,
                             interpret=True, **BACKWARD[variant])
    tq, tk, tv, tmask, tg = _t(q, k, v, mask, g)
    out, lse = tfa.flash_prefill_with_lse(tq, tk, tv, tmask, q_offset, window=window)
    got = tfa.flash_backward(tq, tk, tv, tmask, out, lse, tg, q_offset, window=window)
    for what, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what, **TOL)


@pytest.mark.parametrize("name", ["mqa", "padded_keys", "gqa_ragged", "q_offset_window"])
def test_flash_prefill_trainable_autograd_matches_jax_vjp(name):
    """Autograd through the port's Function, with q, k and v as views of one
    fused projection output (as the decoder passes them), against jax.vjp of
    the JAX flash_prefill_trainable (custom VJP: Pallas forward and
    backward). The gradients reach the fused tensor through the views."""
    import jax

    from starvector_tpu.ops.flash_attention import flash_prefill_trainable as jtrain

    q, k, v, mask, q_offset, window, g, _ = _case(name, seed=3)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    jmask = _j(mask)[0]
    out_ref, vjp = jax.vjp(lambda q, k, v: jtrain(q, k, v, jmask, q_offset, window=window),
                           *_j(q, k, v))
    dq_ref, dk_ref, dv_ref = vjp(_j(g)[0])

    qkv = torch.cat([torch.from_numpy(q).reshape(B, S, H * D),
                     torch.zeros((B, S, 2 * Hkv * D))], dim=-1).requires_grad_(True)
    tq = qkv[..., :H * D].unflatten(-1, (H, D))
    tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (k, v))
    out = tfa.flash_prefill_trainable(tq, tk, tv, torch.from_numpy(mask), q_offset,
                                      window=window)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), **VJP_TOL)
    dq = qkv.grad[..., :H * D].reshape(B, S, H, D)
    assert (qkv.grad[..., H * D:] == 0).all()
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), **VJP_TOL)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(dk_ref), **VJP_TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(dv_ref), **VJP_TOL)


def test_rows_that_see_no_key_give_zeros():
    """Left-padded keys leave row 1's first queries with no visible key:
    the forward gives zeros and lse = -1e30 + log(1e-30) there, as the
    kernel does, and the backward finite zeros, never NaN."""
    q, k, v, mask, _, _, g, live = _case("no_visible_key")
    assert not live.all()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_prefill_trainable(tq, tk, tv, torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    _, lse = tfa.flash_prefill_with_lse(*_t(q, k, v, mask))
    dead = ~live
    assert (out.detach().numpy()[dead] == 0).all()
    assert (lse.numpy().transpose(0, 2, 1)[dead] == np.float32(tfa.KERNEL_NEG_INF)).all()
    for grad in (tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(grad).all()
    assert (tq.grad.numpy()[dead] == 0).all()
    assert (tk.grad.numpy()[1, :6] == 0).all() and (tv.grad.numpy()[1, :6] == 0).all()


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the training wrappers launch nothing; a device with no
    kernel raises instead of falling back."""
    def counts():
        return (tfa.flash_prefill_with_lse.launches, tfa.flash_bwd_dkdv.launches,
                tfa.flash_bwd_dq.launches)

    before = counts()
    q, k, v, mask, _, _, g, _ = _case("mqa")
    out, lse = tfa.flash_prefill_with_lse(*_t(q, k, v, mask))
    tfa.flash_backward(*_t(q, k, v, mask), out, lse, torch.from_numpy(g))
    assert counts() == before
    meta = torch.empty((1, 4, 4, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_prefill_with_lse(meta, meta[:, :, :1], meta[:, :, :1],
                                   torch.ones((1, 4), dtype=torch.int32, device="meta"))


# (B, T, Hkv, G, SMs): the 1B train step on an H100, the long contexts, GQA,
# a short batch, a smaller card
PLAN_SHAPES = [(4, 769, 1, 16, 132), (1, 8450, 1, 16, 132), (1, 16642, 1, 2, 132),
               (2, 130, 4, 4, 132), (2, 37, 1, 16, 132), (4, 769, 1, 16, 16)]


@pytest.mark.parametrize("B,T,Hkv,G,sms", PLAN_SHAPES)
def test_dkdv_head_split_plan_covers_every_head_once(B, T, Hkv, G, sms):
    """The default head_split divides G, and the kernel's blocks of one
    (batch, KV head, key tile), split s taking heads hk*G + s*G/split + i
    for i < G/split, take every query head of the KV head exactly once."""
    split = tfa.dkdv_head_split(B, T, Hkv, G, sms)
    assert 1 <= split <= G and G % split == 0
    for hk in range(Hkv):
        heads = [hk * G + s * (G // split) + i for s in range(split) for i in range(G // split)]
        assert sorted(heads) == list(range(hk * G, (hk + 1) * G))


def test_dkdv_head_split_fills_the_card_at_the_1b_step():
    """At B=4, T=769 (13 key tiles, one KV head of 16 query heads) on 132
    SMs, the default split gives at least one wave of blocks, and its
    longest block (the first key tile: 13 query tiles x its heads) walks
    fewer steps than without a split."""
    split = tfa.dkdv_head_split(4, 769, 1, 16, 132)
    assert 4 * 13 * split >= 132
    assert (16 // split) * 13 < 16 * 13


# flash_bwd_dkdv's bf16 ms at each head_split on an NVIDIA H100 80GB HBM3 at
# 700 W, all keys valid (chip_smoke.py::head_split_times, PERF.md section
# 6): (B, S, T, q_offset, Hkv, G, window) -> {split: ms}. The 1B step, the
# 8k triangle, the 8B's 36 over 4 heads under its 4096-key window; then
# three shapes the plan's DKDV_BLOCK_STEPS was not fitted to: the 8k and
# 16k sequence-parallel chunks and the 16k triangle at 2 heads. At the 8k
# triangle the pick sits at the margin: 3.7% from the best here, 4.3% in a
# second sweep on the same card (PERF.md section 6)
DKDV_SWEEP = {
    (4, 769, 769, 0, 1, 16, None): {1: 0.6813, 2: 0.3524, 4: 0.1934, 8: 0.1141, 16: 0.1245},
    (1, 8450, 8450, 0, 1, 16, None): {1: 6.7846, 2: 3.8752, 4: 2.1145, 8: 2.1333, 16: 2.1932},
    (2, 1160, 1160, 0, 4, 9, 4096): {1: 0.5734, 3: 0.2330, 9: 0.2626},
    (1, 4700, 4700, 0, 4, 9, 4096): {1: 2.2917, 3: 1.5305, 9: 1.5679},
    (1, 8192, 8192, 0, 4, 9, 4096): {1: 4.3089, 3: 3.4313, 9: 3.4933},
    (2, 8192, 8192, 0, 4, 9, 4096): {1: 6.6756, 3: 6.7669, 9: 7.0196},
    (1, 16384, 16384, 0, 4, 9, 4096): {1: 8.5521, 3: 7.9101, 9: 8.1178},
    (4, 769, 769, 0, 4, 9, 4096): {1: 0.4044, 3: 0.2294, 9: 0.2778},
    (1, 2048, 2048, 0, 4, 9, 4096): {1: 0.9395, 3: 0.3790, 9: 0.3401},
    (1, 1024, 8450, 7426, 1, 16, None): {1: 0.8512, 2: 0.5349, 4: 0.5320, 8: 0.5564, 16: 0.5935},
    (1, 1024, 16642, 15618, 1, 16, None): {1: 1.0360, 2: 1.0409, 4: 1.0583, 8: 1.0984,
                                           16: 1.1581},
    (1, 16642, 16642, 0, 1, 2, None): {1: 1.8590, 2: 1.0374},
}


def _sweep_id(shape):
    B, S, T, q_offset, Hkv, G, window = shape
    if S == T and not q_offset:
        return f"B={B} T={T} Hkv={Hkv} G={G} W={window}"
    return f"B={B} S={S} T={T} q_offset={q_offset} Hkv={Hkv} G={G} W={window}"


@pytest.mark.parametrize("shape", list(DKDV_SWEEP), ids=_sweep_id)
def test_dkdv_head_split_picks_a_measured_fastest(shape):
    """On the 132 SMs the sweep ran on, the plan picks the fastest split or
    one within 4% of it (the causal model it replaced picked 1 at the 8B's
    B=1 T=8192, 26% slower than 3, and 2 at the 8k triangle, 83% slower
    than 4); at the 1B train step it picks 8, as before."""
    B, S, T, q_offset, Hkv, G, window = shape
    times = DKDV_SWEEP[shape]
    split = tfa.dkdv_head_split(B, T, Hkv, G, 132, S=S, q_offset=q_offset, window=window)
    assert times[split] <= 1.04 * min(times.values()), (split, times)
    if shape == (4, 769, 769, 0, 1, 16, None):
        assert split == 8


@pytest.mark.parametrize("S,T,q_offset,window", [(100, 100, 0, None), (200, 200, 0, 70),
                                                 (64, 300, 236, None), (90, 400, 310, 100)])
def test_dkdv_query_tiles_cover_every_visible_pair(S, T, q_offset, window):
    """The query tiles the plan counts for each key tile hold every query
    row that sees one of its keys (causal with q_offset, the window), and
    the 8B's T = 8192 under the 4096-key window walks 6240 of the causal
    triangle's 8256 (key tile, query tile) steps."""
    tiles = tfa.dkdv_query_tiles(S, T, q_offset, True, window)
    q = q_offset + np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    vis = (t <= q) & ((t > q - window) if window else True)
    for j, n in enumerate(tiles):
        rows = np.nonzero(vis[:, j * 64:(j + 1) * 64].any(axis=1))[0]
        if n == 0:
            assert rows.size == 0
            continue
        lo = (max(0, j * 64 - q_offset)) // 64
        assert rows.size and lo * 64 <= rows.min() and rows.max() < (lo + n) * 64
    assert sum(tfa.dkdv_query_tiles(8192, 8192, 0, True, 4096)) == 6240
    assert sum(tfa.dkdv_query_tiles(8192, 8192)) == 128 * 129 // 2


@pytest.mark.parametrize("head_split", [0, 3, 5, 32])
def test_flash_bwd_dkdv_rejects_a_head_split_that_does_not_divide_g(head_split):
    """Checked before the CPU takes the plain version, so the argument is
    refused on every device."""
    q, k, v, mask, _, _, g, _ = _case("mqa")  # H = 4 query heads over one KV head
    out, lse = tfa.flash_prefill_with_lse(*_t(q, k, v, mask))
    delta = tfa.attention_delta(out, torch.from_numpy(g))
    with pytest.raises(ValueError, match="head_split"):
        tfa.flash_bwd_dkdv(*_t(q, k, v, mask), torch.from_numpy(g), lse, delta,
                           head_split=head_split)
    dk, dv = tfa.flash_bwd_dkdv(*_t(q, k, v, mask), torch.from_numpy(g), lse, delta, head_split=2)
    ref = tfa.flash_bwd_dkdv(*_t(q, k, v, mask), torch.from_numpy(g), lse, delta)
    torch.testing.assert_close((dk, dv), ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

GPU_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GPU_CASES = ["mqa", "gqa", "padded_keys", "ragged", "q_offset", "window", "q_offset_window"]


def _cuda_case(name, dev, dtype):
    q, k, v, mask, q_offset, window, g, live = _case(name, seed=5, D=128)
    q, k, v, g = (torch.from_numpy(a).to(dev, dtype) for a in (q, k, v, g))
    return q, k, v, torch.from_numpy(mask).to(dev), q_offset, window, g, live


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", GPU_CASES)
def test_flash_training_kernels_match_plain(cuda, name, dtype):
    q, k, v, mask, q_offset, window, g, live = _cuda_case(name, cuda, dtype)
    n = (tfa.flash_prefill_with_lse.launches, tfa.flash_bwd_dkdv.launches,
         tfa.flash_bwd_dq.launches)
    out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_offset, window=window)
    ref_out, ref_lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_offset, window=window,
                                                  kernels=False)
    grads = tfa.flash_backward(q, k, v, mask, ref_out, ref_lse, g, q_offset, window=window)
    ref = tfa.flash_backward(q, k, v, mask, ref_out, ref_lse, g, q_offset, window=window,
                             kernels=False)
    torch.cuda.synchronize()
    assert (tfa.flash_prefill_with_lse.launches, tfa.flash_bwd_dkdv.launches,
            tfa.flash_bwd_dq.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    live = torch.from_numpy(live).to(cuda)
    torch.testing.assert_close(out[live].float(), ref_out[live].float(), **GPU_TOL[dtype])
    torch.testing.assert_close(lse.transpose(1, 2)[live], ref_lse.transpose(1, 2)[live],
                               **GPU_TOL[torch.float32])
    for a, b in zip(grads, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), **GPU_TOL[dtype])


@pytest.mark.gpu
def test_flash_trainable_on_the_card_counts_its_launches(cuda):
    q, k, v, mask, _, _, g, _ = _cuda_case("no_visible_key", cuda, torch.float32)
    for t in (q, k, v):
        t.requires_grad_(True)
    n = (tfa.flash_prefill_with_lse.launches, tfa.flash_bwd_dkdv.launches,
         tfa.flash_bwd_dq.launches)
    tfa.flash_prefill_trainable(q, k, v, mask).backward(g)
    torch.cuda.synchronize()
    assert (tfa.flash_prefill_with_lse.launches, tfa.flash_bwd_dkdv.launches,
            tfa.flash_bwd_dq.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def _backward_inputs(q, k, v, mask, g, q_offset=0, window=None):
    """out, lse and delta from the plain forward, so a comparison isolates
    the backward kernels."""
    out, lse = tfa.flash_prefill_with_lse(q, k, v, mask, q_offset, window=window, kernels=False)
    return out, lse, tfa.attention_delta(out, g)


def _1b_step_case(dev, seed=11):
    """bf16 q, k, v, dout and an all-ones mask at the 1B training shape:
    B=4, S=T=769, H=16 query heads over one KV head, D=128."""
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((4, 769, 16, 128), dtype=np.float32) for _ in "qg")
    k, v = (rng.standard_normal((4, 769, 1, 128), dtype=np.float32) for _ in "kv")
    q, k, v, g = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v, g))
    return q, k, v, torch.ones((4, 769), dtype=torch.int32, device=dev), g


@pytest.mark.gpu
@pytest.mark.parametrize("head_split", [1, 2, 4, 8, 16])
def test_bf16_backward_at_the_1b_step_matches_plain_for_each_head_split(cuda, head_split):
    q, k, v, mask, g = _1b_step_case(cuda)
    _, lse, delta = _backward_inputs(q, k, v, mask, g)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta, head_split=head_split)
    dq = tfa.flash_bwd_dq(q, k, v, mask, g, lse, delta)
    ref = tfa.flash_bwd_dq(q, k, v, mask, g, lse, delta, kernels=False), \
        *tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta, kernels=False)
    torch.cuda.synchronize()
    for a, b in zip((dq, dk, dv), ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), **GPU_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_backward_with_a_head_split_matches_plain(cuda, dtype):
    """G = 2 query heads over each of 2 KV heads, each KV head's heads split
    across 2 blocks."""
    q, k, v, mask, q_offset, window, g, _ = _cuda_case("gqa", cuda, dtype)
    _, lse, delta = _backward_inputs(q, k, v, mask, g, q_offset, window)
    got = tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta, q_offset, window=window, head_split=2)
    ref = tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta, q_offset, window=window,
                             kernels=False)
    torch.cuda.synchronize()
    torch.testing.assert_close([t.float() for t in got], [t.float() for t in ref],
                               **GPU_TOL[dtype])


@pytest.mark.gpu
def test_bf16_rows_that_see_no_key_get_zero_dq(cuda):
    q, k, v, mask, _, _, g, live = _cuda_case("no_visible_key", cuda, torch.bfloat16)
    out, lse, delta = _backward_inputs(q, k, v, mask, g)
    dq = tfa.flash_bwd_dq(q, k, v, mask, g, lse, delta)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta, head_split=4)
    ref = tfa.flash_backward(q, k, v, mask, out, lse, g, kernels=False)
    torch.cuda.synchronize()
    dead = torch.from_numpy(~live).to(cuda)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[dead] == 0).all()
    assert (dk[1, :6] == 0).all() and (dv[1, :6] == 0).all()
    for a, b in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a.float(), b.float(), **GPU_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_bf16_backward_is_bit_identical_across_launches(cuda):
    """No atomics: the head splits are summed in a fixed order."""
    q, k, v, mask, g = _1b_step_case(cuda, seed=12)
    _, lse, delta = _backward_inputs(q, k, v, mask, g)
    first = (tfa.flash_bwd_dq(q, k, v, mask, g, lse, delta),
             *tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta))
    second = (tfa.flash_bwd_dq(q, k, v, mask, g, lse, delta),
              *tfa.flash_bwd_dkdv(q, k, v, mask, g, lse, delta))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_forward_at_the_1b_step_matches_plain(cuda):
    """The tensor-core forward with its lse at the 1B training shape."""
    q, k, v, mask, _ = _1b_step_case(cuda, seed=13)
    out, lse = tfa.flash_prefill_with_lse(q, k, v, mask)
    ref_out, ref_lse = tfa.flash_prefill_with_lse(q, k, v, mask, kernels=False)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref_out.float(), **GPU_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **GPU_TOL[torch.float32])


@pytest.mark.gpu
def test_bf16_forward_rows_that_see_no_key_give_zeros(cuda):
    """Rows with every key masked: zero output and lse = -1e30 + log(1e-30)
    (which is -1e30 in fp32), never NaN; the other rows match the plain
    version."""
    q, k, v, mask, _, _, _, live = _cuda_case("no_visible_key", cuda, torch.bfloat16)
    out, lse = tfa.flash_prefill_with_lse(q, k, v, mask)
    ref_out, ref_lse = tfa.flash_prefill_with_lse(q, k, v, mask, kernels=False)
    torch.cuda.synchronize()
    live = torch.from_numpy(live).to(cuda)
    assert torch.isfinite(out.float()).all()
    assert (out[~live] == 0).all()
    assert (lse.transpose(1, 2)[~live] == np.float32(tfa.KERNEL_NEG_INF)).all()
    torch.testing.assert_close(out[live].float(), ref_out[live].float(), **GPU_TOL[torch.bfloat16])
    torch.testing.assert_close(lse.transpose(1, 2)[live], ref_lse.transpose(1, 2)[live],
                               **GPU_TOL[torch.float32])


@pytest.mark.gpu
def test_bf16_forward_is_bit_identical_across_launches(cuda):
    """Each output is written once, with no atomics."""
    q, k, v, mask, _ = _1b_step_case(cuda, seed=14)
    first = tfa.flash_prefill_with_lse(q, k, v, mask)
    second = tfa.flash_prefill_with_lse(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_bf16_forward_refuses_rows_that_are_not_16_byte_aligned(cuda):
    """The bf16 kernel copies rows 16 bytes at a time: a q whose rows are
    513 elements (1026 bytes) apart is refused, not read misaligned; fp32
    rows are read one element at a time and need no alignment."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 8, 4 * 128 + 1), device=cuda).to(dtype)[..., :512].unflatten(-1, (4, 128))
        k = torch.randn((1, 8, 1, 128), device=cuda).to(dtype)
        mask = torch.ones((1, 8), dtype=torch.int32, device=cuda)
        if dtype == torch.bfloat16:
            for fn in (tfa.flash_prefill, tfa.flash_prefill_with_lse):
                with pytest.raises(ValueError, match="aligned"):
                    fn(q, k, k, mask)
        else:
            torch.testing.assert_close(tfa.flash_prefill(q, k, k, mask),
                                       tfa.flash_prefill(q, k, k, mask, kernels=False),
                                       **GPU_TOL[dtype])
