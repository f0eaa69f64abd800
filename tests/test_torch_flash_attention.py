"""Port parity for the two attention kernels of the inference path.

On the CPU the wrappers take their plain PyTorch versions, which are held
here against the JAX package's Pallas kernels run in interpret mode
(`flash_prefill`, `gqa_decode_batched`, `mqa_decode`) and against the XLA
`merged_decode_attention`, over the Pallas tests' matrix: MQA/GQA, padded
keys, lengths that do not divide the blocks, q_offset > 0, window.
Tolerance 2e-4, as tests/test_flash_attention.py uses; rows that see no key
are unspecified and left out.

Tests marked `gpu` hold each CUDA kernel against its plain version on the
card and skip without one. They import no JAX, so on the card they run as
    python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

from starvector_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def jfa():
    return pytest.importorskip("starvector_tpu.ops.flash_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _prefill_case(name, seed=0, D=32):
    """(q, k, v, kv_mask, q_offset, window, live) for a named case; live
    (B, S) marks the query rows that see at least one key."""
    rng = np.random.default_rng(seed)
    H, Hkv, B, q_offset, window = 4, 1, 2, 0, None
    S, T = {"ragged": (37, 37), "q_offset": (16, 48), "cache_window": (37, 53)}.get(name, (40, 40))
    mask = np.ones((B, T), np.int32)
    if name == "gqa":
        Hkv = 2
    elif name == "mha":
        Hkv = 4
    elif name == "padded_keys":
        mask[:, :5] = 0              # left padding
    elif name == "q_offset":
        q_offset = 20
        mask[:, q_offset + S:] = 0   # unwritten cache tail
    elif name == "window":
        window = 8
    elif name == "non_causal":
        mask[1, 30:] = 0
    elif name == "cache_window":
        # the decoder's prefill: S prefix tokens in a cache of T slots
        mask[:, S:] = 0
        mask[1, :4] = 0
    q = _rand(rng, (B, S, H, D))
    k = _rand(rng, (B, T, Hkv, D))
    v = _rand(rng, (B, T, Hkv, D))
    pos = q_offset + np.arange(S) if name != "non_causal" else np.full(S, T - 1)
    live = np.stack([[mask[b, : p + 1].any() for p in pos] for b in range(B)])
    return q, k, v, mask, q_offset, window, live


PREFILL_CASES = ["mqa", "gqa", "mha", "padded_keys", "ragged", "q_offset", "window",
                 "cache_window", "non_causal"]


@pytest.mark.parametrize("name", PREFILL_CASES)
def test_flash_prefill_plain_matches_pallas(jfa, name):
    import jax.numpy as jnp

    q, k, v, mask, q_offset, window, live = _prefill_case(name)
    causal = name != "non_causal"
    ref = jfa.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                            q_offset, causal=causal, window=window, block_q=16, block_k=16,
                            interpret=True)
    out = tfa.flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(mask), q_offset, causal=causal, window=window)
    assert live.sum() >= live.size - 10
    np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live], **TOL)


def _decode_case(seed, B=2, Hkv=2, G=4, T=100, D=32, pad=7):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (B, Hkv * G, D))
    k = _rand(rng, (B, T, Hkv, D))
    v = _rand(rng, (B, T, Hkv, D))
    mask = np.ones((B, T), np.int32)
    mask[0, :pad] = 0
    mask[1, 30:33] = 0
    return q, k, v, mask


@pytest.mark.parametrize("cache_len,window_start", [(70, 0), (100, 0), (70, 10), (45, 40)])
def test_gqa_decode_batched_plain_matches_pallas(jfa, cache_len, window_start):
    import jax.numpy as jnp

    q, k, v, mask = _decode_case(1)
    ref = jfa.gqa_decode_batched(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                 jnp.asarray(cache_len), window_start, block_k=32, interpret=True)
    out = tfa.gqa_decode_batched(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(mask), cache_len, window_start)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mqa_decode_plain_matches_pallas(jfa):
    """Kernel 3's signature (one KV head, cache (B, T, D)), served by kernel 2."""
    import jax.numpy as jnp

    q, k, v, mask = _decode_case(2, Hkv=1, G=8, T=64)
    k, v = k[:, :, 0], v[:, :, 0]
    ref = jfa.mqa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                         jnp.asarray(40), block_k=32, interpret=True)
    out = tfa.mqa_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(mask), 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("Hkv,T", [(1, 37), (2, 37), (1, 1)])
def test_merged_decode_attention_plain_matches_jax(Hkv, T):
    import jax.numpy as jnp

    from starvector_tpu.models import decode_common as jdc

    rng = np.random.default_rng(3)
    B, G, D = 2, 4, 32
    qg = _rand(rng, (B, Hkv, G, D))
    kn, vn = _rand(rng, (B, Hkv, D)), _rand(rng, (B, Hkv, D))
    k, v = _rand(rng, (B, T, Hkv, D)), _rand(rng, (B, T, Hkv, D))
    old = np.ones((B, T), np.int32)
    old[1, : T // 3] = 0
    scale = D**-0.5
    ref = jdc.merged_decode_attention(*(jnp.asarray(a) for a in (qg, kn, vn, k, v, old)), scale)
    out = tfa.merged_decode_attention(*(torch.from_numpy(a) for a in (qg, kn, vn, k, v, old)),
                                      scale)
    assert out.shape == (B, 1, Hkv * G * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("idx,window", [(90, 32), (60, 200), (33, 8), (100, 100)])
def test_windowed_g9_decode_plain_matches_jax(jfa, idx, window):
    """The StarVector-8B decode step's attention at G = 9 (36 query heads
    over 4 KV heads): the port passes the sliding window as t_begin =
    max(idx - window + 1, 0) over the idx cached slots; JAX folds it into
    old_mask (`slot > idx - window`, starcoder2._decode_step) for XLA's
    merged_decode_attention, and gives the Pallas gqa_decode_batched the
    window start (interpret mode, no self token)."""
    import jax.numpy as jnp

    from starvector_tpu.models import decode_common as jdc

    rng = np.random.default_rng(idx + window)
    B, Hkv, G, D, T = 2, 2, 9, 32, 100
    qg = _rand(rng, (B, Hkv, G, D))
    kn, vn = _rand(rng, (B, Hkv, D)), _rand(rng, (B, Hkv, D))
    k, v = _rand(rng, (B, T, Hkv, D)), _rand(rng, (B, T, Hkv, D))
    mask = np.ones((B, T), np.int32)
    mask[0, :5] = 0
    mask[1, idx - 3] = 0
    t_begin = max(idx - window + 1, 0)
    slot = np.arange(T)[None, :]
    old = (mask > 0) & (slot < idx) & (slot > idx - window)
    scale = D**-0.5
    ref = jdc.merged_decode_attention(*(jnp.asarray(a) for a in (qg, kn, vn, k, v)),
                                      jnp.asarray(old.astype(np.int32)), scale)
    t = {n: torch.from_numpy(a) for n, a in dict(qg=qg, kn=kn, vn=vn, k=k, v=v, m=mask).items()}
    out = tfa.merged_decode_attention(t["qg"], t["kn"], t["vn"], t["k"][:, :idx],
                                      t["v"][:, :idx], t["m"][:, :idx], scale, t_begin=t_begin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    q = qg.reshape(B, Hkv * G, D)
    ref = jfa.gqa_decode_batched(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(mask), jnp.asarray(idx), t_begin, block_k=32,
                                 interpret=True)
    out = tfa.gqa_decode_batched(torch.from_numpy(q), t["k"], t["v"], t["m"], idx, t_begin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("G", [9, 16])
def test_decode_partials_are_whole_float4s(G):
    """Kernel 2's workspace holds one partial of acc[G][D], m[G], l[G] a
    split, padded so that every partial starts on a 16-byte boundary (its
    float4 loads): at G = 9, 1170 floats become 1172."""
    n = tfa.decode_partial_floats(G, 128)
    assert n % 4 == 0 and G * 128 + 2 * G <= n < G * 128 + 2 * G + 4
    assert tfa.decode_partial_floats(9, 128) == 1172 and tfa.decode_partial_floats(16, 128) == 2080


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("T", [1, 31, 325, 1285, 4100, 8450])
def test_decode_splits_tile_the_keys_once(B, T):
    """The split-KV plan: chunks of a multiple of the 128-key tile, up to
    256 keys, tile [t_begin, t_end) exactly once (the first chunk starts at
    the tile holding t_begin, the last is not empty), and the grid stays
    within one resident block an SM (unless a chunk is already the largest)
    while it fills at least half the SMs where there are keys enough."""
    sms = 132
    for t_begin in (0, T // 3 + 5):
        t_begin = min(t_begin, T - 1)
        t_lo = t_begin - t_begin % tfa.DECODE_KEY_TILE
        span = T - t_lo
        splits, chunk = tfa.decode_splits(B, 1, span, sms)
        assert chunk % tfa.DECODE_KEY_TILE == 0 and tfa.DECODE_KEY_TILE <= chunk <= 256
        starts = [t_lo + s * chunk for s in range(splits)]
        assert starts[0] <= t_begin and starts[-1] < T <= starts[-1] + chunk
        covered = np.zeros(T, np.int32)
        for s0 in starts:
            covered[max(s0, t_begin):min(s0 + chunk, T)] += 1
        assert (covered[t_begin:] == 1).all()
        tiles = -(-span // tfa.DECODE_KEY_TILE)
        blocks = B * splits
        assert blocks <= tfa.DECODE_BLOCKS_PER_SM * sms or chunk == 256 or splits == 1
        assert 2 * blocks > min(sms, B * tiles)


# decode_attention's kernel against its plain version. fp32 queries: 1e-4
# (fp32 sums in another order). bf16 queries, over a bf16 or an int8 cache:
# rtol 2^-7 for the output's own rounding (the two round fp32 values that
# may straddle a bf16 rounding edge: a step of the output apart), atol 2e-3
# for p rounded to bf16 against another max (the kernel's: each warp's
# running max over its 16 keys of a tile; the plain version's: the global
# max). At T >= 1285 the outputs are ~0.02-0.04, so 2e-2 would pass a kernel
# that dropped the self token; the test below shows this limit admits the
# rounding and refuses a dropped self token or 128-key split.
DECODE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: dict(rtol=2**-7, atol=2e-3)}


def _decode_p_rounded_by_groups(qg, kn, vn, k, v, ks, vs, mask, group=16):
    """The plain decode (Hkv = 1, bf16 queries, the self token) with p
    rounded to bf16 against the max of each group of `group` keys, as the
    kernel's warps round it, the groups and the self token merged in fp32."""
    import torch.nn.functional as F

    T, D, pad = mask.shape[1], qg.shape[-1], -mask.shape[1] % group
    q = qg[:, 0].float()
    s = torch.einsum("bgd,btd->bgt", q, k[:, :, 0].float()) * D**-0.5
    if ks is not None:
        s = s * ks[:, None, :, 0]
    s = torch.where(mask[:, None] > 0, s, -torch.inf)
    s = F.pad(s, (0, pad), value=-torch.inf).unflatten(-1, (-1, group))
    m = s.amax(-1).clamp_min(-1e30)
    p = torch.exp(s - m[..., None])
    w = p if vs is None else p * F.pad(vs[:, :, 0], (0, pad)).unflatten(-1, (-1, group))[:, None]
    vg = F.pad(v[:, :, 0].float(), (0, 0, 0, pad)).unflatten(1, (-1, group))
    acc = torch.einsum("bgnt,bntd->bgnd", w.bfloat16().float(), vg)
    s_self = (q * kn[:, 0, None].float()).sum(-1) * D**-0.5
    top = torch.maximum(m.amax(-1), s_self)
    c, c_self = torch.exp(m - top[..., None]), torch.exp(s_self - top)
    den = (p.sum(-1) * c).sum(-1) + c_self
    out = (acc * c[..., None]).sum(2) + c_self[..., None] * vn[:, 0, None].float()
    return (out / den[..., None]).bfloat16()[:, None]


@pytest.mark.parametrize("cache", ["bf16", "int8 cache, bf16 q"])
@pytest.mark.parametrize("B,T", [(1, 1285), (8, 1285), (1, 4100), (8, 4100)])
def test_decode_tolerance_tells_a_dropped_token_or_split(cache, B, T):
    """DECODE_TOL in bf16, with the plain version on the CPU: p rounded
    against each 16-key group's max stays within it; the same call without
    the self token, or with one 128-key split of every row masked, does not."""
    qg, kn, vn, k, v, ks, vs, mask = _decode_inputs("cpu", B, T, cache, B * 10007 + T)
    kw = dict(k_scale=ks, v_scale=vs)
    ref = tfa.decode_attention(qg, k, v, mask, k_new=kn, v_new=vn, **kw).float()
    tol = DECODE_TOL[torch.bfloat16]

    def within(out):
        return bool(((out.float() - ref).abs() <= tol["atol"] + tol["rtol"] * ref.abs()).all())

    assert within(_decode_p_rounded_by_groups(qg, kn, vn, k, v, ks, vs, mask))
    assert not within(tfa.decode_attention(qg, k, v, mask, **kw))
    split = mask.clone()
    lo = tfa.DECODE_KEY_TILE * (3 * T // 5 // tfa.DECODE_KEY_TILE)
    split[:, lo:lo + tfa.DECODE_KEY_TILE] = 0
    assert not within(tfa.decode_attention(qg, k, v, split, k_new=kn, v_new=vn, **kw))


def test_decode_scratch_is_reused_and_grows():
    """The decode kernel's tickets and partials workspace are cached per
    device: a launch that fits takes the same buffers (no allocation per
    call), a larger one grows only what it outgrows, and tickets start at 0."""
    dev = torch.device("cpu")
    saved = tfa._DECODE_SCRATCH.pop(dev, None)
    try:
        t1, w1 = tfa._decode_scratch(dev, 4, 1000)
        assert t1.dtype == torch.int32 and w1.dtype == torch.float32 and (t1 == 0).all()
        t2, w2 = tfa._decode_scratch(dev, 8, 500)
        assert t2 is t1 and w2 is w1
        t3, w3 = tfa._decode_scratch(dev, 4, 5000)
        assert t3 is t1 and w3 is not w1 and w3.numel() >= 5000
        t4, w4 = tfa._decode_scratch(dev, 5000, 10)
        assert w4 is w3 and t4.numel() >= 5000 and (t4 == 0).all()
    finally:
        tfa._DECODE_SCRATCH.pop(dev, None)
        if saved is not None:
            tfa._DECODE_SCRATCH[dev] = saved


def _p_rounding_case():
    """Two visible keys: a with score 0 (p = 1) and v = 0; b with score s < 0
    whose p = exp(s) lies 0.3-0.45 of a bf16 step above a bf16 number lo,
    and v = c in column 0. Returns (x, c, want, unrounded): q[:, 0] = x and
    k_b[0] = -1 give s = fp32(-x * scale); want = bf16(c lo / (1 + p)), what
    JAX and the plain version compute (P rounded to bf16 before P V);
    unrounded = bf16(c p / (1 + p)), what an fp32 P would give. Each is
    at least a tenth of a bf16 step from a rounding edge."""
    scale = np.float32(128**-0.5)

    def bf16(a):
        return torch.tensor(np.float32(a)).bfloat16().double().item()

    def edge_distance(u):  # of u from the nearest bf16 rounding edge, in bf16 steps
        lo = torch.tensor(np.float32(u)).bfloat16()
        step = float(abs(np.spacing(np.float32(lo.float().item())))) * 2**16
        frac = (u - lo.double().item()) / step
        return abs(0.5 - abs(frac))

    for xi in range(200):
        x = bf16(0.3 + 0.01 * xi)
        s = float(np.float32(np.float32(-x) * scale))
        p = float(np.exp(np.float64(s)))
        lo = float(torch.tensor(p).float().bfloat16().double())
        step = float(np.spacing(np.float32(lo))) * 2**16
        if not 0.3 <= (p - lo) / step <= 0.45:
            continue
        best = None
        for ci in range(2000):
            c = bf16(1.0 + ci / 512)
            u1, u2 = c * lo / (1 + p), c * p / (1 + p)
            if bf16(u1) == bf16(u2):
                continue
            margin = min(edge_distance(u1), edge_distance(u2))
            if best is None or margin > best[0]:
                best = (margin, c, bf16(u1), bf16(u2))
        if best is not None and best[0] >= 0.1:
            return x, best[1], best[2], best[3]
    raise AssertionError("no P-rounding case found")


def _p_rounding_inputs(device, T=325):
    """qg (1, 1, 16, 128), cache k, v (1, T, 1, 128) bf16 with keys 0 (a)
    and 1 (b) visible, the rest masked (at T = 325 whole splits of the grid
    see no key); (inputs, want, unrounded)."""
    x, c, want, unrounded = _p_rounding_case()
    qg = torch.zeros((1, 1, 16, 128), dtype=torch.bfloat16, device=device)
    qg[..., 0] = x
    k = torch.zeros((1, T, 1, 128), dtype=torch.bfloat16, device=device)
    v = torch.zeros_like(k)
    k[0, 1, 0, 0] = -1.0
    v[0, 1, 0, 0] = c
    mask = torch.zeros((1, T), dtype=torch.int32, device=device)
    mask[0, :2] = 1
    return (qg, k, v, mask), want, unrounded


def _int8_p_rounding_case():
    """Over an int8 cache the P V operand is p times v_scale, rounded to bf16
    once (JAX: `(p_c * v_scale).astype(dt)`, decode_common.py:222-227). Key
    a: score 0 (p = 1), v = 0; key b: k code -1 with k_scale 1, so
    s = fp32(-x * scale), and v code 1 with v_scale c. Returns (x, c, want,
    others): want = bf16(bf16(c p) / (1 + p)); others = (bf16(c bf16(p) /
    (1 + p)), v_scale applied after the rounding, and bf16(c p / (1 + p)),
    an fp32 P), both unlike want. Each is at least a tenth of a bf16 step
    from a rounding edge."""
    scale = np.float32(128**-0.5)

    def bf16(a):
        return torch.tensor(np.float32(a)).bfloat16().double().item()

    def edge_distance(u):  # of u from the nearest bf16 rounding edge, in bf16 steps
        lo = torch.tensor(np.float32(u)).bfloat16()
        step = float(abs(np.spacing(np.float32(lo.float().item())))) * 2**16
        return abs(0.5 - abs((u - lo.double().item()) / step))

    for xi in range(200):
        x = bf16(0.3 + 0.01 * xi)
        p = float(np.exp(np.float32(np.float32(-x) * scale)))
        if edge_distance(p) < 0.1:
            continue
        for ci in range(4000):
            c = float(np.float32(1.0 + ci / 3001))
            cp = float(np.float32(c) * np.float32(p))
            u = bf16(cp) / (1 + p)
            others = (c * bf16(p) / (1 + p), cp / (1 + p))
            if edge_distance(cp) < 0.1 or min(edge_distance(w) for w in (u, *others)) < 0.1:
                continue
            if all(bf16(w) != bf16(u) for w in others):
                return x, c, bf16(u), tuple(bf16(w) for w in others)
    raise AssertionError("no int8 P-rounding case found")


def _int8_p_rounding_inputs(device, G=9, Hkv=4, T=325):
    """qg (1, Hkv, G, 128) bf16, an int8 cache (1, T, Hkv, 128) with scales,
    keys 0 and 1 visible and the rest masked (at T = 325 whole splits see
    no key); (inputs, want, others) of _int8_p_rounding_case."""
    x, c, want, others = _int8_p_rounding_case()
    qg = torch.zeros((1, Hkv, G, 128), dtype=torch.bfloat16, device=device)
    qg[..., 0] = x
    k = torch.zeros((1, T, Hkv, 128), dtype=torch.int8, device=device)
    v = torch.zeros_like(k)
    k[0, 1, :, 0] = -1
    v[0, 1, :, 0] = 1
    ks = torch.ones((1, T, Hkv), device=device)
    vs = torch.ones_like(ks)
    vs[0, 1] = c
    mask = torch.zeros((1, T), dtype=torch.int32, device=device)
    mask[0, :2] = 1
    return (qg, k, v, mask, ks, vs), want, others


def test_int8_decode_rounds_p_times_v_scale_to_bf16(jfa):
    """The int8 P-rounding contract on the CPU at the 8B's G = 9: the port's
    plain version and XLA's merged_decode_attention (key a as the self
    token) give bf16(bf16(c p) / (1 + p)), neither of the other orderings."""
    import jax.numpy as jnp

    from starvector_tpu.models import decode_common as jdc

    (qg, k, v, mask, ks, vs), want, others = _int8_p_rounding_inputs("cpu")
    assert want not in others
    out = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs)
    assert (out[..., 0].double() == want).all() and (out[..., 1:] == 0).all()
    zero = jnp.zeros((1, 4, 128), jnp.bfloat16)
    old = (mask.numpy() * np.arange(k.shape[1]) == 1).astype(np.int32)
    ref = jdc.merged_decode_attention(
        jnp.asarray(qg.float().numpy()).astype(jnp.bfloat16), zero, zero, jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(old), 128**-0.5, k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy()))
    assert (np.asarray(ref.astype(jnp.float32)).reshape(36, 128)[:, 0] == want).all()


def test_decode_rounds_p_to_bf16_before_pv(jfa):
    """The P-rounding contract on the CPU: the port's plain version and both
    JAX functions (the Pallas decode kernel in interpret mode, and XLA's
    merged_decode_attention with key a as the self token) give
    bf16(c bf16(p) / (1 + p)), not the fp32-P value."""
    import jax.numpy as jnp

    from starvector_tpu.models import decode_common as jdc

    (qg, k, v, mask), want, unrounded = _p_rounding_inputs("cpu")
    assert want != unrounded
    out = tfa.decode_attention(qg, k, v, mask)
    assert (out[..., 0].double() == want).all() and (out[..., 1:] == 0).all()
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    ref = jfa.gqa_decode_batched(to_j(qg.reshape(1, 16, 128)), to_j(k), to_j(v),
                                 jnp.asarray(mask.numpy()), jnp.asarray(k.shape[1]), 0,
                                 block_k=32, interpret=True)
    assert (np.asarray(ref.astype(jnp.float32))[..., 0] == want).all()
    # XLA's merged attention: key a is the self token (k_new = v_new = 0)
    zero = jnp.zeros((1, 1, 128), jnp.bfloat16)
    ref = jdc.merged_decode_attention(to_j(qg), zero, zero, to_j(k), to_j(v),
                                      jnp.asarray((mask.numpy() * np.arange(k.shape[1]) == 1)
                                                  .astype(np.int32)), 128**-0.5)
    assert (np.asarray(ref.astype(jnp.float32)).reshape(16, 128)[:, 0] == want).all()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the wrappers run their plain versions and launch nothing;
    a device with no kernel raises instead of falling back."""
    calls = []
    for name in ("flash_prefill_plain", "decode_attention_plain"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    before = (tfa.flash_prefill.launches, tfa.decode_attention.launches)
    q, k, v, mask, *_ = _prefill_case("mqa")
    tfa.flash_prefill(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    q, k, v, mask = _decode_case(4)
    tfa.gqa_decode_batched(*(torch.from_numpy(a) for a in (q, k, v, mask)), 50)
    assert calls == ["flash_prefill_plain", "decode_attention_plain"]
    assert (tfa.flash_prefill.launches, tfa.decode_attention.launches) == before
    meta = torch.empty((1, 4, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_prefill(meta, meta[:, :, :1], meta[:, :, :1],
                          torch.ones((1, 4), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

GPU_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", PREFILL_CASES)
def test_flash_prefill_kernel_matches_plain(cuda, name, dtype):
    q, k, v, mask, q_offset, window, live = _prefill_case(name, D=128)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda)
    causal = name != "non_causal"
    n = tfa.flash_prefill.launches
    out = tfa.flash_prefill(q, k, v, mask, q_offset, causal=causal, window=window)
    ref = tfa.flash_prefill(q, k, v, mask, q_offset, causal=causal, window=window, kernels=False)
    torch.cuda.synchronize()
    assert tfa.flash_prefill.launches == n + 1
    live = torch.from_numpy(live).to(cuda)
    torch.testing.assert_close(out[live].float(), ref[live].float(), **GPU_TOL[dtype])


@pytest.mark.gpu
def test_bf16_flash_prefill_at_the_1b_prefill_matches_plain(cuda):
    """The 1B prefill: B=4, a 261-token prefix in a cache of 389 slots
    (unwritten tail masked), 16 query heads over one KV head, q a strided
    view of the fused [q | k | v] projection as the decoder passes it."""
    rng = np.random.default_rng(6)
    B, S, T, H, D = 4, 261, 389, 16, 128
    qkv = torch.from_numpy(_rand(rng, (B, S, (H + 2) * D))).to(cuda, torch.bfloat16)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k, v = (torch.from_numpy(_rand(rng, (B, T, 1, D))).to(cuda, torch.bfloat16) for _ in "kv")
    mask = torch.ones((B, T), dtype=torch.int32, device=cuda)
    mask[:, S:] = 0
    out = tfa.flash_prefill(q, k, v, mask)
    ref = tfa.flash_prefill(q, k, v, mask, kernels=False)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **GPU_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(1, 1), (4, 300), (1, 2049)])
def test_decode_attention_kernel_matches_plain(cuda, B, T, dtype):
    rng = np.random.default_rng(5)
    G, D = 16, 128
    qg = torch.from_numpy(_rand(rng, (B, 1, G, D))).to(cuda, dtype)
    kn, vn = (torch.from_numpy(_rand(rng, (B, 1, D))).to(cuda, dtype) for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, (B, T, 1, D))).to(cuda, dtype) for _ in range(2))
    mask = torch.ones((B, T), dtype=torch.int32, device=cuda)
    mask[0, : T // 4] = 0
    out = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5)
    ref = tfa.merged_decode_attention(qg, kn, vn, k, v, mask, D**-0.5, kernels=False)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL[dtype])
    q = qg.reshape(B, G, D)
    out = tfa.gqa_decode_batched(q, k, v, mask, max(T - 3, 1), min(T // 8, T - 1))
    ref = tfa.gqa_decode_batched(q, k, v, mask, max(T - 3, 1), min(T // 8, T - 1), kernels=False)
    live = (mask[:, min(T // 8, T - 1): max(T - 3, 1)] > 0).any(dim=1)
    torch.testing.assert_close(out[live].float(), ref[live].float(), **DECODE_TOL[dtype])


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    """Each kernel is built for StarVector-1B's shapes only: head size 128,
    and 16 query heads per KV head in decode."""
    q = torch.zeros((1, 8, 4, 128), device=cuda)
    k = torch.zeros((1, 8, 1, 128), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_prefill(q, k, k, mask.float())
    with pytest.raises(TypeError):
        tfa.flash_prefill(q.half(), k.half(), k.half(), mask)
    with pytest.raises(ValueError, match="D = 128"):
        tfa.flash_prefill(q[..., :64], k[..., :64], k[..., :64], mask)
    qg = torch.zeros((1, 1, 16, 128), device=cuda)
    with pytest.raises(ValueError, match="G=3"):
        tfa.decode_attention(qg[:, :, :3], k, k, mask)
    odd = torch.zeros((1, 8 * 129 + 1), device=cuda)[:, 1:].view(1, 8, 1, 129)[..., :128]
    with pytest.raises(ValueError, match="aligned"):
        tfa.decode_attention(qg, odd, odd, mask)


@pytest.mark.gpu
def test_bf16_decode_rounds_p_to_bf16_before_pv(cuda):
    """Two visible keys in one split, the rest masked (whole splits see no
    key): the bf16 kernel gives bf16(c bf16(p) / (1 + p)) exactly, as JAX and
    the plain version do; an fp32 P gives another bf16 number."""
    (qg, k, v, mask), want, unrounded = _p_rounding_inputs(cuda)
    out = tfa.decode_attention(qg, k, v, mask)
    ref = tfa.decode_attention(qg, k, v, mask, kernels=False)
    torch.cuda.synchronize()
    assert want != unrounded
    assert (ref[..., 0].double() == want).all()
    assert (out[..., 0].double() == want).all(), (out[..., 0], want, unrounded)
    assert (out[..., 1:] == 0).all()


DECODE_CACHES = ["fp32", "bf16", "int8 cache, bf16 q", "int8 cache, fp32 q"]


def _decode_inputs(device, B, T, cache, seed, G=16, Hkv=1):
    """(qg, k_new, v_new, k, v, k_scale, v_scale, mask) for a cache kind:
    random values, row 0 left-padded, and (T > 256) a masked run of keys
    that empties a whole 128-key chunk of the last row."""
    from starvector_tpu_torch.models import decode_common as tdc

    rng = np.random.default_rng(seed)
    D = 128
    dtype = torch.bfloat16 if "bf16" in cache else torch.float32
    qg = torch.from_numpy(_rand(rng, (B, Hkv, G, D))).to(device, dtype)
    kn, vn = (torch.from_numpy(_rand(rng, (B, Hkv, D))).to(device, dtype) for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, (B, T, Hkv, D))).to(device) for _ in range(2))
    ks = vs = None
    if cache.startswith("int8"):
        (k, ks), (v, vs) = tdc.quantize_kv(k), tdc.quantize_kv(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    mask = torch.ones((B, T), dtype=torch.int32, device=device)
    mask[0, : T // 5] = 0
    if T > 256:
        mask[-1, 100:300] = 0
    mask[:, T // 2] = 0
    return qg, kn, vn, k, v, ks, vs, mask


@pytest.mark.gpu
@pytest.mark.parametrize("cache", DECODE_CACHES)
@pytest.mark.parametrize("T", [1, 325, 1285, 4100])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_split_decode_matches_plain(cuda, B, T, cache):
    """The split-KV kernel against its plain version: the whole cache with
    the self token, then a window whose edges fall inside chunks without it.
    Tolerance DECODE_TOL (its reasons are with it)."""
    qg, kn, vn, k, v, ks, vs, mask = _decode_inputs(cuda, B, T, cache, B * 10007 + T)
    tol = DECODE_TOL[qg.dtype]
    n = tfa.decode_attention.launches
    kw = dict(k_scale=ks, v_scale=vs)
    out = tfa.decode_attention(qg, k, v, mask, k_new=kn, v_new=vn, **kw)
    ref = tfa.decode_attention(qg, k, v, mask, k_new=kn, v_new=vn, kernels=False, **kw)
    torch.cuda.synchronize()
    assert tfa.decode_attention.launches == n + 1
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    lo, hi = (T // 3 + 5, T - 7) if T > 64 else (0, T)
    out = tfa.decode_attention(qg, k, v, mask, t_begin=lo, t_end=hi, **kw)
    ref = tfa.decode_attention(qg, k, v, mask, t_begin=lo, t_end=hi, kernels=False, **kw)
    torch.cuda.synchronize()
    live = (mask[:, lo:hi] > 0).any(dim=1)
    torch.testing.assert_close(out[live].float(), ref[live].float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("cache", ["bf16", "int8 cache, bf16 q"])
def test_split_decode_any_chunk_matches_plain(cuda, monkeypatch, chunk, cache):
    """Both chunks decode_splits can choose give the plain result (B=8 at
    the planned 1k-token cell's end, T=1285, where this card's plan takes
    128 keys a block): the SM count it plans for is set so that it takes
    `chunk`. Tolerance DECODE_TOL."""
    sms = {128: 10**6, 256: 1}[chunk]
    assert tfa.decode_splits(8, 1, 1285, sms)[1] == chunk
    monkeypatch.setattr(tfa, "_sm_count", lambda device: sms)
    qg, kn, vn, k, v, ks, vs, mask = _decode_inputs(cuda, 8, 1285, cache, chunk)
    kw = dict(k_new=kn, v_new=vn, k_scale=ks, v_scale=vs)
    out = tfa.decode_attention(qg, k, v, mask, **kw)
    ref = tfa.decode_attention(qg, k, v, mask, kernels=False, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("cache", DECODE_CACHES)
def test_split_decode_two_launches_are_bit_identical(cuda, cache):
    """The partials are merged in split order by whichever block finishes
    last: no atomics in the sums, so two launches give the same bits."""
    qg, kn, vn, k, v, ks, vs, mask = _decode_inputs(cuda, 8, 1285, cache, 17)
    kw = dict(k_new=kn, v_new=vn, k_scale=ks, v_scale=vs)
    a = tfa.decode_attention(qg, k, v, mask, **kw)
    b = tfa.decode_attention(qg, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# StarVector-8B: 36 query heads over 4 KV heads (G = 9), a 4096-key window
G9_CASES = [  # B, T, t_begin (the decode step's window start), ragged mask
    (4, 708, 0, False), (1, 8192, 4097, False), (4, 708, 0, True), (2, 5000, 905, True),
    (1, 1, 0, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,t_begin,ragged", G9_CASES)
def test_g9_decode_matches_plain(cuda, B, T, t_begin, ragged, dtype):
    """Kernel 2 at G = 9, Hkv = 4 (query rows 9-15 of the tensor-core
    product are zero padding) against its plain version, with the self token
    and the window's first slot, to DECODE_TOL."""
    cache = "bf16" if dtype == torch.bfloat16 else "fp32"
    qg, kn, vn, k, v, _, _, mask = _decode_inputs(cuda, B, T, cache, B * 7 + T, G=9, Hkv=4)
    if not ragged:
        mask.fill_(1)
    n = tfa.decode_attention.launches
    out = tfa.decode_attention(qg, k, v, mask, k_new=kn, v_new=vn, t_begin=t_begin)
    ref = tfa.decode_attention(qg, k, v, mask, k_new=kn, v_new=vn, t_begin=t_begin,
                               kernels=False)
    torch.cuda.synchronize()
    assert tfa.decode_attention.launches == n + 1 and out.shape == (B, 4, 9, 128)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL[dtype])
    again = tfa.decode_attention(qg, k, v, mask, k_new=kn, v_new=vn, t_begin=t_begin)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["bf16", "fp32"])
@pytest.mark.parametrize("B,T,t_begin,ragged", G9_CASES)
def test_g9_decode_over_an_int8_cache_matches_plain(cuda, B, T, t_begin, ragged, q):
    """Kernel 2's int8 instantiation at G = 9, Hkv = 4 (the 8B's int8 KV
    cache) against its plain version, with the self token and the window's
    first slot, to DECODE_TOL; two launches give the same bits. With one
    cached key (T = 1) the bf16 kernel rounds p v_scale against that key's
    own score, the plain version against the larger of it and the self
    score: a bf16 step of the cached term, on outputs of order 1 that can
    cancel to near 0, which DECODE_TOL does not admit there (it is set for
    the hundreds of keys of a real step); that case is held to the plain
    version with p rounded against each 16-key group's max, as the kernel's
    warps round it (_decode_p_rounded_by_groups, a KV head at a time)."""
    qg, kn, vn, k, v, ks, vs, mask = _decode_inputs(cuda, B, T, f"int8 cache, {q} q", B * 5 + T,
                                                    G=9, Hkv=4)
    if not ragged:
        mask.fill_(1)
    kw = dict(k_new=kn, v_new=vn, k_scale=ks, v_scale=vs, t_begin=t_begin)
    n = tfa.decode_attention.int8_launches
    out = tfa.decode_attention(qg, k, v, mask, **kw)
    if T == 1 and q == "bf16":
        ref = torch.cat([_decode_p_rounded_by_groups(
            qg[:, h:h + 1], kn[:, h:h + 1], vn[:, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1],
            ks[..., h:h + 1], vs[..., h:h + 1], mask) for h in range(4)], dim=1)
    else:
        ref = tfa.decode_attention(qg, k, v, mask, kernels=False, **kw)
    torch.cuda.synchronize()
    assert tfa.decode_attention.int8_launches == n + 1 and out.shape == (B, 4, 9, 128)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL[qg.dtype])
    again = tfa.decode_attention(qg, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize("G,Hkv", [(9, 4), (16, 1)])
def test_int8_decode_kernel_rounds_p_times_v_scale(cuda, G, Hkv):
    """The bf16 kernel over an int8 cache gives bf16(bf16(c p) / (1 + p))
    exactly, as JAX and the plain version do (v_scale folded into P before
    the rounding)."""
    (qg, k, v, mask, ks, vs), want, others = _int8_p_rounding_inputs(cuda, G, Hkv)
    out = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs)
    ref = tfa.decode_attention(qg, k, v, mask, k_scale=ks, v_scale=vs, kernels=False)
    torch.cuda.synchronize()
    assert (ref[..., 0].double() == want).all()
    assert (out[..., 0].double() == want).all(), (out[..., 0], want, others)
    assert (out[..., 1:] == 0).all()


G36_CASES = [  # B, S, T, q_offset, window: the 8B prefill, and a prefix past the window
    (4, 580, 580, 0, 4096), (1, 1024, 8192, 7168, 4096), (2, 300, 500, 100, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,q_offset,window", G36_CASES)
def test_flash_prefill_at_the_8b_heads_matches_plain(cuda, B, S, T, q_offset, window, dtype):
    """Kernel 1 at StarVector-8B's 36 query heads over 4 KV heads with the
    sliding window, against its plain version (GPU_TOL); two bf16 launches
    give the same bits."""
    rng = np.random.default_rng(S + T)
    H, Hkv, D = 36, 4, 128
    q = torch.from_numpy(_rand(rng, (B, S, H, D))).to(cuda, dtype)
    k, v = (torch.from_numpy(_rand(rng, (B, T, Hkv, D))).to(cuda, dtype) for _ in "kv")
    mask = torch.ones((B, T), dtype=torch.int32, device=cuda)
    mask[:, q_offset + S:] = 0
    out = tfa.flash_prefill(q, k, v, mask, q_offset, window=window)
    ref = tfa.flash_prefill(q, k, v, mask, q_offset, window=window, kernels=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **GPU_TOL[dtype])
    if dtype == torch.bfloat16:
        again = tfa.flash_prefill(q, k, v, mask, q_offset, window=window)
        torch.cuda.synchronize()
        assert torch.equal(again, out)
