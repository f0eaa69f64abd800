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
    torch.testing.assert_close(out.float(), ref.float(), **GPU_TOL[dtype])
    q = qg.reshape(B, G, D)
    out = tfa.gqa_decode_batched(q, k, v, mask, max(T - 3, 1), min(T // 8, T - 1))
    ref = tfa.gqa_decode_batched(q, k, v, mask, max(T - 3, 1), min(T // 8, T - 1), kernels=False)
    live = (mask[:, min(T // 8, T - 1): max(T - 3, 1)] > 0).any(dim=1)
    torch.testing.assert_close(out[live].float(), ref[live].float(), **GPU_TOL[dtype])


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
    with pytest.raises(ValueError, match="G = 16"):
        tfa.decode_attention(qg[:, :, :4], k, k, mask)
    odd = torch.zeros((1, 8 * 129 + 1), device=cuda)[:, 1:].view(1, 8, 1, 129)[..., :128]
    with pytest.raises(ValueError, match="aligned"):
        tfa.decode_attention(qg, odd, odd, mask)
