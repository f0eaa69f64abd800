"""Port parity: starvector_tpu_torch.ops (layers, plain attention, sampling
transforms) against starvector_tpu.ops on the same numpy inputs, in fp32.
Tolerance 1e-5 relative/absolute unless a test says otherwise."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.ops import attention as jattn
from starvector_tpu.ops import layers as jlayers
from starvector_tpu.ops import sampling as jsamp
from starvector_tpu_torch.ops import attention as tattn
from starvector_tpu_torch.ops import layers as tlayers
from starvector_tpu_torch.ops import sampling as tsamp

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import starvector_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 15, mods\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'starvector_tpu']\n"
        "from starvector_tpu_torch.ops import kernel_lib\n"
        "assert kernel_lib._lib is None  # importing builds nothing\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"kernel": rng.standard_normal((16, 24)).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(24).astype(np.float32)
    ref = jlayers.dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                        jlayers.DTypePolicy(compute_dtype=jnp.float32))
    out = tlayers.dense({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                        tlayers.DTypePolicy(compute_dtype=torch.float32))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)



def test_dense_bf16_policy_adds_the_fp32_bias_before_rounding():
    """fp32 parameters under the default bf16 policy: as in JAX, the bf16
    product accumulates in fp32 and the fp32 bias joins that sum before the
    one rounding to bf16. The bias (1 to 2) dwarfs the product (~0.1), so
    rounding it to bf16 first would change most outputs. Tolerance: equal
    but for the few elements whose fp32 sums, taken in another order,
    straddle a bf16 rounding boundary; those differ by one bf16 step."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    p = {"kernel": (rng.standard_normal((64, 96)) * 0.01).astype(np.float32),
         "bias": rng.uniform(1, 2, 96).astype(np.float32)}
    ref = jlayers.dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                        jlayers.DTypePolicy())
    ref = np.asarray(ref.astype(jnp.float32))
    out = tlayers.dense({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                        tlayers.DTypePolicy())
    assert out.dtype == torch.bfloat16
    diff = np.abs(out.float().numpy() - ref)
    assert (diff == 0).mean() >= 0.99
    assert (diff <= np.abs(ref) * 2**-7).all()

def test_layer_norm_fp32_statistics():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 32)) * 4 + 2).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    ref = jlayers.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out = tlayers.layer_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    # bf16 input keeps its dtype, statistics still taken in fp32
    out16 = tlayers.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x).bfloat16())
    assert out16.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["gelu_tanh", "quick_gelu", "swish"])
def test_activations(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    ref = getattr(jlayers, name)(jnp.asarray(x))
    out = getattr(tlayers, name)(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_layer_slice_is_a_view():
    p = {"a": {"kernel": torch.arange(12.0).reshape(3, 4)}, "b": torch.zeros(3, 2)}
    s = tlayers.layer_slice(p, 1)
    assert s["a"]["kernel"].tolist() == [4.0, 5.0, 6.0, 7.0]
    s["b"].fill_(1.0)
    assert p["b"][1].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("q_offset,window,pad", [(0, None, False), (5, None, True), (3, 4, True)])
def test_make_attention_bias(q_offset, window, pad):
    rng = np.random.default_rng(2)
    mask = (rng.random((2, 12)) > 0.3).astype(np.int32) if pad else None
    ref = jattn.make_attention_bias(None if mask is None else jnp.asarray(mask), 6, 12,
                                    q_offset=q_offset, window=window)
    out = tattn.make_attention_bias(None if mask is None else torch.from_numpy(mask), 6, 12,
                                    q_offset=q_offset, window=window)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


@pytest.mark.parametrize("H,Hkv", [(4, 1), (4, 2), (4, 4)])
def test_multihead_attention(H, Hkv):
    rng = np.random.default_rng(3)
    B, S, T, D = 2, 9, 13, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    jb = jattn.make_attention_bias(jnp.asarray(mask), S, T, q_offset=T - S)
    ref = jattn.multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    tb = tattn.make_attention_bias(torch.from_numpy(mask), S, T, q_offset=T - S)
    out = tattn.multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), tb)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)



def test_multihead_attention_bf16_scores_stay_fp32():
    """bf16 q, k, v: the scores leave their fp32 accumulator unrounded, as
    JAX's preferred_element_type=float32 keeps them. Both sides then round
    P to bf16 for the product with V and round the output once, so they
    agree to the bit here; atol 2e-3 leaves room for one flip of a P
    rounding. Scores rounded to bf16 (|s| ~ 10) are off by over 1e-2."""
    rng = np.random.default_rng(8)
    B, S, T, H, D = 2, 9, 13, 4, 64
    q, k, v = (rng.standard_normal((B, n, h, D)).astype(np.float32) * c
               for n, h, c in ((S, H, 3), (T, 1, 1), (T, 1, 1)))
    jb = jattn.make_attention_bias(None, S, T, q_offset=T - S)
    ref = jattn.multihead_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jb)
    tb = tattn.make_attention_bias(None, S, T, q_offset=T - S)
    out = tattn.multihead_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), tb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2e-3)

def _logits(seed=4, B=3, V=50):
    return (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)


@pytest.mark.parametrize("fn,args", [
    ("apply_temperature", (0.7,)),
    ("apply_temperature", (np.array([0.5, 1.0, 2.0], np.float32),)),
    ("apply_top_k", (5, 16)),
    ("apply_top_k", (np.array([0, 3, 7], np.int32), 16)),
    ("apply_top_p", (0.8,)),
    ("apply_top_p", (np.array([0.3, 0.9, 1.0], np.float32),)),
    ("apply_min_p", (0.1,)),
    ("apply_min_p", (np.array([0.0, 0.05, 0.5], np.float32),)),
])
def test_sampling_transforms(fn, args):
    x = _logits()
    ref = getattr(jsamp, fn)(jnp.asarray(x), *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                             for a in args])
    out = getattr(tsamp, fn)(torch.from_numpy(x), *[torch.from_numpy(a) if isinstance(a, np.ndarray)
                                                   else a for a in args])
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_sampling_penalties_and_bias():
    rng = np.random.default_rng(5)
    x = _logits(5)
    presence = (rng.random(x.shape) > 0.7).astype(np.int32)
    counts = rng.integers(0, 3, x.shape).astype(np.int32)
    ids = np.array([[3, -1], [7, 7], [-1, -1]], np.int32)
    vals = np.array([[2.0, 9.0], [1.0, 0.5], [4.0, 4.0]], np.float32)
    j, t = jnp.asarray, torch.from_numpy
    pairs = [
        (jsamp.apply_repetition_penalty(j(x), j(presence), 1.3),
         tsamp.apply_repetition_penalty(t(x), t(presence), 1.3)),
        (jsamp.apply_frequency_presence(j(x), j(counts), 0.4, 0.2),
         tsamp.apply_frequency_presence(t(x), t(counts), 0.4, 0.2)),
        (jsamp.apply_logit_bias(j(x), j(ids), j(vals)),
         tsamp.apply_logit_bias(t(x), t(ids), t(vals))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_sample_token_greedy_matches_and_draws_from_generator():
    x = _logits(6)
    ref = jsamp.sample_token(None, jnp.asarray(x), do_sample=False, temperature=1.0,
                             top_p=1.0, top_k=0)
    out = tsamp.sample_token(torch.from_numpy(x), do_sample=False)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    # temperature 0 falls back to greedy even when sampling
    g = torch.Generator().manual_seed(0)
    out0 = tsamp.sample_token(torch.from_numpy(x), do_sample=True, temperature=0.0, generator=g)
    np.testing.assert_array_equal(_np(out0), np.asarray(ref))
    # top_k=1 leaves one candidate per row: the draw must be the argmax
    out1 = tsamp.sample_token(torch.from_numpy(x), do_sample=True, top_k=1, generator=g)
    np.testing.assert_array_equal(_np(out1), np.asarray(ref))
    # the same seed gives the same draw
    a = tsamp.sample_token(torch.from_numpy(x), do_sample=True,
                           generator=torch.Generator().manual_seed(7))
    b = tsamp.sample_token(torch.from_numpy(x), do_sample=True,
                           generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
