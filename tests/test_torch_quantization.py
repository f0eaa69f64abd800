"""Port parity: int8 weight-only quantization (starvector_tpu_torch.ops.
quantization) against starvector_tpu.ops.quantization on the same numpy
inputs.

Codes and scales must equal the JAX package's bit for bit. The plain
int8 matmul is held against the Pallas quant_matmul in interpret mode (fp32
at 1e-5; bf16 x at 1e-2: both sides take the same bf16 values, the sums run
in another order). The quantized dense layer is held against the JAX
default path (`use_pallas=False`), which rounds q * scale to the compute
dtype before the product: fp32 at 1e-5, bf16 within 2e-2 of max |y|.

Tests marked `gpu` hold kernel 14 against its plain version at the 1B
shapes and skip without a card; they import no JAX, so on the card they run
as
    python -m pytest --noconftest -m gpu tests/test_torch_quantization.py
"""

import numpy as np
import pytest
import torch

from starvector_tpu_torch.models import convert
from starvector_tpu_torch.ops import layers as tlayers
from starvector_tpu_torch.ops import quantization as tq

# the 1B decoder's four projections, (K, N)
SHAPES_1B = {"attn.c_attn": (2048, 2304), "attn.c_proj": (2048, 2048),
             "mlp.c_fc": (2048, 8192), "mlp.c_proj": (8192, 2048)}


@pytest.fixture(scope="module")
def jq():
    return pytest.importorskip("starvector_tpu.ops.quantization")


def _weights(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    # a column whose codes land on exact halves: max 127 gives scale 1, so
    # 0.5, 1.5, 2.5, -2.5 round half to even
    w[..., :4, 0] = [127.0, 0.5, 1.5, -2.5]
    return w


@pytest.mark.parametrize("shape", [(300, 200), (3, 130, 96)], ids=["2d", "stacked"])
def test_codes_and_scales_equal_jax(jq, shape):
    import jax.numpy as jnp

    w = _weights(shape, 0)
    # through quantize_tree: the JAX package takes a stacked leaf there (its
    # quantize_dense is for 2-D kernels)
    ref = jq.quantize_tree({"p": {"kernel": jnp.asarray(w), "bias": jnp.zeros(shape[-1])}},
                           min_elems=1, consume=False)["p"]
    out = tq.quantize_tree({"p": {"kernel": torch.from_numpy(w), "bias": torch.zeros(shape[-1])}},
                           min_elems=1)["p"]
    assert out["kernel_q"].dtype == torch.int8 and out["scale"].dtype == torch.float32
    assert tuple(out["scale"].shape) == shape[:-2] + shape[-1:]
    np.testing.assert_array_equal(out["kernel_q"].numpy(), np.asarray(ref["kernel_q"]))
    np.testing.assert_array_equal(out["scale"].numpy(), np.asarray(ref["scale"]))
    assert out["kernel_q"][..., 1:4, 0].tolist() == ([0, 2, -2] if len(shape) == 2
                                                     else [[0, 2, -2]] * shape[0])
    assert "bias" in out


def test_quantize_tree_targets_the_jax_leaves(jq):
    import jax

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu_torch.ops.quantization import quantize_tree

    cfg = jgbc.tiny_config(hidden_size=256, n_head=4)
    jtree = jax.tree_util.tree_map(np.asarray, jgbc.init_params(cfg, jax.random.PRNGKey(0)))
    ref = jax.tree_util.tree_map(np.asarray, jq.quantize_tree(jtree, min_elems=1 << 12,
                                                              consume=False))
    src = convert.from_jax_params(jtree)
    kept = quantize_tree(src, min_elems=1 << 12, consume=False)
    assert "kernel" in src["layers"]["mlp"]["c_fc"]  # consume=False leaves the input intact

    def leaves(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    got, want = leaves(kept), leaves(ref)
    assert sorted(got) == sorted(want)
    quantized = sorted(k for k in want if k.endswith("kernel_q"))
    assert quantized == ["layers/attn/c_attn/kernel_q", "layers/attn/c_proj/kernel_q",
                         "layers/mlp/c_fc/kernel_q", "layers/mlp/c_proj/kernel_q"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["wte"].dtype == torch.float32 and "scale" in kept["ln_f"]

    consumed = quantize_tree(src, min_elems=1 << 12)  # the default drops the source weights
    assert all("kernel" not in grp[name] for grp in (src["layers"]["attn"], src["layers"]["mlp"])
               for name in grp)
    for k in quantized:
        np.testing.assert_array_equal(leaves(consumed)[k].numpy(), want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_plain_matches_pallas(jq, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    M, K, N = 5, 300, 200  # ragged against the Pallas blocks
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = _weights((K, N), 2)
    p = tq.quantize_dense({"kernel": torch.from_numpy(w)})
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = jq.quant_matmul(xj, jnp.asarray(p["kernel_q"].numpy()), jnp.asarray(p["scale"].numpy()),
                          block_n=128, block_k=128, interpret=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = tq.quant_matmul_plain(xt, p["kernel_q"], p["scale"])
    assert out.dtype == torch.float32 and out.shape == (M, N)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    # the wrapper takes the plain version for a CPU tensor, launching nothing
    launches = tq.quant_matmul.launches
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    y = tq.quant_matmul(xt, p["kernel_q"], p["scale"], bias, out_dtype=xt.dtype)
    torch.testing.assert_close(y, (out + bias).to(xt.dtype), rtol=0, atol=0)
    assert tq.quant_matmul.launches == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_quantized_matches_jax_default(jq, dtype):
    import jax.numpy as jnp

    from starvector_tpu.ops import layers as jlayers
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy

    rng = np.random.default_rng(3)
    K, N = 256, 384
    x = rng.standard_normal((2, 7, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    jp = jq.quantize_dense({"kernel": jnp.asarray(_weights((K, N), 4)), "bias": jnp.asarray(b)})
    ref = jlayers.dense(jp, jnp.asarray(x), JPolicy(compute_dtype=getattr(jnp, dtype)))
    tp = convert.from_jax_params({k: np.asarray(v) for k, v in jp.items()})
    out = tlayers.dense(tp, torch.from_numpy(x),
                        tlayers.DTypePolicy(compute_dtype=getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 7, N)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_from_jax_params_keeps_int8_codes_and_fp32_scales(jq):
    import jax.numpy as jnp

    w = _weights((64, 48), 5)
    tree = {"q": jq.quantize_dense({"kernel": jnp.asarray(w), "bias": jnp.ones(48)}),
            "ln": {"scale": jnp.full((64,), 1 - 1e-5), "bias": jnp.zeros(64)}}
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}
    out = convert.from_jax_params(tree, dtype=torch.bfloat16)
    assert out["q"]["kernel_q"].dtype == torch.int8
    assert out["q"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(out["q"]["scale"].numpy(), tree["q"]["scale"])
    assert out["q"]["bias"].dtype == torch.bfloat16
    assert out["ln"]["scale"].dtype == torch.bfloat16  # a LayerNorm's scale is cast


# ---------------------------------------------------------------------------
# on the card: kernel 14 against its plain version at the 1B shapes
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 1040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_quant_matmul_kernel_matches_plain(cuda, M, dtype):
    """Tolerance: fp32 atol = rtol = 1e-4 (the sums run in another order);
    bf16 out 2e-2 relative (one output rounding)."""
    rng = np.random.default_rng(M)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, (K, N) in SHAPES_1B.items():
        p = tq.quantize_dense({"kernel": torch.from_numpy(_weights((K, N), K + N)).to(cuda)})
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
        bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(cuda)
        for b in (None, bias):
            out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
            ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                       msg=f"{name} M={M} bias={b is not None}")


@pytest.mark.gpu
def test_quant_matmul_refuses_what_it_does_not_take(cuda):
    p = tq.quantize_dense({"kernel": torch.randn(64, 40, device=cuda)})  # N % 16 != 0
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError, match="N % 16"):
        tq.quant_matmul(x, p["kernel_q"], p["scale"])
    p = tq.quantize_dense({"kernel": torch.randn(64, 48, device=cuda)})
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tq.quant_matmul(x.half(), p["kernel_q"], p["scale"])
    with pytest.raises(ValueError, match="scale"):
        tq.quant_matmul(x, p["kernel_q"], p["scale"].bfloat16())
