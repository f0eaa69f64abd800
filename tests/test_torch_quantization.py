"""Port parity: int8 weight-only quantization (starvector_tpu_torch.ops.
quantization) against starvector_tpu.ops.quantization on the same numpy
inputs.

Codes and scales must equal the JAX package's bit for bit. The plain
int8 matmul is held against the Pallas quant_matmul in interpret mode (fp32
at 1e-5; bf16 x at 1e-2: both sides take the same bf16 values, the sums run
in another order). The quantized dense layer is held against the JAX
default path (`use_pallas=False`), which rounds q * scale to the compute
dtype before the product: fp32 at 1e-5, bf16 within 2e-2 of max |y|.

Tests marked `gpu` hold kernel 14 against its plain version at the 1B and
8B shapes and the wgmma tile's edges, the tensor-core GEMV at every height
and on many plans, and skip without a card; they import no JAX, so on the
card they run as
    python -m pytest --noconftest -m gpu tests/test_torch_quantization.py

Kernel 14's tolerance against its plain version (QMM_TOL): fp32 out atol =
rtol = 1e-4, the fp32 sums taken in another order; bf16 out atol 2e-3 and
rtol 2^-7: the fp32 values differ only by the sum order, which can move a
result across one bf16 rounding boundary, one bf16 step (at most 2^-7
relative), with atol for results near zero. 2e-2 would pass a kernel that
drops or repeats a 16-row slab of q (test_qmm_tolerance_tells_a_dropped_
or_repeated_k_slab holds this limit on the CPU).
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
# StarVector-8B's six projections a layer, four (K, N) shapes (StarCoder2-7B:
# 4608 wide, 4 KV heads of 128, an MLP of 18432)
SHAPES_8B = {"attn.q_proj, o_proj": (4608, 4608), "attn.k_proj, v_proj": (4608, 512),
             "mlp.c_fc": (4608, 18432), "mlp.c_proj": (18432, 4608)}
# the wgmma tile's ragged edges: N not a multiple of its columns, K not a
# multiple of its 64-row step (a multiple of 8)
SHAPES_RAGGED = {"K=200 N=48": (200, 48), "K=2056 N=400": (2056, 400)}
QMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-3, rtol=2**-7)}


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


@pytest.mark.parametrize("K,N", list(SHAPES_1B.values()) + [(300, 208), (16384, 48), (64, 16)]
                         + list(SHAPES_8B.values()))
def test_gemv_split_tiles_k_once(K, N):
    """The GEMV's split of K: slices of kc rows (a multiple of 32, at most
    the 1024 a block stages), every slice non-empty, and the grid within one
    wave of two blocks on each of the H100's 132 SMs unless K alone needs
    more splits."""
    splits, kc = tq.gemv_split(K, N)
    assert kc % 32 == 0 and 0 < kc <= 1024
    assert splits * kc >= K and (splits - 1) * kc < K
    assert -(-N // 128) * splits <= 2 * 132 or splits == -(-K // 1024)


# a tensor-8 rank's slices of both models (chip_smoke.py's QMM_TP_SHAPES):
# the 8B's q (5 and 4 heads), k/v, o_proj rows, MLP; the 1B's c_attn,
# attn/c_proj rows, MLP
SHAPES_TP8 = [(4608, 640), (4608, 512), (4608, 128), (640, 4608), (512, 4608), (4608, 2304),
              (2304, 4608), (2048, 512), (256, 2048), (2048, 1024), (1024, 2048)]


@pytest.mark.parametrize("K,N", list(SHAPES_1B.values()) + list(SHAPES_8B.values()) + SHAPES_TP8
                         + list(SHAPES_RAGGED.values()))
def test_gemv_plan_tiles_k_once_in_whole_waves(K, N):
    """The tensor-core GEMV's plan: every column tile's runs cover its
    units of K once, in k order, none empty; at most one block on each of
    the H100's 132 SMs, each holding parts of two shared tiles at most
    (the kernel's two partial slots); every block gets the same units give
    or take one, so the blocks end together: one whole wave wherever the
    launch has 256 rows of K for each of 132 blocks, else one block for
    every 256 rows; units of 64 rows where there are 64 column tiles or
    more, else of 256."""
    blocks, waves, ku = tq.gemv_plan(K, N)
    tiles, k_units = tq.gemv_units(K, N, ku)
    assert tq.gemv_plan_ok(K, N, blocks, waves, ku)
    assert ku == (1 if tiles >= 64 else 4)
    assert blocks == max(1, min(132, tiles * k_units // (4 // ku)))
    load = [0] * blocks
    partial = [0] * blocks
    for runs in tq.gemv_runs(K, N, blocks, waves, ku):
        assert runs[0][1] == 0 and runs[-1][2] == k_units
        assert all(a[2] == b[1] for a, b in zip(runs, runs[1:]))
        for b, k0, k1 in runs:
            assert k0 < k1
            load[b] += k1 - k0
            partial[b] += len(runs) > 1
    assert max(load) - min(load) <= 1 and sum(load) == tiles * k_units
    assert max(partial) <= 2
    assert tq.gemv_plan(K, N) == (blocks, waves, ku)


@pytest.mark.parametrize("M", list(range(1, 17)))
def test_gemv_path_keeps_the_pair_for_fp32_x(M):
    """fp32 x (the fp32 greedy checks) runs the CUDA-core pair at every M:
    a bf16 tensor-core product would round x. bf16 x runs the tensor-core
    GEMV, except where the pair measured faster (gemv_path's rule: M = 1
    below a wave of whole column tiles, M <= 4 at N <= 1024, M <= 8 at
    N <= 128) and where K % 8 != 0 (TMA copies x in 16-byte rows): at
    M > 8 every shape of the path runs it, and the 8B's c_fc at every M."""
    for K, N in list(SHAPES_1B.values()) + list(SHAPES_8B.values()) + SHAPES_TP8:
        assert tq.gemv_path(M, K, N, torch.float32) == "gemv"
        tc = M > 8 or (M > 4 and N > 128) or (M > 1 and N > 1024) or N >= 132 * 128
        assert tq.gemv_path(M, K, N, torch.bfloat16) == ("gemv_tc" if tc else "gemv")
    assert tq.gemv_path(M, 4612, 4608, torch.bfloat16) == "gemv"
    assert tq.gemv_path(M, 4608, 18432, torch.bfloat16) == "gemv_tc"


@pytest.mark.parametrize("M", [17, 64, 65, 260, 580, 1040, 2320, 4160])
@pytest.mark.parametrize("K,N", list(SHAPES_1B.values()) + list(SHAPES_RAGGED.values())
                         + list(SHAPES_8B.values()))
def test_tile_plan_tiles_k_once(M, K, N):
    """The wgmma tile's plan: a height the kernel has, K in slices of kc
    rows (a multiple of two of its 64-row steps), every slice non-empty, at
    most 8 of them; the same plan on every call."""
    tile_x, splits, kc = tq.tile_plan(M, K, N)
    assert tile_x in tq.TILE_XS and kc % (2 * tq.TILE_K) == 0 and 0 < kc
    assert splits * kc >= K and (splits - 1) * kc < K and 1 <= splits <= 8
    assert tq.tile_plan(M, K, N) == (tile_x, splits, kc)


# tile_plan's picks at the 1B's prefill shapes (B = 1 and 4) and the 8B's
# (580 and 2320 rows), the plans chip_smoke.py's tile_plan_times found the
# fastest of those it weighs on the H100 (PERF.md section 6): a change to
# the rule's constants keeps them
TILE_PLANS_1B = {
    (260, 2048, 2304): (136, 3, 768), (260, 2048, 2048): (136, 4, 512),
    (260, 2048, 8192): (136, 1, 2048), (260, 8192, 2048): (136, 4, 2048),
    (1040, 2048, 2304): (256, 1, 2048), (1040, 2048, 2048): (136, 1, 2048),
    (1040, 2048, 8192): (136, 1, 2048), (1040, 8192, 2048): (136, 1, 8192)}


TILE_PLANS_8B = {
    (580, 4608, 4608): (256, 1, 4608), (2320, 4608, 4608): (256, 1, 4608),
    (580, 4608, 512): (136, 6, 768), (2320, 4608, 512): (256, 3, 1536),
    (580, 4608, 18432): (136, 1, 4608), (2320, 4608, 18432): (256, 1, 4608),
    (580, 18432, 4608): (256, 1, 18432), (2320, 18432, 4608): (256, 1, 18432)}


@pytest.mark.parametrize("plans", [TILE_PLANS_1B, TILE_PLANS_8B], ids=["1b", "8b"])
def test_tile_plan_keeps_the_measured_plans(plans):
    assert {key: tq.tile_plan(*key) for key in plans} == plans


def _slab_case(K, seed, M=64, N=256):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).bfloat16()
    p = tq.quantize_dense({"kernel": torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32) * 0.02)})
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    return x, p["kernel_q"], p["scale"], bias


@pytest.mark.parametrize("K", [2048, 8192])
def test_qmm_tolerance_tells_a_dropped_or_repeated_k_slab(K):
    """QMM_TOL in bf16, with the plain version on the CPU: the sums taken
    in the tile's order (64-row steps, each step's fp32 sum added in turn)
    stay within it; the same product with one 16-row slab of q (one k16
    product) dropped or counted twice does not."""
    x, q, scale, bias = _slab_case(K, K)
    ref = tq.quant_matmul_plain(x, q, scale, bias, out_dtype=torch.bfloat16).float()
    tol = QMM_TOL[torch.bfloat16]

    def within(out):
        return bool(((out.float() - ref).abs() <= tol["atol"] + tol["rtol"] * ref.abs()).all())

    acc = torch.zeros((x.shape[0], q.shape[1]))
    for k0 in range(0, K, 64):
        acc += torch.mm(x[:, k0:k0 + 64].float(), q[k0:k0 + 64].float())
    assert within((acc * scale + bias).bfloat16())
    k0 = 16 * (5 * K // 16 // 7)
    for factor in (0, 2):
        slab = q.clone()
        slab[k0:k0 + 16] = (q[k0:k0 + 16].int() * factor).clamp(-128, 127).to(torch.int8)
        wrong = tq.quant_matmul_plain(x, slab, scale, bias, out_dtype=torch.bfloat16)
        assert not within(wrong), f"a slab times {factor} passes"


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
@pytest.mark.parametrize("M", list(range(1, 17)) + [17, 63, 64, 65, 260, 1040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_quant_matmul_kernel_matches_plain(cuda, M, dtype):
    """x of `dtype` at the 1B shapes and the tile's ragged edges, every GEMV
    height (M = 1..16: the tensor-core GEMV with bf16 x, the pair with
    fp32) and the tile's, bias none, fp32 or bf16, bf16 and fp32 out (fp32
    out with no bias: a row-parallel rank's partial); tolerance QMM_TOL of
    the output type (the module docstring gives its reasons)."""
    rng = np.random.default_rng(M)
    for name, (K, N) in {**SHAPES_1B, **SHAPES_RAGGED}.items():
        p = tq.quantize_dense({"kernel": torch.from_numpy(_weights((K, N), K + N)).to(cuda)})
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
        bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(cuda)
        for b in (None, bias, bias.bfloat16()):
            for out_dtype in (torch.bfloat16, torch.float32):
                out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=out_dtype)
                ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert out.dtype == out_dtype
                torch.testing.assert_close(
                    out.float(), ref.float(), **QMM_TOL[out_dtype],
                    msg=lambda m: f"{name} M={M} bias={None if b is None else b.dtype} "
                                  f"out {out_dtype}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 4, 7, 8, 9, 12, 16, 580, 2320])
@pytest.mark.parametrize("name", list(SHAPES_8B))
def test_quant_matmul_at_the_8b_shapes_matches_plain(cuda, name, M):
    """The 8B's projections at decode (M = 1..16: the GEMV; bf16 x with
    bias none, fp32 or bf16 and bf16 or fp32 out, the fp32-out no-bias case
    being a row-parallel rank's partial) and prefill (M = 580, 2320: B = 1
    and 4 prefixes of 576 visual tokens and 4 prompt ids, the tile) with
    their biases; bf16 x, and fp32 x up to M = 580; tolerance QMM_TOL; the
    bf16 GEMV and the tile at M = 2320 launched twice, bit for bit."""
    K, N = SHAPES_8B[name]
    rng = np.random.default_rng(K + N + M)
    p = tq.quantize_dense({"kernel": torch.from_numpy(_weights((K, N), K + N)).to(cuda)})
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32 and M > 580:
            continue
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
        cases = [(bias.to(dtype), dtype)]
        if dtype == torch.bfloat16 and M <= tq.GEMV_MAX_ROWS:
            cases = [(b, o) for b in (None, bias, bias.bfloat16())
                     for o in (torch.bfloat16, torch.float32)]
        for b, out_dtype in cases:
            out = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=out_dtype)
            ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=out_dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                out.float(), ref.float(), **QMM_TOL[out_dtype],
                msg=lambda m: f"{name} M={M} {dtype} bias={None if b is None else b.dtype} "
                              f"out {out_dtype}: {m}")
            if M == 2320 or (dtype == torch.bfloat16 and M <= tq.GEMV_MAX_ROWS):
                again = tq.quant_matmul(x, p["kernel_q"], p["scale"], b, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_x", tq.TILE_XS)
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_wgmma_tile_matches_plain_at_every_height_and_split(cuda, tile_x, splits):
    """Every height the tile has (rows of x a block) and splits of K that
    tile_plan may pick, launched directly, at mlp.c_proj's K = 8192 and a
    ragged K and N, M = 65 and 260; bf16 out, tolerance QMM_TOL."""
    rng = np.random.default_rng(tile_x + splits)
    for K, N in ((8192, 2048), (2056, 400)):
        p = tq.quantize_dense({"kernel": torch.from_numpy(_weights((K, N), K)).to(cuda)})
        bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(cuda)
        kc = 2 * tq.TILE_K * -(-K // (splits * 2 * tq.TILE_K))
        for M in (65, 260):
            x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
                cuda, torch.bfloat16)
            out = tq.launch_kernel(x, p["kernel_q"], p["scale"], bias, torch.bfloat16, "wgmma",
                                   tile_x, -(-K // kc), kc)
            ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], bias,
                                        out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **QMM_TOL[torch.bfloat16],
                                       msg=lambda m: f"K={K} N={N} M={M}: {m}")


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


def _gemv_plans(K: int, N: int) -> list[tuple]:
    """Plans (blocks, waves of whole tiles, ku) of the tensor-core GEMV that
    cover its cases: gemv_plan's, and for units of 64 and of 256 rows one
    block, a few, a whole wave and one unit a block, with and without waves
    of whole tiles; each that the kernel takes."""
    plans = [tq.gemv_plan(K, N)]
    for ku in (1, 4):
        tiles, k_units = tq.gemv_units(K, N, ku)
        for blocks in (1, 2, 3, 7, 132, tiles * k_units):
            plans += [(blocks, waves, ku) for waves in (0, tiles // blocks)]
    return sorted({p for p in plans if tq.gemv_plan_ok(K, N, *p)})


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 16, 17, 260, 1040])
def test_gemv_two_launches_are_bit_identical(cuda, M):
    """The GEMV (M <= 16: the tensor-core GEMV, whose last block of a column
    tile adds the parts in k order, on gemv_plan's plan and every other
    count of blocks, waves of whole tiles and splits of K that _gemv_plans
    lists; and the pair, whose second kernel adds the splits in order) and
    the wgmma tile (M > 16, split or not): no atomics on the sums, the same
    bits twice, at the four 1B projections and the 8B's k/v; each GEMV plan
    to QMM_TOL of the plain version."""
    rng = np.random.default_rng(M)
    for name, (K, N) in {**SHAPES_1B, "8B k/v": SHAPES_8B["attn.k_proj, v_proj"]}.items():
        p = tq.quantize_dense({"kernel": torch.from_numpy(_weights((K, N), N)).to(cuda)})
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, torch.bfloat16)
        a = tq.quant_matmul(x, p["kernel_q"], p["scale"], out_dtype=torch.bfloat16)
        b = tq.quant_matmul(x, p["kernel_q"], p["scale"], out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(a, b), name
        if M > tq.GEMV_MAX_ROWS:
            continue
        ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], out_dtype=torch.bfloat16)
        runs = [("pair", lambda: tq.launch_kernel(x, p["kernel_q"], p["scale"], None,
                                                  torch.bfloat16, "gemv", 0, *tq.gemv_split(K, N)))]
        runs += [(plan, (lambda plan: lambda: tq.launch_gemv_tc(
            x, p["kernel_q"], p["scale"], None, torch.bfloat16, *plan))(plan))
                 for plan in _gemv_plans(K, N)]
        for plan, fn in runs:
            a, b = fn(), fn()
            torch.cuda.synchronize()
            assert torch.equal(a, b), (name, plan)
            torch.testing.assert_close(a.float(), ref.float(), **QMM_TOL[torch.bfloat16],
                                       msg=lambda m: f"{name} M={M} plan {plan}: {m}")
