"""The static decode loops on the card, captured as CUDA graphs
(generation/graphs.py), against the same steps run uncaptured; and kernel
2 with its key bounds read from the device against its plain version.

Every test here is marked `gpu` and skips without a card. The file imports
no JAX, so on the card it runs as
    python -m pytest --noconftest -m gpu tests/test_torch_graph_decode_gpu.py

  * kernel 2 with device `bounds` (int32 [t_begin, t_end], the grid planned
    at t_cap) matches its plain version with the same bounds to DECODE_TOL
    (tests/test_torch_flash_attention.py: atol = rtol 1e-4 in fp32; bf16
    atol 2e-3, rtol 2^-7) at every group G the kernel is built for, over
    each cache type, with t_end well inside t_cap, a window's t_begin > 0
    off a tile edge, t_begin == t_end (the self token alone) and one
    visible key; a launch captured in a CUDA graph, replayed after the
    device bounds change, gives a fresh launch's bits. With one visible
    key and bf16 queries the kernel rounds p to bf16 against that key's
    own score (the max of its 16-key group), the plain version in fp32
    against the larger of it and the self score: a bf16 step of the cached
    term, over either cache type, on outputs that can cancel to near 0,
    which DECODE_TOL (set for the hundreds of keys of a real step) does
    not admit there. That case is held to the plain version with p rounded
    as the kernel's warps round it (tests/test_torch_flash_attention.py::
    _decode_p_rounded_by_groups, a KV head at a time), as
    test_g9_decode_over_an_int8_cache_matches_plain holds T = 1;
  * a graph keeps the kernel-2 scratch it was captured with: after a
    larger launch replaced the scratch and new tensors took the freed
    sizes, a replay gives a fresh launch's bits and leaves those tensors
    as they were; the serving engine's graphs, replayed after the same,
    give an uncaptured engine's ids;
  * the graphed generate gives the uncaptured static generate's ids and
    lengths bit for bit (the same launches in the same order), at a
    decoder of the 1B's head size (2 layers, 16 heads of 128) and of the
    8B's groups (18 heads over 2, window 64 which the steps run past):
    fp32 and bf16 greedy, an int8 cache, num_return_sequences = 2, and
    sampling under one seed (the generator's state registered with each
    graph); the launches the graphs replayed are the uncaptured run's;
  * the serving engine's graphed tick gives the uncaptured tick's greedy
    ids (cuda_graphs=False).
"""

import pytest
import torch
from test_torch_flash_attention import _decode_p_rounded_by_groups

from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.models import decode_common as tdc
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy

DECODE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: dict(rtol=2**-7, atol=2e-3)}
POLICIES = {"fp32": DTypePolicy(torch.float32, torch.float32),
            "bf16": DTypePolicy(torch.bfloat16, torch.bfloat16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(device, cache: str, G: int, Hkv: int, B=4, T=1500, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    D = 128
    dtype = torch.bfloat16 if "bf16" in cache else torch.float32
    r = lambda *shape: torch.randn(*shape, generator=g).to(device)  # noqa: E731
    qg, kn, vn = r(B, Hkv, G, D).to(dtype), r(B, Hkv, D).to(dtype), r(B, Hkv, D).to(dtype)
    k, v = r(B, T, Hkv, D), r(B, T, Hkv, D)
    ks = vs = None
    if cache.startswith("int8"):
        (k, ks), (v, vs) = tdc.quantize_kv(k), tdc.quantize_kv(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    mask = torch.ones((B, T), dtype=torch.int32, device=device)
    mask[0, :300] = 0
    mask[:, 777] = 0
    return qg, kn, vn, k, v, ks, vs, mask


BOUNDS = [(0, 900, 1024), (333, 1400, 1500), (1000, 1000, 1024), (40, 300, 512), (129, 700, 1500),
          (0, 1, 128)]


def _plain(qg, k, v, mask, bounds, t_cap, kw):
    """The plain version with the same device bounds; with one visible key
    and bf16 queries, p rounded as the kernel rounds it (module docstring)."""
    t_begin, t_end = bounds.tolist()
    if t_end - t_begin != 1 or qg.dtype != torch.bfloat16:
        return tfa.decode_attention(qg, k, v, mask, t_end=t_cap, bounds=bounds, kernels=False,
                                    **kw)
    one = torch.zeros_like(mask)
    one[:, t_begin] = mask[:, t_begin]
    ks, vs = kw["k_scale"], kw["v_scale"]
    return torch.cat([_decode_p_rounded_by_groups(
        qg[:, h:h + 1], kw["k_new"][:, h:h + 1], kw["v_new"][:, h:h + 1], k[:, :, h:h + 1],
        v[:, :, h:h + 1], None if ks is None else ks[..., h:h + 1],
        None if vs is None else vs[..., h:h + 1], one) for h in range(qg.shape[1])], dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8 cache, bf16 q", "int8 cache, fp32 q"])
@pytest.mark.parametrize("G,Hkv", [(16, 1), (9, 4), (8, 1), (5, 4), (4, 4), (2, 1)])
def test_decode_device_bounds_match_plain(cuda, G, Hkv, cache):
    qg, kn, vn, k, v, ks, vs, mask = _operands(cuda, cache, G, Hkv, seed=G * 7 + Hkv)
    kw = dict(k_new=kn, v_new=vn, k_scale=ks, v_scale=vs)
    bounds = torch.zeros(2, dtype=torch.int32, device=cuda)
    for t_begin, t_end, t_cap in BOUNDS:
        bounds.copy_(torch.tensor([t_begin, t_end]))
        n = tfa.decode_attention.launches
        out = tfa.decode_attention(qg, k, v, mask, t_end=t_cap, bounds=bounds, **kw)
        ref = _plain(qg, k, v, mask, bounds, t_cap, kw)
        torch.cuda.synchronize()
        assert tfa.decode_attention.launches == n + 1
        torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL[qg.dtype],
                                   msg=f"bounds {(t_begin, t_end, t_cap)}")
    # one launch in a graph, its bounds moved on the device between replays
    tfa.reserve_decode_scratch(cuda, qg.shape[0], Hkv, G, 128, 1500)
    static = torch.empty_like(qg)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static.copy_(tfa.decode_attention(qg, k, v, mask, t_end=1500, bounds=bounds, **kw))
    for t_begin, t_end, _ in BOUNDS:
        bounds.copy_(torch.tensor([t_begin, t_end]))
        graph.replay()
        fresh = tfa.decode_attention(qg, k, v, mask, t_end=1500, bounds=bounds, **kw)
        torch.cuda.synchronize()
        assert torch.equal(static, fresh), (t_begin, t_end)


def _decoder(name: str, device, policy):
    if name == "gpt_bigcode":
        cfg = tgbc.tiny_config(hidden_size=2048, n_head=16, n_inner=1024, n_positions=512)
        params = tgbc.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                  device=device, dtype=policy.param_dtype)
        return tgbc, cfg, params
    cfg = tsc.tiny_config(hidden_size=2304, num_attention_heads=18, num_key_value_heads=2,
                          intermediate_size=1024, max_position_embeddings=512, sliding_window=64)
    params = tsc.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device,
                             dtype=policy.param_dtype)
    return tsc, cfg, params


def _generate(mod, cfg, params, device, policy, cuda_graphs, *, kv=None, seed=None, **kw):
    B, P = 2, 80
    g = torch.Generator(device=device).manual_seed(1)
    emb = (torch.randn(B, P, cfg.hidden_size, generator=g, device=device) * 0.5)
    mask = torch.ones((B, P), dtype=torch.int32, device=device)
    mask[1, :7] = 0
    gen = tengine.GenerationConfig(max_new_tokens=40, **{"do_sample": False, **kw})
    sampler = None if seed is None else torch.Generator(device=device).manual_seed(seed)
    return tengine.generate(params, cfg, emb.to(policy.compute_dtype), mask, gen, sampler,
                            policy=policy, kv_cache_dtype=kv, cuda_graphs=cuda_graphs)


GENERATE_CASES = {
    "fp32": ("fp32", None, {}),
    "bf16": ("bf16", None, {}),
    "int8 cache": ("bf16", torch.int8, {}),
    "n_rep 2": ("fp32", None, {"num_return_sequences": 2}),
    "sampled": ("bf16", None, {"do_sample": True, "temperature": 0.9, "top_p": 0.95,
                               "seed": 3}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GENERATE_CASES))
@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
def test_graphed_generate_equals_uncaptured(cuda, name, case):
    policy_name, kv, kw = GENERATE_CASES[case]
    policy = POLICIES[policy_name]
    mod, cfg, params = _decoder(name, cuda, policy)
    counts = {}
    for graphed in (False, True):
        graphs.reset_tally()
        before = graphs.launch_counts()
        out = _generate(mod, cfg, params, cuda, policy, graphed, kv=kv, **kw)
        torch.cuda.synchronize()
        after = graphs.launch_counts()
        counts[graphed] = graphs.true_launches({k: after[k] - before[k] for k in after})
        if graphed:
            t = graphs.tally()  # one bucket (the keys stay below 128): one graph, 38 replays
            assert t["captures"] == 1 and t["replays"] == 40 - 2, t
            assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1]), \
                (out[0].tolist(), plain[0].tolist())
        plain = out
    assert counts[True] == counts[False] and counts[True]["decode_attention"] > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
def test_graphed_tick_equals_eager_tick(cuda, name):
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    policy = POLICIES["fp32"]
    mod, cfg, params = _decoder(name, cuda, policy)
    g = torch.Generator(device="cpu").manual_seed(2)
    prefixes = [torch.randn(1, n, cfg.hidden_size, generator=g) * 0.5 for n in (90, 40, 70, 120)]
    outs = {}
    for graphed in (True, False):
        engine = ServeEngine(params, cfg, name, max_batch=4, max_len=512, policy=policy,
                             device=cuda, cuda_graphs=graphed)
        try:
            reqs = [engine.submit(Request(prefix_embeds=p, max_new_tokens=30, do_sample=False))
                    for p in prefixes]
            engine.start()
            outs[graphed] = [engine.result(r, timeout=300) for r in reqs]
            if graphed:
                assert engine._graphs, "no tick was captured"
        finally:
            engine.stop()
    assert outs[True] == outs[False]


def _filled(sizes, device):
    """New tensors of the given (numel, dtype) sizes, each filled with a
    pattern: allocated right after buffers of those sizes were freed, they
    take the freed memory."""
    return [torch.full((n,), 7, dtype=dtype, device=device) for n, dtype in sizes]


@pytest.mark.gpu
def test_a_graph_keeps_its_scratch_when_the_scratch_grows(cuda):
    cuda = torch.device("cuda", torch.cuda.current_device())  # the scratch's key
    saved = tfa._DECODE_SCRATCH.pop(cuda, None)
    try:
        qg, kn, vn, k, v, _, _, mask = _operands(cuda, "bf16", 16, 1, B=4, T=1024)
        kw = dict(k_new=kn, v_new=vn)
        bounds = torch.tensor([0, 900], dtype=torch.int32, device=cuda)
        tfa.reserve_decode_scratch(cuda, 4, 1, 16, 128, 1024)
        static = torch.empty_like(qg)
        graph = graphs.StepGraph(lambda: static.copy_(tfa.decode_attention(
            qg, k, v, mask, t_end=1024, bounds=bounds, **kw)), cuda)
        # addresses and sizes only: a reference here would keep the buffers
        ptrs = {t.data_ptr() for t in tfa._DECODE_SCRATCH[cuda]}
        sizes = [(t.numel(), t.dtype) for t in tfa._DECODE_SCRATCH[cuda]]
        big = _operands(cuda, "bf16", 16, 1, B=8, T=8192, seed=1)
        tfa.decode_attention(big[0], big[3], big[4], big[7], k_new=big[1], v_new=big[2])
        assert tfa._DECODE_SCRATCH[cuda][1].data_ptr() not in ptrs, "the scratch did not grow"
        del big
        fillers = _filled(sizes, cuda)
        graph.replay()
        fresh = tfa.decode_attention(qg, k, v, mask, t_end=1024, bounds=bounds, **kw)
        torch.cuda.synchronize()
        assert torch.equal(static, fresh)
        assert all(bool((f == 7).all()) for f in fillers), "a replay wrote into freed scratch"
        assert not ptrs & {f.data_ptr() for f in fillers}
    finally:
        tfa._DECODE_SCRATCH.pop(cuda, None)
        if saved is not None:
            tfa._DECODE_SCRATCH[cuda] = saved


@pytest.mark.gpu
def test_graphed_ticks_replay_after_the_scratch_grew(cuda):
    """Three rounds on one engine: a short request (its ticks captured at
    key cap 64), a long one (caps 128 and 256), then, after an eager
    kernel-2 launch larger than the engine's scratch and new tensors of
    the freed sizes, the short request again (the cap-64 graphs replayed).
    The ids equal an uncaptured engine's round by round, and the new
    tensors keep their pattern."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    cuda = torch.device("cuda", torch.cuda.current_device())  # the scratch's key
    policy = POLICIES["fp32"]
    mod, cfg, params = _decoder("gpt_bigcode", cuda, policy)
    g = torch.Generator(device="cpu").manual_seed(4)
    short, long = (torch.randn(1, n, cfg.hidden_size, generator=g) * 0.5 for n in (30, 100))
    saved = tfa._DECODE_SCRATCH.pop(cuda, None)
    try:
        outs = {}
        for graphed in (True, False):
            engine = ServeEngine(params, cfg, "gpt_bigcode", max_batch=4, max_len=512,
                                 policy=policy, device=cuda, cuda_graphs=graphed)
            try:
                engine.start()
                run = lambda p, n: engine.generate_sync(  # noqa: E731
                    Request(prefix_embeds=p, max_new_tokens=n, do_sample=False), timeout=300)
                got = [run(short, 20), run(long, 100)]
                if graphed:
                    assert {c for c, _ in engine._graphs} == {64, 128, 256}, engine._graphs
                    ptrs = {t.data_ptr() for t in tfa._DECODE_SCRATCH[cuda]}
                    sizes = [(t.numel(), t.dtype) for t in tfa._DECODE_SCRATCH[cuda]]
                    big = _operands(cuda, "bf16", 16, 1, B=8, T=8192, seed=1)
                    tfa.decode_attention(big[0], big[3], big[4], big[7], k_new=big[1],
                                         v_new=big[2])
                    assert tfa._DECODE_SCRATCH[cuda][1].data_ptr() not in ptrs
                    del big
                    fillers = _filled(sizes, cuda)
                got.append(run(short, 20))
                outs[graphed] = got
            finally:
                engine.stop()
        assert outs[True] == outs[False]
        assert all(bool((f == 7).all()) for f in fillers), "a replay wrote into freed scratch"
    finally:
        tfa._DECODE_SCRATCH.pop(cuda, None)
        if saved is not None:
            tfa._DECODE_SCRATCH[cuda] = saved
