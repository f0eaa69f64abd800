"""The pipelined streams and speculative decoding on the card, their static
steps captured as CUDA graphs (generation/graphs.py::StepLoop), against
the same steps run uncaptured (cuda_graphs=False).

Every test here is marked `gpu` and skips without a card. The file imports
no JAX, so on the card it runs as
    python -m pytest --noconftest -m gpu tests/test_torch_graph_pipelined_gpu.py

The decoders are tests/test_torch_graph_decode_gpu.py's: 2 layers of the
1B's head size (16 heads of 128 over one KV head) and of the 8B's groups
(18 heads over 2, window 64 which the streams run past).
  * generate_pipelined over 3 batches, generate_pipelined_spec over 3
    batches (the 1B: StarCoder2 has no fused verify), and
    generate_greedy_speculative (B = 1) and _batched (B = 3), graphed, give
    the uncaptured run's ids, lengths, n_forwards and rounds bit for bit
    (the same launches in the same order): fp32, an int8 KV cache, and int8
    weights in bf16 (kernel 14's tile inside the fused step's graphs at M =
    B (1 + C) = 18 rows, its GEMV in the decode-only ones); the launches
    the graphs replayed are the uncaptured run's (graphs.true_launches);
  * a stream of 3 batches captures as many graphs as one of 2, for both
    pipelined streams;
  * kernel 14's tile, captured with a split-K workspace from the pool its
    graph shares, replays to a fresh launch's bits after another graph
    was captured in that pool at a larger M;
  * every replay, and every uncaptured step, runs under
    torch.cuda.set_sync_debug_mode("error"): only the loops' one read a
    block (graphs.host_read) and the warm-ups and captures run outside it.
"""

import pytest
import torch
from test_torch_graph_decode_gpu import POLICIES, _decoder

from starvector_tpu_torch.generation import engine as tengine
from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.generation import speculative as tspec
from starvector_tpu_torch.ops import quantization as tq
from starvector_tpu_torch.ops.quantization import quantize_tree

NEW, C = 24, 8  # 24 new tokens; the pipelined prompts' chunks of 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(name, device, policy_name, int8_weights=False):
    policy = POLICIES[policy_name]
    mod, cfg, params = _decoder(name, device, policy)
    if int8_weights:
        params = quantize_tree(params)
    return mod, cfg, params, policy


def _left_batches(cfg, device, policy, n=3, B=2, P=60):
    g = torch.Generator(device=device).manual_seed(5)
    out = []
    for _ in range(n):
        emb = torch.randn(B, P, cfg.hidden_size, generator=g, device=device) * 0.5
        mask = torch.ones((B, P), dtype=torch.int32, device=device)
        mask[1, :5] = 0
        out.append((emb.to(policy.compute_dtype), mask))
    return out


def _right_batches(mod, params, device, n=3, lens=(70, 66, 65)):
    """n batches of right-padded rows of ids from a set of 6 (drafts
    recur): (embeds, mask, ids -1 at the holes). Every row is longer than
    64 and a stream's ragged cache holds fewer than 128 slots (72 + 24 + 5
    + 1), so a verify's key span is the whole cache whatever the rows
    accepted, and a stream's graphs are the same set however many batches
    it has."""
    g = torch.Generator(device=device).manual_seed(6)
    P = max(lens)
    mask = (torch.arange(P, device=device)[None, :]
            < torch.tensor(lens, device=device)[:, None]).int()
    out = []
    for _ in range(n):
        ids = torch.tensor([7, 99, 123, 311, 5, 42], device=device)[
            torch.randint(0, 6, (len(lens), P), generator=g, device=device)]
        emb = mod.embed_tokens(params, ids).float() * mask[:, :, None]
        out.append((emb, mask, torch.where(mask > 0, ids, -1)))
    return out


def _run(fn, graphed):
    """(fn(graphed), its true launches, the tally)."""
    graphs.reset_tally()
    before = graphs.launch_counts()
    out = fn(graphed)
    torch.cuda.synchronize()
    after = graphs.launch_counts()
    return out, graphs.true_launches({k: after[k] - before[k] for k in after}), graphs.tally()


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _pipelined(mod, cfg, params, policy, device, kv=None, n=3):
    batches = _left_batches(cfg, device, policy, n=n)
    gen = tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)
    return lambda graphed: tengine.generate_pipelined(
        params, cfg, batches, gen, policy=policy, chunk_positions=C, kv_cache_dtype=kv,
        cuda_graphs=graphed)


def _pipelined_spec(mod, cfg, params, policy, device, kv=None, n=3):
    batches = _right_batches(mod, params, device, n=n)
    gen = tengine.GenerationConfig(max_new_tokens=NEW, do_sample=False)

    def run(graphed):
        stats = []
        out = tspec.generate_pipelined_spec(
            params, cfg, [(e.to(policy.compute_dtype), m, i) for e, m, i in batches], gen,
            policy=policy, draft_len=5, chunk_positions=C, kv_cache_dtype=kv, stats=stats,
            cuda_graphs=graphed)
        return out, stats
    return run


def _speculative(mod, cfg, params, policy, device, B):
    emb, mask, ids = _right_batches(mod, params, device, n=1)[0]
    emb = emb.to(policy.compute_dtype)
    kw = dict(max_new_tokens=NEW, draft_len=5, policy=policy)
    if B == 1:
        n = int(mask[0].sum())
        return lambda graphed: tspec.generate_greedy_speculative(
            params, cfg, emb[:1, :n], mask[:1, :n], ids[:1, :n], cuda_graphs=graphed, **kw)
    return lambda graphed: tspec.generate_greedy_speculative_batched(
        params, cfg, emb, mask, ids, cuda_graphs=graphed, **kw)


CASES = {"fp32": ("fp32", None, False), "int8 KV": ("fp32", torch.int8, False),
         "int8 weights, bf16": ("bf16", None, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
def test_graphed_pipelined_equals_uncaptured(cuda, name, case):
    policy_name, kv, int8_weights = CASES[case]
    mod, cfg, params, policy = _model(name, cuda, policy_name, int8_weights)
    run = _pipelined(mod, cfg, params, policy, cuda, kv)
    plain, plain_counts, _ = _run(run, False)
    out, counts, tally = _run(run, True)
    assert _same(out, plain), ([t.tolist() for t, _ in out], [t.tolist() for t, _ in plain])
    assert counts == plain_counts and counts["decode_attention"] > 0, (counts, plain_counts)
    assert tally["captures"] > 0 and tally["replays"] > 0, tally
    if int8_weights:
        assert counts["quant_matmul_wgmma"] > 0 and counts["quant_matmul"] > \
            counts["quant_matmul_wgmma"], counts


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_pipelined_spec_equals_uncaptured(cuda, case):
    policy_name, kv, int8_weights = CASES[case]
    mod, cfg, params, policy = _model("gpt_bigcode", cuda, policy_name, int8_weights)
    run = _pipelined_spec(mod, cfg, params, policy, cuda, kv)
    plain, plain_counts, _ = _run(run, False)
    out, counts, tally = _run(run, True)
    assert _same(out, plain), (out[1], plain[1])
    assert counts == plain_counts and tally["captures"] > 0, (counts, plain_counts, tally)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
def test_graphed_speculative_equals_uncaptured(cuda, name, B):
    for policy_name in ("fp32", "bf16"):
        mod, cfg, params, policy = _model(name, cuda, policy_name)
        run = _speculative(mod, cfg, params, policy, cuda, B)
        plain, plain_counts, _ = _run(run, False)
        out, counts, tally = _run(run, True)
        assert _same(out, plain), (out, plain)
        assert counts == plain_counts and tally["captures"] > 0, (counts, plain_counts, tally)


@pytest.mark.gpu
def test_a_longer_stream_captures_no_more_graphs(cuda):
    captures = {}
    for name, stream in (("gpt_bigcode", _pipelined), ("starcoder2", _pipelined),
                         ("gpt_bigcode", _pipelined_spec)):
        mod, cfg, params, policy = _model(name, cuda, "fp32")
        for n in (2, 3):
            captures[stream.__name__, name, n] = _run(
                stream(mod, cfg, params, policy, cuda, n=n), True)[2]["captures"]
    for (stream, name, n), c in captures.items():
        assert c > 0 and c == captures[stream, name, 2], captures


@pytest.mark.gpu
def test_tile_replays_after_another_graph_grew_the_pool(cuda):
    """Kernel 14's tile at M = 144 over the 1B's mlp/c_proj shape (K 8192,
    N 2048: a split-K workspace of 8 splits, allocated per call, inside a
    capture from the graph's pool); a second graph in the same pool at M =
    1040 and M = 260 allocates over what the first one freed; replays of
    the first, before and after the second's, give a fresh launch's
    bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    K, N = 8192, 2048
    assert tq.tile_plan(144, K, N)[1] > 1  # the workspace exists
    q = torch.randint(-127, 128, (K, N), generator=g, device=cuda, dtype=torch.int8)
    scale = torch.rand(N, generator=g, device=cuda) * 1e-2
    xs = {M: torch.randn(M, K, generator=g, device=cuda).bfloat16() for M in (144, 1040, 260)}
    outs = {M: torch.empty((M, N), dtype=torch.float32, device=cuda) for M in xs}
    pool = torch.cuda.graph_pool_handle()

    def step(Ms):
        def fn():
            for M in Ms:
                outs[M].copy_(tq.quant_matmul(xs[M], q, scale))
        return fn

    graphs.on_side_stream(cuda, step((144, 1040, 260)))  # warm-up: the libraries' set-up
    first = graphs.StepGraph(step((144,)), cuda, pool=pool)
    first.replay()
    torch.cuda.synchronize()
    after_first = outs[144].clone()
    second = graphs.StepGraph(step((1040, 260)), cuda, pool=pool)
    for graph in (second, first, second, first):
        outs[144].zero_()
        graph.replay()
    fresh = {M: tq.quant_matmul(xs[M], q, scale) for M in xs}
    torch.cuda.synchronize()
    for M in xs:
        assert torch.equal(outs[M], fresh[M]), M
    assert torch.equal(after_first, fresh[144])


LOOPS = {"pipelined": ("gpt_bigcode", _pipelined), "pipelined 8B": ("starcoder2", _pipelined),
         "pipelined_spec": ("gpt_bigcode", _pipelined_spec),
         "speculative B=1": ("starcoder2", lambda *a: _speculative(*a, B=1)),
         "speculative B=3": ("gpt_bigcode", lambda *a: _speculative(*a, B=3))}


@pytest.mark.gpu
@pytest.mark.parametrize("graphed", [True, False])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_steps_make_no_host_sync(cuda, monkeypatch, loop, graphed):
    """Every replay (graphed) or uncaptured step (cuda_graphs=False) under
    set_sync_debug_mode("error"): a step that read the device on the host
    would raise. A warm-up and a capture run outside it, as does the
    loops' one read a block (graphs.host_read, between steps)."""
    name, make = LOOPS[loop]
    mod, cfg, params, policy = _model(name, cuda, "bf16")
    run = graphs.StepLoop.run
    checked = []

    def strict(self, kind, key, fn):
        if self.enabled and (kind not in self.warmed or (kind, key) not in self.graphs):
            return run(self, kind, key, fn)
        checked.append(kind)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, kind, key, fn)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(graphs.StepLoop, "run", strict)
    make(mod, cfg, params, policy, cuda)(graphed)
    torch.cuda.synchronize()
    assert checked, "no step ran under the sync check"
