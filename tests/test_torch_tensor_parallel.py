"""Tensor-parallel serving of the port on the CPU (gloo), held to the port's
one process and to the JAX package.

- head_layout at the 8B's 36 heads over 4 on 1, 2, 4 and 8 ranks, a tiny
  uneven split (6 over 2 on 4 ranks: 2 + 1 query heads a KV head, as 9 ->
  5 + 4 at tensor 8) and refused triples;
- each rank's slices at tensor 2 and 4, where tp divides the KV heads,
  equal the JAX package's device shards (its make_param_shardings on its
  8-device CPU mesh); a per-rank checkpoint load (safetensors get_slice)
  equals the shard of the whole load, leaf for leaf;
- four gloo ranks on (tensor 4), a tiny 8B-shaped decoder of 6 heads over
  2 with random biases: the cached prefill past the window, a decode step,
  a chunk step, ragged decode steps and a ragged verify, each within 1e-5
  of the one-process port and within the port's fp32 tolerance of
  starvector_tpu's; without the all-reduce, or with the row-parallel bias
  added on every rank, they are wrong. The tensor-4 ServeEngine's greedy
  ids for 3 concurrent requests, over a bf16 and over an int8 cache, equal
  the JAX package's unsharded ServeEngine's, and every follower checks the
  leader's tokens against its own;
- one run of (data 2, tensor 2): two leaders load their slices from an
  exported checkpoint, register ModelWorkers with the controller, and 4
  requests through it land on both and give the one-process worker's text;
- refusals citing item 12: a serving mesh with stage above 1 (a training
  mesh of stage x tensor is laid out; the 1B, int8 weights and
  use_speculative on a tensor mesh: tests/test_torch_tensor_parallel_rest.py).

Ranks are this file run as a script (test_torch_fsdp_train.launch); their
code imports torch and the port only, the JAX references run in the pytest
process.
"""

import base64
import io
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_fsdp_train import launch, worker_main  # noqa: E402

# a tiny 8B-shaped decoder: 6 query heads over 2 KV heads (G = 3: 2 + 1 on
# tensor 4), head size 16, a window of 8 that the prefill runs past
LLM = dict(num_attention_heads=6, num_key_value_heads=2, hidden_size=96, intermediate_size=128,
           sliding_window=8)
# tensor 2 and 4 divide these KV heads: each rank's slices are JAX's shards
EVEN = dict(num_attention_heads=8, num_key_value_heads=4, hidden_size=128, intermediate_size=256)
REL = dict(rtol=1e-5, atol=1e-5)      # the tensor group against one process
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # the port against the JAX package, fp32
ENGINE_NEW = 8
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5])


# ---------------------------------------------------------------------------
# the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _f32():
    from starvector_tpu_torch.ops.layers import DTypePolicy

    return DTypePolicy(torch.float32, torch.float32)


def scenario(params: dict, cfg, emb: np.ndarray, toks: np.ndarray) -> dict:
    """The decoder's cached forwards on `params` (whole, or a tensor rank's
    with its cfg), fp32: a prefill of 12 tokens past the window of 8 (one
    row right-padded to 9), a decode step, a chunk step of 4; then the
    engine's ragged cache: the prefill landed in rows 0 and 2 of 3, two
    ragged decode steps, a ragged verify of 3 tokens. Returns each one's
    logits."""
    from starvector_tpu_torch.models import decode_common as dc
    from starvector_tpu_torch.models import starcoder2 as tsc

    f32 = _f32()
    emb = torch.from_numpy(emb)
    toks = torch.from_numpy(toks)
    mask = torch.ones(emb.shape[:2], dtype=torch.int32)
    mask[1, 9:] = 0
    out = {}
    cache = tsc.init_cache(cfg, 2, 24, dtype=torch.float32)
    out["prefill"], cache = tsc.forward(params, cfg, emb, mask, cache=cache, policy=f32)
    small = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()}
    x = tsc.embed_tokens(params, toks[:, :1])
    out["decode"], cache = tsc.forward(params, cfg, x, torch.ones((2, 1), dtype=torch.int32),
                                       cache=cache, policy=f32)
    x = tsc.embed_tokens(params, toks[:, 1:5])
    out["chunk"], cache = tsc.forward(params, cfg, x, torch.ones((2, 4), dtype=torch.int32),
                                      cache=cache, policy=f32)
    rag = tsc.init_ragged_cache(cfg, 3, 32, dtype=torch.float32)
    dc.insert_prefill_rows(rag, small, torch.tensor([0, 2]), torch.tensor([12, 9]))
    for i, active in enumerate(([1, 0, 1], [1, 0, 0])):
        out[f"ragged{i}"], rag = tsc.forward_ragged_decode(
            params, cfg, toks[[0, 0, 1], 5 + i], rag, torch.tensor(active, dtype=torch.int32),
            policy=f32)
    out["verify"], rag = tsc.forward_ragged_verify(params, cfg, toks[[0, 0, 1], 7:10], rag,
                                                   policy=f32)
    return out


def _gather(obj) -> list:
    import torch.distributed as dist

    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, obj)
    return box


def _per_rank_bias(dense):
    """dense with a row-parallel bias added on every rank before the sum."""
    from starvector_tpu_torch.ops.layers import matmul_f32
    from starvector_tpu_torch.parallel import tensor

    def wrong(params, x, policy=None, **kw):
        group = tensor.row_group(params["kernel"])
        if group is None or "bias" not in params:
            return dense(params, x, policy, **kw)
        y = matmul_f32(x, params["kernel"]) + params["bias"].float()
        return group.all_reduce(y).to(x.dtype)

    return wrong


def _tensor4_job(tree: dict, emb: np.ndarray, toks: np.ndarray, prompts: list) -> dict:
    """On tensor 4: the scenario on this rank's slices, again without the
    all-reduce and with the bias on every rank; then the engine's greedy
    ids for `prompts` over a bf16 and an int8 cache. Returns rank 0's
    results and every rank's count of checked steps."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    group = tensor.serving_group({"tensor": 4})
    whole = convert.from_jax_params(tree)
    cfg = tsc.tiny_config(**LLM)
    local_cfg = tsc.tensor_config(cfg, group.size, group.rank)
    params = tensor.shard_tree(whole, tsc.partition_rules(),
                               tsc.tensor_units(cfg, group.size, group.rank), group.tensor)
    out = {"tp": scenario(params, local_cfg, emb, toks),
           "heads": (local_cfg.num_attention_heads, local_cfg.kv_heads)}
    reduce = tensor.TensorGroup.all_reduce
    tensor.TensorGroup.all_reduce = lambda self, t: t
    try:
        out["no_reduce"] = scenario(params, local_cfg, emb, toks)
    finally:
        tensor.TensorGroup.all_reduce = reduce
    dense = tsc.dense
    tsc.dense = _per_rank_bias(dense)
    try:
        out["bias_per_rank"] = scenario(params, local_cfg, emb, toks)
    finally:
        tsc.dense = dense
    checked = {}
    for kv in ("bfloat16", "int8"):
        engine = ServeEngine(params, local_cfg, "starcoder2", max_batch=3, max_len=64,
                             policy=_f32(), kv_cache_dtype=getattr(torch, kv), device="cpu",
                             group=group)
        if not group.is_leader:
            engine.follow()
            checked[kv] = engine.checked_steps
            continue
        out[f"engine_{kv}"] = _engine_run(engine, [
            Request(prefix_embeds=torch.from_numpy(p), max_new_tokens=ENGINE_NEW,
                    do_sample=False) for p in prompts])
    for mode, kw in (("spec", dict(spec_drafts=3)), ("beam", {})):
        engine = ServeEngine(params, local_cfg, "starcoder2", max_batch=3, max_len=64,
                             policy=_f32(), device="cpu", group=group, **kw)
        if not group.is_leader:
            engine.follow()
            continue
        out[f"engine_{mode}"] = _engine_run(engine, _mode_requests(mode, prompts))
    out["checked"] = _gather(checked)
    return out


def _mode_requests(mode: str, prompts: list) -> list:
    """Speculative traffic (greedy, prompt ids to draft from) or a beam
    group of 2 beside a greedy request."""
    from starvector_tpu_torch.serve.engine import Request

    if mode == "spec":
        return [Request(prefix_embeds=torch.from_numpy(p), max_new_tokens=ENGINE_NEW,
                        do_sample=False, prompt_token_ids=ids) for p, ids in zip(prompts, PROMPTS)]
    return [Request(prefix_embeds=torch.from_numpy(prompts[2]), max_new_tokens=6, num_beams=2,
                    do_sample=False),
            Request(prefix_embeds=torch.from_numpy(prompts[0]), max_new_tokens=ENGINE_NEW,
                    do_sample=False)]


def _engine_run(engine, reqs: list) -> list:
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        return [engine.result(r, timeout=120) for r in reqs]
    finally:
        engine.stop()


def _replicas_job(ckpt: str, config: str, controller_port: int, worker_port: int,
                  payloads: list) -> dict:
    """worker.main on (data 2, tensor 2), as torchrun starts it (fp32: the
    loaded model's policy made fp32): each rank reads its slices of
    `ckpt`, each data group's leader serves a ModelWorker on worker_port + d
    registered with the controller that rank 0 runs beside it, and rank 0
    sends `payloads` to the workers the controller picks. Then each leader
    is interrupted (the worker's Ctrl-C: its engine stops, its follower
    leaves follow()). Returns the texts, which worker took each request and
    the controller's models."""
    import _thread

    import torch.distributed as dist

    from starvector_tpu_torch import api
    from starvector_tpu_torch.serve import controller as ctl
    from starvector_tpu_torch.serve import worker
    from starvector_tpu_torch.serve.httpd import post_json, post_json_reply

    load = api.StarVectorForCausalLM.from_pretrained.__func__

    def fp32_load(cls, path, dtype=torch.bfloat16, device="cuda", **kw):
        model = load(cls, path, torch.float32, device, **kw)
        model.policy = _f32()
        return model

    api.StarVectorForCausalLM.from_pretrained = classmethod(fp32_load)
    rank, out = dist.get_rank(), {}
    url = f"http://127.0.0.1:{controller_port}"
    leaders = dist.new_group([0, 2])
    if rank == 0:
        controller = ctl.Controller("shortest_queue")
        cserver = ctl.build_server(controller, "127.0.0.1", controller_port)
        threading.Thread(target=cserver.serve_forever, daemon=True).start()
    dist.barrier()  # the controller is up

    def ask(i, payload, texts, served):
        served[i] = controller.get_worker_address(payload["model"])
        with post_json(served[i] + "/worker_generate_stream", payload, 120) as resp:
            texts[i] = [json.loads(c) for c in resp.read().split(b"\0") if c][-1]

    def leader():
        if rank == 0:
            deadline = time.monotonic() + 120
            while len(controller.worker_info) < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            texts, served = [None] * len(payloads), [None] * len(payloads)
            threads = [threading.Thread(target=ask, args=(i, p, texts, served))
                       for i, p in enumerate(payloads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(180)
            out.update(texts=texts, served=served,
                       models=post_json_reply(url + "/list_models", {}, 10)["models"])
        dist.barrier(group=leaders)  # rank 0's requests are answered
        _thread.interrupt_main()

    if rank in (0, 2):
        threading.Thread(target=leader, daemon=True).start()
    try:
        worker.main(["--model-path", ckpt, "--device", "cpu", "--host", "127.0.0.1",
                     "--port", str(worker_port), "--controller", url, "--serve-config", config])
    except KeyboardInterrupt:
        pass
    return out


def _stage_layout_job() -> dict:
    """A training layout on (stage 2, tensor 2): this rank's coordinates
    and the sizes of its stage and tensor groups."""
    import torch.distributed as dist

    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, zero

    layout = zero.Layout(create_mesh(MeshConfig(fsdp=1, stage=2, tensor=2)))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (layout.stage_rank, layout.tensor_group.rank,
                                   layout.batch_rank))
    return {"ranks": ranks, "stage_group": dist.get_world_size(layout.stage_group),
            "tensor_group": layout.tensor_group.size}


JOBS = {"tensor4": _tensor4_job, "replicas": _replicas_job, "stage_layout": _stage_layout_job}


# ---------------------------------------------------------------------------
# the JAX side and the one-process port (pytest process)
# ---------------------------------------------------------------------------

def _jax_tree(geometry: dict, seed: int = 0) -> dict:
    """A tiny StarCoder2 tree (numpy) with its projections x 3 and random
    biases, so that greedy output varies and a bias counted tp times shows."""
    import jax

    from starvector_tpu.models import starcoder2 as jsc

    cfg = jsc.tiny_config(**geometry)
    tree = jax.tree_util.tree_map(np.asarray, jsc.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 3.0
            p["bias"] = rng.normal(0, 0.2, p["bias"].shape).astype(np.float32)
    return tree


def _inputs(tree) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(3)
    emb = tree["embed_tokens"][rng.integers(0, 512, (2, 12))].astype(np.float32)
    return emb, rng.integers(0, 512, (2, 10)).astype(np.int64)


def _jax_scenario(tree, emb, toks) -> dict:
    """scenario() through starvector_tpu.models.starcoder2."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import decode_common as jdc
    from starvector_tpu.models import starcoder2 as jsc
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy

    f32 = JPolicy(compute_dtype=jnp.float32)
    cfg = jsc.tiny_config(**LLM)
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    mask = np.ones(emb.shape[:2], np.int32)
    mask[1, 9:] = 0
    out = {}
    cache = jsc.init_cache(cfg, 2, 24, dtype=jnp.float32)
    out["prefill"], cache = jsc.forward(p, cfg, jnp.asarray(emb), jnp.asarray(mask), cache=cache,
                                        policy=f32)
    small = cache
    x = jsc.embed_tokens(p, jnp.asarray(toks[:, :1]))
    out["decode"], cache = jsc.forward(p, cfg, x, jnp.ones((2, 1), jnp.int32), cache=cache,
                                       policy=f32)
    x = jsc.embed_tokens(p, jnp.asarray(toks[:, 1:5]))
    out["chunk"], cache = jsc.forward(p, cfg, x, jnp.ones((2, 4), jnp.int32), cache=cache,
                                      policy=f32)
    rag = jdc.insert_prefill_rows(jsc.init_ragged_cache(cfg, 3, 32, dtype=jnp.float32), small,
                                  jnp.asarray([0, 2]), jnp.asarray([12, 9], jnp.int32))
    for i, active in enumerate(([1, 0, 1], [1, 0, 0])):
        out[f"ragged{i}"], rag = jsc.forward_ragged_decode(
            p, cfg, jnp.asarray(toks[[0, 0, 1], 5 + i], jnp.int32), rag,
            jnp.asarray(active, jnp.int32), policy=f32)
    out["verify"], rag = jsc.forward_ragged_verify(
        p, cfg, jnp.asarray(toks[[0, 0, 1], 7:10], jnp.int32), rag,
        jnp.asarray([1, 0, 1], jnp.int32), policy=f32)
    return {k: np.asarray(v) for k, v in out.items()}


def _rows(name: str):
    """The rows of each output that every package computes alike: the
    ragged cache's empty row 1 and a step's inactive rows aside."""
    return {"ragged0": [0, 2], "ragged1": [0], "verify": [0, 2]}.get(name, slice(None))


def _jax_engine_ids(tree, prompts, kv) -> list[list[int]]:
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import starcoder2 as jsc
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy
    from starvector_tpu.serve.engine import Request, ServeEngine

    engine = ServeEngine(jax.tree_util.tree_map(jnp.asarray, tree), jsc.tiny_config(**LLM),
                         "starcoder2", max_batch=3, max_len=64,
                         policy=JPolicy(compute_dtype=jnp.float32), kv_cache_dtype=kv)
    reqs = [Request(prefix_embeds=p, max_new_tokens=ENGINE_NEW, do_sample=False) for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.start()
    out = []
    try:
        for r in reqs:
            while True:
                kind, payload = r.out_queue.get(timeout=120)
                if kind != "token":
                    assert kind == "done", payload
                    out.append([int(t) for t in payload])
                    break
    finally:
        engine.stop()
    return out


@pytest.fixture(scope="module")
def tensor4(tmp_path_factory):
    tree = _jax_tree(LLM)
    emb, toks = _inputs(tree)
    prompts = [tree["embed_tokens"][p][None].astype(np.float32) for p in PROMPTS]
    got = launch(HERE, "tensor4", 4, dict(tree=tree, emb=emb, toks=toks, prompts=prompts),
                 tmp_path_factory.mktemp("tensor4"))
    return tree, emb, toks, prompts, got


# ---------------------------------------------------------------------------
# the head layout and the slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_head_layout_of_the_8b(tp):
    """36 query heads over 4 KV heads: whole groups where tp divides 4; at
    tensor 8 each KV head on two ranks, its 9 query heads split 5 + 4."""
    from starvector_tpu_torch.parallel.tensor import head_layout

    heads = head_layout(36, 4, tp)
    assert len(heads) == tp
    assert sum(h.q_count for h in heads) == 36
    q = [i for h in heads for i in range(h.q_start, h.q_start + h.q_count)]
    assert q == list(range(36))  # every query head once, in order
    for h in heads:  # each rank's query heads attend to its own KV heads
        assert h.q_start // 9 >= h.kv_start and (h.q_start + h.q_count - 1) // 9 < \
            h.kv_start + h.kv_count
    if tp <= 4:
        assert {(h.q_count, h.kv_count) for h in heads} == {(36 // tp, 4 // tp)}
    else:
        assert [(h.q_count, h.kv_start) for h in heads] == [(5, 0), (4, 0), (5, 1), (4, 1),
                                                             (5, 2), (4, 2), (5, 3), (4, 3)]


def test_head_layout_uneven_and_refused():
    from starvector_tpu_torch.parallel.tensor import head_layout

    assert [(h.q_start, h.q_count, h.kv_start) for h in head_layout(6, 2, 4)] == [
        (0, 2, 0), (2, 1, 0), (3, 2, 1), (5, 1, 1)]
    for H, Hkv, tp in ((36, 4, 3), (36, 4, 6), (4, 4, 8), (6, 4, 2)):
        with pytest.raises(ValueError):
            head_layout(H, Hkv, tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_slices_are_the_jax_device_shards(tp):
    """Where tp divides the KV heads, each rank's leaf is the JAX device
    shard at its tensor coordinate (JAX's make_param_shardings on a
    (tensor tp) mesh of its CPU devices); the row-parallel kernels (o_proj,
    mlp/c_proj) are registered, nothing else."""
    import jax

    from starvector_tpu.models import starcoder2 as jsc
    from starvector_tpu.parallel import MeshConfig, create_mesh, make_param_shardings
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.sharding import _paths

    tree = _jax_tree(EVEN)
    mesh = create_mesh(MeshConfig(tensor=tp), devices=jax.devices()[:tp])
    shardings = dict(_paths(jax.tree_util.tree_map(
        lambda s: s, make_param_shardings(tree, jsc.partition_rules(), mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))))
    whole = dict(_paths(tree))
    cfg = tsc.tiny_config(**EVEN)
    for r in range(tp):
        group = tensor.TensorGroup(None, tp, r)
        local = dict(_paths(tensor.shard_tree(convert.from_jax_params(tree), tsc.partition_rules(),
                                              tsc.tensor_units(cfg, tp, r), group)))
        device = mesh.devices.reshape(-1)[r]
        for path, sharding in shardings.items():
            index = sharding.devices_indices_map(whole[path].shape)[device]
            np.testing.assert_array_equal(local[path].numpy(), whole[path][index],
                                          err_msg=f"rank {r} {path}")
            row = path.endswith(("o_proj/kernel", "c_proj/kernel"))
            assert (tensor.row_group(local[path]) is group) == row, path


def _export(tmp_path, llm: dict):
    """A tiny StarVector-8B-shaped checkpoint (SigLIP, LayerNorm adapter,
    StarCoder2 `llm`) written by train/hub.py (models/export.py), its
    projections x 3 and biases random; returns (dir, its port params, cfg)."""
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.models.vision import siglip as tsig
    from starvector_tpu_torch.train.hub import export_hf_checkpoint

    cfg = tsv.tiny_config(decoder="starcoder2", image_encoder_type="siglip_384", image_size=32,
                          adapter_norm="layer_norm", vision_tower=tsig.tiny_config(),
                          llm=tsc.tiny_config(**llm))
    params = tsv.init_params(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    for grp in params["svg_transformer"]["layers"]["attn"], \
            params["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"].mul_(3.0)
            p["bias"].normal_(0, 0.2, generator=gen)
    export_hf_checkpoint(params, cfg, build_test_tokenizer("v2"), str(tmp_path))
    return str(tmp_path), params, cfg


@pytest.mark.parametrize("tp", [2, 4])
def test_per_rank_checkpoint_load_is_the_shard_of_the_whole_load(tp, tmp_path):
    """Each rank's load through get_slice (builder.load_hf_starvector_
    checkpoint with its group) equals starvector.tensor_parallel of the
    whole load, leaf for leaf, config and row-parallel marks included; the
    tower and adapter on the leader only."""
    from starvector_tpu_torch.models import builder
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.sharding import _paths

    ckpt, _, _ = _export(tmp_path, LLM)
    params, cfg, _ = builder.load_hf_starvector_checkpoint(ckpt, torch.float32, "cpu")
    for r in range(tp):
        group = tensor.ServingGroup.of_tensor(tensor.TensorGroup(None, tp, r))
        got, got_cfg, _ = builder.load_hf_starvector_checkpoint(ckpt, torch.float32, "cpu",
                                                                group=group)
        ref, ref_cfg = tsv.serving_params(params, cfg, group)
        assert got_cfg == ref_cfg and type(got_cfg.llm) is type(ref_cfg.llm)
        got, ref = dict(_paths(got)), dict(_paths(ref))
        assert got.keys() == ref.keys()
        assert any(k.startswith("image_encoder") for k in got) == (r == 0)
        for path in ref:
            assert torch.equal(got[path], ref[path]), (r, path)
            assert (tensor.row_group(got[path]) is group.tensor) == \
                (tensor.row_group(ref[path]) is group.tensor), path


# ---------------------------------------------------------------------------
# four ranks on tensor 4
# ---------------------------------------------------------------------------

def test_tensor4_forwards_match_one_process_and_jax(tensor4):
    """Prefill (kernel 1's path, past the window), decode step (kernel 2's),
    chunk step, ragged decode and verify: rank 0's logits equal the
    one-process port's to 1e-5 and JAX's to the fp32 tolerance; the ranks
    held 2, 1, 2, 1 query heads over one KV head."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.models import starcoder2 as tsc

    tree, emb, toks, _, got = tensor4
    one = scenario(convert.from_jax_params(tree), tsc.tiny_config(**LLM), emb, toks)
    ref = _jax_scenario(tree, emb, toks)
    assert got["heads"] == (2, 1)
    assert set(got["tp"]) == set(one) == set(ref)
    for name, out in got["tp"].items():
        rows = _rows(name)
        np.testing.assert_allclose(out.numpy()[rows], one[name].numpy()[rows], **REL,
                                   err_msg=name)
        np.testing.assert_allclose(out.numpy()[rows], ref[name][rows], **LOGIT_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mutant", ["no_reduce", "bias_per_rank"])
def test_tensor4_without_the_all_reduce_or_with_a_bias_per_rank_is_wrong(tensor4, mutant):
    """The same ranks with the row-parallel products not summed, or with
    the row-parallel bias added on every rank before the sum (tp x bias):
    every output is far from the one-process port's."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.models import starcoder2 as tsc

    tree, emb, toks, _, got = tensor4
    one = scenario(convert.from_jax_params(tree), tsc.tiny_config(**LLM), emb, toks)
    for name, out in got[mutant].items():
        rows = _rows(name)
        assert (out[rows] - one[name][rows]).abs().max().item() > 1e-2, (mutant, name)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_tensor4_engine_ids_equal_the_jax_engine(tensor4, kv):
    """3 concurrent greedy requests through the tensor-4 ServeEngine (fp32
    compute) give the JAX package's unsharded ServeEngine's ids; each
    follower checked every step's tokens against its own argmax."""
    import jax.numpy as jnp

    tree, _, _, prompts, got = tensor4
    assert got[f"engine_{kv}"] == _jax_engine_ids(tree, prompts, getattr(jnp, kv))
    checked = [c[kv] for c in got["checked"][1:]]
    assert len(set(checked)) == 1 and checked[0] >= ENGINE_NEW - 1, got["checked"]


@pytest.mark.parametrize("mode", ["spec", "beam"])
def test_tensor4_speculative_and_beam_ticks_match_one_process(tensor4, mode):
    """Speculative ticks (each round's proposal and accepted counts sent to
    the followers) and a beam group beside a greedy request (each round's
    reorder and tokens) on tensor 4 give the one-process port engine's
    ids."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.serve.engine import ServeEngine

    tree, _, _, prompts, got = tensor4
    engine = ServeEngine(convert.from_jax_params(tree), tsc.tiny_config(**LLM), "starcoder2",
                         max_batch=3, max_len=64, policy=_f32(), device="cpu",
                         **({"spec_drafts": 3} if mode == "spec" else {}))
    assert got[f"engine_{mode}"] == _engine_run(engine, _mode_requests(mode, prompts))


# ---------------------------------------------------------------------------
# data 2 x tensor 2 behind the controller
# ---------------------------------------------------------------------------

def _png(rgb) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (32, 32), rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_data2_tensor2_workers_serve_the_one_process_text(tmp_path):
    """worker.main on a (data 2, tensor 2) serve config under 4 ranks: the
    two leaders register with the controller, 4 im2svg requests land on
    both, and each text is the one-process worker's for the same image
    (fp32)."""
    from test_torch_fsdp_train import reserved_ports

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.serve.worker import ModelWorker

    ckpt, _, _ = _export(tmp_path / "ckpt", LLM)
    config = tmp_path / "serve.yaml"
    config.write_text("serve:\n  mesh:\n    data: 2\n    tensor: 2\n  max_batch: 4\n"
                      "  max_len: 256\n  kv_cache_dtype: bfloat16\n")
    payloads = [{"model": "starvector", "image": _png(c), "max_new_tokens": 10,
                 "temperature": 0.0} for c in ((250, 10, 10), (10, 250, 10), (10, 10, 250),
                                               (200, 200, 30))]
    with reserved_ports() as controller, reserved_ports(2) as port:
        got = launch(HERE, "replicas", 4, dict(ckpt=ckpt, config=str(config),
                                               controller_port=controller, worker_port=port,
                                               payloads=payloads), tmp_path)
    assert set(got["served"]) == {f"http://localhost:{port}", f"http://localhost:{port + 1}"}
    assert got["models"] == ["starvector"]
    model = StarVectorForCausalLM.from_pretrained(ckpt, torch.float32, "cpu")
    model.policy = _f32()
    worker = ModelWorker(model, worker_addr="http://unused", max_batch=2, max_len=256)
    try:
        for payload, chunk in zip(payloads, got["texts"]):
            req, prompt = worker.make_request(payload)
            worker.engine.submit(req)
            ids = worker.engine.result(req, timeout=120)
            assert chunk == {"text": prompt + model.tokenizer.decode(np.asarray(ids)),
                             "error_code": 0}
    finally:
        worker.shutdown()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_cite_item_12(tmp_path):
    """A serve mesh with stage above 1 is accepted now (item 12's serving
    rest is done): serving_mesh_config gives its axes, every unnamed axis 1,
    stage beside sequence too (a training mesh's check refuses that pair),
    and a name that is no mesh axis raises ValueError. A training mesh of
    (stage 2, tensor 2) is accepted: the training mesh's check passes it,
    and 4 gloo ranks lay it out (stage coordinate, tensor rank, one batch
    coordinate; row-major over (stage, tensor)). (Sharded serving runs in
    tests/test_torch_sharded_serving.py; the 1B, an int8-weight decoder and
    use_speculative on a tensor mesh: tests/test_torch_tensor_parallel_
    rest.py; tensor-parallel training: tests/test_torch_tensor_train.py;
    pipeline parallelism: tests/test_torch_pipeline_parallel.py.)"""
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.mesh import check_training_mesh

    assert tensor.serving_mesh_config({"tensor": 2, "stage": 2}).resolve(4) == \
        (1, 1, 1, 1, 2, 2)
    assert tensor.serving_mesh_config({"stage": 2, "sequence": 2, "tensor": 2}).resolve(8) == \
        (1, 1, 1, 2, 2, 2)
    with pytest.raises(ValueError, match="nest"):
        check_training_mesh({"stage": 2, "sequence": 2})
    with pytest.raises(ValueError, match="pipeline"):
        tensor.serving_mesh_config({"pipeline": 2})
    check_training_mesh({"stage": 2, "tensor": 2})
    got = launch(HERE, "stage_layout", 4, {}, tmp_path)
    assert got["ranks"] == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert (got["stage_group"], got["tensor_group"]) == (2, 2)


def test_both_serve_configs_map_onto_their_meshes():
    """tp4dp2: tensor 4 x data 2, 64 slots (32 a replica), bf16 cache;
    tp8-int8kv: tensor 8, 16 slots, int8 cache; each mesh's head layout
    holds the 8B's heads."""
    from starvector_tpu_torch.config import load_yaml
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.parallel.tensor import serving_mesh_config
    from starvector_tpu_torch.serve.worker import serve_kwargs_from_leaf

    root = "configs/generation/serve/starvector-8b/"
    for name, axes, slots, kv, grid in (
            ("im2svg-tp4dp2.yaml", {"tensor": 4, "data": 2}, 64, None, (1, 2, 1, 1, 1, 4)),
            ("im2svg-tp8-int8kv.yaml", {"tensor": 8}, 16, torch.int8, (1, 1, 1, 1, 1, 8))):
        kw = serve_kwargs_from_leaf(load_yaml(root + name))
        assert (kw["mesh_axes"], kw["max_batch"], kw["kv_cache_dtype"]) == (axes, slots, kv)
        assert serving_mesh_config(kw["mesh_axes"]).resolve(8) == grid
    cfg = tsc.starcoder2_7b_config()
    for tp, heads in ((4, {(9, 1)}), (8, {(5, 1), (4, 1)})):
        local = [tsc.tensor_config(cfg, tp, r) for r in range(tp)]
        assert {(c.num_attention_heads, c.kv_heads) for c in local} == heads
        assert {(c.head_dim, c.intermediate_size, c.hidden_size) for c in local} == \
            {(128, 18432 // tp, 4608)}


def test_serving_mesh_fsdp_absorbs_the_ranks_left():
    """A serve leaf that does not name fsdp leaves it at -1, as the JAX
    worker's MeshConfig(**axes) does: {"tensor": 4} on 8 ranks is fsdp 2 x
    tensor 4 in both packages (it raised before), and named axes that
    cover the ranks resolve as before."""
    from starvector_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from starvector_tpu_torch.parallel.tensor import serving_mesh_config

    assert serving_mesh_config({"tensor": 4}).resolve(8) == \
        JMeshConfig(tensor=4).resolve(8) == (1, 1, 2, 1, 1, 4)
    for axes, n in (({"tensor": 4, "data": 2}, 8), ({"stage": 2, "tensor": 2}, 8),
                    ({"fsdp": 4}, 4), ({}, 1)):
        assert serving_mesh_config(axes).resolve(n) == JMeshConfig(**axes).resolve(n)


if __name__ == "__main__":
    worker_main(JOBS)
