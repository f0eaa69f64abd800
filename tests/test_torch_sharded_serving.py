"""Serving on fsdp, sequence and stage meshes, on the CPU over gloo, held to
the port's one process and to the JAX package.

A data group's ranks hold the decoder's weights as the JAX worker's
placement does (make_param_shardings on its mesh): stage blocks of the
stacked layers, fsdp shards (widened to (fsdp, sequence) where JAX widens
them), beside tensor ranges; every cached forward gathers each layer just
before it reads it. With tensor 1 a gathered weight is the whole weight bit
for bit, so the group's engine gives one process's ids and logits bit for
bit.

- each rank's shards (fp32 and int8: quantize_shards of its own fp32
  shards) are its device's shards of JAX's make_param_shardings(params,
  sv.partition_rules(), mesh) on the virtual CPU devices, on (fsdp 4),
  (fsdp 2, stage 2), (stage 2, sequence 2) and (fsdp 2, tensor 2) (the
  8B-shaped decoder, whose heads split evenly, there);
- the tiny 1B's and 8B-shaped decoder's engine ids over a bf16 and an int8
  cache (fp32 weights), on each tensor-1 mesh and on (data 2, fsdp 2) (each
  data group with its own slots), equal bit for bit one process's engine
  with the same slots and requests, and JAX's engine on the whole tree;
  int8 weights on (fsdp 4) give one process's ids too;
- on (fsdp 2, stage 2) the 1B's cached fp32 prefill is within 1e-5 of
  JAX's forward on that placement and equals one process's bit for bit;
  speculative ticks, a beam group and one use_speculative stream replay
  over the group as one process's;
- a per-rank checkpoint load on (fsdp 2, stage 2) reads the rank's shards
  alone (serving_params of the whole load), and its quantize_shards equals
  the whole load's quantize_tree cut the same way;
- worker.main with a serve leaf of (fsdp 2, stage 2) answers one HTTP
  request with one process's text.

Ranks are this file run as a script (test_torch_fsdp_train.launch): one
launch of four ranks; their code imports torch and the port only, the JAX
references and the one-process port run in the pytest process meanwhile.
"""

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

from test_torch_fsdp_train import launch, reserved_ports, worker_main  # noqa: E402
from test_torch_tensor_parallel_rest import (  # noqa: E402
    ENGINE_NEW, MIN_ELEMS, PROMPTS, _cfg, _dec, _export, _f32, _jax_engine_ids, _jax_quantized,
    _png, _table, _tree,
)

NAMES = ("gpt_bigcode", "starcoder2")
# the meshes of the four ranks, and the decoders each serves
MESHES = {
    "fsdp4": ({"fsdp": 4}, NAMES),
    "fsdp2_stage2": ({"fsdp": 2, "stage": 2}, NAMES),
    "stage2_sequence2": ({"stage": 2, "sequence": 2}, NAMES),
    "data2_fsdp2": ({"data": 2, "fsdp": 2}, ("gpt_bigcode",)),
    "fsdp2_tensor2": ({"fsdp": 2, "tensor": 2}, ("starcoder2",)),
}
SLOTS = 3
PREFILL = 70  # the 1B's prefill past the chunk step's 64 tokens: kernel 1's path
SPEC = dict(max_new_tokens=10, draft_len=3)
REQUEST = {"temperature": 0.0, "max_new_tokens": 6}


# ---------------------------------------------------------------------------
# the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _gather(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _sv_cfg(name: str):
    from starvector_tpu_torch.models import starvector as tsv

    return tsv.tiny_config(decoder=name, llm=_cfg(name))


def _numpy(tree) -> dict:
    from starvector_tpu_torch.parallel.sharding import _paths

    return {p: t.detach().float().numpy() if t.is_floating_point() else t.numpy()
            for p, t in _paths(tree)}


def _requests(prompts: list, mode: str = "plain") -> list:
    from starvector_tpu_torch.serve.engine import Request

    if mode == "beam":
        return [Request(prefix_embeds=torch.from_numpy(prompts[2]), max_new_tokens=5,
                        num_beams=2, do_sample=False),
                Request(prefix_embeds=torch.from_numpy(prompts[0]), max_new_tokens=ENGINE_NEW,
                        do_sample=False)]
    return [Request(prefix_embeds=torch.from_numpy(p), max_new_tokens=ENGINE_NEW,
                    do_sample=False, prompt_token_ids=list(ids) if mode == "spec" else None)
            for p, ids in zip(prompts, PROMPTS)]


def engine_ids(name: str, params: dict, cfg, reqs: list, slots: int = SLOTS, group=None,
               kv=None, **kw):
    """Greedy ids of `reqs` through the ServeEngine (fp32 weights); on a
    serving group the leader's, while a follower replays and returns its
    count of checked steps."""
    from starvector_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(params, cfg, name, max_batch=slots, max_len=96, policy=_f32(),
                         kv_cache_dtype=kv, device="cpu", group=group, **kw)
    if group is not None and not group.is_leader:
        engine.follow()
        return engine.checked_steps
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        return [engine.result(r, timeout=120) for r in reqs]
    finally:
        engine.stop()


def prefill_logits(params: dict, cfg, x: np.ndarray, layout=None) -> torch.Tensor:
    """The 1B's cached fp32 prefill of x (B, S, E), inside the layout's
    serve() where given."""
    import contextlib

    dec = _dec("gpt_bigcode")
    xt = torch.from_numpy(x)
    with layout.serve() if layout is not None else contextlib.nullcontext():
        cache = dec.init_cache(cfg, xt.shape[0], xt.shape[1], dtype=torch.float32)
        return dec.forward(params, cfg, xt, cache=cache, policy=_f32())[0]


def speculative(params: dict, cfg, prefix: np.ndarray, group=None):
    """One use_speculative stream: through the group's engine, or one
    process's generate_greedy_speculative."""
    from starvector_tpu_torch.generation.speculative import generate_greedy_speculative
    from starvector_tpu_torch.serve.engine import ServeEngine

    x = torch.from_numpy(prefix)
    ids = torch.tensor([[-1] * (x.shape[1] - 2) + [3, 1]])
    kw = dict(stop_sequences=(), eos_token_id=None, pad_token_id=0, **SPEC)
    if group is None:
        mask = torch.ones(x.shape[:2], dtype=torch.int32)
        out = generate_greedy_speculative(params, cfg, x, mask, ids, policy=_f32(), **kw)
    else:
        engine = ServeEngine(params, cfg, "gpt_bigcode", max_batch=1, max_len=96,
                             policy=_f32(), device="cpu", group=group)
        if not group.is_leader:
            engine.follow()
            return None
        try:
            out = engine.generate_speculative(x, ids, **kw)
        finally:
            engine.stop()
    return out[0].tolist(), int(out[1][0]), int(out[2])


def _mesh_runs(key: str, trees: dict, prompts: dict, x: np.ndarray) -> dict:
    """On MESHES[key]: each decoder's shards (fp32, then quantize_shards of
    them), its engine ids over both caches (the data group's requests), and
    on (fsdp 2, stage 2) the prefill, speculative ticks, a beam group and a
    use_speculative stream; int8 weights on (fsdp 4)."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.sharding import quantize_shards

    axes, names = MESHES[key]
    group = tensor.serving_group(axes)
    data = axes.get("data", 1)
    out = {"group": (group.size, group.rank, group.data_rank, group.tensor.rank)}
    for name in names:
        whole = {"svg_transformer": convert.from_jax_params(trees[name])}
        params, cfg = tsv.serving_params(whole, _sv_cfg(name), group)
        dec_params = params["svg_transformer"]
        out[f"{name}_shards"] = _numpy(dec_params)
        out[f"{name}_prompt_decoder"] = sorted(params.get("prompt_decoder", {}))
        mine = [p for i, p in enumerate(prompts[name]) if i % data == group.data_rank]
        for kv in ("bfloat16", "int8"):
            out[f"{name}_{kv}"] = engine_ids(name, dec_params, cfg.llm, _requests(mine),
                                             SLOTS // data + (data > 1), group,
                                             getattr(torch, kv))
        if key == "fsdp4":
            q = quantize_shards(tsv.serving_params(whole, _sv_cfg(name), group)[0]
                                ["svg_transformer"], MIN_ELEMS)
            out[f"{name}_int8_shards"] = _numpy(q)
            out[f"{name}_int8_weights"] = engine_ids(name, q, cfg.llm, _requests(mine),
                                                     group=group)
        if key == "fsdp2_stage2" and name == "gpt_bigcode":
            out["prefill"] = prefill_logits(dec_params, cfg.llm, x, group.layout)
            out["spec_ticks"] = engine_ids(name, dec_params, cfg.llm, _requests(mine, "spec"),
                                           group=group, spec_drafts=3)
            out["beam"] = engine_ids(name, dec_params, cfg.llm, _requests(mine, "beam"),
                                     group=group)
            out["speculative"] = speculative(dec_params, cfg.llm, prompts[name][0], group)
    return out


def _checkpoint_load(ckpt: str) -> dict:
    """On (fsdp 2, stage 2): whether the rank's load through get_slice
    equals serving_params of the whole load leaf for leaf, and whether its
    quantize_shards equals the whole load's quantize_tree cut as
    shard_pytree cuts it."""
    from starvector_tpu_torch.models import builder
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.ops.quantization import quantize_tree
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.sharding import _paths, quantize_shards

    group = tensor.serving_group(MESHES["fsdp2_stage2"][0])
    whole, cfg, _ = builder.load_hf_starvector_checkpoint(ckpt, torch.float32, "cpu")
    got, got_cfg, _ = builder.load_hf_starvector_checkpoint(ckpt, torch.float32, "cpu",
                                                            group=group)
    ref, ref_cfg = tsv.serving_params(whole, cfg, group)

    def same(a, b) -> bool:
        a, b = dict(_paths(a)), dict(_paths(b))
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    qwhole = {**whole, "svg_transformer": quantize_tree(whole["svg_transformer"], MIN_ELEMS,
                                                        consume=False)}
    return {"load": same(got, ref) and got_cfg == ref_cfg,
            "tower": "image_encoder" in got, "prompt_decoder": "prompt_decoder" in got,
            "quantized": same(quantize_shards(got["svg_transformer"], MIN_ELEMS),
                              tsv.serving_params(qwhole, cfg, group)[0]["svg_transformer"])}


def _worker(ckpt: str, port: int, png: str) -> str | None:
    """worker.main on a serve leaf of (fsdp 2, stage 2) (fp32: the loaded
    model's policy made fp32), as torchrun starts it: the leader answers one
    request on `port`, then is interrupted (its engine stops, its followers
    leave follow()). Returns the leader's text."""
    import _thread

    from starvector_tpu_torch import api
    from starvector_tpu_torch.serve import worker
    from starvector_tpu_torch.serve.httpd import post_json, post_json_reply

    load = api.StarVectorForCausalLM.from_pretrained.__func__

    def fp32_load(cls, path, dtype=torch.bfloat16, device="cuda", **kw):
        model = load(cls, path, torch.float32, device, **kw)
        model.policy = _f32()
        return model

    api.StarVectorForCausalLM.from_pretrained = classmethod(fp32_load)
    leaf = Path(ckpt) / "sharded.yaml"
    text = {}

    def ask():
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                post_json_reply(url + "/worker_get_status", {}, 5)
                break
            except OSError:
                time.sleep(0.05)
        with post_json(url + "/worker_generate_stream", {"image": png, **REQUEST}, 120) as resp:
            text["text"] = [json.loads(c) for c in resp.read().split(b"\0") if c][-1]["text"]
        _thread.interrupt_main()

    import torch.distributed as dist

    if dist.get_rank() == 0:
        threading.Thread(target=ask, daemon=True).start()
    try:
        worker.main(["--model-path", ckpt, "--device", "cpu", "--host", "127.0.0.1",
                     "--port", str(port), "--serve-config", str(leaf)])
    except KeyboardInterrupt:
        pass
    return text.get("text")


def _serving_job(trees: dict, prompts: dict, x: np.ndarray, ckpt: str, port: int,
                 png: str) -> dict:
    """Every mesh's runs, gathered from every rank; the checkpoint loads;
    the worker's text."""
    out = {key: _gather(_mesh_runs(key, trees, prompts, x)) for key in MESHES}
    out["loads"] = _gather(_checkpoint_load(ckpt))
    out["worker"] = _worker(ckpt, port, png)
    return out


JOBS = {"serving": _serving_job}


# ---------------------------------------------------------------------------
# the references (pytest process)
# ---------------------------------------------------------------------------

def _jax_mesh(axes: dict):
    import jax

    from starvector_tpu.parallel import MeshConfig, create_mesh

    return create_mesh(MeshConfig(**{"fsdp": 1, **axes}), devices=jax.devices()[:4])


def _jax_placed(tree: dict, axes: dict) -> dict:
    """{path: [rank r's shard of the leaf]} of the JAX worker's placement of
    the decoder tree on `axes` (devices in rank order)."""
    import jax

    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.parallel import make_param_shardings
    from starvector_tpu_torch.parallel.sharding import _paths

    mesh = _jax_mesh(axes)
    whole = {"svg_transformer": tree}
    shardings = dict(_paths(jax.tree_util.tree_map(
        lambda s: s, make_param_shardings(whole, jsv.partition_rules(), mesh),
        is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))))
    devices = mesh.devices.reshape(-1)
    leaves = dict(_paths(whole))
    return {p.removeprefix("svg_transformer/"): [
        leaves[p][s.devices_indices_map(leaves[p].shape)[d]] for d in devices]
        for p, s in shardings.items()}


def _jax_placed_logits(tree: dict, x: np.ndarray, axes: dict) -> np.ndarray:
    """JAX's 1B forward with the decoder placed on `axes` (fp32)."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy
    from starvector_tpu.parallel import make_param_shardings
    from test_torch_tensor_parallel_rest import _jcfg

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mesh = _jax_mesh(axes)
    placed = jax.tree_util.tree_map(jax.device_put, params,
                                    make_param_shardings(params, jgbc.partition_rules(), mesh))
    with jax.set_mesh(mesh):
        logits, _ = jgbc.forward(placed, _jcfg("gpt_bigcode"), jnp.asarray(x),
                                 policy=JPolicy(compute_dtype=jnp.float32))
    return np.asarray(logits)


def _one_process(refs) -> dict:
    """The port's one process on the whole trees: engine ids by (decoder,
    cache) for 3 slots and, split by data group, for the data groups'
    slots; int8-weight ids; the prefill; speculative ticks, a beam group
    and a use_speculative stream; the worker's text."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.ops.quantization import quantize_tree
    from starvector_tpu_torch.serve.httpd import post_json
    from starvector_tpu_torch.serve.worker import ModelWorker, build_server

    out = {}
    for name in NAMES:
        params, cfg = convert.from_jax_params(refs["trees"][name]), _cfg(name)
        prompts = refs["prompts"][name]
        for kv in ("bfloat16", "int8"):
            out[name, kv] = engine_ids(name, params, cfg, _requests(prompts),
                                       kv=getattr(torch, kv))
            out[name, kv, "data"] = [engine_ids(name, params, cfg, _requests(prompts[d::2]), 2,
                                                kv=getattr(torch, kv)) for d in range(2)]
        out[name, "int8_weights"] = engine_ids(name, quantize_tree(params, MIN_ELEMS,
                                                                   consume=False),
                                               cfg, _requests(prompts))
    params, cfg = convert.from_jax_params(refs["trees"]["gpt_bigcode"]), _cfg("gpt_bigcode")
    prompts = refs["prompts"]["gpt_bigcode"]
    out["prefill"] = prefill_logits(params, cfg, refs["x"])
    out["spec_ticks"] = engine_ids("gpt_bigcode", params, cfg, _requests(prompts, "spec"),
                                   spec_drafts=3)
    out["beam"] = engine_ids("gpt_bigcode", params, cfg, _requests(prompts, "beam"))
    out["speculative"] = speculative(params, cfg, prompts[0])
    model = StarVectorForCausalLM.from_pretrained(refs["ckpt"], torch.float32, "cpu")
    model.policy = _f32()
    worker = ModelWorker(model, worker_addr="http://unused", max_batch=2, max_len=256)
    server = build_server(worker, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with post_json(url + "/worker_generate_stream", {"image": refs["png"], **REQUEST},
                       120) as resp:
            out["text"] = [json.loads(c) for c in resp.read().split(b"\0") if c][-1]["text"]
    finally:
        server.shutdown()
        server.server_close()
        worker.shutdown()
    return out


def _references(refs) -> dict:
    """What the ranks are held to, computed while they run: the JAX
    engine's ids on the whole trees over both caches, the JAX placements
    (fp32 and JAX's quantize_tree), JAX's placed prefill, and the port's
    one process."""
    import jax.numpy as jnp

    placed = {}
    for key, (axes, names) in MESHES.items():
        if axes.get("data", 1) == 1:
            for name in names:
                placed[key, name] = _jax_placed(refs["trees"][name], axes)
    for name in NAMES:
        placed["fsdp4", name, "int8"] = _jax_placed(refs["qtrees"][name], MESHES["fsdp4"][0])
    return {
        "jax_engine": {(n, kv): _jax_engine_ids(n, refs["trees"][n], refs["prompts"][n],
                                                getattr(jnp, kv))
                       for n in NAMES for kv in ("bfloat16", "int8")},
        "placed": placed,
        "prefill": _jax_placed_logits(refs["trees"]["gpt_bigcode"], refs["x"],
                                      MESHES["fsdp2_stage2"][0]),
        "one": _one_process(refs),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one launch of four ranks (rank 0's gathered results) and the
    references, computed while the ranks run."""
    trees = {name: _tree(name) for name in NAMES}
    rng = np.random.default_rng(8)
    refs = dict(trees=trees, qtrees={n: _jax_quantized(t) for n, t in trees.items()},
                prompts={n: [_table(n, t)[p][None].astype(np.float32) for p in PROMPTS]
                         for n, t in trees.items()},
                x=_table("gpt_bigcode", trees["gpt_bigcode"])[
                    rng.integers(0, 512, (2, PREFILL))].astype(np.float32),
                png=_png((30, 160, 220)))
    ckpt = Path(_export(tmp_path_factory.mktemp("ckpt") / "gpt_bigcode", "gpt_bigcode"))
    (ckpt / "sharded.yaml").write_text("serve:\n  mesh:\n    fsdp: 2\n    stage: 2\n"
                                       "  max_batch: 2\n  max_len: 256\n")
    refs["ckpt"] = str(ckpt)
    box = {}

    def run():
        try:  # the leader's HTTP port stays held until the ranks end
            with reserved_ports(1) as port:
                box["got"] = launch(HERE, "serving", 4,
                                    dict(trees=trees, prompts=refs["prompts"], x=refs["x"],
                                         ckpt=str(ckpt), port=port, png=refs["png"]),
                                    tmp_path_factory.mktemp("serving"), timeout=400)
        except BaseException as e:  # noqa: BLE001 — raised below, in the fixture
            box["error"] = e

    ranks = threading.Thread(target=run)
    ranks.start()
    try:
        ref = _references(refs)
    finally:
        ranks.join()
    if "error" in box:
        raise box["error"]
    return box["got"], ref


def _leaders(got: dict, key: str) -> list:
    """The results of each data group's leader on MESHES[key], by data group."""
    return sorted((r for r in got[key] if r["group"][1] == 0), key=lambda r: r["group"][2])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["fsdp4", "fsdp2_stage2", "stage2_sequence2", "fsdp2_tensor2"])
def test_shards_are_the_jax_workers_placement(runs, key):
    """Each rank's decoder shards (stage blocks, fsdp and widened shards,
    beside tensor ranges) are its device's shards of JAX's
    make_param_shardings on the same mesh; only the leader keeps a whole
    token table beside its shard (the prompt's embeddings)."""
    got, ref = runs
    for name in MESHES[key][1]:
        want = ref["placed"][key, name]
        for r, rank in enumerate(got[key]):
            mine = rank[f"{name}_shards"]
            assert mine.keys() == want.keys()
            for path, shards in want.items():
                np.testing.assert_array_equal(mine[path], shards[r],
                                              err_msg=f"{key} {name} rank {r} {path}")
            assert rank[f"{name}_prompt_decoder"] == \
                (["wte" if name == "gpt_bigcode" else "embed_tokens"]
                 if rank["group"][1] == 0 and MESHES[key][0].get("fsdp", 1) > 1 else [])


def test_quantized_shards_are_the_whole_quantize_trees(runs):
    """quantize_shards of each rank's fp32 shards on (fsdp 4): its codes
    are its device's shards of JAX's quantize_tree placed by the JAX rules,
    and its scales the whole scales (no rule names them), bit for bit."""
    got, ref = runs
    for name in NAMES:
        want = ref["placed"]["fsdp4", name, "int8"]
        for r, rank in enumerate(got["fsdp4"]):
            mine = rank[f"{name}_int8_shards"]
            assert mine.keys() == want.keys()
            assert any(p.endswith("kernel_q") for p in mine)
            for path, shards in want.items():
                np.testing.assert_array_equal(mine[path], shards[r],
                                              err_msg=f"{name} rank {r} {path}")


@pytest.mark.parametrize("key", ["fsdp4", "fsdp2_stage2", "stage2_sequence2", "data2_fsdp2",
                                 "fsdp2_tensor2"])
def test_engine_ids_are_one_process_and_jax(runs, key):
    """The group's engine over a bf16 and an int8 cache: each data group's
    leader's ids equal one process's engine with the same slots and
    requests bit for bit, and JAX's engine on the whole tree; every
    follower checked every greedy step against its own argmax."""
    got, ref = runs
    axes, names = MESHES[key]
    for name in names:
        for kv in ("bfloat16", "int8"):
            leaders = _leaders(got, key)
            if axes.get("data", 1) > 1:
                by_group = ref["one"][name, kv, "data"]
                assert [lead[f"{name}_{kv}"] for lead in leaders] == by_group
                merged = [by_group[i % 2][i // 2] for i in range(len(PROMPTS))]
                assert merged == ref["jax_engine"][name, kv]
            else:
                assert leaders[0][f"{name}_{kv}"] == ref["one"][name, kv]
                assert ref["one"][name, kv] == ref["jax_engine"][name, kv]
            assert all(r[f"{name}_{kv}"] > 0 for r in got[key] if r["group"][1] != 0)


def test_int8_weights_serve_as_one_process(runs):
    """Both decoders' int8 weights (quantize_shards) on (fsdp 4): the
    engine's ids equal one process's on the whole tree's quantize_tree."""
    got, ref = runs
    for name in NAMES:
        assert _leaders(got, "fsdp4")[0][f"{name}_int8_weights"] == ref["one"][name, "int8_weights"]


def test_stage_fsdp_prefill_and_engine_paths(runs):
    """On (fsdp 2, stage 2): the 1B's cached prefill (kernel 1's path) on
    every rank is one process's bit for bit and within 1e-5 of JAX's
    forward on that placement; speculative ticks, a beam group beside a
    greedy request and one use_speculative stream give one process's ids
    (and the stream its forward count)."""
    got, ref = runs
    for rank in got["fsdp2_stage2"]:
        assert torch.equal(rank["prefill"], ref["one"]["prefill"])
    np.testing.assert_allclose(got["fsdp2_stage2"][0]["prefill"].numpy(), ref["prefill"],
                               rtol=1e-5, atol=1e-5)
    lead = _leaders(got, "fsdp2_stage2")[0]
    for what in ("spec_ticks", "beam", "speculative"):
        assert lead[what] == ref["one"][what], what


def test_per_rank_checkpoint_load(runs):
    """Each rank's load on (fsdp 2, stage 2) through get_slice equals
    serving_params of the whole load (config included), the tower and a
    whole token table on the leader alone; its quantize_shards equals the
    whole load's quantize_tree cut the same way."""
    got, _ = runs
    for r, load in enumerate(got["loads"]):
        assert load == {"load": True, "tower": r == 0, "prompt_decoder": r == 0,
                        "quantized": True}, r


def test_worker_main_serves_a_fsdp_leaf(runs):
    """worker.main with a serve leaf of (fsdp 2, stage 2) under four ranks
    answers one image request with the one-process worker's text."""
    got, ref = runs
    assert got["worker"] == ref["one"]["text"]
    assert got["worker"].startswith("<svg")


if __name__ == "__main__":
    worker_main(JOBS)
