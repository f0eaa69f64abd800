"""Tensor-parallel serving of StarVector-1B, of int8-weight decoders and of
`use_speculative`, on the CPU over gloo, held to the port's one process and
to the JAX package.

- the 1B's real geometry at tensor 2, 4 and 8: each rank's c_attn is its
  query heads' columns and then all 256 KV columns, its attn/c_proj rows
  the same heads, c_fc / mlp c_proj an even split (no weights);
- a tiny 1B (hidden 128, 8 heads over one KV head, as tests/test_parallel.py's
  sharded forward) on tensor 2 and 4: the cached prefill, a decode step, a
  chunk step, ragged decode steps and a ragged verify within 1e-5 of one
  port process; the prefill's logits within 2e-4 of JAX's forward on its
  (data 2, fsdp 2, tensor 2) mesh; the tensor group's engine ids equal the
  JAX engine's over a bf16 and an int8 cache;
- int8 weights: a rank's codes and scales are the slices of JAX's whole
  quantize_tree (column leaves cut with their scales, row leaves with their
  scales whole); a row-parallel int8 dense equals one process's, where a
  mutant that rounds each rank's partial or adds the bias on every rank
  does not; both decoders' int8 forwards on tensor 2 and 4 within 1e-5 of
  one process, and their engine ids equal JAX's generate on JAX's
  quantize_tree; a per-rank --quantize load (a MAX all-reduce of each
  row-parallel column's maximum) equals the whole quantized load's slices
  bit for bit, and quantizing a rank's rows alone does not;
- `use_speculative` through worker.main on a serve leaf of two tensor-2
  replicas, a tiny 1B and a tiny 8B-shaped checkpoint: the text of the
  one-process worker, and the ids and forward count of JAX's
  generate_greedy_speculative.

Ranks are this file run as a script (test_torch_fsdp_train.launch), one
launch of four: tensor 4, then (data 2, tensor 2); their code imports
torch and the port only, the JAX references run in the pytest process.
"""

import base64
import dataclasses
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

from test_torch_fsdp_train import launch, reserved_ports, worker_main  # noqa: E402

# a tiny 1B: 8 query heads over one KV head (G = 4 a rank on tensor 2, 2 on
# tensor 4), head size 16
ONE_B = dict(hidden_size=128, n_head=8)
# a tiny 8B-shaped decoder: 6 query heads over 2 KV heads, a window of 8
LLM = dict(num_attention_heads=6, num_key_value_heads=2, hidden_size=96, intermediate_size=128,
           sliding_window=8)
PREFILL = {"gpt_bigcode": 70, "starcoder2": 12}  # past the chunk step's 64 / the window of 8
REL = dict(rtol=1e-5, atol=1e-5)        # a tensor group against one process, fp32
SHARDED = dict(rtol=2e-4, atol=2e-4)    # against JAX's sharded forward (tests/test_parallel.py)
MIN_ELEMS = 1 << 10                     # quantize every projection of the tiny decoders
ENGINE_NEW = 8
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6, 5, 3], [2, 7, 1, 8, 2])
SPEC = dict(max_new_tokens=12, draft_len=4)


# ---------------------------------------------------------------------------
# the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _f32():
    from starvector_tpu_torch.ops.layers import DTypePolicy

    return DTypePolicy(torch.float32, torch.float32)


def _dec(name: str):
    from starvector_tpu_torch.models import gpt_bigcode, starcoder2

    return {"gpt_bigcode": gpt_bigcode, "starcoder2": starcoder2}[name]


def _cfg(name: str):
    dec = _dec(name)
    return dec.tiny_config(**(ONE_B if name == "gpt_bigcode" else LLM))


def scenario(name: str, params: dict, cfg, emb: np.ndarray, toks: np.ndarray) -> dict:
    """The decoder's cached forwards on `params` (whole, or a tensor rank's
    with its cfg), fp32: a prefill of PREFILL[name] tokens (row 1
    right-padded by 9), a decode step, a chunk step of 4; then the ragged
    cache with the prefill in rows 0 and 2 of 3, two ragged decode steps
    and a ragged verify of 3 tokens. Returns each one's logits."""
    from starvector_tpu_torch.models import decode_common as dc

    dec, f32 = _dec(name), _f32()
    emb, toks = torch.from_numpy(emb), torch.from_numpy(toks)
    P = emb.shape[1]
    mask = torch.ones(emb.shape[:2], dtype=torch.int32)
    mask[1, P - 9:] = 0
    out = {}
    cache = dec.init_cache(cfg, 2, P + 12, dtype=torch.float32)
    out["prefill"], cache = dec.forward(params, cfg, emb, mask, cache=cache, policy=f32)
    small = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()}
    out["decode"], cache = dec.forward(params, cfg, dec.embed_tokens(params, toks[:, :1]),
                                       torch.ones((2, 1), dtype=torch.int32), cache=cache,
                                       policy=f32)
    out["chunk"], cache = dec.forward(params, cfg, dec.embed_tokens(params, toks[:, 1:5]),
                                      torch.ones((2, 4), dtype=torch.int32), cache=cache,
                                      policy=f32)
    rag = dec.init_ragged_cache(cfg, 3, P + 20, dtype=torch.float32)
    dc.insert_prefill_rows(rag, small, torch.tensor([0, 2]), torch.tensor([P, P - 9]))
    for i, active in enumerate(([1, 0, 1], [1, 0, 0])):
        out[f"ragged{i}"], rag = dec.forward_ragged_decode(
            params, cfg, toks[[0, 0, 1], 5 + i], rag, torch.tensor(active, dtype=torch.int32),
            policy=f32)
    out["verify"], rag = dec.forward_ragged_verify(params, cfg, toks[[0, 0, 1], 7:10], rag,
                                                   policy=f32)
    return out


def _engine_ids(name: str, params: dict, cfg, prompts: list, group=None, kv=None):
    """Greedy ids of `prompts` through the ServeEngine (fp32; on a tensor
    group the leader's, a follower replays and returns its checked steps)."""
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(params, cfg, name, max_batch=3, max_len=96, policy=_f32(),
                         kv_cache_dtype=kv, device="cpu", group=group)
    if group is not None and not group.is_leader:
        engine.follow()
        return engine.checked_steps
    reqs = [Request(prefix_embeds=torch.from_numpy(p), max_new_tokens=ENGINE_NEW, do_sample=False)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        return [engine.result(r, timeout=120) for r in reqs]
    finally:
        engine.stop()


def _gather(obj) -> list:
    import torch.distributed as dist

    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, obj)
    return box


def _row_dense(group) -> dict:
    """A row-parallel int8 dense on this rank's rows against one process's,
    in fp32 and bf16, with two mutants: each rank's partial rounded to the
    compute dtype before the sum, and the bias added on every rank."""
    from starvector_tpu_torch.ops.layers import DTypePolicy, dense
    from starvector_tpu_torch.ops.quantization import quant_matmul, quantize_dense
    from starvector_tpu_torch.parallel.tensor import even_split, register_row

    g = torch.Generator().manual_seed(9)
    K, N = 256, 96
    w, bias, x = torch.randn(K, N, generator=g), torch.randn(N, generator=g), \
        torch.randn(8, K, generator=g)
    p = quantize_dense({"kernel": w, "bias": bias})
    start, n = even_split(K, group.size, group.rank)
    q = register_row(p["kernel_q"][start:start + n].clone(), group)
    local = {"kernel_q": q, "scale": p["scale"], "bias": bias}
    xr = x[:, start:start + n]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        out[f"one_{key}"] = dense(p, x, DTypePolicy(dtype, dtype))
        out[f"tp_{key}"] = dense(local, xr, DTypePolicy(dtype, dtype))
        y = quant_matmul(xr.to(dtype), q, p["scale"], None, out_dtype=dtype)
        out[f"round_per_rank_{key}"] = (group.all_reduce(y.float()) + bias).to(dtype)
        y = quant_matmul(xr.to(dtype), q, p["scale"], bias, out_dtype=torch.float32)
        out[f"bias_per_rank_{key}"] = group.all_reduce(y).to(dtype)
    return out


def _quantized_loads(ckpts: dict, group) -> dict:
    """Each decoder's per-rank load (its slices through get_slice)
    quantized by quantize_slices, against shard_tree of the whole load's
    quantize_tree, leaf for leaf; the same slices quantized by rank alone
    (quantize_tree of the rank's tree); and, for the 1B, from_pretrained
    (quantize=True, group=group) at the default threshold. Returns, by
    name, whether each equals the whole tree's slices."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import builder
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.ops.quantization import quantize_tree
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.sharding import _paths

    def same(a, b, marks: bool = True) -> bool:
        a, b = dict(_paths(a)), dict(_paths(b))
        return a.keys() == b.keys() and all(
            torch.equal(a[k], b[k]) and (not marks or (tensor.row_group(a[k]) is None)
                                         == (tensor.row_group(b[k]) is None)) for k in a)

    def whole_slices(whole, cfg, min_elems):
        q = {**whole, "svg_transformer": quantize_tree(whole["svg_transformer"], min_elems,
                                                       consume=False)}
        return tsv.serving_params(q, cfg, group)[0]["svg_transformer"]

    def rank_load(ckpt):
        return builder.load_hf_starvector_checkpoint(ckpt, torch.float32, "cpu",
                                                     group=group)[0]["svg_transformer"]

    out = {}
    for name, ckpt in ckpts.items():
        whole, cfg, _ = builder.load_hf_starvector_checkpoint(ckpt, torch.float32, "cpu")
        rules = cfg.decoder_module.partition_rules()
        ref = whole_slices(whole, cfg, MIN_ELEMS)
        every = [cfg.decoder_module.tensor_units(cfg.llm, group.size, r)
                 for r in range(group.size)]
        out[f"{name}_per_rank_load"] = same(
            tensor.quantize_slices(rank_load(ckpt), rules, every, group.tensor, MIN_ELEMS), ref)
        out[f"{name}_rows_alone"] = same(quantize_tree(rank_load(ckpt), MIN_ELEMS), ref,
                                         marks=False)
        model = StarVectorForCausalLM.from_pretrained(ckpt, torch.float32, "cpu", quantize=True,
                                                      group=group)
        out[f"{name}_from_pretrained"] = same(model.params["svg_transformer"],
                                              whole_slices(whole, cfg, 1 << 16))
        out[f"{name}_from_pretrained_int8"] = sum(
            k.endswith("kernel_q") for k, _ in _paths(model.params["svg_transformer"]))
    return out


def _speculative_workers(ckpts: dict, port: int, png: str) -> dict:
    """worker.main on each checkpoint's serve leaf (data 2 x tensor 2; fp32:
    the loaded model's policy made fp32), as torchrun starts it: each data
    group's leader answers one use_speculative request on port + d, then
    is interrupted (its engine stops, its follower leaves follow()).
    Returns the texts by data group and rank 0's (tokens, lengths,
    n_forwards) of its engine's speculative call."""
    import _thread

    import torch.distributed as dist

    from starvector_tpu_torch import api
    from starvector_tpu_torch.serve import engine as eng
    from starvector_tpu_torch.serve import worker
    from starvector_tpu_torch.serve.httpd import post_json, post_json_reply

    load = api.StarVectorForCausalLM.from_pretrained.__func__

    def fp32_load(cls, path, dtype=torch.bfloat16, device="cuda", **kw):
        model = load(cls, path, torch.float32, device, **kw)
        model.policy = _f32()
        return model

    api.StarVectorForCausalLM.from_pretrained = classmethod(fp32_load)
    spec = eng.generate_greedy_speculative
    calls = []

    def recorded(*a, **kw):
        res = spec(*a, **kw)
        calls.append((res[0].clone(), res[1].clone(), res[2]))
        return res

    eng.generate_greedy_speculative = recorded
    rank, out = dist.get_rank(), {}
    leaders = dist.new_group([0, 2])
    for name, ckpt in ckpts.items():
        texts = {}

        def ask(d: int):
            url = f"http://127.0.0.1:{port + d}"
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                try:
                    post_json_reply(url + "/worker_get_status", {}, 5)
                    break
                except OSError:
                    time.sleep(0.05)
            payload = {"image": png, "use_speculative": True, "temperature": 0.0, **SPEC}
            with post_json(url + "/worker_generate_stream", payload, 120) as resp:
                texts[d] = [json.loads(c) for c in resp.read().split(b"\0") if c][-1]
            dist.barrier(group=leaders)  # both leaders are answered
            _thread.interrupt_main()

        if rank in (0, 2):
            threading.Thread(target=ask, args=(rank // 2,), daemon=True).start()
        try:
            worker.main(["--model-path", ckpt, "--device", "cpu", "--host", "127.0.0.1",
                         "--port", str(port), "--serve-config", str(Path(ckpt) / "serve.yaml")])
        except KeyboardInterrupt:
            pass
        out[name] = [t for box in _gather(texts) for t in box.values()]
        if rank == 0:
            out[f"{name}_call"] = calls.pop()
    return out


def _tensor_runs(group, trees: dict, qtrees: dict, emb: dict, toks: dict, prompts: dict,
                 sharded, ckpts: dict) -> dict:
    """On `group`: the 1B scenario and the sharded-forward input's prefill,
    the 1B engine over a bf16 and an int8 cache, each decoder's int8
    scenario and engine ids, the per-rank quantized loads. Returns this
    rank's results (a leader's; a follower's checked steps), with every
    rank's load checks and checked steps gathered."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.parallel import tensor

    out, checked = {"heads": {}}, {}
    for name in ("gpt_bigcode", "starcoder2"):
        dec, cfg = _dec(name), _cfg(name)
        rcfg = dec.tensor_config(cfg, group.size, group.rank)
        units = dec.tensor_units(cfg, group.size, group.rank)
        out["heads"][name] = (rcfg.n_head if name == "gpt_bigcode" else
                              rcfg.num_attention_heads, rcfg.kv_heads)
        variants = [("int8", qtrees[name])] + ([("fp32", trees[name])]
                                               if name == "gpt_bigcode" else [])
        for label, tree in variants:
            params = tensor.shard_tree(convert.from_jax_params(tree), dec.partition_rules(),
                                       units, group.tensor)
            out[f"{name}_{label}"] = scenario(name, params, rcfg, emb[name], toks[name])
            kvs = ("bfloat16", "int8") if label == "fp32" else ("bfloat16",)
            for kv in kvs:
                ids = _engine_ids(name, params, rcfg, prompts[name], group,
                                  torch.int8 if kv == "int8" else None)
                if group.is_leader:
                    out[f"{name}_{label}_engine_{kv}"] = ids
                else:
                    checked[f"{name}_{label}_{kv}"] = ids
            if label == "fp32":
                x = torch.from_numpy(sharded)
                cache = dec.init_cache(rcfg, x.shape[0], x.shape[1], dtype=torch.float32)
                out["sharded"] = dec.forward(params, rcfg, x, cache=cache, policy=_f32())[0]
    out["loads"] = _gather(_quantized_loads(ckpts, group))
    out["checked"] = _gather(checked)
    return out


def _tensor_job(port: int, png: str, **refs) -> dict:
    """Four ranks: the runs of _tensor_runs on tensor 4, then on the two
    tensor-2 groups of (data 2, tensor 2) (each on the same inputs); on
    those, the row-parallel int8 dense and the speculative workers.
    Returns rank 0's results by tensor size."""
    from starvector_tpu_torch.parallel import tensor

    out = {tp: _tensor_runs(tensor.serving_group(axes), **refs)
           for tp, axes in ((4, {"tensor": 4}), (2, {"data": 2, "tensor": 2}))}
    group = tensor.serving_group({"data": 2, "tensor": 2})
    out[2]["row_dense"] = _row_dense(group.tensor)
    out[2]["workers"] = _speculative_workers(refs["ckpts"], port, png)
    return out


JOBS = {"tensor": _tensor_job}


# ---------------------------------------------------------------------------
# the JAX side and the one-process port (pytest process)
# ---------------------------------------------------------------------------

def _jmod(name: str):
    from starvector_tpu.models import gpt_bigcode, starcoder2

    return {"gpt_bigcode": gpt_bigcode, "starcoder2": starcoder2}[name]


def _jcfg(name: str):
    return _jmod(name).tiny_config(**(ONE_B if name == "gpt_bigcode" else LLM))


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def _tree(name: str, seed: int = 0) -> dict:
    """A tiny decoder tree in the layout both packages share (numpy), drawn
    by the port, its projections x 3 and random biases, so that greedy
    output varies and a bias counted tp times shows."""
    tree = _numpy(_dec(name).init_params(_cfg(name), torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 3.0
            p["bias"] = rng.normal(0, 0.2, p["bias"].shape).astype(np.float32)
    return tree


def _jax_quantized(tree: dict) -> dict:
    import jax

    from starvector_tpu.ops.quantization import quantize_tree

    return jax.tree_util.tree_map(np.asarray, quantize_tree(
        jax.tree_util.tree_map(jax.numpy.asarray, tree), MIN_ELEMS, consume=False))


def _table(name: str, tree: dict) -> np.ndarray:
    return tree["wte" if name == "gpt_bigcode" else "embed_tokens"]


def _inputs(name: str, tree: dict):
    rng = np.random.default_rng(3)
    vocab = _table(name, tree).shape[0]
    emb = _table(name, tree)[rng.integers(0, vocab, (2, PREFILL[name]))].astype(np.float32)
    return emb, rng.integers(0, vocab, (2, 10)).astype(np.int64)


def _rows(name: str):
    """The rows every package computes alike: the ragged cache's empty row
    1 and a step's inactive rows aside."""
    return {"ragged0": [0, 2], "ragged1": [0], "verify": [0, 2]}.get(name, slice(None))


def _jax_engine_ids(name: str, tree: dict, prompts: list, kv) -> list[list[int]]:
    import jax
    import jax.numpy as jnp

    from starvector_tpu.ops.layers import DTypePolicy as JPolicy
    from starvector_tpu.serve.engine import Request, ServeEngine

    engine = ServeEngine(jax.tree_util.tree_map(jnp.asarray, tree), _jcfg(name), name,
                         max_batch=3, max_len=96, policy=JPolicy(compute_dtype=jnp.float32),
                         kv_cache_dtype=kv)
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


def _jax_generate_ids(name: str, tree: dict, prompts: list) -> list[list[int]]:
    """The JAX package's offline greedy ids of the (equally long) prompts
    as one batch, fp32."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.generation import engine as jengine
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy

    x = np.concatenate(prompts)
    gen = jengine.GenerationConfig(max_new_tokens=ENGINE_NEW, do_sample=False, pad_token_id=0,
                                   min_new_tokens=ENGINE_NEW)
    toks, _ = jengine.generate(jax.tree_util.tree_map(jnp.asarray, tree), _jcfg(name), name,
                               jnp.asarray(x), jnp.ones(x.shape[:2], jnp.int32), gen,
                               jax.random.PRNGKey(0), policy=JPolicy(compute_dtype=jnp.float32))
    return np.asarray(toks).tolist()


def _jax_sharded_logits(tree: dict, x: np.ndarray) -> np.ndarray:
    """JAX's gbc.forward of the 1B on its (data 2, fsdp 2, tensor 2) mesh
    (tests/test_parallel.py::test_sharded_forward_matches_single_device)."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy
    from starvector_tpu.parallel import MeshConfig, create_mesh, make_param_shardings
    from starvector_tpu.parallel.mesh import batch_sharding

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mesh = create_mesh(MeshConfig(data=2, fsdp=2, tensor=2))
    sp = jax.tree_util.tree_map(jax.device_put, params,
                                make_param_shardings(params, jgbc.partition_rules(), mesh))
    sx = jax.device_put(jnp.asarray(x), batch_sharding(mesh, extra_dims=2))
    with jax.set_mesh(mesh):
        logits, _ = jgbc.forward(sp, _jcfg("gpt_bigcode"), sx,
                                 policy=JPolicy(compute_dtype=jnp.float32))
    return np.asarray(logits)


def _png(rgb) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (32, 32), rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _export(path: Path, name: str) -> str:
    """A tiny StarVector checkpoint of `name`'s decoder (the 1B: CLIP at 28
    px; the 8B-shaped: SigLIP at 32 px, LayerNorm adapter) written by
    train/hub.py, its projections x 3 and biases random, and a tensor-2
    serve leaf beside it (serve.yaml)."""
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.models.vision import siglip as tsig
    from starvector_tpu_torch.train.hub import export_hf_checkpoint

    if name == "gpt_bigcode":
        cfg = tsv.tiny_config(llm=_cfg(name))
    else:
        cfg = tsv.tiny_config(decoder="starcoder2", image_encoder_type="siglip_384",
                              image_size=32, adapter_norm="layer_norm",
                              vision_tower=tsig.tiny_config(), llm=_cfg(name))
    params = tsv.init_params(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    for grp in params["svg_transformer"]["layers"]["attn"], \
            params["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"].mul_(3.0)
            p["bias"].normal_(0, 0.2, generator=gen)
    export_hf_checkpoint(params, cfg, build_test_tokenizer("v1" if name == "gpt_bigcode"
                                                           else "v2"), str(path))
    (path / "serve.yaml").write_text("serve:\n  mesh:\n    data: 2\n    tensor: 2\n"
                                     "  max_batch: 2\n  max_len: 256\n"
                                     "  kv_cache_dtype: bfloat16\n")
    return str(path)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The launch's inputs: each decoder's tree and JAX's
    quantize_tree of it, the scenario's inputs, the engine prompts, the
    sharded forward's input, the exported checkpoints and an image."""
    trees = {name: _tree(name) for name in ("gpt_bigcode", "starcoder2")}
    qtrees = {name: _jax_quantized(t) for name, t in trees.items()}
    inputs = {name: _inputs(name, t) for name, t in trees.items()}
    prompts = {name: [_table(name, t)[p][None].astype(np.float32) for p in PROMPTS]
               for name, t in trees.items()}
    rng = np.random.default_rng(4)
    sharded = _table("gpt_bigcode", trees["gpt_bigcode"])[
        rng.integers(0, 512, (4, PREFILL["gpt_bigcode"]))].astype(np.float32)
    root = tmp_path_factory.mktemp("ckpts")
    ckpts = {name: _export(root / name, name) for name in trees}
    return dict(trees=trees, qtrees=qtrees, emb={k: v[0] for k, v in inputs.items()},
                toks={k: v[1] for k, v in inputs.items()}, prompts=prompts, sharded=sharded,
                ckpts=ckpts, png=_png((250, 40, 10)))


def _speculative_refs(name: str, refs) -> dict:
    """For `name`'s checkpoint, fp32: the one-process worker's text for the
    use_speculative payload, and the ids, length and forward count of the
    port's and of JAX's generate_greedy_speculative on its prefix."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.generation import speculative as jspec
    from starvector_tpu.ops.layers import DTypePolicy as JPolicy
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.generation.speculative import generate_greedy_speculative
    from starvector_tpu_torch.serve.worker import ModelWorker

    model = StarVectorForCausalLM.from_pretrained(refs["ckpts"][name], torch.float32, "cpu")
    model.policy = _f32()
    worker = ModelWorker(model, worker_addr="http://unused", max_batch=1, max_len=256)
    payload = {"image": refs["png"], "use_speculative": True, "temperature": 0.0, **SPEC}
    try:
        text = worker.generate_speculative(payload)
        prefix, _, ids = worker._prefix_for(payload)
    finally:
        worker.shutdown()
    mask = torch.ones(prefix.shape[:2], dtype=torch.int32)
    tok = model.tokenizer
    kw = dict(stop_sequences=(tuple(tok.stop_sequence_ids("</svg>")),),
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, **SPEC)
    tokens, lengths, n_fwd = generate_greedy_speculative(
        model.params["svg_transformer"], model.cfg.llm, prefix, mask, ids, policy=_f32(), **kw)
    jtype = type(_jcfg(name))
    jcfg = jtype(**{f.name: getattr(model.cfg.llm, f.name) for f in dataclasses.fields(jtype)
                    if hasattr(model.cfg.llm, f.name)})
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     model.params["svg_transformer"])
    ref, ref_len, ref_fwd = jspec.generate_greedy_speculative(
        jparams, jnp.asarray(prefix.numpy()), jnp.asarray(mask.numpy()),
        jnp.asarray(ids.numpy(), jnp.int32), dec_name=name, llm_cfg=jcfg,
        policy=JPolicy(compute_dtype=jnp.float32), **kw)
    return dict(text=text, one=(tokens, int(lengths[0]), n_fwd),
                jax=(np.asarray(ref), int(ref_len[0]), int(ref_fwd)))


def _references(refs) -> dict:
    """What the ranks are held to, computed in this process while they run:
    the JAX engine's 1B ids over both caches, JAX's generate on its
    quantize_tree of each decoder, JAX's sharded 1B forward, and the
    speculative references."""
    import jax.numpy as jnp

    name = "gpt_bigcode"
    return {
        "engine": {kv: _jax_engine_ids(name, refs["trees"][name], refs["prompts"][name],
                                       getattr(jnp, kv)) for kv in ("bfloat16", "int8")},
        "int8_ids": {n: _jax_generate_ids(n, refs["qtrees"][n], refs["prompts"][n])
                     for n in refs["qtrees"]},
        "sharded": _jax_sharded_logits(refs["trees"][name], refs["sharded"]),
        "speculative": {n: _speculative_refs(n, refs) for n in refs["ckpts"]},
    }


@pytest.fixture(scope="module")
def launches(refs, tmp_path_factory):
    """Rank 0's results of the one launch of four ranks, by tensor size,
    and the references (_references), computed while the ranks run."""
    box = {}

    def run():
        try:  # the two leaders' HTTP ports stay held until the ranks end
            with reserved_ports(2) as port:
                box["got"] = launch(HERE, "tensor", 4, dict(refs, port=port),
                                    tmp_path_factory.mktemp("tensor"), timeout=400)
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
    return {**box["got"], "ref": ref}


@pytest.fixture(params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, launches):
    return request.param, launches[request.param], launches["ref"]


def _one(name: str, tree: dict, refs) -> dict:
    from starvector_tpu_torch.models import convert

    return scenario(name, convert.from_jax_params(tree), _cfg(name), refs["emb"][name],
                    refs["toks"][name])


# ---------------------------------------------------------------------------
# the 1B's layout (no weights)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4, 8])
def test_1b_rank_layout(tp):
    """StarVector-1B's GPTBigCode (2048 x 24, 16 query heads over one KV
    head of 128) on tensor tp: c_attn's columns are the rank's 16 / tp
    query heads and then all 256 KV columns, attn/c_proj's rows the same
    heads, c_fc's columns and mlp/c_proj's rows an even 1/tp of 8192; the
    rank's config holds 16 / tp heads of 128 over the one KV head, a query
    width of 2048 / tp and the whole residual width."""
    from starvector_tpu_torch.models import gpt_bigcode as tgbc
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.parallel.tensor import leaf_slice

    cfg = tsv.starvector_1b_config().llm
    rules = tgbc.partition_rules()
    q_cols = []
    for r in range(tp):
        units = tgbc.tensor_units(cfg, tp, r)
        q = (r * 2048 // tp, 2048 // tp)
        mlp = (r * 8192 // tp, 8192 // tp)
        want = {"layers/attn/c_attn/kernel": (2, (q, (2048, 256))),
                "layers/attn/c_attn/kernel_q": (2, (q, (2048, 256))),
                "layers/attn/c_attn/bias": (1, (q, (2048, 256))),
                "layers/attn/c_proj/kernel": (1, (q,)),
                "layers/attn/c_proj/bias": None,
                "layers/mlp/c_fc/kernel": (2, (mlp,)),
                "layers/mlp/c_fc/bias": (1, (mlp,)),
                "layers/mlp/c_proj/kernel_q": (1, (mlp,)),
                "layers/ln_1/scale": None, "wte": None}
        for path, cut in want.items():
            ndim = 3 if path.endswith(("kernel", "kernel_q")) else 2
            assert leaf_slice(path, ndim, rules, units) == cut, (r, path)
        rcfg = tgbc.tensor_config(cfg, tp, r)
        assert (rcfg.n_head, rcfg.head_dim, rcfg.n_head * rcfg.head_dim, rcfg.kv_heads) == \
            (16 // tp, 128, 2048 // tp, 1)
        assert (rcfg.hidden_size, rcfg.inner_dim, rcfg.n_layer) == (2048, 8192 // tp, 24)
        q_cols += list(range(q[0], q[0] + q[1]))
    assert q_cols == list(range(2048))


# ---------------------------------------------------------------------------
# the int8 slices (no collective)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
@pytest.mark.parametrize("tp", [2, 4])
def test_quantized_slices_are_the_whole_quantize_trees(refs, name, tp):
    """shard_tree of the port's quantize_tree: each rank's codes are the
    slice of JAX's whole quantize_tree's codes by the kernel's ranges; a
    column-split leaf's scales are cut with its columns, a row-split
    leaf's stay whole, and only the row-split codes are registered
    row-parallel."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.ops.quantization import quantize_tree
    from starvector_tpu_torch.parallel import tensor

    dec, cfg = _dec(name), _cfg(name)
    jq = refs["qtrees"][name]
    ours = quantize_tree(convert.from_jax_params(refs["trees"][name]), MIN_ELEMS)
    rows = ("o_proj", "c_proj")  # the row-parallel projections of both decoders
    for r in range(tp):
        group = tensor.TensorGroup(None, tp, r)
        units = dec.tensor_units(cfg, tp, r)
        local = tensor.shard_tree(ours, dec.partition_rules(), units, group)
        for part in ("attn", "mlp"):
            for proj, whole in jq["layers"][part].items():
                mine = local["layers"][part][proj]
                unit = units.get(f"{part}/{proj}", units.get(proj))
                ranges = (unit,) if isinstance(unit[0], int) else unit
                row = proj in rows
                codes = np.concatenate([whole["kernel_q"][:, s:s + n] if row else
                                        whole["kernel_q"][:, :, s:s + n] for s, n in ranges],
                                       axis=1 if row else 2)
                scale = whole["scale"] if row else np.concatenate(
                    [whole["scale"][:, s:s + n] for s, n in ranges], axis=1)
                np.testing.assert_array_equal(mine["kernel_q"].numpy(), codes, err_msg=proj)
                np.testing.assert_array_equal(mine["scale"].numpy(), scale, err_msg=proj)
                assert (tensor.row_group(mine["kernel_q"]) is group) == row, proj


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def test_1b_tensor_forwards_match_one_process_and_jax(ranks, refs):
    """The tiny 1B on tensor 2 and 4 (4 and 2 query heads a rank over the
    KV head): prefill (kernel 1's path), decode step (kernel 2's), chunk
    step, ragged decode and verify within 1e-5 of one port process; the
    prefill of 4 rows of 70 tokens within 2e-4 of JAX's forward on its
    (data 2, fsdp 2, tensor 2) mesh."""
    tp, got, ref = ranks
    name = "gpt_bigcode"
    assert got["heads"][name] == (8 // tp, 1)
    one = _one(name, refs["trees"][name], refs)
    assert set(got[f"{name}_fp32"]) == set(one)
    for key, out in got[f"{name}_fp32"].items():
        rows = _rows(key)
        np.testing.assert_allclose(out.numpy()[rows], one[key].numpy()[rows], **REL, err_msg=key)
    np.testing.assert_allclose(got["sharded"].numpy(), ref["sharded"], **SHARDED)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_1b_tensor_engine_ids_equal_the_jax_engine(ranks, kv):
    """3 concurrent greedy requests through the 1B's tensor-group engine
    (fp32 compute) over a bf16-named and an int8 cache give the JAX
    package's unsharded ServeEngine's ids; every follower checked each
    step's tokens against its own argmax."""
    tp, got, ref = ranks
    name = "gpt_bigcode"
    assert got[f"{name}_fp32_engine_{kv}"] == ref["engine"][kv]
    key = f"{name}_fp32_{kv}"
    checked = [c[key] for c in got["checked"] if key in c]
    assert len(checked) == 4 - 4 // tp and min(checked) >= ENGINE_NEW - 1, got["checked"]


@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
def test_int8_tensor_forward_matches_one_process_and_ids_equal_jax(ranks, refs, name):
    """An int8-weight decoder of each family (every projection quantized,
    the ranks' slices of the whole quantize_tree) on tensor 2 and 4: the
    forwards within 1e-5 of one port process on the same codes, and the
    engine's greedy ids equal to the JAX package's generate on JAX's
    quantize_tree of the same weights."""
    from starvector_tpu_torch.models import convert
    from starvector_tpu_torch.ops.quantization import quantize_tree

    _, got, ref = ranks
    one = scenario(name, quantize_tree(convert.from_jax_params(refs["trees"][name]), MIN_ELEMS),
                   _cfg(name), refs["emb"][name], refs["toks"][name])
    for key, out in got[f"{name}_int8"].items():
        rows = _rows(key)
        np.testing.assert_allclose(out.numpy()[rows], one[key].numpy()[rows], **REL, err_msg=key)
    assert got[f"{name}_int8_engine_bfloat16"] == ref["int8_ids"][name]


def test_per_rank_quantized_load_equals_the_whole_quantized_slices(ranks):
    """Each rank's load of its slices, quantized with each row-parallel
    column's maximum over the group, equals the whole quantized load's
    slices bit for bit, for both decoders (and from_pretrained(quantize=
    True) on a tensor group, the 1B at the default threshold, which
    quantizes its c_fc and mlp/c_proj); the same slices quantized by each
    rank's rows alone differ."""
    _, got, _ = ranks
    assert len(got["loads"]) == 4
    for r, loads in enumerate(got["loads"]):
        for name in ("gpt_bigcode", "starcoder2"):
            assert loads[f"{name}_per_rank_load"], (r, name)
            assert not loads[f"{name}_rows_alone"], (r, name)
            assert loads[f"{name}_from_pretrained"], (r, name)
        assert loads["gpt_bigcode_from_pretrained_int8"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_int8_dense_matches_one_process(launches, dtype):
    """On tensor 2, a row-parallel int8 dense (kernel 14's fp32 partial, the
    all-reduce in fp32, the bias once, one rounding) equals one process's:
    within 1e-6 of the output's largest magnitude in fp32 (the two sum the
    256 products in another order), the same bf16 values in bf16 (but where
    the fp32 sums part on a rounding boundary). Adding the bias on every
    rank is wrong in both; rounding each rank's partial shows in bf16."""
    d = launches[2]["row_dense"]
    one, mine = d[f"one_{dtype}"].float(), d[f"tp_{dtype}"].float()
    assert (d[f"bias_per_rank_{dtype}"].float() - one).abs().max() > 0.5
    if dtype == "float32":
        assert (mine - one).abs().max() <= 1e-6 * one.abs().max()
        return
    assert (mine != one).float().mean() <= 0.01
    assert (d[f"round_per_rank_{dtype}"].float() != one).float().mean() >= 0.1


@pytest.mark.parametrize("name", ["gpt_bigcode", "starcoder2"])
def test_use_speculative_on_a_tensor_worker(launches, name):
    """worker.main on a serve leaf of two tensor-2 replicas answers a
    use_speculative request on each with the one-process worker's text;
    the group's speculative call gave the ids, length and forward count of
    JAX's generate_greedy_speculative (and the port's one process) on the
    same prefix, with drafts accepted."""
    ref = launches["ref"]["speculative"][name]
    got = launches[2]["workers"]
    assert got[name] == [{"text": ref["text"], "error_code": 0}] * 2
    tokens, lengths, n_fwd = got[f"{name}_call"]
    jtokens, n, jfwd = ref["jax"]
    np.testing.assert_array_equal(tokens.numpy()[0, :n], jtokens[0, :n])
    np.testing.assert_array_equal(ref["one"][0].numpy()[0, :n], jtokens[0, :n])
    assert int(lengths[0]) == n == ref["one"][1]
    assert n_fwd == jfwd == ref["one"][2] < 1 + SPEC["max_new_tokens"]  # drafts accepted


if __name__ == "__main__":
    worker_main(JOBS)
