"""The port's mesh and partition rules against the JAX package's, the
stage axis in train.main and the refusals of what it does not execute, and
each reduction that a
rank-local step needs to equal the JAX package's global one.

Specs: `MeshConfig.resolve` and every leaf's spec from
`apply_partition_rules` equal starvector_tpu's (JAX on its 8-device CPU
platform, spec computation only) for a tiny 1B, a tiny 8B-shaped model and
the other towers, on the meshes (fsdp 8), (data 2, fsdp 4),
(replica 2, fsdp 2, tensor 2) and (fsdp 4, sequence 2); each module's
rule list is the JAX one verbatim.

Reductions: one run of 2 gloo ranks on (fsdp 2) (this file as a script,
test_torch_fsdp_train.launch; the worker imports torch and the port only)
computes, for each place where a rank-local computation parts from the
global one, the sharded result against the one-process result on the whole
input, and what the rank-local computation without its collective gives;
each test holds the first to 1e-5 and the second to be wrong. A run of 4
ranks on (fsdp 2, sequence 2) does the same for each reduction that the
sequence axis changes, the wrong one being that reduction over the wrong
ranks, and shards the 1B's and 8B's trees, which must be the JAX
package's device shards.
"""

import contextlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fsdp_train import launch, worker_main

HERE = Path(__file__).resolve()
MESHES = {"fsdp8": dict(fsdp=8), "data2_fsdp4": dict(data=2, fsdp=4),
          "replica2_fsdp2_tensor2": dict(replica=2, fsdp=2, tensor=2),
          "fsdp4_sequence2": dict(fsdp=4, sequence=2), "fsdp2_sequence2": dict(fsdp=2, sequence=2)}
EXACT = 1e-5     # sharded against one process, relative to the result's scale
WRONG = 1e-3     # the rank-local result without its collective is off by more


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------

def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _reductions_job() -> dict:
    """Each check: (error of the sharded computation, error of the
    rank-local one without the collective), the larger over the ranks."""
    import torch.distributed as dist

    from starvector_tpu_torch.models import adapter, gpt_bigcode
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.ops.layers import DTypePolicy, dropout
    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, shard_pytree, zero
    from starvector_tpu_torch.train import optim
    from starvector_tpu_torch.train.step import loss_and_grads, mark_trainable

    layout = zero.Layout(create_mesh(MeshConfig(fsdp=2)))
    rank, n = layout.batch_rank, layout.batch
    f32 = DTypePolicy(torch.float32, torch.float32)
    rng = np.random.RandomState(0)  # the same draws on every rank
    out = {}

    def rows(t: torch.Tensor) -> torch.Tensor:
        return t.chunk(n)[rank]

    def record(name, sharded, local):
        pair = torch.tensor([sharded, local], dtype=torch.float64)
        dist.all_reduce(pair, op=dist.ReduceOp.MAX)
        out[name] = pair.tolist()

    # --- the loss's denominator: unequal counts of targets on the ranks
    B, S, E, V = 4, 9, 16, 32
    hidden = torch.tensor(rng.standard_normal((B, S, E)), dtype=torch.float32)
    table = torch.tensor(rng.standard_normal((V, E)), dtype=torch.float32)
    labels = torch.tensor(rng.randint(0, V, (B, S)))
    labels[0, 3:], labels[1, 8:], labels[3, 5:] = -100, -100, -100
    h = hidden.clone().requires_grad_(True)
    ref = gpt_bigcode.causal_lm_loss_fused(table, h, labels, policy=f32, chunk=4)
    ref.backward()
    hr = rows(hidden).clone().requires_grad_(True)
    with layout.step():
        mine = gpt_bigcode.causal_lm_loss_fused(table, hr, rows(labels), policy=f32, chunk=4)
        total = zero.batch_sum(mine.detach())
    mine.backward()
    local = gpt_bigcode.causal_lm_loss_fused(table, rows(hidden), rows(labels), policy=f32,
                                             chunk=4)
    record("loss", max(_err(total, ref), _err(hr.grad, rows(h.grad))),
           _err(zero.Layout.batch_sum(layout, local.detach()) / n, ref))

    # --- the BatchNorm adapter: statistics, running statistics, gradients
    acfg = adapter.AdapterConfig(input_size=8, output_size=16, query_length=6,
                                 adapter_norm="batch_norm")
    params = adapter.init_params(acfg, torch.Generator().manual_seed(1))
    params["norm"]["scale"] += torch.tensor(rng.standard_normal(6) * 0.1, dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((B, 6, 8)) * 2 + 1, dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((B, 6, 16)), dtype=torch.float32)
    full = optim.tree_map(torch.clone, params)
    for k in ("c_fc", "c_proj"):
        for t in full[k].values():
            t.requires_grad_(True)
    for k in ("scale", "bias"):
        full["norm"][k].requires_grad_(True)
    xf = x.clone().requires_grad_(True)
    y, stats = adapter.forward_with_stats(full, acfg, xf, policy=f32)
    leaves = [p for p in optim.tree_leaves(full) if p.requires_grad]
    (y * w).sum().backward()
    shards = shard_pytree(params, adapter.partition_rules(), layout)
    for p in optim.tree_leaves(shards):
        p.requires_grad_(True)
    for k in ("running_mean", "running_var"):
        shards["norm"][k].requires_grad_(False)
    wrt = [p for p in optim.tree_leaves(shards) if p.requires_grad]
    xr = rows(x).clone().requires_grad_(True)
    with layout.step():
        yr, stats_r = adapter.forward_with_stats(shards, acfg, xr, policy=f32)
        grads = torch.autograd.grad((yr * rows(w)).sum(), wrt + [xr])
    local_grads = [g.clone() for g in grads[:-1]]
    zero.reduce_grads(wrt, grads[:-1])
    whole = [zero.full_tree(zero.register_like(g, p)) for g, p in zip(grads[:-1], wrt)]
    y_local = adapter.forward_with_stats(params, acfg, rows(x), policy=f32)[0]
    record("batch_norm", max([_err(yr, rows(y)), _err(grads[-1], rows(xf.grad))]
                             + [_err(stats_r[k], stats[k]) for k in stats]
                             + [_err(g, p.grad) for g, p in zip(whole, leaves)]),
           _err(y_local, rows(y)))

    # --- gradients of leaves whole on every rank: summed over the batch ranks
    replicated = [i for i, p in enumerate(wrt) if zero.sharded(p) is None]
    assert replicated
    record("replicated_grads", max(_err(grads[i], leaves[i].grad) for i in replicated),
           max(_err(local_grads[i], leaves[i].grad) for i in replicated))

    # --- the global norm over shards
    norm = optim.global_norm(list(grads[:-1]), wrt)
    ref_norm = optim.global_norm([p.grad for p in leaves])
    record("global_norm", _err(norm, ref_norm), _err(optim.global_norm(list(grads[:-1])), ref_norm))

    # --- Adafactor over shards: factored moments and the block-RMS clip
    shapes = {"a": ((256, 128), 0), "b": ((2, 128, 256), 1)}  # split on d0; on d1, by layer
    whole_p = {k: torch.tensor(rng.standard_normal(s) * 0.05, dtype=torch.float32)
               for k, (s, _) in shapes.items()}
    gs = [{k: torch.tensor(rng.standard_normal(s) * scale, dtype=torch.float32)
           for k, (s, _) in shapes.items()} for scale in (1e-3, 1e-1)]

    def shard_of(t, dim):
        return t.chunk(layout.fsdp, dim)[layout.fsdp_rank].clone() if dim is not None else t

    def run_adafactor(ps, grads_of, dims):
        tx = optim.build_optimizer(ps, optimizer="adafactor", lr=1e-2, warmup_steps=0,
                                   total_steps=10)
        st = tx.init(ps)
        for g in grads_of:
            tx.update({k: shard_of(v, dims[k]) for k, v in g.items()}, st, ps)
        return st

    ref_p = {k: v.clone() for k, v in whole_p.items()}
    ref_st = run_adafactor(ref_p, gs, {k: None for k in shapes})
    split = {k: d for k, (_, d) in shapes.items()}
    sh_p = {k: zero.register(shard_of(v, split[k]), zero.Shard(layout, split[k], tuple(v.shape)))
            for k, v in whole_p.items()}
    sh_st = run_adafactor(sh_p, gs, split)
    loc_p = {k: shard_of(v, split[k]) for k, v in whole_p.items()}
    loc_st = run_adafactor(loc_p, gs, split)

    def factored(st, gather):
        return [gather(t) if gather else t for key in ("v_row", "v_col") for t in st[key]]

    def ref_slice(t, like):
        info = zero.info_of(like)
        return t if info.dim is None else t.chunk(layout.fsdp, info.dim)[layout.fsdp_rank]

    got = factored(sh_st, lambda t: zero.full_tree(t))
    record("adafactor_factored", max(_err(a, b) for a, b in zip(got, factored(ref_st, None))),
           max(_err(a, ref_slice(b, s)) if a is not None and a.shape == ref_slice(b, s).shape
               else 1.0  # the shard factors otherwise, or not at all
               for a, b, s in zip(factored(loc_st, None), factored(ref_st, None),
                                  factored(sh_st, None))))
    record("adafactor_block_rms",
           max(_err(zero.full_tree(sh_p[k]), ref_p[k]) for k in shapes),
           max(_err(loc_p[k], shard_of(ref_p[k], shapes[k][1])) for k in shapes))

    # --- dropout: the global batch's mask, this rank's rows
    xd = torch.tensor(rng.standard_normal((B, 5, 7)), dtype=torch.float32)
    ref_d = dropout(xd, 0.5, torch.Generator().manual_seed(11))
    with layout.step():
        mine_d = dropout(rows(xd), 0.5, torch.Generator().manual_seed(11))
    local_d = dropout(rows(xd), 0.5, torch.Generator().manual_seed(11))
    record("dropout", _err(mine_d, rows(ref_d)), _err(local_d, rows(ref_d)))

    # --- ZeRO-3 memory: no gathered weight outlives its use in the forward
    cfg = tsv.tiny_config(adapter_norm="batch_norm")
    model = mark_trainable(shard_pytree(tsv.init_params(cfg, torch.Generator().manual_seed(2)),
                                        tsv.partition_rules(), layout))
    batch = {"image": torch.tensor(rng.standard_normal((2, 28, 28, 3)), dtype=torch.float32),
             "svg_ids": torch.tensor(rng.randint(1, 512, (2, 12))),
             "svg_mask": torch.ones((2, 12), dtype=torch.int32)}
    table = tuple(zero.full_shape(model["svg_transformer"]["wte"]))
    alive = {}
    for mode in (False, True, "dots_flash", "dots"):
        for hooks in (True, False):
            with layout.step():
                if hooks:
                    loss, _ = tsv.loss_fn_with_bn_stats(model, cfg, batch, 0, policy=f32,
                                                        remat=mode)
                else:  # an inner pair of hooks that keeps what autograd saves
                    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
                        loss, _ = tsv.loss_fn_with_bn_stats(model, cfg, batch, 0, policy=f32,
                                                            remat=mode)
                kept = [tuple(t.shape) for t in zero._GATHERED.keys()]
                torch.autograd.grad(loss, [p for p in optim.tree_leaves(model)
                                           if p.requires_grad])
            del loss
            alive[(str(mode), hooks)] = kept
    out["alive"] = alive
    out["table"] = table

    # --- bf16: dense kernels gathered in the compute dtype, gradients in fp32
    bf16 = DTypePolicy(torch.float32, torch.bfloat16)
    whole = mark_trainable(tsv.init_params(cfg, torch.Generator().manual_seed(2)))
    ref_loss, _, ref_grads = loss_and_grads(whole, cfg, batch, 0, policy=bf16, remat=False)
    loss, _, grads = loss_and_grads(model, cfg, {k: rows(v) for k, v in batch.items()}, 0,
                                    policy=bf16, remat=False)
    out["bf16"] = max([_err(loss, ref_loss)] + [
        _err(g, r) for g, r in zip(optim.tree_leaves(zero.full_tree(grads)),
                                   optim.tree_leaves(ref_grads))])
    return out


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _flipped(fn):
    """fn run with the active step's sequence split taken the other way:
    the reduction over the wrong ranks."""
    def run(layout, *args):
        layout.seq_split = not layout.seq_split
        try:
            return fn(layout, *args)
        finally:
            layout.seq_split = not layout.seq_split

    return run


def _seq_reductions_job(trees: dict) -> dict:
    """4 ranks on (fsdp 2, sequence 2), batch coordinate = rank // 2: each
    check as (error of the sharded computation, error with the reduction
    over the wrong ranks), the larger over the ranks, under "seq_*"; and
    every rank's shards of `trees` ("shards": per rank, {path: shard})."""
    import torch.distributed as dist

    from starvector_tpu_torch.models import adapter
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.ops.layers import DTypePolicy, dropout
    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, shard_pytree, zero
    from starvector_tpu_torch.train import optim
    from starvector_tpu_torch.train.step import loss_and_grads, mark_trainable

    layout = zero.Layout(create_mesh(MeshConfig(fsdp=2, sequence=2)))
    rank, n = layout.batch_rank, layout.batch
    f32 = DTypePolicy(torch.float32, torch.float32)
    rng = np.random.RandomState(1)  # the same draws on every rank
    out = {}

    def rows(t: torch.Tensor) -> torch.Tensor:
        return t.chunk(n)[rank]

    def record(name, sharded, wrong):
        pair = torch.tensor([sharded, wrong], dtype=torch.float64)
        dist.all_reduce(pair, op=dist.ReduceOp.MAX)
        out["seq_" + name] = pair.tolist()

    # --- BatchNorm statistics span the batch ranks, not the sequence peers
    acfg = adapter.AdapterConfig(input_size=8, output_size=16, query_length=6,
                                 adapter_norm="batch_norm")
    params = adapter.init_params(acfg, torch.Generator().manual_seed(1))
    x = torch.tensor(rng.standard_normal((4, 6, 8)) * 2 + 1, dtype=torch.float32)
    y, stats = adapter.forward_with_stats(params, acfg, x, policy=f32)

    def batch_norm() -> float:
        with layout.step():
            yr, stats_r = adapter.forward_with_stats(params, acfg, rows(x), policy=f32)
        return max([_err(yr, rows(y))] + [_err(stats_r[k], stats[k]) for k in stats])

    good = batch_norm()
    with _patched(layout, "batch_group", dist.group.WORLD):
        record("batch_norm", good, batch_norm())

    # --- dropout: the sequence peers draw the same rows
    xd = torch.tensor(rng.standard_normal((4, 5, 7)), dtype=torch.float32)
    ref_d = dropout(xd, 0.5, torch.Generator().manual_seed(11))

    def drop() -> float:
        with layout.step():
            return _err(dropout(rows(xd), 0.5, torch.Generator().manual_seed(11)), rows(ref_d))

    good = drop()
    with _patched(layout, "batch_rank", dist.get_rank()), \
            _patched(layout, "batch", dist.get_world_size()):
        record("dropout", good, drop())

    # --- the count of targets and the gradients: over batch x sequence in a
    # step with the split (17 + 47 positions), over the batch ranks without
    # it (17 + 46); the error is the largest over the loss and every
    # gradient, relative to the largest gradient
    cfg = tsv.tiny_config(adapter_norm="batch_norm")
    whole = mark_trainable(tsv.init_params(cfg, torch.Generator().manual_seed(3)))
    shards = mark_trainable(shard_pytree(tsv.init_params(cfg, torch.Generator().manual_seed(3)),
                                         tsv.partition_rules(), layout))
    for S, tag in ((47, "split"), (46, "nosplit")):
        mask = (np.arange(S)[None, :] < np.asarray([S, S - 7, S - 30, S - 2])[:, None])
        batch = {"image": torch.tensor(rng.standard_normal((4, 28, 28, 3)), dtype=torch.float32),
                 "svg_ids": torch.tensor(np.where(mask, rng.randint(1, 512, (4, S)), 0)),
                 "svg_mask": torch.tensor(mask.astype(np.int32))}
        ref_loss, _, ref_grads = loss_and_grads(whole, cfg, batch, 0, policy=f32, remat=False)
        ref_leaves = optim.tree_leaves(ref_grads)
        scale = max(float(g.abs().max()) for g in ref_leaves)

        def step() -> float:
            loss, _, grads = loss_and_grads(shards, cfg, {k: rows(v) for k, v in batch.items()},
                                            0, policy=f32, remat=False)
            got = optim.tree_leaves(zero.full_tree(grads))
            return max([_err(loss, ref_loss)] + [float((g - r).abs().max()) / scale
                                                 for g, r in zip(got, ref_leaves)])

        good = step()
        out[f"seq_split_{tag}"] = layout.seq_split
        with _patched(zero.Layout, "batch_sum", _flipped(zero.Layout.batch_sum)):
            record(f"count_{tag}", good, step())
        real = zero.reduce_grads
        with _patched(zero, "reduce_grads", lambda ps, gs: _flipped(
                lambda lay: real(ps, gs))(layout)):
            record(f"grads_{tag}", good, step())

    # --- ZeRO over sequence: the global norm and Adafactor's reductions over
    # a leaf widened to fsdp x sequence span its 4 ranks; registered as a
    # fsdp leaf (its sums over fsdp alone) they do not
    _, parts, index = layout.split(True)
    shapes = {"a": ((256, 128), 0), "b": ((2, 128, 256), 1)}  # split on d0; on d1, by layer
    whole_p = {k: torch.tensor(rng.standard_normal(s) * 0.05, dtype=torch.float32)
               for k, (s, _) in shapes.items()}
    gs = [{k: torch.tensor(rng.standard_normal(s) * scale, dtype=torch.float32)
           for k, (s, _) in shapes.items()} for scale in (1e-3, 1e-1)]
    split = {k: d for k, (_, d) in shapes.items()}

    def part(t, dim):
        return t if dim is None else t.chunk(parts, dim)[index].clone()

    def adafactor(ps, dims):
        tx = optim.build_optimizer(ps, optimizer="adafactor", lr=1e-2, warmup_steps=0,
                                   total_steps=10)
        st = tx.init(ps)
        for g in gs:
            tx.update({k: part(v, dims[k]) for k, v in g.items()}, st, ps)
        return st

    ref_p = {k: v.clone() for k, v in whole_p.items()}
    ref_st = adafactor(ref_p, dict.fromkeys(shapes))
    ref_norm = optim.global_norm(list(gs[1].values()))
    errs = {}
    for wide in (True, False):
        sh_p = {k: zero.register(part(v, split[k]), zero.Shard(layout, split[k], tuple(v.shape),
                                                               wide))
                for k, v in whole_p.items()}
        st = adafactor(sh_p, split)
        moments = [(t, r) for key in ("v_row", "v_col") for t, r in zip(st[key], ref_st[key])]
        errs[wide] = (
            _err(optim.global_norm([part(v, split[k]) for k, v in gs[1].items()],
                                   list(sh_p.values())), ref_norm),
            max(_err(t, part(r, None if zero.info_of(t).dim is None else zero.info_of(t).dim))
                for t, r in moments),
            max(_err(sh_p[k], part(ref_p[k], split[k])) for k in shapes))
    for i, name in enumerate(("global_norm", "adafactor_factored", "adafactor_block_rms")):
        record(name, errs[True][i], errs[False][i])

    # --- every rank's shards of the 1B's and 8B's trees, by _flat's paths
    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {p: v for k, t in tree.items() for p, v in flat(t, prefix + (k,)).items()}
        return {prefix: tree.detach()}

    mine = {model: flat(shard_pytree(tree, tsv.partition_rules(), layout))
            for model, tree in trees.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out["shards"] = every
    return out


def _stage_main_job(yaml_path: str, out_dir: str) -> dict:
    """train.main for one step on the yaml's stage mesh, then the tiny 1B's
    tree through sv.shard_params (shard_pytree with the model's tensor
    units) on that mesh: the steps whose loss was
    logged and this rank's and the whole stack's layer counts."""
    import json

    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, zero
    from starvector_tpu_torch.parallel.mesh import mesh_config_from
    from starvector_tpu_torch.train.train import main

    config = get_config([f"config={yaml_path}", "training.steps=1"],
                        default_path=resolve_repo_config())
    main(config)
    layout = zero.Layout(create_mesh(MeshConfig(**vars(mesh_config_from(config)))))
    cfg = tsv.tiny_config()
    params = tsv.init_params(cfg, torch.Generator().manual_seed(0))
    stack = tsv.shard_params(params, cfg, layout)["svg_transformer"]["layers"]
    scale = stack["ln_1"]["scale"]
    steps = [r["step"] for r in map(json.loads, open(Path(out_dir) / "metrics.jsonl"))
             if "loss" in r]
    return {"steps": steps, "layers": (scale.shape[0], zero.full_shape(scale)[0])}


JOBS = {"reductions": _reductions_job, "seq_reductions": _seq_reductions_job,
        "stage_main": _stage_main_job}


if __name__ == "__main__":
    worker_main(JOBS)


@pytest.fixture(scope="module")
def reductions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reductions")
    trees = {model: _trees(model)[1] for model in ("1b", "8b")}
    return {**launch(HERE, "reductions", 2, {}, tmp),
            **launch(HERE, "seq_reductions", 4, dict(trees=trees), tmp)}


def _held(reductions, name):
    sharded, local = reductions[name]
    assert sharded <= EXACT, (name, sharded)
    assert local > WRONG, (name, local)


def test_loss_denominator_is_the_global_batch(reductions):
    """causal_lm_loss_fused divides by the global batch's count of
    targets: the ranks' losses (rows with 3 + 9 and 9 + 5 targets) add up
    to the one-process loss, and each row's gradient is its one-process
    gradient; a mean of the ranks' own means is not the loss."""
    _held(reductions, "loss")


def test_batch_norm_statistics_span_the_batch_ranks(reductions):
    """The BatchNorm adapter's statistics over (batch, D) are the global
    batch's in the forward and its backward: each rank's rows of the output,
    the new running statistics (equal on every rank), the input's and every
    parameter's gradient equal one process's on the whole batch; the
    ranks' own statistics give another output."""
    _held(reductions, "batch_norm")


def test_replicated_leaf_gradients_are_summed_over_batch_ranks(reductions):
    """A leaf that no rank splits (biases, the norm, dims the mesh does not
    divide) has the gradient of the whole batch: the sum over the batch
    ranks of each rank's, not its own."""
    _held(reductions, "replicated_grads")


def test_global_norm_spans_the_shards(reductions):
    """global_norm over the reduced shards (and the whole leaves, once)
    is the whole gradient's norm; over the local shards alone it is not."""
    _held(reductions, "global_norm")


def test_adafactor_factored_moments_span_the_shards(reductions):
    """Adafactor's row and column means over a leaf split on its largest
    dim (a 256 x 128 leaf) and on its second (a stacked 2 x 128 x 256 leaf,
    a layer at a time) equal the whole leaf's after two updates; the
    shard's own factoring and means do not."""
    _held(reductions, "adafactor_factored")


def test_block_rms_clip_spans_the_shards(reductions):
    """clip_by_block_rms (binding at the second update, whose gradients are
    100x the first's) and the parameter's block RMS take the whole leaf's
    sums of squares: the sharded parameters after two updates equal the
    whole ones; the shard's own do not."""
    _held(reductions, "adafactor_block_rms")


@pytest.mark.parametrize("name", ["batch_norm", "dropout"])
def test_sequence_peers_share_batch_statistics_and_dropout_rows(reductions, name):
    """On (fsdp 2, sequence 2) the BatchNorm statistics and the dropout
    rows span the batch ranks only: the sequence peers hold the same rows,
    so the statistics summed over them too, or rows drawn by the global
    rank, give another output."""
    _held(reductions, "seq_" + name)


@pytest.mark.parametrize("which", ["count", "grads"])
@pytest.mark.parametrize("split", ["split", "nosplit"])
def test_count_and_gradients_span_sequence_only_with_the_split(reductions, which, split):
    """On (fsdp 2, sequence 2), the tiny 1B's loss and every gradient (a
    row a rank) equal one process's on the 4 rows: with the split (17 + 47
    positions) the count of targets and the gradients sum over batch x
    sequence, without it (17 + 46) over the batch ranks, where each
    sequence peer's gradients are copies. Either sum over the other ranks
    (the count, or the gradients) gives another loss or gradient."""
    assert reductions[f"seq_split_{split}"] is (split == "split")
    _held(reductions, f"seq_{which}_{split}")


@pytest.mark.parametrize("name", ["global_norm", "adafactor_factored", "adafactor_block_rms"])
def test_widened_leaf_reductions_span_fsdp_and_sequence(reductions, name):
    """A leaf widened over (fsdp, sequence) (ZeRO over sequence), split in
    4 on its largest dim (256 x 128) and on its second (2 x 128 x 256, a
    layer at a time): the global norm and Adafactor's factored moments and
    block-RMS clip after two updates equal the whole leaf's; sums over the
    fsdp ranks alone do not."""
    _held(reductions, "seq_" + name)


def test_dropout_draws_the_global_rows(reductions):
    """On a layout the dropout mask is the global batch's, drawn from the
    one generator state, and each rank takes its rows: N ranks drop what
    one process drops; a rank drawing its own shape does not."""
    _held(reductions, "dropout")


@pytest.mark.parametrize("remat", ["False", "True", "dots_flash", "dots"])
def test_gathered_weights_are_not_kept_for_the_backward(reductions, remat):
    """After the sharded forward of the tiny 1B, no gathered weight is
    alive but the tied head table, which the fused loss's checkpoint holds
    as its input: the layers' gathers are re-run in the backward (inside
    the checkpoints) or kept as shards (Layout.step's saved-tensor hooks).
    With those hooks overridden, remat=False keeps every layer's."""
    alive = reductions["alive"]
    assert set(alive[(remat, True)]) <= {reductions["table"]}, alive[(remat, True)]
    if remat == "False":
        assert len(alive[(remat, False)]) > 4, alive[(remat, False)]


def test_bf16_gathers_match_one_process(reductions):
    """Under a bf16 policy the dense kernels are gathered in bf16 (the cast
    the model makes anyway) and their gradients reduce-scattered in fp32:
    the loss and every gradient of the sharded tiny 1B (fsdp 2, a row
    each) equal one process's on both rows within bf16 rounding (2e-2 of
    each leaf's largest gradient)."""
    assert reductions["bf16"] <= 2e-2, reductions["bf16"]


# ---------------------------------------------------------------------------
# the mesh and the specs against the JAX package (no ranks)
# ---------------------------------------------------------------------------

def test_mesh_config_resolves_as_jax():
    from starvector_tpu.parallel.mesh import MeshConfig as JMesh
    from starvector_tpu_torch.parallel.mesh import MeshConfig as TMesh

    cases = [(dict(), 8), (dict(data=2, fsdp=4), 8), (dict(replica=2, fsdp=2, tensor=2), 8),
             (dict(fsdp=4, sequence=2), 8), (dict(data=-1, fsdp=2), 4), (dict(), 1),
             (dict(fsdp=-1, data=-1), 8), (dict(fsdp=3), 8), (dict(fsdp=4), 8)]
    for kw, n in cases:
        try:
            ref = JMesh(**kw).resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                TMesh(**kw).resolve(n)
        else:
            assert TMesh(**kw).resolve(n) == ref, kw


def _jax_mesh(axes: dict):
    """The JAX mesh over the first devices of the 8 that it covers."""
    import jax

    from starvector_tpu.parallel import MeshConfig, create_mesh

    return create_mesh(MeshConfig(**axes), devices=jax.devices()[:math.prod(axes.values())])


def _trees(model: str):
    """(JAX params as numpy, the port's tree of the same weights)."""
    import dataclasses

    import jax

    from starvector_tpu.models import starcoder2 as jsc
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.vision import convnext as jcn
    from starvector_tpu.models.vision import open_clip_vit as joc
    from starvector_tpu.models.vision import siglip as jsig
    from starvector_tpu.models.vision import vqgan as jvq
    from starvector_tpu_torch.models import convert

    if model == "1b":
        cfg = jsv.tiny_config(adapter_norm="batch_norm",
                              llm=dataclasses.replace(jsv.tiny_config().llm, hidden_size=128,
                                                      n_head=4))
    elif model == "8b":
        cfg = jsv.tiny_config(decoder="starcoder2", image_encoder_type="siglip_384",
                              image_size=32, adapter_norm="layer_norm",
                              vision_tower=jsig.tiny_config(hidden_size=64),
                              llm=jsc.tiny_config(hidden_size=128, intermediate_size=256,
                                                  tie_word_embeddings=False))
    else:
        tower, size = {"vqgan": (jvq.tiny_config(z_channels=256), 28),
                       "convnext": (jcn.tiny_config(dims=(8, 1024)), 56),
                       "open-clip": (joc.tiny_config(width=64), 28)}[model]
        cfg = jsv.tiny_config(image_encoder_type=model, image_size=size, vision_tower=tower)
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(0)))
    return tree, convert.from_jax_params(tree)


def _flat(tree, prefix=()):
    """{path: leaf} over dicts and lists (a spec, a tuple, is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _flat(t, prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in _flat(t, prefix + (i,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["1b", "8b", "vqgan", "convnext", "open-clip"])
def test_partition_specs_equal_jax(model, mesh, request):
    """Every leaf's spec from the port's apply_partition_rules (a mesh
    shape, no devices) equals the JAX package's on its 8-device CPU mesh,
    entry for entry; the sequence meshes widen fsdp to (fsdp, sequence)
    where the JAX package does. On (fsdp 2, sequence 2) the 1B's and 8B's
    shards that shard_pytree executes on 4 gloo ranks are, rank for rank,
    the shards of the JAX device at the same mesh position (its
    make_param_shardings' index map), widened leaves included."""
    import jax

    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.parallel import apply_partition_rules as japply
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.parallel import apply_partition_rules as tapply

    jtree, ttree = _trees(model)
    jmesh = _jax_mesh(MESHES[mesh])
    jspecs = jax.tree_util.tree_leaves_with_path(
        japply(jtree, jsv.partition_rules(), jmesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    ref = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(spec)
           for path, spec in jspecs}
    got = {path: tuple(spec) for path, spec in
           _flat(tapply(ttree, tsv.partition_rules(), dict(jmesh.shape))).items()}
    assert got == ref
    split = [s for s in ref.values() if any(e is not None for e in s)]
    assert split, "the mesh splits no leaf: the comparison says nothing"
    if "sequence" in mesh and model in ("1b", "8b"):
        assert any(("fsdp", "sequence") in s for s in got.values())
    if mesh == "fsdp2_sequence2" and model in ("1b", "8b"):
        from starvector_tpu.parallel import make_param_shardings

        shardings = _flat(jax.tree_util.tree_map(
            lambda s: s, make_param_shardings(jtree, jsv.partition_rules(), jmesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
        whole = _flat(jtree)
        ranks = request.getfixturevalue("reductions")["shards"]
        for r, shards in enumerate(ranks):
            device = jmesh.devices[0, 0, r // 2, r % 2, 0, 0]
            for path, sharding in shardings.items():
                index = sharding.devices_indices_map(whole[path].shape)[device]
                np.testing.assert_array_equal(shards[model][path].numpy(), whole[path][index],
                                              err_msg=f"rank {r} {path}")


MODULES = ["gpt_bigcode", "starcoder2", "adapter", "image_encoder", "starvector",
           "vision.clip_vit", "vision.siglip", "vision.open_clip_vit", "vision.vqgan",
           "vision.convnext"]


@pytest.mark.parametrize("module", MODULES)
def test_partition_rules_are_the_jax_lists(module):
    """Each model module's partition_rules() is the JAX module's list, the
    same regexes over the same paths with the same specs, in order (and
    gpt_bigcode's cache_partition_rules)."""
    import importlib

    jmod = importlib.import_module(f"starvector_tpu.models.{module}")
    tmod = importlib.import_module(f"starvector_tpu_torch.models.{module}")
    names = ["partition_rules"] + (["cache_partition_rules"] if module == "gpt_bigcode" else [])
    for name in names:
        ref = [(pat, tuple(spec)) for pat, spec in getattr(jmod, name)()]
        assert [(pat, tuple(spec)) for pat, spec in getattr(tmod, name)()] == ref, name


def test_batch_specs_sanitize_and_summary_equal_jax():
    """batch_spec, seq_spec, sanitize_for_mesh and local_mesh_summary give
    the JAX package's values."""
    from starvector_tpu.parallel import mesh as jm
    from starvector_tpu_torch.parallel import mesh as tm

    assert tm.MESH_AXES == jm.MESH_AXES and tm.BATCH_AXES == jm.BATCH_AXES
    for extra in (0, 1, 3):
        assert tuple(tm.batch_spec(extra)) == tuple(jm.batch_spec(extra))
        assert tuple(tm.seq_spec(extra)) == tuple(jm.seq_spec(extra))
    for axes in MESHES.values():
        jmesh = _jax_mesh(axes)
        shape = dict(jmesh.shape)
        assert tm.local_mesh_summary(shape) == jm.local_mesh_summary(jmesh)
        for spec, arr in ((jm.seq_spec(), (8, 16)), (jm.batch_spec(3), (4, 28, 28, 3)),
                          (jm.seq_spec(1), (6, 10, 4)), (jm.batch_spec(), (16,))):
            assert tuple(tm.sanitize_for_mesh(tuple(spec), arr, shape)) == \
                tuple(jm.sanitize_for_mesh(spec, arr, jmesh)), (axes, spec, arr)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["stage", "stage+tensor", "stage+sequence"])
def test_model_parallel_axes_raise_citing_item_12(axis, tmp_path):
    """stage above 1 trains (ROADMAP queue 1, item 12, is done for
    training): on (stage 2) and (stage 2, tensor 2) gloo ranks run
    train.main for a step and shard_pytree (through sv.shard_params, the
    way GRPOTrainer's parameters reach a mesh) gives each stage its one
    layer of the tiny 1B's two. stage with sequence raises the JAX pipeline's ValueError in
    train.main, before anything runs or is written, and in shard_pytree."""
    import test_torch_sequence_parallel as seq_par

    from starvector_tpu_torch.config import ConfigNode
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.parallel import shard_pytree
    from starvector_tpu_torch.train.train import main

    axes = dict.fromkeys(axis.split("+"), 2)
    out = tmp_path / "run"
    if "sequence" not in axes:
        yaml_path = seq_par._seq_yaml(tmp_path / "run.yaml", out, {"fsdp": 1, **axes})
        got = launch(HERE, "stage_main", 2 * len(axes),
                     dict(yaml_path=str(yaml_path), out_dir=str(out)), tmp_path)
        assert got == {"steps": [1], "layers": (1, 2)}
        return
    config = ConfigNode({"project": {"out_dir": str(out)}, "mesh": {"fsdp": 2, **axes},
                         "model": {"preset": "tiny"}, "training": {"device": "cpu"}})
    nest = "pipeline and sequence parallelism cannot nest"
    with pytest.raises(ValueError, match=nest):
        main(config)
    assert not out.exists()
    params = tsv.init_params(tsv.tiny_config(), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=nest):
        shard_pytree(params, tsv.partition_rules(), {"fsdp": 1, **axes})


def test_distributed_init_never_falls_back(monkeypatch):
    """Without torchrun's variables initialize_distributed does nothing;
    with them, a CUDA device on a torch without NCCL (or without a card)
    raises rather than run over gloo or on the CPU; one process started
    plainly on a mesh that asks for more devices raises ValueError, as the
    JAX main does."""
    import torch.distributed as dist

    from starvector_tpu_torch.config import ConfigNode
    from starvector_tpu_torch.parallel.mesh import initialize_distributed
    from starvector_tpu_torch.train.train import main

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        main(ConfigNode({"mesh": {"fsdp": 2}, "model": {"preset": "tiny"},
                         "training": {"device": "cpu"}}))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError):
        initialize_distributed("cuda")
    assert not dist.is_initialized()


def test_sharded_serving_still_raises_citing_item_12():
    """Sharded serving is accepted now (item 12's serving rest is done): a
    serve leaf on a (tensor 4, data 2) mesh, and leaves that ask for stage
    or fsdp above 1 beside tensor, map onto the worker's kwargs, and
    serving_mesh_config gives their meshes (every unnamed axis 1; ranks
    row-major over (replica, data, fsdp, sequence, stage, tensor))."""
    from starvector_tpu_torch.config import ConfigNode
    from starvector_tpu_torch.parallel.tensor import serving_mesh_config
    from starvector_tpu_torch.serve.worker import serve_kwargs_from_leaf

    leaf = ConfigNode({"serve": {"mesh": {"tensor": 4, "data": 2}}})
    assert serve_kwargs_from_leaf(leaf) == {
        "mesh_axes": {"tensor": 4, "data": 2}, "max_batch": 8, "max_len": 8192,
        "kv_cache_dtype": None, "hbm_proof_case": None}
    for axis, grid in (("stage", (1, 1, 1, 1, 2, 2)), ("fsdp", (1, 1, 2, 1, 1, 2))):
        kw = serve_kwargs_from_leaf(ConfigNode({"serve": {"mesh": {"tensor": 2, axis: 2}}}))
        assert kw["mesh_axes"] == {"tensor": 2, axis: 2}
        assert serving_mesh_config(kw["mesh_axes"]).resolve(4) == grid
