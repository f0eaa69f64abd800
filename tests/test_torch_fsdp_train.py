"""Data-parallel and ZeRO-3 training of the port on the CPU (gloo), held to
the JAX package's one-device step.

Each case runs this file as a script in N processes, one a rank, with
torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT): the worker code imports torch and the port only; the JAX
side runs in the pytest process. The models are the tiny 1B (BatchNorm
adapter, AdamW with clipping) and a tiny 8B-shaped model (SigLIP tower,
StarCoder2 with a window below the sequence, hidden 128 and MLP 256 so that
Adafactor factors its stacked leaves), in fp32, on the meshes (fsdp 4),
(replica 2, fsdp 2) and (data 2), with masks of unequal token counts
across the ranks. Each must give JAX's loss, every gradient (gathered
whole) and, after 3 steps, every parameter, at rtol 1e-4 and atol 1e-6.
Adapter dropout is off on both sides here (the JAX step always passes a
dropout key; its adapter is wrapped to get none); test_torch_parallel.py
holds the port's N-rank dropout to its one-process one, and
`test_train_main_under_torchrun_writes_the_one_process_checkpoint` trains
with it on.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
REPO = HERE.parents[1]
TOL = dict(rtol=1e-4, atol=1e-6)
WINDOW = 8
GEOMETRY_8B = dict(num_attention_heads=4, num_key_value_heads=2, hidden_size=128,
                   intermediate_size=256, sliding_window=WINDOW)
MESHES = {"fsdp4": (4, dict(fsdp=4)), "replica2_fsdp2": (4, dict(replica=2, fsdp=2)),
          "data2": (2, dict(data=2, fsdp=1))}
REMAT = {"1b": {"fsdp4": "dots_flash", "replica2_fsdp2": False, "data2": True},
         "8b": {"fsdp4": "dots_flash", "replica2_fsdp2": "dots", "data2": False}}
# AdamW's eps 1e-4: an element whose gradient is far below eps moves by
# lr x g / eps, so an fp32 summation-order difference of 1e-9 in g (the
# ranks sum in another order than one process) would move it by 1e-6 a step
# at eps 1e-6; at 1e-4 by 1e-8, and every gradient of the tiny model that is
# not rounding noise is above 1e-4
OPT = {"1b": dict(lr=1e-3, warmup_steps=1, weight_decay=0.05, betas=(0.95, 0.999), eps=1e-4,
                  total_steps=10),
       "8b": dict(optimizer="adafactor", lr=1e-3, warmup_steps=1, total_steps=10)}
STEPS = 3


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def reserved_ports(n: int = 1):
    """Yield a port p with p, ..., p + n - 1 held for the block: each is
    bound, not listening, by a socket with SO_REUSEADDR. The kernel hands a
    held port to no bind(0) and no outgoing connection (a port that was
    only picked and closed can go to any of them while the ranks start),
    yet a server that sets SO_REUSEADDR itself (http.server's, c10d's
    TCPStore) binds and listens on it from another process."""
    while True:
        held = [socket.socket()]
        held[0].setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        held[0].bind(("localhost", 0))
        port = held[0].getsockname()[1]
        try:
            for i in range(1, n):
                held.append(socket.socket())
                held[-1].setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                held[-1].bind(("localhost", port + i))
        except OSError:  # a neighbour is taken: draw again
            for s in held:
                s.close()
            continue
        try:
            yield port
        finally:
            for s in held:
                s.close()
        return


def launch(script: Path, job: str, world: int, args: dict, tmp_path: Path,
           timeout: float = 300.0, attempts: int = 3):
    """Run `job` of `script` in `world` gloo ranks, one process each with
    torchrun's variables, and return what rank 0 saved. A rank that fails
    stops the others. The rendezvous port is held (reserved_ports) until
    the ranks end; a run in which any rank still met EADDRINUSE starts
    again on a new port."""
    for attempt in range(attempts):
        try:
            return _launch(script, job, world, args, tmp_path, timeout)
        except _PortTaken:
            if attempt == attempts - 1:
                raise


class _PortTaken(AssertionError):
    pass


def _launch(script: Path, job: str, world: int, args: dict, tmp_path: Path, timeout: float):
    tag = f"{job}-{time.monotonic_ns()}"
    argf, out = tmp_path / f"{tag}-args.pt", tmp_path / f"{tag}-out.pt"
    torch.save(args, argf)
    logs = [tmp_path / f"{tag}-rank{r}.log" for r in range(world)]
    with reserved_ports() as master:
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(master),
               "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        procs = [subprocess.Popen([sys.executable, str(script), job, str(argf), str(out)],
                                  env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                  stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            text = logs[r].read_text()
            for q, log in enumerate(logs):
                if any(w in log.read_text() for w in ("EADDRINUSE", "Address already in use")):
                    raise _PortTaken(f"rank {q} of {job} could not bind its port")
            raise AssertionError(f"rank {r} of {job}:\n" + text[-6000:])
    return torch.load(out, weights_only=False)


def worker_main(jobs: dict) -> None:
    """A rank's process: join the gloo group that the variables describe,
    run the job on the saved arguments, rank 0 saves its result."""
    import torch.distributed as dist

    from starvector_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    job, argf, out = sys.argv[1:4]
    initialize_distributed("cpu")
    result = jobs[job](**torch.load(argf, weights_only=False))
    if dist.get_rank() == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


def port_config(model: str):
    from starvector_tpu_torch.models import starcoder2 as tsc
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.vision import siglip as tsig

    if model == "1b":
        return tsv.tiny_config(adapter_norm="batch_norm")
    return tsv.tiny_config(decoder="starcoder2", image_encoder_type="siglip_384", image_size=32,
                           adapter_norm="layer_norm", vision_tower=tsig.tiny_config(),
                           llm=tsc.tiny_config(**GEOMETRY_8B))


def _steps_job(model: str, params: dict, batch: dict, mesh: dict, remat, opt: dict,
               steps: int) -> dict:
    """On this rank's shards and rows: the loss and every gradient at the
    start, then `steps` train steps; the gradients and the final parameters
    gathered whole, each step's loss and grad norm, and where each
    optimizer state leaf lies beside its parameter."""
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, zero
    from starvector_tpu_torch.train import optim, step
    from starvector_tpu_torch.train.train import rank_rows, to_device

    cfg = port_config(model)
    policy = DTypePolicy(torch.float32, torch.float32)
    layout = zero.Layout(create_mesh(MeshConfig(**mesh)))
    tx = optim.build_optimizer(params, **opt)
    params, state = step.shard_train_state(params, tx, layout, cfg)
    step.mark_trainable(params)
    rows = to_device(rank_rows(batch, layout), "cpu")
    loss0, _, grads = step.loss_and_grads(params, cfg, rows, 0, policy=policy, remat=remat,
                                          trainable=tx._trainable(params))
    out = {"loss0": float(loss0), "grads0": zero.full_tree(grads),
           "local_rows": int(rows["svg_ids"].shape[0]), "seq_split": layout.seq_split,
           "pipelined": layout.stage_token is not None}
    shards = [(tuple(p.shape), zero.full_shape(p)) for p in optim.tree_leaves(params)]
    out["split"] = sum(a != b for a, b in shards)
    where = step.opt_state_shardings(state)
    out["moments_beside_shards"] = all(
        m is None or (w.dim == zero.info_of(p).dim and m.shape == p.shape)
        for k in ("mu", "nu", "v") if k in state
        for m, w, p in zip(state[k], where[k], optim.tree_leaves(params)))
    train = step.make_train_step(cfg, tx, 0, policy=policy, remat=remat)
    out["losses"], out["grad_norms"] = [], []
    for _ in range(steps):
        params, state, m = train(params, state, rows, None)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = zero.full_tree(params)
    return out


G = 2  # GRPO rollouts a prompt


def grpo_updates(model, rollout: dict, advantages, updates: int, rows=None) -> dict:
    """GRPOTrainer on `model` (kl_beta 0.1, AdamW eps 1e-4 for the reason
    given at OPT): the behaviour and KL-reference log-probs of the rollout,
    then `updates` updates; each update's metrics and the trainer. `rows`
    takes this rank's block of the rollout's rows first."""
    from starvector_tpu_torch.train import grpo

    trainer = grpo.GRPOTrainer(model, grpo.GRPOConfig(num_generations=G, kl_beta=0.1),
                               lr=1e-3, remat=False)
    trainer.opt.eps = 1e-4
    roll = {k: torch.as_tensor(v) for k, v in rollout.items()}
    adv = torch.as_tensor(advantages)
    if rows is not None:
        roll, adv = rows(roll), rows({"adv": adv})["adv"]
    roll["old_lp"] = trainer._log_probs(model.params, roll)
    roll["ref_lp"] = trainer._log_probs({"svg_transformer": trainer.ref_decoder}, roll)
    metrics = []
    for _ in range(updates):
        _, trainer.opt_state, m = trainer._step_fn(model.params, trainer.opt_state, roll, adv)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "trainer": trainer}


def _grpo_job(params: dict, mesh: dict, rollout: dict, advantages, updates: int) -> dict:
    """GRPOTrainer on sharded parameters: `updates` updates on this rank's
    rows of a fixed rollout (the decoder gathered whole after), then one
    trainer.step with a sampled rollout of this rank's images and a
    stand-in reward."""
    import numpy as np

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, zero
    from starvector_tpu_torch.train import grpo
    from starvector_tpu_torch.train.optim import tree_leaves, tree_map

    layout = zero.Layout(create_mesh(MeshConfig(**mesh)))
    cfg = tsv.tiny_config()
    model = StarVectorForCausalLM(tsv.shard_params(params, cfg, layout), cfg,
                                  build_test_tokenizer("v1"), device="cpu",
                                  policy=DTypePolicy(torch.float32, torch.float32))

    def rows(tree):
        return {k: v.chunk(layout.batch)[layout.batch_rank] for k, v in tree.items()}

    run = grpo_updates(model, rollout, advantages, updates, rows)
    trainer = run["trainer"]
    seq_split = layout.seq_split
    mu = [m for m in trainer.opt_state["mu"] if m is not None]
    whole = zero.full_tree(model.params["svg_transformer"])  # unsplit leaves are the live ones
    out = {"metrics": run["metrics"], "decoder": tree_map(lambda t: t.detach().clone(), whole),
           "moments_split": sum(zero.sharded(m) is not None for m in mu), "seq_split": seq_split}
    grpo.batch_rewards = lambda raw, targets, *, num_generations, **kw: np.linspace(
        0.0, 1.0, len(raw), dtype=np.float32)
    images = torch.from_numpy(np.random.RandomState(layout.batch_rank).standard_normal(
        (1, 28, 28, 3)).astype(np.float32))
    step = trainer.step(images, [np.zeros((28, 28, 3), np.uint8)], max_new_tokens=4)
    out["step_finite"] = all(np.isfinite(v) for v in step.values())
    out["still_shards"] = zero.layout_of(model.params) is layout and any(
        zero.sharded(p) is not None for p in tree_leaves(model.params))
    return out


JOBS = {"steps": _steps_job, "grpo": _grpo_job}


if __name__ == "__main__":
    worker_main(JOBS)


# ---------------------------------------------------------------------------
# the JAX side (the pytest process)
# ---------------------------------------------------------------------------

def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items() for p, leaf in _flat(v, prefix + (k,)).items()}
    return {prefix: tree}


def _batch(model: str) -> dict:
    """4 rows: images, svg ids and right-padded masks whose token counts
    differ across every split of the rows."""
    rng = np.random.RandomState(7)
    B, S = 4, 12
    lengths = (12, 7, 10, 4) if model == "1b" else (12, 5, 9, 11)
    size = 28 if model == "1b" else 32
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = rng.randint(1, 512, (B, S)).astype(np.int32)
    return {"image": rng.standard_normal((B, size, size, 3)).astype(np.float32),
            "svg_ids": np.where(mask > 0, ids, 0).astype(np.int32), "svg_mask": mask}


def _jax_config(model: str):
    import dataclasses

    from starvector_tpu.models import starcoder2 as jsc
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.vision import siglip as jsig

    if model == "1b":
        return jsv.tiny_config(adapter_norm="batch_norm")
    cfg = jsv.tiny_config(decoder="starcoder2", image_encoder_type="siglip_384", image_size=32,
                          adapter_norm="layer_norm", vision_tower=jsig.tiny_config(),
                          llm=jsc.tiny_config(**GEOMETRY_8B))
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"))


@pytest.fixture(scope="module")
def jax_runs():
    """Per model: the initial parameters (numpy), the batch, and JAX's
    one-device loss, gradients, and 3 train steps' losses, grad norms and
    parameters (plain attention, no adapter dropout)."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import adapter as jadapter
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.ops import layers as jlayers
    from starvector_tpu.train import optim as joptim
    from starvector_tpu.train import step as jstep

    f32 = jlayers.DTypePolicy(compute_dtype=jnp.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("forward", "forward_with_stats"):
            fn = getattr(jadapter, name)
            mp.setattr(jadapter, name,
                       lambda *a, _fn=fn, dropout_rng=None, **kw: _fn(*a, dropout_rng=None, **kw))
        for model in ("1b", "8b"):
            cfg = _jax_config(model)
            params = jsv.init_params(cfg, jax.random.PRNGKey(3))
            batch = _batch(model)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: jsv.loss_fn_with_bn_stats(p, cfg, jb, 0, policy=f32),
                has_aux=True))(params)
            tx = joptim.build_optimizer(params, **OPT[model])
            state = tx.init(params)
            train = jstep.make_train_step(cfg, tx, 0, policy=f32, remat=False)
            p = jax.tree_util.tree_map(jnp.copy, params)
            losses, norms = [], []
            for i in range(STEPS):
                p, state, m = train(p, state, jb, jax.random.PRNGKey(i))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            out[model] = dict(init=_np_tree(params), batch=batch, loss=float(loss),
                              grads=_np_tree(grads), losses=losses, grad_norms=norms,
                              params=_np_tree(p))
    return out


# a leaf whose gradient is rounding noise, the noise's bound, and how far
# the optimizer may carry each side: SigLIP's key biases (attention ignores
# a shift shared by every key), which Adafactor moves by a full step of its
# floor size (lr x 1e-3) a step with a noise-given sign
NOISE = {"8b": (("image_encoder", "visual_encoder", "layers", "attn", "k_proj", "bias"), 1e-6,
                2 * STEPS * OPT["8b"]["lr"] * 1e-3)}


def _close(got, ref, what, noise=None):
    """Every leaf of `got` (torch) within TOL of `ref` (numpy), but the
    noise leaf (NOISE), held to its bound."""
    got, ref = _flat(got), _flat(ref)
    assert got.keys() == ref.keys(), what
    for k, r in ref.items():
        g = got[k].detach().cpu().numpy()
        if noise is not None and k == noise[0]:
            assert np.abs(g - r).max() <= noise[2], (what, k, np.abs(g - r).max())
            continue
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"{what} {'/'.join(k)}", **TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["1b", "8b"])
def test_sharded_steps_match_jax(jax_runs, model, mesh, tmp_path):
    """N gloo ranks on the mesh, each on its shards and its block of rows:
    the loss, every gradient and 3 steps' parameters equal the JAX
    package's one-device step on the whole batch (TOL). The optimizer's
    moments lie beside their shards, and some leaves are split."""
    from starvector_tpu_torch.models import convert

    ref = jax_runs[model]
    world, axes = MESHES[mesh]
    got = launch(HERE, "steps", world, dict(
        model=model, params=convert.from_jax_params(ref["init"]), batch=ref["batch"], mesh=axes,
        remat=REMAT[model][mesh], opt=OPT[model], steps=STEPS), tmp_path)
    assert got["local_rows"] == 4 // world
    assert got["moments_beside_shards"]
    assert (got["split"] > 0) == (axes["fsdp"] > 1)
    assert got["loss0"] == pytest.approx(ref["loss"], rel=TOL["rtol"])
    _close(got["grads0"], ref["grads"], f"{model} {mesh} gradients")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL["rtol"])
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=TOL["rtol"])
    noise = NOISE.get(model)
    if noise is not None:
        assert np.abs(_flat(ref["grads"])[noise[0]]).max() < noise[1]  # noise indeed
    _close(got["params"], ref["params"], f"{model} {mesh} after {STEPS} steps", noise)


def test_grpo_trainer_on_sharded_params_matches_one_process(tmp_path):
    """GRPOTrainer takes sharded parameters, as the JAX trainer does: on
    (fsdp 2) its AdamW moments lie on the shards, and two updates of each
    rank's block of a fixed rollout (behaviour and KL-reference log-probs
    included) give one process's losses, KL, grad norms and decoder
    (TOL); a sampled trainer.step then runs on the gathered parameters and
    leaves them sharded."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = tsv.tiny_config()
    params = tsv.init_params(cfg, torch.Generator().manual_seed(4))
    rng = np.random.RandomState(5)
    B, L, P = 2, 10, 3
    lengths = np.asarray([10, 6, 8, 9])
    pos = np.arange(L)[None, :]
    attn = (pos < lengths[:, None]).astype(np.int32)
    rollout = {"vision_embeds": rng.standard_normal((B, 17, 64)).astype(np.float32),
               "ids": np.where(attn > 0, rng.randint(1, 512, (B * G, L)), 0).astype(np.int64),
               "attn_mask": attn, "loss_mask": attn * (pos >= P).astype(np.int32)}
    advantages = rng.standard_normal(B * G).astype(np.float32)
    got = launch(HERE, "grpo", 2, dict(params=params, mesh=dict(fsdp=2), rollout=rollout,
                                       advantages=advantages, updates=2), tmp_path)
    model = StarVectorForCausalLM(params, cfg, build_test_tokenizer("v1"), device="cpu",
                                  policy=DTypePolicy(torch.float32, torch.float32))
    ref = grpo_updates(model, rollout, advantages, 2)
    assert got["moments_split"] > 0 and got["step_finite"] and got["still_shards"]
    for a, b in zip(got["metrics"], ref["metrics"]):
        for k in ("loss", "kl", "grad_norm", "clip_frac", "mean_ratio"):
            assert a[k] == pytest.approx(b[k], rel=TOL["rtol"], abs=TOL["atol"]), k
    _close(got["decoder"], tree_numpy(model.params["svg_transformer"]),
           "GRPO decoder after 2 updates")


def tree_numpy(tree):
    from starvector_tpu_torch.train.optim import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _toy_yaml(path: Path, out_dir: Path) -> Path:
    """A tiny 1B run on ToySVGDataset (train and val), on the CPU, AdamW at
    eps 1e-4 (OPT's reason), adapter dropout on (train_loop's generator),
    a checkpoint every 2 steps, batch 4."""
    import yaml

    path.write_text(yaml.safe_dump({
        "project": {"name": "toy", "out_dir": str(out_dir), "snapshot_code": False},
        "model": {"preset": "tiny", "adapter_norm": "batch_norm", "image_size": 28},
        "training": {"epochs": 4, "lr": 1e-3, "lr_scheduler": "constant", "lr_warmup_steps": 0,
                     "adam_epsilon": 1e-4, "log_every": 1, "bf16": False,
                     "checkpointing_steps": 2, "checkpoints_total_limit": 3, "seed": 0,
                     "gradient_checkpointing": "dots_flash", "device": "cpu"},
        "data": {"batch_size": 4, "max_length": 64, "num_workers": 1,
                 "train": {"target": "starvector_tpu.data.datasets.ToySVGDataset",
                           "params": {"num_samples": 8, "im_size": 28}},
                 "val": {"target": "starvector_tpu.data.datasets.ToySVGDataset",
                         "params": {"num_samples": 4, "im_size": 28}}},
    }))
    return path


def _torchrun(yaml_path: Path, steps: int, nproc: int = 2) -> None:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
         "-m", "starvector_tpu_torch.train.train", f"config={yaml_path}",
         f"training.steps={steps}"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-6000:]


def test_train_main_under_torchrun_writes_the_one_process_checkpoint(tmp_path):
    """`torchrun --nproc_per_node 2 -m starvector_tpu_torch.train.train`
    on a tiny yaml (training.device=cpu: gloo; no mesh block: fsdp over both
    ranks) writes checkpoint-2 equal to a one-process main's (parameters,
    BatchNorm statistics and AdamW state, TOL), logs each step and the
    reduced validation loss once, as the one process does; resumed under
    torchrun to 4 steps, it continues the step count and ends equal to the
    one-process run resumed the same way."""
    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.train import checkpoint as tckpt
    from starvector_tpu_torch.train.train import main

    ranks, one = tmp_path / "ranks", tmp_path / "one"
    cfg_ranks = _toy_yaml(tmp_path / "ranks.yaml", ranks)
    cfg_one = _toy_yaml(tmp_path / "one.yaml", one)

    def one_process(steps):
        main(get_config([f"config={cfg_one}", f"training.steps={steps}"],
                        default_path=resolve_repo_config()))

    for steps in (2, 4):
        _torchrun(cfg_ranks, steps)
        one_process(steps)
        assert [s for s, _ in tckpt.list_checkpoints(str(ranks))] == \
            [s for s, _ in tckpt.list_checkpoints(str(one))] == list(range(2, steps + 1, 2))
        got = tckpt.restore_checkpoint(tckpt.get_last_checkpoint(str(ranks)))
        ref = tckpt.restore_checkpoint(tckpt.get_last_checkpoint(str(one)))
        assert got["opt_state"]["count"] == ref["opt_state"]["count"] == steps
        _close(got["params"], tree_numpy(ref["params"]), f"params at {steps}")
        for key in ("mu", "nu"):
            for a, b in zip(got["opt_state"][key], ref["opt_state"][key]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key, **TOL)
    logs = [[json.loads(line) for line in open(d / "metrics.jsonl")] for d in (ranks, one)]
    assert [r["step"] for r in logs[0] if "loss" in r] == [1, 2, 3, 4]
    for a, b in zip(*logs):
        assert a.keys() == b.keys()
        for k in ("loss", "val_loss"):
            if k in a:
                assert a[k] == pytest.approx(b[k], rel=TOL["rtol"]), (k, a["step"])


def test_reserved_ports_are_held_yet_servers_bind_them():
    """reserved_ports(2): while held, neither port is given to a plain bind
    (EADDRINUSE) nor drawn by bind(0); another process's c10d TCPStore
    (the rendezvous) and the port's HTTP server (a serve worker's) bind and
    answer on them. A launch's ports were picked and closed before, and an
    outgoing connection of a test running beside it could take one in the
    minutes before its rank bound it."""
    import errno

    code = ("import datetime, sys, threading, torch.distributed as dist\n"
            "from starvector_tpu_torch.serve.httpd import make_server, post_json_reply\n"
            "p = int(sys.argv[1])\n"
            "store = dist.TCPStore('localhost', p, 1, True,\n"
            "                      timeout=datetime.timedelta(seconds=30))\n"
            "store.set('k', 'v')\n"
            "srv = make_server('127.0.0.1', p + 1, {'/ping': lambda h, b: h.send_json(b)})\n"
            "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
            "print(store.get('k').decode(), post_json_reply(f'http://127.0.0.1:{p + 1}/ping',"
            " {'x': 1}, 10))\n"
            "srv.shutdown(); srv.server_close()\n")
    with reserved_ports(2) as port:
        for p in (port, port + 1):
            with socket.socket() as s, pytest.raises(OSError) as e:
                s.bind(("localhost", p))
            assert e.value.errno == errno.EADDRINUSE
        for _ in range(2000):
            with socket.socket() as s:
                s.bind(("localhost", 0))
                assert s.getsockname()[1] not in (port, port + 1)
        run = subprocess.run([sys.executable, "-c", code, str(port)], capture_output=True,
                             text=True, timeout=120, cwd=REPO,
                             env={**os.environ, "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split("\n")[0] == "v {'x': 1}"
