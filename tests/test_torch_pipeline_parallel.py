"""Pipeline parallelism in training (parallel/pipeline.py: the decoder's
layers cut over a mesh's `stage` axis, GPipe's microbatch ticks) held to
the JAX package's pp_layer_scan on the same mesh of the virtual devices, on
the CPU, in fp32. The port's ranks are gloo processes
(test_torch_fsdp_train.launch; the worker imports torch and the port only)
while the pytest process computes the JAX side, in a thread beside them.

  * forward: the tiny GPTBigCode's logits (4 layers, 8 rows) on stage 4
    (8 microbatches), on stage 2 x fsdp 2 (4 a rank), and in JAX's two
    fallbacks, 3 layers on stage 2 x fsdp 2 (the layers whole on every
    stage) and 2 rows on it (one row a rank: the port fetches each layer
    from its stage at use), all four in one launch;
  * steps: the loss, every gradient gathered whole and 3 train steps'
    losses, grad norms and parameters (test_torch_fsdp_train's TOL) of
    1b_stage2 (AdamW), 1b_stage2_fsdp2 (dots_flash), 8b_stage2_tensor2
    (the tiny 8B-shaped model, 4 heads over 2 split over tensor 2 inside
    each stage, Adafactor; JAX's `tensor` stays auto inside its region)
    and the fallback at one row a rank (remat True);
  * stage x sequence raises ValueError in both packages;
  * train.main under torchrun on a stage-2 yaml writes the one-process
    checkpoint and resumes from it; GRPOTrainer on stage 2 equals one
    process.

A spy on the JAX package's `_plain_scan` shows that its side pipelined
(no call) or fell back (a call); the port's ranks report the same of
theirs.
"""

import concurrent.futures
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_fsdp_train as fsdp_train
import test_torch_sequence_parallel as seq_par
import test_torch_tensor_train as tensor_train
from test_torch_fsdp_train import NOISE, OPT, STEPS, TOL, _close, launch, tree_numpy, worker_main

HERE = Path(__file__).resolve()
NEST = "pipeline and sequence parallelism cannot nest"

# name: (mesh, decoder layers, rows, whether JAX and the port pipeline)
FORWARD = {
    "stage4": (dict(fsdp=1, stage=4), 4, 8, True),
    "stage2_fsdp2": (dict(fsdp=2, stage=2), 4, 8, True),
    "fallback_3_layers": (dict(fsdp=2, stage=2), 3, 8, False),
    "fallback_1_row": (dict(fsdp=2, stage=2), 4, 2, False),
}
STEP_CASES = {  # name: (model, mesh, ranks, port remat, rows, whether both pipeline)
    "1b_stage2": ("1b", dict(fsdp=1, stage=2), 2, False, 4, True),
    "1b_stage2_fsdp2": ("1b", dict(fsdp=2, stage=2), 4, "dots_flash", 4, True),
    "8b_stage2_tensor2": ("8b", dict(fsdp=1, stage=2, tensor=2), 4, "dots", 4, True),
    # one row a rank: JAX's fallback; the port fetches each layer from its stage
    "1b_stage2_fsdp2_1_row": ("1b", dict(fsdp=2, stage=2), 4, True, 2, False),
}
S_FWD = 16


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------

def _forward_job(cases: dict) -> dict:
    """Each case's logits of every row (every rank's, put in row order) and
    how the ranks ran the layers: {"logits", "pipelined", "stand_ins"}."""
    import torch.distributed as dist

    from starvector_tpu_torch.models import gpt_bigcode as tgbc
    from starvector_tpu_torch.ops.layers import DTypePolicy
    from starvector_tpu_torch.parallel import MeshConfig, create_mesh, pipeline, shard_pytree, zero

    f32 = DTypePolicy(torch.float32, torch.float32)
    calls = {"gpipe": 0, "stand_in": 0}
    gpipe, stand_in = pipeline._gpipe, zero.stand_in

    def count(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    pipeline._gpipe, zero.stand_in = count("gpipe", gpipe), count("stand_in", stand_in)
    out = {}
    for name, case in cases.items():
        calls.update(gpipe=0, stand_in=0)
        layout = zero.Layout(create_mesh(MeshConfig(**case["mesh"])))
        cfg = tgbc.tiny_config(n_layer=case["layers"])
        params = shard_pytree(case["params"], tgbc.partition_rules(), layout)
        rows = [t.chunk(layout.batch)[layout.batch_rank] for t in (case["embeds"], case["mask"])]
        with torch.no_grad(), layout.step():
            logits, _ = tgbc.forward(params, cfg, rows[0], attention_mask=rows[1], policy=f32)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (layout.batch_rank, logits))
        assert all(torch.equal(lg, got[0][1]) for b, lg in got if b == 0), "stage ranks differ"
        out[name] = {"logits": torch.cat([dict(got)[b] for b in range(layout.batch)]),
                     "pipelined": calls["gpipe"] > 0, "stand_ins": calls["stand_in"]}
    return out


JOBS = {"forward": _forward_job}


if __name__ == "__main__":
    worker_main(JOBS)


# ---------------------------------------------------------------------------
# the JAX side (the pytest process)
# ---------------------------------------------------------------------------

class _PlainScanSpy:
    """Within: counts the JAX pipeline's fallbacks to its plain scan."""

    def __enter__(self):
        from starvector_tpu.parallel import pipeline as jpp

        self.calls, self._mp = 0, pytest.MonkeyPatch()
        real = jpp._plain_scan

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        self._mp.setattr(jpp, "_plain_scan", spy)
        return self

    def __exit__(self, *exc):
        self._mp.undo()


def _jax_forward(cases: dict) -> dict:
    """Each case's JAX logits on its mesh and its plain-scan count."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu.ops.layers import DTypePolicy
    from starvector_tpu.parallel import MeshConfig, create_mesh, make_param_shardings
    from starvector_tpu.parallel.mesh import batch_sharding

    f32 = DTypePolicy(compute_dtype=jnp.float32)
    out = {}
    for name, case in cases.items():
        cfg = jgbc.tiny_config(n_layer=case["layers"], attn_impl="xla")
        world = int(np.prod(list(case["mesh"].values())))
        mesh = create_mesh(MeshConfig(**case["mesh"]), devices=jax.devices()[:world])
        params = jax.tree_util.tree_map(jnp.asarray, case["jparams"])
        p = jax.tree_util.tree_map(jax.device_put, params,
                                   make_param_shardings(params, jgbc.partition_rules(), mesh))
        e = jax.device_put(jnp.asarray(case["jembeds"]), batch_sharding(mesh, extra_dims=2))
        with _PlainScanSpy() as spy, jax.set_mesh(mesh):
            logits, _ = jax.jit(lambda p, e, m: jgbc.forward(p, cfg, e, attention_mask=m,
                                                            policy=f32))(p, e, case["jmask"])
        out[name] = {"logits": np.asarray(logits), "plain_scans": spy.calls,
                     "mask": case["jmask"]}
    return out


@pytest.fixture(scope="module")
def forward_runs(tmp_path_factory):
    """The port's four forward cases in one launch of 4 ranks, and JAX's."""
    import jax

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu_torch.models import convert

    rng = np.random.RandomState(17)
    cases = {}
    for name, (mesh, layers, B, _) in FORWARD.items():
        jparams = fsdp_train._np_tree(jgbc.init_params(
            jgbc.tiny_config(n_layer=layers, attn_impl="xla"), jax.random.PRNGKey(layers)))
        embeds = rng.standard_normal((B, S_FWD, 64)).astype(np.float32)
        mask = np.ones((B, S_FWD), np.int32)
        mask[1, :3] = 0  # a left-padded row
        cases[name] = dict(mesh=mesh, layers=layers, jparams=jparams, jembeds=embeds,
                           jmask=mask, params=convert.from_jax_params(jparams),
                           embeds=torch.from_numpy(embeds), mask=torch.from_numpy(mask))
    port_cases = {k: {n: c[n] for n in ("mesh", "layers", "params", "embeds", "mask")}
                  for k, c in cases.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, HERE, "forward", 4, dict(cases=port_cases),
                            tmp_path_factory.mktemp("pp_forward"))
        ref = _jax_forward(cases)
        got = ranks.result()
    return got, ref


@pytest.mark.parametrize("case", list(FORWARD))
def test_pipelined_forward_matches_jax_mesh(forward_runs, case):
    """The decoder's logits on the case's mesh equal the JAX package's on
    the same mesh (TOL), every stage rank holding the same; both pipeline
    where the layers divide over the stages and the rows make 2
    microbatches, and both fall back to the plain loop otherwise (the port
    fetching each stage-split layer from its stage where there is one row
    a rank)."""
    got, ref = (r[case] for r in forward_runs)
    pipelines = FORWARD[case][3]
    assert (ref["plain_scans"] == 0) is pipelines
    assert got["pipelined"] is pipelines
    assert (got["stand_ins"] > 0) is (case == "fallback_1_row")
    # a left pad's query sees no key: the packages differ there by convention
    # (the port's attention gives zeros), so the pads' rows are left out
    live = ref["mask"] > 0
    np.testing.assert_allclose(got["logits"].numpy()[live], ref["logits"][live], **TOL)


def _jax_steps(model: str, cfg, init, batch: dict, axes: dict, world: int) -> dict:
    with _PlainScanSpy() as spy:
        out = tensor_train._jax_tensor_run(model, cfg, init, batch, axes, world)
    return out | {"plain_scans": spy.calls}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pipelined_steps_match_jax_mesh(case, tmp_path):
    """gloo ranks on the case's stage mesh, each on its block of the
    layers (its tensor slices, its fsdp shards) and its batch coordinate's
    rows: the loss, every gradient gathered whole and 3 steps' losses,
    grad norms and parameters equal the JAX package's step on the same
    mesh (TOL), both sides pipelined, or at one row a rank both in the
    plain loop (the port's layers fetched from their stages at use, their
    gradients summed back there)."""
    from starvector_tpu_torch.models import convert

    model, axes, world, remat, rows, pipelines = STEP_CASES[case]
    cfg, init = tensor_train._jax_init(model, "xla")
    batch = {k: v[:rows] for k, v in seq_par._batch(model, 24).items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, fsdp_train.HERE, "steps", world, dict(
            model=model, params=convert.from_jax_params(init), batch=batch, mesh=axes,
            remat=remat, opt=OPT[model], steps=STEPS), tmp_path)
        ref = _jax_steps(model, cfg, init, batch, axes, world)
        got = ranks.result()
    assert (ref["plain_scans"] == 0) is pipelines and got["pipelined"] is pipelines
    assert got["local_rows"] == rows // axes["fsdp"]
    assert got["moments_beside_shards"] and got["split"] > 0
    assert got["loss0"] == pytest.approx(ref["loss"], rel=TOL["rtol"])
    _close(got["grads0"], ref["grads"], f"{case} gradients")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL["rtol"])
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=TOL["rtol"])
    _close(got["params"], ref["params"], f"{case} after {STEPS} steps", NOISE.get(model))


def test_stage_and_sequence_cannot_nest():
    """A mesh with stage 2 and sequence 2 raises ValueError in both
    packages: JAX's pipeline when it traces, the port's training mesh when
    it is laid out (train.main checks its mesh block first)."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import gpt_bigcode as jgbc
    from starvector_tpu.ops.layers import DTypePolicy
    from starvector_tpu.parallel import MeshConfig, create_mesh
    from starvector_tpu_torch.config import ConfigNode
    from starvector_tpu_torch.parallel import zero
    from starvector_tpu_torch.parallel.mesh import check_training_mesh
    from starvector_tpu_torch.train.train import main

    cfg = jgbc.tiny_config(n_layer=4, attn_impl="xla")
    params = jgbc.init_params(cfg, jax.random.PRNGKey(0))
    embeds = jnp.zeros((4, S_FWD, 64), jnp.float32)
    mesh = create_mesh(MeshConfig(fsdp=1, sequence=2, stage=2), devices=jax.devices()[:4])
    with jax.set_mesh(mesh), pytest.raises(ValueError, match=NEST):
        jax.jit(lambda p, e: jgbc.forward(p, cfg, e, policy=DTypePolicy(
            compute_dtype=jnp.float32)))(params, embeds)
    axes = {"fsdp": 1, "sequence": 2, "stage": 2}
    for refuse in (check_training_mesh, zero.Layout):
        with pytest.raises(ValueError, match=NEST):
            refuse(axes)
    with pytest.raises(ValueError, match=NEST):
        main(ConfigNode({"mesh": axes, "model": {"preset": "tiny"},
                         "training": {"device": "cpu"}}))


def test_train_main_under_torchrun_on_a_stage_mesh(tmp_path):
    """`torchrun --nproc_per_node 2` on a yaml with mesh {fsdp: 1, stage:
    2} (training.device=cpu: gloo; the tiny 1B's 2 layers one a stage, its
    2 rows 2 microbatches) writes checkpoint-2 equal to a one-process
    main's (parameters, BatchNorm statistics and AdamW state, TOL), from the
    stages' blocks put back whole, and logs the same losses and validation
    loss; resumed to 3 steps under torchrun (each stage cutting its block
    out of the checkpoint again), it continues the step count and ends
    equal to the one process resumed the same way."""
    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.train import checkpoint as tckpt
    from starvector_tpu_torch.train.train import main

    ranks, one = tmp_path / "ranks", tmp_path / "one"
    cfg_ranks = seq_par._seq_yaml(tmp_path / "ranks.yaml", ranks, {"fsdp": 1, "stage": 2})
    cfg_one = seq_par._seq_yaml(tmp_path / "one.yaml", one, None)
    for steps in (2, 3):
        fsdp_train._torchrun(cfg_ranks, steps, nproc=2)
        main(get_config([f"config={cfg_one}", f"training.steps={steps}"],
                        default_path=resolve_repo_config()))
        assert [s for s, _ in tckpt.list_checkpoints(str(ranks))] == \
            [s for s, _ in tckpt.list_checkpoints(str(one))] == [2, 3][:steps - 1]
        got = tckpt.restore_checkpoint(tckpt.get_last_checkpoint(str(ranks)))
        ref = tckpt.restore_checkpoint(tckpt.get_last_checkpoint(str(one)))
        assert got["opt_state"]["count"] == ref["opt_state"]["count"] == steps
        _close(got["params"], tree_numpy(ref["params"]), f"params at {steps}")
        for key in ("mu", "nu"):
            for a, b in zip(got["opt_state"][key], ref["opt_state"][key]):
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key, **TOL)
    logs = [[json.loads(line) for line in open(d / "metrics.jsonl")] for d in (ranks, one)]
    assert [r["step"] for r in logs[0] if "loss" in r] == [1, 2, 3]
    for a, b in zip(*logs):
        assert a.keys() == b.keys()
        for k in ("loss", "val_loss"):
            if k in a:
                assert a[k] == pytest.approx(b[k], rel=TOL["rtol"]), (k, a["step"])


def test_grpo_trainer_on_a_stage_mesh_matches_one_process(tmp_path):
    """GRPOTrainer on (stage 2), 2 ranks, each with its layer of the tiny
    1B's decoder: two updates of a fixed rollout (behaviour and
    KL-reference log-probs included, through the pipeline without
    gradients) give one process's losses, KL, grad norms and decoder (TOL);
    a sampled trainer.step then rolls out on the parameters gathered whole
    (the cached decoder, unpipelined; the stage group taking its first
    rank's rollout) and leaves them split."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = tsv.tiny_config()
    params = tsv.init_params(cfg, torch.Generator().manual_seed(14))
    rng = np.random.RandomState(15)
    B, L, P = 2, 10, 3
    lengths = np.asarray([10, 6, 8, 9])
    pos = np.arange(L)[None, :]
    attn = (pos < lengths[:, None]).astype(np.int32)
    rollout = {"vision_embeds": rng.standard_normal((B, 17, 64)).astype(np.float32),
               "ids": np.where(attn > 0, rng.randint(1, 512, (B * fsdp_train.G, L)),
                               0).astype(np.int64),
               "attn_mask": attn, "loss_mask": attn * (pos >= P).astype(np.int32)}
    advantages = rng.standard_normal(B * fsdp_train.G).astype(np.float32)
    got = launch(fsdp_train.HERE, "grpo", 2, dict(
        params=params, mesh=dict(fsdp=1, stage=2), rollout=rollout, advantages=advantages,
        updates=2), tmp_path)
    model = StarVectorForCausalLM(params, cfg, build_test_tokenizer("v1"), device="cpu",
                                  policy=DTypePolicy(torch.float32, torch.float32))
    ref = fsdp_train.grpo_updates(model, rollout, advantages, 2)
    assert got["moments_split"] > 0 and not got["seq_split"]
    assert got["step_finite"] and got["still_shards"]
    for a, b in zip(got["metrics"], ref["metrics"]):
        for k in ("loss", "kl", "grad_norm", "clip_frac", "mean_ratio"):
            assert a[k] == pytest.approx(b[k], rel=TOL["rtol"], abs=TOL["atol"]), k
    _close(got["decoder"], tree_numpy(model.params["svg_transformer"]),
           "GRPO decoder after 2 updates")
