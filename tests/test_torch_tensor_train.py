"""Tensor parallelism in training (the `tensor` axis of parallel/zero.py and
parallel/tensor.py's collectives under autograd) held to the JAX
package's step on the same mesh, on the CPU, in fp32.

The step: gloo ranks (test_torch_fsdp_train.launch and its "steps"
worker; the worker imports torch and the port only) against the JAX step
on the same mesh of the virtual devices (GSPMD splits the same leaves over
`tensor`), while the pytest process computes it in a thread:

  * 1b_tensor2: the tiny 1B (4 query heads over its one KV head, which
    both ranks hold whole: c_attn's K and V columns sum their gradient over
    the pair), BatchNorm adapter, AdamW;
  * 1b_fsdp2_tensor2: the same, each tensor slice cut over fsdp 2;
  * 8b_tensor4: the tiny 8B-shaped model (4 heads over 2 KV heads: each KV
    head's k/v_proj slice on a pair of ranks), SigLIP, Adafactor, "dots";
  * 8b_sequence2_tensor2: the same on sequence 2 x tensor 2, where the
    sequence split engages (JAX's flash region splits the heads over
    tensor, as the port's ranks hold theirs).

JAX's attention is its flash kernel (Pallas in interpret mode) where the
sequence split needs it, else "xla", the same function. Loss, every
gradient gathered whole and, after 3 steps, every parameter, the losses
and the grad norms at test_torch_fsdp_train's TOL.

The entry points: train.main under torchrun on a tensor-2 yaml writes the
one-process checkpoint and resumes from it; GRPOTrainer's updates on a
tensor-2 mesh equal one process's.
"""

import concurrent.futures
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_fsdp_train as fsdp_train
import test_torch_sequence_parallel as seq_par
from test_torch_fsdp_train import NOISE, OPT, STEPS, TOL, _close, launch, tree_numpy

CASES = {  # name: (model, svg tokens, mesh, ranks, port remat, JAX attention, split engages)
    "1b_tensor2": ("1b", 24, dict(fsdp=1, tensor=2), 2, False, "xla", False),
    "1b_fsdp2_tensor2": ("1b", 24, dict(fsdp=2, tensor=2), 4, "dots_flash", "xla", False),
    "8b_tensor4": ("8b", 24, dict(fsdp=1, tensor=4), 4, "dots", "xla", False),
    "8b_sequence2_tensor2": ("8b", 24, dict(fsdp=1, sequence=2, tensor=2), 4, "dots_flash",
                             "flash", True),
}


def _jax_init(model: str, attn_impl: str):
    """The JAX config with `attn_impl` and its initial parameters (numpy)."""
    import jax

    from starvector_tpu.models import starvector as jsv

    cfg = fsdp_train._jax_config(model)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl=attn_impl))
    return cfg, fsdp_train._np_tree(jsv.init_params(cfg, jax.random.PRNGKey(5)))


def _jax_tensor_run(model: str, cfg, init, batch: dict, mesh_axes: dict, world: int) -> dict:
    """The JAX package's loss, gradients and 3 train steps on the mesh over
    the first `world` virtual devices, no adapter dropout; and the query
    lengths its flash calls saw."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.models import adapter as jadapter
    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.ops import layers as jlayers
    from starvector_tpu.parallel import MeshConfig, create_mesh, make_param_shardings
    from starvector_tpu.parallel import sequence as jseq
    from starvector_tpu.parallel.mesh import batch_sharding
    from starvector_tpu.train import optim as joptim
    from starvector_tpu.train import step as jstep

    f32 = jlayers.DTypePolicy(compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("forward", "forward_with_stats"):
            fn = getattr(jadapter, name)
            mp.setattr(jadapter, name,
                       lambda *a, _fn=fn, dropout_rng=None, **kw: _fn(*a, dropout_rng=None, **kw))
        flash = jseq.flash_prefill_trainable
        mp.setattr(jseq, "flash_prefill_trainable",
                   lambda q, *a, **kw: (seen.append(q.shape[1]), flash(q, *a, **kw))[1])
        mesh = create_mesh(MeshConfig(**mesh_axes), devices=jax.devices()[:world])
        p = jax.tree_util.tree_map(jax.device_put, params,
                                   make_param_shardings(params, jsv.partition_rules(), mesh))
        jb = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh, v.ndim - 1))
              for k, v in batch.items()}
        with jax.set_mesh(mesh):
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: jsv.loss_fn_with_bn_stats(p, cfg, jb, 0, policy=f32),
                has_aux=True))(p)
            tx = joptim.build_optimizer(params, **OPT[model])
            state = tx.init(p)
            train = jstep.make_train_step(cfg, tx, 0, policy=f32, remat=False)
            losses, norms = [], []
            for i in range(STEPS):
                p, state, m = train(p, state, jb, jax.random.PRNGKey(i))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
    np_tree = fsdp_train._np_tree
    return dict(loss=float(loss), grads=np_tree(grads), losses=losses, grad_norms=norms,
                params=np_tree(p), chunks=set(seen))


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_steps_match_jax_mesh(case, tmp_path):
    """gloo ranks on the case's mesh, each on its tensor slices (cut over
    fsdp where the mesh has it), its batch coordinate's rows and, where
    the split engages, its chunk of their positions: the loss, every
    gradient gathered whole and 3 steps' losses, grad norms and parameters
    equal the JAX package's step on the same mesh (TOL); the optimizer
    state lies beside the shards, and some leaves are split."""
    from starvector_tpu_torch.models import convert

    model, S, axes, world, remat, attn_impl, split = CASES[case]
    cfg, init = _jax_init(model, attn_impl)
    batch = seq_par._batch(model, S)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, fsdp_train.HERE, "steps", world, dict(
            model=model, params=convert.from_jax_params(init), batch=batch, mesh=axes,
            remat=remat, opt=OPT[model], steps=STEPS), tmp_path)
        ref = _jax_tensor_run(model, cfg, init, batch, axes, world)
        got = ranks.result()
    S_total = S + (17 if model == "1b" else 16)
    if attn_impl == "flash":
        assert ref["chunks"] == {S_total // axes["sequence"]}
    assert got["seq_split"] is split
    batch_ranks = world // axes.get("sequence", 1) // axes["tensor"]
    assert got["local_rows"] == 4 // batch_ranks
    assert got["moments_beside_shards"] and got["split"] > 0
    assert got["loss0"] == pytest.approx(ref["loss"], rel=TOL["rtol"])
    _close(got["grads0"], ref["grads"], f"{case} gradients")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL["rtol"])
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=TOL["rtol"])
    _close(got["params"], ref["params"], f"{case} after {STEPS} steps", NOISE.get(model))


def test_train_main_under_torchrun_on_a_tensor_mesh(tmp_path):
    """`torchrun --nproc_per_node 2` on a yaml with mesh {fsdp: 1, tensor:
    2} (training.device=cpu: gloo) writes checkpoint-2 equal to a
    one-process main's (parameters, BatchNorm statistics and AdamW state,
    TOL), from the tensor slices put back whole, and logs the same losses
    and validation loss; resumed to 3 steps under torchrun (each rank
    slicing the checkpoint again), it continues the step count and ends
    equal to the one process resumed the same way."""
    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.train import checkpoint as tckpt
    from starvector_tpu_torch.train.train import main

    ranks, one = tmp_path / "ranks", tmp_path / "one"
    cfg_ranks = seq_par._seq_yaml(tmp_path / "ranks.yaml", ranks, {"fsdp": 1, "tensor": 2})
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


def test_grpo_trainer_on_a_tensor_mesh_matches_one_process(tmp_path):
    """GRPOTrainer on (tensor 2), 2 ranks, each with its heads and MLP
    columns of the decoder: two updates of a fixed rollout (behaviour and
    KL-reference log-probs included) give one process's losses, KL, grad
    norms and decoder (TOL); a sampled trainer.step then runs on the
    parameters gathered whole (the tensor group taking its first rank's
    rollout) and leaves them split."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = tsv.tiny_config()
    params = tsv.init_params(cfg, torch.Generator().manual_seed(12))
    rng = np.random.RandomState(13)
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
        params=params, mesh=dict(fsdp=1, tensor=2), rollout=rollout, advantages=advantages,
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
