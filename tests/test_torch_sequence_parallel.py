"""Sequence parallelism of the port (parallel/sequence.py and the sequence
axis of parallel/zero.py) held to the JAX package's on the CPU, in fp32.

The op: each rank's body (`sp_chunk_attention`: its query chunk against
the gathered K and V at q_offset = rank x chunk), run rank after rank with
the gather's result and the reduce-scatter's sum formed by hand, against
JAX's sp_flash_attention on its 8-device virtual CPU mesh (Pallas in
interpret mode) at sequence 2 and 4: the forward, the gradients, GQA with
a window below S and a left-padded row; and the no-op where S does not
divide.

The step: gloo ranks (test_torch_fsdp_train.launch; the worker imports
torch and the port only) against the JAX step on the same mesh on the
virtual devices, with the flash attention so that JAX's sequence split
engages where the port's does: a tiny 1B at (sequence 2) with 17 visual +
47 svg = 64 positions (split), the same at 17 + 46 = 63 (no split: each
rank computes the whole rows and no gradient may double), and a tiny
8B-shaped model at (fsdp 2, sequence 2) with Adafactor and dots_flash, its
window (8) below the chunk (32). Loss, every gradient gathered whole and
every parameter after 3 steps at test_torch_fsdp_train's TOL.

The entry points: train.main under torchrun on (fsdp 2, sequence 2) writes
the one-process checkpoint and resumes from it; GRPOTrainer's updates on
(fsdp 2, sequence 2) equal one process's.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_fsdp_train as fsdp_train
from test_torch_fsdp_train import NOISE, OPT, STEPS, TOL, _close, launch, tree_numpy

HERE = Path(__file__).resolve()
OP_TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_sequence_parallel.py's
OP_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)  # its gradients' (test_sp_flash_gradients_match)
CASES = {  # name: (model, svg tokens, mesh, ranks, port remat, split engages)
    "1b_sequence2_split": ("1b", 47, dict(fsdp=1, sequence=2), 2, True, True),
    "1b_sequence2_nosplit": ("1b", 46, dict(fsdp=1, sequence=2), 2, "dots_flash", False),
    "8b_fsdp2_sequence2": ("8b", 48, dict(fsdp=2, sequence=2), 4, "dots_flash", True),
}


# ---------------------------------------------------------------------------
# the op against JAX's sp_flash_attention (no ranks)
# ---------------------------------------------------------------------------

PAD = 5  # row 1's left padding: its first PAD queries see no key


def _qkv(B=2, S=32, H=4, Hkv=1, D=16, seed=0):
    """q, k, v and a key mask with row 1 left-padded; and the weights w of
    the loss sum(out * w), 0 at the queries that see no key (whose output
    is a convention: the port's kernels give zeros there, the JAX package's
    CPU path does not), as a loss over real tokens has it."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (H, Hkv, Hkv))
    mask = np.ones((B, S), np.int32)
    mask[1, :PAD] = 0
    w = np.linspace(0.5, 1.5, q.size, dtype=np.float32).reshape(q.shape)
    w[1, :PAD] = 0
    return q, k, v, mask, w


def _jax_sp(q, k, v, mask, w, sequence: int, window=None):
    """JAX's sp_flash_attention on (data 2, sequence) of the virtual
    devices: its output and the gradients of sum(out * w)."""
    import jax
    import jax.numpy as jnp

    from starvector_tpu.parallel import MeshConfig, create_mesh
    from starvector_tpu.parallel.sequence import sp_flash_attention

    mesh = create_mesh(MeshConfig(data=2, fsdp=1, sequence=sequence),
                       devices=jax.devices()[:2 * sequence])

    def loss(q, k, v):
        out = sp_flash_attention(q, k, v, jnp.asarray(mask), window=window)
        return jnp.sum(out * jnp.asarray(w)), out

    with jax.set_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _live(a: np.ndarray) -> np.ndarray:
    """a (B, S, ...) without the queries that see no key."""
    return np.concatenate([a[0], a[1, PAD:]])


def _port_ranks(q, k, v, mask, sequence: int, w, window=None):
    """The port's per-rank body, rank after rank: each rank's query chunk
    against the whole K and V (what its all-gather returns), each its own
    leaf; the out and dQ chunks concatenated, each rank's dK and dV summed
    (the reduce-scatter's sum, whose chunks the owners take)."""
    from starvector_tpu_torch.parallel.sequence import sp_chunk_attention

    c = q.shape[1] // sequence
    outs, dqs, dk, dv = [], [], 0, 0
    for r in range(sequence):
        qr = torch.tensor(q[:, r * c:(r + 1) * c], requires_grad=True)
        kf, vf = (torch.tensor(t, requires_grad=True) for t in (k, v))
        out = sp_chunk_attention(qr, kf, vf, torch.from_numpy(mask), r, window=window)
        (out * torch.tensor(w[:, r * c:(r + 1) * c])).sum().backward()
        outs.append(out.detach())
        dqs.append(qr.grad)
        dk, dv = dk + kf.grad, dv + vf.grad
    return torch.cat(outs, 1).numpy(), [torch.cat(dqs, 1).numpy(), dk.numpy(), dv.numpy()]


@pytest.mark.parametrize("case", ["mqa", "gqa_window16"])
@pytest.mark.parametrize("sequence", [2, 4])
def test_sp_attention_ranks_match_jax(sequence, case):
    """Rank after rank, the port's body gives JAX's sp_flash_attention on a
    (data 2, sequence) mesh: out and dQ concatenated, dK and dV summed over
    the ranks (MQA, and GQA 8 over 2 heads with a window of 16 below S =
    32; row 1 left-padded by 5)."""
    H, Hkv, window = (4, 1, None) if case == "mqa" else (8, 2, 16)
    q, k, v, mask, w = _qkv(H=H, Hkv=Hkv, seed=sequence + H)
    out, grads = _jax_sp(q, k, v, mask, w, sequence, window)
    got, (dq, dk, dv) = _port_ranks(q, k, v, mask, sequence, w, window)
    np.testing.assert_allclose(_live(got), _live(out), **OP_TOL)
    np.testing.assert_allclose(_live(dq), _live(grads[0]), err_msg="dq", **OP_GRAD_TOL)
    np.testing.assert_allclose(dk, grads[1], err_msg="dk", **OP_GRAD_TOL)
    np.testing.assert_allclose(dv, grads[2], err_msg="dv", **OP_GRAD_TOL)


class _Layout:
    """A stand-in for an active zero.Layout on a sequence axis of 2, for a
    call that must not reach a collective."""
    sequence, seq_rank, seq_split = 2, 1, False


def test_sp_noop_on_an_indivisible_length(monkeypatch):
    """Where S does not divide over the sequence axis (31 over 2) JAX runs
    the attention whole, and so does the port: sp_flash_attention under a
    sequence layout is exactly flash_prefill_trainable, with no gather, and
    the layout is not told of a split."""
    from starvector_tpu_torch.ops.flash_attention import flash_prefill_trainable
    from starvector_tpu_torch.parallel import sequence, zero

    q, k, v, mask, w = _qkv(S=31, seed=9)
    out, _ = _jax_sp(q, k, v, mask, w, 2)
    layout = _Layout()
    monkeypatch.setattr(zero, "_ACTIVE", [layout])
    assert sequence.split_sequence(31) is None and sequence.chunk_span(32) == (16, 32)
    tq, tk, tv, tm = (torch.from_numpy(t) for t in (q, k, v, mask))
    got = sequence.sp_flash_attention(tq, tk, tv, tm)
    assert torch.equal(got, flash_prefill_trainable(tq, tk, tv, tm))
    assert not layout.seq_split
    np.testing.assert_allclose(_live(got.numpy()), _live(out), **OP_TOL)


# ---------------------------------------------------------------------------
# the step against the JAX mesh step (gloo ranks)
# ---------------------------------------------------------------------------

def _batch(model: str, S: int) -> dict:
    """4 rows of S svg tokens, right-padded to unequal lengths."""
    rng = np.random.RandomState(11)
    B = 4
    lengths = (S, S - 9, S - 20, S - 3)
    size = 28 if model == "1b" else 32
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = rng.randint(1, 512, (B, S)).astype(np.int32)
    return {"image": rng.standard_normal((B, size, size, 3)).astype(np.float32),
            "svg_ids": np.where(mask > 0, ids, 0).astype(np.int32), "svg_mask": mask}


def _jax_mesh_run(model: str, S: int, mesh_axes: dict, world: int) -> dict:
    """The JAX package's loss, gradients and 3 train steps on the mesh over
    the first `world` virtual devices, the decoder's attention the flash
    kernel (so that sp_flash_attention runs), no adapter dropout; and the
    query lengths its flash calls saw (the chunk where the split engaged)."""
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
    cfg = fsdp_train._jax_config(model)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="flash"))
    params = jsv.init_params(cfg, jax.random.PRNGKey(5))
    init = fsdp_train._np_tree(params)  # the step donates what device_put may alias
    batch = _batch(model, S)
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
    return dict(init=init, batch=batch, loss=float(loss), grads=np_tree(grads),
                losses=losses, grad_norms=norms, params=np_tree(p), chunks=set(seen))


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_steps_match_jax_mesh(case, tmp_path):
    """gloo ranks on the case's mesh, each on its shards, its batch
    coordinate's rows and (where S_total divides) its chunk of their
    positions: the loss, every gradient and 3 steps' parameters equal the
    JAX package's step on the same mesh (TOL), whose sequence split engages
    exactly where the port's does; with the split the 8B's widened leaves
    split over fsdp x sequence and their Adafactor moments beside them."""
    from starvector_tpu_torch.models import convert

    model, S, axes, world, remat, split = CASES[case]
    ref = _jax_mesh_run(model, S, axes, world)
    S_total = S + (17 if model == "1b" else 16)
    assert ref["chunks"] == {S_total // axes["sequence"] if split else S_total}
    got = launch(fsdp_train.HERE, "steps", world, dict(
        model=model, params=convert.from_jax_params(ref["init"]), batch=ref["batch"], mesh=axes,
        remat=remat, opt=OPT[model], steps=STEPS), tmp_path)
    assert got["seq_split"] is split
    assert got["local_rows"] == 4 // (world // axes["sequence"])
    assert got["moments_beside_shards"] and got["split"] > 0
    assert got["loss0"] == pytest.approx(ref["loss"], rel=TOL["rtol"])
    _close(got["grads0"], ref["grads"], f"{case} gradients")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL["rtol"])
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=TOL["rtol"])
    _close(got["params"], ref["params"], f"{case} after {STEPS} steps", NOISE.get(model))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _seq_yaml(path: Path, out_dir: Path, mesh: dict | None) -> Path:
    """A tiny 1B run on ToySVGDataset at 21 px (3 x 3 patches and the class
    token: 10 visual tokens, so that 10 + 64 svg tokens split over
    sequence 2), AdamW at eps 1e-4 (OPT's reason), adapter dropout on,
    dots_flash, a checkpoint every 2 steps, batch 2, validation on."""
    import yaml

    path.write_text(yaml.safe_dump({
        "project": {"name": "toy", "out_dir": str(out_dir), "snapshot_code": False},
        "model": {"preset": "tiny", "adapter_norm": "batch_norm", "image_size": 21},
        "training": {"epochs": 4, "lr": 1e-3, "lr_scheduler": "constant", "lr_warmup_steps": 0,
                     "adam_epsilon": 1e-4, "log_every": 1, "bf16": False,
                     "checkpointing_steps": 2, "checkpoints_total_limit": 3, "seed": 0,
                     "gradient_checkpointing": "dots_flash", "device": "cpu"},
        "data": {"batch_size": 2, "max_length": 64, "num_workers": 1,
                 "train": {"target": "starvector_tpu.data.datasets.ToySVGDataset",
                           "params": {"num_samples": 6, "im_size": 21}},
                 "val": {"target": "starvector_tpu.data.datasets.ToySVGDataset",
                         "params": {"num_samples": 2, "im_size": 21}}},
        **({"mesh": mesh} if mesh else {}),
    }))
    return path


def test_train_main_under_torchrun_on_a_sequence_mesh(tmp_path):
    """`torchrun --nproc_per_node 4` on a yaml with mesh {fsdp: 2,
    sequence: 2} (training.device=cpu: gloo) writes checkpoint-2 equal to a
    one-process main's (parameters, BatchNorm statistics and AdamW state,
    TOL) and logs the same losses and validation loss; resumed to 3 steps
    under torchrun, it continues the step count and ends equal to the one
    process resumed the same way."""
    from starvector_tpu_torch.config import get_config, resolve_repo_config
    from starvector_tpu_torch.train import checkpoint as tckpt
    from starvector_tpu_torch.train.train import main

    ranks, one = tmp_path / "ranks", tmp_path / "one"
    cfg_ranks = _seq_yaml(tmp_path / "ranks.yaml", ranks, {"fsdp": 2, "sequence": 2})
    cfg_one = _seq_yaml(tmp_path / "one.yaml", one, None)
    for steps in (2, 3):
        fsdp_train._torchrun(cfg_ranks, steps, nproc=4)
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
                np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key, **TOL)
    logs = [[json.loads(line) for line in open(d / "metrics.jsonl")] for d in (ranks, one)]
    assert [r["step"] for r in logs[0] if "loss" in r] == [1, 2, 3]
    for a, b in zip(*logs):
        assert a.keys() == b.keys()
        for k in ("loss", "val_loss"):
            if k in a:
                assert a[k] == pytest.approx(b[k], rel=TOL["rtol"]), (k, a["step"])


def test_grpo_trainer_on_a_sequence_mesh_matches_one_process(tmp_path):
    """GRPOTrainer on (fsdp 2, sequence 2), 4 ranks: two updates of each
    batch rank's rows of a fixed rollout of 17 prefix + 19 ids (36
    positions, so the update splits them: rank 0 of a sequence group scores
    ids 0-1, rank 1 ids 2-18) give one process's losses, KL, grad norms and
    decoder (TOL); a sampled trainer.step then runs on the gathered
    parameters (the sequence group taking its first rank's rollout) and
    leaves them sharded."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.ops.layers import DTypePolicy

    cfg = tsv.tiny_config()
    params = tsv.init_params(cfg, torch.Generator().manual_seed(8))
    rng = np.random.RandomState(9)
    B, L, P = 2, 19, 3
    lengths = np.asarray([19, 12, 16, 9])
    pos = np.arange(L)[None, :]
    attn = (pos < lengths[:, None]).astype(np.int32)
    rollout = {"vision_embeds": rng.standard_normal((B, 17, 64)).astype(np.float32),
               "ids": np.where(attn > 0, rng.randint(1, 512, (B * fsdp_train.G, L)),
                               0).astype(np.int64),
               "attn_mask": attn, "loss_mask": attn * (pos >= P).astype(np.int32)}
    advantages = rng.standard_normal(B * fsdp_train.G).astype(np.float32)
    got = launch(fsdp_train.HERE, "grpo", 4, dict(
        params=params, mesh=dict(fsdp=2, sequence=2), rollout=rollout, advantages=advantages,
        updates=2), tmp_path)
    model = StarVectorForCausalLM(params, cfg, build_test_tokenizer("v1"), device="cpu",
                                  policy=DTypePolicy(torch.float32, torch.float32))
    ref = fsdp_train.grpo_updates(model, rollout, advantages, 2)
    assert got["seq_split"] and got["moments_split"] > 0
    assert got["step_finite"] and got["still_shards"]
    for a, b in zip(got["metrics"], ref["metrics"]):
        for k in ("loss", "kl", "grad_norm", "clip_frac", "mean_ratio"):
            assert a[k] == pytest.approx(b[k], rel=TOL["rtol"], abs=TOL["atol"]), k
    _close(got["decoder"], tree_numpy(model.params["svg_transformer"]),
           "GRPO decoder after 2 updates")
