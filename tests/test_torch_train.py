"""Port parity for training: the loss, its gradients, the BatchNorm running
statistics, the fused LM-head loss, the schedules, the optimizer, the train
step, checkpoints and the entry point, against starvector_tpu on the same
weights (the JAX pytree handed over with from_jax_params) and the same
numpy inputs.

The model is sv.tiny_config(adapter_norm="batch_norm"); the JAX decoder runs
attn_impl="flash", so its attention is the Pallas forward-with-lse and
backward in interpret mode. Adapter dropout is off on both sides (the JAX
train step always passes a dropout key; the tests wrap the JAX adapter so
that it gets none). Tolerances, fp32: loss 1e-5 relative; gradients
rtol 1e-4 with atol 1e-6 (the BatchNorm bias's gradient is zero up to
rounding: every path from it goes through a LayerNorm, which cancels a
per-token shift); parameters after 3 optimizer updates or train steps 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from starvector_tpu.models import adapter as jadapter
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.ops import layers as jlayers
from starvector_tpu.train import optim as joptim
from starvector_tpu.train import step as jstep
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.ops import layers as tlayers
from starvector_tpu_torch.train import checkpoint as tckpt
from starvector_tpu_torch.train import optim as toptim
from starvector_tpu_torch.train import step as tstep
from starvector_tpu_torch.train.optim import tree_leaves

JF32 = jlayers.DTypePolicy(compute_dtype=jnp.float32)
TF32 = tlayers.DTypePolicy(compute_dtype=torch.float32)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
REMATS = [False, True, "dots_flash", "dots", "dots_slim"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items() for p, leaf in _flat(v, prefix + (k,)).items()}
    return {prefix: tree}


def _assert_trees_close(got, ref, tol, what=""):
    got, ref = _flat(got), _flat(ref)
    assert set(got) == set(ref), what
    for path, r in ref.items():
        g = got[path]
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"{what} {'/'.join(path)}", **tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = jsv.tiny_config(adapter_norm="batch_norm")
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_impl="flash"))
    tcfg = tsv.tiny_config(adapter_norm="batch_norm")
    jparams = jsv.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B, S = 3, 12
    svg_mask = np.ones((B, S), np.int32)
    svg_mask[1, 7:] = 0   # ragged, right-padded as the loader pads
    svg_mask[2, 10:] = 0
    batch = {"image": rng.standard_normal((B, 28, 28, 3)).astype(np.float32),
             "svg_ids": rng.integers(1, jcfg.llm.vocab_size, (B, S)).astype(np.int32),
             "svg_mask": svg_mask}
    return jcfg, tcfg, jparams, batch


def _tparams(jparams):
    return tstep.mark_trainable(convert.from_jax_params(_np_tree(jparams)))


def _tbatch(batch):
    return {"image": torch.from_numpy(batch["image"]),
            "svg_ids": torch.from_numpy(batch["svg_ids"]).long(),
            "svg_mask": torch.from_numpy(batch["svg_mask"])}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture
def jax_adapter_without_dropout(monkeypatch):
    fn = jadapter.forward_with_stats
    monkeypatch.setattr(jadapter, "forward_with_stats",
                        lambda *a, dropout_rng=None, **kw: fn(*a, dropout_rng=None, **kw))


# ---------------------------------------------------------------------------
# the LayerNorm rounding fault (fixed here): fp32 parameters under bf16
# ---------------------------------------------------------------------------

def test_layer_norm_applies_fp32_params_in_fp32_under_bf16():
    """Training keeps fp32 master parameters under a bf16 compute policy.
    A scale of 1 +- 1e-3 k is not a bf16 value: the JAX layer_norm applies
    it in fp32 and rounds once, and so must the port (it used to round the
    scale and bias to bf16 first). The scale's and bias's gradients reach
    the fp32 parameters."""
    rng = np.random.default_rng(0)
    E = 64
    x = (rng.standard_normal((4, 6, E)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 1e-3 * np.arange(-E // 2, E // 2)).astype(np.float32)
    bias = (1e-3 * np.arange(E)).astype(np.float32)
    g = rng.standard_normal((4, 6, E)).astype(np.float32)

    def jfn(s, b):
        y = jlayers.layer_norm({"scale": s, "bias": b}, jnp.asarray(x).astype(jnp.bfloat16))
        return y, jnp.sum(y.astype(jnp.float32) * g)

    ref = jfn(jnp.asarray(scale), jnp.asarray(bias))[0]
    ref_ds, ref_db = jax.grad(lambda s, b: jfn(s, b)[1], argnums=(0, 1))(jnp.asarray(scale),
                                                                        jnp.asarray(bias))
    ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (scale, bias))
    out = tlayers.layer_norm({"scale": ts, "bias": tb}, torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    got, want = out.float().detach().numpy(), np.asarray(ref.astype(jnp.float32))
    # equal but for the odd value whose fp32 sum sits on a bf16 rounding edge
    assert (got == want).mean() >= 0.99
    ulp = np.abs(want) * 2.0**-7 + 1e-30
    assert (np.abs(got - want) <= ulp).all()
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert ts.grad.dtype == torch.float32 and tb.grad.dtype == torch.float32
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ref_ds), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref_db), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(setup):
    """jax.value_and_grad of loss_fn_with_bn_stats per remat mode."""
    jcfg, _, jparams, batch = setup
    out = {}
    for remat in REMATS:
        fn = jax.value_and_grad(
            lambda p, r=remat: jsv.loss_fn_with_bn_stats(p, jcfg, _jbatch(batch), 0, policy=JF32,
                                                         remat=r), has_aux=True)
        out[remat] = jax.jit(fn)(jparams)
    return out


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_match_jax(setup, jax_grads, remat):
    _, tcfg, jparams, batch = setup
    (ref_loss, ref_aux), ref_grads = jax_grads[remat]
    params = _tparams(jparams)
    loss, aux = tsv.loss_fn_with_bn_stats(params, tcfg, _tbatch(batch), 0, policy=TF32,
                                          remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    grads = toptim.tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
    _assert_trees_close(grads, _np_tree(ref_grads), GRAD_TOL, f"remat={remat}")
    _assert_trees_close(aux["bn_stats"], _np_tree(ref_aux["bn_stats"]), PARAM_TOL)


class _Allocs(TorchDispatchMode):
    """Records every storage that an op makes (by weak reference)."""

    def __init__(self, keep: set):
        super().__init__()
        self.keep, self.made = keep, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in self.keep:
                st = t.untyped_storage()
                self.made[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        return out


def held_bytes(run, inputs) -> tuple[int, torch.Tensor]:
    """(bytes of the storages that `run()` made and that are still alive
    when it returns, with its result held; run()'s result): for a loss,
    what its forward keeps for the backward. Storages of `inputs` (a dict
    of tensors) do not count. Views share their base's storage, so
    nothing counts twice. A saved_tensors_hooks count would not see what a
    checkpointed region keeps: its own hooks take those tensors."""
    keep = {t.untyped_storage().data_ptr() for t in tree_leaves(inputs)}
    mode = _Allocs(keep)
    with mode:
        out = run()
    return sum(n for ref, n in mode.made.values() if not ref.expired()), out


def remat_bytes_and_grads(params_of, tcfg, batch, modes=(False, "dots", "dots_slim")):
    """{mode: (held bytes after the forward, loss, {path: grad})} of
    loss_fn_with_bn_stats at fp32, each mode on fresh params."""
    out = {}
    for mode in modes:
        params = params_of()
        held, loss = held_bytes(
            lambda: tsv.loss_fn_with_bn_stats(params, tcfg, batch, 0, policy=TF32,
                                              remat=mode)[0], {"params": params, "batch": batch})
        loss.backward()
        out[mode] = (held, float(loss.detach()),
                     {k: v.grad for k, v in _flat(params).items() if v.grad is not None})
    return out


def test_remat_modes_refused_or_unknown(setup):
    """"dots" and "dots_slim" (refused before they were ported) give
    remat=False's loss (1e-5) and every gradient (GRAD_TOL), fp32, and keep
    fewer bytes from the forward for the backward: dots_slim < dots < False
    (held_bytes); an unknown mode raises ValueError."""
    _, tcfg, jparams, batch = setup
    runs = remat_bytes_and_grads(lambda: _tparams(jparams), tcfg, _tbatch(batch))
    held, ref_loss, ref_grads = runs[False]
    for mode in ("dots", "dots_slim"):
        assert runs[mode][1] == pytest.approx(ref_loss, rel=1e-5), mode
        assert runs[mode][2].keys() == ref_grads.keys()
        for k, g in runs[mode][2].items():
            torch.testing.assert_close(g, ref_grads[k], **GRAD_TOL, msg=f"{mode} {k}")
    assert runs["dots_slim"][0] < runs["dots"][0] < held, {m: r[0] for m, r in runs.items()}
    params = _tparams(jparams)
    with pytest.raises(ValueError, match="unknown gradient_checkpointing"):
        tsv.loss_fn_with_bn_stats(params, tcfg, _tbatch(batch), 0, policy=TF32,
                                  remat="dots-flash")


@pytest.mark.parametrize("chunk", [128, 5])
def test_causal_lm_loss_fused_matches_jax(chunk):
    """Shift-by-one CE over chunks (a length that the chunk does not
    divide, ignored targets): the loss and its gradients to the hidden
    states and the tied table."""
    rng = np.random.default_rng(chunk)
    B, S, E, V = 2, 13, 16, 40
    hidden = rng.standard_normal((B, S, E)).astype(np.float32)
    table = rng.standard_normal((V, E)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :4] = -100
    labels[1, 9:] = -100
    ref, (ref_dh, ref_dt) = jax.value_and_grad(
        lambda h, t: jgbc.causal_lm_loss_fused(t, h, jnp.asarray(labels), policy=JF32,
                                               chunk=chunk), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    th, tt = (torch.from_numpy(a).requires_grad_(True) for a in (hidden, table))
    loss = tgbc.causal_lm_loss_fused(tt, th, torch.from_numpy(labels), policy=TF32, chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(ref_dh), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref_dt), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,warmup", [("cosine", 10), ("cosine", 0), ("linear", 10),
                                         ("constant", 4), ("constant", 0)])
def test_schedules_match_jax(name, warmup):
    ref = joptim.build_schedule(name, 2.0, warmup, 110)
    got = toptim.build_schedule(name, 2.0, warmup, 110)
    for step in (0, 1, 2, 5, 9, 10, 11, 50, 109, 110, 200):
        assert got(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-7), step
    with pytest.raises(ValueError):
        toptim.build_schedule("nope", 1.0, 0, 10)


OPT_CASES = {
    "warmup": dict(warmup_steps=2, lr=1e-2, weight_decay=0.1),
    "accum2": dict(grad_accum_steps=2, lr=1e-2, weight_decay=0.1),
    "frozen_encoder": dict(train_image_encoder=False, lr=1e-2, weight_decay=0.1),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_updates_match_optax(setup, case):
    """3 updates (6 calls with accumulation over 2) on the tiny model's
    parameters with random gradients, some large enough to clip, against
    the JAX package's optax chain."""
    _, _, jparams, _ = setup
    kw = dict(betas=(0.95, 0.999), eps=1e-8, total_steps=20, grad_clip=1.0, **OPT_CASES[case])
    tx = joptim.build_optimizer(jparams, **kw)
    jstate = tx.init(jparams)
    jupdate = jax.jit(tx.update)
    tparams = convert.from_jax_params(_np_tree(jparams))
    opt = toptim.build_optimizer(tparams, **kw)
    tstate = opt.init(tparams)
    rng = np.random.default_rng(1)
    calls = 3 * kw.get("grad_accum_steps", 1)
    for i in range(calls):
        scale = 0.02 if i % 2 else 0.002  # global norms above and below the clip
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), _np_tree(jparams))
        updates, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.update(convert.from_jax_params(grads), tstate, tparams)
        _assert_trees_close(tparams, _np_tree(jparams), PARAM_TOL, f"{case} call {i}")
    if case == "frozen_encoder":
        frozen = _flat(tparams["image_encoder"])
        assert all(torch.equal(frozen[k], torch.tensor(np.asarray(v)))
                   for k, v in _flat(_np_tree(setup[2]["image_encoder"])).items())


def test_optimizer_refuses_what_is_not_ported(setup):
    """Adafactor and AdamW's mu_dtype (refused before they were ported;
    test_torch_optim.py holds them to optax) build, and one update of each
    moves every trainable leaf; an unknown optimizer raises ValueError."""
    params = convert.from_jax_params(_np_tree(setup[2]))
    grads = toptim.tree_map(lambda p: torch.full_like(p, 1e-3), params)
    for kw in (dict(optimizer="adafactor"), dict(mu_dtype=torch.bfloat16)):
        fresh = toptim.tree_map(torch.clone, params)
        opt = toptim.build_optimizer(fresh, lr=1e-2, warmup_steps=0, **kw)
        state = opt.init(fresh)
        opt.update(grads, state, fresh)
        assert state["count"] == 1
        assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(fresh), tree_leaves(params)))
    assert isinstance(toptim.build_optimizer(params, optimizer="adafactor"), toptim.Adafactor)
    assert toptim.build_optimizer(params, mu_dtype=torch.bfloat16).init(params)["mu"][0].dtype \
        == torch.bfloat16
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build_optimizer(params, optimizer="lamb")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(setup, jax_adapter_without_dropout):
    """3 steps of make_train_step (dots_flash, AdamW with warmup, decay and
    clipping) against the JAX make_train_step: loss, grad_norm, every
    parameter and the BatchNorm running statistics."""
    jcfg, tcfg, jparams, batch = setup
    # eps 1e-6: the BatchNorm bias's gradient is rounding noise (~1e-9, see
    # the module docstring), which Adam with eps 1e-8 would scale up to
    # steps of ~lr with a noise-given sign on each side
    kw = dict(lr=1e-3, warmup_steps=1, weight_decay=0.05, betas=(0.95, 0.999), eps=1e-6,
              total_steps=10)
    tx = joptim.build_optimizer(jparams, **kw)
    jstate = tx.init(jparams)
    jtrain = jstep.make_train_step(jcfg, tx, 0, policy=JF32, remat="dots_flash")
    jp = jax.tree_util.tree_map(jnp.copy, jparams)
    tparams = _tparams(jparams)
    opt = toptim.build_optimizer(tparams, **kw)
    tstate = opt.init(tparams)
    ttrain = tstep.make_train_step(tcfg, opt, 0, policy=TF32, remat="dots_flash")
    for i in range(3):
        jp, jstate, jm = jtrain(jp, jstate, _jbatch(batch), jax.random.PRNGKey(i))
        tparams, tstate, tm = ttrain(tparams, tstate, _tbatch(batch), None)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        _assert_trees_close(tparams, _np_tree(jp), PARAM_TOL, f"step {i}")
    before = np.asarray(jparams["image_projection"]["norm"]["running_mean"])
    assert not np.allclose(tparams["image_projection"]["norm"]["running_mean"].numpy(), before)


# ---------------------------------------------------------------------------
# checkpoints and the entry point
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_rotation(tmp_path, setup):
    params = convert.from_jax_params(_np_tree(setup[2]))
    opt = toptim.build_optimizer(params, grad_accum_steps=2)
    state = {"params": params, "opt_state": opt.init(params)}
    base = str(tmp_path / "ckpts")
    tckpt.save_checkpoint(base, 5, state)
    path = tckpt.save_checkpoint(base, 10, state, total_limit=1, config={"model": {"a": 1}})
    assert [s for s, _ in tckpt.list_checkpoints(base)] == [10]
    last = tckpt.get_last_checkpoint(base)
    assert last == path and tckpt.step_from_path(last) == 10
    assert (tmp_path / "ckpts" / "checkpoint-10" / "config.yaml").exists()
    restored = tckpt.restore_checkpoint(last)
    _assert_trees_close(restored["params"], _np_tree(setup[2]), dict(rtol=0, atol=0))
    assert restored["opt_state"]["count"] == 0 and restored["opt_state"]["mini_step"] == 0
    assert all(torch.equal(a, b) for a, b in zip(restored["opt_state"]["acc"],
                                                  state["opt_state"]["acc"]))
    assert tckpt.get_last_checkpoint(str(tmp_path / "none")) is None


def _toy_config(out_dir, steps):
    from starvector_tpu.config import ConfigNode

    return ConfigNode({
        "project": {"name": "toy", "out_dir": str(out_dir)},
        "model": {"preset": "tiny", "adapter_norm": "batch_norm"},
        "training": {
            # constant lr: the cut run's schedule must not depend on its step count
            "steps": steps, "epochs": 4, "lr": 1e-3, "lr_scheduler": "constant",
            "lr_warmup_steps": 0, "log_every": 1,
            "bf16": False, "checkpointing_steps": 2, "checkpoints_total_limit": 2, "seed": 0,
            "gradient_checkpointing": "dots_flash", "device": "cpu",
        },
        "data": {
            "batch_size": 2, "max_length": 64, "num_workers": 1,
            "train": {"target": "starvector_tpu.data.datasets.ToySVGDataset",
                      "params": {"num_samples": 6, "im_size": 28}},
        },
    })


def test_train_main_end_to_end_with_resume(tmp_path):
    """main on the ToySVGDataset: a run cut after 3 steps (mid-epoch) and
    resumed to 6 continues the step count, replays no batch, and ends with
    the parameters of an uninterrupted 6-step run."""
    from starvector_tpu_torch.train.train import main

    main(_toy_config(tmp_path / "run", 3))
    last = tckpt.get_last_checkpoint(str(tmp_path / "run"))
    assert tckpt.step_from_path(last) == 3
    assert (tmp_path / "run" / "config.yaml").exists()
    assert (tmp_path / "run" / "checkpoint-3" / "config.yaml").exists()
    resumed = main(_toy_config(tmp_path / "run", 6))
    assert [s for s, _ in tckpt.list_checkpoints(str(tmp_path / "run"))] == [4, 6]
    recs = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    straight = main(_toy_config(tmp_path / "straight", 6))
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
