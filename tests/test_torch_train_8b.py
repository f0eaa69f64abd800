"""Port parity for StarVector-8B training and the text2svg loss: the loss,
every gradient (decoder, SigLIP tower, LayerNorm adapter), 3 train steps
and the entry point, against starvector_tpu on the same weights (the JAX
pytree handed over with from_jax_params) and the same numpy inputs.

A tiny 8B-shaped model: a SigLIP tower (32 px, patch 8: 16 visual tokens),
the LayerNorm adapter, and a StarCoder2 decoder with 6 query heads over 2
KV heads and a sliding window of 8, so that the 16 + 12 = 28-token
sequences exceed it; svg rows are right-padded as the loader pads them. The
JAX decoder runs attn_impl="flash": its attention is the Pallas
forward-with-lse and backward in interpret mode, with the window. Adapter
dropout is off on both sides (the JAX train step passes a dropout key; the
tests wrap the JAX adapter so that it gets none). Tolerances as in
test_torch_train.py, fp32: loss 1e-5 relative; gradients rtol 1e-4 with
atol 1e-6; parameters after 3 train steps 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import adapter as jadapter
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.models.vision import siglip as jsig
from starvector_tpu.ops import layers as jlayers
from starvector_tpu.train import optim as joptim
from starvector_tpu.train import step as jstep
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.vision import siglip as tsig
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops import layers as tlayers
from starvector_tpu_torch.train import optim as toptim
from starvector_tpu_torch.train import step as tstep

JF32 = jlayers.DTypePolicy(compute_dtype=jnp.float32)
TF32 = tlayers.DTypePolicy(compute_dtype=torch.float32)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
REMATS = [False, True, "dots_flash", "dots", "dots_slim"]
WINDOW = 8
GEOMETRY = dict(num_attention_heads=6, num_key_value_heads=2, hidden_size=96,
                sliding_window=WINDOW)
VISION = dict(decoder="starcoder2", image_encoder_type="siglip_384", image_size=32,
              adapter_norm="layer_norm")


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


def _configs(task="im2svg", decoder="starcoder2"):
    """(JAX config, port config): the tiny 8B-shaped model, or for text2svg
    a tiny 1B (gpt_bigcode) or 8B-shaped (starcoder2) decoder alone."""
    if decoder == "gpt_bigcode":
        jcfg = jsv.tiny_config(task=task)
        return (dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_impl="flash")),
                tsv.tiny_config(task=task))
    vision = VISION if task == "im2svg" else dict(decoder=decoder)
    towers = (dict(vision_tower=jsig.tiny_config()), dict(vision_tower=tsig.tiny_config())) \
        if task == "im2svg" else ({}, {})
    return (jsv.tiny_config(task=task, **vision, **towers[0],
                            llm=jsc.tiny_config(attn_impl="flash", **GEOMETRY)),
            tsv.tiny_config(task=task, **vision, **towers[1], llm=tsc.tiny_config(**GEOMETRY)))


def _right_padded(B, S, lengths, vocab, rng):
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    jparams = jsv.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B, S = 3, 12
    ids, mask = _right_padded(B, S, (12, 7, 10), jcfg.llm.vocab_size, rng)
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "svg_ids": ids, "svg_mask": mask}
    assert tcfg.encoder_config.geometry[1] + S > WINDOW
    return jcfg, tcfg, jparams, batch


def _tparams(jparams):
    return tstep.mark_trainable(convert.from_jax_params(_np_tree(jparams)))


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v)
            for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(params):
    return toptim.tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)


@pytest.fixture
def jax_adapter_without_dropout(monkeypatch):
    fn = jadapter.forward
    monkeypatch.setattr(jadapter, "forward",
                        lambda *a, dropout_rng=None, **kw: fn(*a, dropout_rng=None, **kw))


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
def test_8b_loss_and_grads_match_jax(setup, jax_grads, remat, monkeypatch):
    """The loss and the gradient of every leaf, SigLIP's and the adapter's
    included, past the window, each layer's attention through the training
    kernels' plain versions (on the CPU): the forward with lse once a layer,
    and under remat=True, "dots" and "dots_slim" once more in the backward
    (as the JAX policies, which do not save the flash residuals)."""
    _, tcfg, jparams, batch = setup
    calls = {"flash_prefill_with_lse_plain": 0, "flash_backward_plain": 0}
    for name in calls:
        fn = getattr(tfa, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    (ref_loss, ref_aux), ref_grads = jax_grads[remat]
    params = _tparams(jparams)
    loss, aux = tsv.loss_fn_with_bn_stats(params, tcfg, _tbatch(batch), 0, policy=TF32,
                                          remat=remat)
    loss.backward()
    assert aux == {} and ref_aux == {}
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    _assert_trees_close(_grads(params), _np_tree(ref_grads), GRAD_TOL, f"remat={remat}")
    L = tcfg.llm.num_hidden_layers
    reruns = remat is True or remat in ("dots", "dots_slim")  # the forward again in the backward
    assert calls == {"flash_prefill_with_lse_plain": L * (2 if reruns else 1),
                     "flash_backward_plain": L}


@pytest.mark.parametrize("decoder", ["gpt_bigcode", "starcoder2"])
def test_text2svg_loss_and_grads_match_jax(decoder):
    """The text2svg loss (caption + svg ids, no vision tower) through
    loss_fn_with_bn_stats, for the tiny 1B and the tiny 8B-shaped decoder
    (its window exceeded): the loss and every gradient."""
    jcfg, tcfg = _configs("text2svg", decoder)
    jparams = jsv.init_params(jcfg, jax.random.PRNGKey(1))
    assert set(jparams) == {"svg_transformer"}
    ids, mask = _right_padded(3, 20, (20, 13, 9), jcfg.llm.vocab_size,
                              np.random.default_rng(1))
    batch = {"input_ids": ids, "input_mask": mask}
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jsv.loss_fn_with_bn_stats(p, jcfg, _jbatch(batch), 0, policy=JF32,
                                            remat="dots_flash"), has_aux=True))(jparams)
    params = _tparams(jparams)
    loss, aux = tsv.loss_fn_with_bn_stats(params, tcfg, _tbatch(batch), 0, policy=TF32,
                                          remat="dots_flash")
    loss.backward()
    assert aux == {} and ref_aux == {}
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    _assert_trees_close(_grads(params), _np_tree(ref_grads), GRAD_TOL, decoder)
    with torch.no_grad():  # the eval loss takes the same route
        assert float(tsv.loss_fn(params, tcfg, _tbatch(batch), 0, policy=TF32)) == \
            pytest.approx(float(ref_loss), rel=1e-5)


def test_8b_train_steps_match_jax(setup, jax_adapter_without_dropout):
    """3 steps of make_train_step (dots_flash, AdamW with warmup, decay and
    clipping) against the JAX make_train_step: loss, grad_norm and every
    parameter."""
    jcfg, tcfg, jparams, batch = setup
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
    losses = []
    for i in range(3):
        jp, jstate, jm = jtrain(jp, jstate, _jbatch(batch), jax.random.PRNGKey(i))
        tparams, tstate, tm = ttrain(tparams, tstate, _tbatch(batch), None)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        _assert_trees_close(tparams, _np_tree(jp), PARAM_TOL, f"step {i}")
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each of x's values (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def test_8b_grad_dtype_adafactor_steps_match_jax(setup, jax_adapter_without_dropout):
    """grad_dtype=bf16 (the v5e-8 recipe's): the gradients with respect to
    the bf16 cast of every leaf, and 3 steps of make_train_step with
    Adafactor (warmup 1, clipping) and dots_flash, against the JAX step's
    grad_dtype=jnp.bfloat16, at an fp32 compute policy so that both sides
    round each fp32 gradient once. Gradients: at least 99% of elements
    equal in bf16 and every one within one bf16 ulp or the fp32 gradients'
    own tolerance (GRAD_TOL: a sum that cancels differs in its low bits
    before the rounding); loss 1e-5 relative, grad_norm 1e-4; parameters
    1e-5 relative with atol 1e-6 (5% of one step here: a gradient one ulp
    apart moves its element's Adafactor step by ~2^-8). The tower's key
    biases are the exception: attention is invariant to a shift of every
    key, so their gradient is rounding noise, which Adafactor scales up to
    a full step of the floor size (lr x 1e-3) with a noise-given sign on
    each side; they may differ by two such steps a step."""
    jcfg, tcfg, jparams, batch = setup
    low = jax.tree_util.tree_map(lambda w: w.astype(jnp.bfloat16), jparams)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jsv.loss_fn_with_bn_stats(p, jcfg, _jbatch(batch), 0, policy=JF32,
                                            remat="dots_flash"), has_aux=True))(low)
    tlow = tstep.mark_trainable(convert.from_jax_params(_np_tree(jparams), dtype=torch.bfloat16))
    loss, _ = tsv.loss_fn_with_bn_stats(tlow, tcfg, _tbatch(batch), 0, policy=TF32,
                                        remat="dots_flash")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got, ref = _flat(_grads(tlow)), _flat(_np_tree(jg))
    assert got.keys() == ref.keys()
    same = total = 0
    for k, r in ref.items():
        g = got[k]
        assert g.dtype == torch.bfloat16, k
        r = np.asarray(r, np.float32)
        g = g.float().numpy()
        diff = np.abs(g - r)
        bound = np.maximum(_bf16_ulp(r), GRAD_TOL["rtol"] * np.abs(r) + GRAD_TOL["atol"])
        assert (diff <= bound).all(), (k, diff.max())
        same += (g == r).sum()
        total += r.size
    assert same / total >= 0.99, same / total

    kw = dict(optimizer="adafactor", lr=1e-3, warmup_steps=1, total_steps=10)
    tx = joptim.build_optimizer(jparams, **kw)
    jstate = tx.init(jparams)
    jtrain = jstep.make_train_step(jcfg, tx, 0, policy=JF32, remat="dots_flash",
                                   grad_dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(jnp.copy, jparams)
    tparams = _tparams(jparams)
    opt = toptim.build_optimizer(tparams, **kw)
    tstate = opt.init(tparams)
    ttrain = tstep.make_train_step(tcfg, opt, 0, policy=TF32, remat="dots_flash",
                                   grad_dtype=torch.bfloat16)
    for i in range(3):
        jp, jstate, jm = jtrain(jp, jstate, _jbatch(batch), jax.random.PRNGKey(i))
        tparams, tstate, tm = ttrain(tparams, tstate, _tbatch(batch), None)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert all(p.dtype == torch.float32 for p in toptim.tree_leaves(tparams))
        got, ref = _flat(tparams), _flat(_np_tree(jp))
        assert got.keys() == ref.keys()
        for k, r in ref.items():
            g = got[k].detach().numpy()
            if k[0] == "image_encoder" and k[-2:] == ("k_proj", "bias"):  # noise (docstring)
                assert np.abs(g - r).max() <= 2 * kw["lr"] * 1e-3 * (i + 1), (i, k)
            else:
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=f"step {i} {k}")


def test_8b_remat_modes_refused_or_unknown(setup):
    """"dots" and "dots_slim" (refused before they were ported) give
    remat=False's loss (1e-5) and every gradient (GRAD_TOL), fp32, for the
    StarCoder2 decoder past its window, and keep fewer bytes from the
    forward for the backward: dots_slim < dots < False; an unknown mode
    raises ValueError."""
    from test_torch_train import remat_bytes_and_grads

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


TINY_V2_YAML = """
model:
  preset: tiny-v2
  adapter_norm: layer_norm
  max_length: 128
training:
  steps: 3
  epochs: 2
  lr: 1.0e-3
  lr_scheduler: constant
  lr_warmup_steps: 0
  log_every: 1
  bf16: false
  checkpointing_steps: 3
  gradient_checkpointing: dots_flash
  device: cpu
data:
  batch_size: 2
  max_length: 64
  num_workers: 1
  train:
    target: starvector_tpu.data.datasets.ToySVGDataset
    params: {num_samples: 4, im_size: 28}
  val: null
"""


def test_train_main_tiny_v2_end_to_end(tmp_path):
    """train.main on a tiny-v2 yaml (the StarCoder2 decoder, a LayerNorm
    adapter: no BatchNorm statistics anywhere in the tree): the v2 test
    tokenizer, 3 logged steps with finite losses, and a checkpoint whose
    parameters are the returned ones."""
    from starvector_tpu_torch.config import get_config
    from starvector_tpu_torch.train import checkpoint as tckpt
    from starvector_tpu_torch.train.train import main

    path = tmp_path / "tiny-v2.yaml"
    path.write_text(TINY_V2_YAML)
    out = tmp_path / "run"
    config = get_config([f"config={path}", f"project.out_dir={out}"])
    params = main(config)
    assert set(params) == {"svg_transformer", "image_encoder", "image_projection"}
    assert "running_mean" not in params["image_projection"]["norm"]
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    last = tckpt.get_last_checkpoint(str(out))
    assert tckpt.step_from_path(last) == 3
    saved = tckpt.restore_checkpoint(last)["params"]
    for a, b in zip(toptim.tree_leaves(saved), toptim.tree_leaves(params)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_causal_lm_loss_over_the_starcoder2_head():
    """The 8B's loss tail: causal_lm_loss_fused over starcoder2's tied
    head table and over an untied lm_head, as the JAX loss_fn takes it."""
    rng = np.random.default_rng(5)
    for tie in (True, False):
        jcfg = jsc.tiny_config(tie_word_embeddings=tie)
        tcfg = tsc.tiny_config(tie_word_embeddings=tie)
        jp = jsc.init_params(jcfg, jax.random.PRNGKey(2))
        hidden = rng.standard_normal((2, 9, jcfg.hidden_size)).astype(np.float32)
        labels = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
        labels[1, 6:] = -100
        ref = jgbc.causal_lm_loss_fused(jsc.lm_head_table(jp, jcfg), jnp.asarray(hidden),
                                        jnp.asarray(labels), policy=JF32)
        tp = convert.from_jax_params(_np_tree(jp))
        got = tgbc.causal_lm_loss_fused(tsc.lm_head_table(tp, tcfg), torch.from_numpy(hidden),
                                        torch.from_numpy(labels), policy=TF32)
        assert ("lm_head" in tp) is not tie
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


V5E8 = "configs/models/starvector-8b/im2svg-stack-v5e8.yaml"


def _v5e8_config(out, steps, one_device=True):
    """The v5e-8 recipe's yaml (adafactor, grad_dtype bfloat16, dots_flash)
    at the tiny-v2 preset: a tiny CLIP tower at 28 px in place of SigLIP-L
    at 384 (too large for a CPU test), the toy dataset in place of
    SVG-Stack, 64 svg tokens, on the CPU; with `one_device` its mesh block
    (fsdp 4 x sequence 2) overridden to one process's (fsdp -1, sequence 1)."""
    from starvector_tpu_torch.config import get_config, resolve_repo_config

    mesh = ["mesh.fsdp=-1", "mesh.sequence=1"] if one_device else []
    config = get_config(
        [f"config={V5E8}", *mesh, "model.preset=tiny-v2", "model.image_encoder_type=clip",
         "model.image_size=28", "data.max_length=64", "data.batch_size=2",
         "data.num_workers=1", "data.val=null", f"training.steps={steps}", "training.epochs=4",
         "training.log_every=1", "training.checkpointing_steps=2", "training.lr=1e-3",
         "training.lr_scheduler=constant", "training.lr_warmup_steps=0", "training.device=cpu",
         f"project.out_dir={out}"], default_path=resolve_repo_config())
    config["data"]["train"] = {"target": "starvector_tpu.data.datasets.ToySVGDataset",
                               "params": {"num_samples": 6, "im_size": 28}}
    return config


def test_train_main_v5e8_recipe_end_to_end_with_resume(tmp_path):
    """train.main on the v5e-8 recipe (_v5e8_config): its mesh block
    (fsdp 4 x sequence 2, 8 devices) started as one process raises
    ValueError (the JAX rule: the mesh must cover the devices) before
    anything is written; on one device, Adafactor state, bf16 gradients,
    fp32 masters; a run cut after 2 steps and resumed to 4 continues the
    step count with finite losses; the run directory holds config.yaml,
    experiment_id.txt (the config's md5, 12 hex digits, as the JAX main
    writes it), metrics.jsonl and the code snapshot."""
    from starvector_tpu_torch.train import checkpoint as tckpt
    from starvector_tpu_torch.train.train import main
    from starvector_tpu_torch.utils.experiment import generate_experiment_id

    out = tmp_path / "run"
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        main(_v5e8_config(out, 2, one_device=False))
    assert not out.exists()
    main(_v5e8_config(out, 2))
    config = _v5e8_config(out, 4)
    params = main(config)
    assert all(p.dtype == torch.float32 for p in toptim.tree_leaves(params))
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    assert [s for s, _ in tckpt.list_checkpoints(str(out))] == [2, 4]
    state = tckpt.restore_checkpoint(tckpt.get_last_checkpoint(str(out)))["opt_state"]
    assert state["count"] == 4 and {"v_row", "v_col", "v"} <= set(state)
    assert (out / "experiment_id.txt").read_text().strip() == \
        generate_experiment_id(config)[:12]
    assert (out / "config.yaml").exists()
    assert (out / "code_snapshot" / "starvector_tpu_torch" / "train" / "train.py").exists()


def test_train_main_from_a_checkpoint_takes_its_tokenizer_and_fp32_masters(tmp_path,
                                                                           monkeypatch):
    """Where the port's main differs from the JAX one on purpose, starting
    from a checkpoint directory (model.model_name): the run takes the
    checkpoint's own tokenizer (the JAX main takes the test tokenizer
    without model.tokenizer_path), and the checkpoint's weights, written
    from bf16 here, become fp32 masters (the JAX builder loads bf16). At
    lr 0 the step leaves them as they were loaded."""
    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.train import loader
    from starvector_tpu_torch.train.hub import export_hf_checkpoint
    from starvector_tpu_torch.train.train import main

    cfg = tsv.tiny_config(decoder="starcoder2", adapter_norm="layer_norm")
    weights = sv.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    tok = build_test_tokenizer("v2")
    tok.tokenizer.add_tokens(["<only-in-this-checkpoint>"])
    export_hf_checkpoint(weights, cfg, tok, str(tmp_path / "ckpt"))
    seen = []

    class Recording(loader.DataLoader):
        def __init__(self, dataset, tokenizer, *a, **kw):
            seen.append(tokenizer)
            super().__init__(dataset, tokenizer, *a, **kw)

    monkeypatch.setattr(loader, "DataLoader", Recording)
    config = _v5e8_config(tmp_path / "run", 1)
    config["model"]["model_name"] = str(tmp_path / "ckpt")
    config["training"]["lr"] = 0.0
    params = main(config)
    assert seen and seen[0].tokenizer.token_to_id("<only-in-this-checkpoint>") is not None
    assert build_test_tokenizer("v2").tokenizer.token_to_id("<only-in-this-checkpoint>") is None
    for a, b in zip(toptim.tree_leaves(params), toptim.tree_leaves(weights)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a.detach(), b.float(), rtol=0, atol=0)
