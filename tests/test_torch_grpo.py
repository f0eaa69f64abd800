"""Port parity for GRPO (models/starvector.py::grpo_forward,
gpt_bigcode.token_logprobs_fused, train/grpo.py, metrics/ssim.py) against
starvector_tpu on the same numpy weights and one fixed rollout.

The model is sv.tiny_config(); the JAX decoder runs attn_impl="flash", so
its uncached attention is the Pallas forward-with-lse and backward in
interpret mode (as tests/test_torch_train.py). The rollout: B = 2 images'
visual prefixes (5 tokens), G = 2 rollouts each of a 3-token prompt and up
to 6 generated tokens, right-padded. Tolerances, fp32: log-probs 1e-5;
the loss 1e-5 relative; gradients rtol 1e-4 with atol 1e-6 (the training
tests' GRAD_TOL); parameters after one update 1e-5. The rewards (the
port's rasterizer and SSIM copy) and advantages equal JAX's at 1e-6.
GRPOTrainer.step runs end to end on the tiny model with a stand-in reward
(the tiny model's rollouts are not SVG).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu.train import grpo as jgrpo
from starvector_tpu.train import optim as joptim
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from starvector_tpu_torch.train import grpo as tgrpo
from starvector_tpu_torch.train import optim as toptim
from starvector_tpu_torch.train.optim import tree_leaves

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(compute_dtype=torch.float32)
LP_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
B, G, Q, P, T = 2, 2, 5, 3, 6
RED = ('<svg xmlns="http://www.w3.org/2000/svg" width="32" height="32">'
       '<rect width="32" height="32" fill="red"/></svg>')
BLUE = RED.replace("red", "blue")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items() for p, leaf in _flat(v, prefix + (k,)).items()}
    return {prefix: tree}


def _assert_trees_close(got, ref, tol, what=""):
    got, ref = _flat(got), _flat(ref)
    assert set(got) == set(ref), what
    for path, r in ref.items():
        g = got[path]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"{what} {'/'.join(path)}", **tol)


def _configs(decoder):
    if decoder == "gpt_bigcode":
        return (jsv.tiny_config(llm=jgbc.tiny_config(attn_impl="flash")),
                tsv.tiny_config(llm=tgbc.tiny_config()))
    kw = dict(num_attention_heads=4, num_key_value_heads=2, sliding_window=8)
    return (jsv.tiny_config(decoder=decoder, llm=jsc.tiny_config(attn_impl="flash", **kw)),
            tsv.tiny_config(decoder=decoder, llm=tsc.tiny_config(**kw)))


def _rollout(cfg, seed=0):
    """A fixed rollout: visual prefixes, [prompt ‖ generated] ids with
    ragged lengths (6, 4, 6, 1), their masks and advantages."""
    rng = np.random.default_rng(seed)
    vis = (rng.standard_normal((B, Q, cfg.llm.hidden_size)) * 0.5).astype(np.float32)
    ids = rng.integers(1, cfg.llm.vocab_size, (B * G, P + T))
    lengths = np.asarray([6, 4, 6, 1])
    pos = np.arange(P + T)[None, :]
    attn = (pos < P + lengths[:, None]).astype(np.int32)
    ids = np.where(attn > 0, ids, 0)
    loss = attn * (pos >= P).astype(np.int32)
    adv = np.asarray([1.0, -1.0, 0.5, -0.5], np.float32)
    return vis, ids, attn, loss, adv


@pytest.fixture(scope="module", params=["gpt_bigcode", "starcoder2"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


@pytest.mark.parametrize("remat", [False, "dots"])
def test_grpo_forward_matches_jax(model, remat):
    jcfg, tcfg, tree = model
    vis, ids, attn, _, _ = _rollout(jcfg)
    ref = jsv.grpo_forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(vis),
                           jnp.asarray(ids, jnp.int32), jnp.asarray(attn), num_generations=G,
                           policy=JF32, remat=remat)
    out = tsv.grpo_forward(convert.from_jax_params(tree), tcfg, torch.from_numpy(vis),
                           torch.from_numpy(ids), torch.from_numpy(attn), num_generations=G,
                           policy=TF32, remat=remat)
    assert out.shape == (B * G, P + T) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LP_TOL)
    assert (out.numpy()[attn == 0] == 0).all() and (out.numpy()[attn > 0] < 0).all()


def test_token_logprobs_fused_matches_the_unfused_log_softmax():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
    hidden = torch.from_numpy(rng.standard_normal((3, 11, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (3, 11)))
    ref = torch.log_softmax(hidden @ table.T, dim=-1).gather(-1, ids[..., None])[..., 0]
    for chunk in (4, 11, 128):
        out = tgbc.token_logprobs_fused(table, hidden, ids, policy=TF32, chunk=chunk)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    jref = jgbc.token_logprobs_fused(jnp.asarray(table.numpy()), jnp.asarray(hidden.numpy()),
                                     jnp.asarray(ids.numpy()), policy=JF32, chunk=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **LP_TOL)
    # the backward recomputes each chunk's logits: the gradient is the unfused one's
    h = hidden.clone().requires_grad_()
    g_fused, = torch.autograd.grad(
        tgbc.token_logprobs_fused(table, h, ids, policy=TF32, chunk=4).sum(), h)
    g_ref, = torch.autograd.grad(torch.log_softmax(h @ table.T, -1).gather(
        -1, ids[..., None]).sum(), h)
    torch.testing.assert_close(g_fused, g_ref, rtol=1e-5, atol=1e-6)


def test_rewards_and_advantages_match_jax():
    from starvector_tpu.data.rasterize import rasterize_svg as jrasterize

    target = np.asarray(jrasterize(RED, resolution=64))
    for svg in (RED, BLUE, "<svg><rect", "not an svg at all"):
        ref = jgrpo.svg_pixel_reward(svg, target, resolution=64)
        out = tgrpo.svg_pixel_reward(svg, target, resolution=64)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert tgrpo.svg_pixel_reward("not an svg at all", target, resolution=64) == 0.0
    assert tgrpo.svg_pixel_reward(RED, target, resolution=64) > 0.95
    # a target of another size is resized to the render's
    np.testing.assert_allclose(tgrpo.svg_pixel_reward(BLUE, target[:40, :50], resolution=64),
                               jgrpo.svg_pixel_reward(BLUE, target[:40, :50], resolution=64),
                               rtol=1e-6)
    t_blue = np.asarray(jrasterize(BLUE, resolution=32))
    t_red = np.asarray(jrasterize(RED, resolution=32))
    kw = dict(num_generations=2, resolution=32)
    ref = jgrpo.batch_rewards([RED, BLUE, RED, BLUE], [t_red, t_blue], **kw)
    out = tgrpo.batch_rewards([RED, BLUE, RED, BLUE], [t_red, t_blue], **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert out[0] > out[1] and out[3] > out[2]  # grouped [p0 x G, p1 x G]
    with pytest.raises(ValueError):
        tgrpo.batch_rewards([RED], [t_red, t_blue], **kw)
    r = np.asarray([1.0, 3.0, 0.0, 0.0, 2.0, 2.0, 2.0, 2.0], np.float32)
    np.testing.assert_allclose(tgrpo.group_advantages(torch.from_numpy(r), 4).numpy(),
                               np.asarray(jgrpo.group_advantages(jnp.asarray(r), 4)),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def fixed():
    """The 1B tiny model's fixed rollout with behaviour and reference
    log-probs that differ from the model's (so the ratio clips and the KL
    is not zero)."""
    jcfg, tcfg = _configs("gpt_bigcode")
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    vis, ids, attn, loss, adv = _rollout(jcfg)
    lp = np.asarray(jsv.grpo_forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                     jnp.asarray(vis), jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(attn), num_generations=G, policy=JF32))
    rng = np.random.default_rng(5)
    old = (lp + rng.uniform(-0.4, 0.4, lp.shape) * attn).astype(np.float32)
    ref = (lp + rng.uniform(-0.2, 0.2, lp.shape) * attn).astype(np.float32)
    roll = dict(vision_embeds=vis, ids=ids, attn_mask=attn, loss_mask=loss)
    return jcfg, tcfg, tree, roll, adv, old, ref


CASES = {"ratio 1": (0.0, False), "old_lp and KL": (0.1, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_grpo_loss_and_gradients_match_jax(fixed, case):
    jcfg, tcfg, tree, roll, adv, old, ref = fixed
    kl_beta, with_old = CASES[case]
    kw = dict(num_generations=G, clip_eps=0.2, kl_beta=kl_beta)
    jroll = {k: jnp.asarray(v) for k, v in roll.items()}

    def jloss(params):
        return jgrpo.grpo_loss(params, jcfg, jroll["vision_embeds"], jroll["ids"],
                               jroll["attn_mask"], jroll["loss_mask"],
                               jnp.asarray(old) if with_old else None, jnp.asarray(adv),
                               jnp.asarray(ref) if kl_beta else None, policy=JF32, **kw)

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = convert.from_jax_params(tree)
    dec = tree_leaves(params["svg_transformer"])
    for p in dec:
        p.requires_grad_()
    troll = {k: torch.from_numpy(v) for k, v in roll.items()}
    loss, aux = tgrpo.grpo_loss(params, tcfg, troll["vision_embeds"], troll["ids"],
                                troll["attn_mask"], troll["loss_mask"],
                                torch.from_numpy(old) if with_old else None, torch.from_numpy(adv),
                                torch.from_numpy(ref) if kl_beta else None, policy=TF32, **kw)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for key in ("kl", "clip_frac", "mean_ratio"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5, atol=1e-7)
    assert (float(aux["clip_frac"]) > 0) == with_old and (float(aux["kl"]) > 0) == bool(kl_beta)
    grads = torch.autograd.grad(loss, dec)
    ref_grads = _flat(jgrads["svg_transformer"])
    for (path, r), g in zip(ref_grads.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg="/".join(path), **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_grpo_step_matches_jax(fixed, case):
    """One make_grpo_step update (AdamW at lr 1e-3, only the decoder
    trainable, global-norm clip 1.0) from the same parameters. eps 1e-6:
    the key bias's gradient is rounding noise (attention is invariant to a
    key shift shared by every key), which Adam at eps 1e-8 would scale up
    to a step of ~lr with a noise-given sign on each side."""
    jcfg, tcfg, tree, roll, adv, old, ref = fixed
    kl_beta, with_old = CASES[case]
    jroll = {k: jnp.asarray(v) for k, v in roll.items()}
    troll = {k: torch.from_numpy(v) for k, v in roll.items()}
    if with_old:
        jroll["old_lp"], troll["old_lp"] = jnp.asarray(old), torch.from_numpy(old)
    if kl_beta:
        jroll["ref_lp"], troll["ref_lp"] = jnp.asarray(ref), torch.from_numpy(ref)
    okw = dict(lr=1e-3, eps=1e-6, weight_decay=0.0, train_image_encoder=False,
               train_connector=False)
    skw = dict(num_generations=G, clip_eps=0.2, kl_beta=kl_beta)

    jparams = jax.tree_util.tree_map(jnp.array, tree)
    tx = joptim.build_optimizer(jparams, **okw)
    jstep = jgrpo.make_grpo_step(jcfg, tx, policy=JF32, **skw)
    jparams, _, jm = jstep(jparams, tx.init(jparams), jroll, jnp.asarray(adv))

    params = convert.from_jax_params(tree)
    for p in tree_leaves(params["svg_transformer"]):
        p.requires_grad_()
    opt = toptim.build_optimizer(params, **okw)
    step = tgrpo.make_grpo_step(tcfg, opt, policy=TF32, **skw)
    params, _, m = step(params, opt.init(params), troll, torch.from_numpy(adv))
    for key in ("loss", "grad_norm", "kl", "clip_frac", "mean_ratio"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    _assert_trees_close(params, jax.tree_util.tree_map(np.asarray, jparams), PARAM_TOL, case)
    assert not np.allclose(params["svg_transformer"]["wte"].detach().numpy(),
                           tree["svg_transformer"]["wte"])


def test_grpo_trainer_step_runs(monkeypatch):
    """GRPOTrainer.step end to end on the tiny 1B: a sampled rollout of
    G = 2 rows an image (B = 2), a stand-in reward, two updates a rollout
    with behaviour log-probs and the KL to the copied decoder. The decoder
    moves; the tower and the adapter do not; the update is conditioned on
    the tower's own visual tokens (17 at 28 px)."""
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

    cfg = tsv.tiny_config()
    model = StarVectorForCausalLM.from_config(cfg, seed=0, tokenizer=build_test_tokenizer("v1"),
                                              device="cpu")
    before = {k: v.clone() for k, v in _flat(model.params).items()}
    seen = {}

    def stand_in(raw_svgs, targets, *, num_generations, **kw):
        seen.update(n=len(raw_svgs), raw=raw_svgs)
        return np.linspace(0.0, 1.0, len(raw_svgs), dtype=np.float32)

    monkeypatch.setattr(tgrpo, "batch_rewards", stand_in)
    trainer = tgrpo.GRPOTrainer(model, tgrpo.GRPOConfig(num_generations=2, max_new_tokens=6,
                                                        updates_per_rollout=2, kl_beta=0.1),
                                lr=1e-3)
    step_fn = trainer._step_fn

    def spy(params, opt_state, rollout, advantages):
        seen.update(Q=rollout["vision_embeds"].shape[1], keys=sorted(rollout))
        return step_fn(params, opt_state, rollout, advantages)

    trainer._step_fn = spy
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 28, 28, 3)).astype(np.float32))
    out = trainer.step(images, [np.zeros((28, 28, 3), np.uint8)] * 2)
    assert seen["n"] == 4 and all(s.startswith("<svg") for s in seen["raw"])
    assert seen["Q"] == 17 and seen["keys"] == ["attn_mask", "ids", "loss_mask", "old_lp",
                                                  "ref_lp", "vision_embeds"]
    assert out["step"] == 1 and all(np.isfinite(v) for v in out.values())
    assert out["kl"] > 0.0  # the second update moved away from the reference
    assert {"rollout_s", "reward_s", "update_s"} <= set(out)
    for path, v in _flat(model.params).items():
        assert torch.equal(v.detach(), before[path]) == (path[0] != "svg_transformer"), path
