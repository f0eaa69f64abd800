"""The port's Adafactor and AdamW's bf16 first moment (`mu_dtype`) against
the JAX package's optax chains (starvector_tpu/train/optim.py:
optax.adafactor(schedule) and optax.adamw(mu_dtype=...) behind
clip_by_global_norm, the freeze mask and MultiSteps).

The parameter tree has the shapes Adafactor treats apart: 1-D leaves and
2-D leaves below 128 (a full second moment), 2-D leaves with both dims at
least 128 (factored, either one the larger), and 3-D stacked layers
(factored over their two trailing dims, which the port walks a layer at a
time), under the three top-level components so that a freeze mask applies.
Gradients are random, the global norm above the clip on some updates and
below it on others.

Tolerances, fp32: Adafactor's parameters 1e-6 relative (atol 1e-8 for
elements near zero, 2e-5 of one update's size here) after each of 5
updates. AdamW with a bf16 first
moment: the stored moment is rounded to bf16 on both sides, so a sum that
lands within an fp32 rounding of a bf16 rounding boundary can round the
other way on one side; such flips are rare and each moves the next update
of its element by at most one bf16 step of the moment. So: the moments
equal bit for bit on all but 1e-3 of the elements (and there within one
bf16 ulp, or 1e-9 where the sum cancels to near zero); the parameters
within the fp32 AdamW test's 1e-5 relative (test_torch_train.py; atol 1e-6,
1e-4 of an update here) on all but 1e-3 of the elements, and all within
lr x 2^-6 per update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from starvector_tpu.train import optim as joptim
from starvector_tpu_torch.train import optim as toptim

SHAPES = {
    "svg_transformer": {"layers": {"kernel": (2, 128, 256), "wide": (3, 256, 160),
                                   "bias": (2, 40)},
                        "embed": (300, 130), "small": (20, 50)},
    "image_encoder": {"w": (140, 130), "b": (7,)},
    "image_projection": {"w": (130, 200), "b": (200,), "scale": (64,)},
}


def _params(seed=0):
    rng = np.random.default_rng(seed)

    def make(tree):
        return {k: make(v) if isinstance(v, dict) else
                (rng.standard_normal(v) * 0.05).astype(np.float32) for k, v in tree.items()}

    return make(SHAPES)


def _paths(tree, prefix=()):
    """Leaf paths in the port's (insertion) order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _run(kw, jkw, tkw, updates, rng_seed=1, grad_dtype=np.float32):
    """`updates` optimizer steps (x grad_accum_steps calls) on both sides,
    the gradients rounded to `grad_dtype`: the port takes them in that type,
    the JAX chain widened to fp32 first, as its make_train_step does with
    grad_dtype; yields (call, JAX params, port params, JAX state, port
    state)."""
    params = _params()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = joptim.build_optimizer(jp, **kw, **jkw)
    js = tx.init(jp)
    jupdate = jax.jit(tx.update)
    tp = _to_torch(params)
    opt = toptim.build_optimizer(tp, **kw, **tkw)
    ts = opt.init(tp)
    rng = np.random.default_rng(rng_seed)
    for i in range(updates * kw.get("grad_accum_steps", 1)):
        scale = 0.5 if i % 3 == 0 else 0.01  # global norms above and below the clip
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(grad_dtype), params)
        wide = jax.tree_util.tree_map(lambda a: a.astype(np.float32), grads)
        u, js = jupdate(jax.tree_util.tree_map(jnp.asarray, wide), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.update(jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a).to(getattr(torch, np.dtype(grad_dtype).name)),
            wide), ts, tp)
        yield i, jp, tp, js, ts


def test_factored_dims_follow_optax():
    from optax._src import factorized

    for shape in [(7,), (20, 50), (127, 300), (128, 128), (130, 200), (200, 130),
                  (2, 128, 256), (3, 256, 160), (300, 2, 200), (128, 4, 128)]:
        assert toptim.Adafactor.factored_dims(shape) == \
            factorized._factored_dims(shape, True, 128), shape


@pytest.mark.parametrize("accum,frozen,grad_dtype",
                         [(2, True, np.float32), (1, False, np.float32),
                          (2, True, jnp.bfloat16)],
                         ids=["accum2-frozen", "plain", "accum2-bf16-grads"])
def test_adafactor_matches_optax(accum, frozen, grad_dtype):
    """5 updates of build_optimizer(optimizer="adafactor") with warmup,
    clipping and, in two cases, grad_accum_steps=2 and a frozen image
    encoder; the frozen leaves stay as they were. With bf16 gradients
    (make_train_step's grad_dtype) both sides average them into an fp32
    accumulator (optax's acc_grads), which the port hands to Adafactor
    itself and then zeroes: no copy of it is left in the state."""
    kw = dict(optimizer="adafactor", lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0,
              grad_accum_steps=accum, train_image_encoder=not frozen)
    start = _params()
    acc = None
    for i, jp, tp, _, ts in _run(kw, {}, {}, 5, grad_dtype=grad_dtype):
        for path in _paths(tp):
            np.testing.assert_allclose(_at(tp, path).numpy(), np.asarray(_at(jp, path)),
                                       rtol=1e-6, atol=1e-8, err_msg=f"call {i} {path}")
        if accum > 1:
            acc = acc or list(ts["acc"])
            assert all(a is b and a.dtype == torch.float32 for a, b in zip(ts["acc"], acc))
            assert all(not a.any() for a in acc) == (i % accum == accum - 1), i
    assert ts["count"] == 5
    if frozen:
        np.testing.assert_array_equal(tp["image_encoder"]["w"].numpy(),
                                      start["image_encoder"]["w"])
    # the state is the factored statistics for the large leaves only
    leaves = toptim.tree_leaves(tp)
    for p, vr, vc, v in zip(leaves, ts["v_row"], ts["v_col"], ts["v"]):
        if v is None and vr is None:  # frozen
            continue
        dims = toptim.Adafactor.factored_dims(p.shape)
        assert (v is None) == (dims is not None) and (vr is None) == (dims is None)


def test_adamw_mu_dtype_matches_optax():
    """3 updates of AdamW with mu_dtype bf16 against optax.adamw(mu_dtype=
    jnp.bfloat16): the first moment is stored in bf16, the second in fp32,
    and the updates agree (the module docstring's bounds)."""
    kw = dict(optimizer="adamw", lr=1e-2, warmup_steps=0, total_steps=20, grad_clip=1.0,
              weight_decay=0.1, betas=(0.9, 0.999), eps=1e-8)
    lr, steps = 1e-2, 3
    for i, jp, tp, js, ts in _run(kw, dict(mu_dtype=jnp.bfloat16), dict(mu_dtype=torch.bfloat16),
                                  steps):
        adam = [s for s in jax.tree_util.tree_leaves(
            js, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        paths = _paths(tp)
        assert all(m.dtype == torch.bfloat16 for m in ts["mu"])
        assert all(v.dtype == torch.float32 for v in ts["nu"])
        got_mu = np.concatenate([m.float().numpy().ravel() for m in ts["mu"]])
        ref_mu = np.concatenate([np.asarray(_at(adam[0].mu, q), np.float32).ravel()
                                 for q in paths])
        off = got_mu != ref_mu
        assert off.mean() <= 1e-3, (i, off.mean())
        np.testing.assert_allclose(got_mu[off], ref_mu[off], rtol=2**-7, atol=1e-9)
        got = np.concatenate([_at(tp, q).numpy().ravel() for q in paths])
        ref = np.concatenate([np.asarray(_at(jp, q)).ravel() for q in paths])
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 1 - 1e-3, (i, close.mean())
        assert np.abs(got - ref).max() <= lr * 2**-6 * (i + 1), i
