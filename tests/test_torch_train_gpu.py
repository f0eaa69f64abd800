"""The 8B recipe's training parts and the checkpoint round trip on the card
against the same run on the CPU. Every test here is marked `gpu` and skips
without a card; the file imports no JAX, so on the card it runs as
    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py

The model is a tiny text2svg StarCoder2 with head size 128 (the attention
kernels take D = 128 only): 2 query heads over 1 KV head, a window of 16
past which the 40-token rows reach; no vision tower, so no parameter's
gradient is pure rounding noise. fp32 compute: on the card the training
kernels' fp32 versions, on the CPU their plain versions, the sums in
another order. Tolerances: losses 1e-5 relative, gradients within the
CPU training tests' GRAD_TOL (rtol 1e-4, atol 1e-6) or one bf16 ulp, the
parameters after 3 Adafactor steps at lr 1e-3 1e-5 relative with atol
1e-6 (5% of one step: a gradient one bf16 ulp apart moves its element's
step by ~2^-8); the exported and reloaded parameters bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from starvector_tpu_torch.models import starcoder2 as tsc
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.train import optim as toptim
from starvector_tpu_torch.train import step as tstep

F32 = DTypePolicy(torch.float32, torch.float32)
LR = 1e-3  # a step moves a weight by ~lr x its leaf's RMS (0.018 here): 1.8e-5
CFG = tsv.tiny_config(task="text2svg", decoder="starcoder2", llm=tsc.tiny_config(
    hidden_size=256, intermediate_size=512, num_attention_heads=2, num_key_value_heads=1,
    sliding_window=16))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(device):
    params = tsv.init_params(CFG, torch.Generator().manual_seed(0))
    return tstep.mark_trainable(toptim.tree_map(lambda p: p.to(device), params))


def _batch(device):
    rng = np.random.default_rng(0)
    B, S = 2, 40
    mask = (np.arange(S)[None, :] < np.array([[40], [29]])).astype(np.int32)
    ids = np.where(mask > 0, rng.integers(1, CFG.llm.vocab_size, (B, S)), 0)
    return {"input_ids": torch.from_numpy(ids).long().to(device),
            "input_mask": torch.from_numpy(mask).to(device)}


def _steps(device, remat):
    """3 Adafactor steps with bf16 gradients: (losses, grad norms, params)."""
    params = _params(device)
    opt = toptim.build_optimizer(params, optimizer="adafactor", lr=LR, warmup_steps=0)
    state = opt.init(params)
    step = tstep.make_train_step(CFG, opt, 0, policy=F32, remat=remat,
                                 grad_dtype=torch.bfloat16)
    losses, norms = [], []
    for _ in range(3):
        params, state, m = step(params, state, _batch(device))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["dots_flash", "dots", "dots_slim"])
def test_adafactor_bf16_grad_steps_on_the_card_match_the_cpu(cuda, remat):
    """The recipe's step (Adafactor, grad_dtype bf16) under each of the
    selective remat modes, through the training kernels, against the CPU:
    loss, grad norm and every parameter; the kernels launched."""
    for name in ("flash_prefill_with_lse", "flash_bwd_dkdv", "flash_bwd_dq"):
        getattr(tfa, name).launches = 0
    got = _steps(cuda, remat)
    torch.cuda.synchronize()
    L = CFG.llm.num_hidden_layers
    reruns = 2 if remat != "dots_flash" else 1  # the forward again in the backward
    assert tfa.flash_prefill_with_lse.launches == 3 * L * reruns
    assert tfa.flash_bwd_dkdv.launches == tfa.flash_bwd_dq.launches == 3 * L
    ref = _steps("cpu", remat)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
    assert got[0][-1] < got[0][0]
    for (path, a), (_, b) in zip(_named(got[2]), _named(ref[2])):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5, atol=1e-6,
                                   msg=lambda m, path=path: f"{path}: {m}")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.gpu
def test_bf16_gradients_on_the_card_match_the_cpu(cuda):
    """The gradients with respect to the bf16 cast (grad_dtype's): bf16 on
    both sides, each within one bf16 ulp or GRAD_TOL of the CPU's."""
    grads = {}
    for device in (cuda, torch.device("cpu")):
        low = toptim.tree_map(lambda p: p.detach().bfloat16().requires_grad_(), _params(device))
        loss, _ = tsv.loss_fn_with_bn_stats(low, CFG, _batch(device), 0, policy=F32,
                                            remat="dots_flash")
        loss.backward()
        grads[device.type] = [p.grad.float().cpu() for p in toptim.tree_leaves(low)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        ulp = 2.0 ** (torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
        assert ((a - b).abs() <= torch.maximum(ulp, 1e-4 * b.abs() + 1e-6)).all()


@pytest.mark.gpu
def test_export_round_trip_on_the_card(cuda, tmp_path):
    """Parameters on the card -> export_hf_checkpoint -> load_pretrained_model
    onto the card: the same tensors, bit for bit, and the same config
    (but max_position_embeddings, which the checkpoint does not carry)."""
    from starvector_tpu_torch.models import builder
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.train.hub import export_hf_checkpoint

    cfg = tsv.tiny_config(decoder="starcoder2", image_encoder_type="clip", image_size=28,
                          adapter_norm="layer_norm", llm=CFG.llm, max_length_train=1024)
    params = tsv.init_params(cfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    export_hf_checkpoint(params, cfg, build_test_tokenizer("v2"), str(tmp_path))
    got, got_cfg, _, _, context_len = builder.load_pretrained_model(str(tmp_path), torch.float32,
                                                                    cuda)
    # max_position_embeddings is not in a checkpoint: the loader takes the 8B's
    assert context_len == 1024 and got_cfg.llm == dataclasses.replace(
        cfg.llm, max_position_embeddings=got_cfg.llm.max_position_embeddings)
    got, ref = dict(_named(got)), dict(_named(params))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        assert a.device.type == "cuda" and torch.equal(a, ref[path]), path
