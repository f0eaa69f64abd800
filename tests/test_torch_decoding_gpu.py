"""The decoding variants and the GRPO update on the card: each with the
kernels against the same call with their plain versions. Every test here is
marked `gpu` and skips without a card; the file imports no JAX, so on the
card it runs as
    python -m pytest --noconftest -m gpu tests/test_torch_decoding_gpu.py

The model is a tiny GPTBigCode with the 1B's attention geometry (16 query
heads over one KV head of 128: the kernels take D = 128 and decode G = 16),
2 layers, an MLP of 512 and 512 ids, projections scaled by 3, fp32 (the
kernels' fp32 versions against the plain ones: the same ids). Covered:
beam search at K = 2 (every step a decode over B x K rows reordered by
parent), num_return_sequences = 3 over int8 weights and an int8 cache
(kernel 2's int8 instantiation over the tiled codes and scales, kernel 14's
GEMV at M = B x 3), B = 1 and batched speculative decoding, and one GRPO
loss and its decoder gradients through the training kernels (loss 1e-5
relative; gradients rtol 1e-4 with atol 1e-5 of the leaf's largest
element: the attention backward sums in another order, and a few elements
near zero of 1M moved by 1.6e-6 on the H100).
"""

import pytest
import torch

from starvector_tpu_torch.generation import beam, engine, speculative
from starvector_tpu_torch.models import gpt_bigcode as tgbc
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.ops import flash_attention as tfa
from starvector_tpu_torch.ops import quantization as tq
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.train import grpo
from starvector_tpu_torch.train.optim import tree_leaves, tree_map

F32 = DTypePolicy(torch.float32, torch.float32)
LLM = tgbc.tiny_config(hidden_size=2048, n_head=16, n_inner=512, n_positions=256)
P, NEW = 70, 24  # a prefix past 64 tokens: kernel 1 prefills it


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(cuda):
    p = tgbc.init_params(LLM, torch.Generator().manual_seed(0))
    for grp in p["layers"]["attn"], p["layers"]["mlp"]:
        for leaf in grp.values():
            leaf["kernel"] = leaf["kernel"] * 3.0
    return tree_map(lambda t: t.to(cuda), p)


def _prefix(params, B, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, LLM.vocab_size, (B, P), generator=g).to(params["wte"].device)
    return tgbc.embed_tokens(params, ids), torch.ones_like(ids, dtype=torch.int32), ids


def _launches():
    return (tfa.flash_prefill.launches, tfa.decode_attention.launches,
            tfa.decode_attention.int8_launches, tq.quant_matmul.launches)


@pytest.mark.gpu
def test_beam_search_kernels_match_plain(cuda, params):
    emb, mask, _ = _prefix(params, 2)
    out = {}
    for kernels in (True, False):
        before = _launches()
        out[kernels] = beam.beam_search(params, LLM, emb, mask, num_beams=2, max_new_tokens=NEW,
                                        policy=F32, kernels=kernels)
        after = _launches()
        assert (after[0] > before[0] and after[1] > before[1]) == kernels
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_int8_return_sequences_kernels_match_plain(cuda, params):
    qparams = tq.quantize_tree(params, min_elems=1 << 12, consume=False)
    emb, mask, ids = _prefix(params, 2, seed=1)
    gen = engine.GenerationConfig(max_new_tokens=NEW, do_sample=False, num_return_sequences=3)
    out = {}
    for kernels in (True, False):
        before = _launches()
        out[kernels] = engine.generate(qparams, LLM, emb, mask, gen, prompt_ids=ids, policy=F32,
                                       kernels=kernels, kv_cache_dtype=torch.int8)
        after = _launches()
        assert (after[2] > before[2] and after[3] > before[3]) == kernels
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    tokens = out[True][0]
    assert tokens.shape == (6, NEW) and torch.equal(tokens[0], tokens[2]) \
        and torch.equal(tokens[3], tokens[5])


@pytest.mark.gpu
def test_speculative_kernels_match_plain_greedy(cuda, params):
    emb, mask, ids = _prefix(params, 3, seed=2)
    greedy = engine.generate(params, LLM, emb, mask,
                             engine.GenerationConfig(max_new_tokens=NEW, do_sample=False),
                             policy=F32)[0]
    tokens, _, n_fwd = speculative.generate_greedy_speculative(
        params, LLM, emb[:1], mask[:1], ids[:1], max_new_tokens=NEW, draft_len=4, policy=F32)
    assert torch.equal(tokens[0], greedy[0]) and n_fwd <= NEW + 1
    tokens, lengths, _ = speculative.generate_greedy_speculative_batched(
        params, LLM, emb, mask, ids, max_new_tokens=NEW, draft_len=4, policy=F32)
    assert torch.equal(tokens, greedy) and (lengths == NEW).all()


@pytest.mark.gpu
def test_grpo_loss_and_gradients_kernels_match_plain(cuda, params):
    cfg = tsv.tiny_config(llm=LLM)
    g = torch.Generator().manual_seed(3)
    vis = (torch.randn((2, 5, LLM.hidden_size), generator=g) * 0.5).to(cuda)
    ids = torch.randint(1, LLM.vocab_size, (4, 12), generator=g).to(cuda)
    pos = torch.arange(12, device=cuda)[None, :]
    attn = (pos < 3 + torch.tensor([[9], [6], [9], [2]], device=cuda)).to(torch.int32)
    adv = torch.tensor([1.0, -1.0, 0.5, -0.5], device=cuda)
    res = {}
    for kernels in (True, False):
        p = {"svg_transformer": tree_map(lambda t: t.detach().clone().requires_grad_(), params)}
        loss, _ = grpo.grpo_loss(p, cfg, vis, ids, attn, attn * (pos >= 3), None, adv, None,
                                 num_generations=2, clip_eps=0.2, kl_beta=0.0, policy=F32,
                                 remat="dots", kernels=kernels)
        leaves = tree_leaves(p["svg_transformer"])
        res[kernels] = (loss.detach(), torch.autograd.grad(loss, leaves))
    torch.testing.assert_close(res[True][0], res[False][0], rtol=1e-5, atol=0)
    for a, b in zip(res[True][1], res[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * b.abs().max().item())
