"""Beam search (port of starvector_tpu/generation/beam.py): HF's
beam-search semantics (BeamSearchScorer, early_stopping=False) over the
cached decoder.

  * the prefix is repeated K times and prefilled at B x K rows (kernel 1);
    only beam 0 of each row is live at first, the others start at NEG_INF;
  * each step scores 2K candidates, the top of the K x V beam-extended
    log-probs; candidates that end in eos or a stop sequence go into a
    per-row pool of K finished hypotheses (by length-normalized score), and
    the best K unfinished ones become the live beams;
  * the cache rows are reordered by parent with a gather into new tensors
    (decode_common.reorder_rows), then one cached decode step of B x K rows
    (kernel 2) scores the live beams' new tokens;
  * a row is done when its pool is full and the best live score, normalized
    at the current length, cannot beat the worst pooled one; the loop ends
    when every row is done or max_new_tokens is reached;
  * the result is each row's best of [pool ‖ live beams at their final
    normalized score].

Ties: jax.lax.top_k puts the lower index first among equal values (the
pool starts full of NEG_INF, and the candidates of beams that are not live
yet all sit near NEG_INF, so ties are common); torch.topk promises no
order, so the top-k here is a stable descending sort, which keeps it.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.generation.engine import decoder_module, stop_hit
from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.ops.layers import DTypePolicy

NEG_INF = -1e9


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: values and indices, the lower
    index first among equal values."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _length_norm(length: int, length_penalty: float) -> float:
    """max(length, 1) ** length_penalty, the divisor of a beam's score."""
    return float(max(length, 1)) ** length_penalty


@torch.no_grad()
def beam_search(
    params: dict,
    llm_cfg,                       # GPTBigCodeConfig or StarCoder2Config
    inputs_embeds: torch.Tensor,   # (B, P, E)
    attention_mask: torch.Tensor,  # (B, P)
    *,
    num_beams: int = 2,
    max_new_tokens: int = 256,
    stop_sequences: tuple[tuple[int, ...], ...] = (),
    eos_token_id: int | None = None,
    pad_token_id: int = 0,
    length_penalty: float = 1.0,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_new_tokens) int64, lengths (B,)): the best
    hypothesis of each row, pad-filled after its end."""
    dec = decoder_module(llm_cfg)
    B, P, _ = inputs_embeds.shape
    K, V, n = num_beams, llm_cfg.vocab_size, max_new_tokens
    device = inputs_embeds.device
    bi = torch.arange(B, device=device)[:, None]

    cache = dec.init_cache(llm_cfg, B * K, P + n, dtype=policy.compute_dtype, device=device)
    logits, cache = dec.forward(params, llm_cfg, inputs_embeds.repeat_interleave(K, dim=0),
                                attention_mask=attention_mask.repeat_interleave(K, dim=0),
                                cache=cache, policy=policy, last_logits_only=True,
                                kernels=kernels)
    last_logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, K, V)

    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    tokens = torch.full((B, K, n), pad_token_id, dtype=torch.int64, device=device)
    pool_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    pool_tokens = torch.full((B, K, n), pad_token_id, dtype=torch.int64, device=device)
    pool_lengths = torch.full((B, K), n, dtype=torch.int64, device=device)
    stops = [torch.tensor(s, dtype=torch.int64, device=device) for s in stop_sequences]
    ones = torch.ones((B * K, 1), dtype=torch.int32, device=device)

    def all_done(t: int) -> bool:
        """HF early_stopping=False, for every row: the pool is full and the
        best live score at length t + 1 cannot beat the worst pooled one."""
        pool_full = (pool_scores > NEG_INF / 2).all(dim=1)
        attainable = scores.amax(dim=1) / _length_norm(t + 1, length_penalty)
        return bool((pool_full & (attainable <= pool_scores.amin(dim=1))).all())

    t = 0
    done = n == 0 or all_done(0)
    while not done:
        cand_scores, cand_idx = _top_k((scores[..., None] + last_logp).reshape(B, K * V), 2 * K)
        parent, new_tok = cand_idx // V, cand_idx % V
        cand_tokens = tokens[bi, parent]                          # (B, 2K, n)
        finished = stop_hit(cand_tokens, t, new_tok, stops, eos_token_id, n)
        cand_tokens[:, :, t] = new_tok

        # finished candidates compete for the pool on their normalized score
        cand_pool = torch.where(finished, cand_scores / _length_norm(t + 1, length_penalty),
                                torch.full_like(cand_scores, NEG_INF))
        pool_scores, sel = _top_k(torch.cat([pool_scores, cand_pool], dim=1), K)
        pool_tokens = torch.cat([pool_tokens, cand_tokens], dim=1)[bi, sel]
        pool_lengths = torch.cat([pool_lengths, torch.full_like(cand_idx, t + 1)], dim=1)[bi, sel]

        # the best K unfinished candidates keep searching
        scores, sel = _top_k(torch.where(finished, torch.full_like(cand_scores, NEG_INF),
                                         cand_scores), K)
        tokens = cand_tokens[bi, sel]
        t += 1
        done = t == n or all_done(t)
        if done:
            break  # the next step's logits would go unread
        dc.reorder_rows(cache, (bi * K + parent[bi, sel]).reshape(-1))
        embeds = dec.embed_tokens(params, new_tok[bi, sel].reshape(-1, 1)).to(policy.compute_dtype)
        logits, cache = dec.forward(params, llm_cfg, embeds, attention_mask=ones, cache=cache,
                                    policy=policy, kernels=kernels)
        last_logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, K, V)

    # a short pool: the live beams compete at their final normalized score
    final_scores = torch.cat([pool_scores, scores / _length_norm(t, length_penalty)], dim=1)
    final_tokens = torch.cat([pool_tokens, tokens], dim=1)
    final_lengths = torch.cat([pool_lengths, torch.full_like(pool_lengths, t)], dim=1)
    best = final_scores.argmax(dim=1)
    rows = torch.arange(B, device=device)
    return final_tokens[rows, best], final_lengths[rows, best]
