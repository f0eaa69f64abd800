"""Prompt-lookup speculative decoding, greedy (port of
starvector_tpu/generation/speculative.py).

Draft the K - 1 tokens that followed the latest earlier occurrence of the
current bigram (the last emitted token, the pending one) in the prompt and
the output so far, verify [pending ‖ draft] in one cached forward of K
tokens, keep the longest prefix on which the draft equals the verify's
argmax, and roll the cache back over the rejected slots.

`pending` is always the model's verified greedy continuation of what has
been emitted. A round: proposal p = [pending, d_1 .. d_{K-1}]; one forward
gives g[i], the argmax after p[0..i]; a = 1 + the longest prefix with
p[i + 1] == g[i]; p[0..a-1] are emitted and g[a-1] is the new pending.
In exact arithmetic the tokens equal one-at-a-time greedy decoding. The
verify runs the chunk step (merged_verify_attention, plain PyTorch, as the
JAX package's XLA), a plain decode step kernel 2, so in bf16 an argmax can
flip on a near-tie; `accept_margin` accepts a draft position only where the
verify's top-1 logit leads the top-2 by at least that much.

* generate_greedy_speculative, B = 1, the linear cache: the K slots are
  written at the shared index, then the index is set back to saved + a and
  the kv_mask slots from `saved` on to slot < saved + a, since the next
  round's positions come from the mask's sum. `a` comes to the host once a
  round.
* generate_greedy_speculative_batched, the ragged cache (per-row lengths):
  rows right-padded, each row's keys at [0, length); one
  forward_ragged_verify a round scores every row's proposal, each row
  commits its own accepted count (decode_common.commit_verify), and a done
  row commits nothing.
Both return n_forwards, the decoder forwards run (the prefill included).
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.generation.engine import decoder_module
from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.ops.layers import DTypePolicy, matmul_f32


def _lookup_draft(ctx: torch.Tensor, n_ctx: torch.Tensor, pending: torch.Tensor,
                  K: int) -> torch.Tensor:
    """(B, K - 1) draft tokens for each row of ctx (B, C) (-1 = no id) of
    which the first n_ctx (B,) are filled: the tokens after the latest
    earlier occurrence of the bigram (ctx[n_ctx - 1], pending), preferring
    one with a full K - 1 tokens after it. Holes (-1) and rows with no match
    repeat `pending` (a mismatch only costs acceptance)."""
    B, C = ctx.shape
    pos = torch.arange(C, device=ctx.device)[None, :]
    last = ctx.gather(1, (n_ctx - 1)[:, None].long())
    hit = (ctx == last) & (torch.roll(ctx, -1, dims=1) == pending[:, None]) \
        & (pos < (n_ctx - 1)[:, None])
    any_hit = hit.any(dim=1)
    full = hit & (pos <= (n_ctx - 1 - K)[:, None])
    pick = torch.where(full.any(dim=1, keepdim=True), full, hit)
    j = C - 1 - pick.flip(1).int().argmax(dim=1)  # the latest pick
    start = torch.where(any_hit, j + 2, 0).clamp(0, C - K)  # dynamic_slice's clamp
    prop = ctx.gather(1, start[:, None] + torch.arange(K - 1, device=ctx.device)[None, :])
    return torch.where(any_hit[:, None] & (prop >= 0), prop, pending[:, None])


def _append_accepted(buf: torch.Tensor, offs: torch.Tensor, proposal: torch.Tensor,
                     n_out: torch.Tensor) -> torch.Tensor:
    """Write each row's first n_out (B,) proposal tokens (B, W) into buf
    (B, C) at its own offset (clipped), in place. Returns offs + n_out."""
    W, C = proposal.shape[1], buf.shape[1]
    col = torch.arange(W, device=buf.device)[None, :]
    pos = torch.clamp(offs[:, None] + col, 0, C - 1)
    buf.scatter_(1, pos, torch.where(col < n_out[:, None], proposal, buf.gather(1, pos)))
    return offs + n_out


def _find_stop_in(tok_buf: torch.Tensor, upto: torch.Tensor, stops, eos_token_id,
                  max_new_tokens: int):
    """(the end index of each row's first stop in tok_buf[:, :upto], else
    max_new_tokens; whether one fired), for tok_buf (B, n), upto (B,)."""
    n = tok_buf.shape[1]
    pos = torch.arange(n, device=tok_buf.device)[None, :]
    fire = torch.zeros(tok_buf.shape, dtype=torch.bool, device=tok_buf.device)
    for stop in stops:
        L = len(stop)
        if L == 0 or L > max_new_tokens:
            continue
        s = torch.tensor(stop, dtype=tok_buf.dtype, device=tok_buf.device)
        windows = torch.stack([torch.roll(tok_buf, L - 1 - i, dims=1) for i in range(L)], dim=-1)
        fire |= (windows == s).all(dim=-1) & (pos >= L - 1)
    if eos_token_id is not None:
        fire |= tok_buf == eos_token_id
    fire &= pos < upto[:, None]
    fired = fire.any(dim=1)
    return torch.where(fired, fire.int().argmax(dim=1) + 1, max_new_tokens), fired


def _accepted(proposal: torch.Tensor, logits: torch.Tensor, accept_margin: float):
    """(accepted count a (B,) in 1..K, the verify's argmax g (B, K)) of
    proposals (B, K) and their verify logits (B, K, V)."""
    lg = logits.float()
    g = lg.argmax(dim=-1)
    K = proposal.shape[1]
    agree = (proposal[:, 1:] == g[:, :K - 1]).int()
    if accept_margin > 0.0:
        top2 = torch.topk(lg, 2, dim=-1).values
        agree = agree * ((top2[..., 0] - top2[..., 1])[:, :K - 1] >= accept_margin).int()
    return 1 + agree.cumprod(dim=1).sum(dim=1), g


@torch.no_grad()
def generate_greedy_speculative(
    params: dict,
    llm_cfg,                       # GPTBigCodeConfig or StarCoder2Config
    inputs_embeds: torch.Tensor,   # (1, P, E)
    attention_mask: torch.Tensor,  # (1, P)
    prompt_ids: torch.Tensor,      # (1, P) ids aligned with the prefix, -1 where none (visual)
    *,
    max_new_tokens: int,
    draft_len: int = 8,
    stop_sequences: tuple[tuple[int, ...], ...] = (),
    eos_token_id: int | None = None,
    pad_token_id: int = 0,
    policy: DTypePolicy = DTypePolicy(),
    accept_margin: float = 0.0,
    kernels: bool = True,
):
    """B = 1 over the linear cache. Returns (tokens (1, max_new_tokens),
    lengths (1,), n_forwards). As in the JAX function, tokens past the
    length are not pad-filled: the last round's accepted tokens may run past
    a stop."""
    dec = decoder_module(llm_cfg)
    _, P, _ = inputs_embeds.shape
    K = draft_len
    total = P + max_new_tokens + K + 1
    device = inputs_embeds.device

    cache = dec.init_cache(llm_cfg, 1, total, dtype=policy.compute_dtype, device=device)
    logits, cache = dec.forward(params, llm_cfg, inputs_embeds, attention_mask=attention_mask,
                                cache=cache, policy=policy, last_logits_only=True,
                                kernels=kernels)
    pending = logits[:, -1].float().argmax(dim=-1)                 # (1,)
    ctx = torch.full((1, total), -1, dtype=torch.int64, device=device)
    ctx[:, :prompt_ids.shape[1]] = prompt_ids
    tokens = torch.full((1, max_new_tokens + K), pad_token_id, dtype=torch.int64, device=device)
    ones = torch.ones((1, K), dtype=torch.int32, device=device)
    t, n_ctx, n_fwd, length = 0, P, 1, max_new_tokens
    while t < max_new_tokens:
        proposal = torch.cat([pending[:, None], _lookup_draft(
            ctx, torch.tensor([n_ctx], device=device), pending, K)], dim=1)   # (1, K)
        saved = cache["index"]
        lg, cache = dec.forward(params, llm_cfg, dec.embed_tokens(params, proposal).to(
            policy.compute_dtype), attention_mask=ones, cache=cache, policy=policy,
            kernels=kernels)
        a, g = _accepted(proposal, lg, accept_margin)
        a = int(a)
        n_fwd += 1
        # emit the a verified tokens; roll the cache back over the K - a rejected
        tokens[:, t:t + a] = proposal[:, :a]
        pending = g[:, a - 1]
        cache["index"] = saved + a
        cache["kv_mask"][:, saved + a:] = 0
        ctx[:, n_ctx:n_ctx + a] = proposal[:, :a]
        n_ctx += a
        t += a
        stop_at, fired = _find_stop_in(tokens, torch.tensor([min(t, max_new_tokens)],
                                                             device=device),
                                       stop_sequences, eos_token_id, max_new_tokens)
        if bool(fired):
            length = int(stop_at)
            break
        length = min(t, max_new_tokens)
    return tokens[:, :max_new_tokens], torch.tensor([length], device=device), n_fwd


@torch.no_grad()
def generate_greedy_speculative_batched(
    params: dict,
    llm_cfg,                       # GPTBigCodeConfig or StarCoder2Config
    inputs_embeds: torch.Tensor,   # (B, P, E) right-padded rows
    attention_mask: torch.Tensor,  # (B, P) 1 = real token, contiguous from 0
    prompt_ids: torch.Tensor,      # (B, Pi) ids for the draft's lookup, -1 where none
    *,
    max_new_tokens: int,
    draft_len: int = 8,
    stop_sequences: tuple[tuple[int, ...], ...] = (),
    eos_token_id: int | None = None,
    pad_token_id: int = 0,
    policy: DTypePolicy = DTypePolicy(),
    accept_margin: float = 0.0,
    kernels: bool = True,
):
    """Batched over a ragged cache: each row accepts its own drafts, so a
    row that accepts fast never waits on a slow one. The prefill runs on a
    linear cache (right padding keeps each row's keys contiguous from 0),
    its hidden state read at each row's last prompt token; the cache then
    becomes ragged with lengths = the rows' prompt lengths. The draft's
    context is prompt_ids' whole width per row. Returns (tokens (B,
    max_new_tokens) pad-filled past each row's length, lengths (B,),
    n_forwards)."""
    dec = decoder_module(llm_cfg)
    B, P, _ = inputs_embeds.shape
    K = draft_len
    total = P + max_new_tokens + K + 1
    device = inputs_embeds.device
    rows = torch.arange(B, device=device)

    cache = dec.init_cache(llm_cfg, B, total, dtype=policy.compute_dtype, device=device)
    h, cache = dec.forward(params, llm_cfg, inputs_embeds, attention_mask=attention_mask,
                           cache=cache, policy=policy, return_hidden=True, kernels=kernels)
    n_prompt = attention_mask.sum(dim=1, dtype=torch.int32)
    h_last = h[rows, torch.clamp(n_prompt - 1, min=0).long()]
    pending = matmul_f32(policy.cast(h_last), policy.cast(
        dec.lm_head_table(params, llm_cfg)).T).argmax(dim=-1)       # (B,)
    del cache["index"]
    cache["lengths"] = n_prompt

    Pi = prompt_ids.shape[1]
    ctx = torch.full((B, Pi + max_new_tokens + K), -1, dtype=torch.int64, device=device)
    ctx[:, :Pi] = prompt_ids
    n_ctx = torch.full((B,), Pi, dtype=torch.int64, device=device)
    tokens = torch.full((B, max_new_tokens + K), pad_token_id, dtype=torch.int64, device=device)
    t = torch.zeros((B,), dtype=torch.int64, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    lengths = torch.full((B,), max_new_tokens, dtype=torch.int64, device=device)
    n_fwd = 1
    while not bool(done.all()):
        proposal = torch.cat([pending[:, None], _lookup_draft(ctx, n_ctx, pending, K)], dim=1)
        lg, cache = dec.forward_ragged_verify(params, llm_cfg, proposal, cache, policy=policy,
                                              kernels=kernels)
        n_fwd += 1
        a, g = _accepted(proposal, lg, accept_margin)
        a = torch.where(done, 0, a)
        dc.commit_verify(cache, a)
        t_new = _append_accepted(tokens, t, proposal, a)
        n_ctx = _append_accepted(ctx, n_ctx, proposal, a)
        pending = torch.where(done, pending, g[rows, torch.clamp(a - 1, 0, K - 1)])
        upto = torch.clamp(t_new, max=max_new_tokens)
        stop_at, fired = _find_stop_in(tokens, upto, stop_sequences, eos_token_id,
                                       max_new_tokens)
        newly = (fired | (t_new >= max_new_tokens)) & ~done
        lengths = torch.where(newly, torch.where(fired, stop_at, upto), lengths)
        done |= newly
        t = t_new
    tokens = tokens[:, :max_new_tokens]
    keep = torch.arange(max_new_tokens, device=device)[None, :] < lengths[:, None]
    return torch.where(keep, tokens, pad_token_id), lengths, n_fwd
