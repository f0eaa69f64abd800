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
* generate_pipelined_spec, offline over a stream of same-shaped batches:
  generate_greedy_speculative_batched's rounds (RaggedRows) with a chunk
  of the next batch's right-padded prompt fused into each round
  (forward_ragged_verify_with_chunk, GPTBigCode only); batch 0 is
  prefilled and adopted as a ragged cache by _spec_prefill_adopt, the
  adoption generate_greedy_speculative_batched also runs.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.generation.engine import decoder_module, pad_time
from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.ops.layers import DTypePolicy, matmul_f32


def _lookup_draft(ctx: torch.Tensor, n_ctx: torch.Tensor, pending: torch.Tensor,
                  K: int) -> torch.Tensor:
    """(B, K - 1) draft tokens for each row of ctx (B, C) (-1 = no id) of
    which the first n_ctx (B,) are filled: the tokens after the latest
    earlier occurrence of the bigram (ctx[n_ctx - 1], pending), preferring
    one with a full K - 1 tokens after it. Holes (-1) and rows with no match
    repeat `pending` (a mismatch only costs acceptance), as does a row with
    an empty context (n_ctx 0: no position precedes it)."""
    B, C = ctx.shape
    pos = torch.arange(C, device=ctx.device)[None, :]
    last = ctx.gather(1, (n_ctx - 1).clamp_min(0)[:, None].long())
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
    group=None,
):
    """B = 1 over the linear cache. Returns (tokens (1, max_new_tokens),
    lengths (1,), n_forwards). As in the JAX function, tokens past the
    length are not pad-filled: the last round's accepted tokens may run past
    a stop.

    On a serving group (parallel/tensor.py::ServingGroup; params and
    llm_cfg this rank's) every rank runs this call on the same inputs, so
    that the decoder's all-reduces and gathers meet in the same forwards:
    each round the leader sends its accepted tokens and its next pending
    token, and a follower whose own differ raises (serve/engine.py runs the
    call as one command of its group)."""
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
        if group is not None and group.size > 1:
            _check_round(group, proposal, a, g)
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


def _check_round(group, proposal: torch.Tensor, a: torch.Tensor, g: torch.Tensor) -> None:
    """A serving group's speculative round: the leader's accepted count,
    accepted tokens and next pending token on every rank; a follower whose
    own differ raises."""
    K = proposal.shape[1]
    accepted = torch.where(torch.arange(K, device=proposal.device) < a, proposal[0], -1)
    mine = torch.cat([a.reshape(1).long(), accepted, g[0, a - 1].reshape(1)])
    lead = group.broadcast(mine.clone())
    if not group.is_leader and not torch.equal(lead, mine):
        raise RuntimeError(f"serving rank {group.rank}: its speculative round (accepted count, "
                           f"tokens, pending) {mine.tolist()} parts from the leader's "
                           f"{lead.tolist()}")


def _greedy_head(params: dict, llm_cfg, h: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
    """The greedy token (B,) of final hidden states h (B, E): one head
    projection, fp32 logits from the fp32 accumulator."""
    dec = decoder_module(llm_cfg)
    return matmul_f32(policy.cast(h), policy.cast(dec.lm_head_table(params, llm_cfg)).T
                      ).argmax(dim=-1)


def _as_ragged(cache: dict, lengths: torch.Tensor) -> dict:
    """A prefilled linear cache of right-padded rows adopted as a ragged
    cache, in place: each row's keys at [0, length)."""
    del cache["index"]
    cache["lengths"] = lengths.to(torch.int32)
    return cache


def _spec_prefill_adopt(params: dict, llm_cfg, inputs_embeds: torch.Tensor,
                        attention_mask: torch.Tensor, total: int, policy: DTypePolicy,
                        kernels: bool, kv_cache_dtype=None) -> tuple[dict, torch.Tensor]:
    """Prefill a right-padded batch into a linear cache of `total` slots
    and adopt it as a ragged cache (lengths = the rows' prompt lengths),
    with each row's pending token, the greedy continuation of its last
    prompt position (the JAX _spec_prefill_adopt_jit; the start of
    generate_greedy_speculative_batched and of generate_pipelined_spec).
    Returns (cache, pending (B,))."""
    dec = decoder_module(llm_cfg)
    B = inputs_embeds.shape[0]
    cache = dec.init_cache(llm_cfg, B, total, dtype=kv_cache_dtype or policy.compute_dtype,
                           device=inputs_embeds.device)
    h, cache = dec.forward(params, llm_cfg, inputs_embeds, attention_mask=attention_mask,
                           cache=cache, policy=policy, return_hidden=True, kernels=kernels)
    n_prompt = attention_mask.sum(dim=1, dtype=torch.int32)
    rows = torch.arange(B, device=h.device)
    pending = _greedy_head(params, llm_cfg, h[rows, torch.clamp(n_prompt - 1, min=0).long()],
                          policy)
    return _as_ragged(cache, n_prompt), pending


class RaggedRows:
    """Batched speculative decoding's per-row state over a ragged cache
    (the loop body of generate_greedy_speculative_batched and of
    generate_pipelined_spec's verify rounds): pending tokens, the draft context
    ctx (B, Cx) of which n_ctx (B,) are filled, the emitted tokens (B,
    max_new_tokens + K), each row's count t, done and lengths."""

    def __init__(self, pending: torch.Tensor, ctx: torch.Tensor, n_ctx: torch.Tensor, *,
                 max_new_tokens: int, draft_len: int, stop_sequences, eos_token_id,
                 pad_token_id: int, accept_margin: float):
        B = pending.shape[0]
        device = pending.device
        self.pending, self.ctx, self.n_ctx = pending, ctx, n_ctx
        self.n, self.K = max_new_tokens, draft_len
        self.stops, self.eos, self.pad = stop_sequences, eos_token_id, pad_token_id
        self.accept_margin = accept_margin
        self.tokens = torch.full((B, max_new_tokens + draft_len), pad_token_id,
                                 dtype=torch.int64, device=device)
        self.t = torch.zeros((B,), dtype=torch.int64, device=device)
        self.done = torch.zeros((B,), dtype=torch.bool, device=device)
        self.lengths = torch.full((B,), max_new_tokens, dtype=torch.int64, device=device)

    def live(self) -> bool:
        return not bool(self.done.all())

    def proposal(self) -> torch.Tensor:
        """(B, K): [pending ‖ the looked-up draft]."""
        return torch.cat([self.pending[:, None],
                          _lookup_draft(self.ctx, self.n_ctx, self.pending, self.K)], dim=1)

    def commit(self, cache: dict, proposal: torch.Tensor, logits: torch.Tensor) -> None:
        """Take each live row's accepted prefix of `proposal` by the verify
        logits (B, K, V): commit it in the ragged cache, emit it, find the
        stops; a done row commits nothing."""
        a, g = _accepted(proposal, logits, self.accept_margin)
        a = torch.where(self.done, 0, a)
        dc.commit_verify(cache, a)
        t_new = _append_accepted(self.tokens, self.t, proposal, a)
        self.n_ctx = _append_accepted(self.ctx, self.n_ctx, proposal, a)
        rows = torch.arange(proposal.shape[0], device=proposal.device)
        self.pending = torch.where(self.done, self.pending,
                                   g[rows, torch.clamp(a - 1, 0, self.K - 1)])
        upto = torch.clamp(t_new, max=self.n)
        stop_at, fired = _find_stop_in(self.tokens, upto, self.stops, self.eos, self.n)
        newly = (fired | (t_new >= self.n)) & ~self.done
        self.lengths = torch.where(newly, torch.where(fired, stop_at, upto), self.lengths)
        self.done |= newly
        self.t = t_new

    def result(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(tokens (B, max_new_tokens) pad-filled past each row's length,
        lengths (B,))."""
        tokens = self.tokens[:, :self.n]
        keep = torch.arange(self.n, device=tokens.device)[None, :] < self.lengths[:, None]
        return torch.where(keep, tokens, self.pad), self.lengths


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
    becomes ragged with lengths = the rows' prompt lengths
    (_spec_prefill_adopt). The draft's context is prompt_ids' whole
    width per row. Returns (tokens (B, max_new_tokens) pad-filled past each
    row's length, lengths (B,), n_forwards)."""
    dec = decoder_module(llm_cfg)
    B, P, _ = inputs_embeds.shape
    K = draft_len
    device = inputs_embeds.device
    cache, pending = _spec_prefill_adopt(params, llm_cfg, inputs_embeds, attention_mask,
                                         P + max_new_tokens + K + 1, policy, kernels)
    Pi = prompt_ids.shape[1]
    ctx = torch.full((B, Pi + max_new_tokens + K), -1, dtype=torch.int64, device=device)
    ctx[:, :Pi] = prompt_ids
    state = RaggedRows(pending, ctx, torch.full((B,), Pi, dtype=torch.int64, device=device),
                       max_new_tokens=max_new_tokens, draft_len=K,
                       stop_sequences=stop_sequences, eos_token_id=eos_token_id,
                       pad_token_id=pad_token_id, accept_margin=accept_margin)
    n_fwd = 1
    while state.live():
        proposal = state.proposal()
        lg, cache = dec.forward_ragged_verify(params, llm_cfg, proposal, cache, policy=policy,
                                              kernels=kernels)
        n_fwd += 1
        state.commit(cache, proposal, lg)
    return (*state.result(), n_fwd)


# ---------------------------------------------------------------------------
# pipelined + speculative: batched prompt-lookup verify rounds with a chunk
# of the next batch's prompt in every round
# ---------------------------------------------------------------------------

def _spec_overlap(params: dict, llm_cfg, rag: dict, pending: torch.Tensor, ctx: torch.Tensor,
                  n_ctx: torch.Tensor, nxt: tuple | None, *, max_new_tokens: int,
                  draft_len: int, stop_sequences, eos_token_id, pad_token_id: int, C: int,
                  n_chunks: int, total: int, policy: DTypePolicy, kernels: bool,
                  kv_cache_dtype, accept_margin: float):
    """Speculative verify rounds over the current batch (ragged cache
    `rag`, pending tokens, draft context ctx / n_ctx) with chunk r of the
    next prompt, nxt = (embeds (B, Pn, E), mask (B, Pn)) right-padded, fused
    into round r (forward_ragged_verify_with_chunk); rounds past the last
    chunk verify alone (forward_ragged_verify). Each row captures its last
    prompt position's hidden state when it lands in a chunk. Chunks left
    when every row is done run through the cached forward alone. Returns
    (tokens, lengths, the next batch's ragged cache, its pending tokens,
    rounds run, the chunk-only ones included); the next two None for the
    last batch."""
    dec = decoder_module(llm_cfg)
    B = pending.shape[0]
    device = pending.device
    rows = torch.arange(B, device=device)
    state = RaggedRows(pending, ctx, n_ctx, max_new_tokens=max_new_tokens, draft_len=draft_len,
                       stop_sequences=stop_sequences, eos_token_id=eos_token_id,
                       pad_token_id=pad_token_id, accept_margin=accept_margin)
    n_steps = n_chunks if nxt is not None else 0
    if nxt is not None:
        next_embeds, next_mask = nxt
        cache_next = dec.init_cache(llm_cfg, B, total,
                                    dtype=kv_cache_dtype or policy.compute_dtype, device=device)
        n_prompt = next_mask.sum(dim=1, dtype=torch.int32)
        h_last = torch.zeros((B, next_embeds.shape[2]), dtype=policy.compute_dtype,
                             device=device)

    def capture(h_chunk, r):
        """Keep each row's hidden state at its last prompt position if chunk r holds it."""
        off = n_prompt - 1 - r * C
        hit = (off >= 0) & (off < C)
        h_sel = h_chunk[rows, torch.clamp(off, 0, C - 1).long()].to(h_last.dtype)
        return torch.where(hit[:, None], h_sel, h_last)

    r = 0
    while state.live():
        proposal = state.proposal()
        if r < n_steps:
            ce = policy.cast(next_embeds[:, r * C:(r + 1) * C])
            cm = next_mask[:, r * C:(r + 1) * C]
            lg, rag, h_chunk, cache_next = dec.forward_ragged_verify_with_chunk(
                params, llm_cfg, proposal, rag, ce, cm, cache_next, policy=policy,
                kernels=kernels)
            h_last = capture(h_chunk, r)
        else:
            lg, rag = dec.forward_ragged_verify(params, llm_cfg, proposal, rag, policy=policy,
                                                kernels=kernels)
        state.commit(rag, proposal, lg)
        r += 1
    # the chunks left once every row is done, without the verify side
    while r < n_steps:
        ce = policy.cast(next_embeds[:, r * C:(r + 1) * C])
        h_chunk, cache_next = dec.forward(params, llm_cfg, ce,
                                          attention_mask=next_mask[:, r * C:(r + 1) * C],
                                          cache=cache_next, policy=policy, return_hidden=True,
                                          kernels=kernels)
        h_last = capture(h_chunk, r)
        r += 1
    tokens, lengths = state.result()
    if nxt is None:
        return tokens, lengths, None, None, r
    return (tokens, lengths, _as_ragged(cache_next, n_prompt),
            _greedy_head(params, llm_cfg, h_last, policy), r)


@torch.no_grad()
def generate_pipelined_spec(
    params: dict,
    llm_cfg,          # GPTBigCodeConfig (StarCoder2 only for a single batch)
    batches: list,    # [(embeds (B, P, E), mask (B, P), prompt_ids (B, P))], right-padded,
                      # prompt_ids -1 where a position has no id
    gen: GenerationConfig,
    *,
    policy: DTypePolicy = DTypePolicy(),
    draft_len: int = 8,
    chunk_positions: int | None = None,
    kv_cache_dtype: torch.dtype | None = None,
    accept_margin: float = 0.0,
    stats: list | None = None,
    kernels: bool = True,
) -> list:
    """Greedy generation over a stream of same-shaped batches: batched
    prompt-lookup speculation (speculative.generate_greedy_speculative_
    batched's rounds over a ragged cache) with C = chunk_positions, else
    max(8, ceil(2 P / max_new_tokens)), positions of the next batch's
    prompt prefilled in each verify round through the same pass over the
    layers (the JAX generate_pipelined_spec). Rows are right-padded to
    n_chunks x C. `stats` gets each batch's rounds (verify rounds and
    chunk-only ones). Returns [(tokens, lengths), ...] as `generate`.

    Greedy only (ValueError otherwise). StarCoder2 has no fused verify and
    chunk forward in the JAX package either, so a stream of more than one
    StarCoder2 batch raises NotImplementedError."""
    if gen.do_sample:
        raise ValueError("generate_pipelined_spec is greedy-only (do_sample=False); use "
                         "generate_pipelined for sampled decoding")
    if not batches:
        return []
    dec = decoder_module(llm_cfg)
    if len(batches) > 1 and not hasattr(dec, "forward_ragged_verify_with_chunk"):
        raise NotImplementedError(
            f"generate_pipelined_spec: {dec.__name__.rsplit('.', 1)[-1]} has no fused verify and "
            f"chunk forward (the JAX package has none for StarCoder2 either); run one batch at a "
            f"time, or generate_pipelined")
    B, P, _ = batches[0][0].shape
    n, K = gen.max_new_tokens, draft_len
    C = chunk_positions or max(8, -(-2 * P // n))
    n_chunks = -(-P // C)
    Pn = n_chunks * C
    total = Pn + n + K + 1
    CTX = Pn + n + K

    padded = [(pad_time(embeds, Pn, left=False), pad_time(mask, Pn, left=False),
               pad_time(torch.as_tensor(ids).long().to(embeds.device), Pn, value=-1, left=False))
              for embeds, mask, ids in batches]
    e0, m0, _ = padded[0]
    rag, pending = _spec_prefill_adopt(params, llm_cfg, policy.cast(e0), m0, total, policy,
                                       kernels, kv_cache_dtype)
    out = []
    for i, (_, _, ids) in enumerate(padded):
        nxt = padded[i + 1][:2] if i + 1 < len(batches) else None
        tokens, lengths, rag, pending, rounds = _spec_overlap(
            params, llm_cfg, rag, pending, pad_time(ids, CTX, value=-1, left=False),
            torch.full((B,), Pn, dtype=torch.int64, device=e0.device), nxt,
            max_new_tokens=n, draft_len=K, stop_sequences=gen.stop_sequences,
            eos_token_id=gen.eos_token_id, pad_token_id=gen.pad_token_id, C=C,
            n_chunks=n_chunks, total=total, policy=policy, kernels=kernels,
            kv_cache_dtype=kv_cache_dtype, accept_margin=accept_margin)
        if stats is not None:
            stats.append(rounds)
        out.append((tokens, lengths))
    return out
