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
  written at the device index idx, then the key mask is cleared past idx +
  a and idx advances by a (decode_common.rollback_verify), since the next
  round's positions come from the mask's sum.
* generate_greedy_speculative_batched, the ragged cache (per-row lengths):
  rows right-padded, each row's keys at [0, length); one
  forward_ragged_verify a round scores every row's proposal, each row
  commits its own accepted count (decode_common.commit_verify), and a done
  row commits nothing.
Both return n_forwards, the decoder forwards run (the prefill included).
* generate_pipelined_spec, offline over a stream of same-shaped batches:
  generate_greedy_speculative_batched's rounds with a chunk of the next
  batch's right-padded prompt fused into each round
  (forward_ragged_verify_with_chunk_static, GPTBigCode only); batch 0 is
  prefilled and adopted as a ragged cache by _spec_prefill_adopt, the
  adoption generate_greedy_speculative_batched also runs.

Every round is static, the JAX while_loops' bodies with nothing read on
the host: the per-row state (RaggedRows: pending tokens, draft context,
emitted tokens, counts, done, lengths, the rounds run while a row was
live) lives on the device and is written in place, the verify attends
over a key span fixed per graph (forward_chunk_static at B = 1, the
ragged verify given key_bounds (0, t_cap)). The rounds run in blocks of at
most DECODE_GRAPH_STEPS (no more than the live rows can still need: a live
round emits at least a token), the host reading done, the longest row and
the least emitted count once a block (`_flags`) to plan the next block's
key span; a round after every row is done changes nothing. On the card
each (kind, key span) is a CUDA graph captured once a call
(graphs.StepLoop); `cuda_graphs=False` runs the same rounds uncaptured, as
the CPU and a serving group (whose rounds broadcast over gloo) do.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.generation.engine import (
    DECODE_GRAPH_STEPS, chunk_cap, decoder_module, pad_time,
)
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
    max_new_tokens; whether one fired), for tok_buf (B, n), upto (B,);
    `stops` id tuples or, for a captured round, tensors on tok_buf's
    device."""
    n = tok_buf.shape[1]
    pos = torch.arange(n, device=tok_buf.device)[None, :]
    fire = torch.zeros(tok_buf.shape, dtype=torch.bool, device=tok_buf.device)
    for stop in stops:
        L = len(stop)
        if L == 0 or L > max_new_tokens:
            continue
        s = torch.as_tensor(stop, dtype=tok_buf.dtype, device=tok_buf.device)
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
    cuda_graphs: bool = True,
):
    """B = 1 over the linear cache. Returns (tokens (1, max_new_tokens),
    lengths (1,), n_forwards). As in the JAX function, tokens past the
    length are not pad-filled: the last round's accepted tokens may run past
    a stop. Each round is the static chunk step (forward_chunk_static) of
    [pending ‖ draft] at the device index, then the state's commit and the
    cache's rollback, all on the device (see the module docstring).

    On a serving group (parallel/tensor.py::ServingGroup; params and
    llm_cfg this rank's) every rank runs this call on the same inputs, so
    that the decoder's all-reduces and gathers meet in the same forwards:
    each round the leader sends its accepted tokens and its next pending
    token, and a follower whose own differ raises (serve/engine.py runs the
    call as one command of its group). Its rounds run uncaptured."""
    dec = decoder_module(llm_cfg)
    _, P, _ = inputs_embeds.shape
    K = draft_len
    total = P + max_new_tokens + K + 1
    device = inputs_embeds.device

    cache = dec.init_cache(llm_cfg, 1, total, dtype=policy.compute_dtype, device=device)
    logits, cache = dec.forward(params, llm_cfg, inputs_embeds, attention_mask=attention_mask,
                                cache=cache, policy=policy, last_logits_only=True,
                                kernels=kernels)
    ctx = torch.full((1, total), -1, dtype=torch.int64, device=device)
    ctx[:, :prompt_ids.shape[1]] = prompt_ids
    state = RaggedRows(logits[:, -1].float().argmax(dim=-1), ctx,
                       torch.full((1,), P, dtype=torch.int64, device=device),
                       max_new_tokens=max_new_tokens, draft_len=K,
                       stop_sequences=stop_sequences, eos_token_id=eos_token_id,
                       pad_token_id=pad_token_id, accept_margin=accept_margin)
    idx = torch.full((1,), P, dtype=torch.int32, device=device)
    ones = torch.ones((1, K), dtype=torch.int32, device=device)
    grouped = group is not None and group.size > 1

    def verify(t_cap: int) -> None:
        proposal = state.proposal()
        lg = dec.forward_chunk_static(params, llm_cfg, dec.embed_tokens(params, proposal).to(
            policy.compute_dtype), ones, cache, idx, t_cap=t_cap, policy=policy, kernels=kernels)
        a, g = state.commit(proposal, lg)
        if grouped:
            _check_round(group, proposal, a, g)
        dc.rollback_verify(cache, idx, a, K)

    _verify_rounds(graphs.StepLoop(device, cuda_graphs and not grouped), state, idx, total,
                   verify)
    return state.tokens[:, :max_new_tokens], state.lengths, 1 + graphs.host_read(state.rounds)[0]


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
    """Speculative decoding's per-row state (the loop body of the JAX
    generate_greedy_speculative*, shared by the port's three loops), on the
    device and written in place, so that a captured round keeps reading
    and writing the same tensors: pending tokens, the draft context ctx
    (B, Cx) of which n_ctx (B,) are filled, the emitted tokens (B,
    max_new_tokens + K), each row's count t, done and lengths, and `rounds`
    (1,), the rounds in which a row was live."""

    def __init__(self, pending: torch.Tensor, ctx: torch.Tensor, n_ctx: torch.Tensor, *,
                 max_new_tokens: int, draft_len: int, stop_sequences, eos_token_id,
                 pad_token_id: int, accept_margin: float):
        B = pending.shape[0]
        device = pending.device
        self.pending, self.ctx, self.n_ctx = pending.clone(), ctx.clone(), n_ctx.clone()
        self.n, self.K = max_new_tokens, draft_len
        self.stops = [torch.tensor(s, dtype=torch.int64, device=device) for s in stop_sequences]
        self.eos, self.pad = eos_token_id, pad_token_id
        self.accept_margin = accept_margin
        self.tokens = torch.full((B, max_new_tokens + draft_len), pad_token_id,
                                 dtype=torch.int64, device=device)
        self.t = torch.zeros((B,), dtype=torch.int64, device=device)
        self.done = torch.zeros((B,), dtype=torch.bool, device=device)
        self.lengths = torch.full((B,), max_new_tokens, dtype=torch.int64, device=device)
        self.rounds = torch.zeros((1,), dtype=torch.int32, device=device)

    def reset(self, pending: torch.Tensor, ctx: torch.Tensor, n_ctx: int) -> None:
        """Start a new batch of the same shape in place (a pipelined
        stream's next batch)."""
        self.pending.copy_(pending)
        self.ctx.copy_(ctx)
        self.n_ctx.fill_(n_ctx)
        self.tokens.fill_(self.pad)
        self.t.zero_()
        self.done.zero_()
        self.lengths.fill_(self.n)
        self.rounds.zero_()

    def proposal(self) -> torch.Tensor:
        """(B, K): [pending ‖ the looked-up draft]."""
        return torch.cat([self.pending[:, None],
                          _lookup_draft(self.ctx, self.n_ctx, self.pending, self.K)], dim=1)

    def commit(self, proposal: torch.Tensor, logits: torch.Tensor):
        """Take each live row's accepted prefix of `proposal` by the verify
        logits (B, K, V): emit it, extend the context, find the stops; a
        done row takes nothing. Returns (the accepted counts a (B,), 0 for a
        done row: what the caller commits in its cache; the verify's argmax
        (B, K))."""
        a, g = _accepted(proposal, logits, self.accept_margin)
        a = torch.where(self.done, 0, a)
        self.rounds.add_((~self.done).any().to(torch.int32))
        t_new = _append_accepted(self.tokens, self.t, proposal, a)
        self.n_ctx.copy_(_append_accepted(self.ctx, self.n_ctx, proposal, a))
        rows = torch.arange(proposal.shape[0], device=proposal.device)
        self.pending.copy_(torch.where(self.done, self.pending,
                                       g[rows, torch.clamp(a - 1, 0, self.K - 1)]))
        upto = torch.clamp(t_new, max=self.n)
        stop_at, fired = _find_stop_in(self.tokens, upto, self.stops, self.eos, self.n)
        newly = (fired | (t_new >= self.n)) & ~self.done
        self.lengths.copy_(torch.where(newly, torch.where(fired, stop_at, upto), self.lengths))
        self.done |= newly
        self.t.copy_(t_new)
        return a, g

    def result(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(tokens (B, max_new_tokens) pad-filled past each row's length,
        lengths (B,)), copies of the state's."""
        tokens = self.tokens[:, :self.n]
        keep = torch.arange(self.n, device=tokens.device)[None, :] < self.lengths[:, None]
        return torch.where(keep, tokens, self.pad), self.lengths.clone()


def _flags(state: RaggedRows, keys: torch.Tensor) -> list[int]:
    """The host's one read a block of rounds: [every row done, the most
    keys a row's cache holds (keys.max()), the least a live row has
    emitted]."""
    return graphs.host_read(state.done.all(), keys.max(),
                            torch.where(state.done, state.n, state.t).min())


def _verify_rounds(loop: graphs.StepLoop, state: RaggedRows, keys: torch.Tensor, T: int,
                   verify, flags: list[int] | None = None) -> None:
    """verify(t_cap) rounds until every row is done, in blocks of at most
    DECODE_GRAPH_STEPS rounds and no more than a live row can still need;
    each block's key span t_cap covers the keys (`keys`: the cache's
    lengths, or the linear cache's index) any row holds through its last
    round, each round adding at most K."""
    flags = flags or _flags(state, keys)
    while not flags[0]:
        rounds = min(DECODE_GRAPH_STEPS, state.n - flags[2])
        t_cap = chunk_cap(flags[1] + (rounds - 1) * state.K, T)
        for _ in range(rounds):
            loop.run("verify", t_cap, lambda c=t_cap: verify(c))
        flags = _flags(state, keys)


def _ragged_verify(params: dict, llm_cfg, state: RaggedRows, rag: dict, t_cap: int,
                   policy: DTypePolicy, kernels: bool) -> None:
    """One static round over a ragged cache: the rows' proposals through
    forward_ragged_verify over the key span [0, t_cap), then each row's
    commit."""
    proposal = state.proposal()
    lg, _ = decoder_module(llm_cfg).forward_ragged_verify(
        params, llm_cfg, proposal, rag, policy=policy, kernels=kernels, key_bounds=(0, t_cap))
    dc.commit_verify(rag, state.commit(proposal, lg)[0])


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
    cuda_graphs: bool = True,
):
    """Batched over a ragged cache: each row accepts its own drafts, so a
    row that accepts fast never waits on a slow one. The prefill runs on a
    linear cache (right padding keeps each row's keys contiguous from 0),
    its hidden state read at each row's last prompt token; the cache then
    becomes ragged with lengths = the rows' prompt lengths
    (_spec_prefill_adopt). The draft's context is prompt_ids' whole
    width per row. The rounds are static (module docstring); n_forwards
    counts a round only while a row was live. Returns (tokens (B,
    max_new_tokens) pad-filled past each row's length, lengths (B,),
    n_forwards)."""
    B, P, _ = inputs_embeds.shape
    K = draft_len
    device = inputs_embeds.device
    total = P + max_new_tokens + K + 1
    cache, pending = _spec_prefill_adopt(params, llm_cfg, inputs_embeds, attention_mask,
                                         total, policy, kernels)
    Pi = prompt_ids.shape[1]
    ctx = torch.full((B, Pi + max_new_tokens + K), -1, dtype=torch.int64, device=device)
    ctx[:, :Pi] = prompt_ids
    state = RaggedRows(pending, ctx, torch.full((B,), Pi, dtype=torch.int64, device=device),
                       max_new_tokens=max_new_tokens, draft_len=K,
                       stop_sequences=stop_sequences, eos_token_id=eos_token_id,
                       pad_token_id=pad_token_id, accept_margin=accept_margin)
    _verify_rounds(graphs.StepLoop(device, cuda_graphs), state, cache["lengths"], total,
                   lambda t_cap: _ragged_verify(params, llm_cfg, state, cache, t_cap, policy,
                                                kernels))
    return (*state.result(), 1 + graphs.host_read(state.rounds)[0])


# ---------------------------------------------------------------------------
# pipelined + speculative: batched prompt-lookup verify rounds with a chunk
# of the next batch's prompt in every round
# ---------------------------------------------------------------------------

def _spec_overlap(params: dict, llm_cfg, loop: graphs.StepLoop, state: RaggedRows, rag: dict,
                  nxt: tuple | None, C: int, n_chunks: int, policy: DTypePolicy,
                  kernels: bool) -> int:
    """Speculative verify rounds over the current batch (ragged cache
    `rag`, its rows' state reset in `state`) with chunk r of the next
    prompt fused into round r while r < n_chunks
    (forward_ragged_verify_with_chunk_static), nxt = (the next batch's
    linear cache, its staged prompt embeds (B, n_chunks x C, E) and mask,
    right-padded, the cache's write index idx at 0, each row's prompt
    length, the buffer of each row's hidden state at its last prompt
    position), or None for the last batch. Each round keeps the hidden
    state of a row whose last prompt position its chunk holds. Rounds past
    the last chunk verify alone; once every row is done, the chunks left
    run alone (forward_chunk_static, the JAX tail loop). Returns the rounds
    the JAX function counts: those with a live row, and at least n_chunks
    where there is a next batch."""
    T = rag["k"].shape[2]
    flags = _flags(state, rag["lengths"])

    def verify(t_cap: int) -> None:
        _ragged_verify(params, llm_cfg, state, rag, t_cap, policy, kernels)

    if nxt is not None:
        dec = decoder_module(llm_cfg)
        cache_next, stage_e, stage_m, idx, n_prompt, h_last = nxt

        # every tensor a round reads is the stream's or the round's own: its
        # graph is replayed in later batches, after this call's locals died
        def chunk() -> tuple[torch.Tensor, torch.Tensor]:
            slots = idx.long() + torch.arange(C, device=idx.device)
            return stage_e.index_select(1, slots), stage_m.index_select(1, slots)

        def capture(h_chunk: torch.Tensor) -> None:
            """Keep each row's hidden state at its last prompt position if
            this chunk holds it; advance idx."""
            off = n_prompt - 1 - idx
            hit = (off >= 0) & (off < C)
            rows = torch.arange(h_last.shape[0], device=idx.device)
            h_sel = h_chunk[rows, torch.clamp(off, 0, C - 1).long()].to(h_last.dtype)
            h_last.copy_(torch.where(hit[:, None], h_sel, h_last))
            idx.add_(C)

        def fused_round(t_cap: int, c_cap: int) -> None:
            proposal = state.proposal()
            lg, h = dec.forward_ragged_verify_with_chunk_static(
                params, llm_cfg, proposal, rag, *chunk(), cache_next, idx, t_cap=t_cap,
                chunk_cap=c_cap, policy=policy, kernels=kernels)
            dc.commit_verify(rag, state.commit(proposal, lg)[0])
            capture(h)

        def chunk_round(c_cap: int) -> None:
            capture(dec.forward_chunk_static(params, llm_cfg, *chunk(), cache_next, idx,
                                             t_cap=c_cap, policy=policy, kernels=kernels,
                                             return_hidden=True))

        r = 0
        while r < n_chunks and not flags[0]:
            rounds = min(DECODE_GRAPH_STEPS, n_chunks - r)
            t_cap = chunk_cap(flags[1] + (rounds - 1) * state.K, T)
            for r in range(r, r + rounds):
                key = (t_cap, chunk_cap(r * C, T))
                loop.run("fused", key, lambda k=key: fused_round(*k))
            r += 1
            flags = _flags(state, rag["lengths"])
        for r in range(r, n_chunks):  # every row done: the chunks alone
            c_cap = chunk_cap(r * C, T)
            loop.run("chunk", c_cap, lambda c=c_cap: chunk_round(c))
    _verify_rounds(loop, state, rag["lengths"], T, verify, flags)
    rounds = graphs.host_read(state.rounds)[0]
    return max(rounds, n_chunks) if nxt is not None else rounds


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
    cuda_graphs: bool = True,
) -> list:
    """Greedy generation over a stream of same-shaped batches: batched
    prompt-lookup speculation (speculative.generate_greedy_speculative_
    batched's rounds over a ragged cache) with C = chunk_positions, else
    max(8, ceil(2 P / max_new_tokens)), positions of the next batch's
    prompt prefilled in each verify round through the same pass over the
    layers (the JAX generate_pipelined_spec). Rows are right-padded to
    n_chunks x C. `stats` gets each batch's rounds (verify rounds and
    chunk-only ones). Returns [(tokens, lengths), ...] as `generate`.

    The rounds are static (module docstring). The stream allocates its two
    caches, the staging buffer of the next prompt and the rows' state once;
    between batches the chunk-filled cache is copied into the ragged
    cache's place (lengths the rows' prompt lengths) and the other's key
    mask zeroed, so every batch's rounds use the same buffers and a stream
    captures one graph a round kind and key span, not one a batch (a
    verify's span is the bucket above the longest row, so a batch whose
    rows run further can add a span, at most one a power of two up to the
    cache's size).

    Greedy only (ValueError otherwise). StarCoder2 has no fused verify and
    chunk forward in the JAX package either, so a stream of more than one
    StarCoder2 batch raises NotImplementedError."""
    if gen.do_sample:
        raise ValueError("generate_pipelined_spec is greedy-only (do_sample=False); use "
                         "generate_pipelined for sampled decoding")
    if not batches:
        return []
    dec = decoder_module(llm_cfg)
    if len(batches) > 1 and not hasattr(dec, "forward_ragged_verify_with_chunk_static"):
        raise NotImplementedError(
            f"generate_pipelined_spec: {dec.__name__.rsplit('.', 1)[-1]} has no fused verify and "
            f"chunk forward (the JAX package has none for StarCoder2 either); run one batch at a "
            f"time, or generate_pipelined")
    B, P, E = batches[0][0].shape
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
    device = e0.device
    rag, pending = _spec_prefill_adopt(params, llm_cfg, policy.cast(e0), m0, total, policy,
                                       kernels, kv_cache_dtype)
    state = RaggedRows(pending, torch.full((B, CTX), -1, dtype=torch.int64, device=device),
                       torch.zeros((B,), dtype=torch.int64, device=device), max_new_tokens=n,
                       draft_len=K, stop_sequences=gen.stop_sequences,
                       eos_token_id=gen.eos_token_id, pad_token_id=gen.pad_token_id,
                       accept_margin=accept_margin)
    nxt = None
    if len(batches) > 1:
        nxt = (dec.init_cache(llm_cfg, B, total, dtype=kv_cache_dtype or policy.compute_dtype,
                              device=device),
               torch.zeros((B, Pn, E), dtype=policy.compute_dtype, device=device),
               torch.zeros((B, Pn), dtype=torch.int32, device=device),
               torch.zeros(1, dtype=torch.int32, device=device),
               torch.zeros((B,), dtype=torch.int32, device=device),
               torch.zeros((B, E), dtype=policy.compute_dtype, device=device))
    loop = graphs.StepLoop(device, cuda_graphs)
    out = []
    for i, (_, _, ids) in enumerate(padded):
        if i > 0:
            # the chunk-filled cache, adopted, takes the ragged cache's place
            cache_next, _, _, _, n_prompt, h_last = nxt
            for key in dc.PAYLOAD_KEYS + ("kv_mask",):
                if key in rag:
                    rag[key].copy_(cache_next[key])
            rag["lengths"].copy_(n_prompt)
            cache_next["kv_mask"].zero_()
            pending = _greedy_head(params, llm_cfg, h_last, policy)
        state.reset(pending, pad_time(ids, CTX, value=-1, left=False), Pn)
        has_next = i + 1 < len(batches)
        if has_next:
            embeds, mask, _ = padded[i + 1]
            nxt[1].copy_(policy.cast(embeds))
            nxt[2].copy_(mask)
            nxt[3].zero_()
            nxt[4].copy_(mask.sum(dim=1))
            nxt[5].zero_()
        rounds = _spec_overlap(params, llm_cfg, loop, state, rag, nxt if has_next else None, C,
                               n_chunks, policy, kernels)
        if stats is not None:
            stats.append(rounds)
        out.append(state.result())
    return out
