"""Continuous-batching generation engine (port of
starvector_tpu/serve/engine.py: vLLM-parity serving semantics).

Iteration-level scheduling over a slot-based ragged KV cache:
  * requests queue up; a dedicated ADMISSION thread prefills them (prompt
    lengths bucketed to powers of two, right-padded, in chunks of at most
    `prefill_chunk` tokens: kernel 1, `flash_prefill`, for every chunk of
    more than 64 tokens), samples each first token, and inserts the
    finished prefix into a reserved slot under the engine lock, between
    two ticks. Same-bucket requests admit together in power-of-two groups;
  * every tick decodes `steps_per_tick` tokens for all active slots, each
    step a ragged decode (kernel 2, `decode_attention`, with a per-row key
    mask) followed by per-slot sampling of the full vLLM surface
    (temperature, top-p, top-k, min-p, repetition / frequency / presence
    penalties, logit_bias) on the top-`max_top_k` slab, with the (B, V)
    count and presence tables on the device. A tick makes one host
    transfer, of its (B, steps_per_tick) tokens; kernel 2 reads each
    step's key bounds from the rows' lengths on the device, its grid
    planned at a power-of-two cap from the engine's host bookkeeping of
    every slot's length, so no step reads a length back;
  * per-request stop sequences, eos and max tokens are checked on the host;
    emitted tokens stream into per-request queues; a failure fails the
    requests it touched, never the loops;
  * `num_beams > 1` requests run as BEAM GROUPS: num_beams slots decode in
    lockstep, one ragged step a round after the cache rows are reordered by
    parent, then an on-device top-2k; HF's finished-pool semantics on the
    host (generation/beam.py's); sampling traffic keeps streaming beside;
  * `spec_drafts > 0` turns sampling ticks into PROMPT-LOOKUP SPECULATIVE
    ticks: steps_per_tick verify rounds, each drafting on the device from
    the slot's [prompt ids || accepted output] (generation/speculative.py's
    _lookup_draft), verifying through the decoder's forward_ragged_verify
    and committing the accepted tokens (decode_common.commit_verify). A
    round emits 1 to spec_drafts + 1 tokens a slot; the engine times both
    tick kinds and falls back to plain ticks while verify ticks are slower.

The JAX engine jits each device function and donates its buffers (its
tick is one `lax.scan` over steps_per_tick steps, its engine.py:357); here
the sampling tick is a static tick (`_static_ragged_step`: the decoders'
forward_ragged_decode_static, kernel 2's key bounds from the rows' lengths
on the device, the knobs in static buffers that `_knobs` refills with
copy_ when the slot composition changes). The single-process engine
captures it on the card as one CUDA graph per (power-of-two key bucket,
greedy_only) (generation/graphs.py) and replays it, the first tick run
uncaptured as the warm-up. It runs uncaptured on the CPU, with
`cuda_graphs=False`, and on a serving group, whose broadcasts and gathers
go over gloo, which no CUDA graph can capture. Verify and beam ticks run
eagerly. Every tick writes the ragged cache, its key mask and lengths,
the last tokens and the sampling tables in place, so a graph's tensors
stay the engine's. Both threads launch on the
device's current stream (a capture runs on a side stream, ordered after
the current one, and holds graphs.CAPTURE_LOCK, which an admission's
prefill takes too), so an admission's prefill queues between two ticks'
launches and its insert, taken under the lock, lands after the tick before
it. Random draws come
from two seeded torch.Generators on the device, one for the ticks and one
for the admissions, so sampled tokens are reproducible for a seed but not
equal to the JAX engine's.

On a serving mesh (parallel/tensor.py::ServingGroup: every rank of one
data group) one engine runs over the group: the leader's threads drive it
and every device call goes to the followers as a command that they replay
on their own shards (`follow`), so that the group's collectives (the
tensor group's row-parallel sums; the fsdp and stage gathers of a layout)
meet. Each row's first-token logits come out of the prefill's own device
call, since the head's table may be one of the gathered weights.

Runs on the card; `device="cpu"` asks for the CPU. `kernels=False` runs
the kernels' plain versions (the card's reference run).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import uuid
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from starvector_tpu_torch import require_device
from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.generation.beam import _top_k
from starvector_tpu_torch.generation.speculative import (
    _append_accepted, _lookup_draft, generate_greedy_speculative,
)
from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.models import gpt_bigcode, starcoder2
from starvector_tpu_torch.ops.layers import DTypePolicy, matmul_f32
from starvector_tpu_torch.ops.sampling import sample_token
from starvector_tpu_torch.parallel.zero import gathered

DECODERS = {"gpt_bigcode": gpt_bigcode, "starcoder2": starcoder2}


@dataclasses.dataclass
class Request:
    prefix_embeds: Any                 # (1, P, E) prompt embedding (tensor or array)
    max_new_tokens: int = 256
    temperature: float = 0.8
    top_p: float = 0.9
    top_k: int = 0
    min_p: float = 0.0                 # vLLM min-p (0 disables)
    repetition_penalty: float = 1.0    # over prompt and output tokens (HF/vLLM)
    frequency_penalty: float = 0.0     # OpenAI, over output-token counts
    presence_penalty: float = 0.0      # OpenAI, over output-token presence
    # sparse additive bias {token_id: bias}, at most engine.max_bias entries
    logit_bias: dict[int, float] | None = None
    # prompt token ids: seed the repetition penalty's presence and the
    # speculative draft context (the engine sees only embeddings otherwise)
    prompt_token_ids: Any = None
    do_sample: bool = True
    stop_sequences: tuple[tuple[int, ...], ...] = ()
    eos_token_id: int | None = None
    # > 1 admits a BEAM GROUP of num_beams slots (sampling knobs ignored);
    # the best hypothesis streams at completion
    num_beams: int = 1
    length_penalty: float = 1.0
    request_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    # ("token", id) events, then ("done", ids) or ("error", message)
    out_queue: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    reserved: bool = False             # held by the admission thread
    beam: Any = None                   # _BeamGroup when part of a beam group


NEG_INF = -1e9


@dataclasses.dataclass
class _BeamGroup:
    """Host-side state of one beam-search request occupying `slot_idxs`.
    Candidates come from the device's top-2n (_beam_step); histories, the
    finished-hypothesis pool and termination follow generation/beam.py
    (HF BeamSearchScorer) in plain Python: 2n scalars of host work a round."""

    req: Request
    slot_idxs: list[int]
    histories: list[list[int]]            # per live beam, tokens so far
    scores: list[float]                   # cumulative logp per live beam
    parent_perm: np.ndarray               # (n,) cache reorder for the next round
    next_tokens: np.ndarray               # (n,) tokens selected last round
    pool: list[tuple[float, list[int]]] = dataclasses.field(default_factory=list)
    t: int = 0                            # tokens generated per live beam

    def select(self, cand_scores, parents, toks) -> None:
        """One HF beam round from 2n candidates: finished ones enter the pool
        (normalized by (t + 1) ** length_penalty), the best n unfinished stay
        live. self.t is the 0-based position being written."""
        n = len(self.slot_idxs)
        req = self.req
        lp = req.length_penalty
        live: list[tuple[float, int, int]] = []
        for s, p, tok in zip(map(float, cand_scores), map(int, parents), map(int, toks)):
            hist = self.histories[p] + [tok]
            finished = req.eos_token_id is not None and tok == req.eos_token_id
            for stop in req.stop_sequences:
                L = len(stop)
                if L and len(hist) >= L and tuple(hist[-L:]) == tuple(stop):
                    finished = True
            if finished:
                self.pool.append((s / (float(self.t) + 1.0) ** lp, hist))
            elif len(live) < n:
                live.append((s, p, tok))
        self.pool = sorted(self.pool, key=lambda x: -x[0])[:n]
        while len(live) < n:            # every candidate finished: dead rows
            live.append((NEG_INF, 0, 0))
        self.histories = [self.histories[p] + [tok] for _, p, tok in live]
        self.scores = [s for s, _, _ in live]
        self.parent_perm = np.asarray([p for _, p, _ in live], np.int64)
        self.next_tokens = np.asarray([t for _, _, t in live], np.int64)
        self.t += 1

    def done(self) -> bool:
        """HF early_stopping=False: the pool is full and the best attainable
        live score (one optimistic token ahead) cannot beat its worst."""
        if self.t >= self.req.max_new_tokens:
            return True
        n = len(self.slot_idxs)
        if len(self.pool) < n:
            return False
        attainable = max(self.scores) / (float(self.t) + 1.0) ** self.req.length_penalty
        return attainable <= self.pool[-1][0]

    def best(self) -> list[int]:
        """The best of the pool and the live beams at their current
        normalized score."""
        lp = self.req.length_penalty
        cands = list(self.pool) + [(s / max(float(self.t), 1.0) ** lp, h)
                                   for s, h in zip(self.scores, self.histories)]
        return max(cands, key=lambda x: x[0])[1]


# a prompt length rounded up to a power-of-two bucket (the JAX engine's
# compile bound; here it keeps a request's padding, and so its ids,
# independent of which requests share its admission), and a static tick's
# key bound
_bucket_len = graphs.bucket_len


@dataclasses.dataclass
class _Knobs:
    """Per-slot sampling knobs on the device, (B,) each; bias (B, max_bias).
    Static buffers, refilled (copy_) only when the slot composition
    changes, so that a captured tick reads each new composition's."""

    active: torch.Tensor
    temps: torch.Tensor
    top_ps: torch.Tensor
    top_ks: torch.Tensor
    min_ps: torch.Tensor
    rep_pens: torch.Tensor
    freq_pens: torch.Tensor
    pres_pens: torch.Tensor
    bias_ids: torch.Tensor
    bias_vals: torch.Tensor
    greedy_only: bool  # every active slot greedy: the ticks take the argmax alone
    # greedy with no penalty or bias: each token is the logits' argmax, which
    # a serving group's followers check against their own
    plain_greedy: bool = False


def _lm_logits(dec, params: dict, cfg, h: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
    """(k, V) fp32 logits of hidden states (k, E) through the LM head
    (gathered whole on a serving layout)."""
    return matmul_f32(policy.cast(h), policy.cast(gathered(dec.lm_head_table(params, cfg))).T)


def _prefill_chunk(dec, params: dict, cfg, embeds, mask, cache: dict, h_last, last_idx,
                   chunk_start: int, *, policy: DTypePolicy, kernels: bool):
    """One right-padded prompt chunk (k, C, E) into the bucket-sized linear
    cache (kernel 1 for C > 64, at q_offset chunk_start for a later chunk).
    Each row's hidden state at its last real token is taken from whichever
    chunk holds it (rows of one bucket can end in different chunks) and
    returned in h_last (k, E)."""
    hidden, _ = dec.forward(params, cfg, embeds, attention_mask=mask, cache=cache,
                            policy=policy, return_hidden=True, kernels=kernels)
    C = embeds.shape[1]
    local = torch.clamp(last_idx - chunk_start, 0, C - 1)
    h_sel = hidden.gather(1, local[:, None, None].expand(-1, 1, hidden.shape[-1]))[:, 0]
    valid = (last_idx >= chunk_start) & (last_idx < chunk_start + C)
    return torch.where(valid[:, None], h_sel.to(h_last.dtype), h_last)


def _presence_from_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """(k, P) token ids with -1 padding -> (k, V) int32 0/1 presence."""
    real = (ids >= 0).to(torch.int32)
    out = torch.zeros((ids.shape[0], vocab), dtype=torch.int32, device=ids.device)
    return out.scatter_reduce_(1, torch.where(ids >= 0, ids, 0).long(), real, reduce="amax")


def _sample_first(logits, vocab: int, generator, temp, top_p, top_k, min_p, rep_pen,
                  prompt_ids, bias_ids, bias_vals, *, max_top_k: int):
    """Each admitted row's first token from its last position's logits
    (k, V) (the prefill's head, _prefill_embeds: no (P, V) logits), and the
    rows' prompt presence tables. The full-vocabulary chain, as the JAX
    _sample_first."""
    presence = _presence_from_ids(prompt_ids, vocab)
    first = sample_token(logits, do_sample=True, temperature=temp, top_p=top_p, top_k=top_k,
                         min_p=min_p, presence=presence, repetition_penalty=rep_pen,
                         bias_ids=bias_ids, bias_vals=bias_vals, max_top_k=max_top_k,
                         generator=generator)
    return first, presence


def _tick_sample(logits, kn: _Knobs, counts, prompt_presence, generator, max_top_k: int):
    """One position's tokens (B,): the pruned chain, or the argmax when every
    slot is greedy, after bias and penalties."""
    return sample_token(
        logits, do_sample=not kn.greedy_only, pruned=True, temperature=kn.temps,
        top_p=kn.top_ps, top_k=kn.top_ks, min_p=kn.min_ps,
        presence=torch.maximum((counts > 0).to(torch.int32), prompt_presence),
        repetition_penalty=kn.rep_pens, counts=counts, frequency_penalty=kn.freq_pens,
        presence_penalty=kn.pres_pens, bias_ids=kn.bias_ids, bias_vals=kn.bias_vals,
        max_top_k=max_top_k, generator=generator)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _static_ragged_step(dec, params: dict, cfg, tokens, out, cache: dict, kn: _Knobs, generator,
                        counts, prompt_presence, *, policy: DTypePolicy, max_top_k: int,
                        n_steps: int, kernels: bool, t_cap: int, share=_same):
    """`n_steps` ragged decode steps with per-slot sampling on static
    buffers, the tick a CUDA graph captures: tokens (B,) in, overwritten
    with the last step's; out (B, n_steps) the tick's tokens. Each step is
    forward_ragged_decode_static (kernel 2's key bounds from the rows'
    lengths on the device, its grid planned at t_cap, at least every active
    row's length after the tick), then the slots' sampling; counts (B, V)
    counts each active slot's tokens. Nothing is allocated outside the
    step's own temporaries and nothing is read back. `share` sends the
    input tokens and each step's tokens to a serving group's followers
    (_follow_step)."""
    cur = share(tokens)
    for i in range(n_steps):
        logits = dec.forward_ragged_decode_static(params, cfg, cur, cache, kn.active, t_cap=t_cap,
                                                  policy=policy, kernels=kernels)
        cur = share(_tick_sample(logits, kn, counts, prompt_presence, generator, max_top_k))
        counts.scatter_add_(1, cur[:, None], kn.active[:, None])  # rows distinct: index_put_'s sum
        out[:, i] = cur
    tokens.copy_(cur)


def _fused_verify_multi(dec, params: dict, cfg, tokens, cache: dict, ctx, ctx_len,
                        kn: _Knobs, generator, counts, prompt_presence, *,
                        policy: DTypePolicy, max_top_k: int, n_rounds: int, draft_len: int,
                        accept_margin: float, kernels: bool, key_bounds: tuple[int, int],
                        share=_same):
    """`n_rounds` speculative rounds, drafting on the device from ctx (B, C)
    ([prompt ids || accepted proposal tokens], ctx_len filled, -1 holes).

    Each round verifies W = draft_len + 1 tokens [pending || drafts] in one
    forward_ragged_verify: position i's logits run the slot's full pruned
    chain (greedy slots the argmax), draft i + 1 is accepted while it equals
    the token sampled at i (and, with accept_margin > 0, the previous
    position's fp32 top1 - top2 margin reaches it), and the emitted tokens
    are the sampled chain. The accepted count is committed to the cache and
    appended to ctx. Returns ((B, n_rounds, W) tokens, (B, n_rounds, W)
    cumulative accept flags as int32, the new ctx_len, the pending tokens
    (B,): each slot's last accepted sample); ctx, counts and the cache
    change in place. key_bounds (t_lo, t_hi): the slots any active row may
    see at the first round (ServeEngine._key_bounds); each round's t_hi is
    W more. `share` sends each round's proposal and accepted counts to a
    serving group's followers (_follow_verify)."""
    B = tokens.shape[0]
    W = draft_len + 1
    rows = torch.arange(B, device=tokens.device)
    zeros_b = torch.zeros(B, dtype=torch.float32, device=tokens.device)
    t_lo, t_hi = key_bounds
    pending = tokens
    toks_all, chains_all = [], []
    for m in range(n_rounds):
        proposal = share(torch.cat([pending[:, None], _lookup_draft(ctx, ctx_len, pending, W)],
                                   dim=1))
        logits_all, cache = dec.forward_ragged_verify(params, cfg, proposal, cache,
                                                      policy=policy, kernels=kernels,
                                                      key_bounds=(t_lo, t_hi + m * W))
        chain = prev = prev_margin = None
        toks, oks = [], []
        for i in range(W):
            lg = logits_all[:, i]
            t = _tick_sample(lg, kn, counts, prompt_presence, generator, max_top_k)
            if i == 0:
                ok = kn.active > 0
            else:
                ok = chain & (prev == proposal[:, i])
                if accept_margin > 0.0:
                    ok = ok & (prev_margin >= accept_margin)
            if accept_margin > 0.0:
                top2 = torch.topk(lg.float(), 2, dim=-1).values
                marg = top2[:, 0] - top2[:, 1]
            else:
                marg = zeros_b
            counts.index_put_((rows, t), ok.to(torch.int32), accumulate=True)
            chain, prev, prev_margin = ok, t, marg
            toks.append(t)
            oks.append(ok)
        toks, chain = torch.stack(toks, dim=1), torch.stack(oks, dim=1)   # (B, W)
        n_out = share(chain.sum(dim=1))
        dc.commit_verify(cache, n_out)
        ctx_len = _append_accepted(ctx, ctx_len, proposal, n_out)
        pending = torch.where(n_out > 0, toks[rows, torch.clamp(n_out - 1, 0, W - 1)], pending)
        toks_all.append(toks)
        chains_all.append(chain)
    return (torch.stack(toks_all, dim=1), torch.stack(chains_all, dim=1).to(torch.int32),
            ctx_len, pending)


def _admit_ctx_rows(ctx, ctx_len, slots, pid_rows) -> None:
    """Reset admitted slots' draft context to their prompt ids, compacted
    (bucket padding and visual-prefix holes, -1, squeezed out, so ctx_len
    is the true id count), in place. The first sampled token is not
    written: it is the slot's pending token and enters ctx as round 0's
    proposal[0]."""
    C = ctx.shape[1]
    k, Pb = pid_rows.shape
    real = pid_rows >= 0
    dest = torch.cumsum(real.long(), dim=1) - 1
    # non-real writes park on the last column (-1 over -1: real counts are
    # at most Pb <= max_len < C - 1)
    dest = torch.where(real, dest, C - 1)
    rowfill = torch.full((k, C), -1, dtype=ctx.dtype, device=ctx.device)
    rowfill.scatter_(1, dest, torch.where(real, pid_rows, -1).to(ctx.dtype))
    ctx[slots] = rowfill
    ctx_len[slots] = real.sum(dim=1).to(ctx_len.dtype)


def _admit_sampling_state(counts, prompt_presence, slots, firsts, presence_rows) -> None:
    """Reset admitted slots' sampling state in place: the counts row is the
    one-hot of the first output token, the prompt presence row the prompt's."""
    k, V = presence_rows.shape
    fresh = torch.zeros((k, V), dtype=counts.dtype, device=counts.device)
    fresh[torch.arange(k, device=counts.device), firsts] = 1
    counts[slots] = fresh
    prompt_presence[slots] = presence_rows


def _beam_first(logits, *, n: int):
    """First beam round from the prompt's last position's logits (1, V):
    the top-2n continuations of beam 0 (HF: only beam 0 is live at t = 0).
    Returns (scores (2n,), tokens (2n,))."""
    logp = torch.log_softmax(logits[0], dim=-1)
    return _top_k(logp, 2 * n)


def _beam_decode(dec, params: dict, cfg, cache: dict, group_slots, parent_perm, tokens_full, *,
                 policy: DTypePolicy, kernels: bool, key_bounds: tuple[int, int]):
    """A beam round's device work before its selection: the group's cache
    rows reordered by parent over the slots [0, t_hi) any of them may see
    (the gathered copy is taken before any row is written), then a ragged
    decode of tokens_full (B,) with the group's rows active (kernel 2).
    Returns the (B, V) logits."""
    src = group_slots[parent_perm]
    t_hi = key_bounds[1]
    for key in dc._payload_keys(cache):
        cache[key][:, group_slots, :t_hi] = cache[key][:, src, :t_hi]
    active = torch.zeros(tokens_full.shape[0], dtype=torch.int32, device=tokens_full.device)
    active[group_slots] = 1
    return dec.forward_ragged_decode(params, cfg, tokens_full, cache, active, policy=policy,
                                     kernels=kernels, key_bounds=key_bounds)[0]


def _beam_step(dec, params: dict, cfg, cache: dict, group_slots, parent_perm, toks, scores,
               last_tokens, *, policy: DTypePolicy, n: int, kernels: bool,
               key_bounds: tuple[int, int], share=_same):
    """One beam-group round: _beam_decode of the n beam rows (the other
    slots inactive) fed the group's tokens, then the top-2n candidates of
    the beam-extended log-probs. Returns (scores, parents, tokens), (2n,)
    each. `share` sends the round's tokens to a serving group's followers."""
    tokens_full = last_tokens.clone()
    tokens_full[group_slots] = toks
    logits = _beam_decode(dec, params, cfg, cache, group_slots, parent_perm, share(tokens_full),
                          policy=policy, kernels=kernels, key_bounds=key_bounds)
    logp = torch.log_softmax(logits[group_slots].float(), dim=-1)
    cand_scores, cand_idx = _top_k((scores[:, None] + logp).reshape(-1), 2 * n)
    V = cfg.vocab_size
    return cand_scores, cand_idx // V, cand_idx % V


class ServeEngine:
    def __init__(
        self,
        params: dict,
        llm_cfg,
        dec_name: str,
        *,
        max_batch: int = 8,
        max_len: int = 8192,
        policy: DTypePolicy = DTypePolicy(param_dtype=torch.bfloat16,
                                          compute_dtype=torch.bfloat16),
        seed: int = 0,
        max_top_k: int = 64,
        steps_per_tick: int = 4,
        prefill_chunk: int = 1024,
        kv_cache_dtype: torch.dtype | None = None,  # torch.int8: codes + scales
        spec_drafts: int = 0,     # > 0: speculative ticks, this many drafts a round
        spec_accept_margin: float = 0.0,  # reject drafts whose verify margin is below
        device="cuda",
        kernels: bool = True,
        group=None,               # parallel/tensor.py::ServingGroup of a sharded serving rank
        cuda_graphs: bool = True,
    ):
        """`params` is the decoder's tree on `device`. Runs on the card;
        `device="cpu"` asks for the CPU. `kernels=False` runs the kernels'
        plain versions. `cuda_graphs` (the default) replays a single-process
        engine's sampling ticks as CUDA graphs on the card; False runs the
        same static ticks uncaptured, as the CPU and a serving group do.

        With a serving `group` of more than one rank, `params` and
        `llm_cfg` are this rank's (models/starvector.py::serving_params):
        its tensor slices, and where the group has a layout its fsdp and
        stage shards of them, gathered at use inside every device call
        (parallel/zero.py::Layout.serve). The leader (group rank 0) runs
        the threads and the host state; before each device call it
        broadcasts a command over the group, and each follower, inside
        `follow()`, replays it on its own shards: the
        admission prefill (with the prefix embeddings), the insert into the
        ragged cache, a plain tick, a speculative tick, a beam round, a
        rebuild, one speculative stream (generate_speculative), the stop. Each tick's input tokens and sampled tokens go to
        the followers on the device (and a speculative round's proposal and
        accepted counts), so followers never sample and never decide a
        tick's kind. A follower whose own greedy tokens differ from the
        leader's, or whose command comes out of order, raises; a failure
        on the leader after a command went out leaves the group out of step,
        and the engine then fails every request (`broken`)."""
        self.device = require_device(device, 'device="cpu"')
        if self.device.type == "cuda" and self.device.index is None:
            # the threads set their device by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.group = group if group is not None and group.size > 1 else None
        self._tp_lock = threading.RLock()  # a command and its device calls, one at a time
        self._seq = 0                      # commands sent (leader) or replayed (follower)
        self._prefilled: dict[int, dict] = {}  # a follower's prefill caches by command
        self.checked_steps = 0  # a follower's steps whose tokens it checked against its own
        self.broken: BaseException | None = None
        self.dec = DECODERS[dec_name]
        self.dec_name = dec_name
        self.params = params
        self.llm_cfg = llm_cfg
        self.policy = policy
        self.kernels = kernels
        self.cuda_graphs = cuda_graphs
        self.max_batch = max_batch
        self.max_len = max_len
        self.max_top_k = max_top_k
        # tokens decoded a tick; admissions join between ticks. Tokens past
        # a stop are discarded.
        self.steps_per_tick = max(1, steps_per_tick)
        self.spec_drafts = max(0, int(spec_drafts))
        self.spec_accept_margin = float(spec_accept_margin)
        self.window = getattr(llm_cfg, "sliding_window", None)
        if self.spec_drafts and self.window is not None and self.spec_drafts + 1 > self.window:
            # fail at construction, not mid-serving inside the decode loop
            raise ValueError(
                f"spec_drafts+1 ({self.spec_drafts + 1}) exceeds the model's sliding window "
                f"({self.window}): the verify chunk must fit the window")
        # the admission chunk, rounded down to a power of two so that it
        # divides every bucket
        c = 64
        while c * 2 <= max(64, prefill_chunk):
            c *= 2
        self.prefill_chunk = c
        self.kv_dtype = kv_cache_dtype or policy.compute_dtype
        if self.device.type == "cuda" and kernels:
            # build the kernels once here, before two threads could both
            # reach the first launch
            from starvector_tpu_torch.ops import kernel_lib

            kernel_lib.library()
        self._rebuild_state_locked()
        # adaptive tick kind, measured: emitted tokens/s per (kind,
        # greedy_only); verify ticks run while they are not measurably
        # slower, else plain ticks for a backoff window, then one probe
        self._spec_probe_every = 16
        self._spec_skip = 0
        self._tick_rate: dict = {}
        self._rate_alpha = 0.4
        self._spec_backoff = self._spec_probe_every
        self.max_bias = 4                 # bound on logit_bias entries a request
        self.slots = [_Slot() for _ in range(max_batch)]
        # each slot's cache length as the host knows it (the key bounds)
        self._lens = [0] * max_batch
        self.beam_groups: list[_BeamGroup] = []
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._tick_gen = torch.Generator(device=self.device).manual_seed(seed)
        self._admit_gen = torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED)
        self._knob_cache: _Knobs | None = None
        self._stats = {"tokens": 0, "ticks": 0, "admissions": 0, "prefill_chunks": 0,
                       "spec_ticks": 0, "spec_extra_tokens": 0,
                       # tick start to the host having its tokens
                       "dispatch_s": 0.0, "dispatches": 0, "start_time": time.time()}
        # the decode loop holds _lock through each tick and yields it to any
        # other thread waiting in _locked() before taking it again (a plain
        # Lock would let the loop take it back at once and starve admissions)
        self._lock = threading.Lock()
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self._stop = threading.Event()
        self._stopped_group = False
        self._decode_thread: threading.Thread | None = None
        self._admit_thread: threading.Thread | None = None
        self._idle_wait = 0.005

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> Request:
        P = int(req.prefix_embeds.shape[1])
        # slack: a multi-step tick may overshoot a stop by steps_per_tick - 1
        # tokens; a speculative tick commits up to steps_per_tick * W - 1.
        # Beam groups never speculate.
        if req.num_beams > 1:
            slack = self.steps_per_tick - 1
        else:
            slack = self.steps_per_tick * (self.spec_drafts + 1) - 1
        if P + req.max_new_tokens + slack > self.max_len:
            req.out_queue.put((
                "error",
                f"prompt ({P}) + max_new_tokens ({req.max_new_tokens}) exceeds engine max_len "
                f"({self.max_len}, incl. {slack} multi-step/speculative slack)"))
            return req
        if req.logit_bias and len(req.logit_bias) > self.max_bias:
            req.out_queue.put((
                "error",
                f"logit_bias has {len(req.logit_bias)} entries; the engine's static bound is "
                f"max_bias={self.max_bias}"))
            return req
        if req.num_beams > self.max_batch:
            req.out_queue.put((
                "error",
                f"num_beams ({req.num_beams}) exceeds engine max_batch ({self.max_batch}); a "
                f"beam group occupies one slot per beam"))
            return req
        self.pending.put(req)
        return req

    def start(self):
        if self._decode_thread is None:
            self._decode_thread = threading.Thread(target=self._decode_loop, daemon=True)
            self._admit_thread = threading.Thread(target=self._admit_loop, daemon=True)
            self._decode_thread.start()
            self._admit_thread.start()

    def stop(self):
        self._stop.set()
        for t in (self._decode_thread, self._admit_thread):
            if t:
                t.join(timeout=5)
        self._decode_thread = None
        self._admit_thread = None
        if self.group is not None and self.broken is None and not self._stopped_group:
            with self._device_call("stop"):
                self._stopped_group = True
        # fail anything still queued: callers blocked on out_queue see an event
        while True:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            req.out_queue.put(("error", "engine stopped"))

    @torch.inference_mode()
    def warmup(self, prompt_lens, group_sizes=None, timeout: float = 2400):
        """Run the admission and tick chain once for every (prompt-length
        bucket, admission group size) pair, and the sampled and (with
        speculation) plain tick variants, so that first-use costs (the
        kernels' build, cuBLAS handles, the allocator's pools) never land
        mid-serving. Group sizes default to the powers of two up to
        max_batch, the sizes `_admit_loop` forms. Call on an idle engine;
        the stats() counters are restored afterwards."""
        self.start()
        counter_keys = ("tokens", "ticks", "admissions", "spec_ticks", "spec_extra_tokens",
                        "dispatch_s", "dispatches")
        stats_before = {k: self._stats[k] for k in counter_keys}
        if group_sizes is None:
            group_sizes, g = [], 1
            while g <= self.max_batch:
                group_sizes.append(g)
                g *= 2
        buckets = sorted({min(_bucket_len(int(p)), self.max_len) for p in prompt_lens})
        E = self.llm_cfg.hidden_size
        slack = self.steps_per_tick + 1

        def dummy(P: int, do_sample: bool) -> Request:
            return Request(prefix_embeds=np.zeros((1, P, E), np.float32),
                           max_new_tokens=min(self.steps_per_tick + 1, 4),
                           temperature=0.8 if do_sample else 0.0, do_sample=do_sample)

        def reserve(k: int) -> list[int]:
            idxs: list[int] = []
            deadline = time.time() + timeout
            while len(idxs) < k and time.time() < deadline:
                i = self._reserve_slot()
                if i is None:
                    time.sleep(self._idle_wait)
                else:
                    idxs.append(i)
            if len(idxs) < k:
                self._release_reserved(idxs)
                raise TimeoutError("warmup could not reserve slots")
            return idxs

        def admit_and_wait(reqs: list[Request], Pb: int) -> None:
            idxs = reserve(len(reqs))
            try:
                self._admit_group(reqs, idxs, Pb)
            except Exception:
                # release the slots still held: a failed warmup never
                # shrinks serving capacity
                self._release_reserved(idxs)
                raise
            for r in reqs:
                while True:
                    kind, payload = r.out_queue.get(timeout=timeout)
                    if kind == "done":
                        break
                    if kind == "error":
                        raise RuntimeError(f"warmup failed: {payload}")

        for Pb in buckets:
            P = min(Pb, self.max_len - slack - 1)
            for k in group_sizes:
                if k <= self.max_batch:
                    admit_and_wait([dummy(P, False) for _ in range(k)], Pb)
        P = min(buckets[0], self.max_len - slack - 1)
        admit_and_wait([dummy(P, True)], buckets[0])        # a sampled tick
        if self.spec_drafts > 0:
            # the plain variants run only behind the adaptive fallback
            self._spec_skip = 10_000
            try:
                admit_and_wait([dummy(P, False)], buckets[0])
                admit_and_wait([dummy(P, True)], buckets[0])
            finally:
                self._spec_skip = 0
        with self._locked():
            self._stats.update(stats_before)
            # warmup ticks carry first-use costs: their rates would poison
            # the verify-against-plain EMAs
            self._tick_rate = {}
            self._spec_skip = 0
            self._spec_backoff = self._spec_probe_every

    def stats(self) -> dict:
        """Serving counters (vLLM-style gauges): emitted tokens, ticks,
        admissions, prefill chunks (each one forward of the decoder over an
        admission group's prompts), uptime, average tokens/s."""
        up = max(time.time() - self._stats["start_time"], 1e-6)
        return {
            "tokens_emitted": self._stats["tokens"],
            "ticks": self._stats["ticks"],
            "admissions": self._stats["admissions"],
            "prefill_chunks": self._stats["prefill_chunks"],
            "spec_ticks": self._stats["spec_ticks"],
            "spec_extra_tokens": self._stats["spec_extra_tokens"],
            "dispatch_s_total": round(self._stats["dispatch_s"], 4),
            "dispatches": self._stats["dispatches"],
            "uptime_s": round(up, 1),
            "avg_tokens_per_s": round(self._stats["tokens"] / up, 2),
            "active_slots": self.num_active,
            "pending_requests": self.pending.qsize(),
        }

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    @property
    def queue_length(self) -> int:
        return self.pending.qsize() + self.num_active

    @contextlib.contextmanager
    def _locked(self):
        """Hold the engine lock from outside the decode loop, which yields
        it between two ticks to every thread waiting here."""
        with self._waiters_lock:
            self._waiters += 1
        try:
            with self._lock:
                yield
        finally:
            with self._waiters_lock:
                self._waiters -= 1

    # -- the serving group ----------------------------------------------------
    @contextlib.contextmanager
    def _device_call(self, op: str, **args):
        """Around one device call of the engine: a serving group's leader
        first sends `op` and its host arguments to the followers (one
        command at a time, in the order the leader's threads take them).
        Yields the command's number (0 without a group). An exception
        inside, once the command is out, leaves the followers out of step:
        the engine is `broken` and takes no further device call."""
        if self.group is None:
            yield 0
            return
        with self._tp_lock:
            if self.broken is not None:
                raise RuntimeError(f"the serving group is out of step since "
                                   f"{type(self.broken).__name__}: {self.broken}")
            self._seq += 1
            self.group.broadcast_object({"seq": self._seq, "op": op, **args})
            try:
                with self._serving():
                    yield self._seq
            except BaseException as e:
                self.broken = e
                raise

    def _serving(self):
        """The serving group's layout, active on this thread (its shards
        gathered at use), where it has one; else inference mode alone."""
        layout = None if self.group is None else self.group.layout
        return torch.inference_mode() if layout is None else layout.serve()

    def _share(self, t: torch.Tensor) -> torch.Tensor:
        """t, sent from the leader to a serving group's followers (on the
        device: no host sync); t itself without a group."""
        return t if self.group is None else self.group.broadcast(t)

    def _receive(self, shape, dtype) -> torch.Tensor:
        """A follower's copy of the leader's next _share."""
        return self.group.broadcast(torch.empty(shape, dtype=dtype, device=self.device))

    def follow(self) -> None:
        """A serving group's follower: replay the leader's commands on this
        rank's shards until its stop. Raises on a command out of order or
        unknown, on a device call that fails, and where this rank's own
        greedy tokens part from the leader's."""
        if self.group is None or self.group.is_leader:
            raise RuntimeError("follow() runs on a serving group's followers only")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        replay = {"prefill": self._follow_prefill, "insert": self._follow_insert,
                  "step": self._follow_step, "verify": self._follow_verify,
                  "beam": self._follow_beam, "speculative": self._follow_speculative,
                  "rebuild": lambda cmd: self._rebuild_state_locked()}
        with self._serving():
            while True:
                cmd = self.group.broadcast_object()
                self._seq += 1
                if not isinstance(cmd, dict) or cmd.get("seq") != self._seq:
                    raise RuntimeError(f"serving rank {self.group.rank}: command {cmd!r} out of "
                                       f"step (expected number {self._seq})")
                if cmd["op"] == "stop":
                    return
                if cmd["op"] not in replay:
                    raise RuntimeError(f"serving rank {self.group.rank}: unknown command {cmd!r}")
                replay[cmd["op"]](cmd)

    def _follow_prefill(self, cmd: dict) -> None:
        lens, Pb = cmd["lens"], cmd["Pb"]
        embeds = self._receive((len(lens), Pb, self.llm_cfg.hidden_size),
                               self.policy.compute_dtype)
        self._prefilled[cmd["seq"]] = self._prefill_embeds(embeds, lens, Pb)[0]

    def _follow_insert(self, cmd: dict) -> None:
        small = self._prefilled.pop(cmd["prefill"])
        for seq in [s for s in self._prefilled if s < cmd["prefill"]]:
            del self._prefilled[seq]  # admissions the leader gave up
        if cmd["tile"] > 1:
            small = dc.tile_rows(small, cmd["tile"])
        dc.insert_prefill_rows(self.cache, small, torch.tensor(cmd["slots"]),
                               torch.tensor(cmd["lens"]))

    def _follow_step(self, cmd: dict) -> None:
        """_static_ragged_step's forwards, fed the leader's tokens; with
        `check` (plain greedy traffic) each token must be this rank's own
        argmax on every active row."""
        B = self.max_batch
        active = torch.tensor(cmd["active"], dtype=torch.int32, device=self.device)
        tokens = self._receive((B,), torch.int64)
        agree = torch.ones(B, dtype=torch.bool, device=self.device)
        for _ in range(cmd["n"]):
            logits = self.dec.forward_ragged_decode_static(
                self.params, self.llm_cfg, tokens, self.cache, active, t_cap=cmd["t_cap"],
                policy=self.policy, kernels=self.kernels)
            tokens = self._receive((B,), torch.int64)
            if cmd["check"]:
                agree &= (logits.argmax(-1) == tokens) | (active == 0)
        self.checked_steps += cmd["n"] if cmd["check"] else 0
        if cmd["check"] and not bool(agree.all()):
            raise RuntimeError(f"serving rank {self.group.rank}: its greedy tokens part from the "
                               f"leader's in rows {torch.nonzero(~agree).flatten().tolist()} "
                               f"(command {cmd['seq']})")

    def _follow_verify(self, cmd: dict) -> None:
        """_fused_verify_multi's forwards and commits, fed the leader's
        proposals and accepted counts."""
        B, W = self.max_batch, cmd["W"]
        t_lo, t_hi = cmd["key_bounds"]
        for m in range(cmd["n"]):
            proposal = self._receive((B, W), torch.int64)
            self.dec.forward_ragged_verify(self.params, self.llm_cfg, proposal, self.cache,
                                           policy=self.policy, kernels=self.kernels,
                                           key_bounds=(t_lo, t_hi + m * W))
            dc.commit_verify(self.cache, self._receive((B,), torch.int64))

    def _follow_beam(self, cmd: dict) -> None:
        slots = torch.tensor(cmd["slots"], device=self.device)
        perm = torch.tensor(cmd["perm"], device=self.device)
        _beam_decode(self.dec, self.params, self.llm_cfg, self.cache, slots, perm,
                     self._receive((self.max_batch,), torch.int64), policy=self.policy,
                     kernels=self.kernels, key_bounds=tuple(cmd["key_bounds"]))

    def _follow_speculative(self, cmd: dict) -> None:
        prefix = self._receive((1, cmd["P"], self.llm_cfg.hidden_size), self.policy.compute_dtype)
        self._speculate(prefix, self._receive((1, cmd["n_ids"]), torch.int64), cmd["kw"])

    # -- admission (its own thread; the prefill runs off the lock) -----------
    def _reserve_slot(self) -> int | None:
        with self._locked():
            for i, s in enumerate(self.slots):
                if s.req is None and not s.reserved:
                    s.reserved = True
                    return i
        return None

    def _release_reserved(self, idxs) -> None:
        with self._locked():
            for i in idxs:
                if self.slots[i].req is None:
                    self.slots[i] = _Slot()

    def _admit_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    first = self.pending.get(timeout=0.05)
                except queue.Empty:
                    continue
                # drain the queue and group same-bucket requests: k prompts
                # prefill as one (k, Pb) batch
                batch = [first]
                while len(batch) < 2 * self.max_batch:
                    try:
                        batch.append(self.pending.get_nowait())
                    except queue.Empty:
                        break
                for r in batch:
                    if r.num_beams > 1:  # a beam request takes num_beams slots alone
                        try:
                            self._admit_beam(r)
                        except Exception as e:  # noqa: BLE001 — fail the request, not the loop
                            r.out_queue.put(("error", f"{type(e).__name__}: {e}"))
                groups: dict[int, list[Request]] = {}
                for r in batch:
                    if r.num_beams <= 1:
                        Pb = min(_bucket_len(int(r.prefix_embeds.shape[1])), self.max_len)
                        groups.setdefault(Pb, []).append(r)
                for Pb, reqs in groups.items():
                    while reqs and not self._stop.is_set():
                        # size the group by the slots free right now (never
                        # hold reserved slots idle waiting for more)
                        idxs = [i for i in (self._reserve_slot(),) if i is not None]
                        if not idxs:
                            time.sleep(self._idle_wait)
                            continue
                        while len(idxs) < min(len(reqs), self.max_batch):
                            nxt = self._reserve_slot()
                            if nxt is None:
                                break
                            idxs.append(nxt)
                        k2 = 1  # round down to a power of two
                        while k2 * 2 <= len(idxs):
                            k2 *= 2
                        self._release_reserved(idxs[k2:])
                        idxs = idxs[:k2]
                        chunk_reqs, reqs = reqs[:k2], reqs[k2:]
                        try:
                            self._admit_group(chunk_reqs, idxs, Pb)
                        except Exception as e:  # noqa: BLE001 — fail the requests, not the loop
                            self._release_reserved(idxs)
                            for r in chunk_reqs:
                                r.out_queue.put(("error", f"{type(e).__name__}: {e}"))
                    for r in reqs:  # stopped with requests still queued
                        r.out_queue.put(("error", "engine stopped"))

    def _prefill(self, embeds_list, Pb: int):
        """Right-pad k prompts (1, P, E) to the bucket Pb and prefill them in
        chunks into a B=k linear cache. Returns (the cache, each row's last
        position's logits (k, V), lengths, the prefill's command number: a
        serving group's insert names it)."""
        lens = [int(e.shape[1]) for e in embeds_list]
        rows = [F.pad(torch.as_tensor(e).to(self.device, self.policy.compute_dtype),
                      (0, 0, 0, max(Pb - P, 0)))[:, :Pb] for e, P in zip(embeds_list, lens)]
        embeds = torch.cat(rows, dim=0)                                        # (k, Pb, E)
        # not beside a tick's capture, whose launch counts would take its kernels
        with graphs.CAPTURE_LOCK, self._device_call("prefill", lens=lens, Pb=Pb) as seq:
            small, logits = self._prefill_embeds(self._share(embeds), lens, Pb)
        self._stats["prefill_chunks"] += max(Pb // self.prefill_chunk, 1)
        return small, logits, lens, seq

    def _prefill_embeds(self, embeds, lens: list[int], Pb: int):
        """The chunked prefill of right-padded prompts (k, Pb, E) of lengths
        `lens`. Returns (the B=k linear cache, each row's last position's
        logits (k, V) fp32: the head runs inside the prefill's device call,
        where a serving group gathers its table)."""
        cfg, policy = self.llm_cfg, self.policy
        k = embeds.shape[0]
        mask = (torch.arange(Pb, device=self.device)[None, :]
                < torch.tensor(lens, device=self.device)[:, None]).to(torch.int32)
        small = self.dec.init_cache(cfg, k, Pb, dtype=self.kv_dtype, device=self.device)
        n_chunks = max(Pb // self.prefill_chunk, 1)
        C = Pb // n_chunks
        last_idx = torch.tensor([P - 1 for P in lens], device=self.device)
        h_last = torch.zeros((k, cfg.hidden_size), dtype=policy.compute_dtype, device=self.device)
        for ci in range(n_chunks):
            h_last = _prefill_chunk(self.dec, self.params, cfg, embeds[:, ci * C:(ci + 1) * C],
                                    mask[:, ci * C:(ci + 1) * C], small, h_last, last_idx, ci * C,
                                    policy=policy, kernels=self.kernels)
        return small, _lm_logits(self.dec, self.params, cfg, h_last, policy)

    def _admit_beam(self, req: Request):
        """Admit one beam request into num_beams slots: the prompt's chunked
        prefill, the first round's candidates from its last hidden state
        (HF t = 0), then the prefix replicated into every beam row."""
        n = req.num_beams
        idxs: list[int] = []
        try:
            while len(idxs) < n and not self._stop.is_set():
                i = self._reserve_slot()
                if i is None:
                    time.sleep(self._idle_wait)
                else:
                    idxs.append(i)
            if len(idxs) < n:
                raise RuntimeError("engine stopped")
            P = int(req.prefix_embeds.shape[1])
            small, logits, _, seq = self._prefill([req.prefix_embeds],
                                                  min(_bucket_len(P), self.max_len))
            scores, toks = _beam_first(logits, n=n)
            group = _BeamGroup(req=req, slot_idxs=list(idxs), histories=[[]], scores=[0.0],
                               parent_perm=np.zeros((n,), np.int64),
                               next_tokens=np.zeros((n,), np.int64))
            # HF t = 0: only beam 0 exists, every candidate's parent
            group.select(scores.cpu().numpy(), np.zeros((2 * n,), np.int64), toks.cpu().numpy())
            with self._locked():
                try:
                    with self._device_call("insert", prefill=seq, slots=list(idxs),
                                           lens=[P] * n, tile=n):
                        dc.insert_prefill_rows(self.cache, dc.tile_rows(small, n),
                                               torch.tensor(idxs), torch.tensor([P] * n))
                except Exception as ie:  # noqa: BLE001
                    # a partial in-place insert may have touched any row:
                    # every active request fails with the rebuilt cache
                    self._fail_active_locked(ie)
                    raise
                self._knob_cache = None
                self._stats["admissions"] += 1
                for i in idxs:
                    slot = self.slots[i]
                    slot.req = req
                    slot.beam = group
                    slot.reserved = False
                    self._lens[i] = P
                self.beam_groups.append(group)
        except Exception:
            self._release_reserved(idxs)
            raise

    def _admit_group(self, reqs: list[Request], slot_idxs: list[int], Pb: int):
        """Bucketed batch prefill (no lock held), first tokens, then one
        locked insert of the k rows and their sampling state."""
        k = len(reqs)
        small, logits, lens, seq = self._prefill([r.prefix_embeds for r in reqs], Pb)
        # prompt ids bucketed like the embeds (-1 padding); empty when no
        # request gives them (the repetition penalty then sees output only)
        pid_rows = np.full((k, Pb), -1, np.int64)
        for row, r in enumerate(reqs):
            if r.prompt_token_ids is not None:
                ids = np.asarray(r.prompt_token_ids, np.int64).reshape(-1)
                pid_rows[row, :min(len(ids), Pb)] = ids[:Pb]
        pid_rows = torch.from_numpy(pid_rows).to(self.device)
        bias_ids, bias_vals = self._bias_arrays(reqs)

        def knob(values, dtype):
            return torch.tensor(values, dtype=dtype, device=self.device)

        firsts, presence_rows = _sample_first(
            logits, self.llm_cfg.vocab_size, self._admit_gen,
            knob([r.temperature if r.do_sample else 0.0 for r in reqs], torch.float32),
            knob([r.top_p for r in reqs], torch.float32),
            knob([r.top_k for r in reqs], torch.int32),
            knob([r.min_p for r in reqs], torch.float32),
            knob([r.repetition_penalty for r in reqs], torch.float32),
            pid_rows, bias_ids, bias_vals, max_top_k=self.max_top_k)
        first_ids = firsts.tolist()
        slots = torch.tensor(slot_idxs, device=self.device)
        with self._locked():
            try:
                with self._device_call("insert", prefill=seq, slots=list(slot_idxs), lens=lens,
                                       tile=1):
                    dc.insert_prefill_rows(self.cache, small, slots, torch.tensor(lens))
                _admit_sampling_state(self._counts, self._prompt_presence, slots, firsts,
                                      presence_rows)
                self._last_tokens[slots] = firsts
                if self.spec_drafts:
                    _admit_ctx_rows(self._ctx, self._ctx_len, slots, pid_rows)
                    # fresh requests probe speculation at once
                    self._spec_skip = 0
                    self._spec_backoff = self._spec_probe_every
            except Exception as e:
                # a partial in-place write may have touched any row: rebuild
                # so the decode loop stays serviceable, failing its requests
                self._fail_active_locked(e)
                raise
            self._knob_cache = None       # the slot composition changes below
            self._stats["admissions"] += k
            for r, i, tok, P in zip(reqs, slot_idxs, first_ids, lens):
                slot = self.slots[i]
                slot.req = r
                slot.generated = [tok]
                slot.last_token = tok
                slot.reserved = False
                self._lens[i] = P
                self._emit(i)

    def _rebuild_state_locked(self):
        """Allocate the device state anew (the cache, the sampling tables,
        the draft context) after a failed step may have left it half
        written. Caller holds _lock (or is the constructor). A serving
        group's followers rebuild theirs too, unless the group is out of
        step (`broken`)."""
        if self.group is not None and self.group.is_leader and self._seq and self.broken is None:
            with self._device_call("rebuild"):
                pass
        B, V = self.max_batch, self.llm_cfg.vocab_size
        self.cache = self.dec.init_ragged_cache(self.llm_cfg, B, self.max_len, dtype=self.kv_dtype,
                                                device=self.device)
        self._counts = torch.zeros((B, V), dtype=torch.int32, device=self.device)
        self._prompt_presence = torch.zeros((B, V), dtype=torch.int32, device=self.device)
        self._last_tokens = torch.zeros(B, dtype=torch.int64, device=self.device)
        self._ctx = self._ctx_len = None
        if self.spec_drafts:
            C = self.max_len + self.steps_per_tick * (self.spec_drafts + 1)
            self._ctx = torch.full((B, C), -1, dtype=torch.int64, device=self.device)
            self._ctx_len = torch.zeros(B, dtype=torch.int64, device=self.device)
        self._knob_cache = None
        # the static tick's graphs and the buffers they capture besides the
        # above: the tick's tokens, the knobs (allocated at the first _knobs)
        self._tick_out = torch.zeros((B, self.steps_per_tick), dtype=torch.int64,
                                     device=self.device)
        self._knob_buf: dict | None = None
        self._graphs: dict = {}
        self._graph_pool = None
        self._graph_warm = False

    def _bias_arrays(self, reqs):
        """Per-row logit_bias as (n, max_bias) id / value tensors (-1 = off)."""
        n = len(reqs)
        ids = np.full((n, self.max_bias), -1, np.int64)
        vals = np.zeros((n, self.max_bias), np.float32)
        for row, r in enumerate(reqs):
            if r is not None and r.logit_bias:
                for j, (tid, b) in enumerate(list(r.logit_bias.items())[:self.max_bias]):
                    ids[row, j] = int(tid)
                    vals[row, j] = float(b)
        return (torch.from_numpy(ids).to(self.device), torch.from_numpy(vals).to(self.device))

    # -- decode tick ---------------------------------------------------------
    def _emit(self, slot_idx: int) -> bool:
        """Push the slot's latest token; finish the request if it stopped.
        Returns True when the slot was released."""
        slot = self.slots[slot_idx]
        req = slot.req
        tok = slot.generated[-1]
        done = req.eos_token_id is not None and tok == req.eos_token_id
        for stop in req.stop_sequences:
            L = len(stop)
            if L and len(slot.generated) >= L and tuple(slot.generated[-L:]) == tuple(stop):
                done = True
        if len(slot.generated) >= req.max_new_tokens:
            done = True
        req.out_queue.put(("token", tok))
        self._stats["tokens"] += 1
        if done:
            req.out_queue.put(("done", list(slot.generated)))
            self.slots[slot_idx] = _Slot()
            self._knob_cache = None       # the slot composition changed
        return done

    def _key_bounds(self, idxs) -> tuple[int, int]:
        """(t_lo, t_hi) of the slots rows `idxs` may see now (a verify or
        beam tick's host key bounds): from the shortest row's window start
        to the longest row's length."""
        lens = [self._lens[i] for i in idxs]
        t_lo = 0 if self.window is None else max(min(lens) - self.window + 1, 0)
        return t_lo, max(lens)

    def _tick(self) -> bool:
        # beam slots decode in their own _beam_step rounds; they are inactive
        # rows of the sampling tick (their cache does not advance there)
        reqs = [s.req if s.beam is None else None for s in self.slots]
        worked = False
        if any(r is not None for r in reqs):
            worked = True
            self._sampling_tick(reqs)
        for group in list(self.beam_groups):
            worked = True
            self._beam_tick(group)
        return worked

    def _knobs(self, reqs) -> _Knobs:
        if self._knob_cache is None:
            # request constants: to the device only when the slot
            # composition changes, into the same buffers every time
            bias_ids, bias_vals = self._bias_arrays(reqs)

            def col(fn, dtype):
                return torch.tensor([fn(r) for r in reqs], dtype=dtype, device=self.device)

            fresh = dict(
                active=col(lambda r: 1 if r is not None else 0, torch.int32),
                temps=col(lambda r: r.temperature if (r and r.do_sample) else 0.0, torch.float32),
                top_ps=col(lambda r: r.top_p if r else 1.0, torch.float32),
                top_ks=col(lambda r: r.top_k if r else 0, torch.int32),
                min_ps=col(lambda r: r.min_p if r else 0.0, torch.float32),
                rep_pens=col(lambda r: r.repetition_penalty if r else 1.0, torch.float32),
                freq_pens=col(lambda r: r.frequency_penalty if r else 0.0, torch.float32),
                pres_pens=col(lambda r: r.presence_penalty if r else 0.0, torch.float32),
                bias_ids=bias_ids, bias_vals=bias_vals)
            if self._knob_buf is None:
                self._knob_buf = {k: torch.empty_like(v) for k, v in fresh.items()}
            for k, v in fresh.items():
                self._knob_buf[k].copy_(v)
            self._knob_cache = _Knobs(
                **self._knob_buf,
                greedy_only=all((not r.do_sample) or r.temperature == 0.0
                                for r in reqs if r is not None),
                plain_greedy=all(((not r.do_sample) or r.temperature == 0.0)
                                 and r.repetition_penalty == 1.0 and not r.frequency_penalty
                                 and not r.presence_penalty and not r.logit_bias
                                 for r in reqs if r is not None),
            )
        return self._knob_cache

    def _sampling_tick(self, reqs) -> None:
        if self.spec_drafts > 0:
            greedy_only = self._knobs(reqs).greedy_only
            # bootstrap: after the first verify measurement of a
            # composition, one plain tick so that both rates exist
            need_plain_sample = (self._tick_rate.get(("plain", greedy_only)) is None
                                 and self._tick_rate.get(("verify", greedy_only)) is not None)
            if self._spec_skip == 0 and not need_plain_sample:
                t0 = time.time()
                tok0 = self._stats["tokens"]
                self._verify_tick(reqs)
                self._update_tick_rate("verify", greedy_only, tok0, t0)
                return
            if self._spec_skip > 0:
                self._spec_skip -= 1
        t0 = time.time()
        tok0 = self._stats["tokens"]
        K = self.steps_per_tick
        kn = self._knobs(reqs)
        live = [i for i, r in enumerate(reqs) if r is not None]
        self._stats["ticks"] += 1
        t_disp = time.time()
        # kernel 2's key cap: the power of two (at most max_len) above every
        # live row's length after the tick
        t_cap = min(_bucket_len(max(self._lens[i] for i in live) + K), self.max_len)
        with self._device_call("step", n=K, t_cap=t_cap, active=[
                int(r is not None) for r in reqs], check=kn.plain_greedy):
            nxt = self._static_tick(kn, t_cap)
        nxt = nxt.cpu().numpy()  # (B, K): the tick's one host transfer
        self._stats["dispatch_s"] += time.time() - t_disp
        self._stats["dispatches"] += 1
        for i in live:
            self._lens[i] += K
            for j in range(K):
                tok = int(nxt[i, j])
                slot = self.slots[i]
                slot.generated.append(tok)
                slot.last_token = tok
                if self._emit(i):
                    break  # tokens past the stop are discarded
        if self.spec_drafts > 0:
            self._update_tick_rate("plain", kn.greedy_only, tok0, t0)

    def _static_tick(self, kn: _Knobs, t_cap: int) -> torch.Tensor:
        """steps_per_tick static ragged steps into self._tick_out (B, K),
        kernel 2's grids planned at t_cap. On the card, for a single-process
        engine with cuda_graphs: the engine's first tick uncaptured on the
        capture stream (the warm-up), then a CUDA graph a (t_cap,
        greedy_only), captured at its first use, after kernel 2's scratch is
        reserved for max_len keys, and replayed. Otherwise (the CPU,
        cuda_graphs=False, a serving group) the steps run uncaptured."""
        def run():
            _static_ragged_step(
                self.dec, self.params, self.llm_cfg, self._last_tokens, self._tick_out,
                self.cache, kn, self._tick_gen, self._counts, self._prompt_presence,
                policy=self.policy, max_top_k=self.max_top_k, n_steps=self.steps_per_tick,
                kernels=self.kernels, t_cap=t_cap, share=self._share)

        if self.device.type != "cuda" or not self.cuda_graphs or self.group is not None:
            run()
        elif not self._graph_warm:
            graphs.on_side_stream(self.device, run)
            self._graph_warm = True
        else:
            key = (t_cap, kn.greedy_only)
            if key not in self._graphs:
                graphs.reserve_decode(self.device, self.llm_cfg, self.max_batch, self.max_len)
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                self._graphs[key] = graphs.StepGraph(run, self.device, pool=self._graph_pool,
                                                     generators=(self._tick_gen,))
            self._graphs[key].replay()
        return self._tick_out

    def _update_tick_rate(self, kind: str, greedy_only: bool, tok0: int, t0: float) -> None:
        """Per-composition EMA of emitted tokens/s for this tick kind. After a
        verify measurement, fall back to plain ticks when verify is measurably
        slower; each failed probe doubles the fallback window (capped)."""
        dt = max(time.time() - t0, 1e-6)
        rate = (self._stats["tokens"] - tok0) / dt
        key = (kind, greedy_only)
        prev = self._tick_rate.get(key)
        a = self._rate_alpha
        self._tick_rate[key] = rate if prev is None else a * rate + (1 - a) * prev
        if kind == "verify":
            pv = self._tick_rate.get(("verify", greedy_only))
            pp = self._tick_rate.get(("plain", greedy_only))
            if pp is not None and pv is not None and pv < 0.95 * pp:
                if pv < 0.5 * pp:
                    self._spec_backoff = 256
                self._spec_skip = self._spec_backoff
                self._spec_backoff = min(self._spec_backoff * 2, 256)
            else:
                self._spec_backoff = self._spec_probe_every

    def _verify_tick(self, reqs) -> None:
        """One speculative tick: steps_per_tick verify rounds, drafting on the
        device; 1 to spec_drafts + 1 tokens a slot a round."""
        M = self.steps_per_tick
        kn = self._knobs(reqs)
        live = [i for i, r in enumerate(reqs) if r is not None]
        self._stats["ticks"] += 1
        self._stats["spec_ticks"] += 1
        t_disp = time.time()
        bounds = self._key_bounds(live)
        with self._device_call("verify", n=M, W=self.spec_drafts + 1, key_bounds=bounds):
            toks, chain, self._ctx_len, pending = _fused_verify_multi(
                self.dec, self.params, self.llm_cfg, self._last_tokens, self.cache, self._ctx,
                self._ctx_len, kn, self._tick_gen, self._counts, self._prompt_presence,
                policy=self.policy, max_top_k=self.max_top_k, n_rounds=M,
                draft_len=self.spec_drafts, accept_margin=self.spec_accept_margin,
                kernels=self.kernels, key_bounds=bounds, share=self._share)
            self._last_tokens.copy_(pending)  # in place: the static tick's graphs hold it
        both = torch.stack([toks, chain.to(toks.dtype)]).cpu().numpy()   # the one host transfer
        toks, chain = both[0], both[1]
        self._stats["dispatch_s"] += time.time() - t_disp
        self._stats["dispatches"] += 1
        for i in live:
            slot = self.slots[i]
            self._lens[i] += int(chain[i].sum())
            released = False
            for m in range(M):
                accepted = int(chain[i, m].sum())  # cumulative flags: the sum is the count
                self._stats["spec_extra_tokens"] += max(accepted - 1, 0)
                for j in range(accepted):
                    tok = int(toks[i, m, j])
                    slot.generated.append(tok)
                    slot.last_token = tok
                    if self._emit(i):
                        released = True
                        break  # tokens past the stop are discarded
                if released:
                    break

    def _beam_tick(self, group: _BeamGroup) -> None:
        """steps_per_tick beam rounds for one group, one _beam_step each
        (the next round's reorder needs this round's selection). A failure
        fails every active request: the cache may be half written."""
        try:
            idxs = torch.tensor(group.slot_idxs, device=self.device)
            for _ in range(self.steps_per_tick):
                bounds = self._key_bounds(group.slot_idxs)
                with self._device_call("beam", slots=list(group.slot_idxs),
                                       perm=group.parent_perm.tolist(), key_bounds=bounds):
                    cand_scores, parents, toks = _beam_step(
                        self.dec, self.params, self.llm_cfg, self.cache, idxs,
                        torch.from_numpy(group.parent_perm).to(self.device),
                        torch.from_numpy(group.next_tokens).to(self.device),
                        torch.tensor(group.scores, dtype=torch.float32, device=self.device),
                        self._last_tokens, policy=self.policy, n=len(group.slot_idxs),
                        kernels=self.kernels, key_bounds=bounds, share=self._share)
                for i in group.slot_idxs:
                    self._lens[i] += 1
                cand = torch.stack([cand_scores.double(), parents.double(),
                                    toks.double()]).cpu().numpy()
                group.select(cand[0], cand[1].astype(np.int64), cand[2].astype(np.int64))
                self._stats["ticks"] += 1
                if group.done():
                    best = group.best()
                    req = group.req
                    for tok in best:
                        req.out_queue.put(("token", tok))
                    self._stats["tokens"] += len(best)
                    req.out_queue.put(("done", best))
                    self._release_group(group)
                    return
        except Exception as e:  # noqa: BLE001 — keep the engine alive
            self._fail_active_locked(e)

    def _fail_active_locked(self, e: Exception) -> None:
        """Error out every active request and rebuild the device state
        (caller holds the lock): a failed step may have written the cache in
        part, so no surviving request could decode correctly from it."""
        failed: set[str] = set()
        for i, s in enumerate(self.slots):
            if s.req is not None:
                if s.req.request_id not in failed:  # one error per request
                    failed.add(s.req.request_id)
                    s.req.out_queue.put(("error", f"{type(e).__name__}: {e}"))
                self.slots[i] = _Slot()
        self.beam_groups.clear()
        self._rebuild_state_locked()

    def _release_group(self, group: _BeamGroup) -> None:
        if group in self.beam_groups:
            self.beam_groups.remove(group)
        for i in group.slot_idxs:
            self.slots[i] = _Slot()
        self._knob_cache = None

    def _decode_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    with self._lock:
                        worked = self._tick()
                except Exception as e:  # noqa: BLE001 — fail the active requests, keep looping
                    with self._lock:
                        self._fail_active_locked(e)
                    worked = False
                while self._waiters and not self._stop.is_set():
                    time.sleep(1e-4)  # let an admission or a caller take the lock
                if not worked:
                    time.sleep(self._idle_wait)

    # -- one speculative stream ---------------------------------------------------
    def generate_speculative(self, prefix_embeds: torch.Tensor, prompt_ids: torch.Tensor,
                             **kw):
        """Prompt-lookup speculative decoding of one greedy stream beside the
        slots, over its own linear cache (generation/speculative.py::
        generate_greedy_speculative): `prefix_embeds` (1, P, E), `prompt_ids`
        (1, n) aligned with it (-1 where a position has no id), `kw` that
        function's host arguments (max_new_tokens, draft_len,
        stop_sequences, eos_token_id, pad_token_id). One device call under
        the engine lock, so that a serving group's collectives keep one
        order against admissions and ticks; the followers replay it on
        their slices (_follow_speculative) and check each round's tokens.
        Returns (tokens (1, max_new_tokens), lengths (1,), n_forwards)."""
        with self._locked(), self._device_call("speculative", P=int(prefix_embeds.shape[1]),
                                               n_ids=int(prompt_ids.shape[1]), kw=kw):
            prefix = self._share(prefix_embeds.to(self.device, self.policy.compute_dtype))
            return self._speculate(prefix, self._share(prompt_ids.to(self.device, torch.int64)),
                                   kw)

    def _speculate(self, prefix: torch.Tensor, prompt_ids: torch.Tensor, kw: dict):
        mask = torch.ones(prefix.shape[:2], dtype=torch.int32, device=self.device)
        return generate_greedy_speculative(self.params, self.llm_cfg, prefix, mask, prompt_ids,
                                           policy=self.policy, kernels=self.kernels,
                                           group=self.group, cuda_graphs=self.cuda_graphs, **kw)

    # -- synchronous convenience ---------------------------------------------
    def generate_sync(self, req: Request, timeout: float = 600) -> list[int]:
        self.submit(req)
        self.start()
        return self.result(req, timeout)

    def result(self, req: Request, timeout: float = 600) -> list[int]:
        """The ids of a request already submitted, once it is done (its
        token events are read and dropped); raises on its error or after
        `timeout` seconds."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                kind, payload = req.out_queue.get(timeout=1.0)
            except queue.Empty:
                continue
            if kind == "done":
                return payload
            if kind == "error":
                raise RuntimeError(f"request {req.request_id} failed: {payload}")
        raise TimeoutError(f"request {req.request_id} timed out")
