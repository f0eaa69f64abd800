"""Autoregressive generation: one cached prefill, then a loop of static
decode steps, replayed as CUDA graphs on the card (port of generate /
generate_im2svg / generate_text2svg of starvector_tpu/generation/engine.py).

The first token is drawn from the prefill's last logits. Each row stops on
its own when one of the stop sequences (the `</svg>` ids for im2svg) or eos
ends its output; rows that are done emit pad tokens, and the loop ends when
every row is done.

The decode loop is the JAX package's jitted `lax.while_loop` (its
engine.py:225) as the card runs it: every step samples a token
(`BatchSampler.step`, with the token index `t` on the device) and runs the
decoder's `forward_decode_static` (the write slot `pos` on the device,
kernel 2 taking its key bounds from there), so no launch of a step depends
on where the loop is. The first step runs eagerly, as the warm-up; every
later step replays a CUDA graph of one step (generation/graphs.py),
captured once a call for each power-of-two bucket of the keys a step reads
(`step_cap`: the step's kernel-2 grid is planned there, so a long budget
does not plan every step at its last key). The steps go in blocks of
DECODE_GRAPH_STEPS replays back to back (`decode_blocks`), and the host tests
`done` once a block, not once a token. A graph holds one step, not a
block: a capture costs a step of host time in every call, and graphs of
16 steps took 3.38 ms a step against 2.09 for one (1B bf16, B = 4, 128
tokens, on an H100 80GB HBM3 at 700 W; PERF.md section 6), while
back-to-back replays cost the device the same. Steps after every row is done emit pads and change neither
tokens nor lengths; the last block is cut short, so no step runs past
token n - 1. `cuda_graphs=False` runs the same steps uncaptured (the same
launches, so the same bits); on the CPU they always run uncaptured.

num_return_sequences = n > 1 prefills each distinct row once, then tiles
the filled cache, the last logits and the prompt's presence table n times
(decode_common.tile_rows): the rows come out grouped [p0 x n, p1 x n, ...],
HF's expand order, and the decode steps run at B x n rows.

Beam search (beam.py), prompt-lookup speculative decoding
(speculative.py) and GRPO rollouts (train/grpo.py) build on these pieces;
`BatchSampler` is the per-token choice and stop test that generate and the
pipelined loop share.

Offline pipelined generation over a stream of same-shaped batches,
generate_pipelined: batch k + 1's left-padded prompt is prefilled C
positions a step inside batch k's decode steps, so batch k + 1 starts
decoding when batch k ends. GPTBigCode fuses each step into one forward
(forward_decode_with_chunk_static: kernel 2 for the decode row, the chunk
step's attention for the chunk, the projections shared); StarCoder2 has
none (nor has the JAX package) and runs the static decode step and then
the static chunk step. Its steps are static too, the JAX _decode_overlap
loop's (its engine.py:320) as the card runs it: the chunk's write index is
on the device, so each step kind and key bucket is one graph, captured
once a stream (graphs.StepLoop). Its speculative counterpart,
generate_pipelined_spec, is in speculative.py.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from starvector_tpu_torch.generation import graphs
from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.ops.sampling import NEG_INF, sample_token

# decode steps between two host reads of `done`
DECODE_GRAPH_STEPS = 16


def decoder_module(llm_cfg):
    """The decoder module of a decoder config: models.gpt_bigcode or
    models.starcoder2 (the JAX generate's dispatch on the decoder's name)."""
    return next(mod for mod, cfg_type in sv.DECODERS.values() if isinstance(llm_cfg, cfg_type))


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    min_new_tokens: int = 1
    do_sample: bool = True
    temperature: float = 1.0
    top_p: float = 0.9
    top_k: int = 0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    logit_bias: tuple[tuple[int, float], ...] = ()
    num_return_sequences: int = 1
    stop_sequences: tuple[tuple[int, ...], ...] = ()
    eos_token_id: int | None = None
    pad_token_id: int = 0
    max_top_k: int = 64


def stop_hit(tokens: torch.Tensor, t, new_tok: torch.Tensor, stops: list[torch.Tensor],
             eos_token_id: int | None, max_new_tokens: int) -> torch.Tensor:
    """(...,) bool: a stop sequence (`stops`, on the device) is a suffix of
    [tokens[..., :t], new_tok], or new_tok is eos; tokens (..., n), new_tok
    (...,). A stop longer than max_new_tokens can never match. `t` is an
    int, or a (1,) int tensor on the device (read there, as the JAX
    check_stops' dynamic slice)."""
    hit = torch.zeros_like(new_tok, dtype=torch.bool)
    on_device = isinstance(t, torch.Tensor)
    for s in stops:
        L = len(s)
        if L == 0 or L > max_new_tokens or (not on_device and t < L - 1):
            continue
        match = new_tok == s[-1]
        if on_device:
            match &= t >= L - 1
        if L > 1:
            if on_device:
                cols = torch.clamp(t - (L - 1) + torch.arange(L - 1, device=t.device), min=0)
                window = tokens.index_select(-1, cols.long())
            else:
                window = tokens[..., t - (L - 1):t]
            match &= (window == s[:-1]).all(dim=-1)
        hit |= match
    if eos_token_id is not None:
        hit |= new_tok == eos_token_id
    return hit


def prompt_presence(gen: GenerationConfig, B: int, V: int, device,
                    prompt_ids: torch.Tensor | None) -> torch.Tensor | None:
    """The repetition penalty's (B, V) presence table, the prompt's ids set
    (JAX presence_for); None without a penalty."""
    if gen.repetition_penalty == 1.0:
        return None
    presence = torch.zeros((B, V), dtype=torch.int32, device=device)
    if prompt_ids is not None:
        presence.scatter_(1, prompt_ids.long().to(device), 1)
    return presence


class BatchSampler:
    """One batch's token choice and stops, step by step (the JAX loops'
    body, shared by generate and generate_pipelined): the min-new-tokens eos
    mask, sample_token with the presence table, penalty counts and logit
    bias, pad tokens for rows that are done, and stop_hit. Holds tokens
    (B, n), lengths (B,), done (B,) and the next token's index t (1,) int32,
    all on the device and all written in place, with the knobs as device
    tensors: a step reads nothing back, so a CUDA graph can capture it."""

    def __init__(self, gen: GenerationConfig, B: int, V: int, device,
                 presence: torch.Tensor | None, generator: torch.Generator | None):
        self.gen, self.generator, self.presence = gen, generator, presence
        n = gen.max_new_tokens
        use_freq = gen.frequency_penalty != 0.0 or gen.presence_penalty != 0.0
        self.counts = torch.zeros((B, V), dtype=torch.int32, device=device) if use_freq else None
        self.bias_ids = self.bias_vals = None
        if gen.logit_bias:
            self.bias_ids = torch.tensor([[t for t, _ in gen.logit_bias]] * B, device=device)
            self.bias_vals = torch.tensor([[v for _, v in gen.logit_bias]] * B, device=device)
        self.tokens = torch.full((B, n), gen.pad_token_id, dtype=torch.int64, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.lengths = torch.full((B,), n, dtype=torch.int64, device=device)
        self.stops = [torch.tensor(s, dtype=torch.int64, device=device)
                      for s in gen.stop_sequences]
        self.t = torch.zeros(1, dtype=torch.int32, device=device)
        self.knobs = {name: torch.as_tensor(getattr(gen, name), device=device)
                      for name in ("temperature", "top_p", "top_k", "min_p", "repetition_penalty",
                                   "frequency_penalty", "presence_penalty")}
        self.eos_col = None  # eos's column of the vocabulary, where min_new_tokens masks it
        if gen.eos_token_id is not None and gen.min_new_tokens > 0:
            self.eos_col = torch.arange(V, device=device) == gen.eos_token_id

    def reset(self, prompt_ids: torch.Tensor | None = None) -> None:
        """Start a new batch of the same shape in place (a pipelined
        stream's next batch): tokens pad, lengths max_new_tokens, done
        cleared, t 0, the penalty counts zeroed and the presence table set
        to `prompt_ids`' ids (B, P)."""
        self.tokens.fill_(self.gen.pad_token_id)
        self.lengths.fill_(self.gen.max_new_tokens)
        self.done.zero_()
        self.t.zero_()
        if self.counts is not None:
            self.counts.zero_()
        if self.presence is not None:
            self.presence.zero_()
            if prompt_ids is not None:
                self.presence.scatter_(1, prompt_ids.long().to(self.presence.device), 1)

    def step(self, logits: torch.Tensor) -> torch.Tensor:
        """Token t of every row (B,) from its logits (B, V); records it and
        advances t."""
        gen, kn, t = self.gen, self.knobs, self.t
        if self.eos_col is not None:
            logits = torch.where(self.eos_col & (t < gen.min_new_tokens), NEG_INF, logits)
        nxt = sample_token(
            logits, do_sample=gen.do_sample, temperature=kn["temperature"], top_p=kn["top_p"],
            top_k=kn["top_k"], min_p=kn["min_p"], presence=self.presence,
            repetition_penalty=kn["repetition_penalty"] if self.presence is not None else None,
            counts=self.counts, frequency_penalty=kn["frequency_penalty"],
            presence_penalty=kn["presence_penalty"], bias_ids=self.bias_ids,
            bias_vals=self.bias_vals, max_top_k=gen.max_top_k, generator=self.generator,
        )
        nxt = torch.where(self.done, gen.pad_token_id, nxt)
        newly_done = stop_hit(self.tokens, t, nxt, self.stops, gen.eos_token_id,
                              gen.max_new_tokens) & ~self.done
        self.lengths.copy_(torch.where(newly_done, (t + 1).long(), self.lengths))
        self.tokens.index_copy_(1, t.long(), nxt[:, None])
        if self.presence is not None:
            self.presence.scatter_(1, nxt[:, None], 1)
        if self.counts is not None:
            self.counts.scatter_add_(1, nxt[:, None], (~self.done).to(torch.int32)[:, None])
        self.done |= newly_done
        t.add_(1)
        return nxt


def _check_top_k(gen: GenerationConfig) -> None:
    if gen.top_k > gen.max_top_k:
        raise ValueError(f"top_k={gen.top_k} exceeds max_top_k={gen.max_top_k}")


@torch.no_grad()
def generate(
    params: dict,
    llm_cfg,                       # GPTBigCodeConfig or StarCoder2Config
    inputs_embeds: torch.Tensor,   # (B, P, E)
    attention_mask: torch.Tensor,  # (B, P)
    gen: GenerationConfig,
    generator: torch.Generator | None = None,
    *,
    prompt_ids: torch.Tensor | None = None,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
    kv_cache_dtype: torch.dtype | None = None,
    cuda_graphs: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B x num_return_sequences, max_new_tokens) int64,
    lengths (B x num_return_sequences,)): rows are pad-filled after their
    stop, lengths include the stop tokens, and a prompt's n return
    sequences are adjacent rows. `kv_cache_dtype` is the cache's type
    (default: the compute dtype); torch.int8 stores it as codes with
    per-(position, head) scales, as the JAX generate's
    `kv_cache_dtype=jnp.int8`. On the card the decode steps replay as CUDA
    graphs, DECODE_GRAPH_STEPS of them between two reads of `done` (see the
    module docstring); `cuda_graphs=False` runs the same static steps
    uncaptured."""
    _check_top_k(gen)
    dec = decoder_module(llm_cfg)
    B, P, _ = inputs_embeds.shape
    V = llm_cfg.vocab_size
    device = inputs_embeds.device
    n = gen.max_new_tokens
    n_rep = gen.num_return_sequences
    presence = prompt_presence(gen, B, V, device, prompt_ids)
    last_logits, cache = _prefill_full(params, llm_cfg, inputs_embeds, attention_mask, P + n,
                                       policy, kernels, kv_cache_dtype)
    if n_rep > 1:
        # one prefill per distinct row; its cache serves the row's n samples
        last_logits = last_logits.repeat_interleave(n_rep, dim=0)
        cache = dc.tile_rows(cache, n_rep)
        if presence is not None:
            presence = presence.repeat_interleave(n_rep, dim=0)
        B *= n_rep

    sampler = BatchSampler(gen, B, V, device, presence, generator)
    decode_static(params, llm_cfg, cache, P, last_logits, sampler, policy=policy,
                  kernels=kernels, cuda_graphs=cuda_graphs and device.type == "cuda")
    return sampler.tokens, sampler.lengths


def decode_blocks(n: int, K: int) -> list[int]:
    """The static decode loop's n - 1 steps for n new tokens (the last token
    needs no forward), in blocks between two host reads of `done`: the first
    step alone (the warm-up), then blocks of K steps, the last one shorter
    where n - 2 is no multiple of K."""
    left = n - 1
    blocks = [1] if left > 0 else []
    left -= 1
    while left > 0:
        blocks.append(min(K, left))
        left -= blocks[-1]
    return blocks


def step_cap(pos: int, T: int) -> int:
    """Kernel 2's key cap for the decode step that writes slot pos (its keys
    lie below pos) of a T-slot cache: the power-of-two bucket above pos, at
    most T. The steps of one bucket share one captured graph."""
    return min(graphs.bucket_len(pos + 1), T)


def chunk_cap(idx: int, T: int) -> int:
    """The key span [0, chunk_cap) of a static chunk step (or verify) whose
    keys lie below slot idx of a T-slot cache: 0 for a chunk at slot 0,
    else the power-of-two bucket above idx, at most T. The steps of one
    span share one captured graph."""
    return 0 if idx <= 0 else min(graphs.bucket_len(idx), T)


def decode_static(params: dict, llm_cfg, cache: dict, P: int, last_logits: torch.Tensor,
                  sampler: BatchSampler, *, policy: DTypePolicy, kernels: bool,
                  cuda_graphs: bool) -> None:
    """generate's decode loop over a linear cache prefilled with P slots,
    from the prefill's last logits (B, V): each step samples a token
    (sampler) and runs the decoder's forward_decode_static at the device
    slot pos, its key cap step_cap(pos); the last token is sampled with no
    forward. `cuda_graphs` (on the card) captures one step a key cap and
    replays it for every later step of that cap; otherwise the steps run
    uncaptured, with the same launches. The host reads `done` once a block
    of decode_blocks."""
    dec = decoder_module(llm_cfg)
    device = last_logits.device
    T = cache["k"].shape[2]
    logits = last_logits.contiguous().clone()
    pos = torch.full((1,), P, dtype=torch.int32, device=device)

    def step(t_cap: int) -> None:
        nxt = sampler.step(logits)
        embeds = dec.embed_tokens(params, nxt[:, None]).to(policy.compute_dtype)
        logits.copy_(dec.forward_decode_static(params, llm_cfg, embeds, cache, pos, t_cap=t_cap,
                                               policy=policy, kernels=kernels))
        pos.add_(1)

    n = sampler.gen.max_new_tokens
    blocks = decode_blocks(n, DECODE_GRAPH_STEPS)
    loop = graphs.StepLoop(device, cuda_graphs, (sampler.generator,))
    if loop.enabled and blocks:
        graphs.reserve_decode(device, llm_cfg, cache["k"].shape[1], step_cap(P + n - 2, T))
    p = P
    for n_steps in blocks:
        for _ in range(n_steps):
            t_cap = step_cap(p, T)
            loop.run("decode", t_cap, lambda c=t_cap: step(c))
            p += 1
        if graphs.host_read(sampler.done.all())[0]:
            return
    if n > 0:
        sampler.step(logits)


def _prefill_full(params: dict, llm_cfg, inputs_embeds: torch.Tensor,
                  attention_mask: torch.Tensor, max_len: int, policy: DTypePolicy, kernels: bool,
                  kv_cache_dtype) -> tuple[torch.Tensor, dict]:
    """A batch's whole prompt through the cached forward into a new cache
    of max_len slots (kv_cache_dtype, else the compute dtype). Returns (the
    last position's logits (B, V) fp32, the cache)."""
    dec = decoder_module(llm_cfg)
    cache = dec.init_cache(llm_cfg, inputs_embeds.shape[0], max_len,
                           dtype=kv_cache_dtype or policy.compute_dtype,
                           device=inputs_embeds.device)
    logits, cache = dec.forward(params, llm_cfg, inputs_embeds, attention_mask=attention_mask,
                                cache=cache, policy=policy, last_logits_only=True,
                                kernels=kernels)
    return logits[:, -1], cache


def im2svg_prefix(params: dict, cfg: sv.StarVectorConfig, images: torch.Tensor,
                  prompt_ids: torch.Tensor, *, policy: DTypePolicy = DTypePolicy()):
    """[visual tokens ‖ prompt embeds] and its all-ones mask."""
    cond = sv.encode_image(params, cfg, images, policy=policy)
    B, Q, _ = cond.shape
    prompt_embeds = cfg.decoder_module.embed_tokens(params["svg_transformer"], prompt_ids)
    inputs_embeds = torch.cat([cond, policy.cast(prompt_embeds)], dim=1)
    mask = torch.ones((B, Q + prompt_ids.shape[1]), dtype=torch.int32, device=cond.device)
    return inputs_embeds, mask


def generate_im2svg(
    params: dict,
    cfg: sv.StarVectorConfig,
    images: torch.Tensor,      # (B, H, W, 3) processed
    prompt_ids: torch.Tensor,  # (B, Sp) the tokenized generation prompt "<svg"
    gen: GenerationConfig,
    generator: torch.Generator | None = None,
    *,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
    kv_cache_dtype: torch.dtype | None = None,
    cuda_graphs: bool = True,
):
    """Returns (tokens, lengths) of the NEW tokens; callers prepend the
    prompt ids before detokenizing."""
    inputs_embeds, mask = im2svg_prefix(params, cfg, images, prompt_ids, policy=policy)
    return generate(params["svg_transformer"], cfg.llm, inputs_embeds, mask, gen, generator,
                    prompt_ids=prompt_ids, policy=policy, kernels=kernels,
                    kv_cache_dtype=kv_cache_dtype, cuda_graphs=cuda_graphs)


def generate_text2svg(
    params: dict,
    cfg: sv.StarVectorConfig,
    input_ids: torch.Tensor,       # (B, S) caption + <svg-start>, left-padded
    attention_mask: torch.Tensor,  # (B, S)
    gen: GenerationConfig,
    generator: torch.Generator | None = None,
    *,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
    kv_cache_dtype: torch.dtype | None = None,
    cuda_graphs: bool = True,
):
    """text2svg: the caption's token embeddings are the whole prefix (no
    vision tower). The prompt ids, pads included, are `generate`'s
    prompt_ids, as in the JAX function, so a repetition penalty counts the
    same tokens. Returns (tokens, lengths) of the new tokens."""
    embeds = cfg.decoder_module.embed_tokens(params["svg_transformer"], input_ids)
    return generate(params["svg_transformer"], cfg.llm, policy.cast(embeds), attention_mask,
                    gen, generator, prompt_ids=input_ids, policy=policy, kernels=kernels,
                    kv_cache_dtype=kv_cache_dtype, cuda_graphs=cuda_graphs)


# ---------------------------------------------------------------------------
# offline pipelined generation: the next batch's prompt prefilled a chunk
# at a time inside the current batch's decode steps
# ---------------------------------------------------------------------------

def _chunk_plan(P: int, max_new_tokens: int, chunk_positions: int | None) -> tuple[int, int]:
    """(C, n_chunks) of generate_pipelined: the prompt spread over the
    decode steps, at least 4 positions a step; a chunk size that would need
    more chunks than steps is re-derived by the rule."""
    C = chunk_positions or max(4, -(-P // max_new_tokens))
    n_chunks = -(-P // C)
    if n_chunks > max_new_tokens:
        C = max(4, -(-P // max_new_tokens))
        n_chunks = -(-P // C)
    return C, n_chunks


def pad_time(x: torch.Tensor, width: int, value=0, left: bool = True) -> torch.Tensor:
    """x (B, S[, E]) padded with `value` on its second axis to `width`.
    Raises ValueError where S > width (F.pad would crop the prompt)."""
    d = width - x.shape[1]
    if d < 0:
        raise ValueError(f"a prompt of {x.shape[1]} positions does not fit in {width}")
    if d == 0:
        return x
    pad = (d, 0) if left else (0, d)
    return F.pad(x, (0, 0) * (x.ndim - 2) + pad, value=value)


def _decode_overlap(params: dict, llm_cfg, loop: graphs.StepLoop, sampler: BatchSampler,
                    logits: torch.Tensor, cache: dict, P: int, pos: torch.Tensor,
                    nxt: tuple | None, C: int, n_chunks: int, policy: DTypePolicy,
                    kernels: bool) -> None:
    """Decode one batch of a pipelined stream (its cache prefilled with P
    slots, its first logits in `logits`, (B, V), the write slot pos at P)
    while chunk-prefilling the next one, nxt = (its cache, the staged
    prompt embeds (B, n_chunks x C, E) and mask, left-padded, the cache's
    write index idx at 0, the buffer for its first logits), or None for the
    last batch. The steps, as the JAX loop's `lax.cond` picks them: while t
    < n_chunks, step t samples token t and runs the fused step
    (forward_decode_with_chunk_static where the decoder has one, else the
    static decode step and then the static chunk step), even after every row
    is done (a done row emits pads); the last chunk's step also writes the
    next batch's first logits (its last position: the prompts are
    left-padded). Then, while a row is live, a token and a static decode
    step a step up to token max_new_tokens - 1, which is sampled with no
    forward. The host reads `done` once after the chunks and once a block of
    DECODE_GRAPH_STEPS decode steps. Every step runs through `loop`: a
    captured graph a (kind, key caps) on the card."""
    dec = decoder_module(llm_cfg)
    fused = getattr(dec, "forward_decode_with_chunk_static", None)
    n = sampler.gen.max_new_tokens
    T = cache["k"].shape[2]

    def embed_next() -> torch.Tensor:
        tok = sampler.step(logits)
        return dec.embed_tokens(params, tok[:, None]).to(policy.compute_dtype)

    def decode_step(t_cap: int) -> None:
        logits.copy_(dec.forward_decode_static(params, llm_cfg, embed_next(), cache, pos,
                                               t_cap=t_cap, policy=policy, kernels=kernels))
        pos.add_(1)

    t = 0
    if nxt is not None:
        cache_next, stage_e, stage_m, idx, next_last = nxt

        def chunk_step(t_cap: int, c_cap: int, final: bool) -> None:
            # every tensor a step reads is the stream's or the step's own: its
            # graph is replayed in later batches, after this call's locals died
            slots = idx.long() + torch.arange(C, device=idx.device)
            ce, cm = stage_e.index_select(1, slots), stage_m.index_select(1, slots)
            if fused is not None:
                dec_logits, last = fused(params, llm_cfg, embed_next(), cache, pos, ce, cm,
                                         cache_next, idx, t_cap=t_cap, chunk_cap=c_cap,
                                         policy=policy, kernels=kernels, chunk_logits=final)
                logits.copy_(dec_logits)
                pos.add_(1)
            else:
                decode_step(t_cap)
                last = dec.forward_chunk_static(params, llm_cfg, ce, cm, cache_next, idx,
                                                t_cap=c_cap, policy=policy, kernels=kernels,
                                                return_hidden=not final,
                                                last_logits_only=True)[:, -1]
            if final:
                next_last.copy_(last)
            idx.add_(C)

        for t in range(n_chunks):
            key = (step_cap(P + t, T), chunk_cap(t * C, T), t == n_chunks - 1)
            loop.run("fused", key, lambda k=key: chunk_step(*k))
        t = n_chunks
        if graphs.host_read(sampler.done.all())[0]:
            return
    while t < n - 1:
        end = min(t + DECODE_GRAPH_STEPS, n - 1)
        for s in range(t, end):
            t_cap = step_cap(P + s, T)
            loop.run("decode", t_cap, lambda c=t_cap: decode_step(c))
        t = end
        if graphs.host_read(sampler.done.all())[0]:
            return
    if t == n - 1:
        sampler.step(logits)


@torch.no_grad()
def generate_pipelined(
    params: dict,
    llm_cfg,                # GPTBigCodeConfig or StarCoder2Config
    batches: list,          # [(inputs_embeds (B, P, E), attention_mask (B, P))], left-padded
    gen: GenerationConfig,
    generator: torch.Generator | None = None,
    *,
    prompt_ids: list | None = None,  # per batch (B, P), for the repetition penalty
    policy: DTypePolicy = DTypePolicy(),
    chunk_positions: int | None = None,
    kernels: bool = True,
    kv_cache_dtype: torch.dtype | None = None,
    cuda_graphs: bool = True,
) -> list:
    """Generate over a stream of same-shaped batches, batch k + 1's prompt
    written into its cache C positions a decode step of batch k, so that
    its decoding starts when batch k's ends (the JAX generate_pipelined).
    C = chunk_positions, else max(4, ceil(P / max_new_tokens)); each prompt
    is left-padded to n_chunks x C. Batch 0 prefills whole. Every batch's
    sampling and stops are generate's (BatchSampler), so each batch gives
    what `generate` gives on the same left-padded batch, up to the
    arithmetic of the chunked prefill and the fused steps' M = B x (1 + C)
    rows. StarVector-1B's GPTBigCode fuses each step's decode and chunk into
    one forward; StarCoder2 has no fused forward (in either package) and
    runs the two forwards. `kv_cache_dtype=torch.int8` stores both caches
    as codes and scales. Returns [(tokens, lengths), ...], generate's
    per-batch result.

    The steps are static (_decode_overlap): the stream allocates its two
    caches, a staging buffer for the next prompt and the sampler once, and
    between batches copies the chunk-filled cache into the current one's
    place and resets the other in place (key mask zeroed), so every batch's
    steps read and write the same buffers. On the card they replay as CUDA
    graphs, one a step kind and key bucket, captured once a stream: a stream
    of N same-shaped batches captures no more graphs than one of 2.
    `cuda_graphs=False` runs the same steps uncaptured; the CPU always does."""
    if gen.num_return_sequences != 1:
        raise ValueError("generate_pipelined supports num_return_sequences=1")
    if not batches:
        return []
    _check_top_k(gen)
    dec = decoder_module(llm_cfg)
    B, P, E = batches[0][0].shape
    V = llm_cfg.vocab_size
    n = gen.max_new_tokens
    C, n_chunks = _chunk_plan(P, n, chunk_positions)
    Pn = n_chunks * C

    def padded(i):
        embeds, mask = batches[i]
        return pad_time(embeds, Pn), pad_time(mask, Pn)

    widths = [embeds.shape[1] for embeds, _ in batches]
    if max(widths) > Pn:  # before any forward, not at the batch that overflows
        raise ValueError(f"prompt widths {widths} exceed the {Pn} positions batch 0's fixes")
    e0, m0 = padded(0)
    device = e0.device
    last, cache = _prefill_full(params, llm_cfg, e0, m0, Pn + n, policy, kernels,
                                kv_cache_dtype)
    logits = last.contiguous().clone()
    pos = torch.zeros(1, dtype=torch.int32, device=device)
    nxt = None
    if len(batches) > 1:
        nxt = (dec.init_cache(llm_cfg, B, Pn + n, dtype=kv_cache_dtype or policy.compute_dtype,
                              device=device),
               torch.zeros((B, Pn, E), dtype=policy.compute_dtype, device=device),
               torch.zeros((B, Pn), dtype=torch.int32, device=device),
               torch.zeros(1, dtype=torch.int32, device=device),
               torch.zeros((B, V), dtype=torch.float32, device=device))
    sampler = BatchSampler(gen, B, V, device, prompt_presence(gen, B, V, device, None),
                           generator)
    loop = graphs.StepLoop(device, cuda_graphs, (generator,))
    if loop.enabled:
        graphs.reserve_decode(device, llm_cfg, B, Pn + n)
    out = []
    for i in range(len(batches)):
        if i > 0:
            # the chunk-filled cache takes the current one's place; the other is emptied
            cache_next, _, _, _, next_last = nxt
            for key in dc.PAYLOAD_KEYS + ("kv_mask",):
                if key in cache:
                    cache[key].copy_(cache_next[key])
            cache_next["kv_mask"].zero_()
            logits.copy_(next_last)
        has_next = i + 1 < len(batches)
        if has_next:
            embeds, mask = padded(i + 1)
            nxt[1].copy_(policy.cast(embeds))
            nxt[2].copy_(mask)
            nxt[3].zero_()
        sampler.reset(None if prompt_ids is None else torch.as_tensor(prompt_ids[i]))
        pos.fill_(Pn)
        _decode_overlap(params, llm_cfg, loop, sampler, logits, cache, Pn, pos,
                        nxt if has_next else None, C, n_chunks, policy, kernels)
        out.append((sampler.tokens.clone(), sampler.lengths.clone()))
    return out
