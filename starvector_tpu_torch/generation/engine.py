"""Autoregressive generation: one cached prefill, then a Python loop of
cached decode steps (port of generate / generate_im2svg /
generate_text2svg of starvector_tpu/generation/engine.py).

The first token is drawn from the prefill's last logits. Each row stops on
its own when one of the stop sequences (the `</svg>` ids for im2svg) or eos
ends its output; rows that are done emit pad tokens, and the loop ends when
every row is done.

num_return_sequences = n > 1 prefills each distinct row once, then tiles
the filled cache, the last logits and the prompt's presence table n times
(decode_common.tile_rows): the rows come out grouped [p0 x n, p1 x n, ...],
HF's expand order, and the decode steps run at B x n rows.

Beam search (beam.py), prompt-lookup speculative decoding
(speculative.py) and GRPO rollouts (train/grpo.py) build on these pieces.
The JAX package's generate_pipelined and generate_pipelined_spec raise
NotImplementedError here (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.ops.sampling import NEG_INF, sample_token


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


def stop_hit(tokens: torch.Tensor, t: int, new_tok: torch.Tensor, stops: list[torch.Tensor],
             eos_token_id: int | None, max_new_tokens: int) -> torch.Tensor:
    """(...,) bool: a stop sequence (`stops`, on the device) is a suffix of
    [tokens[..., :t], new_tok], or new_tok is eos; tokens (..., n), new_tok
    (...,). A stop longer than max_new_tokens can never match."""
    hit = torch.zeros_like(new_tok, dtype=torch.bool)
    for s in stops:
        L = len(s)
        if L == 0 or L > max_new_tokens or t < L - 1:
            continue
        match = new_tok == s[-1]
        if L > 1:
            match &= (tokens[..., t - (L - 1):t] == s[:-1]).all(dim=-1)
        hit |= match
    if eos_token_id is not None:
        hit |= new_tok == eos_token_id
    return hit


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B x num_return_sequences, max_new_tokens) int64,
    lengths (B x num_return_sequences,)): rows are pad-filled after their
    stop, lengths include the stop tokens, and a prompt's n return
    sequences are adjacent rows. `kv_cache_dtype` is the cache's type
    (default: the compute dtype); torch.int8 stores it as codes with
    per-(position, head) scales, as the JAX generate's
    `kv_cache_dtype=jnp.int8`."""
    if gen.top_k > gen.max_top_k:
        raise ValueError(f"top_k={gen.top_k} exceeds max_top_k={gen.max_top_k}")
    dec = decoder_module(llm_cfg)
    B, P, _ = inputs_embeds.shape
    V = llm_cfg.vocab_size
    device = inputs_embeds.device
    n = gen.max_new_tokens
    n_rep = gen.num_return_sequences

    use_rep = gen.repetition_penalty != 1.0
    use_freq = gen.frequency_penalty != 0.0 or gen.presence_penalty != 0.0
    presence = torch.zeros((B, V), dtype=torch.int32, device=device) if use_rep else None
    if use_rep and prompt_ids is not None:
        presence.scatter_(1, prompt_ids.long().to(device), 1)

    cache = dec.init_cache(llm_cfg, B, P + n, dtype=kv_cache_dtype or policy.compute_dtype,
                           device=device)
    logits, cache = dec.forward(params, llm_cfg, inputs_embeds, attention_mask=attention_mask,
                                cache=cache, policy=policy, last_logits_only=True,
                                kernels=kernels)
    last_logits = logits[:, -1]
    if n_rep > 1:
        # one prefill per distinct row; its cache serves the row's n samples
        last_logits = last_logits.repeat_interleave(n_rep, dim=0)
        cache = dc.tile_rows(cache, n_rep)
        if use_rep:
            presence = presence.repeat_interleave(n_rep, dim=0)
        B *= n_rep

    counts = torch.zeros((B, V), dtype=torch.int32, device=device) if use_freq else None
    bias_ids = bias_vals = None
    if gen.logit_bias:
        bias_ids = torch.tensor([[t for t, _ in gen.logit_bias]] * B, device=device)
        bias_vals = torch.tensor([[v for _, v in gen.logit_bias]] * B, device=device)

    tokens = torch.full((B, n), gen.pad_token_id, dtype=torch.int64, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    lengths = torch.full((B,), n, dtype=torch.int64, device=device)
    ones = torch.ones((B, 1), dtype=torch.int32, device=device)
    stops = [torch.tensor(s, dtype=torch.int64, device=device) for s in gen.stop_sequences]
    for t in range(n):
        lg = last_logits
        if gen.eos_token_id is not None and t < gen.min_new_tokens:
            lg = lg.clone()
            lg[:, gen.eos_token_id] = NEG_INF
        nxt = sample_token(
            lg, do_sample=gen.do_sample, temperature=gen.temperature, top_p=gen.top_p,
            top_k=gen.top_k, min_p=gen.min_p, presence=presence,
            repetition_penalty=gen.repetition_penalty if use_rep else None,
            counts=counts, frequency_penalty=gen.frequency_penalty,
            presence_penalty=gen.presence_penalty, bias_ids=bias_ids, bias_vals=bias_vals,
            max_top_k=gen.max_top_k, generator=generator,
        )
        nxt = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt)
        newly_done = stop_hit(tokens, t, nxt, stops, gen.eos_token_id, n) & ~done
        lengths = torch.where(newly_done, torch.full_like(lengths, t + 1), lengths)
        tokens[:, t] = nxt
        if use_rep:
            presence.scatter_(1, nxt[:, None], 1)
        if use_freq:
            counts.scatter_add_(1, nxt[:, None], (~done).to(torch.int32)[:, None])
        done |= newly_done
        # the last token needs no forward; neither does a batch that is done
        if t == n - 1 or bool(done.all()):
            break
        embeds = dec.embed_tokens(params, nxt[:, None]).to(policy.compute_dtype)
        step_logits, cache = dec.forward(params, llm_cfg, embeds, attention_mask=ones,
                                         cache=cache, policy=policy, kernels=kernels)
        last_logits = step_logits[:, -1]
    return tokens, lengths


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
):
    """Returns (tokens, lengths) of the NEW tokens; callers prepend the
    prompt ids before detokenizing."""
    inputs_embeds, mask = im2svg_prefix(params, cfg, images, prompt_ids, policy=policy)
    return generate(params["svg_transformer"], cfg.llm, inputs_embeds, mask, gen, generator,
                    prompt_ids=prompt_ids, policy=policy, kernels=kernels,
                    kv_cache_dtype=kv_cache_dtype)


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
):
    """text2svg: the caption's token embeddings are the whole prefix (no
    vision tower). The prompt ids, pads included, are `generate`'s
    prompt_ids, as in the JAX function, so a repetition penalty counts the
    same tokens. Returns (tokens, lengths) of the new tokens."""
    embeds = cfg.decoder_module.embed_tokens(params["svg_transformer"], input_ids)
    return generate(params["svg_transformer"], cfg.llm, policy.cast(embeds), attention_mask,
                    gen, generator, prompt_ids=input_ids, policy=policy, kernels=kernels,
                    kv_cache_dtype=kv_cache_dtype)


def generate_pipelined(*args, **kwargs):
    """The JAX package's generate_pipelined (the next batch's prefill
    riding the current batch's decode steps): not ported."""
    raise NotImplementedError("generate_pipelined is not ported yet (ROADMAP queue 1, item 7)")


def generate_pipelined_spec(*args, **kwargs):
    """The JAX package's generate_pipelined_spec (generate_pipelined with
    speculative verify rounds): not ported."""
    raise NotImplementedError(
        "generate_pipelined_spec is not ported yet (ROADMAP queue 1, item 7)")
