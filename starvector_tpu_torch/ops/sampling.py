"""Token sampling: greedy, temperature, top-k, top-p, min-p, repetition,
frequency and presence penalties, logit bias (port of
starvector_tpu/ops/sampling.py).

The logit transforms are pure functions of the logits and match the JAX
package's. The categorical draw takes an explicit `torch.Generator`, so its
random numbers differ from `jax.random`'s. Every op takes its knobs as
numbers or as tensors on the logits' device and reads nothing back, so a
decode step that samples can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

NEG_INF = -1e10


def _rowwise(knob, logits: torch.Tensor) -> torch.Tensor:
    """Broadcast a knob against (B, V) logits: scalars pass through, per-row
    (B,) knobs gain a trailing axis."""
    knob = torch.as_tensor(knob, device=logits.device)
    if knob.ndim == logits.ndim - 1 and knob.ndim > 0:
        return knob[..., None]
    return knob


def _masked(keep: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_temperature(logits: torch.Tensor, temperature) -> torch.Tensor:
    t = torch.clamp(_rowwise(temperature, logits).to(logits.dtype), min=1e-6)
    return logits / t


def apply_top_k(logits: torch.Tensor, k, max_k: int) -> torch.Tensor:
    """Keep the top-k logits per row (k <= 0 disables; bounded by max_k)."""
    max_k = min(max_k, logits.shape[-1])
    k = _rowwise(k, logits)
    vals = torch.topk(logits, max_k, dim=-1).values
    idx = torch.clamp(k - 1, 0, max_k - 1).long().expand(*vals.shape[:-1], 1)
    threshold = torch.gather(vals, -1, idx)
    keep = (logits >= threshold) | (k <= 0)
    return _masked(keep, logits)


def apply_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability exceeds p, always keeping the most probable token."""
    p = _rowwise(p, logits)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    keep_sorted[..., 0] = True
    kept = torch.where(keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf")))
    threshold = kept.amin(dim=-1, keepdim=True)
    keep = (logits >= threshold) | (p >= 1.0)
    return _masked(keep, logits)


def apply_min_p(logits: torch.Tensor, min_p) -> torch.Tensor:
    """Keep tokens whose probability is at least min_p times the largest
    (min_p <= 0 disables)."""
    min_p = _rowwise(min_p, logits)
    probs = torch.softmax(logits, dim=-1)
    threshold = min_p * probs.amax(dim=-1, keepdim=True)
    keep = (probs >= threshold) | (min_p <= 0.0)
    return _masked(keep, logits)


def apply_frequency_presence(logits, counts, frequency_penalty, presence_penalty):
    """logits - frequency_penalty * count - presence_penalty * (count > 0)."""
    fp = _rowwise(frequency_penalty, logits)
    pp = _rowwise(presence_penalty, logits)
    counts = counts.to(logits.dtype)
    return logits - fp * counts - pp * (counts > 0)


def apply_logit_bias(logits, bias_ids, bias_vals):
    """Sparse additive bias: (B, K) ids (negative = inactive) and values."""
    active = bias_ids >= 0
    ids = torch.where(active, bias_ids, torch.zeros_like(bias_ids)).long()
    vals = torch.where(active, bias_vals.to(logits.dtype), torch.zeros_like(bias_vals, dtype=logits.dtype))
    return logits.scatter_add(-1, ids, vals)


def apply_repetition_penalty(logits, presence, penalty):
    """Seen tokens: positive logits / penalty, negative logits * penalty."""
    penalty = _rowwise(penalty, logits).to(logits.dtype)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    out = torch.where(presence > 0, penalized, logits)
    return torch.where(penalty == 1.0, logits, out)


def categorical(probs: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """One draw a row (B,) from probs (B, V): the argmax of probs over
    Exp(1) noise, which is torch.multinomial's own algorithm for one sample
    (the same draws from the same generator state), without multinomial's
    check of the probabilities, a host read that a CUDA graph cannot
    capture."""
    noise = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / noise, dim=-1)


def pruned_slab(logits: torch.Tensor, *, temperature, top_p, top_k, min_p=None,
                max_top_k: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX sample_token(pruned=True)'s filter chain: the top-max_top_k
    logits of each row (sorted descending) through temperature, top-k,
    top-p and min-p. Returns (the filtered slab (B, K), its token ids (B, K)).
    Exact wherever the nucleus fits the slab; a request's top_k <= max_top_k
    already does."""
    K = min(max_top_k, logits.shape[-1])
    slab, slab_ids = torch.topk(logits, K, dim=-1)
    filtered = apply_temperature(slab, temperature)
    filtered = apply_top_k(filtered, top_k, K)
    filtered = apply_top_p(filtered, top_p)
    if min_p is not None:
        filtered = apply_min_p(filtered, min_p)
    return filtered, slab_ids


def sample_token(
    logits: torch.Tensor,  # (B, V) fp32
    *,
    do_sample: bool,
    temperature=1.0,
    top_p=1.0,
    top_k=0,
    presence: torch.Tensor | None = None,
    repetition_penalty=None,
    counts: torch.Tensor | None = None,
    frequency_penalty=None,
    presence_penalty=None,
    min_p=None,
    bias_ids: torch.Tensor | None = None,
    bias_vals: torch.Tensor | None = None,
    max_top_k: int = 64,
    generator: torch.Generator | None = None,
    pruned: bool = False,
) -> torch.Tensor:
    """(B,) int64 next tokens. Greedy when do_sample is False or temperature
    <= 0. Processor order: bias, penalties, temperature, top-k, top-p, min-p.
    `pruned` runs the chain after the penalties on the top-max_top_k slab
    (pruned_slab) in place of the whole vocabulary, as the serving engine's
    ticks do: one torch.topk in place of the (B, V) sort of top-p."""
    if bias_ids is not None and bias_vals is not None:
        logits = apply_logit_bias(logits, bias_ids, bias_vals)
    if presence is not None and repetition_penalty is not None:
        logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    if counts is not None:
        logits = apply_frequency_presence(
            logits, counts,
            frequency_penalty if frequency_penalty is not None else 0.0,
            presence_penalty if presence_penalty is not None else 0.0,
        )
    greedy = torch.argmax(logits, dim=-1)
    if not do_sample:
        return greedy
    t = torch.as_tensor(temperature, device=logits.device).reshape(-1)
    if pruned:
        filtered, slab_ids = pruned_slab(logits, temperature=temperature, top_p=top_p,
                                         top_k=top_k, min_p=min_p, max_top_k=max_top_k)
        pick = categorical(torch.softmax(filtered.float(), dim=-1), generator)
        return torch.where(t <= 0.0, greedy, slab_ids.gather(1, pick[:, None])[:, 0])
    filtered = apply_temperature(logits, temperature)
    filtered = apply_top_k(filtered, top_k, max_top_k)
    filtered = apply_top_p(filtered, top_p)
    if min_p is not None:
        filtered = apply_min_p(filtered, min_p)
    probs = torch.softmax(filtered.float(), dim=-1)
    sampled = categorical(probs, generator)
    return torch.where(t <= 0.0, greedy, sampled)
