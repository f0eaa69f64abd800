"""KV-cache scaffolding for cached decoding (port of the cache half of
starvector_tpu/models/decode_common.py).

The cache is preallocated, (L, B, T_max, Hkv, D) for k and v, with one shared
write index and a (B, T_max) key mask (left-padded prefixes are masked
out). Where the JAX package returns updated copies (`dynamic_update_slice`),
these functions write the cache IN PLACE: a cache tensor is only ever
written at slots the next call has not read yet, and an in-place write
saves a full copy of the cache per step.

An int8 cache (`init_cache(dtype=torch.int8)`) holds int8 codes with fp32
`k_scale` / `v_scale` (L, B, T_max, Hkv), one per (position, KV head):
`quantize_kv` writes them, the prefill attends over the dequantized window,
and kernel 2's int8 instantiation folds the scales into its scores and
probabilities in decode.

A ragged cache (`init_ragged_cache`) has per-row `lengths`, a (B,) int32
tensor, in place of the shared index: each row's keys occupy [0, length)
and a row advances on its own. Batched speculative decoding writes a
W-token chunk per row at its own length (`write_new_kv_ragged_multi`) and
then commits only the accepted tokens (`commit_verify`); rejected slots
stay masked and are overwritten by the next chunk.

The merged decode attention lives with kernel 2 in
ops/flash_attention.py; the chunk step's attention (1 < S <= 64 new tokens,
`merged_verify_attention`) is here, in plain PyTorch, as the JAX package
computes it in XLA. The serving engine's ragged steps and admission
(`ragged_step_masks`, `write_new_kv_ragged`, `insert_prefill_rows`) are not
ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops.attention import NEG_INF
from starvector_tpu_torch.ops.layers import einsum_f32, layer_slice

PAYLOAD_KEYS = ("k", "v", "k_scale", "v_scale")
# a cached call of 2 up to this many new tokens takes the decoders' chunk
# step (the JAX decoders' `fast_path and S <= 64`; StarCoder2 also needs
# S <= window)
CHUNK_STEP_MAX = 64


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 over the last (D) axis:
    scale = max(max |x| / 127, 1e-8), q = round(x / scale), no clip (the JAX
    function's). Returns (int8 codes, fp32 scales (...,))."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) * (1.0 / 127.0)).clamp_min(1e-8)  # XLA's "/ 127"
    return torch.round(x32 / scale[..., None]).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def init_cache(n_layer: int, kv_heads: int, head_dim: int, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Linear cache with one shared write index (a Python int).
    dtype=torch.int8 stores K/V as codes with per-(layer, row, position,
    head) fp32 scales."""
    shape = (n_layer, batch, max_len, kv_heads, head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
        "kv_mask": torch.zeros((batch, max_len), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def init_ragged_cache(n_layer: int, kv_heads: int, head_dim: int, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cpu") -> dict:
    """Cache with per-row lengths (a (B,) int32 tensor) in place of the
    linear cache's shared index."""
    cache = init_cache(n_layer, kv_heads, head_dim, batch, max_len, dtype, device)
    del cache["index"]
    cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def tile_rows(cache: dict, n: int) -> dict:
    """A new cache whose rows are each of `cache`'s repeated n times in
    place, [r0 x n, r1 x n, ...] (num_return_sequences after one prefill):
    the payloads on their batch dim 1, kv_mask on dim 0; the index and
    anything else shared."""
    return {key: (arr.repeat_interleave(n, dim=1) if key in PAYLOAD_KEYS
                  else arr.repeat_interleave(n, dim=0) if key == "kv_mask" else arr)
            for key, arr in cache.items()}


def reorder_rows(cache: dict, rows: torch.Tensor) -> None:
    """Gather the cache's rows by `rows` (B,) (beam search's reorder by
    parent): each payload and kv_mask is replaced by a new tensor gathered
    from the old one, so no row is overwritten while the gather still
    reads it; later writes go into the new tensors in place."""
    for key in PAYLOAD_KEYS + ("kv_mask",):
        if key in cache:
            cache[key] = cache[key].index_select(0 if key == "kv_mask" else 1, rows)


def layer_cache(cache: dict, i: int) -> dict:
    """Layer i's cache arrays (views): k, v and, for an int8 cache, the scales."""
    return {key: cache[key][i] for key in PAYLOAD_KEYS if key in cache}


def write_prefill_kv(layer_cache: dict, k: torch.Tensor, v: torch.Tensor, cache_index: int,
                     dtype):
    """Write one prefill chunk's (B, S, Hkv, D) keys and values into a
    layer's cache at `cache_index`, in place, and return the (B, T, Hkv, D)
    windows to attend over, in `dtype`. A bf16/fp32 cache returns its whole
    preallocated window. An int8 cache quantizes on write and returns the
    dequantized slots [0, cache_index + S), the chunk's own tokens included
    (the JAX function dequantizes the whole cache; the slots after these are
    never visible to the chunk)."""
    S = k.shape[1]
    end = cache_index + S
    if layer_cache["k"].dtype == torch.int8:
        for name, x in (("k", k), ("v", v)):
            q, sc = quantize_kv(x)
            layer_cache[name][:, cache_index:end] = q
            layer_cache[f"{name}_scale"][:, cache_index:end] = sc
        return (dequantize_kv(layer_cache["k"][:, :end], layer_cache["k_scale"][:, :end], dtype),
                dequantize_kv(layer_cache["v"][:, :end], layer_cache["v_scale"][:, :end], dtype))
    layer_cache["k"][:, cache_index:end] = k.to(layer_cache["k"].dtype)
    layer_cache["v"][:, cache_index:end] = v.to(layer_cache["v"].dtype)
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)


def merged_verify_attention(
    qg: torch.Tensor,        # (B, Hkv, G, W, D) the chunk's queries, grouped
    k_new: torch.Tensor,     # (B, W, Hkv, D) the chunk's keys
    v_new: torch.Tensor,     # (B, W, Hkv, D)
    k_cached: torch.Tensor,  # (B, T, Hkv, D) the cache before the chunk
    v_cached: torch.Tensor,  # (B, T, Hkv, D)
    old_mask: torch.Tensor,  # (B, T), or per query (B, W, T): visible cached slots
    scale: float,
    k_scale: torch.Tensor | None = None,  # (B, T, Hkv) int8-cache scales
    v_scale: torch.Tensor | None = None,  # (B, T, Hkv)
    new_mask: torch.Tensor | None = None,  # (B, W) 1 = the chunk token is real
) -> torch.Tensor:
    """The JAX decoders' chunk attention (decode_common.merged_verify_attention):
    each of the W chunk queries attends to the visible cached slots and,
    causally, to the chunk's own keys (query w sees chunk keys u <= w that
    `new_mask` keeps) in one softmax, without the chunk in the cache. fp32
    scores (times k_scale for an int8 cache); the cached P (times v_scale)
    rounded to the compute dtype before P.V, the chunk's own P and V in
    fp32; the division last. T may be 0 (a chunk at index 0). Returns
    (B, W, H*D) in qg's dtype."""
    B, Hkv, G, W, D = qg.shape
    dt = qg.dtype
    s_n = einsum_f32("bkgwd,bukd->bkgwu", qg, k_new.to(dt)) * scale  # (B, Hkv, G, W, W)
    allowed = torch.ones((W, W), dtype=torch.bool, device=qg.device).tril()[None, None, None]
    if new_mask is not None:
        allowed = allowed & (new_mask > 0)[:, None, None, None, :]
    s_n = torch.where(allowed, s_n, torch.full_like(s_n, NEG_INF))
    m = s_n.amax(dim=-1)
    cached = k_cached.shape[1] > 0
    if cached:
        s_c = einsum_f32("bkgwd,btkd->bkgwt", qg, k_cached.to(dt)) * scale  # (B, Hkv, G, W, T)
        if k_scale is not None:
            s_c = s_c * k_scale.permute(0, 2, 1)[:, :, None, None, :]
        om = (old_mask[:, None, None, None, :] if old_mask.ndim == 2
              else old_mask[:, None, None, :, :])
        s_c = torch.where(om > 0, s_c, torch.full_like(s_c, NEG_INF))
        m = torch.maximum(s_c.amax(dim=-1), m)
    p_n = torch.exp(s_n - m[..., None])
    out = einsum_f32("bkgwu,bukd->bkgwd", p_n, v_new)
    denom = p_n.sum(dim=-1)
    if cached:
        p_c = torch.exp(s_c - m[..., None])
        denom = p_c.sum(dim=-1) + denom
        if v_scale is not None:
            p_c = p_c * v_scale.permute(0, 2, 1)[:, :, None, None, :]
        out = einsum_f32("bkgwt,btkd->bkgwd", p_c.to(dt), v_cached.to(dt)) + out
    out = (out / denom[..., None]).to(dt)
    # (B, Hkv, G, W, D) -> (B, W, H*D), head-major as the decode path
    return out.movedim(3, 1).reshape(B, W, Hkv * G * D)


def decode_scan(layers: dict, cache: dict, x: torch.Tensor, layer_fn):
    """Run `layer_fn(layer_params, h, k_cached, v_cached[, k_scale, v_scale])
    -> (h, k_new, v_new)` over the stacked layers. Layers emit only their new
    tokens' k/v, (B, Hkv, D) for a decode step or (B, W, Hkv, D) for a
    chunk; the caller writes the stacks back once (write_new_kv_linear,
    write_new_kv_linear_multi). An int8 cache also hands each layer its scale
    slices, and the emitted tokens are quantized after the layers (per
    token and head, so one call over the stack equals one per layer).
    Returns (h, news): {"k", "v"} or, int8, {"k", "v", "k_scale", "v_scale"}."""
    n_layer = cache["k"].shape[0]
    quant = "k_scale" in cache
    ks, vs = [], []
    for i in range(n_layer):
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if quant else ()
        x, kn, vn = layer_fn(layer_slice(layers, i), x, cache["k"][i], cache["v"][i], *scales)
        ks.append(kn)
        vs.append(vn)
    k, v = torch.stack(ks), torch.stack(vs)
    if not quant:
        return x, {"k": k, "v": v}
    (kq, ksc), (vq, vsc) = quantize_kv(k), quantize_kv(v)
    return x, {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}


def write_new_kv_linear(cache: dict, news: dict, idx: int) -> None:
    """Write each key's (L, B, Hkv[, D]) new-token stack at slot `idx`, in
    place (codes and scales alike for an int8 cache)."""
    for key, new in news.items():
        cache[key][:, :, idx] = new.to(cache[key].dtype)


def write_new_kv_linear_multi(cache: dict, news: dict, idx: int) -> None:
    """Write each key's (L, B, W, Hkv[, D]) chunk stack at slots
    [idx, idx + W), in place."""
    for key, new in news.items():
        cache[key][:, :, idx:idx + new.shape[2]] = new.to(cache[key].dtype)


def write_new_kv_ragged_multi(cache: dict, news: dict, write_pos: torch.Tensor) -> None:
    """Ragged cache: write each key's (L, B, W, Hkv[, D]) chunk stack at
    each row's own slots `write_pos` (B, W), in place."""
    rows = torch.arange(write_pos.shape[0], device=write_pos.device)[:, None]
    for key, new in news.items():
        cache[key][:, rows, write_pos] = new.to(cache[key].dtype)


def commit_verify(cache: dict, n_commit: torch.Tensor) -> None:
    """After a speculative verify: advance each row's length by its
    accepted count (B,) and show exactly those slots, in place. Rejected
    chunk slots stay masked and are overwritten by the next write."""
    T = cache["kv_mask"].shape[1]
    lengths = cache["lengths"]
    new_len = torch.clamp(lengths + n_commit.to(torch.int32), max=T)
    slot = torch.arange(T, device=lengths.device)[None, :]
    cache["kv_mask"][(slot >= lengths[:, None]) & (slot < new_len[:, None])] = 1
    cache["lengths"] = new_len
