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

The merged decode attention lives with kernel 2 in
ops/flash_attention.py. Ragged (per-row length) caches and the chunk-verify
attention are not ported yet.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops.layers import layer_slice

PAYLOAD_KEYS = ("k", "v", "k_scale", "v_scale")


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


def decode_scan(layers: dict, cache: dict, x: torch.Tensor, layer_fn):
    """Run `layer_fn(layer_params, h, k_cached, v_cached[, k_scale, v_scale])
    -> (h, k_new, v_new)` over the stacked layers. Layers emit only their new
    token's k/v; the caller writes the (L, B, Hkv, D) stacks back once
    (write_new_kv_linear). An int8 cache also hands each layer its scale
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
