"""KV-cache scaffolding for cached decoding (port of the cache half of
starvector_tpu/models/decode_common.py).

The cache is preallocated, (L, B, T_max, Hkv, D) for k and v, with one shared
write index and a (B, T_max) key mask (left-padded prefixes are masked
out). Where the JAX package returns updated copies (`dynamic_update_slice`),
these functions write the cache IN PLACE: a cache tensor is only ever
written at slots the next call has not read yet, and an in-place write
saves a full copy of the cache per step.

The merged decode attention lives with kernel 2 in
ops/flash_attention.py. int8 caches, ragged (per-row length) caches and
the chunk-verify attention are not ported yet.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops.layers import layer_slice


def init_cache(n_layer: int, kv_heads: int, head_dim: int, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Linear cache with one shared write index (a Python int)."""
    shape = (n_layer, batch, max_len, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
        "kv_mask": torch.zeros((batch, max_len), dtype=torch.int32, device=device),
    }


def write_prefill_kv(layer_cache: dict, k: torch.Tensor, v: torch.Tensor, cache_index: int):
    """Write one prefill chunk's (B, S, Hkv, D) keys and values into a layer's
    cache at `cache_index`, in place. Returns the (B, T, Hkv, D) windows over
    the whole cache (bf16 and fp32 caches only)."""
    S = k.shape[1]
    layer_cache["k"][:, cache_index:cache_index + S] = k.to(layer_cache["k"].dtype)
    layer_cache["v"][:, cache_index:cache_index + S] = v.to(layer_cache["v"].dtype)
    return layer_cache["k"], layer_cache["v"]


def decode_scan(layers: dict, cache: dict, x: torch.Tensor, layer_fn):
    """Run `layer_fn(layer_params, h, k_cached, v_cached) -> (h, k_new, v_new)`
    over the stacked layers. Layers emit only their new token's k/v; the
    caller writes the (L, B, Hkv, D) stacks back once (write_new_kv_linear).
    Returns (h, {"k": ..., "v": ...})."""
    n_layer = cache["k"].shape[0]
    ks, vs = [], []
    for i in range(n_layer):
        x, kn, vn = layer_fn(layer_slice(layers, i), x, cache["k"][i], cache["v"][i])
        ks.append(kn)
        vs.append(vn)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def write_new_kv_linear(cache: dict, news: dict, idx: int) -> None:
    """Write each key's (L, B, Hkv[, D]) new-token stack at slot `idx`, in place."""
    for key, new in news.items():
        cache[key][:, :, idx] = new.to(cache[key].dtype)
