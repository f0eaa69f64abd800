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

The serving engine (serve/engine.py) admits a prefilled linear cache into
rows of its ragged cache (`insert_prefill_rows`: the whole row, its slots
past the prefix zeroed and masked), and each ragged decode step writes
every row's new token at that row's own length (`ragged_step_masks`,
`write_new_kv_ragged`), then shows it in the key mask and advances the
row's length, both in place (`ragged_step_commit`), as every commit of a
ragged cache does: a CUDA graph of the engine's tick holds those tensors.
A row that is not active is written at its length
too, but neither its mask nor its length moves: the slot stays invisible,
and the admission that later takes the row overwrites all of it. The
engine inserts under its lock, between two ticks, on the stream the ticks
run on, so no tick reads a row while it is replaced.

A static decode step (`static_decode_slots`, `write_new_kv_static`; the
decoders' forward_decode_static) is the linear cache's decode step with
nothing on the host: the write slot is a device int32 `pos` (1,), the key
mask stays whole at max_len, and kernel 2 takes the visible slots as device
`bounds` [t_begin, pos]. Every launch of the step is then the same from one
token to the next, and generate captures such a step in a CUDA graph
(generation/graphs.py), the counterpart of the JAX package's jitted
while_loop. The serving engine's static tick does the same over the ragged
cache (`ragged_static_masks`: kernel 2's bounds from the rows' lengths).

A static chunk step (`static_chunk_slots`, `write_new_kv_slots`; the
decoders' forward_chunk_static) is the chunk step with its write index a
device int32 `idx` (1,): the chunk's mask and k/v are written at idx +
[0, C) by index ops, and its queries attend over a key span [0, t_cap)
fixed per graph (generation/engine.py::chunk_cap), the slots below idx
visible by a device mask. The pipelined streams and speculative decoding
run their rounds from such steps (generation/engine.py,
generation/speculative.py); `rollback_verify` is the B = 1 verify's
rollback of the linear cache on the device.

The merged decode attention lives with kernel 2 in
ops/flash_attention.py; the chunk step's attention (1 < S <= 64 new tokens,
`merged_verify_attention`) is here, in plain PyTorch, as the JAX package
computes it in XLA.
"""

from __future__ import annotations

import torch

from starvector_tpu_torch.ops.attention import NEG_INF
from starvector_tpu_torch.ops.layers import einsum_f32
from starvector_tpu_torch.parallel import zero

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


def _payload_keys(cache: dict) -> tuple[str, ...]:
    """The per-(layer, row, position) arrays of a cache: k, v and, for an
    int8 cache, the scales."""
    return tuple(key for key in PAYLOAD_KEYS if key in cache)


def _fit_time_axis(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor, *,
                   time_axis: int) -> None:
    """Write src's rows into dst's `rows` (the batch axis, just before
    `time_axis`), in place, src's time axis right-padded with zeros or
    cropped to dst's (the JAX function pads a copy to the ragged cache's
    max_len; here the slots past the copied ones are zeroed in place)."""
    T, Ts = dst.shape[time_axis], src.shape[time_axis]
    n = min(T, Ts)
    lead = (slice(None),) * (time_axis - 1)
    dst[lead + (rows, slice(0, n))] = src[lead + (slice(None), slice(0, n))].to(dst.dtype)
    if T > n:
        dst[lead + (rows, slice(n, T))] = 0


def insert_prefill_rows(ragged_cache: dict, small_cache: dict, slots: torch.Tensor,
                        lengths: torch.Tensor) -> None:
    """Admit a prefilled B=k linear cache into rows `slots` (k,) of a ragged
    cache, in place: every payload array (int8 codes and scales alike) and
    the key mask, each row whole, and the rows' `lengths` (k,). Raises
    ValueError when the two caches' types differ: casting int8 codes as
    values, or dropping scales, would corrupt the admitted rows."""
    if small_cache["k"].dtype != ragged_cache["k"].dtype:
        raise ValueError(
            f"prefill cache dtype {small_cache['k'].dtype} != ragged cache dtype "
            f"{ragged_cache['k'].dtype}: casting int8 codes as values (or dropping scales) "
            f"would silently corrupt the admitted rows")
    device = ragged_cache["k"].device
    slots = torch.as_tensor(slots, device=device).long()
    for key in _payload_keys(ragged_cache):
        _fit_time_axis(ragged_cache[key], slots, small_cache[key], time_axis=2)
    _fit_time_axis(ragged_cache["kv_mask"], slots, small_cache["kv_mask"], time_axis=1)
    ragged_cache["lengths"][slots] = torch.as_tensor(lengths, device=device).to(torch.int32)


def insert_prefill(ragged_cache: dict, small_cache: dict, slot: int, length: int) -> None:
    """Admit a prefilled B=1 linear cache into row `slot` of a ragged cache
    (the single-row case of insert_prefill_rows)."""
    insert_prefill_rows(ragged_cache, small_cache, torch.tensor([slot]), torch.tensor([length]))


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
    -> (h, k_new, v_new)` over the stacked layers, each gathered whole just
    before its call on a serving layout (parallel/zero.py::layer_at: from
    the stage that holds it, then over fsdp). Layers emit only their new
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
        x, kn, vn = layer_fn(zero.layer_at(layers, i), x, cache["k"][i], cache["v"][i], *scales)
        ks.append(kn)
        vs.append(vn)
    return x, emitted_kv(ks, vs, quant)


def emitted_kv(ks: list, vs: list, quant: bool) -> dict:
    """The layers' emitted k/v (one tensor a layer) stacked on a leading
    layer axis for the write after the layers: {"k", "v"} or, for an int8
    cache (`quant`), codes with their scales (quantize_kv, per token and
    head)."""
    k, v = torch.stack(ks), torch.stack(vs)
    if not quant:
        return {"k": k, "v": v}
    (kq, ksc), (vq, vsc) = quantize_kv(k), quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}


def write_new_kv_linear(cache: dict, news: dict, idx: int) -> None:
    """Write each key's (L, B, Hkv[, D]) new-token stack at slot `idx`, in
    place (codes and scales alike for an int8 cache)."""
    for key, new in news.items():
        cache[key][:, :, idx] = new.to(cache[key].dtype)


def static_decode_slots(cache: dict, pos: torch.Tensor, window: int | None):
    """A static decode step's slots on a linear cache, the write slot `pos`
    an int32 (1,) device tensor: each row's position (B,) int32, the real
    tokens its cache holds (the key mask's sum, taken before the new slot
    shows), then the new slot shown in the key mask in place, and kernel
    2's bounds (2,) int32 [t_begin, pos]: t_begin is max(pos - window + 1,
    0) under a sliding window (StarCoder2's window_begin), else 0. No host
    transfer."""
    positions = cache["kv_mask"].sum(dim=-1, dtype=torch.int32)
    cache["kv_mask"].index_fill_(1, pos.long(), 1)
    begin = torch.zeros_like(pos) if window is None else torch.clamp(pos - (window - 1), min=0)
    return positions, torch.cat([begin, pos])


def write_new_kv_static(cache: dict, news: dict, pos: torch.Tensor) -> None:
    """write_new_kv_linear at the device slot `pos` (1,): each key's
    (L, B, Hkv[, D]) new-token stack, in place."""
    write_new_kv_slots(cache, {key: new.unsqueeze(2) for key, new in news.items()}, pos.long())


def static_chunk_slots(cache: dict, idx: torch.Tensor, chunk_mask: torch.Tensor, t_cap: int,
                       window: int | None):
    """A static chunk step's slots on a linear cache, the write index `idx`
    an int32 (1,) device tensor, over the key span [0, t_cap) (t_cap >=
    idx): the chunk's positions (B, C), after the real tokens each row's key
    mask counts (pads at 1, as the chunk step derives them); the visible old
    slots, slot < idx where the key mask shows one, (B, t_cap), or under a
    sliding window per query, slot > idx + w - window for query w, (B, C,
    t_cap); and the chunk's slots idx + [0, C) (C,) int64, clipped to the
    cache. The chunk's mask is written at its slots, in place. No host
    transfer."""
    kv_mask = cache["kv_mask"]
    T = kv_mask.shape[1]
    C = chunk_mask.shape[1]
    chunk_mask = chunk_mask.to(torch.int32)
    prev = kv_mask.sum(dim=-1, dtype=torch.int32)
    positions = prev[:, None] + torch.cumsum(chunk_mask, dim=-1, dtype=torch.int32) - 1
    positions = torch.where(chunk_mask == 0, torch.ones_like(positions), positions)
    slot = torch.arange(t_cap, device=kv_mask.device)
    old_mask = kv_mask[:, :t_cap] * (slot < idx)
    cols = torch.arange(C, device=kv_mask.device)
    if window is not None:
        query = idx + cols
        old_mask = old_mask[:, None, :] * (slot[None, :] > (query - window)[:, None])
    slots = torch.clamp(idx.long() + cols, max=T - 1)
    kv_mask.index_copy_(1, slots, chunk_mask)
    return positions, old_mask, slots


def write_new_kv_slots(cache: dict, news: dict, slots: torch.Tensor) -> None:
    """Write each key's (L, B, W, Hkv[, D]) stack at the device slots
    `slots` (W,), in place (a static chunk step's, or a decode step's one
    slot)."""
    for key, new in news.items():
        cache[key].index_copy_(2, slots, new.to(cache[key].dtype))


def write_new_kv_linear_multi(cache: dict, news: dict, idx: int) -> None:
    """Write each key's (L, B, W, Hkv[, D]) chunk stack at slots
    [idx, idx + W), in place."""
    for key, new in news.items():
        cache[key][:, :, idx:idx + new.shape[2]] = new.to(cache[key].dtype)


def write_new_kv_ragged(cache: dict, news: dict, write_pos: torch.Tensor) -> None:
    """Ragged cache: write each key's (L, B, Hkv[, D]) new-token stack at
    each row's own slot `write_pos` (B,), in place."""
    rows = torch.arange(write_pos.shape[0], device=write_pos.device)
    for key, new in news.items():
        cache[key][:, rows, write_pos] = new.to(cache[key].dtype)


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
    cache["kv_mask"].masked_fill_((slot >= lengths[:, None]) & (slot < new_len[:, None]), 1)
    lengths.copy_(new_len)


def rollback_verify(cache: dict, idx: torch.Tensor, n_commit: torch.Tensor, W: int) -> None:
    """After a static verify of W tokens at the device index `idx` (1,) of
    a linear cache (B = 1 speculative decoding): keep the first n_commit
    (1,) of the W slots, hide the rest in the key mask, and advance idx by
    n_commit, all in place (the next chunk overwrites the hidden slots)."""
    slot = torch.arange(cache["kv_mask"].shape[1], device=idx.device)
    end = idx + n_commit.to(idx.dtype)
    cache["kv_mask"].masked_fill_(((slot >= end) & (slot < idx + W))[None, :], 0)
    idx.copy_(end)


def ragged_step_masks(cache: dict, active: torch.Tensor, window: int | None):
    """(write_pos (B,), the key mask after the step (B, T), the old slots'
    visibility (B, T)) for one ragged decode step: each row writes at its
    length (clipped to T - 1), shown there when the row is active; a row at
    position p sees its visible old slots t > p - window (StarCoder2's
    sliding window, per row: kernel 2 takes one t_begin for all rows, so
    the window goes into the mask). The cache is not changed."""
    T = cache["kv_mask"].shape[1]
    lengths = cache["lengths"]
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    write_pos = torch.clamp(lengths, 0, T - 1).long()
    old_mask = cache["kv_mask"]
    kv_mask = old_mask.clone()
    kv_mask[rows, write_pos] = torch.maximum(kv_mask[rows, write_pos], active.to(torch.int32))
    if window is not None:
        slot = torch.arange(T, device=lengths.device)[None, :]
        old_mask = old_mask * (slot > (lengths - window)[:, None])
    return write_pos, kv_mask, old_mask


def ragged_static_masks(cache: dict, active: torch.Tensor, window: int | None):
    """ragged_step_masks for a static step (the serving engine's captured
    tick): (write_pos (B,), the old slots' visibility (B, T), kernel 2's
    bounds (2,) int32), all from the device. The bounds are those the
    engine's host bookkeeping gives an eager step: from the shortest active
    row's window start (0 without a window) to the longest active row's
    length. The cache is not changed; ragged_step_commit shows the new
    slots after the layers."""
    T = cache["kv_mask"].shape[1]
    lengths = cache["lengths"]
    write_pos = torch.clamp(lengths, 0, T - 1).long()
    old_mask = cache["kv_mask"]
    act = active > 0
    t_hi = torch.where(act, lengths, 0).amax()
    if window is None:
        t_lo = torch.zeros_like(t_hi)
    else:
        slot = torch.arange(T, device=lengths.device)[None, :]
        old_mask = old_mask * (slot > (lengths - window)[:, None])
        shortest = torch.where(act, lengths, torch.iinfo(torch.int32).max).amin()
        t_lo = torch.clamp(shortest - (window - 1), min=0)
    return write_pos, old_mask, torch.stack([t_lo, t_hi]).to(torch.int32)


def ragged_step_commit(cache: dict, active: torch.Tensor, write_pos: torch.Tensor) -> None:
    """After a ragged decode step's layers: each active row's new slot shown
    in the key mask and its length advanced, in place (an inactive row's
    slot stays hidden and its length put)."""
    rows = torch.arange(write_pos.shape[0], device=write_pos.device)
    kv_mask = cache["kv_mask"]
    kv_mask[rows, write_pos] = torch.maximum(kv_mask[rows, write_pos], active.to(torch.int32))
    cache["lengths"].add_(active.to(torch.int32))


def ragged_key_bounds(cache: dict, key_bounds, window: int | None = None) -> tuple[int, int]:
    """(t_lo, t_hi): the slots any row of a ragged cache may see. From
    key_bounds where given (the caller's host bookkeeping: t_lo at most the
    shortest row's window start, t_hi at least the longest row's length;
    looser bounds only read masked slots), else from `lengths` (a host
    transfer). t_lo is 0 without a window."""
    T = cache["k"].shape[2]
    if key_bounds is None:
        lengths = cache["lengths"]
        t_hi = int(lengths.max())
        t_lo = 0 if window is None else max(int(lengths.min()) - window + 1, 0)
    else:
        t_lo, t_hi = (int(b) for b in key_bounds)
    t_hi = max(0, min(t_hi, T))
    return max(0, min(t_lo, t_hi)), t_hi
