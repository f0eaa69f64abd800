"""StarCoder2 decoder, the StarVector-8B's: cached inference and the
uncached training forward (port of starvector_tpu/models/starcoder2.py).

Same architecture and parameter layout as the JAX package: separate
q/k/v/o projections with bias; grouped-query attention (the 7B: 36 query
heads over 4 KV heads, head size 128); rotary positions (rotate-half, theta
1e6); pre-LN blocks input_layernorm -> attn -> +res,
post_attention_layernorm -> mlp (c_fc -> gelu_tanh -> c_proj) -> +res;
final `norm`; a head tied to `embed_tokens` unless the tree holds an
`lm_head`; a sliding window (4096 for the 7B): a query at position q sees
keys in [q - window + 1, q]. Layers are stacked on a leading axis.

A cached call writes its new tokens at cache["index"]. Positions continue
from the number of real tokens each row has seen (the sum of the cache's
key mask), clipped to max_position_embeddings - 1.
  * S > 64 new tokens, or more than the window (the im2svg prefill: 576
    visual tokens and the prompt): each layer's attention is kernel 1
    (flash_prefill) over the cache window from query offset index, with the
    sliding window (an int8 cache: codes and scales written first, the
    window dequantized).
  * S == 1 (a decode step): kernel 2 (decode_attention, or its int8
    instantiation with the cache's scales) merges the new token's
    self-score into the softmax over the cache slots
    [max(index - window + 1, 0), index), the set the JAX decoder's
    `old_mask` keeps; the kernel reads no slot outside it. The new k/v are
    written once after all layers.
  * 1 < S <= 64 and S <= window (a text2svg prompt): the JAX chunk step,
    decode_common.merged_verify_attention in plain PyTorch, with the JAX
    decoder's per-query window over the cached slots (query w, at slot
    index + w, sees slot t > index + w - window); the chunk's k/v are
    written once after all layers.
Without a cache, `forward` is the training forward: positions from the key
mask, each layer's attention `flash_prefill_trainable` (the forward-with-lse
kernel and the backward pair behind one autograd Function) with the sliding
window, activation checkpointing per `remat` (see `_train_block`). The loss
is gpt_bigcode.causal_lm_loss_fused over `lm_head_table`.

`forward_ragged_verify` is batched speculative decoding's verify over a
ragged cache (per-row lengths): RoPE at each row's own positions and a
per-query window over the cached slots. The serving engine's ragged
decode step is not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.ops.flash_attention import (
    flash_prefill, flash_prefill_trainable, merged_decode_attention,
)
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, gelu_tanh, layer_norm, layer_slice, layer_unbind, make_dense_params,
    make_layer_norm_params, matmul_f32, normal_, remat_layer,
)
from starvector_tpu_torch.ops.rotary import rope_frequencies, rope_tables, rotate


@dataclasses.dataclass(frozen=True)
class StarCoder2Config:
    vocab_size: int = 49152
    hidden_size: int = 4608
    intermediate_size: int = 18432
    num_hidden_layers: int = 32
    num_attention_heads: int = 36
    num_key_value_heads: int = 4
    max_position_embeddings: int = 16384
    norm_epsilon: float = 1e-5
    rope_theta: float = 1e6
    sliding_window: int | None = 4096
    use_bias: bool = True
    tie_word_embeddings: bool = True
    initializer_range: float = 0.018042
    # no attn_impl: the port's attention is always its flash kernels (each
    # with its plain version on the CPU)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads

    @property
    def n_layer(self) -> int:
        return self.num_hidden_layers


def starcoder2_7b_config(**kw) -> StarCoder2Config:
    """bigcode/starcoder2-7b geometry (the 8B model's decoder)."""
    return StarCoder2Config(**kw)


def tiny_config(**kw) -> StarCoder2Config:
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, sliding_window=None)
    base.update(kw)
    return StarCoder2Config(**base)


def init_params(cfg: StarCoder2Config, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    """Random weights with the JAX package's distributions (normal with
    std initializer_range, zero biases), drawn from `gen`."""
    E, L = cfg.hidden_size, cfg.num_hidden_layers
    D, H, Hkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    std = cfg.initializer_range
    kw = dict(std=std, lead=(L,), device=device, dtype=dtype)

    def proj(d_in, d_out):
        p = make_dense_params(gen, d_in, d_out, **kw)
        return p if cfg.use_bias else {"kernel": p["kernel"]}

    params = {
        "embed_tokens": normal_((cfg.vocab_size, E), std, gen, device, dtype),
        "layers": {
            "input_layernorm": make_layer_norm_params(E, lead=(L,), device=device, dtype=dtype),
            "attn": {"q_proj": proj(E, H * D), "k_proj": proj(E, Hkv * D),
                     "v_proj": proj(E, Hkv * D), "o_proj": proj(H * D, E)},
            "post_attention_layernorm": make_layer_norm_params(E, lead=(L,), device=device,
                                                               dtype=dtype),
            "mlp": {"c_fc": proj(E, cfg.intermediate_size),
                    "c_proj": proj(cfg.intermediate_size, E)},
        },
        "norm": make_layer_norm_params(E, device=device, dtype=dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal_((cfg.vocab_size, E), std, gen, device, dtype)
    return params


def init_cache(cfg: StarCoder2Config, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    return dc.init_cache(cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim, batch, max_len,
                         dtype, device)


def init_ragged_cache(cfg: StarCoder2Config, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cpu") -> dict:
    """Cache with per-row lengths (decode_common.init_ragged_cache)."""
    return dc.init_ragged_cache(cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim, batch,
                                max_len, dtype, device)


def compute_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """cumsum(mask) - 1, masked positions pinned to 1."""
    pos = torch.cumsum(attention_mask, dim=-1) - 1
    return torch.where(attention_mask == 0, torch.ones_like(pos), pos)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def lm_head_table(params: dict, cfg: StarCoder2Config) -> torch.Tensor:
    return params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"]


def _qkv(p: dict, cfg: StarCoder2Config, h: torch.Tensor, rope, policy, kernels: bool):
    """q (B, S, H, D), k and v (B, S, Hkv, D) of the normed h, q and k
    rotated by the call's rope tables (cos, sin)."""
    H, D, Hkv = cfg.num_attention_heads, cfg.head_dim, cfg.kv_heads
    q, k, v = (dense(p[name], h, policy, kernels=kernels, tag="dense_qkv_out").unflatten(-1, (n, D))
               for name, n in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)))
    return rotate(q, *rope), rotate(k, *rope), v


def _mlp(p: dict, cfg: StarCoder2Config, x: torch.Tensor, policy: DTypePolicy, kernels: bool):
    h = layer_norm(p["post_attention_layernorm"], x, cfg.norm_epsilon)
    h = gelu_tanh(dense(p["mlp"]["c_fc"], h, policy, kernels=kernels))
    return x + dense(p["mlp"]["c_proj"], h, policy, kernels=kernels)


def _prefill_block(p, cfg, x, layer_cache, kv_mask, idx, rope, policy, kernels):
    """One layer over S new tokens: write their k/v into the layer's cache,
    then flash-attend over the cache window from query offset idx with the
    sliding window."""
    B, S, _ = x.shape
    h = layer_norm(p["input_layernorm"], x, cfg.norm_epsilon)
    q, k, v = _qkv(p["attn"], cfg, h, rope, policy, kernels)
    k_win, v_win = dc.write_prefill_kv(layer_cache, k, v, idx, x.dtype)
    out = flash_prefill(q, k_win, v_win, kv_mask[:, :k_win.shape[1]], q_offset=idx,
                        window=cfg.sliding_window, kernels=kernels)
    x = x + dense(p["attn"]["o_proj"], out.reshape(B, S, -1), policy, kernels=kernels)
    return _mlp(p, cfg, x, policy, kernels)


def window_begin(cfg: StarCoder2Config, idx: int) -> int:
    """The first cache slot a query at slot idx sees: max(idx - window + 1,
    0), the JAX decoder's `slot > idx - window`."""
    return 0 if cfg.sliding_window is None else max(idx - cfg.sliding_window + 1, 0)


def _decode_layer_fn(cfg: StarCoder2Config, old_mask, idx: int, rope, policy, kernels: bool):
    """Per-layer single-token decode for decode_common.decode_scan:
    input_layernorm -> q/k/v with RoPE -> merged-softmax attention (kernel 2)
    over the cache slots [window_begin, idx) -> residual MLP."""
    H, D, Hkv = cfg.num_attention_heads, cfg.head_dim, cfg.kv_heads
    scale = D**-0.5
    t_begin = window_begin(cfg, idx)

    def fn(layer_p, h, lk, lv, lks=None, lvs=None):
        B = h.shape[0]
        hh = layer_norm(layer_p["input_layernorm"], h, cfg.norm_epsilon)
        q, k_new, v_new = _qkv(layer_p["attn"], cfg, hh, rope, policy, kernels)
        out = merged_decode_attention(
            q[:, 0].reshape(B, Hkv, H // Hkv, D), k_new[:, 0], v_new[:, 0], lk[:, :idx],
            lv[:, :idx], old_mask, scale, None if lks is None else lks[:, :idx],
            None if lvs is None else lvs[:, :idx], t_begin=t_begin, kernels=kernels)
        h = h + dense(layer_p["attn"]["o_proj"], out, policy, kernels=kernels)
        return _mlp(layer_p, cfg, h, policy, kernels), k_new[:, 0], v_new[:, 0]

    return fn


def _verify_layer_fn(cfg: StarCoder2Config, old_mask, t_lo: int, idx: int, new_mask, rope,
                     policy, kernels: bool):
    """Per-layer chunk step for decode_common.decode_scan: as
    _decode_layer_fn, with the W chunk queries attending to the cache slots
    [t_lo, idx) that `old_mask` (B, W, idx - t_lo) shows each of them, and
    to the chunk's own keys (decode_common.merged_verify_attention);
    `new_mask` (B, W) hides the chunk's pads."""
    H, D, Hkv = cfg.num_attention_heads, cfg.head_dim, cfg.kv_heads
    scale = D**-0.5

    def fn(layer_p, h, lk, lv, lks=None, lvs=None):
        hh = layer_norm(layer_p["input_layernorm"], h, cfg.norm_epsilon)
        q, k_new, v_new = _qkv(layer_p["attn"], cfg, hh, rope, policy, kernels)
        out = dc.merged_verify_attention(
            q.unflatten(2, (Hkv, H // Hkv)).movedim(1, 3), k_new, v_new, lk[:, t_lo:idx],
            lv[:, t_lo:idx], old_mask, scale, None if lks is None else lks[:, t_lo:idx],
            None if lvs is None else lvs[:, t_lo:idx], new_mask=new_mask)
        h = h + dense(layer_p["attn"]["o_proj"], out, policy, kernels=kernels)
        return _mlp(layer_p, cfg, h, policy, kernels), k_new, v_new

    return fn


def _train_block(p, cfg: StarCoder2Config, x, kv_mask, rope, policy: DTypePolicy, remat,
                 kernels: bool):
    """One layer of the training forward (the JAX _block without a cache),
    with the remat modes of gpt_bigcode._train_block: False keeps every
    activation; True recomputes the whole layer in the backward, the flash
    forward kernel included; "dots_flash" (the 8B recipe's) checkpoints the
    part before the attention (input_layernorm, q/k/v, RoPE) and the part
    after it (o_proj, residual, MLP) and leaves the flash autograd Function
    between them (ops/layers.py::remat_layer), so the backward never re-runs
    the attention forward."""
    B, S, _ = x.shape

    def pre(x):
        h = layer_norm(p["input_layernorm"], x, cfg.norm_epsilon)
        return _qkv(p["attn"], cfg, h, rope, policy, kernels)

    def attend(q, k, v):
        return flash_prefill_trainable(q, k, v, kv_mask, window=cfg.sliding_window,
                                       kernels=kernels)

    def post(x, attn):
        x = x + dense(p["attn"]["o_proj"], attn.reshape(B, S, -1), policy, kernels=kernels)
        return _mlp(p, cfg, x, policy, kernels)

    return remat_layer(pre, attend, post, remat)(x)


def forward(
    params: dict,
    cfg: StarCoder2Config,
    inputs_embeds: torch.Tensor,                 # (B, S, E)
    attention_mask: torch.Tensor | None = None,  # (B, S) over the new tokens
    position_ids: torch.Tensor | None = None,    # (B, S) absolute positions
    cache: dict | None = None,
    *,
    policy: DTypePolicy = DTypePolicy(),
    remat: bool | str = False,
    return_hidden: bool = False,
    last_logits_only: bool = False,
    kernels: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """Without `cache`: the full-sequence (training) forward, differentiable,
    the key mask `attention_mask`, positions compute_position_ids(mask),
    activation checkpointing per `remat` (False | True | "dots_flash").

    With `cache`: writes the S new tokens at cache["index"] (in place), by
    decode step, chunk step or prefill (see the module docstring).

    Returns (logits (B, S|1, V) fp32, or the final hidden states if
    `return_hidden`; the cache with its index advanced, or None).
    `kernels=False` runs the attention kernels' plain versions on the card."""
    B, S, _ = inputs_embeds.shape
    x = policy.cast(inputs_embeds)
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32, device=x.device)
    attention_mask = attention_mask.to(torch.int32)
    if cache is None:
        kv_mask = attention_mask.contiguous()
        if position_ids is None:
            position_ids = compute_position_ids(kv_mask)
    else:
        idx = cache["index"]
        T = cache["k"].shape[2]
        if idx + S > T:
            raise ValueError(f"cache of {T} slots cannot take {S} tokens at index {idx}")
        if position_ids is None:
            # positions continue from the number of real tokens each row has seen
            prev = cache["kv_mask"].sum(dim=-1, dtype=torch.int32)
            position_ids = prev[:, None] + compute_position_ids(attention_mask)
            position_ids = torch.where(attention_mask == 0, torch.ones_like(position_ids),
                                       position_ids)
        kv_mask = cache["kv_mask"]
        kv_mask[:, idx:idx + S] = attention_mask
    positions = torch.clamp(position_ids, 0, cfg.max_position_embeddings - 1)
    # RoPE's cos and sin, once for every layer (JAX recomputes them per
    # layer inside one jit; eager, that would be ten ops a layer)
    rope = rope_tables(positions, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                   device=x.device))

    layers = params["layers"]
    if cache is None:
        for layer in layer_unbind(layers, cfg.num_hidden_layers):
            x = _train_block(layer, cfg, x, kv_mask, rope, policy, remat, kernels)
    elif S == 1:
        # decode: the new token's k/v stay out of the cache during the layer
        # loop and are written once after it; old_mask covers slots < idx
        x, news = dc.decode_scan(layers, cache, x, _decode_layer_fn(
            cfg, kv_mask[:, :idx], idx, rope, policy, kernels))
        dc.write_new_kv_linear(cache, news, idx)
    elif S <= dc.CHUNK_STEP_MAX and (cfg.sliding_window is None or S <= cfg.sliding_window):
        # the chunk step: no query sees a slot before the first query's
        # window, so the layers read the slots from there
        t_lo = window_begin(cfg, idx)
        old_mask = kv_mask[:, None, t_lo:idx].expand(B, S, idx - t_lo)
        if cfg.sliding_window is not None:
            slot = torch.arange(t_lo, idx, device=x.device)
            query = torch.arange(idx, idx + S, device=x.device)
            old_mask = old_mask * (slot[None, :] > query[:, None] - cfg.sliding_window)
        x, news = dc.decode_scan(layers, cache, x, _verify_layer_fn(
            cfg, old_mask, t_lo, idx, attention_mask, rope, policy, kernels))
        dc.write_new_kv_linear_multi(cache, news, idx)
    else:
        for i in range(cfg.num_hidden_layers):
            x = _prefill_block(layer_slice(layers, i), cfg, x, dc.layer_cache(cache, i), kv_mask,
                               idx, rope, policy, kernels)
    if cache is not None:
        cache["index"] = idx + S

    x = layer_norm(params["norm"], x, cfg.norm_epsilon)
    if return_hidden:
        return x, cache
    if last_logits_only:
        x = x[:, -1:]
    # compute-dtype operands, fp32 logits straight from the fp32 accumulator
    logits = matmul_f32(policy.cast(x), policy.cast(lm_head_table(params, cfg)).T)
    return logits, cache


def forward_ragged_verify(params: dict, cfg: StarCoder2Config, token_ids: torch.Tensor,
                          cache: dict, *, policy: DTypePolicy = DTypePolicy(),
                          kernels: bool = True):
    """Speculative verify over a ragged cache (gpt_bigcode.
    forward_ragged_verify), with RoPE at each row's positions lengths +
    [0, W) (unclipped, as the JAX function) and the window per query: query
    w of row b sees cached slot t iff t > lengths[b] + w - window. Raises
    ValueError when W exceeds the window (the within-chunk attention
    assumes the chunk fits it). Returns (logits (B, W, V) fp32, the cache
    with the chunk written and lengths / kv_mask unchanged)."""
    B, W = token_ids.shape
    if cfg.sliding_window is not None and W > cfg.sliding_window:
        raise ValueError(f"verify chunk ({W}) exceeds sliding window ({cfg.sliding_window}): "
                         f"within-chunk visibility assumes the whole chunk fits the window")
    x = policy.cast(embed_tokens(params, token_ids))
    lengths = cache["lengths"]
    positions = lengths[:, None] + torch.arange(W, device=x.device)[None, :]
    rope = rope_tables(positions, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                   device=x.device))
    T = cache["k"].shape[2]
    # the slots any query can see: below the longest row, and past the
    # first query's window of the shortest
    t_hi = int(lengths.max())
    t_lo = min(window_begin(cfg, int(lengths.min())), t_hi)
    old_mask = cache["kv_mask"][:, None, t_lo:t_hi].expand(B, W, t_hi - t_lo)
    if cfg.sliding_window is not None:
        slot = torch.arange(t_lo, t_hi, device=x.device)
        old_mask = old_mask * (slot[None, None, :]
                               > (positions - cfg.sliding_window)[:, :, None])
    x, news = dc.decode_scan(params["layers"], cache, x, _verify_layer_fn(
        cfg, old_mask, t_lo, t_hi, None, rope, policy, kernels))
    dc.write_new_kv_ragged_multi(cache, news, torch.clamp(positions, 0, T - 1))
    x = layer_norm(params["norm"], x, cfg.norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(lm_head_table(params, cfg)).T), cache
