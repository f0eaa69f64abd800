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
is gpt_bigcode.causal_lm_loss_fused over `lm_head_table`. On a
sequence-parallel layout it splits the positions, RoPE at the chunk's
absolute positions, and each rank runs its chunk, its attention through
parallel/sequence.py::sp_flash_attention; on a stage mesh the layers run
through parallel/pipeline.py::pipeline_layers, the key mask and the RoPE
tables travelling with each microbatch.

Over a ragged cache (per-row lengths; the serving engine's):
`forward_ragged_decode` is one decode step with RoPE at each row's own
position and the window per row: kernel 2 takes one t_begin for all rows,
so each row's window goes into its key mask, and t_begin is at most the
shortest row's window start. `forward_ragged_verify` is speculative
decoding's verify, with a per-query window over the cached slots. Both
take the slots any row may see from the caller (`key_bounds`); a verify
given (0, t_cap) is static: it reads nothing on the host, every row's
window in its per-query mask over [0, t_cap).

The static steps (`forward_decode_static`, `forward_chunk_static`) take
their write slot as a device int32 tensor and read nothing on the host, so
that generation/engine.py and generation/speculative.py run their loops
as captured CUDA graphs; StarCoder2 has no fused decode+chunk forward (nor
has the JAX package), so its pipelined step is a decode step and then a
chunk step.

On a serving layout (parallel/zero.py; a serving mesh with fsdp, sequence
or stage above 1) every cached path gathers each layer whole just before
it reads it (zero.layer_at: a stage's layer from its owner, fsdp shards
all-gathered) and the tables and `norm` where it reads them
(zero.gathered); the window's t_begin is the same. Off a layout both are
the plain views.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.parallel import pipeline, sequence, zero
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.tensor import copy_to_group
from starvector_tpu_torch.parallel.zero import gathered
from starvector_tpu_torch.ops.flash_attention import (
    flash_prefill, merged_decode_attention,
)
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, gelu_tanh, layer_norm, make_dense_params,
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


@dataclasses.dataclass(frozen=True)
class StarCoder2RankConfig(StarCoder2Config):
    """The decoder of one tensor-parallel rank (tensor_config): its own
    heads and MLP columns, the whole model's head size."""
    head_size: int = 128

    @property
    def head_dim(self) -> int:
        return self.head_size


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


def partition_rules() -> list[tuple[str, P]]:
    """Path regex -> PartitionSpec, the JAX package's list (the tables over
    fsdp only, as gpt_bigcode's)."""
    return [
        (r"embed_tokens$|lm_head$", P("fsdp", None)),
        (r"layers/.*(q_proj|k_proj|v_proj)/kernel", P("stage", "fsdp", "tensor")),
        (r"layers/.*(q_proj|k_proj|v_proj)/bias", P("stage", "tensor")),
        (r"layers/.*o_proj/kernel", P("stage", "tensor", "fsdp")),
        (r"layers/.*o_proj/bias", P("stage", None)),
        (r"layers/.*c_fc/kernel", P("stage", "fsdp", "tensor")),
        (r"layers/.*c_fc/bias", P("stage", "tensor")),
        (r"layers/.*mlp/c_proj/kernel", P("stage", "tensor", "fsdp")),
        (r"layers/.*mlp/c_proj/bias", P("stage", None)),
        (r"layers/.*layernorm/", P("stage", None)),
        (r"norm/", P(None)),
    ]


def tensor_units(cfg: StarCoder2Config, tp: int, rank: int) -> dict[str, tuple[int, int]]:
    """Tensor rank `rank` of tp's (start, length) along each projection's
    split dimension (partition_rules' "tensor" entries): whole heads of
    q/k/v_proj's columns and o_proj's rows (parallel/tensor.py::
    head_layout), a contiguous 1/tp of c_fc's columns and mlp/c_proj's rows."""
    from starvector_tpu_torch.parallel.tensor import even_split, head_layout

    D = cfg.head_dim
    h = head_layout(cfg.num_attention_heads, cfg.kv_heads, tp)[rank]
    q, kv = (h.q_start * D, h.q_count * D), (h.kv_start * D, h.kv_count * D)
    mlp = even_split(cfg.intermediate_size, tp, rank)
    return {"q_proj": q, "k_proj": kv, "v_proj": kv, "o_proj": q, "c_fc": mlp, "c_proj": mlp}


def tensor_config(cfg: StarCoder2Config, tp: int, rank: int) -> StarCoder2Config:
    """The config of tensor rank `rank`'s decoder: its own heads and 1/tp of
    the MLP; hidden size, head size, RoPE, window and vocabulary whole."""
    from starvector_tpu_torch.parallel.tensor import head_layout

    h = head_layout(cfg.num_attention_heads, cfg.kv_heads, tp)[rank]
    _, mlp = tensor_units(cfg, tp, rank)["c_fc"]
    whole = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(StarCoder2Config)}
    return StarCoder2RankConfig(**{**whole, "num_attention_heads": h.q_count,
                                   "num_key_value_heads": h.kv_count, "intermediate_size": mlp},
                                head_size=cfg.head_dim)


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
    return gathered(params["embed_tokens"])[input_ids]


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
    h = copy_to_group(layer_norm(p["post_attention_layernorm"], x, cfg.norm_epsilon))
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


def _decode_layer_fn(cfg: StarCoder2Config, old_mask, idx: int | None, rope, policy,
                     kernels: bool, t_begin: int | None = None,
                     bounds: torch.Tensor | None = None, t_cap: int | None = None):
    """Per-layer single-token decode for decode_common.decode_scan:
    input_layernorm -> q/k/v with RoPE -> merged-softmax attention (kernel 2)
    over the cache slots [t_begin, idx) (t_begin: window_begin(idx) unless
    given) -> residual MLP. idx None: the whole cache, its visible slots
    kernel 2's device `bounds` (a static step), t_cap their host cap."""
    H, D, Hkv = cfg.num_attention_heads, cfg.head_dim, cfg.kv_heads
    scale = D**-0.5
    if bounds is not None:
        t_begin = 0
    elif t_begin is None:
        t_begin = window_begin(cfg, idx)

    def fn(layer_p, h, lk, lv, lks=None, lvs=None):
        B = h.shape[0]
        hh = layer_norm(layer_p["input_layernorm"], h, cfg.norm_epsilon)
        q, k_new, v_new = _qkv(layer_p["attn"], cfg, hh, rope, policy, kernels)
        out = merged_decode_attention(
            q[:, 0].reshape(B, Hkv, H // Hkv, D), k_new[:, 0], v_new[:, 0], lk[:, :idx],
            lv[:, :idx], old_mask, scale, None if lks is None else lks[:, :idx],
            None if lvs is None else lvs[:, :idx], t_begin=t_begin, bounds=bounds,
            t_cap=t_cap, kernels=kernels)
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
    the attention forward. On a ZeRO-3 layout each part gathers its own
    weights inside its checkpoint, and on a tensor-parallel one `cfg` is
    the rank's, the normed input entering q/k/v (one copy_to_group for the
    three) and the MLP (gpt_bigcode._train_block)."""
    B, S, _ = x.shape

    def pre(x):
        g = gathered({"input_layernorm": p["input_layernorm"],
                      "attn": {k: p["attn"][k] for k in ("q_proj", "k_proj", "v_proj")}}, policy)
        h = copy_to_group(layer_norm(g["input_layernorm"], x, cfg.norm_epsilon))
        return _qkv(g["attn"], cfg, h, rope, policy, kernels)

    def attend(q, k, v):
        return sequence.sp_flash_attention(q, k, v, kv_mask, window=cfg.sliding_window,
                                           kernels=kernels)

    def post(x, attn):
        g = gathered({"o_proj": p["attn"]["o_proj"], "mlp": p["mlp"],
                      "post_attention_layernorm": p["post_attention_layernorm"]}, policy)
        x = x + dense(g["o_proj"], attn.reshape(B, S, -1), policy, kernels=kernels)
        return _mlp(g, cfg, x, policy, kernels)

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
    `return_hidden`; the cache with its index advanced, or None). Without a
    cache, on a sequence-parallel split, those of this rank's chunk of the
    positions (parallel/sequence.py::chunk_span).
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
    span = sequence.split_sequence(S) if cache is None else None
    if span is not None:  # a sequence-parallel rank's chunk of positions
        x, positions = x[:, span[0]:span[1]], positions[:, span[0]:span[1]]
    # RoPE's cos and sin, once for every layer (JAX recomputes them per
    # layer inside one jit; eager, that would be ten ops a layer)
    rope = rope_tables(positions, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                   device=x.device))

    layers = params["layers"]
    if cache is None:
        x = pipeline.pipeline_layers(
            layers, x, {"kv_mask": kv_mask, "cos": rope[0], "sin": rope[1]},
            lambda h, layer, a: _train_block(layer, cfg, h, a["kv_mask"], (a["cos"], a["sin"]),
                                             policy, remat, kernels))
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
            x = _prefill_block(zero.layer_at(layers, i), cfg, x, dc.layer_cache(cache, i),
                               kv_mask, idx, rope, policy, kernels)
    if cache is not None:
        cache["index"] = idx + S

    x = layer_norm(gathered(params["norm"]), x, cfg.norm_epsilon)
    if return_hidden:
        return x, cache
    if last_logits_only:
        x = x[:, -1:]
    # compute-dtype operands, fp32 logits straight from the fp32 accumulator
    logits = matmul_f32(policy.cast(x), policy.cast(gathered(lm_head_table(params, cfg))).T)
    return logits, cache


def forward_decode_static(params: dict, cfg: StarCoder2Config, inputs_embeds: torch.Tensor,
                          cache: dict, pos: torch.Tensor, *, t_cap: int,
                          policy: DTypePolicy = DTypePolicy(), kernels: bool = True):
    """The cached decode step (forward's S == 1 branch) with nothing on the
    host, as gpt_bigcode.forward_decode_static: the new token at slot `pos`
    (int32 (1,) on the device), RoPE at the position its row's key mask
    counts, kernel 2 over the whole cache with the device bounds
    [max(pos - window + 1, 0), pos] (window_begin on the device), its grid
    planned at t_cap >= pos. Returns the logits (B, V) fp32; the cache
    changes in place."""
    x = policy.cast(inputs_embeds)
    positions, bounds = dc.static_decode_slots(cache, pos, cfg.sliding_window)
    positions = torch.clamp(positions[:, None], 0, cfg.max_position_embeddings - 1)
    rope = rope_tables(positions, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                   device=x.device))
    x, news = dc.decode_scan(params["layers"], cache, x, _decode_layer_fn(
        cfg, cache["kv_mask"], None, rope, policy, kernels, bounds=bounds, t_cap=t_cap))
    dc.write_new_kv_static(cache, news, pos)
    x = layer_norm(gathered(params["norm"]), x, cfg.norm_epsilon)
    return matmul_f32(policy.cast(x),
                      policy.cast(gathered(lm_head_table(params, cfg))).T)[:, 0]


def forward_chunk_static(params: dict, cfg: StarCoder2Config, inputs_embeds: torch.Tensor,
                         attention_mask: torch.Tensor, cache: dict, idx: torch.Tensor, *,
                         t_cap: int, policy: DTypePolicy = DTypePolicy(), kernels: bool = True,
                         return_hidden: bool = False, last_logits_only: bool = False):
    """The cached chunk step (forward's 1 < S <= 64 branch) with nothing on
    the host, as gpt_bigcode.forward_chunk_static: the C new tokens at slots
    idx + [0, C) (`idx` int32 (1,) on the device), RoPE at the positions
    their rows' key masks count, the queries over the key span [0, t_cap)
    with the sliding window per query in the device mask (query w sees
    slot t > idx + w - window, the chunk step's window without its host
    t_lo). Raises ValueError when C exceeds the window (the within-chunk
    attention assumes the chunk fits it). Returns the logits (B, C|1, V)
    fp32, or the final hidden states (B, C, E) if `return_hidden`; the
    cache changes in place."""
    C = inputs_embeds.shape[1]
    if cfg.sliding_window is not None and C > cfg.sliding_window:
        raise ValueError(f"chunk ({C}) exceeds sliding window ({cfg.sliding_window}): "
                         f"within-chunk visibility assumes the whole chunk fits the window")
    x = policy.cast(inputs_embeds)
    positions, old_mask, slots = dc.static_chunk_slots(cache, idx, attention_mask, t_cap,
                                                       cfg.sliding_window)
    positions = torch.clamp(positions, 0, cfg.max_position_embeddings - 1)
    rope = rope_tables(positions, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                   device=x.device))
    x, news = dc.decode_scan(params["layers"], cache, x, _verify_layer_fn(
        cfg, old_mask, 0, t_cap, attention_mask.to(torch.int32), rope, policy, kernels))
    dc.write_new_kv_slots(cache, news, slots)
    x = layer_norm(gathered(params["norm"]), x, cfg.norm_epsilon)
    if return_hidden:
        return x
    if last_logits_only:
        x = x[:, -1:]
    return matmul_f32(policy.cast(x), policy.cast(gathered(lm_head_table(params, cfg))).T)


def forward_ragged_decode(params: dict, cfg: StarCoder2Config, token_ids: torch.Tensor,
                          cache: dict, active: torch.Tensor, *,
                          policy: DTypePolicy = DTypePolicy(), kernels: bool = True,
                          key_bounds: tuple[int, int] | None = None):
    """One decode step with every row at its own position (the JAX
    forward_ragged_decode): token_ids (B,), RoPE at each row's length, each
    row's new k/v written at its length after the layers, `lengths +=
    active`. Attention is kernel 2 over the slots [t_lo, t_hi) of
    `key_bounds` with the per-row key mask, each row's window (slot t >
    length - window) folded into it. Returns (logits (B, V) fp32, the
    cache, updated in place)."""
    x = policy.cast(embed_tokens(params, token_ids[:, None]))  # (B, 1, E)
    lengths = cache["lengths"]
    rope = rope_tables(lengths[:, None], rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                          device=x.device))
    write_pos, _, old_mask = dc.ragged_step_masks(cache, active, cfg.sliding_window)
    t_lo, t_hi = dc.ragged_key_bounds(cache, key_bounds, cfg.sliding_window)
    x, news = dc.decode_scan(params["layers"], cache, x, _decode_layer_fn(
        cfg, old_mask[:, :t_hi], t_hi, rope, policy, kernels, t_begin=t_lo))
    dc.write_new_kv_ragged(cache, news, write_pos)
    dc.ragged_step_commit(cache, active, write_pos)
    x = layer_norm(gathered(params["norm"]), x, cfg.norm_epsilon)
    return matmul_f32(policy.cast(x),
                      policy.cast(gathered(lm_head_table(params, cfg))).T)[:, 0], cache


def forward_ragged_decode_static(params: dict, cfg: StarCoder2Config, token_ids: torch.Tensor,
                                 cache: dict, active: torch.Tensor, *, t_cap: int,
                                 policy: DTypePolicy = DTypePolicy(), kernels: bool = True):
    """forward_ragged_decode with nothing on the host (the serving engine's
    captured tick), as gpt_bigcode.forward_ragged_decode_static: RoPE at
    each row's length, the window per row in its key mask and kernel 2's
    device bounds from the shortest active row's window start
    (decode_common.ragged_static_masks), the grid planned at t_cap; the key
    mask and lengths written in place. Returns (B, V) fp32 logits."""
    x = policy.cast(embed_tokens(params, token_ids[:, None]))  # (B, 1, E)
    rope = rope_tables(cache["lengths"][:, None], rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                                   device=x.device))
    write_pos, old_mask, bounds = dc.ragged_static_masks(cache, active, cfg.sliding_window)
    x, news = dc.decode_scan(params["layers"], cache, x, _decode_layer_fn(
        cfg, old_mask, None, rope, policy, kernels, bounds=bounds, t_cap=t_cap))
    dc.write_new_kv_ragged(cache, news, write_pos)
    dc.ragged_step_commit(cache, active, write_pos)
    x = layer_norm(gathered(params["norm"]), x, cfg.norm_epsilon)
    return matmul_f32(policy.cast(x),
                      policy.cast(gathered(lm_head_table(params, cfg))).T)[:, 0]


def forward_ragged_verify(params: dict, cfg: StarCoder2Config, token_ids: torch.Tensor,
                          cache: dict, *, policy: DTypePolicy = DTypePolicy(),
                          kernels: bool = True, key_bounds: tuple[int, int] | None = None):
    """Speculative verify over a ragged cache (gpt_bigcode.
    forward_ragged_verify), with RoPE at each row's positions lengths +
    [0, W) (unclipped, as the JAX function) and the window per query: query
    w of row b sees cached slot t iff t > lengths[b] + w - window. Raises
    ValueError when W exceeds the window (the within-chunk attention
    assumes the chunk fits it). `key_bounds` as in forward_ragged_decode.
    Returns (logits (B, W, V) fp32, the cache with the chunk written and
    lengths / kv_mask unchanged)."""
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
    t_lo, t_hi = dc.ragged_key_bounds(cache, key_bounds, cfg.sliding_window)
    old_mask = cache["kv_mask"][:, None, t_lo:t_hi].expand(B, W, t_hi - t_lo)
    if cfg.sliding_window is not None:
        slot = torch.arange(t_lo, t_hi, device=x.device)
        old_mask = old_mask * (slot[None, None, :]
                               > (positions - cfg.sliding_window)[:, :, None])
    x, news = dc.decode_scan(params["layers"], cache, x, _verify_layer_fn(
        cfg, old_mask, t_lo, t_hi, None, rope, policy, kernels))
    dc.write_new_kv_ragged_multi(cache, news, torch.clamp(positions, 0, T - 1))
    x = layer_norm(gathered(params["norm"]), x, cfg.norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(gathered(lm_head_table(params, cfg))).T), cache
