"""GPTBigCode (StarCoder v1) decoder, cached inference (port of
starvector_tpu/models/gpt_bigcode.py).

Same architecture and parameter layout as the JAX package: learned
positions `wpe`; multi-query attention through a fused
c_attn -> [Q (E) | K (Hkv*D) | V (Hkv*D)]; pre-LN blocks
ln_1 -> attn -> +res, ln_2 -> mlp(gelu_tanh) -> +res; ln_f; lm head tied to
`wte`. Layers are stacked on a leading axis.

Only the cached (inference) forward is ported. A cached call with S == 1
new tokens is a decode step: each layer's new k/v stay out of the cache,
kernel 2 merges the self-score into the softmax, and the new k/v are written
once after all layers. Every cached call with S > 1 goes through kernel 1
(flash prefill) over the whole cache window; the JAX package sends
1 < S <= 64 to an XLA chunk step instead, which computes the same attention.

The config's resid/embd/attn dropout fields are declared and never applied,
as in the JAX package: inference runs with p = 0 in effect.
"""

from __future__ import annotations

import dataclasses

import torch

from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.ops.flash_attention import flash_prefill, merged_decode_attention
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, gelu_tanh, layer_norm, layer_slice, make_dense_params,
    make_layer_norm_params, matmul_f32, normal_,
)


@dataclasses.dataclass(frozen=True)
class GPTBigCodeConfig:
    vocab_size: int = 49152
    n_positions: int = 8192
    hidden_size: int = 2048
    n_layer: int = 24
    n_head: int = 16
    n_inner: int | None = None  # default 4 * hidden
    multi_query: bool = True
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    resid_pdrop: float = 0.1  # declared, never applied (see module docstring)
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    # no attn_impl: the port's attention is always kernel 1 for prefill and
    # kernel 2 for decode (each with its plain version on the CPU)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @property
    def kv_heads(self) -> int:
        return 1 if self.multi_query else self.n_head

    @property
    def inner_dim(self) -> int:
        return self.n_inner or 4 * self.hidden_size


def tiny_config(**kw) -> GPTBigCodeConfig:
    base = dict(vocab_size=512, n_positions=128, hidden_size=64, n_layer=2, n_head=4)
    base.update(kw)
    return GPTBigCodeConfig(**base)


def init_params(cfg: GPTBigCodeConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    """Random weights with the JAX package's distributions (normal 0.02,
    depth-scaled residual projections), drawn from `gen`."""
    E, L = cfg.hidden_size, cfg.n_layer
    kv_dim = cfg.kv_heads * cfg.head_dim
    std = cfg.initializer_range
    resid_std = std / (2 * L) ** 0.5
    kw = dict(lead=(L,), device=device, dtype=dtype)
    return {
        "wte": normal_((cfg.vocab_size, E), std, gen, device, dtype),
        "wpe": normal_((cfg.n_positions, E), std, gen, device, dtype),
        "layers": {
            "ln_1": make_layer_norm_params(E, **kw),
            "attn": {
                "c_attn": make_dense_params(gen, E, E + 2 * kv_dim, std=std, **kw),
                "c_proj": make_dense_params(gen, E, E, std=resid_std, **kw),
            },
            "ln_2": make_layer_norm_params(E, **kw),
            "mlp": {
                "c_fc": make_dense_params(gen, E, cfg.inner_dim, std=std, **kw),
                "c_proj": make_dense_params(gen, cfg.inner_dim, E, std=resid_std, **kw),
            },
        },
        "ln_f": make_layer_norm_params(E, device=device, dtype=dtype),
    }


def init_cache(cfg: GPTBigCodeConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    return dc.init_cache(cfg.n_layer, cfg.kv_heads, cfg.head_dim, batch, max_len,
                         dtype, device)


def compute_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """cumsum(mask) - 1, masked positions pinned to 1."""
    pos = torch.cumsum(attention_mask, dim=-1) - 1
    return torch.where(attention_mask == 0, torch.ones_like(pos), pos)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["wte"][input_ids]


def _split_qkv(cfg: GPTBigCodeConfig, qkv: torch.Tensor):
    """Views of the fused projection (..., E + 2*Hkv*D): q (..., H*D), k and
    v (..., Hkv*D)."""
    E, kvd = cfg.hidden_size, cfg.kv_heads * cfg.head_dim
    return qkv[..., :E], qkv[..., E:E + kvd], qkv[..., E + kvd:]


def _mlp(p: dict, cfg: GPTBigCodeConfig, x: torch.Tensor, policy: DTypePolicy):
    h = layer_norm(p["ln_2"], x, cfg.layer_norm_epsilon)
    h = gelu_tanh(dense(p["mlp"]["c_fc"], h, policy))
    return x + dense(p["mlp"]["c_proj"], h, policy)


def _prefill_block(p, cfg, x, layer_cache, kv_mask, idx, policy, kernels):
    """One layer over S new tokens: write their k/v into the layer's cache,
    then flash-attend over the whole cache window from query offset idx."""
    B, S, E = x.shape
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads
    qkv = dense(p["attn"]["c_attn"], layer_norm(p["ln_1"], x, cfg.layer_norm_epsilon), policy)
    q, k, v = _split_qkv(cfg, qkv)
    k_win, v_win = dc.write_prefill_kv(
        layer_cache, k.unflatten(-1, (Hkv, D)), v.unflatten(-1, (Hkv, D)), idx)
    out = flash_prefill(q.unflatten(-1, (H, D)), k_win, v_win, kv_mask, q_offset=idx,
                        kernels=kernels)
    x = x + dense(p["attn"]["c_proj"], out.reshape(B, S, E), policy)
    return _mlp(p, cfg, x, policy)


def _decode_layer_fn(cfg: GPTBigCodeConfig, old_mask, idx: int, policy, kernels: bool):
    """Per-layer single-token decode for decode_common.decode_scan: ln_1 ->
    fused c_attn split -> merged-softmax attention (kernel 2) over the
    cache's first idx slots -> residual MLP."""
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads
    scale = D**-0.5

    def fn(layer_p, h, lk, lv):
        hh = layer_norm(layer_p["ln_1"], h, cfg.layer_norm_epsilon)
        qkv = dense(layer_p["attn"]["c_attn"], hh, policy)[:, 0]  # (B, E + 2*Hkv*D)
        q, k_new, v_new = _split_qkv(cfg, qkv)
        out = merged_decode_attention(
            q.unflatten(-1, (Hkv, H // Hkv, D)), k_new.unflatten(-1, (Hkv, D)),
            v_new.unflatten(-1, (Hkv, D)), lk[:, :idx], lv[:, :idx], old_mask, scale,
            kernels=kernels,
        )
        h = h + dense(layer_p["attn"]["c_proj"], out, policy)
        return _mlp(layer_p, cfg, h, policy), k_new.unflatten(-1, (Hkv, D)), v_new.unflatten(-1, (Hkv, D))

    return fn


def forward(
    params: dict,
    cfg: GPTBigCodeConfig,
    inputs_embeds: torch.Tensor,                 # (B, S, E)
    attention_mask: torch.Tensor | None = None,  # (B, S) over the new tokens
    position_ids: torch.Tensor | None = None,    # (B, S) absolute positions
    cache: dict | None = None,
    *,
    policy: DTypePolicy = DTypePolicy(),
    last_logits_only: bool = False,
    kernels: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Cached forward: writes the S new tokens at cache["index"] (in place)
    and attends over the whole preallocated window. Returns (logits (B, S|1,
    V) fp32, the same cache dict with its index advanced). `kernels=False`
    runs the attention kernels' plain versions on the card."""
    if cache is None:
        raise NotImplementedError(
            "the uncached (training) forward is not ported yet: ROADMAP queue 1, item 8")
    B, S, _ = inputs_embeds.shape
    x = policy.cast(inputs_embeds)
    idx = cache["index"]
    T = cache["k"].shape[2]
    if idx + S > T:
        raise ValueError(f"cache of {T} slots cannot take {S} tokens at index {idx}")
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32, device=x.device)
    attention_mask = attention_mask.to(torch.int32)
    if position_ids is None:
        # positions continue from the number of real tokens each row has seen
        prev = cache["kv_mask"].sum(dim=-1, dtype=torch.int32)
        position_ids = prev[:, None] + compute_position_ids(attention_mask)
        position_ids = torch.where(attention_mask == 0, torch.ones_like(position_ids), position_ids)
    kv_mask = cache["kv_mask"]
    kv_mask[:, idx:idx + S] = attention_mask
    position_ids = torch.clamp(position_ids, 0, cfg.n_positions - 1)
    x = x + policy.cast(params["wpe"][position_ids])

    layers = params["layers"]
    if S == 1:
        # decode: the new token's k/v stay out of the cache during the layer
        # loop and are written once after it; old_mask covers slots < idx
        x, news = dc.decode_scan(
            layers, cache, x, _decode_layer_fn(cfg, kv_mask[:, :idx], idx, policy, kernels))
        dc.write_new_kv_linear(cache, news, idx)
    else:
        for i in range(cfg.n_layer):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x = _prefill_block(layer_slice(layers, i), cfg, x, layer_cache, kv_mask, idx,
                               policy, kernels)
    cache["index"] = idx + S

    x = layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)
    if last_logits_only:
        x = x[:, -1:]
    # tied head: compute-dtype operands, fp32 logits straight from the fp32
    # accumulator (never rounded to bf16, which would tie near-equal logits)
    logits = matmul_f32(policy.cast(x), policy.cast(params["wte"]).T)
    return logits, cache
