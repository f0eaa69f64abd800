"""GPTBigCode (StarCoder v1) decoder: cached inference and the uncached
training forward (port of starvector_tpu/models/gpt_bigcode.py).

Same architecture and parameter layout as the JAX package: learned
positions `wpe`; multi-query attention through a fused
c_attn -> [Q (E) | K (Hkv*D) | V (Hkv*D)]; pre-LN blocks
ln_1 -> attn -> +res, ln_2 -> mlp(gelu_tanh) -> +res; ln_f; lm head tied to
`wte`. Layers are stacked on a leading axis.

A cached call dispatches on its S new tokens as the JAX decoder does:
  * S == 1, a decode step: each layer's new k/v stay out of the cache,
    kernel 2 merges the self-score into the softmax, and the new k/v are
    written once after all layers;
  * 1 < S <= 64, the chunk step (a text2svg prompt): the same write-once
    scan, each layer's attention decode_common.merged_verify_attention in
    plain PyTorch (the JAX package's XLA): the cached slots with P rounded
    to the compute dtype, the chunk's own keys unquantized with P and V in
    fp32;
  * S > 64, a prefill (im2svg's visual prefix): each layer writes its k/v
    and runs kernel 1 (flash prefill) over the cache window.
An int8 cache (init_cache(dtype=torch.int8)) is written as codes and
scales: a prefill attends over the dequantized window, a decode step goes
through kernel 2's int8 instantiation, and the chunk step folds the scales
into its scores and probabilities; decode and chunk quantize their own
k/v only when they write them after the layers.

Every dense layer of the cached path also takes `kernels`: a quantized
parameter tree (ops/quantization.py::quantize_tree) runs its projections
through kernel 14, or its plain version with kernels=False.

`forward_ragged_verify` is batched speculative decoding's verify over a
ragged cache (per-row lengths): each row's W tokens at its own positions,
through the chunk step's attention.

Without a cache, `forward` is the training forward: each layer's attention
is `flash_prefill_trainable` (the forward-with-lse kernel and the backward
pair behind one autograd Function), with activation checkpointing per
`remat` (see `_train_block`). The loss is `causal_lm_loss_fused`, the tied
head fused into chunks whose logits are recomputed in the backward;
`token_logprobs_fused` gives GRPO's per-token log-probs the same way.

The config's resid/embd/attn dropout fields are declared and never applied,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.ops.flash_attention import (
    flash_prefill, flash_prefill_trainable, merged_decode_attention,
)
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, gelu_tanh, layer_norm, layer_slice, layer_unbind, make_dense_params,
    make_layer_norm_params, matmul_f32, normal_, remat_layer,
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


def _mlp(p: dict, cfg: GPTBigCodeConfig, x: torch.Tensor, policy: DTypePolicy,
         kernels: bool = True):
    h = layer_norm(p["ln_2"], x, cfg.layer_norm_epsilon)
    h = gelu_tanh(dense(p["mlp"]["c_fc"], h, policy, kernels=kernels))
    return x + dense(p["mlp"]["c_proj"], h, policy, kernels=kernels)


def _prefill_block(p, cfg, x, layer_cache, kv_mask, idx, policy, kernels):
    """One layer over S new tokens: write their k/v into the layer's cache,
    then flash-attend over the cache window from query offset idx (an int8
    cache's window is dequantized and ends after the chunk)."""
    B, S, E = x.shape
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads
    qkv = dense(p["attn"]["c_attn"], layer_norm(p["ln_1"], x, cfg.layer_norm_epsilon), policy,
                kernels=kernels)
    q, k, v = _split_qkv(cfg, qkv)
    k_win, v_win = dc.write_prefill_kv(
        layer_cache, k.unflatten(-1, (Hkv, D)), v.unflatten(-1, (Hkv, D)), idx, x.dtype)
    out = flash_prefill(q.unflatten(-1, (H, D)), k_win, v_win, kv_mask[:, :k_win.shape[1]],
                        q_offset=idx, kernels=kernels)
    x = x + dense(p["attn"]["c_proj"], out.reshape(B, S, E), policy, kernels=kernels)
    return _mlp(p, cfg, x, policy, kernels)


def _decode_layer_fn(cfg: GPTBigCodeConfig, old_mask, idx: int, policy, kernels: bool):
    """Per-layer single-token decode for decode_common.decode_scan: ln_1 ->
    fused c_attn split -> merged-softmax attention (kernel 2) over the
    cache's first idx slots (with their scales for an int8 cache) ->
    residual MLP."""
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads
    scale = D**-0.5

    def fn(layer_p, h, lk, lv, lks=None, lvs=None):
        hh = layer_norm(layer_p["ln_1"], h, cfg.layer_norm_epsilon)
        qkv = dense(layer_p["attn"]["c_attn"], hh, policy, kernels=kernels)[:, 0]
        q, k_new, v_new = _split_qkv(cfg, qkv)  # of (B, E + 2*Hkv*D)
        out = merged_decode_attention(
            q.unflatten(-1, (Hkv, H // Hkv, D)), k_new.unflatten(-1, (Hkv, D)),
            v_new.unflatten(-1, (Hkv, D)), lk[:, :idx], lv[:, :idx], old_mask, scale,
            None if lks is None else lks[:, :idx], None if lvs is None else lvs[:, :idx],
            kernels=kernels,
        )
        h = h + dense(layer_p["attn"]["c_proj"], out, policy, kernels=kernels)
        return (_mlp(layer_p, cfg, h, policy, kernels), k_new.unflatten(-1, (Hkv, D)),
                v_new.unflatten(-1, (Hkv, D)))

    return fn


def _verify_layer_fn(cfg: GPTBigCodeConfig, old_mask, idx: int, new_mask, policy,
                     kernels: bool):
    """Per-layer chunk step for decode_common.decode_scan: as
    _decode_layer_fn, with the W chunk queries attending to the cache's
    first idx slots and to the chunk's own keys (decode_common.
    merged_verify_attention); `new_mask` (B, W) hides the chunk's pads."""
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads
    scale = D**-0.5

    def fn(layer_p, h, lk, lv, lks=None, lvs=None):
        hh = layer_norm(layer_p["ln_1"], h, cfg.layer_norm_epsilon)
        q, k_new, v_new = _split_qkv(cfg, dense(layer_p["attn"]["c_attn"], hh, policy,
                                                kernels=kernels))
        k_new, v_new = k_new.unflatten(-1, (Hkv, D)), v_new.unflatten(-1, (Hkv, D))
        out = dc.merged_verify_attention(
            q.unflatten(-1, (Hkv, H // Hkv, D)).movedim(1, 3), k_new, v_new, lk[:, :idx],
            lv[:, :idx], old_mask, scale, None if lks is None else lks[:, :idx],
            None if lvs is None else lvs[:, :idx], new_mask=new_mask)
        h = h + dense(layer_p["attn"]["c_proj"], out, policy, kernels=kernels)
        return _mlp(layer_p, cfg, h, policy, kernels), k_new, v_new

    return fn


def _train_block(p, cfg: GPTBigCodeConfig, x, kv_mask, policy: DTypePolicy, remat,
                 kernels: bool):
    """One layer of the training forward (the JAX _block without a cache).

    remat False keeps every activation; True recomputes the whole layer in
    the backward, the flash forward kernel included. "dots_flash" (the 1B
    default) checkpoints the part before the attention (ln_1, c_attn) and
    the part after it (c_proj, residual, ln_2, MLP) each and leaves the
    flash autograd Function between them (ops/layers.py::remat_layer), so
    the backward never re-runs the attention forward. The JAX policy also saves the MLP
    down-projection output; here the post-attention part recomputes it."""
    B, S, E = x.shape
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads

    def pre(x):
        return (dense(p["attn"]["c_attn"], layer_norm(p["ln_1"], x, cfg.layer_norm_epsilon),
                      policy, tag="dense_qkv_out"),)

    def attend(qkv):
        q, k, v = _split_qkv(cfg, qkv)
        return flash_prefill_trainable(q.unflatten(-1, (H, D)), k.unflatten(-1, (Hkv, D)),
                                       v.unflatten(-1, (Hkv, D)), kv_mask, kernels=kernels)

    def post(x, attn):
        x = x + dense(p["attn"]["c_proj"], attn.reshape(B, S, E), policy)
        return _mlp(p, cfg, x, policy)

    return remat_layer(pre, attend, post, remat)(x)


def _forward_uncached(params, cfg, inputs_embeds, attention_mask, position_ids, policy,
                      remat, return_hidden, last_logits_only, kernels):
    B, S, _ = inputs_embeds.shape
    x = policy.cast(inputs_embeds)
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32, device=x.device)
    kv_mask = attention_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = compute_position_ids(kv_mask)
    position_ids = torch.clamp(position_ids, 0, cfg.n_positions - 1)
    x = x + policy.cast(params["wpe"][position_ids])
    for layer in layer_unbind(params["layers"], cfg.n_layer):
        x = _train_block(layer, cfg, x, kv_mask, policy, remat, kernels)
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)
    if return_hidden:
        return x, None
    if last_logits_only:
        x = x[:, -1:]
    return matmul_f32(policy.cast(x), policy.cast(params["wte"]).T), None


def forward(
    params: dict,
    cfg: GPTBigCodeConfig,
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
    with activation checkpointing per `remat` (False | True | "dots_flash");
    returns (logits (B, S, V) fp32, or the final hidden states if
    `return_hidden`, None).

    With `cache`: writes the S new tokens at cache["index"] (in place), by
    decode step, chunk step or prefill (see the module docstring). Returns
    (logits (B, S|1, V) fp32, or the final hidden states (B, S, E) if
    `return_hidden`; the same cache dict with its index advanced).

    `kernels=False` runs the kernels' plain versions on the card (attention,
    and the int8 matmul of a quantized tree)."""
    if cache is None:
        return _forward_uncached(params, cfg, inputs_embeds, attention_mask, position_ids,
                                 policy, remat, return_hidden, last_logits_only, kernels)
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
    elif S <= dc.CHUNK_STEP_MAX:
        # the chunk step: the chunk's k/v, too, are written once after the
        # layers, and its pads (left-padded prompts) are hidden from its queries
        x, news = dc.decode_scan(layers, cache, x, _verify_layer_fn(
            cfg, kv_mask[:, :idx], idx, attention_mask, policy, kernels))
        dc.write_new_kv_linear_multi(cache, news, idx)
    else:
        for i in range(cfg.n_layer):
            x = _prefill_block(layer_slice(layers, i), cfg, x, dc.layer_cache(cache, i), kv_mask,
                               idx, policy, kernels)
    cache["index"] = idx + S

    x = layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)
    if return_hidden:
        return x, cache
    if last_logits_only:
        x = x[:, -1:]
    # tied head: compute-dtype operands, fp32 logits straight from the fp32
    # accumulator (never rounded to bf16, which would tie near-equal logits)
    logits = matmul_f32(policy.cast(x), policy.cast(params["wte"]).T)
    return logits, cache


def init_ragged_cache(cfg: GPTBigCodeConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cpu") -> dict:
    """Cache with per-row lengths (decode_common.init_ragged_cache)."""
    return dc.init_ragged_cache(cfg.n_layer, cfg.kv_heads, cfg.head_dim, batch, max_len,
                                dtype, device)


def forward_ragged_verify(params: dict, cfg: GPTBigCodeConfig, token_ids: torch.Tensor,
                          cache: dict, *, policy: DTypePolicy = DTypePolicy(),
                          kernels: bool = True):
    """Speculative verify over a ragged cache: each row's W tokens (B, W)
    ([last accepted ‖ drafts]) at positions lengths + [0, W), attending to
    the row's visible slots and causally to its own chunk (the chunk step's
    merged_verify_attention). The chunk's k/v are written at those slots
    in place; `lengths` and `kv_mask` are left for
    decode_common.commit_verify, which shows only the accepted ones (every
    row computes; the caller commits nothing for a finished one). Returns
    (logits (B, W, V) fp32, the cache)."""
    B, W = token_ids.shape
    x = policy.cast(embed_tokens(params, token_ids))
    positions = cache["lengths"][:, None] + torch.arange(W, device=x.device)[None, :]
    x = x + policy.cast(params["wpe"][torch.clamp(positions, 0, cfg.n_positions - 1)])
    T = cache["k"].shape[2]
    # no slot at or past the longest row is visible: attend over [0, t_hi)
    t_hi = int(cache["lengths"].max())
    x, news = dc.decode_scan(params["layers"], cache, x, _verify_layer_fn(
        cfg, cache["kv_mask"][:, :t_hi], t_hi, None, policy, kernels))
    dc.write_new_kv_ragged_multi(cache, news, torch.clamp(positions, 0, T - 1))
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(params["wte"]).T), cache


def lm_head_table(params: dict, cfg: GPTBigCodeConfig) -> torch.Tensor:
    return params["wte"]  # tied


def _chunk_nll(h: torch.Tensor, y: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum of -log p(y) over the chunk's non-ignored targets; fp32 logits
    straight from the fp32 accumulator."""
    logp = torch.log_softmax(matmul_f32(h, table.T), dim=-1)
    valid = y != -100
    ll = torch.gather(logp, -1, torch.where(valid, y, 0)[..., None])[..., 0]
    return torch.where(valid, -ll, 0.0).sum()


def causal_lm_loss_fused(
    head_table: torch.Tensor,  # (V, E) tied lm head
    hidden: torch.Tensor,      # (B, S, E) final hidden states
    labels: torch.Tensor,      # (B, S) int, -100 = ignored
    *,
    policy: DTypePolicy = DTypePolicy(),
    chunk: int = 128,
) -> torch.Tensor:
    """Shift-by-one cross entropy with the LM head fused into chunks of
    `chunk` positions, each chunk checkpointed so that the backward
    recomputes its logits: the (B, S, V) fp32 logits and their gradient never
    exist at once. Mean over the non-ignored targets."""
    h = policy.cast(hidden[:, :-1])
    y = labels[:, 1:].long()
    S = h.shape[1]
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=-100)
    table = policy.cast(head_table)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S + pad, chunk):
        total = total + checkpoint(_chunk_nll, h[:, c:c + chunk], y[:, c:c + chunk], table,
                                   use_reentrant=False)
    return total / (y != -100).sum().clamp_min(1)


def _chunk_logprobs(h: torch.Tensor, y: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """log p(y) of the chunk's ids; fp32 logits from the fp32 accumulator."""
    logp = torch.log_softmax(matmul_f32(h, table.T), dim=-1)
    return torch.gather(logp, -1, y[..., None])[..., 0]


def token_logprobs_fused(
    head_table: torch.Tensor,  # (V, E) tied lm head
    hidden: torch.Tensor,      # (B, S, E) hidden states at the predicting positions
    ids: torch.Tensor,         # (B, S) realized ids
    *,
    policy: DTypePolicy = DTypePolicy(),
    chunk: int = 128,
) -> torch.Tensor:
    """Per-token log-probs (B, S) fp32 of the realized ids, the LM head
    fused into chunks of `chunk` positions, each checkpointed so that the
    backward recomputes its logits (as causal_lm_loss_fused): the
    (B, S, V) fp32 logits never exist at once."""
    h = policy.cast(hidden)
    table = policy.cast(head_table)
    y = ids.long()
    return torch.cat([checkpoint(_chunk_logprobs, h[:, c:c + chunk], y[:, c:c + chunk], table,
                                 use_reentrant=False)
                      for c in range(0, h.shape[1], chunk)], dim=1)
