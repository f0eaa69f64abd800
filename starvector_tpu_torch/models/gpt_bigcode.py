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

The ragged cache (per-row lengths) serves the continuous-batching engine
(serve/engine.py): `forward_ragged_decode` is one decode step with every
row at its own position (kernel 2 with a per-row key mask), and
`forward_ragged_verify` is speculative decoding's verify, each row's W
tokens at its own positions through the chunk step's attention. Both take
the slots any row may see as host integers (`key_bounds`), so a step makes
no host transfer; without them they read the bounds from `lengths`. A
verify given (0, t_cap) is the static verify of speculative decoding's
captured rounds.

The static steps take their write slots as device int32 tensors and read
nothing on the host, so that their launches are the same from one step to
the next and the loops replay them as CUDA graphs: `forward_decode_static`
(a decode step), `forward_chunk_static` (the chunk step over a key span
fixed per graph) and the offline pipelined engine's two fused forwards
(generation/engine.py::generate_pipelined and
generation/speculative.py::generate_pipelined_spec),
`forward_decode_with_chunk_static` (a decode step of the current batch and a
chunk of the next batch's prompt) and
`forward_ragged_verify_with_chunk_static` (a speculative verify and a
chunk), each one pass over the layers with the projections shared by both
row groups; the decode half is kernel 2, the chunk and the verify the chunk
step's attention. `forward_decode_with_chunk` and
`forward_ragged_verify_with_chunk` run them at the caches' host indices.

Without a cache, `forward` is the training forward: each layer's attention
is `flash_prefill_trainable` (the forward-with-lse kernel and the backward
pair behind one autograd Function), with activation checkpointing per
`remat` (see `_train_block`). The loss is `causal_lm_loss_fused`, the tied
head fused into chunks whose logits are recomputed in the backward;
`token_logprobs_fused` gives GRPO's per-token log-probs the same way. On a
sequence-parallel layout the training forward splits the positions after
wpe and each rank runs its chunk, its attention through
parallel/sequence.py::sp_flash_attention; on a stage mesh the layers run
through parallel/pipeline.py::pipeline_layers (GPipe over the stage ranks,
each its block of the layers; the plain loop elsewhere).

On a serving layout (parallel/zero.py; a serving mesh with fsdp, sequence
or stage above 1) every cached path gathers each layer whole just before
it reads it (zero.layer_at: a stage's layer from its owner, fsdp shards
all-gathered) and `wte`, `wpe` and `ln_f` where it reads them
(zero.gathered), and drops them after. Off a layout both are the plain
views.

The config's resid/embd/attn dropout fields are declared and never applied,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from starvector_tpu_torch.models import decode_common as dc
from starvector_tpu_torch.parallel.mesh import BATCH_AXES, P
from starvector_tpu_torch.parallel import pipeline, sequence, zero
from starvector_tpu_torch.parallel.tensor import copy_to_group
from starvector_tpu_torch.parallel.zero import gathered
from starvector_tpu_torch.ops.flash_attention import (
    flash_prefill, merged_decode_attention,
)
from starvector_tpu_torch.ops.layers import (
    DTypePolicy, dense, gelu_tanh, layer_norm, make_dense_params,
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


@dataclasses.dataclass(frozen=True)
class GPTBigCodeRankConfig(GPTBigCodeConfig):
    """The decoder of one tensor-parallel rank (tensor_config): its own
    query heads (n_head) and MLP columns (n_inner), the whole model's
    hidden size and head size."""
    head_size: int = 128

    @property
    def head_dim(self) -> int:
        return self.head_size


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


def partition_rules() -> list[tuple[str, P]]:
    """Path regex -> PartitionSpec, the JAX package's list (the leading
    layer axis of a stacked leaf is "stage"): c_attn and c_fc
    column-parallel (out dim on "tensor"), c_proj row-parallel (in dim on
    "tensor"); the embedding tables over fsdp only."""
    return [
        (r"wte$|wpe$", P("fsdp", None)),
        (r"layers/.*c_attn/kernel", P("stage", "fsdp", "tensor")),
        (r"layers/.*c_attn/bias", P("stage", "tensor")),
        (r"layers/.*attn/c_proj/kernel", P("stage", "tensor", "fsdp")),
        (r"layers/.*attn/c_proj/bias", P("stage", None)),
        (r"layers/.*c_fc/kernel", P("stage", "fsdp", "tensor")),
        (r"layers/.*c_fc/bias", P("stage", "tensor")),
        (r"layers/.*mlp/c_proj/kernel", P("stage", "tensor", "fsdp")),
        (r"layers/.*mlp/c_proj/bias", P("stage", None)),
        (r"layers/.*ln_[12]/", P("stage", None)),
        (r"ln_f/", P(None)),
    ]


def tensor_units(cfg: GPTBigCodeConfig, tp: int, rank: int) -> dict:
    """Tensor rank `rank` of tp's ranges along each projection's split
    dimension (partition_rules' "tensor" entries; parallel/tensor.py::
    leaf_slice): c_attn's columns are this rank's whole query heads
    (head_layout), then its KV heads' K columns and V columns (the 1B's one
    KV head: K and V whole on every rank, one range), attn/c_proj's rows the
    same query heads, and a contiguous 1/tp of c_fc's columns and
    mlp/c_proj's rows."""
    from starvector_tpu_torch.parallel.tensor import even_split, head_layout

    D, Hkv = cfg.head_dim, cfg.kv_heads
    E = cfg.n_head * D
    h = head_layout(cfg.n_head, Hkv, tp)[rank]
    q = (h.q_start * D, h.q_count * D)
    k = (E + h.kv_start * D, h.kv_count * D)
    v = (E + (Hkv + h.kv_start) * D, h.kv_count * D)
    qkv = [q, (k[0], 2 * k[1])] if k[0] + k[1] == v[0] else [q, k, v]
    mlp = even_split(cfg.inner_dim, tp, rank)
    return {"c_attn": qkv, "attn/c_proj": q, "c_fc": mlp, "mlp/c_proj": mlp}


def tensor_config(cfg: GPTBigCodeConfig, tp: int, rank: int) -> "GPTBigCodeRankConfig":
    """The config of tensor rank `rank`'s decoder: its own query heads over
    the whole KV head, and 1/tp of the MLP; hidden size, head size,
    positions and vocabulary whole."""
    from starvector_tpu_torch.parallel.tensor import head_layout

    h = head_layout(cfg.n_head, cfg.kv_heads, tp)[rank]
    _, inner = tensor_units(cfg, tp, rank)["c_fc"]
    whole = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(GPTBigCodeConfig)}
    return GPTBigCodeRankConfig(**{**whole, "n_head": h.q_count, "n_inner": inner},
                                head_size=cfg.head_dim)


def init_cache(cfg: GPTBigCodeConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    return dc.init_cache(cfg.n_layer, cfg.kv_heads, cfg.head_dim, batch, max_len,
                         dtype, device)


def cache_partition_rules() -> list[tuple[str, P]]:
    """The KV cache's specs (the JAX package's): rows over the batch axes."""
    return [(r"k$|v$", P(None, BATCH_AXES, None, None, None)),
            (r"k_scale$|v_scale$", P(None, BATCH_AXES, None, None)),
            (r"kv_mask$", P(BATCH_AXES, None)),
            (r"index$", P())]


def compute_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """cumsum(mask) - 1, masked positions pinned to 1."""
    pos = torch.cumsum(attention_mask, dim=-1) - 1
    return torch.where(attention_mask == 0, torch.ones_like(pos), pos)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return gathered(params["wte"])[input_ids]


def _split_qkv(cfg: GPTBigCodeConfig, qkv: torch.Tensor):
    """Views of the fused projection (..., H*D + 2*Hkv*D): q (..., H*D), k
    and v (..., Hkv*D). H*D is the hidden size but on a tensor rank, which
    holds fewer query heads."""
    E, kvd = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    return qkv[..., :E], qkv[..., E:E + kvd], qkv[..., E + kvd:]


def _mlp(p: dict, cfg: GPTBigCodeConfig, x: torch.Tensor, policy: DTypePolicy,
         kernels: bool = True):
    h = copy_to_group(layer_norm(p["ln_2"], x, cfg.layer_norm_epsilon))
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
    x = x + dense(p["attn"]["c_proj"], out.reshape(B, S, H * D), policy, kernels=kernels)
    return _mlp(p, cfg, x, policy, kernels)


def _decode_layer_fn(cfg: GPTBigCodeConfig, old_mask, idx: int | None, policy, kernels: bool,
                     bounds: torch.Tensor | None = None, t_cap: int | None = None):
    """Per-layer single-token decode for decode_common.decode_scan: ln_1 ->
    fused c_attn split -> merged-softmax attention (kernel 2) over the
    cache's first idx slots (with their scales for an int8 cache) ->
    residual MLP. idx None: the whole cache, its visible slots kernel 2's
    device `bounds` (a static step), t_cap their host cap."""
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
            bounds=bounds, t_cap=t_cap, kernels=kernels,
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
    down-projection output; here the post-attention part recomputes it.

    On a ZeRO-3 layout each part gathers its own weights first
    (parallel/zero.py), inside its checkpoint, so that the backward gathers
    them again rather than keep them. On a tensor-parallel layout `cfg` is
    the rank's (tensor_config): ln_1's and ln_2's outputs enter their
    column-parallel projections through parallel/tensor.py::copy_to_group,
    and c_proj's partials are summed in dense."""
    B, S, E = x.shape
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads

    def pre(x):
        g = gathered({"ln_1": p["ln_1"], "c_attn": p["attn"]["c_attn"]}, policy)
        h = copy_to_group(layer_norm(g["ln_1"], x, cfg.layer_norm_epsilon))
        return (dense(g["c_attn"], h, policy, tag="dense_qkv_out"),)

    def attend(qkv):
        q, k, v = _split_qkv(cfg, qkv)
        return sequence.sp_flash_attention(q.unflatten(-1, (H, D)), k.unflatten(-1, (Hkv, D)),
                                           v.unflatten(-1, (Hkv, D)), kv_mask, kernels=kernels)

    def post(x, attn):
        g = gathered({"c_proj": p["attn"]["c_proj"], "ln_2": p["ln_2"], "mlp": p["mlp"]}, policy)
        x = x + dense(g["c_proj"], attn.reshape(B, S, H * D), policy)
        return _mlp(g, cfg, x, policy)

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
    x = x + policy.cast(gathered(params["wpe"])[position_ids])
    span = sequence.split_sequence(S)  # a sequence-parallel rank's chunk of positions
    if span is not None:
        x = x[:, span[0]:span[1]]
    x = pipeline.pipeline_layers(
        params["layers"], x, {"kv_mask": kv_mask},
        lambda h, layer, a: _train_block(layer, cfg, h, a["kv_mask"], policy, remat, kernels))
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    if return_hidden:
        return x, None
    if last_logits_only:
        x = x[:, -1:]
    return matmul_f32(policy.cast(x), policy.cast(gathered(params["wte"])).T), None


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
    `return_hidden`, None); on a sequence-parallel split those of this
    rank's chunk of the positions (parallel/sequence.py::chunk_span).

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
    x = x + policy.cast(gathered(params["wpe"])[position_ids])

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
            x = _prefill_block(zero.layer_at(layers, i), cfg, x, dc.layer_cache(cache, i),
                               kv_mask, idx, policy, kernels)
    cache["index"] = idx + S

    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    if return_hidden:
        return x, cache
    if last_logits_only:
        x = x[:, -1:]
    # tied head: compute-dtype operands, fp32 logits straight from the fp32
    # accumulator (never rounded to bf16, which would tie near-equal logits)
    logits = matmul_f32(policy.cast(x), policy.cast(gathered(params["wte"])).T)
    return logits, cache


def forward_decode_static(params: dict, cfg: GPTBigCodeConfig, inputs_embeds: torch.Tensor,
                          cache: dict, pos: torch.Tensor, *, t_cap: int,
                          policy: DTypePolicy = DTypePolicy(), kernels: bool = True):
    """The cached decode step (forward's S == 1 branch) with nothing on the
    host: the new token (B, 1, E) goes to slot `pos`, an int32 (1,) device
    tensor, at the position its row's key mask counts; kernel 2 reads the
    whole cache with the device bounds [0, pos], its grid planned at t_cap
    >= pos (decode_common.static_decode_slots); the new k/v are written at
    pos after the layers. The caller advances pos. Every launch is the same
    from one step to the next, so generate replays these steps as a CUDA
    graph. Returns the logits (B, V) fp32; the cache changes in place (its
    host `index` is not read or moved)."""
    x = policy.cast(inputs_embeds)
    positions, bounds = dc.static_decode_slots(cache, pos, None)
    position_ids = torch.clamp(positions[:, None], 0, cfg.n_positions - 1)
    x = x + policy.cast(gathered(params["wpe"])[position_ids])
    x, news = dc.decode_scan(params["layers"], cache, x, _decode_layer_fn(
        cfg, cache["kv_mask"], None, policy, kernels, bounds=bounds, t_cap=t_cap))
    dc.write_new_kv_static(cache, news, pos)
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(gathered(params["wte"])).T)[:, 0]


def init_ragged_cache(cfg: GPTBigCodeConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cpu") -> dict:
    """Cache with per-row lengths (decode_common.init_ragged_cache)."""
    return dc.init_ragged_cache(cfg.n_layer, cfg.kv_heads, cfg.head_dim, batch, max_len,
                                dtype, device)


def forward_ragged_decode(params: dict, cfg: GPTBigCodeConfig, token_ids: torch.Tensor,
                          cache: dict, active: torch.Tensor, *,
                          policy: DTypePolicy = DTypePolicy(), kernels: bool = True,
                          key_bounds: tuple[int, int] | None = None):
    """One decode step where every row sits at its own position (the JAX
    forward_ragged_decode, the continuous-batching hot path): token_ids
    (B,), positions wpe[lengths], each row's new k/v written at its length
    after the layers, `lengths += active`. Attention is kernel 2
    (merged_decode_attention) over the slots [0, t_hi) with the per-row key
    mask; a row that is not active computes but neither shows its slot nor
    advances. `key_bounds` (t_lo, t_hi): the slots any row may see, from
    the caller (t_lo is unused without a window). Returns (logits (B, V)
    fp32, the cache, updated in place)."""
    table = gathered(params["wte"])
    x = policy.cast(table[token_ids[:, None]])  # (B, 1, E)
    positions = torch.clamp(cache["lengths"], 0, cfg.n_positions - 1)[:, None]
    x = x + policy.cast(gathered(params["wpe"])[positions])
    write_pos, _, old_mask = dc.ragged_step_masks(cache, active, None)
    t_hi = dc.ragged_key_bounds(cache, key_bounds)[1]
    x, news = dc.decode_scan(params["layers"], cache, x, _decode_layer_fn(
        cfg, old_mask[:, :t_hi], t_hi, policy, kernels))
    dc.write_new_kv_ragged(cache, news, write_pos)
    dc.ragged_step_commit(cache, active, write_pos)
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(table).T)[:, 0], cache


def forward_ragged_decode_static(params: dict, cfg: GPTBigCodeConfig, token_ids: torch.Tensor,
                                 cache: dict, active: torch.Tensor, *, t_cap: int,
                                 policy: DTypePolicy = DTypePolicy(), kernels: bool = True):
    """forward_ragged_decode with nothing on the host (the serving engine's
    captured tick): kernel 2 reads the whole cache with the key bounds the
    rows' lengths give on the device (decode_common.ragged_static_masks),
    its grid planned at t_cap, at least every active row's length; the key
    mask and lengths are written in place. Returns (B, V) fp32 logits."""
    table = gathered(params["wte"])
    x = policy.cast(table[token_ids[:, None]])  # (B, 1, E)
    positions = torch.clamp(cache["lengths"], 0, cfg.n_positions - 1)[:, None]
    x = x + policy.cast(gathered(params["wpe"])[positions])
    write_pos, old_mask, bounds = dc.ragged_static_masks(cache, active, None)
    x, news = dc.decode_scan(params["layers"], cache, x, _decode_layer_fn(
        cfg, old_mask, None, policy, kernels, bounds=bounds, t_cap=t_cap))
    dc.write_new_kv_ragged(cache, news, write_pos)
    dc.ragged_step_commit(cache, active, write_pos)
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(table).T)[:, 0]


def forward_ragged_verify(params: dict, cfg: GPTBigCodeConfig, token_ids: torch.Tensor,
                          cache: dict, *, policy: DTypePolicy = DTypePolicy(),
                          kernels: bool = True, key_bounds: tuple[int, int] | None = None):
    """Speculative verify over a ragged cache: each row's W tokens (B, W)
    ([last accepted ‖ drafts]) at positions lengths + [0, W), attending to
    the row's visible slots and causally to its own chunk (the chunk step's
    merged_verify_attention). The chunk's k/v are written at those slots
    in place; `lengths` and `kv_mask` are left for
    decode_common.commit_verify, which shows only the accepted ones (every
    row computes; the caller commits nothing for a finished one). Returns
    (logits (B, W, V) fp32, the cache). `key_bounds` as in
    forward_ragged_decode."""
    B, W = token_ids.shape
    table = gathered(params["wte"])
    x = policy.cast(table[token_ids])
    positions = cache["lengths"][:, None] + torch.arange(W, device=x.device)[None, :]
    x = x + policy.cast(gathered(params["wpe"])[torch.clamp(positions, 0, cfg.n_positions - 1)])
    T = cache["k"].shape[2]
    # no slot at or past the longest row is visible: attend over [0, t_hi)
    t_hi = dc.ragged_key_bounds(cache, key_bounds)[1]
    x, news = dc.decode_scan(params["layers"], cache, x, _verify_layer_fn(
        cfg, cache["kv_mask"][:, :t_hi], t_hi, None, policy, kernels))
    dc.write_new_kv_ragged_multi(cache, news, torch.clamp(positions, 0, T - 1))
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    return matmul_f32(policy.cast(x), policy.cast(table).T), cache


def forward_chunk_static(params: dict, cfg: GPTBigCodeConfig, inputs_embeds: torch.Tensor,
                         attention_mask: torch.Tensor, cache: dict, idx: torch.Tensor, *,
                         t_cap: int, policy: DTypePolicy = DTypePolicy(), kernels: bool = True,
                         return_hidden: bool = False, last_logits_only: bool = False):
    """The cached chunk step (forward's 1 < S <= 64 branch) with nothing on
    the host: the C new tokens (B, C, E) with their mask (B, C) go to slots
    idx + [0, C), `idx` an int32 (1,) device tensor, at the positions their
    rows' key masks count; their queries attend over the key span [0,
    t_cap) (t_cap >= idx, generation/engine.py::chunk_cap), the slots below idx
    that the key mask shows, and causally over the chunk's real keys
    (merged_verify_attention); the chunk's k/v are written after the
    layers. The caller advances idx. Returns the logits (B, C|1, V) fp32, or
    the final hidden states (B, C, E) if `return_hidden`; the cache changes
    in place (its host `index` is not read or moved)."""
    x = policy.cast(inputs_embeds)
    positions, old_mask, slots = dc.static_chunk_slots(cache, idx, attention_mask, t_cap, None)
    x = x + policy.cast(gathered(params["wpe"])[torch.clamp(positions, 0, cfg.n_positions - 1)])
    x, news = dc.decode_scan(params["layers"], cache, x, _verify_layer_fn(
        cfg, old_mask, t_cap, attention_mask.to(torch.int32), policy, kernels))
    dc.write_new_kv_slots(cache, news, slots)
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    if return_hidden:
        return x
    if last_logits_only:
        x = x[:, -1:]
    return matmul_f32(policy.cast(x), policy.cast(gathered(params["wte"])).T)


def _cached_slots(layer_cache: dict, t: int) -> tuple:
    """(k, v, k_scale, v_scale) of a layer's cache over the slots [0, t);
    the scales None for a bf16/fp32 cache."""
    return tuple(layer_cache[key][:, :t] if key in layer_cache else None
                 for key in dc.PAYLOAD_KEYS)


def _chunk_side(wpe: torch.Tensor, cfg: GPTBigCodeConfig, cache_next: dict,
                chunk_embeds: torch.Tensor, chunk_mask: torch.Tensor, idx: torch.Tensor,
                chunk_cap: int, policy: DTypePolicy):
    """The next batch's chunk in a fused forward, as the static chunk step
    derives it (decode_common.static_chunk_slots; `wpe` the whole position
    table): its mask written at the device index idx. Returns (x (B, C, E)
    with wpe added, the visible old slots (B, chunk_cap), the chunk's mask
    (B, C) int32, its slots (C,))."""
    chunk_mask = chunk_mask.to(torch.int32)
    pos, old_mask, slots = dc.static_chunk_slots(cache_next, idx, chunk_mask, chunk_cap, None)
    x = policy.cast(chunk_embeds) + policy.cast(wpe[torch.clamp(pos, 0, cfg.n_positions - 1)])
    return x, old_mask, chunk_mask, slots


def _fused_scan(params: dict, cfg: GPTBigCodeConfig, x: torch.Tensor, W: int, cache: dict,
                attend, cache_next: dict, old_mask_c: torch.Tensor, chunk_mask: torch.Tensor,
                chunk_cap: int, policy: DTypePolicy, kernels: bool):
    """The fused forwards' layer loop over x (B, W + C, E): each layer's
    LayerNorms and projections run once over all rows (one weight read, the
    point of fusing; kernel 14 for a quantized leaf); rows [0, W) attend by
    `attend(q (B, W, Hkv, G, D), k, v (B, W, Hkv, D), layer cache) ->
    (B, W, H*D)` over `cache`, rows [W, W + C), the next batch's chunk,
    through merged_verify_attention over the key span [0, chunk_cap) of
    cache_next (`old_mask_c` its visible slots) and causally over the
    chunk's real keys. Returns (x, the W rows' emitted k/v, the chunk's),
    each stacked over the layers for the write after them
    (decode_common.emitted_kv)."""
    H, D, Hkv = cfg.n_head, cfg.head_dim, cfg.kv_heads
    quant = "k_scale" in cache
    ka, va, kc, vc = [], [], [], []
    for i in range(cfg.n_layer):
        p = zero.layer_at(params["layers"], i)
        hh = layer_norm(p["ln_1"], x, cfg.layer_norm_epsilon)
        q, k, v = _split_qkv(cfg, dense(p["attn"]["c_attn"], hh, policy, kernels=kernels))
        q = q.unflatten(-1, (Hkv, H // Hkv, D))
        k, v = k.unflatten(-1, (Hkv, D)), v.unflatten(-1, (Hkv, D))
        out_a = attend(q[:, :W], k[:, :W], v[:, :W], dc.layer_cache(cache, i))
        k_c, v_c, ks, vs = _cached_slots(dc.layer_cache(cache_next, i), chunk_cap)
        out_c = dc.merged_verify_attention(q[:, W:].movedim(1, 3), k[:, W:], v[:, W:], k_c, v_c,
                                           old_mask_c, D**-0.5, ks, vs, new_mask=chunk_mask)
        x = x + dense(p["attn"]["c_proj"], torch.cat([out_a, out_c], dim=1), policy,
                      kernels=kernels)
        x = _mlp(p, cfg, x, policy, kernels)
        ka.append(k[:, :W])
        va.append(v[:, :W])
        kc.append(k[:, W:])
        vc.append(v[:, W:])
    return x, dc.emitted_kv(ka, va, quant), dc.emitted_kv(kc, vc, quant)


def _check_cache_types(cache: dict, cache_next: dict, what: str) -> None:
    if ("k_scale" in cache) != ("k_scale" in cache_next):
        raise ValueError(f"fused {what}+chunk: cache dtypes must match")


def _host_index(cache: dict, n: int, device) -> torch.Tensor:
    """A linear cache's host index as the int32 (1,) device tensor a static
    step takes, after checking that n more tokens fit."""
    idx, T = cache["index"], cache["k"].shape[2]
    if idx + n > T:
        raise ValueError(f"cache of {T} slots cannot take {n} tokens at index {idx}")
    return torch.tensor([idx], dtype=torch.int32, device=device)


def forward_decode_with_chunk_static(
    params: dict,
    cfg: GPTBigCodeConfig,
    dec_embeds: torch.Tensor,    # (B, 1, E) the next token's embeds (wpe added here)
    cache: dict,                 # the current batch's linear cache
    pos: torch.Tensor,           # int32 (1,): its write slot
    chunk_embeds: torch.Tensor,  # (B, C, E) a chunk of the next batch's prompt
    chunk_mask: torch.Tensor,    # (B, C)
    cache_next: dict,            # the next batch's linear cache, being prefilled
    idx: torch.Tensor,           # int32 (1,): its write index
    *,
    t_cap: int,
    chunk_cap: int,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
    chunk_logits: bool = False,
):
    """One pass over the layers that decodes the current batch and
    prefills a chunk of the next batch's prompt, with nothing on the host
    (the JAX forward_decode_with_chunk; generation/engine.py::
    generate_pipelined): the projections run once over the (B, 1 + C)
    rows. The decode row is forward_decode_static's (slot pos, kernel 2
    over the whole cache with the device bounds [0, pos], its grid planned
    at t_cap); the chunk is forward_chunk_static's (slots idx + [0, C),
    merged_verify_attention over the key span [0, chunk_cap)). With int8
    caches (both, or ValueError) the new k/v are quantized on write. Both
    caches are written in place; the caller advances pos and idx.

    Returns (decode logits (B, V) fp32, the chunk's last-position logits
    (B, V) fp32: JAX's chunk_logits[:, -1], the only position the stream
    reads, None unless `chunk_logits`)."""
    _check_cache_types(cache, cache_next, "decode")
    D = cfg.head_dim
    positions, bounds = dc.static_decode_slots(cache, pos, None)
    wpe = gathered(params["wpe"])
    x_d = policy.cast(dec_embeds) + policy.cast(
        wpe[torch.clamp(positions[:, None], 0, cfg.n_positions - 1)])
    x_c, old_mask_c, chunk_mask, slots_c = _chunk_side(wpe, cfg, cache_next, chunk_embeds,
                                                       chunk_mask, idx, chunk_cap, policy)
    kv_mask = cache["kv_mask"]

    def attend(q, k, v, layer_cache):
        k_c, v_c, ks, vs = (layer_cache.get(key) for key in dc.PAYLOAD_KEYS)
        return merged_decode_attention(q[:, 0], k[:, 0], v[:, 0], k_c, v_c, kv_mask, D**-0.5,
                                       ks, vs, bounds=bounds, t_cap=t_cap, kernels=kernels)

    x, news, news_c = _fused_scan(params, cfg, torch.cat([x_d, x_c], dim=1), 1, cache, attend,
                                  cache_next, old_mask_c, chunk_mask, chunk_cap, policy, kernels)
    dc.write_new_kv_slots(cache, news, pos.long())
    dc.write_new_kv_slots(cache_next, news_c, slots_c)
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    table = policy.cast(gathered(params["wte"])).T
    dec_logits = matmul_f32(policy.cast(x[:, 0]), table)
    last = matmul_f32(policy.cast(x[:, -1]), table) if chunk_logits else None
    return dec_logits, last


def forward_decode_with_chunk(
    params: dict,
    cfg: GPTBigCodeConfig,
    dec_embeds: torch.Tensor,    # (B, 1, E) the next token's embeds (wpe added here)
    cache: dict,                 # the current batch's linear cache
    chunk_embeds: torch.Tensor,  # (B, C, E) a chunk of the next batch's prompt
    chunk_mask: torch.Tensor,    # (B, C)
    cache_next: dict,            # the next batch's linear cache, being prefilled
    *,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
    chunk_logits: bool = True,
):
    """forward_decode_with_chunk_static at the caches' host indices (the
    JAX forward_decode_with_chunk's contract): the decode row's keys are the
    first index slots of `cache`, the chunk's the first index slots of
    cache_next. Both indices advance, by 1 and C.

    Returns (decode logits (B, V) fp32, cache, the chunk's last-position
    logits (B, V) fp32, None unless `chunk_logits`, cache_next)."""
    _check_cache_types(cache, cache_next, "decode")
    device = dec_embeds.device
    C = chunk_embeds.shape[1]
    pos, idx = _host_index(cache, 1, device), _host_index(cache_next, C, device)
    dec_logits, last = forward_decode_with_chunk_static(
        params, cfg, dec_embeds, cache, pos, chunk_embeds, chunk_mask, cache_next, idx,
        t_cap=cache["index"] + 1, chunk_cap=cache_next["index"], policy=policy,
        kernels=kernels, chunk_logits=chunk_logits)
    cache["index"] += 1
    cache_next["index"] += C
    return dec_logits, cache, last, cache_next


def forward_ragged_verify_with_chunk_static(
    params: dict,
    cfg: GPTBigCodeConfig,
    token_ids: torch.Tensor,     # (B, W) [pending token ‖ drafts]
    cache: dict,                 # the current batch's ragged cache
    chunk_embeds: torch.Tensor,  # (B, C, E) a chunk of the next batch's prompt
    chunk_mask: torch.Tensor,    # (B, C) right-padded rows: 1 = a real token
    cache_next: dict,            # the next batch's linear cache, being prefilled
    idx: torch.Tensor,           # int32 (1,): its write index
    *,
    t_cap: int,
    chunk_cap: int,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
):
    """One pass over the layers that verifies the current batch's W-token
    proposals and prefills a chunk of the next batch's prompt, with nothing
    on the host (the JAX forward_ragged_verify_with_chunk;
    generation/speculative.py::generate_pipelined_spec). The verify side is
    forward_ragged_verify's over the key span [0, t_cap) (t_cap at least
    every row's length; each row's key mask hides the rest): each row at
    its own positions lengths + [0, W), its k/v written there, lengths and
    kv_mask left for decode_common.commit_verify. The chunk side is
    forward_chunk_static's at the device index idx over the key span [0,
    chunk_cap). The projections run once over the (B, W + C) rows; both
    attentions are merged_verify_attention, int8 scales folded in (both
    caches int8, or ValueError). The caller advances idx.

    Returns (verify logits (B, W, V) fp32, the chunk's final hidden states
    (B, C, E) after ln_f: the caller projects only the positions it
    needs)."""
    _check_cache_types(cache, cache_next, "verify")
    W = token_ids.shape[1]
    D = cfg.head_dim
    positions = cache["lengths"][:, None] + torch.arange(W, device=token_ids.device)[None, :]
    table, wpe = gathered(params["wte"]), gathered(params["wpe"])
    x_v = policy.cast(table[token_ids]) + policy.cast(
        wpe[torch.clamp(positions, 0, cfg.n_positions - 1)])
    T = cache["k"].shape[2]
    t_cap = min(t_cap, T)
    old_mask = cache["kv_mask"][:, :t_cap]
    x_c, old_mask_c, chunk_mask, slots_c = _chunk_side(wpe, cfg, cache_next, chunk_embeds,
                                                       chunk_mask, idx, chunk_cap, policy)

    def attend(q, k, v, layer_cache):
        k_c, v_c, ks, vs = _cached_slots(layer_cache, t_cap)
        return dc.merged_verify_attention(q.movedim(1, 3), k, v, k_c, v_c, old_mask, D**-0.5,
                                          ks, vs)

    x, news, news_c = _fused_scan(params, cfg, torch.cat([x_v, x_c], dim=1), W, cache, attend,
                                  cache_next, old_mask_c, chunk_mask, chunk_cap, policy, kernels)
    dc.write_new_kv_ragged_multi(cache, news, torch.clamp(positions, 0, T - 1))
    dc.write_new_kv_slots(cache_next, news_c, slots_c)
    x = layer_norm(gathered(params["ln_f"]), x, cfg.layer_norm_epsilon)
    logits = matmul_f32(policy.cast(x[:, :W]), policy.cast(table).T)
    return logits, x[:, W:]


def forward_ragged_verify_with_chunk(
    params: dict,
    cfg: GPTBigCodeConfig,
    token_ids: torch.Tensor,     # (B, W) [pending token ‖ drafts]
    cache: dict,                 # the current batch's ragged cache
    chunk_embeds: torch.Tensor,  # (B, C, E) a chunk of the next batch's prompt
    chunk_mask: torch.Tensor,    # (B, C) right-padded rows: 1 = a real token
    cache_next: dict,            # the next batch's linear cache, being prefilled
    *,
    policy: DTypePolicy = DTypePolicy(),
    kernels: bool = True,
):
    """forward_ragged_verify_with_chunk_static with the verify's key span
    read from `lengths` (a host transfer) and the chunk at cache_next's host
    index, which advances by C (the JAX forward_ragged_verify_with_chunk's
    contract).

    Returns (verify logits (B, W, V) fp32, cache, the chunk's final hidden
    states (B, C, E) after ln_f, cache_next)."""
    C = chunk_embeds.shape[1]
    idx = _host_index(cache_next, C, token_ids.device)
    logits, h = forward_ragged_verify_with_chunk_static(
        params, cfg, token_ids, cache, chunk_embeds, chunk_mask, cache_next, idx,
        t_cap=dc.ragged_key_bounds(cache, None)[1], chunk_cap=cache_next["index"],
        policy=policy, kernels=kernels)
    cache_next["index"] += C
    return logits, cache, h, cache_next


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
    shifted: bool = False,
) -> torch.Tensor:
    """Shift-by-one cross entropy with the LM head fused into chunks of
    `chunk` positions, each chunk checkpointed so that the backward
    recomputes its logits: the (B, S, V) fp32 logits and their gradient never
    exist at once. Mean over the non-ignored targets; on a data-parallel
    layout over those of the global batch (the count summed over the ranks
    that split the step, zero.batch_sum), so that the ranks' losses add up
    to the one-process loss. `shifted`: labels[:, p] is already the target
    of hidden[:, p] (a sequence-parallel chunk's, shifted over the whole
    sequence)."""
    h = policy.cast(hidden if shifted else hidden[:, :-1])
    y = (labels if shifted else labels[:, 1:]).long()
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
    return total / zero.batch_sum((y != -100).sum()).clamp_min(1)


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
    # at least one chunk, empty for S = 0, so that the result hangs off hidden
    return torch.cat([checkpoint(_chunk_logprobs, h[:, c:c + chunk], y[:, c:c + chunk], table,
                                 use_reentrant=False)
                      for c in range(0, max(h.shape[1], 1), chunk)], dim=1)
