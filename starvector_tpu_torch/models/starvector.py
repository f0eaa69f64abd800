"""StarVector task model, im2svg: vision tower + adapter + code-LLM
decoder (port of starvector_tpu/models/starvector.py).

v1, StarVector-1B: GPTBigCode decoder, CLIP tower (257 visual tokens).
v2, StarVector-8B: StarCoder2 decoder, SigLIP-384 tower (576 visual
tokens), LayerNorm adapter. `image_encoder_type` picks any of the seven
towers of models/image_encoder.py. Both infer and train, im2svg and
text2svg (a caption in, no vision tower: `text2svg_inputs`). Generation
lives in starvector_tpu_torch/generation/; `grpo_forward` gives the
per-token log-probs that train/grpo.py's policy gradient takes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from starvector_tpu_torch.models import adapter as adapter_mod
from starvector_tpu_torch.models import gpt_bigcode, image_encoder, starcoder2
from starvector_tpu_torch.models.vision.clip_vit import CLIPViTConfig
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel import zero
from starvector_tpu_torch.parallel.sequence import chunk_span
from starvector_tpu_torch.parallel.zero import gathered


DECODERS = {  # decoder -> (module, its full-size config)
    "gpt_bigcode": (gpt_bigcode, gpt_bigcode.GPTBigCodeConfig),
    "starcoder2": (starcoder2, starcoder2.StarCoder2Config),
}


@dataclasses.dataclass(frozen=True)
class StarVectorConfig:
    decoder: str = "gpt_bigcode"
    image_encoder_type: str = "clip"
    adapter_norm: str = "layer_norm"
    image_size: int = 224
    max_length_train: int = 8192
    task: str = "im2svg"
    llm: Any = None            # decoder geometry; None -> the family's (1B / 7B)
    vision_tower: Any = None   # tower geometry override (one of models/vision/'s configs)

    def __post_init__(self):
        if self.decoder not in DECODERS:
            raise ValueError(f"unknown decoder {self.decoder!r}; one of {sorted(DECODERS)}")
        if self.llm is None:
            object.__setattr__(self, "llm", DECODERS[self.decoder][1]())

    @property
    def decoder_module(self):
        """models.gpt_bigcode (v1) or models.starcoder2 (v2)."""
        return DECODERS[self.decoder][0]

    @property
    def use_image_encoder(self) -> bool:
        return self.task == "im2svg"

    @property
    def hidden_size(self) -> int:
        return self.llm.hidden_size

    @property
    def vision_geometry(self) -> tuple[int, int]:
        return image_encoder.ImageEncoderConfig(self.image_encoder_type, self.image_size).geometry

    @property
    def query_length(self) -> int:
        return self.vision_geometry[1] if self.use_image_encoder else 0

    @property
    def max_svg_length(self) -> int:
        # the JAX package's rule: minus the visual prefix and special tokens
        return self.max_length_train - self.query_length - 4

    @property
    def encoder_config(self) -> image_encoder.ImageEncoderConfig:
        return image_encoder.ImageEncoderConfig(self.image_encoder_type, self.image_size,
                                                tower=self.vision_tower)

    @property
    def adapter_config(self) -> adapter_mod.AdapterConfig:
        hidden, qlen = self.vision_geometry
        return adapter_mod.AdapterConfig(input_size=hidden, output_size=self.hidden_size,
                                         query_length=qlen, adapter_norm=self.adapter_norm)


def starvector_1b_config(**kw) -> StarVectorConfig:
    base = dict(
        decoder="gpt_bigcode",
        image_encoder_type="clip",
        adapter_norm="batch_norm",
    )
    base.update(kw)
    return StarVectorConfig(**base)


def starvector_8b_config(**kw) -> StarVectorConfig:
    """StarVector-8B: StarCoder2-7B decoder, SigLIP-large-patch16-384 tower,
    LayerNorm adapter (configs/models/starvector-8b/im2svg-stack.yaml)."""
    base = dict(
        decoder="starcoder2",
        image_encoder_type="siglip_384",
        adapter_norm="layer_norm",
        image_size=384,
        max_length_train=16000,
    )
    base.update(kw)
    return StarVectorConfig(**base)


def tiny_config(task: str = "im2svg", decoder: str = "gpt_bigcode", **kw) -> StarVectorConfig:
    base = dict(decoder=decoder, image_encoder_type="clip", image_size=28, max_length_train=128,
                task=task, llm=DECODERS[decoder][0].tiny_config())
    base.update(kw)
    return StarVectorConfig(**base)


def partition_rules() -> list[tuple[str, P]]:
    """The whole model's rules: each component's under its subtree."""
    rules: list[tuple[str, P]] = []
    for prefix, mod in (("svg_transformer/", gpt_bigcode), ("svg_transformer/", starcoder2),
                        ("image_encoder/", image_encoder), ("image_projection/", adapter_mod)):
        rules += [(prefix + pat.lstrip("^"), spec) for pat, spec in mod.partition_rules()]
    return rules


def serving_params(params: dict, cfg: StarVectorConfig, group) -> tuple[dict, StarVectorConfig]:
    """(params, cfg) of one rank of a serving group (parallel/tensor.py::
    ServingGroup): the decoder's shards and the config with the rank's
    decoder geometry (`tensor_config`). The decoder: its tensor slices
    (whole heads; the 1B's one KV head on every tensor rank), and on a
    group with a layout its stage block and fsdp (or fsdp x sequence)
    shards of them as the rules place them (parallel/sharding.py::
    shard_pytree): this rank's share of the JAX worker's placement, which
    the cached forwards gather at use. bf16/fp32, or int8 (a tree quantized
    whole: codes split as their kernel; scales whole, as no rule names
    them, but a tensor rank's columns).

    The vision tower and the adapter stay whole on the leader, which alone
    computes every request's prefix outside the engine's device calls (the
    JAX rules shard the tower over fsdp too); where the token table is
    split, the leader also keeps it whole as `prompt_decoder` (the prompt
    ids' embeddings, serve/worker.py). The followers hold no tower."""
    from starvector_tpu_torch.parallel import tensor
    from starvector_tpu_torch.parallel.sharding import shard_pytree

    dec = cfg.decoder_module
    tg = group.tensor
    whole = params["svg_transformer"]
    if group.layout is None:
        decoder = tensor.shard_tree(whole, dec.partition_rules(),
                                    dec.tensor_units(cfg.llm, tg.size, tg.rank), tg)
    else:
        units = [{"svg_transformer": dec.tensor_units(cfg.llm, tg.size, r)}
                 for r in range(tg.size)] if tg.size > 1 else None
        decoder = shard_pytree({"svg_transformer": whole}, partition_rules(), group.layout,
                               units)["svg_transformer"]
    out = {"svg_transformer": decoder}
    if group.is_leader:
        out.update({k: v for k, v in params.items() if k != "svg_transformer"})
        table = "wte" if "wte" in whole else "embed_tokens"
        if zero.sharded(decoder[table]) is not None:
            out["prompt_decoder"] = {table: whole[table]}
    return out, dataclasses.replace(cfg, llm=dec.tensor_config(cfg.llm, tg.size, tg.rank))


def tensor_units(cfg: StarVectorConfig, tp: int, rank: int) -> dict:
    """Tensor rank `rank` of tp's ranges of every split projection of the
    whole training tree, by its top-level key (parallel/sharding.py::
    shard_pytree): the decoder's (`tensor_units`: whole heads, the 1B's KV
    columns on every rank), the vision tower's and the adapter's."""
    units = {"svg_transformer": cfg.decoder_module.tensor_units(cfg.llm, tp, rank)}
    if cfg.use_image_encoder:
        enc, _ = _encoder_cfg(cfg)
        units["image_encoder"] = image_encoder.tensor_units(enc, tp, rank)
        units["image_projection"] = adapter_mod.tensor_units(
            dataclasses.replace(cfg.adapter_config, input_size=_tower_geometry(cfg)[0]), tp, rank)
    return units


def shard_params(params: dict, cfg: StarVectorConfig, mesh) -> dict:
    """This rank's shards of a whole training tree on a mesh (a DeviceMesh
    or a parallel.zero.Layout): partition_rules' fsdp and sequence splits,
    and on a mesh with tensor above 1 its tensor ranges first
    (tensor_units of every tensor rank)."""
    from starvector_tpu_torch.parallel.sharding import shard_pytree

    layout = mesh if isinstance(mesh, zero.Layout) else zero.Layout(mesh)
    units = [tensor_units(cfg, layout.tensor, r) for r in range(layout.tensor)] \
        if layout.tensor > 1 else None
    return shard_pytree(params, partition_rules(), layout, units)


def decoder_config(cfg: StarVectorConfig):
    """The decoder config the model runs with: on a tensor-parallel
    training layout (parallel/zero.py) its rank's (the decoder's
    `tensor_config`: its own heads and MLP columns), else cfg.llm."""
    layout = zero.active()
    if layout is None or layout.tensor == 1 or layout.serving:
        return cfg.llm
    return cfg.decoder_module.tensor_config(cfg.llm, layout.tensor, layout.tensor_group.rank)


def _encoder_cfg(cfg: StarVectorConfig):
    """(encoder config, tower config). A CLIP tower at an image size other
    than 224 without an explicit tower is the tiny test tower: patch 7,
    width 32, 2 layers, 4 heads (the JAX package's rule)."""
    enc = cfg.encoder_config
    if enc.tower is None and cfg.image_encoder_type == "clip" and cfg.image_size != 224:
        tower = CLIPViTConfig(image_size=cfg.image_size, patch_size=7, width=32, layers=2, heads=4)
        return dataclasses.replace(enc, tower=tower), tower
    return enc, enc.tower_config


def _adapter_cfg_for(cfg: StarVectorConfig, params: dict) -> adapter_mod.AdapterConfig:
    """Adapter geometry read from the parameters (tiny towers included)."""
    norm = params["image_projection"]["norm"]["scale"]
    qlen = norm.shape[0]
    d_in = params["image_projection"]["c_fc"]["kernel"].shape[0]
    return adapter_mod.AdapterConfig(input_size=d_in, output_size=cfg.hidden_size,
                                     query_length=qlen, adapter_norm=cfg.adapter_norm)


def _tower_geometry(cfg: StarVectorConfig) -> tuple[int, int]:
    """(width, tokens) the adapter takes, by the JAX package's rule: the
    CLIP tower's own, else the encoder's (the stock table's for a vqgan or
    convnext override, which states no token count)."""
    enc, tower = _encoder_cfg(cfg)
    return (tower.width, tower.num_tokens) if cfg.image_encoder_type == "clip" else enc.geometry


def init_vision_params(cfg: StarVectorConfig, gen: torch.Generator, *, device="cpu",
                       dtype=torch.float32) -> dict:
    """The tower's and the adapter's random weights ({"image_encoder",
    "image_projection"}), as init_params draws them after the decoder's."""
    enc, _ = _encoder_cfg(cfg)
    hidden, qlen = _tower_geometry(cfg)
    ad_cfg = dataclasses.replace(cfg.adapter_config, input_size=hidden, query_length=qlen)
    return {"image_encoder": image_encoder.init_params(enc, gen, device=device, dtype=dtype),
            "image_projection": adapter_mod.init_params(ad_cfg, gen, device=device, dtype=dtype)}


def init_params(cfg: StarVectorConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    params = {"svg_transformer": cfg.decoder_module.init_params(cfg.llm, gen, device=device,
                                                                dtype=dtype)}
    if cfg.use_image_encoder:
        params.update(init_vision_params(cfg, gen, device=device, dtype=dtype))
    return params


def encode_image(params: dict, cfg: StarVectorConfig, images: torch.Tensor, *,
                 policy: DTypePolicy = DTypePolicy(), train: bool = False,
                 dropout_gen: torch.Generator | None = None,
                 remat: bool | str = False) -> torch.Tensor:
    """Vision tower + ln_vision + adapter -> (B, query_length, llm_hidden)."""
    enc, _ = _encoder_cfg(cfg)
    embeds = image_encoder.forward(params["image_encoder"], enc, images, policy=policy,
                                   remat=remat)
    return adapter_mod.forward(params["image_projection"], _adapter_cfg_for(cfg, params), embeds,
                               policy=policy, train=train, dropout_gen=dropout_gen)


def _im2svg_sequence(params: dict, cfg: StarVectorConfig, cond: torch.Tensor,
                     svg_ids: torch.Tensor, svg_mask: torch.Tensor, policy: DTypePolicy):
    """[visual prefix | svg tokens]: (inputs_embeds, attention_mask, targets).
    Targets are -100 over the prefix and wherever svg_mask == 0: by
    position, not by pad id, so a terminal eos equal to pad is still a
    target."""
    B, Q, _ = cond.shape
    tok = cfg.decoder_module.embed_tokens(params["svg_transformer"], svg_ids)
    inputs_embeds = torch.cat([cond, policy.cast(tok)], dim=1)
    ones = torch.ones((B, Q), dtype=torch.int32, device=cond.device)
    attention_mask = torch.cat([ones, svg_mask.to(torch.int32)], dim=1)
    svg_targets = torch.where(svg_mask == 0, -100, svg_ids.long())
    targets = torch.cat([torch.full((B, Q), -100, dtype=torch.long, device=cond.device),
                         svg_targets], dim=1)
    return inputs_embeds, attention_mask, targets


def im2svg_inputs(params: dict, cfg: StarVectorConfig, images, svg_ids, svg_mask,
                  pad_token_id: int, *, policy: DTypePolicy = DTypePolicy(),
                  train: bool = False, dropout_gen: torch.Generator | None = None,
                  remat: bool | str = False):
    """(inputs_embeds, attention_mask, targets) for the im2svg loss."""
    cond = encode_image(params, cfg, images, policy=policy, train=train,
                        dropout_gen=dropout_gen, remat=remat)
    return _im2svg_sequence(params, cfg, cond, svg_ids, svg_mask, policy)


def text2svg_inputs(params: dict, cfg: StarVectorConfig, input_ids: torch.Tensor,
                    input_mask: torch.Tensor, pad_token_id: int, *,
                    policy: DTypePolicy = DTypePolicy()):
    """(inputs_embeds, attention_mask, targets) of caption + <svg-start> +
    svg + eos ids (B, S): the token embeddings in the compute dtype, the
    mask as int32, and targets -100 wherever input_mask == 0 (by position,
    not by pad id, as in _im2svg_sequence)."""
    tok = cfg.decoder_module.embed_tokens(params["svg_transformer"], input_ids)
    targets = torch.where(input_mask == 0, -100, input_ids.long())
    return policy.cast(tok), input_mask.to(torch.int32), targets


def _decoder_loss(params, cfg, inputs_embeds, attention_mask, targets, policy, remat, kernels):
    """The decoder's training forward, then the fused LM-head loss over its
    head table (the JAX loss_fn's tail, either decoder). On a
    sequence-parallel split the hidden states are this rank's chunk of the
    positions: the targets are shifted over the whole sequence, then cut to
    the chunk (a chunk's last position predicts the next chunk's first
    target), and the loss's count spans the ranks."""
    dec = cfg.decoder_module
    hidden, _ = dec.forward(params["svg_transformer"], decoder_config(cfg), inputs_embeds,
                            attention_mask, policy=policy, remat=remat, return_hidden=True,
                            kernels=kernels)
    span = chunk_span(targets.shape[1])
    if span is not None:
        targets = F.pad(targets[:, 1:], (0, 1), value=-100)[:, span[0]:span[1]]
    return gpt_bigcode.causal_lm_loss_fused(
        gathered(dec.lm_head_table(params["svg_transformer"], cfg.llm)), hidden, targets,
        policy=policy, shifted=span is not None)


def loss_fn(params: dict, cfg: StarVectorConfig, batch: dict, pad_token_id: int, *,
            policy: DTypePolicy = DTypePolicy(), train: bool = False,
            dropout_gen: torch.Generator | None = None, remat: bool | str = False,
            kernels: bool = True) -> torch.Tensor:
    """The training loss. batch, im2svg: image (B, H, W, 3), svg_ids and
    svg_mask (B, S); text2svg: input_ids and input_mask (B, S) (caption +
    <svg-start> + svg + eos). Without `train` the BatchNorm adapter takes
    its running statistics (the eval step)."""
    if cfg.task == "im2svg":
        inputs = im2svg_inputs(params, cfg, batch["image"], batch["svg_ids"], batch["svg_mask"],
                               pad_token_id, policy=policy, train=train, dropout_gen=dropout_gen,
                               remat=remat)
    else:
        inputs = text2svg_inputs(params, cfg, batch["input_ids"], batch["input_mask"],
                                 pad_token_id, policy=policy)
    return _decoder_loss(params, cfg, *inputs, policy, remat, kernels)


def loss_fn_with_bn_stats(params: dict, cfg: StarVectorConfig, batch: dict, pad_token_id: int,
                          *, policy: DTypePolicy = DTypePolicy(),
                          dropout_gen: torch.Generator | None = None,
                          remat: bool | str = False, kernels: bool = True):
    """Training loss and the BatchNorm adapter's new running statistics:
    (loss, {"bn_stats": {...}}), or (loss, {}) for a layer_norm adapter or
    text2svg."""
    if cfg.task != "im2svg" or cfg.adapter_norm != "batch_norm":
        return loss_fn(params, cfg, batch, pad_token_id, policy=policy, train=True,
                       dropout_gen=dropout_gen, remat=remat, kernels=kernels), {}
    enc, _ = _encoder_cfg(cfg)
    embeds = image_encoder.forward(params["image_encoder"], enc, batch["image"], policy=policy,
                                   remat=remat)
    cond, bn_stats = adapter_mod.forward_with_stats(
        params["image_projection"], _adapter_cfg_for(cfg, params), embeds, policy=policy,
        dropout_gen=dropout_gen)
    inputs = _im2svg_sequence(params, cfg, cond, batch["svg_ids"], batch["svg_mask"], policy)
    return _decoder_loss(params, cfg, *inputs, policy, remat, kernels), {"bn_stats": bn_stats}


def grpo_forward(params: dict, cfg: StarVectorConfig, vision_embeds: torch.Tensor,
                 input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                 num_generations: int = 1, policy: DTypePolicy = DTypePolicy(),
                 remat: bool | str = False, kernels: bool = True) -> torch.Tensor:
    """Per-token log-probs (B x G, S) fp32 of generated ids (the JAX
    grpo_forward, the reference forward's RL surface): each image's visual
    prefix vision_embeds (B, Q, E) is repeated for its G = num_generations
    rollouts, the uncached decoder runs over [prefix ‖ ids] (B x G rows;
    flash_prefill_trainable, with activation checkpointing per `remat`),
    and gpt_bigcode.token_logprobs_fused scores each id from the hidden
    state before it. Positions where attention_mask is 0 get 0. On a
    sequence-parallel split only the ids this rank's chunk predicts
    (grpo_scored_ids) are scored; the others get 0."""
    dec = cfg.decoder_module
    B, Q, _ = vision_embeds.shape
    G = num_generations
    L = input_ids.shape[1]
    cond = policy.cast(vision_embeds).repeat_interleave(G, dim=0)
    tok = policy.cast(dec.embed_tokens(params["svg_transformer"], input_ids))
    am = torch.cat([torch.ones((B * G, Q), dtype=torch.int32, device=cond.device),
                    attention_mask.to(torch.int32)], dim=1)
    hidden, _ = dec.forward(params["svg_transformer"], decoder_config(cfg),
                            torch.cat([cond, tok], dim=1), am, policy=policy, remat=remat,
                            return_hidden=True, kernels=kernels)
    # the hidden state at Q - 1 + t predicts input_ids[:, t]; on a
    # sequence-parallel split hidden starts at its chunk's first position
    lo, hi = grpo_scored_ids(Q, L)
    start = (chunk_span(Q + L) or (0, Q + L))[0]
    first = Q - 1 + lo - start
    lp = gpt_bigcode.token_logprobs_fused(
        gathered(dec.lm_head_table(params["svg_transformer"], cfg.llm)),
        hidden[:, first:first + hi - lo], input_ids[:, lo:hi], policy=policy)
    if (lo, hi) != (0, L):
        lp = F.pad(lp, (lo, L - hi))
    return torch.where(attention_mask > 0, lp, 0.0)


def grpo_scored_ids(Q: int, L: int) -> tuple[int, int]:
    """(first, end) of the L generated ids after a Q-token prefix whose
    log-probs this rank computes: all of them, or on a sequence-parallel
    split those its chunk of the Q + L positions predicts (position Q - 1 + t
    predicts id t), possibly none."""
    span = chunk_span(Q + L)
    if span is None:
        return 0, L
    lo = min(max(span[0] - (Q - 1), 0), L)
    return lo, max(min(span[1] - (Q - 1), L), lo)
