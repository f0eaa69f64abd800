"""GRPO post-training for StarVector (port of starvector_tpu/train/grpo.py).

The reference ships the RL surface (the log-prob forward and grouped
rollouts) and no loop; the JAX package completes it, and this is its port:

  rollout   api.generate_im2svg_grpo: the image encoded once, its prefix
            prefilled once and the cache tiled G times (num_return_sequences),
            G sampled rows a prompt, adjacent
  reward    on the host, through the eval chain's validity-gated
            process_and_rasterize_svg: SSIM and 1 - MSE of the render
            against the target raster; an SVG that falls to the placeholder
            scores 0
  advantage the z-score of each prompt's G rewards (no value network)
  update    make_grpo_step: grpo_forward's fused per-token log-probs (the
            uncached decoder through the training kernels; the (B·G, S, V)
            logits never exist at once), the PPO-clip surrogate, an optional
            k3 KL to a frozen copy of the decoder, the train/optim.py chain
            with its freeze mask (only the decoder trains)

`main` is the driver (the port of scripts/train_grpo.py):
`python -m starvector_tpu_torch.train.grpo config=... [dotlist]`.

Ratios take the model's raw log-probs on both sides, so the first update
after a rollout starts at ratio 1 (old_lp is the detached new_lp); with
updates_per_rollout > 1 the behaviour log-probs are computed once, before
the first update.

Sharded parameters (models/starvector.py::shard_params on a mesh of the
batch axes, `sequence` and `tensor`, one process a device), as the JAX
trainer takes them: the optimizer state lies beside each shard, each batch
rank rolls out its own prompts on the parameters gathered whole (the ranks
that hold the same rows, a sequence and a tensor group, take their first
rank's rollout), and the update gathers at use and sums over the ranks
(parallel/zero.py), the batch means taken over every rank's rows, through
the sequence split where the rollout's length divides and on each tensor
rank's heads and MLP columns. `main`, like the JAX script, builds no
mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.parallel import zero
from starvector_tpu_torch.train.optim import Chain, build_optimizer, global_norm, tree_leaves, \
    tree_map


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    """Rollout and objective knobs (PPO-clip defaults; KL off unless asked)."""

    num_generations: int = 8          # G rollouts a prompt
    max_new_tokens: int = 256
    temperature: float = 1.0
    top_p: float = 0.9
    clip_eps: float = 0.2             # PPO ratio clip
    kl_beta: float = 0.0              # weight of the k3 KL to the frozen reference
    updates_per_rollout: int = 1      # GRPO mu: > 1 reuses each rollout batch
    reward_resolution: int = 224      # raster size for the pixel reward
    ssim_weight: float = 0.5          # reward = w SSIM + (1 - w)(1 - MSE)
    advantage_eps: float = 1e-4       # z-score denominator floor


# ---------------------------------------------------------------------------
# reward (host side)
# ---------------------------------------------------------------------------

def svg_pixel_reward(svg_text: str, target: np.ndarray, *, resolution: int = 224,
                     ssim_weight: float = 0.5) -> float:
    """Render-fidelity reward in [0, 1] of one rollout against its target
    raster (H, W, 3) uint8: w SSIM (clipped to [0, 1], the channels'
    mean) + (1 - w)(1 - MSE / 255^2). The SVG goes through the eval chain
    (process_and_rasterize_svg); one that falls to the placeholder scores
    0. A target of another size is resized (bicubic) to the render's."""
    from PIL import Image

    from starvector_tpu_torch.data.rasterize import process_and_rasterize_svg, use_placeholder
    from starvector_tpu_torch.metrics.ssim import ssim_single

    out_svg, img = process_and_rasterize_svg(svg_text, resolution)
    if out_svg == use_placeholder():
        return 0.0
    arr = np.asarray(img, np.float64)
    tgt = np.asarray(target, np.float64)
    if arr.shape != tgt.shape:
        tgt = np.asarray(Image.fromarray(np.asarray(target, np.uint8)).resize(
            (arr.shape[1], arr.shape[0]), Image.BICUBIC), np.float64)
    mse = float(np.mean((arr - tgt) ** 2)) / 255.0**2
    ssim = np.mean([ssim_single(arr[..., c], tgt[..., c]) for c in range(arr.shape[-1])])
    ssim01 = float(np.clip(ssim, 0.0, 1.0))
    return ssim_weight * ssim01 + (1.0 - ssim_weight) * (1.0 - min(mse, 1.0))


def batch_rewards(raw_svgs: Sequence[str], targets: Sequence[np.ndarray], *,
                  num_generations: int, resolution: int = 224,
                  ssim_weight: float = 0.5) -> np.ndarray:
    """(B·G,) fp32 rewards of rollouts grouped [p0 x G, p1 x G, ...]
    against B targets."""
    G = num_generations
    if len(raw_svgs) != G * len(targets):
        raise ValueError(f"{len(raw_svgs)} rollouts for {len(targets)} targets x {G}")
    return np.asarray([svg_pixel_reward(svg, targets[i // G], resolution=resolution,
                                        ssim_weight=ssim_weight)
                       for i, svg in enumerate(raw_svgs)], np.float32)


# ---------------------------------------------------------------------------
# advantages and the objective
# ---------------------------------------------------------------------------

def group_advantages(rewards: torch.Tensor, num_generations: int, *,
                     eps: float = 1e-4) -> torch.Tensor:
    """Each prompt's G rewards as z-scores (population std, floored by
    eps); a group with one reward throughout gets 0."""
    r = torch.as_tensor(rewards).reshape(-1, num_generations).float()
    mean = r.mean(dim=1, keepdim=True)
    std = r.std(dim=1, unbiased=False, keepdim=True)
    return ((r - mean) / (std + eps)).reshape(-1)


def grpo_loss(params: dict, cfg: sv.StarVectorConfig, vision_embeds: torch.Tensor,
              ids: torch.Tensor, attn_mask: torch.Tensor, loss_mask: torch.Tensor,
              old_lp: torch.Tensor | None, advantages: torch.Tensor,
              ref_lp: torch.Tensor | None, *, num_generations: int, clip_eps: float,
              kl_beta: float, policy: DTypePolicy = DTypePolicy(), remat: bool | str = False,
              kernels: bool = True):
    """The clipped-surrogate GRPO objective: per-token -min(r A, clip(r) A)
    (+ kl_beta k3 with ref_lp), a token mean a sequence over loss_mask, then
    the batch mean. ids (B·G, L) [prompt ‖ generated], right-padded;
    attn_mask their valid positions, loss_mask the generated ones; old_lp
    the behaviour log-probs, or None (one update a rollout: the detached
    new log-probs). Returns (loss, {"kl", "clip_frac", "mean_ratio"}). On
    a data-parallel layout the rows are this rank's and the means are over
    every rank's rows and tokens: the ranks' losses add up to the global
    one. On a sequence-parallel split each rank of a sequence group scores
    its share of the rows' tokens (sv.grpo_scored_ids) and sums only those,
    over each row's whole count of tokens: the group's sums add up to the
    rows' token means."""
    new_lp = sv.grpo_forward(params, cfg, vision_embeds, ids, attn_mask,
                             num_generations=num_generations, policy=policy, remat=remat,
                             kernels=kernels)
    if old_lp is None:
        old_lp = new_lp.detach()
    ratio = torch.exp(new_lp - old_lp)
    adv = advantages.float()[:, None]
    per_tok = -torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
    m = loss_mask.float()
    denom = m.sum(dim=1).clamp_min(1.0)
    lo, hi = sv.grpo_scored_ids(vision_embeds.shape[1], ids.shape[1])
    if (lo, hi) != (0, ids.shape[1]):
        pos = torch.arange(ids.shape[1], device=m.device)
        m = m * ((pos >= lo) & (pos < hi))
    kl = torch.zeros((), device=new_lp.device)
    if ref_lp is not None and kl_beta > 0.0:
        d = ref_lp - new_lp
        k3 = torch.exp(d) - d - 1.0  # an unbiased, positive KL estimator
        per_tok = per_tok + kl_beta * k3
        kl = _batch_mean((k3 * m).sum(dim=1) / denom)
    loss = _batch_mean((per_tok * m).sum(dim=1) / denom)
    n_tok = zero.batch_sum(m.sum()).clamp_min(1.0)
    return loss, {"kl": zero.batch_sum(kl.detach()),
                  "clip_frac": zero.batch_sum(
                      (((ratio - 1.0).abs() > clip_eps).float() * m).sum().detach()) / n_tok,
                  "mean_ratio": zero.batch_sum((ratio * m).sum().detach()) / n_tok}


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x's mean, or on a layout this rank's share of the mean over every
    rank's rows."""
    rows = zero.global_rows(x.shape[0])
    return x.mean() if rows is None else x.sum() / rows[1]


def make_grpo_step(cfg: sv.StarVectorConfig, opt: Chain, *, num_generations: int,
                   clip_eps: float = 0.2, kl_beta: float = 0.0,
                   policy: DTypePolicy = DTypePolicy(), remat: bool | str = False,
                   kernels: bool = True):
    """Returns grpo_step(params, opt_state, rollout, advantages) -> (params,
    opt_state, metrics). `rollout` holds vision_embeds, ids, attn_mask,
    loss_mask [, old_lp] [, ref_lp]. The loss is differentiated with respect
    to the decoder's leaves that require a gradient (the rest get zeros, as
    in the JAX step, where grpo_forward reads only the decoder); the
    optimizer updates params and its state in place. metrics: the loss's,
    "loss" and "grad_norm" (optax.global_norm over every gradient)."""
    use_kl = kl_beta > 0.0

    def grpo_step(params: dict, opt_state: dict, rollout: dict, advantages: torch.Tensor):
        wrt = [p for p in tree_leaves(params["svg_transformer"]) if p.requires_grad]
        layout = zero.layout_of(params)
        with layout.step() if layout is not None else contextlib.nullcontext():
            loss, aux = grpo_loss(params, cfg, rollout["vision_embeds"], rollout["ids"],
                                  rollout["attn_mask"], rollout["loss_mask"],
                                  rollout.get("old_lp"), advantages,
                                  rollout.get("ref_lp") if use_kl else None,
                                  num_generations=num_generations, clip_eps=clip_eps,
                                  kl_beta=kl_beta, policy=policy, remat=remat, kernels=kernels)
            grads = zero.step_grads(loss, wrt)
            loss = zero.batch_sum(loss.detach())
        zero.reduce_grads(wrt, grads)
        got = dict(zip(map(id, wrt), grads))

        def grad_of(p):
            g = got.get(id(p))
            # a zero that costs no memory for every leaf grpo_forward does not read
            return torch.zeros((), dtype=p.dtype, device=p.device).expand(p.shape) \
                if g is None else g

        grads = tree_map(grad_of, params)
        with torch.no_grad():
            grad_norm = global_norm(tree_leaves(grads), tree_leaves(params))
            opt.update(grads, opt_state, params)
        return params, opt_state, {**aux, "loss": loss, "grad_norm": grad_norm}

    return grpo_step


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

class GRPOTrainer:
    """Rollout -> reward -> advantage -> update, bound to an
    api.StarVectorForCausalLM. Only the decoder trains (the reference's
    stage-2 freezes the vision tower; the adapter stays frozen because
    grpo_forward conditions on the rollout's visual prefix): its leaves get
    requires_grad, the optimizer's mask freezes the rest. With kl_beta > 0
    a copy of the decoder taken here is the KL reference.

    When model.params are shards on a layout (parallel/; sv.shard_params),
    the optimizer state takes each shard's split, each batch rank rolls out
    the images it is given on the parameters gathered whole (for the
    rollout only, on the cached decoder, unpipelined; the ranks that hold
    the same rows, its sequence, stage and tensor ranks, take their first
    rank's rollout), and the update runs through the gathers, the sequence
    split, the tensor ranks' heads, the pipeline over the stage ranks'
    blocks of layers (parallel/pipeline.py) and the sums of the sharded
    step."""

    def __init__(self, model, grpo: GRPOConfig = GRPOConfig(), *, lr: float = 1e-6,
                 total_steps: int = 1000, warmup_steps: int = 0, grad_clip: float = 1.0,
                 weight_decay: float = 0.0, remat: bool | str = "dots"):
        self.model = model
        self.grpo = grpo
        for p in tree_leaves(model.params["svg_transformer"]):
            p.requires_grad_(p.is_floating_point())
        self.opt = build_optimizer(model.params, lr=lr, weight_decay=weight_decay,
                                   warmup_steps=warmup_steps, total_steps=total_steps,
                                   grad_clip=grad_clip, train_image_encoder=False,
                                   train_connector=False, train_LLM=True)
        self.opt_state = self.opt.init(model.params)
        self.layout = zero.layout_of(model.params)
        self.ref_decoder = (tree_map(lambda p: zero.register_like(p.detach().clone(), p),
                                     model.params["svg_transformer"])
                            if grpo.kl_beta > 0.0 else None)
        self._step_fn = make_grpo_step(model.cfg, self.opt, num_generations=grpo.num_generations,
                                       clip_eps=grpo.clip_eps, kl_beta=grpo.kl_beta,
                                       policy=model.policy, remat=remat, kernels=model.kernels)
        self.step_count = 0

    def _log_probs(self, params: dict, rollout: dict) -> torch.Tensor:
        with torch.no_grad(), (self.layout.step() if self.layout is not None
                               else contextlib.nullcontext()):
            return sv.grpo_forward(params, self.model.cfg, rollout["vision_embeds"],
                                   rollout["ids"], rollout["attn_mask"],
                                   num_generations=self.grpo.num_generations,
                                   policy=self.model.policy, kernels=self.model.kernels)

    @contextlib.contextmanager
    def _whole_params(self):
        """model.params gathered whole while the rollout runs (its
        generation reads plain tensors); the shards again after."""
        if self.layout is None:
            yield
            return
        shards = self.model.params
        self.model.params = zero.full_tree(shards)
        try:
            yield
        finally:
            self.model.params = shards

    def step(self, images: torch.Tensor, target_rasters: Sequence[np.ndarray],
             **gen_kwargs: Any) -> dict:
        """One rollout of images (B, H, W, 3) (processed), rewards against
        B target rasters (h, w, 3) uint8, and updates_per_rollout updates.
        Returns floats: the last update's metrics, the rewards' mean, std,
        max and valid fraction, the step count, and the wall seconds of the
        rollout, the reward and the update (each ends at a host read)."""
        g = self.grpo
        t0 = time.perf_counter()
        with self._whole_params():
            roll = self.model.generate_im2svg_grpo(
                {"image": images}, num_return_sequences=g.num_generations,
                temperature=gen_kwargs.pop("temperature", g.temperature),
                top_p=gen_kwargs.pop("top_p", g.top_p),
                max_new_tokens=gen_kwargs.pop("max_new_tokens", g.max_new_tokens), **gen_kwargs)
        if self.layout is not None:
            roll = self.layout.rows_broadcast(roll)
        t1 = time.perf_counter()
        rewards = batch_rewards(roll["raw_svg"], target_rasters, num_generations=g.num_generations,
                                resolution=g.reward_resolution, ssim_weight=g.ssim_weight)
        t2 = time.perf_counter()

        ids, P = roll["outputs"], roll["prompt_len"]
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        attn_mask = (pos < P + roll["lengths"][:, None]).to(torch.int32)
        # the visual prefix: what the tower gave, before the prompt
        rollout = {"vision_embeds": roll["inputs_embeds"][:, :roll["inputs_embeds"].shape[1] - P],
                   "ids": ids, "attn_mask": attn_mask,
                   "loss_mask": attn_mask * (pos >= P).to(torch.int32)}
        mu = max(int(g.updates_per_rollout), 1)
        if mu > 1:
            rollout["old_lp"] = self._log_probs(self.model.params, rollout)
        if self.ref_decoder is not None:
            rollout["ref_lp"] = self._log_probs({"svg_transformer": self.ref_decoder}, rollout)
        advantages = group_advantages(torch.as_tensor(rewards, device=ids.device),
                                      g.num_generations, eps=g.advantage_eps)
        for _ in range(mu):
            _, self.opt_state, metrics = self._step_fn(self.model.params, self.opt_state,
                                                       rollout, advantages)
        out = {k: float(v) for k, v in metrics.items()}
        t3 = time.perf_counter()
        self.step_count += 1
        out.update(reward_mean=float(rewards.mean()), reward_std=float(rewards.std()),
                   reward_max=float(rewards.max()), valid_frac=float((rewards > 0.0).mean()),
                   step=self.step_count, rollout_s=t1 - t0, reward_s=t2 - t1, update_s=t3 - t2)
        return out


# ---------------------------------------------------------------------------
# the driver (port of scripts/train_grpo.py)
# ---------------------------------------------------------------------------

def main(config):
    """GRPO post-training from a config, as scripts/train_grpo.py drives the
    JAX trainer:

        python -m starvector_tpu_torch.train.grpo \\
            config=configs/models/starvector-1b/im2svg-grpo.yaml \\
            model.pretrained_path=/ckpts/starvector-1b grpo.steps=500

    The model is `model.pretrained_path` (from_pretrained), else the
    model block's random weights (models/builder.py::model_builder) with
    the test tokenizer of its decoder. Each step takes data.batch_size
    items of `data.train` in order, rasterizes their SVGs at
    grpo.reward_resolution as the reward's targets, logs the step's metrics
    to MetricsSink under project.out_dir, and saves {"params"} as
    checkpoint-<step> every training.checkpointing_steps steps and at the
    last (rotated to training.checkpoints_total_limit). Runs on the card
    unless training.device=cpu. The JAX driver first turns on XLA's
    persistent compilation cache; the port compiles nothing at run time
    (its kernels build once, ops/kernel_lib.py), so it has no counterpart.
    Returns (model, the logged metrics of every step)."""
    from starvector_tpu_torch.api import StarVectorForCausalLM, tokenizer_version
    from starvector_tpu_torch.config import instantiate_from_config
    from starvector_tpu_torch.data.rasterize import rasterize_svg
    from starvector_tpu_torch.models.builder import model_builder
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.train import checkpoint as ckpt
    from starvector_tpu_torch.utils.logging import MetricsSink

    g = config.get_path
    device = require_device(g("training.device", "cuda"), "training.device=cpu")
    pretrained = g("model.pretrained_path")
    if pretrained:
        model = StarVectorForCausalLM.from_pretrained(pretrained, device=device)
    else:
        params, cfg, tok = model_builder(config, device)
        model = StarVectorForCausalLM(params, cfg, tok or build_test_tokenizer(
            tokenizer_version(cfg)), device=device)
    # the JAX driver's defaults (512 new tokens where GRPOConfig has 256)
    gcfg = GRPOConfig(
        num_generations=int(g("grpo.num_generations", 8)),
        max_new_tokens=int(g("grpo.max_new_tokens", 512)),
        temperature=float(g("grpo.temperature", 1.0)),
        top_p=float(g("grpo.top_p", 0.9)),
        clip_eps=float(g("grpo.clip_eps", 0.2)),
        kl_beta=float(g("grpo.kl_beta", 0.0)),
        updates_per_rollout=int(g("grpo.updates_per_rollout", 1)),
        reward_resolution=int(g("grpo.reward_resolution", 224)),
        ssim_weight=float(g("grpo.ssim_weight", 0.5)),
    )
    steps = int(g("grpo.steps", 1000))
    trainer = GRPOTrainer(model, gcfg, lr=float(g("grpo.lr", 1e-6)), total_steps=steps,
                          warmup_steps=int(g("grpo.warmup_steps", 0)),
                          grad_clip=float(g("training.grad_clip", 1.0)))
    ds = instantiate_from_config(g("data.train"))
    batch_size = int(g("data.batch_size", 4))
    out_dir = g("project.out_dir", f"runs/{g('project.name', 'starvector-grpo')}")
    sink = MetricsSink(out_dir)
    every = int(g("training.checkpointing_steps", 200))
    records, idx = [], 0
    for step in range(steps):
        images, targets = [], []
        while len(images) < batch_size:
            item = ds[idx % len(ds)]
            idx += 1
            images.append(np.asarray(item["image"]))
            targets.append(np.asarray(rasterize_svg(item["svg"],
                                                    resolution=gcfg.reward_resolution)))
        metrics = trainer.step(torch.as_tensor(np.stack(images), device=device), targets)
        sink.log(metrics, step=metrics["step"])
        records.append(metrics)
        print(f"step {metrics['step']}: loss {metrics['loss']:.4f} "
              f"reward {metrics['reward_mean']:.3f} "
              f"valid {metrics['valid_frac']:.2f} kl {metrics['kl']:.4f}")
        if (step + 1) % every == 0 or step + 1 >= steps:
            ckpt.save_checkpoint(out_dir, metrics["step"], {"params": model.params},
                                 total_limit=g("training.checkpoints_total_limit", 3))
    sink.finish()
    return model, records


def main_cli():
    from starvector_tpu_torch.config import get_config, resolve_repo_config

    main(get_config(default_path=resolve_repo_config()))


if __name__ == "__main__":
    main_cli()
