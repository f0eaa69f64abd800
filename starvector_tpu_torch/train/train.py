"""Training entry point (port of starvector_tpu/train/train.py).

    python -m starvector_tpu_torch.train.train \
        config=configs/models/starvector-1b/im2svg-icons.yaml training.steps=1000

The CLI and its keys are the JAX package's: configs/models/default.yaml,
then the `config=` yaml, then dotlist overrides. One more key,
`training.device` (default "cuda"), names the device; without a card the
run stops and names `training.device=cpu`, it never switches on its own.

`main(config)` reads the config, builds the model from the preset (or a
local HF-layout checkpoint), the tokenizer, the datasets and the loader, and
hands them to `train_loop`. The config, tokenizer, dataset and loader
modules are the port's own copies of the JAX package's; a dataset `target:`
under `starvector_tpu.data` is read as its `starvector_tpu_torch.data`
counterpart (config.py).

Left out against the JAX main: the device mesh (one device), the
out-dir-by-config-hash rule (the run directory is `project.out_dir`, or
runs/<project.name>), the code snapshot and experiment id files, and wandb.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.train import checkpoint as ckpt
from starvector_tpu_torch.train.optim import AdamW, build_optimizer
from starvector_tpu_torch.train.step import make_eval_step, make_train_step, mark_trainable

MODEL_KEYS = ("image_encoder_type", "adapter_norm", "image_size", "task")


def optimizer_kwargs_from_config(config) -> dict:
    """The optimizer recipe from a config (the JAX function's keys and
    defaults)."""
    g = config.get_path
    return dict(
        optimizer=g("training.optimizer", "adamw"),
        lr=float(g("training.lr", 1e-4)),
        weight_decay=float(g("training.adam_weight_decay", g("training.weight_decay", 1e-6))),
        betas=(float(g("training.adam_beta1", 0.95)), float(g("training.adam_beta2", 0.999))),
        eps=float(g("training.adam_epsilon", 1e-8)),
        warmup_steps=int(g("training.lr_warmup_steps", g("training.warmup_steps", 0))),
        lr_scheduler=g("training.lr_scheduler", "cosine"),
        grad_clip=float(g("training.grad_clip", 1.0)),
        grad_accum_steps=int(g("training.grad_accum_steps", 1)),
        train_image_encoder=bool(g("training.train_image_encoder", True)),
        train_LLM=bool(g("training.train_LLM", True)),
        train_connector=bool(g("training.train_connector", True)),
    )


def remat_mode(raw) -> bool | str:
    """training.gradient_checkpointing: true | false | "dots" | "dots_slim"
    | "dots_flash" (ops/layers.py::maybe_checkpoint)."""
    if isinstance(raw, str):
        if raw not in ("dots", "dots_slim", "dots_flash"):
            raise ValueError(f"training.gradient_checkpointing={raw!r} is not a known mode; "
                             "expected true | false | 'dots' | 'dots_slim' | 'dots_flash'")
        return raw
    return bool(raw)


def config_from_model_block(block: dict) -> sv.StarVectorConfig:
    """The `model` yaml block -> StarVectorConfig (the JAX package's
    models/builder.py::config_from_yaml_block). `attn_impl` is not read: the
    port's attention is always its flash kernels."""
    name = str(block.get("starcoder_model_name", "")) + str(block.get("_name_or_path", ""))
    preset = block.get("preset")
    if preset in ("tiny", "tiny-v2"):
        base = sv.tiny_config(decoder="starcoder2" if preset == "tiny-v2" else "gpt_bigcode")
    elif preset in (None, "", "full"):
        base = sv.starvector_8b_config() if "starcoder2" in name else sv.starvector_1b_config()
    else:
        raise ValueError(f"unknown model.preset {preset!r}")
    import dataclasses

    overrides: dict[str, Any] = {k: block[k] for k in MODEL_KEYS if k in block}
    if "max_length" in block:
        overrides["max_length_train"] = int(block["max_length"])
    return dataclasses.replace(base, **overrides)


def model_builder(config, device) -> tuple[dict, sv.StarVectorConfig, Any]:
    """(fp32 params on `device`, config, the checkpoint's tokenizer or
    None): random weights from a torch.Generator seeded with model.seed, or
    a local HF-layout checkpoint directory (model.model_name /
    model.pretrained_path)."""
    block = dict(config.get_path("model") or {})
    cfg = config_from_model_block(block)
    pretrained = block.get("model_name") or block.get("pretrained_path")
    if pretrained and os.path.isdir(str(pretrained)):
        from starvector_tpu_torch.api import StarVectorForCausalLM

        model = StarVectorForCausalLM.from_pretrained(str(pretrained), dtype=torch.float32,
                                                      device=device)
        return model.params, model.cfg, model.tokenizer
    gen = torch.Generator(device=device).manual_seed(int(block.get("seed", 0)))
    return sv.init_params(cfg, gen, device=device), cfg, None


BATCH_TYPES = {"image": torch.float32, "svg_ids": torch.long, "svg_mask": torch.int32,
               "input_ids": torch.long, "input_mask": torch.int32}


def to_device(batch: dict, device) -> dict:
    """A batch (numpy arrays or tensors) as the loss's tensors on `device`:
    im2svg's image, svg_ids and svg_mask, and text2svg's input_ids and
    input_mask, whichever it holds."""
    return {k: torch.as_tensor(batch[k], device=device).to(t)
            for k, t in BATCH_TYPES.items() if k in batch}


def jsonl_logger(out_dir: str) -> Callable[[dict], None]:
    """Appends each record to out_dir/metrics.jsonl and prints it."""
    path = os.path.join(out_dir, "metrics.jsonl")

    def log(record: dict) -> None:
        line = json.dumps(record)
        with open(path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)

    return log


def train_loop(
    params: dict,
    cfg: sv.StarVectorConfig,
    opt: AdamW,
    batches: Iterable[tuple[int, dict]],
    *,
    total_steps: int,
    device,
    policy: DTypePolicy = DTypePolicy(),
    remat: bool | str = True,
    pad_token_id: int = 0,
    opt_state: dict | None = None,
    start_step: int = 0,
    seed: int = 0,
    log: Callable[[dict], None] | None = None,
    log_every: int = 10,
    out_dir: str | None = None,
    ckpt_every: int = 1000,
    total_limit: int | None = 3,
    config: Any = None,
    validate: Callable[[dict], float] | None = None,
    kernels: bool = True,
    on_step: Callable[[int, dict], None] | None = None,
) -> tuple[dict, dict, int]:
    """Train from `start_step` until `total_steps` or the end of `batches`.

    `batches` yields (epoch, batch) with batch in the loader's format
    (image (B, H, W, 3) CLIP-normalised, svg_ids and svg_mask (B, S)), numpy
    or tensors. Each step's adapter dropout draws from a torch.Generator
    seeded with (seed, step), so a resumed run draws what the uninterrupted
    one would. Every `log_every` steps (and at the last) `log` gets
    {step, epoch, loss, grad_norm, step_time}; every `ckpt_every` steps (and
    at the last) `validate(params)` is logged and a checkpoint with
    {params, opt_state} is written to `out_dir` when one is given.
    `on_step(step, metrics)` sees every step's metrics (tensors on the
    device). Returns (params, opt_state, step)."""
    device = torch.device(device)
    mark_trainable(params)
    if opt_state is None:
        opt_state = opt.init(params)
    train_step = make_train_step(cfg, opt, pad_token_id, policy=policy, remat=remat,
                                 kernels=kernels)
    step = start_step
    t_last = time.perf_counter()
    for epoch, batch in batches:
        if step >= total_steps:
            break
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
        params, opt_state, metrics = train_step(params, opt_state, to_device(batch, device), gen)
        step += 1
        if on_step is not None:
            on_step(step, metrics)
        if log is not None and (step % log_every == 0 or step >= total_steps):
            now = time.perf_counter()
            log({"step": step, "epoch": epoch, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]), "step_time": (now - t_last) / log_every})
            t_last = now
        if step % ckpt_every == 0 or step >= total_steps:
            if validate is not None and log is not None:
                log({"step": step, "val_loss": validate(params)})
            if out_dir is not None:
                ckpt.save_checkpoint(out_dir, step, {"params": params, "opt_state": opt_state},
                                     total_limit=total_limit, config=config)
    return params, opt_state, step


def epoch_batches(loader, start_step: int, epochs: int):
    """(epoch, batch) across epochs, resuming at `start_step` without
    replaying a batch: per-epoch seeded permutation and a fast-forward within
    the resumed epoch (the JAX loop's rule)."""
    per_epoch = max(len(loader), 1)
    start_epoch = start_step // per_epoch
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        if epoch == start_epoch and start_step % per_epoch:
            loader.skip_first_batches(start_step % per_epoch)
        for batch in loader:
            yield epoch, batch


def reimpose_checkpoint_model_block(config, out_dir: str) -> str | None:
    """On resume the checkpoint's saved `model` block wins over the live
    config (the JAX rule). Returns the checkpoint to resume from, or None."""
    last = ckpt.get_last_checkpoint(out_dir)
    if not (last and config.get_path("training.resume", True)):
        return last
    saved = ckpt.load_checkpoint_config(last)
    if saved is not None and saved.get("model") is not None:
        if config.get_path("model") != saved["model"]:
            print(f"resume: re-imposing the model block saved at {last}")
        config["model"] = saved["model"]
    return last


def main(config) -> dict:
    from starvector_tpu_torch.api import tokenizer_version
    from starvector_tpu_torch.config import instantiate_from_config
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer, load_tokenizer
    from starvector_tpu_torch.train.loader import DataLoader

    g = config.get_path
    device = require_device(g("training.device", "cuda"), "training.device=cpu")
    project = g("project.name", "starvector-tpu")
    out_dir = g("project.out_dir", os.path.join("runs", str(project)))
    last = reimpose_checkpoint_model_block(config, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        f.write(config.to_yaml())

    params, cfg, tokenizer = model_builder(config, device)
    if tokenizer is None:
        tok_path = g("model.tokenizer_path")
        version = tokenizer_version(cfg)
        tokenizer = (load_tokenizer(tok_path, version=version) if tok_path
                     else build_test_tokenizer(version))
    batch_size = int(g("data.batch_size", 2))
    loader_kw = dict(max_length=min(int(g("data.max_length", 512)), cfg.max_svg_length),
                     num_workers=int(g("data.num_workers", 4)),
                     process_index=0, process_count=1)
    train_loader = DataLoader(instantiate_from_config(g("data.train")), tokenizer, batch_size,
                              **loader_kw)
    val_cfg = g("data.val")
    validate = None
    policy = DTypePolicy(torch.float32,
                         torch.bfloat16 if g("training.bf16", True) else torch.float32)
    if val_cfg:
        val_loader = DataLoader(instantiate_from_config(val_cfg), tokenizer, batch_size,
                                shuffle=False, **loader_kw)
        eval_step = make_eval_step(cfg, tokenizer.pad_token_id, policy=policy)

        def validate(params, max_batches: int = 16) -> float:
            losses = [float(eval_step(params, to_device(b, device)))
                      for _, b in zip(range(max_batches), val_loader)]
            return float(np.mean(losses)) if losses else float("nan")

    total_steps = int(g("training.steps", 10_000))
    opt = build_optimizer(params, total_steps=total_steps, **optimizer_kwargs_from_config(config))
    opt_state, step = None, 0
    if last and g("training.resume", True):
        state = ckpt.restore_checkpoint(last, device)
        params, opt_state = state["params"], state["opt_state"]
        step = ckpt.step_from_path(last)
        print(f"resumed from {last} at step {step}")

    params, _, _ = train_loop(
        params, cfg, opt, epoch_batches(train_loader, step, int(g("training.epochs", 1))),
        total_steps=total_steps, device=device, policy=policy,
        remat=remat_mode(g("training.gradient_checkpointing", True)),
        pad_token_id=tokenizer.pad_token_id, opt_state=opt_state, start_step=step,
        seed=int(g("training.seed", 0)), log=jsonl_logger(out_dir),
        log_every=max(int(g("training.log_every", 10)), 1), out_dir=out_dir,
        ckpt_every=int(g("training.checkpointing_steps", 1000)),
        total_limit=g("training.checkpoints_total_limit", 3), config=config, validate=validate,
    )
    return params


def main_cli():
    from starvector_tpu_torch.config import get_config, resolve_repo_config

    main(get_config(default_path=resolve_repo_config()))


if __name__ == "__main__":
    main_cli()
