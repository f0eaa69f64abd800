"""Training entry point (port of starvector_tpu/train/train.py).

    python -m starvector_tpu_torch.train.train \
        config=configs/models/starvector-1b/im2svg-icons.yaml training.steps=1000

The CLI and its keys are the JAX package's: configs/models/default.yaml,
then the `config=` yaml, then dotlist overrides. One more key,
`training.device` (default "cuda"), names the device; without a card the
run stops and names `training.device=cpu`, it never switches on its own.

`main(config)` reads the config, builds the model from the preset (or a
local HF-layout checkpoint, models/builder.py), the tokenizer, the
datasets and the loader, and hands them to `train_loop`. The recipe keys
are the JAX main's: training.optimizer (adamw | adafactor), the AdamW
keys, training.gradient_checkpointing (true | false | dots | dots_slim |
dots_flash) and training.grad_dtype (e.g. bfloat16: the gradients' type,
fp32 masters). The run directory is `project.out_dir`, or
runs/<project.name>; it gets config.yaml, experiment_id.txt (the config's
md5, as the JAX main writes it), metrics.jsonl (utils/logging.py, wandb
too with project.report_to: wandb), a snapshot of starvector_tpu_torch/
(unless project.snapshot_code is false) and checkpoint-<n>/.

The mesh: under `torchrun --nproc_per_node N` (one process a device) the
`mesh:` block, fsdp: -1 over every rank without one, lays the N ranks out
as the JAX main lays out its devices (parallel/): plain DP, ZeRO-3/FSDP
and HSDP over the batch axes (replica, data, fsdp), sequence parallelism
with ZeRO over sequence (parallel/sequence.py; the 8B recipe
im2svg-stack-v5e8.yaml asks for fsdp 4 x sequence 2) and tensor
parallelism (`tensor`: each rank its whole heads and MLP columns of the
decoder, the vision tower and the adapter, parallel/tensor.py) and
pipeline parallelism (`stage`: each rank its contiguous block of the
decoder's layers, the rows pipelined over them in GPipe's microbatch
ticks, parallel/pipeline.py), alone or with the others; stage and
sequence both above 1 raise ValueError, as in the JAX package. Each rank
keeps its shards of the parameters and optimizer state and trains on its
batch coordinate's contiguous block of the global batch that a
one-process run draws (the ranks of a sequence, stage or tensor group the
same block, a sequence rank its chunk of the positions where the batch's
length divides), so N ranks take the one-process steps. Rank
0 alone logs, writes
the run directory and writes each checkpoint, from the state gathered
whole (the files a one-process run writes); a resume re-shards it on the
run's own mesh. A CUDA run takes NCCL, training.device=cpu gloo. Started
without torchrun, main is one process on one device, and a mesh that
asks for more raises ValueError (the JAX rule: the mesh must cover the
devices).

Left out against the JAX main: the rule that puts a run without
project.out_dir under runs/<project.name>/<experiment id>.
Where the port differs on purpose, starting from a checkpoint directory
(model.model_name or model.pretrained_path): the run takes that
checkpoint's own tokenizer (the JAX main takes model.tokenizer_path or
the test tokenizer), and its weights load as fp32 masters (the JAX
builder loads them in bf16).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from starvector_tpu_torch import require_device
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.models.builder import model_builder
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.parallel import zero
from starvector_tpu_torch.parallel.mesh import (
    check_training_mesh, create_mesh, initialize_distributed, local_mesh_summary, mesh_config_from,
)
from starvector_tpu_torch.train import checkpoint as ckpt
from starvector_tpu_torch.train.optim import Chain, build_optimizer
from starvector_tpu_torch.train.step import (
    make_eval_step, make_train_step, mark_trainable, shard_train_state,
)


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


def grad_dtype_from(raw) -> torch.dtype | None:
    """training.grad_dtype (a torch dtype name, e.g. bfloat16) -> the
    dtype, or None for the parameters' own."""
    if not raw:
        return None
    dtype = getattr(torch, str(raw), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"training.grad_dtype={raw!r} is not a floating torch dtype")
    return dtype


BATCH_TYPES = {"image": torch.float32, "svg_ids": torch.long, "svg_mask": torch.int32,
               "input_ids": torch.long, "input_mask": torch.int32}


def to_device(batch: dict, device) -> dict:
    """A batch (numpy arrays or tensors) as the loss's tensors on `device`:
    im2svg's image, svg_ids and svg_mask, and text2svg's input_ids and
    input_mask, whichever it holds."""
    return {k: torch.as_tensor(batch[k], device=device).to(t)
            for k, t in BATCH_TYPES.items() if k in batch}


def rank_rows(batch: dict, layout: zero.Layout | None) -> dict:
    """This rank's contiguous block of a global batch's rows by its batch
    coordinate (the JAX batch_spec layout: the ranks of a sequence, stage
    or tensor group take the same block), the batch itself without a
    layout."""
    if layout is None:
        return batch
    B = len(next(batch[k] for k in BATCH_TYPES if k in batch))
    if B % layout.batch:
        raise ValueError(f"a batch of {B} rows does not split over {layout.batch} batch ranks")
    n = B // layout.batch
    lo = layout.batch_rank * n
    return {k: batch[k][lo:lo + n] for k in BATCH_TYPES if k in batch}


def _save(out_dir: str, step: int, state: dict, layout, **kw) -> None:
    """Write a checkpoint: on a layout every rank gathers the state whole
    (each gathered leaf to the host) and rank 0 writes it."""
    if layout is not None:
        state = zero.full_tree(state, to_cpu=True)
        if dist.get_rank():
            return
    ckpt.save_checkpoint(out_dir, step, state, **kw)


def train_loop(
    params: dict,
    cfg: sv.StarVectorConfig,
    opt: Chain,
    batches: Iterable[tuple[int, dict]],
    *,
    total_steps: int,
    device,
    policy: DTypePolicy = DTypePolicy(),
    remat: bool | str = True,
    grad_dtype: torch.dtype | None = None,
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
    at the last) `validate(params)` runs and is logged, and a checkpoint
    with {params, opt_state} is written to `out_dir` when one is given.
    `on_step(step, metrics)` sees every step's metrics (tensors on the
    device). Returns (params, opt_state, step).

    On a ZeRO-3 layout (params from step.shard_train_state) each rank
    passes the same global batches and trains on its block of their rows
    (rank_rows); every rank must call validate and reach each checkpoint,
    whose state rank 0 writes gathered whole; give `log` on one rank."""
    device = torch.device(device)
    layout = zero.layout_of(params)
    mark_trainable(params)
    if opt_state is None:
        opt_state = opt.init(params)
    train_step = make_train_step(cfg, opt, pad_token_id, policy=policy, remat=remat,
                                 grad_dtype=grad_dtype, kernels=kernels)
    step = start_step
    t_last = time.perf_counter()
    for epoch, batch in batches:
        if step >= total_steps:
            break
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
        params, opt_state, metrics = train_step(params, opt_state,
                                                to_device(rank_rows(batch, layout), device), gen)
        step += 1
        if on_step is not None:
            on_step(step, metrics)
        if log is not None and (step % log_every == 0 or step >= total_steps):
            now = time.perf_counter()
            log({"step": step, "epoch": epoch, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]), "step_time": (now - t_last) / log_every})
            t_last = now
        if step % ckpt_every == 0 or step >= total_steps:
            if validate is not None:
                val_loss = validate(params)
                if log is not None:
                    log({"step": step, "val_loss": val_loss})
            if out_dir is not None:
                _save(out_dir, step, {"params": params, "opt_state": opt_state}, layout,
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
    """Train from a config (the module docstring); returns this rank's
    parameters (its shards on a mesh). A process group that main starts
    (torchrun's variables) it also ends."""
    g = config.get_path
    device = require_device(g("training.device", "cuda"), "training.device=cpu")
    mesh_cfg = mesh_config_from(config)
    check_training_mesh(dataclasses.asdict(mesh_cfg))
    owns_group = not dist.is_initialized()
    device = initialize_distributed(device)
    owns_group = owns_group and dist.is_initialized()
    try:
        return _main(config, device, mesh_cfg)
    finally:
        if owns_group:
            dist.barrier()
            dist.destroy_process_group()


def _main(config, device: torch.device, mesh_cfg) -> dict:
    from starvector_tpu_torch.api import tokenizer_version
    from starvector_tpu_torch.config import instantiate_from_config
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer, load_tokenizer
    from starvector_tpu_torch.train.loader import DataLoader
    from starvector_tpu_torch.utils.experiment import copy_code, generate_experiment_id
    from starvector_tpu_torch.utils.logging import MetricsSink

    g = config.get_path
    layout = None
    if dist.is_initialized():
        mesh = create_mesh(mesh_cfg, device_type=device.type)
        layout = zero.Layout(mesh)
    else:
        mesh_cfg.resolve(1)  # one process, one device: the mesh must cover it
    rank0 = layout is None or dist.get_rank() == 0
    if layout is not None and rank0:
        print(local_mesh_summary(mesh))
    project = g("project.name", "starvector-tpu")
    out_dir = g("project.out_dir", os.path.join("runs", str(project)))
    last = reimpose_checkpoint_model_block(config, out_dir)
    sink = None
    if rank0:
        os.makedirs(out_dir, exist_ok=True)
        sink = MetricsSink(out_dir, report_to=g("project.report_to"), project=project,
                           config=config.to_dict())
        with open(os.path.join(out_dir, "config.yaml"), "w") as f:
            f.write(config.to_yaml())
        with open(os.path.join(out_dir, "experiment_id.txt"), "w") as f:
            f.write(generate_experiment_id(config)[:12] + "\n")
        if g("project.snapshot_code", True):
            copy_code(out_dir)

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
            # each batch's loss is the global batch's (eval_step sums the ranks')
            losses = [float(eval_step(params, to_device(rank_rows(b, layout), device)))
                      for _, b in zip(range(max_batches), val_loader)]
            return float(np.mean(losses)) if losses else float("nan")

    total_steps = int(g("training.steps", 10_000))
    opt = build_optimizer(params, total_steps=total_steps, **optimizer_kwargs_from_config(config))
    opt_state, step, saved = None, 0, None
    if last and g("training.resume", True):
        # on a mesh each rank copies its shards out of the file mapped on the
        # host: no rank holds the whole state on its device
        saved = (ckpt.restore_checkpoint(last, device) if layout is None
                 else ckpt.restore_checkpoint(last, "cpu", mmap=True))
        step = ckpt.step_from_path(last)
        if rank0:
            print(f"resumed from {last} at step {step}")
    if layout is not None:
        params, opt_state = shard_train_state(params, opt, layout, cfg)
        if saved is not None:
            state = zero.load_shards({"params": params, "opt_state": opt_state}, saved)
            params, opt_state = state["params"], state["opt_state"]
    elif saved is not None:
        params, opt_state = saved["params"], saved["opt_state"]
    del saved

    params, _, _ = train_loop(
        params, cfg, opt, epoch_batches(train_loader, step, int(g("training.epochs", 1))),
        total_steps=total_steps, device=device, policy=policy,
        remat=remat_mode(g("training.gradient_checkpointing", True)),
        grad_dtype=grad_dtype_from(g("training.grad_dtype")),
        pad_token_id=tokenizer.pad_token_id, opt_state=opt_state, start_step=step,
        seed=int(g("training.seed", 0)), log=sink.log if sink is not None else None,
        log_every=max(int(g("training.log_every", 10)), 1), out_dir=out_dir,
        ckpt_every=int(g("training.checkpointing_steps", 1000)),
        total_limit=g("training.checkpoints_total_limit", 3), config=config, validate=validate,
    )
    if sink is not None:
        sink.finish()
    return params


def main_cli():
    from starvector_tpu_torch.config import get_config, resolve_repo_config

    main(get_config(default_path=resolve_repo_config()))


if __name__ == "__main__":
    main_cli()
