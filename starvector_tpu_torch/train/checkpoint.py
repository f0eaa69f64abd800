"""Checkpoints: save, rotate, find the last, resume (port of
starvector_tpu/train/checkpoint.py, with torch.save in place of Orbax).

A checkpoint is the directory `<base>/checkpoint-<step>` (the JAX package's
name) holding `state.pt`, {params, opt_state, ...} as torch.save writes it,
and, when a config is given, the `config.yaml` snapshot that a resumed run
re-imposes. Older directories are removed beyond `total_limit`.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any

import torch

STATE_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(base, f"checkpoint-{step}")


def list_checkpoints(base: str) -> list[tuple[int, str]]:
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.exists(os.path.join(base, name, STATE_FILE)):
            out.append((int(m.group(1)), os.path.join(base, name)))
    return sorted(out)


def get_last_checkpoint(base: str) -> str | None:
    cps = list_checkpoints(base)
    return cps[-1][1] if cps else None


def save_checkpoint(base: str, step: int, state: dict[str, Any], *,
                    total_limit: int | None = None, config: Any | None = None) -> str:
    """Save state at checkpoint-<step> and rotate old ones. The state file is
    written beside its final name and renamed, so a run cut during the save
    leaves no checkpoint that list_checkpoints would offer."""
    path = _ckpt_dir(os.path.abspath(base), step)
    os.makedirs(path, exist_ok=True)
    if config is not None:
        if hasattr(config, "to_yaml"):
            blob = config.to_yaml()
        else:
            import yaml

            blob = yaml.safe_dump(dict(config), sort_keys=False)
        with open(os.path.join(path, "config.yaml"), "w") as f:
            f.write(blob)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if total_limit:
        cps = list_checkpoints(base)
        for _, old in cps[: max(0, len(cps) - total_limit)]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def restore_checkpoint(path: str, device="cpu") -> dict[str, Any]:
    """The saved state, its tensors on `device`."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def load_checkpoint_config(path: str):
    """The config snapshot saved beside a checkpoint (a ConfigNode), or None."""
    cfg_path = os.path.join(path, "config.yaml")
    if not os.path.exists(cfg_path):
        return None
    from starvector_tpu_torch.config import load_yaml

    return load_yaml(cfg_path)


def step_from_path(path: str) -> int:
    m = re.search(r"checkpoint-(\d+)$", path.rstrip("/"))
    return int(m.group(1)) if m else 0
