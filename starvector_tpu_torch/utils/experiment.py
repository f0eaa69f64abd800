"""Run identity, code snapshot and parameter counts (port of
starvector_tpu/utils/experiment.py)."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from starvector_tpu_torch.config import _unwrap


def generate_experiment_id(config) -> str:
    """Deterministic run identity: the md5 of the config as sorted JSON
    (the JAX package's, so that both give one config the same id)."""
    blob = json.dumps(_unwrap(config), sort_keys=True, default=str)
    return hashlib.md5(blob.encode()).hexdigest()


def copy_code(out_dir: str) -> str:
    """Snapshot the port's source (starvector_tpu_torch/, without build
    outputs) into out_dir/code_snapshot, so that every run records the code
    that made it; a failed copy is reported and does not stop the run.
    Returns the snapshot's directory."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(out_dir, "code_snapshot", os.path.basename(src))
    try:
        shutil.copytree(src, dst, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "_build"))
    except OSError as e:
        print(f"code snapshot skipped ({e})")
    return os.path.dirname(dst)


def count_params(tree) -> int:
    """Elements in a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())
