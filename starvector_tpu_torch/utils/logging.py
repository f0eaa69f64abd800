"""Metrics sink: jsonl always, wandb when asked (port of
starvector_tpu/utils/logging.py's MetricsSink).

Every record goes to <out_dir>/metrics.jsonl and to stdout. With
`project.report_to: wandb` (the reference's key) and the `wandb` package
importable, records are mirrored there too; without either, jsonl only.
"""

from __future__ import annotations

import json
import os
from typing import Any


def _plain(v):
    return v.item() if hasattr(v, "item") else v


class MetricsSink:
    def __init__(self, out_dir: str, *, report_to: str | None = None,
                 project: str | None = None, config: dict | None = None, echo: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.echo = echo
        self.wandb = None
        if report_to == "wandb":
            try:
                import wandb

                self.wandb = wandb.init(project=project or "starvector-tpu", config=config or {},
                                        dir=out_dir)
            except Exception as e:  # noqa: BLE001 -- wandb absent or offline
                print(f"wandb disabled ({type(e).__name__}: {e}); jsonl only")

    def log(self, record: dict[str, Any]) -> None:
        record = {k: _plain(v) for k, v in record.items()}
        line = json.dumps(record)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in record.items() if isinstance(v, (int, float))},
                           step=record.get("step"))

    def finish(self) -> None:
        if self.wandb is not None:
            self.wandb.finish()
