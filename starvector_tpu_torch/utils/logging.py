"""Metrics sink: jsonl always, wandb when asked (port of
starvector_tpu/utils/logging.py's MetricsSink).

Every record goes to <out_dir>/metrics.jsonl and, with `echo`, to stdout.
With `report_to: wandb` (the reference's key) and the `wandb` package
importable, records are mirrored there too; without either, jsonl only.
The validator's comparison table and image pairs (reference
svg_validator_base.py:436-451) are jsonl records as well; their lines equal
the JAX sink's.
"""

from __future__ import annotations

import json
import os
from typing import Any


def _plain(v):
    return v.item() if hasattr(v, "item") else v


class MetricsSink:
    def __init__(self, out_dir: str, *, report_to: str | None = None,
                 project: str | None = None, run_name: str | None = None,
                 config: dict | None = None, echo: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.echo = echo
        self.wandb = None
        if report_to == "wandb":
            try:
                import wandb

                self.wandb = wandb.init(project=project or "starvector-tpu", name=run_name,
                                        config=config or {}, dir=out_dir)
            except Exception as e:  # noqa: BLE001 -- wandb absent or offline
                print(f"wandb disabled ({type(e).__name__}: {e}); jsonl only")

    def _write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log(self, record: dict[str, Any], step: int | None = None) -> None:
        record = {k: _plain(v) for k, v in record.items()}
        if step is not None and "step" not in record:
            record["step"] = int(step)
        self._write(record)
        if self.echo:
            print(json.dumps(record), flush=True)
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in record.items() if isinstance(v, (int, float))},
                           step=record.get("step"))

    def log_table(self, name: str, columns: list[str], rows: list[list]) -> None:
        """One jsonl record holding the table; a wandb Table when mirrored."""
        self._write({"table": name, "columns": columns,
                     "rows": [[_plain(c) for c in r] for r in rows]})
        if self.wandb is not None:
            import wandb

            self.wandb.log({name: wandb.Table(columns=columns, data=rows)})

    def log_image_pairs(self, name: str, pairs: list[tuple], captions=None) -> None:
        """GT-vs-generated image files (already on disk): their paths in
        jsonl; uploaded when mirrored to wandb."""
        self._write({"images": name, "pairs": [[str(a), str(b)] for a, b in pairs]})
        if self.wandb is not None:
            import wandb

            imgs = []
            for i, (gt, gen) in enumerate(pairs):
                cap = captions[i] if captions else f"pair {i}"
                imgs.append(wandb.Image(str(gt), caption=f"GT {cap}"))
                imgs.append(wandb.Image(str(gen), caption=f"gen {cap}"))
            self.wandb.log({name: imgs})

    def finish(self) -> None:
        if self.wandb is not None:
            self.wandb.finish()
