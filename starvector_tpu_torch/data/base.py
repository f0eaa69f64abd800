"""Dataset base: table loading, augmentation gating, rasterization with
placeholder fallbacks, per-backend image processing (the port's copy of
starvector_tpu/data/base.py; images are processed on the host by the port's
data/processor.py).

Rebuilds SVGDatasetBase (reference: starvector/data/base.py:7-71) without a
hard `datasets` dependency. Data sources, in priority order:
  * an in-memory list[dict] (tests / custom pipelines)
  * HF `datasets.load_dataset` when the library is installed
  * a local directory of parquet / jsonl shards (pandas+pyarrow, which the
    image ships) laid out as <root>/<split>*.parquet or <root>/<split>/*

`get_svg_and_image` reproduces the reference fallback chain exactly:
augment (prob p) → rasterize → placeholder on failure → placeholder when the
render is pure white (:36-68).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Sequence

import numpy as np

from starvector_tpu_torch.config import instantiate_from_config
from starvector_tpu_torch.data.processor import ImageProcessor, SIGLIP_MEAN, SIGLIP_STD
from starvector_tpu_torch.data.rasterize import rasterize_svg, use_placeholder


class Table:
    """Uniform row-access over list / HF dataset / pandas DataFrame."""

    def __init__(self, rows):
        self._rows = rows

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, idx: int) -> dict:
        row = self._rows[idx]
        if isinstance(row, dict):
            return row
        return dict(row)

    def filter(self, fn) -> "Table":
        return Table([r for r in self if fn(r)])

    def select(self, indices) -> "Table":
        rows = list(self._rows)
        return Table([rows[i] for i in indices])


def load_table(dataset_name: str | Sequence[dict], split: str) -> Table:
    if not isinstance(dataset_name, (str, os.PathLike)):
        return Table(list(dataset_name))
    path = str(dataset_name)
    if os.path.exists(path):
        files = sorted(
            glob.glob(os.path.join(path, f"{split}*.parquet"))
            + glob.glob(os.path.join(path, split, "*.parquet"))
        )
        if files:
            import pandas as pd

            frames = [pd.read_parquet(f) for f in files]
            df = pd.concat(frames, ignore_index=True)
            return Table(df.to_dict("records"))
        files = sorted(
            glob.glob(os.path.join(path, f"{split}*.jsonl"))
            + glob.glob(os.path.join(path, split, "*.jsonl"))
        )
        if files:
            import json

            rows = []
            for f in files:
                with open(f) as fh:
                    rows += [json.loads(line) for line in fh if line.strip()]
            return Table(rows)
        raise FileNotFoundError(f"no {split} parquet/jsonl shards under {path}")
    try:
        from datasets import load_dataset  # type: ignore

        return Table(load_dataset(path, split=split))
    except ImportError as e:
        raise RuntimeError(
            f"dataset {path!r} is not a local directory and the `datasets` "
            "library is not installed"
        ) from e


class SVGDatasetBase:
    def __init__(self, dataset_name, split, im_size, num_samples=-1, **kwargs):
        self.split = split
        self.im_size = im_size

        transforms_cfg = kwargs.get("transforms", False)
        if transforms_cfg:
            self.transforms = instantiate_from_config(transforms_cfg)
            self.p = self.transforms.p
        else:
            self.transforms = None
            self.p = 0.0

        normalization = kwargs.get("normalize", False)
        mean = std = None
        if normalization:
            mean = tuple(normalization.get("mean"))
            std = tuple(normalization.get("std"))

        self.image_processor = kwargs.get("image_processor", None) or ""
        if "siglip" in self.image_processor:
            self.processor = ImageProcessor(
                size=self.im_size, mean=mean or SIGLIP_MEAN, std=std or SIGLIP_STD,
                device="cpu",
            )
        else:
            self.processor = ImageProcessor(size=self.im_size, mean=mean, std=std,
                                            device="cpu")

        self.data = load_table(dataset_name, split)
        print(f"Loaded {len(self.data)} samples from {dataset_name} {split} split")

    def __len__(self):
        return len(self.data)

    def get_svg_and_image(self, svg_str: str, sample_id: Any):
        do_augment = np.random.choice([True, False], p=[self.p, 1 - self.p])
        svg, image = None, None

        if self.transforms is not None and do_augment:
            try:
                svg, image = self.transforms.augment(
                    svg_str, resolution=self.im_size
                )
            except Exception as e:  # noqa: BLE001 — reference logs and falls back
                print(f"Error augmenting {sample_id} due to {e}, trying to rasterize SVG")

        if svg is None or image is None:
            try:
                svg, image = svg_str, rasterize_svg(svg_str, self.im_size)
            except Exception as e:  # noqa: BLE001
                print(f"Error rasterizing {sample_id} due to {e}, using placeholder image")
                svg = use_placeholder()
                image = rasterize_svg(svg, self.im_size)

        if np.array(image).mean() == 255.0:
            print(f"Image is full white, using placeholder image for {sample_id}")
            svg = use_placeholder()
            image = rasterize_svg(svg, self.im_size)

        return svg, self.processor(image).numpy()

    def __getitem__(self, idx):
        raise NotImplementedError
