"""The six dataset families (the port's copy of starvector_tpu/data/datasets.py;
reference: starvector/data/{dataset,stacksvg,
emojisvg,figrsvg,fontsvg,iconsvg}.py). Column conventions follow the
published SVG-Bench datasets: `Svg` + `Filename` (or `Id` for FigrSVG),
optional `Caption`, SVG-Stack adds `caption_blip2`/`caption_llava`."""

from __future__ import annotations

import random

from starvector_tpu_torch.data.augmentation import SVGTransforms
from starvector_tpu_torch.data.base import SVGDatasetBase

text2svg_captions = [
    "Draw an SVG of ",
    "Draw an SVG image of ",
    "Draw an SVG picture of ",
    "Generate an SVG of ",
    "Create an SVG of ",
    "Design an SVG of ",
    "Make an SVG of ",
]


class SVGDataset(SVGDatasetBase):
    """Generic dataset with palette color-change and model_name filter
    (reference dataset.py:7-42)."""

    def __init__(self, dataset_name, split, im_size, num_samples=-1, **kwargs):
        super().__init__(dataset_name, split, im_size, num_samples, **kwargs)
        self.color_changer = SVGTransforms(
            {"color_change": True,
             "colors": ["#ff0000", "#0000ff", "#00ff00", "#ffff00", "#000000"]}
        )
        select_dataset_name = kwargs.get("select_dataset_name", False)
        if select_dataset_name:
            self.data = self.data.filter(
                lambda ex: ex.get("model_name") == select_dataset_name
            )
        if num_samples not in (-1, None):
            self.data = self.data.select(range(num_samples))

    def __getitem__(self, idx):
        row = self.data[idx]
        svg, image = self.get_svg_and_image(row["Svg"], row["Filename"])
        return {"svg": svg, "image": image, "id": row["Filename"],
                "caption": row.get("Caption", "")}


class SVGStackDataset(SVGDatasetBase):
    """SVG-Stack with randomized caption templates (reference stacksvg.py)."""

    def __init__(self, dataset_name, split, im_size, num_samples=-1, **kwargs):
        super().__init__(dataset_name, split, im_size, num_samples, **kwargs)
        self.color_changer = SVGTransforms(
            {"color_change": True,
             "colors": ["#ff0000", "#0000ff", "#00ff00", "#ffff00", "#000000"]}
        )
        self.random_caption = kwargs.get("random_caption", True)
        select_dataset_name = kwargs.get("select_dataset_name", False)
        if select_dataset_name:
            self.data = self.data.filter(
                lambda ex: ex.get("model_name") == select_dataset_name
            )
        if num_samples not in (-1, None):
            self.data = self.data.select(range(num_samples))

    def __getitem__(self, idx):
        row = self.data[idx]
        svg, image = self.get_svg_and_image(row["Svg"], row["Filename"])
        caption_column = random.choice(["caption_blip2", "caption_llava"])
        caption = random.choice(text2svg_captions) + (row.get(caption_column) or "")
        return {"svg": svg, "image": image, "id": row["Filename"],
                "caption": caption}


class _SimpleSVGDataset(SVGDatasetBase):
    id_column = "Filename"

    def __init__(self, dataset_name, split, im_size, num_samples=-1, **kwargs):
        super().__init__(dataset_name, split, im_size, **kwargs)
        if num_samples not in (-1, None):
            self.data = self.data.select(range(num_samples))

    def __getitem__(self, idx):
        row = self.data[idx]
        svg, image = self.get_svg_and_image(row["Svg"], row[self.id_column])
        return {"svg": svg, "image": image, "id": row[self.id_column],
                "caption": row.get("Caption", "")}


class EmojiSVGDataset(_SimpleSVGDataset):
    """reference emojisvg.py:5-27"""


class FigrSVGDataset(_SimpleSVGDataset):
    """reference figrsvg.py:6-27 (Id column)"""

    id_column = "Id"


class FontSVGDataset(_SimpleSVGDataset):
    """reference fontsvg.py:6-28"""


class SVGIconsDataset(_SimpleSVGDataset):
    """reference iconsvg.py:6-38"""


class ToySVGDataset:
    """In-memory synthetic dataset (no hub, no network): deterministic
    colored-rect SVGs rasterized through the real pipeline. Exists so the
    train loop, quickstarts, and tests can run end-to-end in zero-egress
    environments; instantiable from config leafs like every hub dataset
    (target: starvector_tpu.data.datasets.ToySVGDataset, which
    starvector_tpu_torch.config maps to this class)."""

    PALETTE = ("red", "green", "blue", "orange", "purple", "teal")

    def __init__(self, num_samples: int = 16, im_size: int = 32, **kwargs):
        from starvector_tpu_torch.data.processor import ImageProcessor
        from starvector_tpu_torch.data.rasterize import rasterize_svg

        proc = ImageProcessor(size=int(im_size), device="cpu")
        self.im_size = int(im_size)
        self.samples = []
        for i in range(int(num_samples)):
            color = self.PALETTE[i % len(self.PALETTE)]
            s = 4 + (i % 8) * 2
            svg = (
                f'<svg xmlns="http://www.w3.org/2000/svg" width="{im_size}" '
                f'height="{im_size}"><rect x="{s}" y="{s}" '
                f'width="{im_size - 2 * s}" height="{im_size - 2 * s}" '
                f'fill="{color}"/></svg>'
            )
            image = proc(rasterize_svg(svg, resolution=self.im_size)).numpy()
            self.samples.append({
                "svg": svg,
                "image": image,
                "id": f"toy-{i}",
                "caption": f"a {color} square",
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return dict(self.samples[idx])
