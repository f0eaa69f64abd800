"""Validation comparison plots (reference: starvector/data/util.py:185-389;
the port of starvector_tpu/utils/plots.py, built with PIL only).

Side-by-side generated/GT/diff panels and the temperature-sweep grid the
reference logs to wandb. Every helper returns the PIL image and optionally
saves it."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw

_PAD = 8
_TITLE = 28  # rows above a panel for its caption (two lines of PIL's default font)


def _diff_image(im1: Image.Image, im2: Image.Image) -> Image.Image:
    a = np.asarray(im1.convert("RGB"), np.float32)
    b = np.asarray(im2.convert("RGB").resize(im1.size), np.float32)
    return Image.fromarray(np.abs(a - b).astype(np.uint8))


def _row(panels: list[Image.Image], titles: list[str] | None = None) -> Image.Image:
    """Panels left to right on white, each under its title."""
    w, h = panels[0].size
    top = _TITLE if titles else 0
    canvas = Image.new("RGB", (len(panels) * (w + _PAD) + _PAD, h + top + 2 * _PAD), "white")
    draw = ImageDraw.Draw(canvas)
    for i, im in enumerate(panels):
        x = _PAD + i * (w + _PAD)
        canvas.paste(im.convert("RGB").resize((w, h)), (x, _PAD + top))
        if titles:
            draw.multiline_text((x, _PAD // 2), titles[i], fill="black")
    return canvas


def plot_images_side_by_side(
    gen_im: Image.Image, gt_im: Image.Image, out_path: str | None = None
) -> Image.Image:
    """[generated | gt | abs-diff] panel (reference data/util.py:206-224)."""
    gen = gen_im.convert("RGB")
    gt = gt_im.convert("RGB").resize(gen.size)
    canvas = _row([gen, gt, _diff_image(gen, gt)])
    if out_path:
        canvas.save(out_path)
    return canvas


def plot_images_side_by_side_with_metrics(
    gen_im: Image.Image, gt_im: Image.Image, l2_dist: float,
    post_processed: bool, out_path: str | None = None,
) -> Image.Image:
    """Annotated comparison panel (reference data/util.py:185-204)."""
    panel = plot_images_side_by_side(gen_im, gt_im)
    w, h = panel.size
    canvas = Image.new("RGB", (w, h + 24), "white")
    canvas.paste(panel, (0, 24))
    ImageDraw.Draw(canvas).text(
        (8, 4), f"MSE: {l2_dist:.4f}  post-processed: {post_processed}", fill="black")
    if out_path:
        canvas.save(out_path)
    return canvas


def plot_images_side_by_side_temperatures(
    samples_temp: dict, metrics: dict, sample_dir: str,
    outpath_filename: str,
) -> Image.Image | None:
    """Temperature-sweep grid: GT + one panel per temperature with its MSE
    (reference data/util.py:226-280), saved as
    `{sample_dir}/{outpath_filename}_temps.png`. `samples_temp` maps
    temperature → result dict holding 'gen_im' and 'gt_im' PIL images;
    `metrics` maps temperature → {'mse': float, ...}."""
    temps = sorted(samples_temp)
    if not temps:
        return None
    panels, titles = [samples_temp[temps[0]]["gt_im"]], ["Original"]
    for t in temps:
        m = metrics.get(t, {})
        panels.append(samples_temp[t]["gen_im"])
        titles.append(f"T={t:.2f}" + (f"\nMSE {m['mse']:.4f}" if "mse" in m else ""))
    canvas = _row(panels, titles)
    canvas.save(os.path.join(sample_dir, f"{outpath_filename}_temps.png"))
    return canvas
