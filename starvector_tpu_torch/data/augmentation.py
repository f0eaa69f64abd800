"""SVG-space data augmentation (the port's copy of
starvector_tpu/data/augmentation.py): geometric transforms + control-point noise +
color jitter, then re-rasterization.

Rebuilds SVGTransforms (reference: starvector/data/augmentation.py:13-250)
on the in-repo path parser (svg_util) instead of svgpathtools:
  * per-sample sampled rotation (about the viewBox center), translation
    (shift_re/shift_im), uniform scale
  * per-segment noise on Bezier control points / arc radii (gaussian; the
    reference's perlin mode falls back to gaussian here — the `noise` C
    library is not in the image, and its pnoise1(random) usage is
    distributionally white noise anyway)
  * fill-color jitter (color_noise) or replacement from a palette
    (color_change); style="fill:..." promoted to a fill attribute
  * output re-serialized as grouped <path> elements under the original
    opening tag, then rasterized (paths2str semantics, :44-69)

Config surface is identical: {noise_std:{from,to}, noise_type, rotate:
{from,to}, shift_re:{from,to}, shift_im:{from,to}, scale:{from,to},
color_noise:{from,to}, color_change, colors, p}.
"""

from __future__ import annotations

import cmath
import math
import re

import numpy as np

from starvector_tpu_torch.data.svg_util import PathCommand, path_to_str

# minimal CSS color table for the names that appear in SVG corpora
CSS_COLORS = {
    "black": "#000000", "white": "#ffffff", "red": "#ff0000",
    "green": "#008000", "blue": "#0000ff", "yellow": "#ffff00",
    "cyan": "#00ffff", "magenta": "#ff00ff", "gray": "#808080",
    "grey": "#808080", "orange": "#ffa500", "purple": "#800080",
    "brown": "#a52a2a", "pink": "#ffc0cb", "lime": "#00ff00",
    "navy": "#000080", "teal": "#008080", "silver": "#c0c0c0",
    "maroon": "#800000", "olive": "#808000", "gold": "#ffd700",
}


def hex2rgb(color: str) -> np.ndarray:
    c = color.strip().lower()
    if not c.startswith("#"):
        c = CSS_COLORS.get(c, "#ffffff")
    c = c.lstrip("#")
    if len(c) == 3:
        c = "".join(ch * 2 for ch in c)
    return np.array([int(c[i : i + 2], 16) / 255.0 for i in (0, 2, 4)])


def rgb2hex(rgb) -> str:
    r, g, b = (int(round(float(v) * 255)) for v in rgb)
    return f"#{r:02x}{g:02x}{b:02x}"


def _to_absolute(cmds: list[PathCommand]) -> list[PathCommand]:
    """Absolute commands with H/V→L and S/T expanded to C/Q-style handling
    left intact (S keeps 4 args, control reflection not needed for affine)."""
    out: list[PathCommand] = []
    cur = 0j
    start = 0j
    for c in cmds:
        u = c.cmd.upper()
        rel = c.cmd.islower()
        a = list(c.args)
        if u == "Z":
            out.append(PathCommand("Z", []))
            cur = start
            continue
        if u == "H":
            x = a[0] + (cur.real if rel else 0)
            out.append(PathCommand("L", [x, cur.imag]))
            cur = complex(x, cur.imag)
            continue
        if u == "V":
            y = a[0] + (cur.imag if rel else 0)
            out.append(PathCommand("L", [cur.real, y]))
            cur = complex(cur.real, y)
            continue
        if u == "A":
            rx, ry, xrot, laf, sf, x, y = a
            if rel:
                x += cur.real
                y += cur.imag
            out.append(PathCommand("A", [rx, ry, xrot, laf, sf, x, y]))
            cur = complex(x, y)
            continue
        # commands whose args are plain coordinate pairs
        if rel:
            a = [
                v + (cur.real if i % 2 == 0 else cur.imag)
                for i, v in enumerate(a)
            ]
        out.append(PathCommand(u, a))
        cur = complex(a[-2], a[-1])
        if u == "M":
            start = cur
    return out


def _map_points(cmds: list[PathCommand], fn) -> list[PathCommand]:
    """Apply a complex→complex map to every coordinate pair; arcs transform
    endpoint only (radii/rotation handled by the specific transform)."""
    out = []
    for c in cmds:
        if c.cmd == "Z":
            out.append(c)
        elif c.cmd == "A":
            rx, ry, xrot, laf, sf, x, y = c.args
            p = fn(complex(x, y))
            out.append(PathCommand("A", [rx, ry, xrot, laf, sf, p.real, p.imag]))
        else:
            a = []
            for i in range(0, len(c.args), 2):
                p = fn(complex(c.args[i], c.args[i + 1]))
                a += [p.real, p.imag]
            out.append(PathCommand(c.cmd, a))
    return out


def rotate_path(cmds, degrees: float, center: complex):
    rot = cmath.exp(1j * math.radians(degrees))

    def fn(p):
        return (p - center) * rot + center

    out = _map_points(cmds, fn)
    # arcs: x-axis-rotation advances by the rotation angle
    for c in out:
        if c.cmd == "A":
            c.args[2] = (c.args[2] + degrees) % 360
    return out


def translate_path(cmds, shift: complex):
    return _map_points(cmds, lambda p: p + shift)


def scale_path(cmds, s: float):
    out = _map_points(cmds, lambda p: p * s)
    for c in out:
        if c.cmd == "A":
            c.args[0] *= abs(s)
            c.args[1] *= abs(s)
    return out


class SVGTransforms:
    def __init__(self, transformations: dict):
        t = transformations
        self.transformations = t
        self.noise_std = t.get("noise_std", False)
        self.noise_type = t.get("noise_type", False)
        self.rotate = t.get("rotate", False)
        self.shift_re = t.get("shift_re", False)
        self.shift_im = t.get("shift_im", False)
        self.scale = t.get("scale", False)
        self.color_noise = t.get("color_noise", False)
        self.p = t.get("p", 0.5)
        self.color_change = t.get("color_change", False)
        self.colors = t.get("colors", ["#ff0000", "#0000ff", "#000000"])

    # -- per-sample parameter sampling (reference :26-40) -------------------
    def sample_transformations(self):
        if self.rotate:
            self.rotation_angle = np.random.uniform(
                self.rotate["from"], self.rotate["to"]
            )
        if self.shift_re or self.shift_im:
            self.shift_real = np.random.uniform(
                self.shift_re["from"], self.shift_re["to"]
            ) if self.shift_re else 0.0
            self.shift_imag = np.random.uniform(
                self.shift_im["from"], self.shift_im["to"]
            ) if self.shift_im else 0.0
        if self.scale:
            self.scale_value = np.random.uniform(
                self.scale["from"], self.scale["to"]
            )
        if self.color_noise:
            self.color_noise_std = np.random.uniform(
                self.color_noise["from"], self.color_noise["to"]
            )

    def _noise_sample(self) -> complex:
        noise_scale = np.random.uniform(
            self.noise_std["from"], self.noise_std["to"]
        )
        return complex(
            np.random.normal(0.0, noise_scale), np.random.normal(0.0, noise_scale)
        )

    def add_noise(self, cmd: PathCommand) -> PathCommand:
        """Noise on control points (C/S/Q) and arc radii (reference :71-88)."""
        n = self._noise_sample()
        a = list(cmd.args)
        if cmd.cmd == "C":
            a[0] += n.real; a[1] += n.imag
            a[2] += n.real; a[3] += n.imag
        elif cmd.cmd in ("S", "Q"):
            a[0] += n.real; a[1] += n.imag
        elif cmd.cmd == "A":
            a[0] += n.real; a[1] += n.imag
        return PathCommand(cmd.cmd, a)

    def add_color_noise(self, source_color: str) -> str:
        base = hex2rgb(source_color)
        noisy = np.clip(base + np.random.normal(0, self.color_noise_std, 3), 0, 1)
        return rgb2hex(noisy)

    def do_color_change(self, attr: dict) -> dict:
        if "fill" in attr and (self.color_noise or self.color_change):
            fill = attr["fill"]
            if fill != "none":
                if self.color_noise:
                    attr["fill"] = self.add_color_noise(fill)
                elif self.color_change:
                    attr["fill"] = str(np.random.choice(self.colors))
        return attr

    def clean_attributes(self, attr: dict) -> dict:
        """Promote style="fill:..." to a fill attribute (reference :139-153)."""
        if "fill" in attr:
            return dict(attr)
        if "style" in attr:
            m = re.findall(r"fill:[^;]+", attr["style"])
            if m:
                return {"fill": m[0].replace("fill:", "").strip()}
        return dict(attr)

    def get_viewbox_size(self, svg: str) -> tuple[float, float, float, float]:
        """(min_x, min_y, width, height). viewBox separators may be spaces
        AND/OR commas per the SVG spec; min-x/min-y are honored so rotation
        happens about the true content center, not the origin's."""
        m = re.search(r'viewBox="([^"]+)"', svg)
        if m:
            vb = m.group(1)
        else:
            m = re.search(r'width="([0-9.]+)(?:px)?" height="([0-9.]+)(?:px)?"', svg)
            vb = f"0 0 {m.group(1)} {m.group(2)}" if m else "0 0 256 256"
        parts = [float(x) for x in vb.replace(",", " ").split()]
        if len(parts) == 2:
            parts = [0.0, 0.0, *parts]
        return parts[0], parts[1], parts[2], parts[3]

    # -- main entry (reference :173-250) ------------------------------------
    def augment(self, svg: str, resolution: int = 224):
        from starvector_tpu_torch.data.rasterize import rasterize_svg
        from starvector_tpu_torch.data.svg_util import parse_svg_paths

        self.sample_transformations()

        m = re.findall(r"<svg[^>]*>", svg)
        svg_opening_tag = m[0] if m else '<svg xmlns="http://www.w3.org/2000/svg">'
        vx, vy, vw, vh = self.get_viewbox_size(svg)
        center = complex(vx + vw / 2, vy + vh / 2)

        try:
            parsed = parse_svg_paths(svg)
        except Exception:
            return svg, rasterize_svg(svg, resolution)
        if not parsed:
            return svg, rasterize_svg(svg, resolution)

        path_strings = []
        for tag, cmds, el in parsed:
            attrs = self.clean_attributes(
                {k.rsplit("}", 1)[-1]: v for k, v in el.attrib.items()}
            )
            cmds = _to_absolute(cmds)
            if self.rotate:
                cmds = rotate_path(cmds, self.rotation_angle, center)
            if self.shift_re or self.shift_im:
                cmds = translate_path(cmds, complex(self.shift_real, self.shift_imag))
            if self.scale:
                cmds = scale_path(cmds, self.scale_value)
            if self.noise_std:
                cmds = [self.add_noise(c) for c in cmds]
            attrs = self.do_color_change(attrs)
            attr_str = "".join(
                f' {k}="{v}"' for k, v in attrs.items()
                if k not in ("d", "cx", "cy", "rx", "ry", "r", "x", "y",
                             "width", "height", "x1", "y1", "x2", "y2", "points")
            )
            path_strings.append(f'<path d="{path_to_str(cmds)}"{attr_str} />')

        out_svg = svg_opening_tag + "\n" + "\n".join(path_strings) + "\n</svg>"
        return out_svg, rasterize_svg(out_svg, resolution)
