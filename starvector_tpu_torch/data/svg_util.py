"""SVG parsing / validity / path utilities (no svgpathtools dependency; the
port's copy of starvector_tpu/data/svg_util.py).

Rebuilds the svgpathtools-backed checks the reference relies on
(reference: starvector/data/util.py:80-86 is_valid_svg via svgstr2paths;
:163-181 find_unclosed_tags) with an in-repo SVG path grammar parser that
also powers geometric augmentation (data/augmentation.py).

The validity contract matches svgstr2paths: the document must be well-formed
XML and every <path> "d" attribute (plus the shape elements svgpathtools
converts: rect/circle/ellipse/line/polyline/polygon) must parse.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator

# argument count per path command
_ARITY = {
    "M": 2, "L": 2, "H": 1, "V": 1, "C": 6, "S": 4, "Q": 4, "T": 2,
    "A": 7, "Z": 0,
}

_NUM_RE = re.compile(
    r"[-+]?(?:\d*\.\d+|\d+\.?)(?:[eE][-+]?\d+)?"
)
_CMD_RE = re.compile(r"[MmLlHhVvCcSsQqTtAaZz]")
_SHAPE_TAGS = ("path", "rect", "circle", "ellipse", "line", "polyline", "polygon")


class PathParseError(ValueError):
    pass


@dataclass
class PathCommand:
    cmd: str                 # single letter, case preserved
    args: list[float] = field(default_factory=list)

    def __iter__(self):
        return iter((self.cmd, self.args))


def tokenize_path(d: str) -> list[PathCommand]:
    """Parse an SVG path data string into commands; raises PathParseError on
    malformed input (the svgstr2paths failure mode the reference keys on)."""
    out: list[PathCommand] = []
    pos = 0
    n = len(d)
    last_cmd = None
    while pos < n:
        ch = d[pos]
        if ch.isspace() or ch == ",":
            pos += 1
            continue
        m = _CMD_RE.match(d, pos)
        if m:
            last_cmd = m.group(0)
            pos = m.end()
            arity = _ARITY[last_cmd.upper()]
            if arity == 0:
                out.append(PathCommand(last_cmd, []))
                continue
        elif last_cmd is None:
            raise PathParseError(f"path data must start with a command: {d[:30]!r}")
        else:
            # implicit command repetition; after M/m it becomes L/l
            if last_cmd in "Mm":
                last_cmd = "L" if last_cmd == "M" else "l"
            arity = _ARITY[last_cmd.upper()]
            if arity == 0:
                raise PathParseError(f"unexpected data after Z at {pos}")
        args: list[float] = []
        for i in range(arity):
            while pos < n and (d[pos].isspace() or d[pos] == ","):
                pos += 1
            if last_cmd in "Aa" and i in (3, 4):
                # arc flags may be single chars without separators
                if pos < n and d[pos] in "01":
                    args.append(float(d[pos]))
                    pos += 1
                    continue
            mnum = _NUM_RE.match(d, pos)
            if not mnum:
                raise PathParseError(
                    f"expected number for {last_cmd!r} arg {i} at {pos}: {d[pos:pos+20]!r}"
                )
            args.append(float(mnum.group(0)))
            pos = mnum.end()
        out.append(PathCommand(last_cmd, args))
    return out


def path_to_str(commands: list[PathCommand]) -> str:
    parts = []
    for c in commands:
        coord = " ".join(_fmt(a) for a in c.args)
        parts.append(c.cmd + (" " + coord if coord else ""))
    return " ".join(parts)


def _fmt(x: float) -> str:
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.6g}"


def _parse_xml(svg_text: str):
    from lxml import etree

    parser = etree.XMLParser(recover=False, huge_tree=True)
    return etree.fromstring(svg_text.encode("utf-8"), parser=parser)


def _iter_shape_elements(root) -> Iterator:
    for el in root.iter():
        tag = el.tag
        if isinstance(tag, str):
            local = tag.rsplit("}", 1)[-1]
            if local in _SHAPE_TAGS:
                yield local, el


def _float_attr(el, name, default=0.0) -> float:
    v = el.get(name)
    if v is None:
        return default
    v = v.strip()
    m = _NUM_RE.match(v)
    if not m:
        raise PathParseError(f"bad numeric attribute {name}={v!r}")
    return float(m.group(0))


def shape_to_path(local: str, el) -> list[PathCommand]:
    """Convert basic shapes to path commands (svgpathtools-equivalent)."""
    if local == "path":
        d = el.get("d")
        if d is None:
            raise PathParseError("<path> without d attribute")
        return tokenize_path(d)
    if local == "rect":
        x, y = _float_attr(el, "x"), _float_attr(el, "y")
        w, h = _float_attr(el, "width"), _float_attr(el, "height")
        return tokenize_path(f"M {x} {y} h {w} v {h} h {-w} Z")
    if local == "circle":
        cx, cy, r = _float_attr(el, "cx"), _float_attr(el, "cy"), _float_attr(el, "r")
        return tokenize_path(
            f"M {cx - r} {cy} a {r} {r} 0 1 0 {2 * r} 0 a {r} {r} 0 1 0 {-2 * r} 0"
        )
    if local == "ellipse":
        cx, cy = _float_attr(el, "cx"), _float_attr(el, "cy")
        rx, ry = _float_attr(el, "rx"), _float_attr(el, "ry")
        return tokenize_path(
            f"M {cx - rx} {cy} a {rx} {ry} 0 1 0 {2 * rx} 0 a {rx} {ry} 0 1 0 {-2 * rx} 0"
        )
    if local == "line":
        x1, y1 = _float_attr(el, "x1"), _float_attr(el, "y1")
        x2, y2 = _float_attr(el, "x2"), _float_attr(el, "y2")
        return tokenize_path(f"M {x1} {y1} L {x2} {y2}")
    if local in ("polyline", "polygon"):
        pts = el.get("points", "")
        nums = [float(m.group(0)) for m in _NUM_RE.finditer(pts)]
        if len(nums) < 4 or len(nums) % 2:
            raise PathParseError(f"bad points attribute: {pts[:40]!r}")
        coords = " L ".join(f"{nums[i]} {nums[i+1]}" for i in range(0, len(nums), 2))
        close = " Z" if local == "polygon" else ""
        return tokenize_path(f"M {coords}{close}")
    raise PathParseError(f"unsupported shape {local}")


def parse_svg_paths(svg_text: str) -> list[tuple[str, list[PathCommand], object]]:
    """Parse every drawable element; raises on malformed XML or path data.
    Returns (tag, commands, element) triples."""
    root = _parse_xml(svg_text)
    out = []
    for local, el in _iter_shape_elements(root):
        out.append((local, shape_to_path(local, el), el))
    return out


def is_valid_svg_strict(svg_text: str) -> bool:
    """True iff the document parses and every shape's geometry parses."""
    try:
        parse_svg_paths(svg_text)
        return True
    except Exception:
        return False


def is_valid_svg(svg_text: str) -> bool:
    """Reference-parity wrapper (data/util.py:80-86): prints the failure."""
    try:
        parse_svg_paths(svg_text)
        return True
    except Exception as e:  # noqa: BLE001
        print(f"Invalid SVG: {e}")
        return False


_TAG_TOKEN = re.compile(r"<(/?)(\w+)([^<>]*?)(/?)>|<(\w+)")


def find_unclosed_tags(svg_content: str) -> list[str]:
    """Tags still open at end of document, in first-seen order — used by the
    streaming renderer to balance partial SVG (behavioral parity with the
    reference's unclosed-tag detection, data/util.py:163-181; different
    algorithm: one linear scan keeping a per-tag open/close balance instead
    of repeated whole-string counting).

    A tag counts as open if it appears more times as `<tag ...>` than as
    `<tag .../>` or `</tag>`. Truncated trailing tags (`<path d="...`) with
    no closing `>` also count as open.
    """
    balance: dict[str, int] = {}
    order: list[str] = []
    for m in _TAG_TOKEN.finditer(svg_content):
        closing, name, _, self_closed, dangling = m.groups()
        if dangling is not None:
            name, closing, self_closed = dangling, "", ""
        if name not in balance:
            balance[name] = 0
            order.append(name)
        if closing:
            balance[name] -= 1
        elif not self_closed:
            balance[name] += 1
    return [t for t in order if balance[t] > 0]
