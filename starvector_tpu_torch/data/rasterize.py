"""SVG rasterization + normalization with reference-parity fallbacks (the
port's copy of starvector_tpu/data/rasterize.py, which the port does not
import).

Rebuilds the cairosvg-based helpers (reference: starvector/data/util.py):
  * rasterize_svg (:138-161): svg → PIL RGB at a forced square resolution on
    a white background; fallback chain raster → clean+raster → white image
  * clean_svg (:88-117): prettify → cairo svg2svg normalization with a 5 s
    timeout → "<svg></svg>" fallback; strips the <?xml?> header
  * process_and_rasterize_svg (:123-136): validity-gated clean + raster
  * is_valid_svg (:80-86): parseability check (path-level, see svg_util)

The cairo work runs through the native librsvg/cairo module
(starvector_tpu_torch/native/rasterizer.cpp), built with g++ at first use
into starvector_tpu_torch/_build/ under a hash of the source. The
reference's SIGALRM guard cannot actually interrupt a hung C call; here the
timeout path runs in a disposable worker process that is killed on expiry —
same semantics, actually enforceable. Where librsvg/cairo is missing
(rasterizer_available(), decided once a process), clean_svg and
rasterize_svg return the reference's fallbacks, '<svg></svg>' and a white
image, without starting a worker.
"""

from __future__ import annotations

import ctypes
import hashlib
import multiprocessing as mp
import os
import subprocess
from typing import Optional

import numpy as np

VOID_SVG = "<svg></svg>"
_PACKAGE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
_SOURCE = os.path.join(_PACKAGE_DIR, "native", "rasterizer.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build_lib())
    lib.sv_rasterize.restype = ctypes.c_int
    lib.sv_rasterize.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_char_p,
        ctypes.c_ulong,
    ]
    lib.sv_svg2svg.restype = ctypes.c_int
    lib.sv_svg2svg.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_ulong), ctypes.c_char_p, ctypes.c_ulong,
    ]
    lib.sv_free.argtypes = [ctypes.c_char_p]
    lib.sv_available.restype = ctypes.c_int
    if not lib.sv_available():
        raise RuntimeError("librsvg/cairo not available on this system")
    _lib = lib
    return lib


def _build_lib() -> str:
    """The rasterizer's shared library, compiled unless this source's build
    exists. The compiler writes beside the final name and the file is
    renamed into place, so a concurrent process never loads half a file."""
    with open(_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"librasterizer_{tag}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-Wall", "-shared", "-fPIC", _SOURCE, "-o", tmp, "-ldl"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    return path


class RasterizeError(RuntimeError):
    pass


def _raster_native(svg: str, resolution: int, dpi: float) -> np.ndarray:
    lib = _load_lib()
    data = svg.encode("utf-8")
    out = (ctypes.c_ubyte * (resolution * resolution * 3))()
    err = ctypes.create_string_buffer(512)
    rc = lib.sv_rasterize(
        data, len(data), resolution, resolution, dpi, out, err, 512
    )
    if rc != 0:
        raise RasterizeError(err.value.decode(errors="replace") or f"rc={rc}")
    return np.frombuffer(bytes(out), np.uint8).reshape(resolution, resolution, 3)


def _svg2svg_native(svg: str, out_w: float, out_h: float, dpi: float) -> str:
    lib = _load_lib()
    data = svg.encode("utf-8")
    buf = ctypes.c_char_p()
    blen = ctypes.c_ulong()
    err = ctypes.create_string_buffer(512)
    rc = lib.sv_svg2svg(
        data, len(data), out_w, out_h, dpi,
        ctypes.byref(buf), ctypes.byref(blen), err, 512,
    )
    if rc != 0:
        raise RasterizeError(err.value.decode(errors="replace") or f"rc={rc}")
    try:
        return ctypes.string_at(buf, blen.value).decode("utf-8", errors="replace")
    finally:
        lib.sv_free(buf)


# ---------------------------------------------------------------------------
# killable-timeout execution (replaces the reference's SIGALRM guard)
# ---------------------------------------------------------------------------

def _worker_entry(conn, fn_name, args):
    try:
        fn = {"svg2svg": _svg2svg_native, "raster": _raster_native}[fn_name]
        conn.send(("ok", fn(*args)))
    except BaseException as e:  # noqa: BLE001 - worker must always report
        conn.send(("err", repr(e)))
    finally:
        conn.close()


def _main_importable() -> bool:
    """forkserver/spawn children re-import __main__; from a stdin/interactive
    host that import fails before the worker entry runs, killing every call."""
    import sys

    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    return bool(path and os.path.exists(path))


def _call_with_timeout(fn_name: str, args: tuple, timeout: float):
    if not _main_importable():
        # interactive host: no subprocess possible — run in-process and give
        # up the kill-on-timeout guarantee rather than failing every call
        fn = {"svg2svg": _svg2svg_native, "raster": _raster_native}[fn_name]
        return fn(*args)
    # forkserver: fork() from a multithreaded host (torch spins threads) risks
    # deadlock; the forkserver parent stays single-threaded
    ctxm = mp.get_context("forkserver")
    parent, child = ctxm.Pipe()
    p = ctxm.Process(target=_worker_entry, args=(child, fn_name, args))
    p.start()
    child.close()
    if parent.poll(timeout):
        try:
            status, payload = parent.recv()
        except (EOFError, OSError) as e:
            # worker died without a message (librsvg segfault on a malformed
            # SVG closes the pipe; poll() reports EOF as readable) — treat
            # like any other rasterization failure, not a crash
            p.kill()
            p.join(1)
            raise RasterizeError(f"{fn_name} worker died: {e}") from e
        p.join(1)
        if status == "ok":
            return payload
        raise RasterizeError(payload)
    p.kill()
    p.join(1)
    raise TimeoutError(f"{fn_name} timed out after {timeout}s")


# ---------------------------------------------------------------------------
# public API (reference-parity surface)
# ---------------------------------------------------------------------------

def clean_svg(
    svg_text: str,
    output_width: Optional[int] = None,
    output_height: Optional[int] = None,
    *,
    timeout: float = 5.0,
) -> str:
    """Normalize SVG via cairo svg2svg with a hard 5 s timeout (reference
    clean_svg, data/util.py:88-117). Falls back to '<svg></svg>'."""
    if not rasterizer_available():
        return VOID_SVG
    try:
        from bs4 import BeautifulSoup

        pretty = BeautifulSoup(svg_text, "xml").prettify()
    except Exception:
        pretty = svg_text
    try:
        out = _call_with_timeout(
            "svg2svg",
            (pretty, float(output_width or 0), float(output_height or 0), 96.0),
            timeout,
        )
    except (TimeoutError, RasterizeError):
        out = VOID_SVG
    return "\n".join(
        line for line in out.split("\n") if not line.strip().startswith("<?xml")
    )


def rasterize_svg(svg_string: str, resolution: int = 224, dpi: float = 128,
                  scale: float = 2, *, timeout: float | None = None):
    """svg → PIL RGB image, white background, forced square resolution
    (reference rasterize_svg, data/util.py:138-161). `scale` kept for
    signature parity (ignored when an output size is forced, matching
    cairosvg). Fallbacks: raster → clean+raster → white image."""
    from PIL import Image

    if not rasterizer_available():
        return Image.fromarray(np.full((resolution, resolution, 3), 255, np.uint8), "RGB")

    def _run(svg):
        if timeout is not None:
            return _call_with_timeout("raster", (svg, resolution, dpi), timeout)
        return _raster_native(svg, resolution, dpi)

    try:
        arr = _run(svg_string)
    except Exception:
        try:
            arr = _run(clean_svg(svg_string))
        except Exception:
            arr = np.full((resolution, resolution, 3), 255, np.uint8)
    return Image.fromarray(arr, "RGB")


def use_placeholder() -> str:
    return VOID_SVG


def process_and_rasterize_svg(svg_string: str, resolution: int = 256,
                              dpi: float = 128, scale: float = 2):
    """Validity-gated clean + raster (reference data/util.py:123-136)."""
    from starvector_tpu_torch.data.svg_util import is_valid_svg_strict

    try:
        if not is_valid_svg_strict(svg_string):
            raise ValueError("invalid svg")
        out_svg = svg_string
    except Exception:
        try:
            svg = clean_svg(svg_string)
            if not is_valid_svg_strict(svg):
                raise ValueError("still invalid")
            out_svg = svg
        except Exception:
            out_svg = use_placeholder()
    raster_image = rasterize_svg(out_svg, resolution, dpi, scale)
    return out_svg, raster_image


_available: bool | None = None


def rasterizer_available() -> bool:
    """Whether librsvg/cairo can be loaded here; decided at the first call
    of a process."""
    global _available
    if _available is None:
        try:
            _load_lib()
            _available = True
        except Exception:  # noqa: BLE001 -- any failure to build or load
            _available = False
    return _available
