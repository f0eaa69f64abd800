"""Build and load the hand-written CUDA kernels of `starvector_tpu_torch/csrc`.

The kernels are plain CUDA C++ for Hopper (`sm_90a`) behind a C interface.
At first use, `nvcc` compiles every `csrc/*.cu` into an object, one compiler
process per source, all started together, and links the objects into one
shared library under `starvector_tpu_torch/_build/` (listed in `.gitignore`),
named by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the library. The library is loaded with `ctypes`;
callers pass tensor pointers and the current CUDA stream as `c_void_p`.

Importing this module builds nothing and needs no CUDA toolkit: only the
first call to `library()` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

# the storage types the kernels take and their codes across the C
# interface (csrc/common.cuh, enum DType); int8 is a cache's or a weight's codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
FLOAT_TYPES = (torch.float32, torch.bfloat16)

_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the CUDA kernels build only where the CUDA toolkit is installed"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libsv_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists:
    one nvcc per source, run in parallel, then one link. Writes the
    compilers' output (registers, spills per kernel) to a log beside the
    library."""
    global _build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text[-6000:]}")
    tmp = out.with_name(f"{tag}.tmp.so")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-6000:]}")
    _build_seconds = time.perf_counter() - t0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_seconds() -> float | None:
    """Seconds the last build in this process took (None: no build ran)."""
    return _build_seconds


def build_log() -> str:
    p = library_path().with_suffix(".log")
    return p.read_text() if p.exists() else ""


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sv_flash_prefill.restype = i32
    lib.sv_flash_prefill.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, vp,    # dtype, D, q, k, v, mask, out, lse
        i32, i32, i32, i32, i32,             # B, S, T, H, Hkv
        i64, i64, i64, i64, i64, i64, i64, i64, i64,  # q, k, v strides
        i64, i32, i32, i32, f32, vp,         # m_sb, q_offset, causal, window, scale, stream
    ]
    lib.sv_decode_attention.restype = i32
    lib.sv_decode_attention.argtypes = [
        i32, i32, i32, i32,                  # dtype, cache dtype, G, D
        vp, vp, vp, vp, vp, vp, vp,          # q, k, v, k_new, v_new, mask, bounds
        vp, vp, vp,                          # k_scale, v_scale, out
        vp, vp, i32, i32,                             # workspace, tickets, B, Hkv
        i64, i64, i64, i64, i64, i64, i64, i64, i64,  # q, k, v strides
        i64, i64, i64, i64,                           # k_new, v_new strides
        i64, i64, i64, i64, i64, i64,                 # k_scale, v_scale strides
        i64, i32, i32,                                # m_sb, t_begin, t_end
        i32, i32, i32, f32, vp,                       # t_lo, chunk, splits, scale, stream
    ]
    lib.sv_quant_matmul.restype = i32
    lib.sv_quant_matmul.argtypes = [
        i32, i32, i32,               # x, out and bias dtypes
        vp, vp, vp, vp, vp, vp,      # x, q, scale, bias, out, workspace
        i32, i32, i32, i64, i64,     # M, K, N, x and out row strides
        i32, i32, i32, vp,           # tile rows of x, K splits, rows a split, stream
    ]
    lib.sv_quant_gemv.restype = i32
    lib.sv_quant_gemv.argtypes = [
        i32, i32,                    # out and bias dtypes
        vp, vp, vp, vp, vp, vp, vp,  # x, q, scale, bias, out, workspace, tickets
        i32, i32, i32, i64, i64,     # M, K, N, x and out row strides
        i32, i32, i32, vp,           # blocks, waves of whole tiles, rows of a unit / 64, stream
    ]
    bwd = [
        i32, i32, vp, vp, vp, vp, vp, vp, vp,  # dtype, D, q, k, v, dout, lse, delta, mask
        i32, i32, i32, i32, i32,               # B, S, T, H, Hkv
        ctypes.POINTER(i64), i64,              # 12 strides (q, k, v, dout), m_sb
        i32, i32, i32, f32, vp,                # q_offset, causal, window, scale, stream
    ]
    lib.sv_flash_bwd_dkdv.restype = i32
    lib.sv_flash_bwd_dkdv.argtypes = bwd[:9] + [vp, vp, vp, i32] + bwd[9:]  # dk, dv, ws, head_split
    lib.sv_flash_bwd_dq.restype = i32
    lib.sv_flash_bwd_dq.argtypes = bwd[:9] + [vp] + bwd[9:]        # dq
    lib.sv_error_string.restype = ctypes.c_char_p
    lib.sv_error_string.argtypes = [i32]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if code != 0:
        msg = library().sv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
