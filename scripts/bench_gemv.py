"""Kernel 14's GEMV (M <= 16 rows of x) on the card: the tensor-core GEMV
(`quant_matmul.launch_gemv_tc`, on the plan `gemv_plan` picks and, at
M = 4, on others) beside the CUDA-core split-K pair
(path "gemv"), the bf16 cuBLAS addmm over the dequantized weight and
torch._weight_int8pack_mm, with each call's bound, at the 1B's and the
8B's projections and a tensor-8 rank's slices (chip_smoke.py's
QMM_SHAPES, QMM_SHAPES_8B, QMM_TP_SHAPES), M = 1, 4, 8, 16.

First it holds every variant against the plain version (QMM_TOL) at
every M from 1 to 16, bias none / fp32 / bf16, bf16 and fp32 out, and two
launches bit for bit; any failure raises before a time is taken.

Each time is a graph of launches replayed between two CUDA events
(chip_smoke.rotated_ms) over copies of the weights that together pass 160 MB,
one copy a launch in turn, so every launch reads its codes from HBM as a
decode step does (its 24 or 32 layers' weights do not fit the 50 MB L2).
Variants of one shape are timed in turns (a, b, ..., b, a).

    python3 scripts/bench_gemv.py [--out chiprun_out/bench_gemv.json] [--quick]

It needs the card; it prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its timers, bounds and shapes)

ROWS = (1, 4, 8, 16)
ROTATE_BYTES = 160 << 20


def shapes() -> list[tuple[str, int, int, bool]]:
    """(name, K, N, row-parallel) of every GEMV shape on the main path."""
    out = [(f"1B {n}", K, N, False) for n, K, N in cs.QMM_SHAPES]
    out += [(f"8B {n}", K, N, False) for n, K, N in cs.QMM_SHAPES_8B]
    out += [(n, K, N, row) for n, K, N, row, _ in cs.QMM_TP_SHAPES]
    return out


def variants(tq, K: int, N: int, sweep: bool = True) -> dict:
    """name -> fn(x, q, scale, bias, out_dtype): the pair and the
    tensor-core GEMV on gemv_plan's plan (blocks G, waves of whole tiles W,
    units of 64 ku rows of K) and, with `sweep`, on others: the other unit
    height, and blocks for runs of 1, 2, 4 and 8 units of 64 rows (at most
    one an SM), each with as many waves of whole tiles as fit and none."""
    G0, W0, ku0 = tq.gemv_plan(K, N)
    out = {"pair": lambda x, q, s, b, o: tq.launch_kernel(x, q, s, b, o, "gemv", 0,
                                                          *tq.gemv_split(K, N))}

    seen = set()

    def add(name, G, W, ku):
        if tq.gemv_plan_ok(K, N, G, W, ku) and (G, W, ku) not in seen:
            seen.add((G, W, ku))
            out[name] = lambda x, q, s, b, o: tq.launch_gemv_tc(x, q, s, b, o, G, W, ku)

    add(f"plan G={G0} W={W0} ku{ku0}", G0, W0, ku0)
    if sweep:
        for ku in (1, 4):
            tiles, k_units = tq.gemv_units(K, N, ku)
            for rows in (1, 2, 4, 8):  # units of 64 rows a block
                G = max(1, min(132, tiles * k_units * ku // rows))
                for W in sorted({0, tiles // G}):
                    add(f"G={G} W={W} ku{ku}", G, W, ku)
    return out


def check(tq, dev) -> None:
    """Every variant against the plain version at every shape, at M = 4
    and 16 (one and two n8 tiles of x), bf16 bias and out; gemv_plan's plan
    at every M from 1 to 16 at the 1B's c_fc and the 8B's k/v and at M = 1,
    8, 9 elsewhere, bias none / fp32 / bf16 (fp32 out and no bias: a
    row-parallel rank's partial), bf16 and fp32 out; to QMM_TOL, and two
    launches bit for bit."""
    g = torch.Generator(device=dev).manual_seed(31)
    n_checks = 0
    for name, K, N, _ in shapes():
        p = tq.quantize_dense({"kernel": torch.randn((K, N), generator=g, device=dev) * 0.02})
        bias = torch.randn((N,), generator=g, device=dev)
        every = name in ("1B mlp.c_fc", "8B attn.k_proj, v_proj")
        cases = [(M, v, b, o) for M in (4, 16) for v in variants(tq, K, N)
                 for b, o in ((bias.bfloat16(), torch.bfloat16),)]
        cases += [(M, v, b, o) for M in (range(1, 17) if every else (1, 8, 9))
                  for v in variants(tq, K, N, sweep=False)
                  for b in (None, bias, bias.bfloat16()) for o in (torch.bfloat16, torch.float32)]
        xs = {}
        for M, vname, b, out_dtype in cases:
            x = xs.setdefault(M, torch.randn((M, K), generator=g, device=dev).bfloat16())
            fn = variants(tq, K, N)[vname]
            out = fn(x, p["kernel_q"], p["scale"], b, out_dtype)
            ref = tq.quant_matmul_plain(x, p["kernel_q"], p["scale"], b, out_dtype=out_dtype)
            again = fn(x, p["kernel_q"], p["scale"], b, out_dtype)
            torch.cuda.synchronize()
            what = (f"{name} M={M} {vname} bias={None if b is None else str(b.dtype)[6:]} "
                    f"out={out_dtype}")
            cs.compare(what, out, ref, out_dtype, tols=cs.QMM_TOL)
            if not torch.equal(out, again):
                raise AssertionError(f"{what}: two launches differ")
            n_checks += 1
        cs.log("check", f"{name} (K={K}, N={N}): every variant matches the plain version")
    cs.log("check", f"{n_checks} cases match the plain version to QMM_TOL, bit for bit twice")


def rotated(K: int, N: int, g, dev) -> list:
    """Copies of random codes, scales and a bf16 bias that pass
    ROTATE_BYTES together (at most 64)."""
    n = max(2, min(64, -(-ROTATE_BYTES // (K * N))))
    return [(torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
             torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-4,
             torch.randn((N,), generator=g, device=dev).bfloat16()) for _ in range(n)]


def times(tq, dev, card: str, quick: bool) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(32)
    rows = []
    for name, K, N, row in shapes():
        ws = rotated(K, N, g, dev)
        w16 = [(kq.float() * sc).bfloat16() for kq, sc, _ in ws]
        out_dtype = torch.float32 if row else torch.bfloat16
        for M in ROWS:
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            vs = variants(tq, K, N, sweep=not quick and M == 4)
            order = list(vs) + list(vs)[::-1]
            got: dict[str, list[float]] = {k: [] for k in vs}
            for k in order:
                fn = vs[k]
                got[k].append(cs.rotated_ms(lambda w: fn(x, w[0], w[1], None if row else w[2],
                                                    out_dtype), ws))
            ms = {k: sum(v) / len(v) for k, v in got.items()}
            addmm = cs.rotated_ms(lambda w: torch.mm(x, w) if row else torch.addmm(ws[0][2], x, w),
                             w16)
            kq_nk, sc16 = ws[0][0].t().contiguous(), ws[0][1].bfloat16()
            lib = cs.library_ms(lambda: torch._weight_int8pack_mm(x, kq_nk, sc16),
                                "torch._weight_int8pack_mm")
            out_bytes = M * N * (4 if row else 2)
            b_ms, b_by = cs.bound(M * K * 2 + K * N + N * 4 + (0 if row else N * 2) + out_bytes,
                                  2 * M * K * N)
            rule = tq.gemv_path(M, K, N, torch.bfloat16)
            picked = ms["plan G={} W={} ku{}".format(*tq.gemv_plan(K, N))] \
                if rule == "gemv_tc" else ms["pair"]
            rows.append(dict(shape=name, K=K, N=N, M=M, row_parallel=row, ms=ms, addmm_ms=addmm,
                             int8pack_ms=lib, bound_ms=b_ms, bound_by=b_by, rule=rule,
                             picked_ms=picked))
            cs.log("times", f"{card}: GEMV {name} K={K} N={N} M={M}"
                            f"{' (row-parallel: fp32 out, no bias)' if row else ''}: "
                            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                            + f" ms; rule {rule} {picked:.4f} ms = {b_ms / picked:.1%} of the "
                              f"bound {b_ms:.4f} ms ({b_by}); bf16 addmm {addmm:.4f}"
                            + " ms; int8pack_mm " + ("n/a" if lib is None else f"{lib:.4f}")
                            + " ms")
        del ws, w16
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "bench_gemv.json")
    parser.add_argument("--quick", action="store_true",
                        help="time only the pair and gemv_plan's plan (other plans are timed at "
                             "M = 4 only in any case)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_gemv: no CUDA device: this script runs kernel 14 on an H100", file=sys.stderr)
        return 2
    from starvector_tpu_torch.ops import kernel_lib
    from starvector_tpu_torch.ops import quantization as tq

    card = cs.card_line()
    cs.log("card", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.library()
    cs.log("build", "; ".join(line for line in cs.ptxas_summary(kernel_lib.build_log())
                              if line.startswith("qmm_gemv")))
    sass = cs.sass_counts(kernel_lib.library_path(), kernel_lib.find_nvcc())
    cs.log("build", ", ".join(f"{k}: HMMA {v['HMMA']} HGMMA {v['HGMMA']}"
                              for k, v in sorted(sass.items()) if k.startswith("qmm_gemv")))
    dev = torch.device("cuda")
    check(tq, dev)
    rows = times(tq, dev, card, args.quick)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    cs.log("times", f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
