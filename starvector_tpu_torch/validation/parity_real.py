"""Real-checkpoint fidelity harness (the port of starvector_tpu/validation/
parity_real.py): prove that a StarVector checkpoint run through the port
reproduces reference outputs (the BASELINE north star — MSE/SSIM parity on
SVG-Bench; reference flow: starvector/validation/validate.py:33-56 +
scripts/quickstart.py:9-20).

Weights-gated by design: real checkpoints are not in the repository. The
harness runs on tiny random models in tests; with `STARVECTOR_CKPT_DIR`
pointing at a real HF StarVector checkpoint directory, `run_parity` writes
the parity artifact.

Three nested levels of evidence, strongest available wins:
  1. port-vs-reference greedy decode on the fixed probe set — token exact
     match + per-sample raster MSE/SSIM deltas (needs transformers + the
     checkpoint's bundled remote code; the reference HF path,
     starvector_hf_validator.py:43-88).
  2. port-only fidelity vs ground truth: greedy im2svg on rasterized probe
     SVGs, MSE/SSIM of the reconstruction (the SVG-Bench protocol without
     the paired reference run).
  3. Converter self-consistency: the port's export_hf_checkpoint, then
     load_pretrained_model, then a bit-compare of every parameter (no
     generation; catches layout drift on real geometry).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from starvector_tpu_torch.data.rasterize import process_and_rasterize_svg, rasterize_svg
from starvector_tpu_torch.metrics.ssim import ssim_single
from starvector_tpu_torch.validation.parity_samples import SAMPLES


def raster_mse(img_a, img_b) -> float:
    """Mean squared error on [0,1] floats (the SVG-Bench L2 protocol,
    reference metrics/compute_l2.py:14-22)."""
    a = np.asarray(img_a, np.float32) / 255.0
    b = np.asarray(img_b, np.float32) / 255.0
    return float(np.mean((a - b) ** 2))


def raster_ssim(img_a, img_b) -> float:
    """Mean channelwise SSIM (reference compute_SSIM.py:12-35 semantics)."""
    a = np.asarray(img_a, np.float64)
    b = np.asarray(img_b, np.float64)
    return float(np.mean([
        ssim_single(a[..., c], b[..., c]) for c in range(a.shape[-1])
    ]))


def score_generation(gt_svg: str, gen_svg: str, resolution: int = 224) -> dict:
    """Post-process + rasterize a generated SVG and score it against the
    ground-truth raster (the validator's per-sample metric core)."""
    gt_img = rasterize_svg(gt_svg, resolution)
    out_svg, gen_img = process_and_rasterize_svg(gen_svg, resolution)
    return {
        "mse": raster_mse(gt_img, gen_img),
        "ssim": raster_ssim(gt_img, gen_img),
        "post_processed": out_svg != gen_svg,
        "svg": out_svg,
    }


def generate_torch(model, samples: Sequence[tuple[str, str]],
                   *, max_new_tokens: int = 512, resolution: int = 224) -> list[dict]:
    """Greedy im2svg through the port's model on the probe set. `model` is
    any object with the reference generation surface (process_images +
    generate_im2svg): api.StarVectorForCausalLM from a checkpoint, or a
    tiny one in tests."""
    results = []
    for sid, gt_svg in samples:
        image = rasterize_svg(gt_svg, resolution)
        t0 = time.perf_counter()
        svg = model.generate_im2svg(
            {"image": model.process_images([image])},
            max_new_tokens=max_new_tokens,
            use_nucleus_sampling=False,
            temperature=0.0,
        )[0]
        scores = score_generation(gt_svg, svg, resolution)
        results.append({
            "id": sid,
            "gen_svg": svg,
            "latency_s": round(time.perf_counter() - t0, 3),
            **{k: scores[k] for k in ("mse", "ssim", "post_processed")},
        })
    return results


def _reference_unavailable_reason(ckpt_dir: str) -> str | None:
    """The paired reference run needs the checkpoint's bundled
    trust_remote_code modules (the reference serves its arch that way,
    starvector_arch.py:133) and transformers."""
    if not os.path.exists(os.path.join(ckpt_dir, "starvector_arch.py")) and \
       not os.path.exists(os.path.join(ckpt_dir, "config.json")):
        return "checkpoint carries no config"
    try:
        import transformers  # noqa: F401
    except ImportError:
        return "transformers unavailable"
    return None


def generate_reference(ckpt_dir: str, samples: Sequence[tuple[str, str]],
                       *, max_new_tokens: int = 512,
                       resolution: int = 224) -> list[dict] | str:
    """Greedy im2svg through the reference HF path (AutoModelForCausalLM +
    trust_remote_code — the checkpoint ships the reference modules), on
    the CPU in fp32. Returns a reason string when that path can't run."""
    reason = _reference_unavailable_reason(ckpt_dir)
    if reason:
        return reason
    from transformers import AutoModelForCausalLM

    try:
        model = AutoModelForCausalLM.from_pretrained(
            ckpt_dir, trust_remote_code=True, torch_dtype=torch.float32,
            use_flash_attn=False,
        )
    except Exception as e:  # noqa: BLE001 — remote code may need CUDA-only deps
        return f"reference load failed: {e!r}"
    model.eval()
    results = []
    for sid, gt_svg in samples:
        image = rasterize_svg(gt_svg, resolution)
        t0 = time.perf_counter()
        with torch.no_grad():
            batch = {"image": model.process_images([image]).to(torch.float32)}
            svg = model.generate_im2svg(
                batch, max_length=max_new_tokens, num_beams=1,
                use_nucleus_sampling=False, temperature=0.0,
            )[0]
        scores = score_generation(gt_svg, svg, resolution)
        results.append({
            "id": sid,
            "gen_svg": svg,
            "latency_s": round(time.perf_counter() - t0, 3),
            **{k: scores[k] for k in ("mse", "ssim", "post_processed")},
        })
    return results


def token_match(tokenizer, svg_a: str, svg_b: str) -> dict:
    """Exact + prefix token agreement between two generations (greedy
    decode parity should be token-exact up to numerics)."""
    ids_a = tokenizer.token_ids(svg_a)
    ids_b = tokenizer.token_ids(svg_b)
    n = min(len(ids_a), len(ids_b))
    prefix = 0
    for x, y in zip(ids_a, ids_b):
        if x != y:
            break
        prefix += 1
    return {
        "exact": ids_a == ids_b,
        "prefix_match": prefix,
        "len_a": len(ids_a),
        "len_b": len(ids_b),
        "prefix_ratio": prefix / max(n, 1),
    }


def _leaves(tree: dict, path: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def converter_self_consistency(params: dict, cfg, tokenizer, tmp_dir: str) -> dict:
    """The port's export_hf_checkpoint, then load_pretrained_model at fp32
    on the parameters' device, then a bit-compare of every leaf (as fp32):
    catches state-dict layout drift at the checkpoint's true geometry
    without any generation."""
    from starvector_tpu_torch.models.builder import load_pretrained_model
    from starvector_tpu_torch.train.hub import export_hf_checkpoint

    leaves1 = list(_leaves(params))
    out = export_hf_checkpoint(params, cfg, tokenizer, tmp_dir)
    params2, cfg2, *_ = load_pretrained_model(out, torch.float32, leaves1[0][1].device)
    leaves2 = dict(_leaves(params2))
    mismatched = []
    for path, leaf in leaves1:
        other = leaves2.get(path)
        if other is None or leaf.shape != other.shape or \
                not torch.equal(leaf.float(), other.float()):
            mismatched.append(path)
    return {
        "n_leaves": len(leaves1),
        "mismatched": mismatched,
        "bit_exact": not mismatched,
        "decoder": cfg2.decoder,
    }


def run_parity(
    ckpt_dir: str,
    out_dir: str,
    *,
    model: Any = None,
    samples: Sequence[tuple[str, str]] | None = None,
    max_new_tokens: int = 512,
    resolution: int = 224,
    with_reference: bool = True,
    with_roundtrip: bool = True,
    device="cuda",
) -> dict:
    """Produce the parity artifact: parity_report.json + generated SVGs in
    `out_dir`. `model` overrides checkpoint loading (tests pass a tiny
    model and set ckpt_dir='synthetic'); otherwise the checkpoint loads on
    `device`, the card unless `device="cpu"`."""
    samples = list(samples if samples is not None else SAMPLES)
    os.makedirs(out_dir, exist_ok=True)
    if model is None:
        from starvector_tpu_torch.api import StarVectorForCausalLM

        model = StarVectorForCausalLM.from_pretrained(ckpt_dir, device=device)

    report: dict[str, Any] = {
        "checkpoint": ckpt_dir,
        "n_samples": len(samples),
        "max_new_tokens": max_new_tokens,
        "resolution": resolution,
    }

    port_results = generate_torch(
        model, samples, max_new_tokens=max_new_tokens, resolution=resolution
    )
    report["torch"] = {
        "per_sample": [
            {k: r[k] for k in ("id", "mse", "ssim", "post_processed", "latency_s")}
            for r in port_results
        ],
        "mean_mse": float(np.mean([r["mse"] for r in port_results])),
        "mean_ssim": float(np.mean([r["ssim"] for r in port_results])),
    }
    for r in port_results:
        with open(os.path.join(out_dir, f"{r['id']}.torch.svg"), "w") as f:
            f.write(r["gen_svg"])

    if with_reference:
        ref = generate_reference(
            ckpt_dir, samples, max_new_tokens=max_new_tokens,
            resolution=resolution,
        )
        if isinstance(ref, str):
            report["reference"] = {"skipped": ref}
        else:
            matches = [
                token_match(model.tokenizer, p["gen_svg"], r["gen_svg"])
                for p, r in zip(port_results, ref)
            ]
            report["reference"] = {
                "per_sample": [
                    {k: r[k] for k in ("id", "mse", "ssim", "latency_s")}
                    for r in ref
                ],
                "mean_mse": float(np.mean([r["mse"] for r in ref])),
                "mean_ssim": float(np.mean([r["ssim"] for r in ref])),
                "token_exact_rate": float(np.mean([m["exact"] for m in matches])),
                "token_prefix_ratio": float(
                    np.mean([m["prefix_ratio"] for m in matches])
                ),
                "mse_delta_vs_torch": float(
                    report["torch"]["mean_mse"] - np.mean([r["mse"] for r in ref])
                ),
                "ssim_delta_vs_torch": float(
                    report["torch"]["mean_ssim"] - np.mean([r["ssim"] for r in ref])
                ),
            }
            for r in ref:
                with open(os.path.join(out_dir, f"{r['id']}.ref.svg"), "w") as f:
                    f.write(r["gen_svg"])

    if with_roundtrip:
        report["converter_roundtrip"] = converter_self_consistency(
            model.params, model.cfg, model.tokenizer,
            os.path.join(out_dir, "roundtrip_ckpt"),
        )

    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report
