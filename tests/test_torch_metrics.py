"""The port's pixel metrics and orchestrator against the JAX package's
(starvector_tpu_torch/metrics/{l2,ssim,model_metrics,metrics}.py against
starvector_tpu/metrics/), on images, SVGs and flags made from a numpy
seed: ratios and counts equal exactly, float metrics to 1e-7 absolute."""

import numpy as np
import pytest
from PIL import Image

from starvector_tpu.metrics import SVGMetrics as JSVGMetrics
from starvector_tpu.metrics.l2 import L2DistanceCalculator as JL2
from starvector_tpu.metrics.model_metrics import CountTokenLength as JCount
from starvector_tpu.metrics.model_metrics import frechet_distance as jfrechet
from starvector_tpu.metrics.ssim import SSIMDistanceCalculator as JSSIM
from starvector_tpu_torch.data.rasterize import rasterizer_available
from starvector_tpu_torch.metrics import SVGMetrics
from starvector_tpu_torch.metrics.l2 import L2DistanceCalculator
from starvector_tpu_torch.metrics.model_metrics import CountTokenLength, frechet_distance
from starvector_tpu_torch.metrics.ssim import SSIMDistanceCalculator
from starvector_tpu_torch.validation.parity_samples import SAMPLES

needs_native = pytest.mark.skipif(not rasterizer_available(),
                                  reason="librsvg/cairo unavailable")
ATOL = 1e-7


def _images(n, seed, size=32):
    """n RGB images: a white background with seeded colored rectangles."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = np.full((size, size, 3), 255, np.uint8)
        for _ in range(3):
            y, x = rng.integers(0, size - 8, 2)
            a[y:y + 8, x:x + 8] = rng.integers(0, 256, 3)
        out.append(Image.fromarray(a))
    return out


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 2, (n, 2)).astype(bool)
    return {
        "gt_im": _images(n, seed), "gen_im": _images(n, seed + 1),
        "gt_svg": [SAMPLES[i][1] for i in range(n)],
        "gen_svg": [SAMPLES[-1 - i][1][: 40 + 7 * i] for i in range(n)],
        "json": [{"sample_id": f"s{i}", "post_processed": bool(flags[i, 0]),
                  "no_compile": bool(flags[i, 1])} for i in range(n)],
    }


@pytest.mark.parametrize("masked", [False, True])
def test_l2_equals_jax(masked):
    b = _batch()
    ours, ref = L2DistanceCalculator(masked_l2=masked), JL2(masked_l2=masked)
    for gt, gen in zip(b["gt_im"], b["gen_im"]):
        assert ours.l2_distance(gt_im=gt, gen_im=gen) == pytest.approx(
            ref.l2_distance(gt_im=gt, gen_im=gen), abs=ATOL)


def test_ssim_equals_jax():
    b = _batch(seed=3)
    for gt, gen in zip(b["gt_im"], b["gen_im"]):
        assert SSIMDistanceCalculator().compute_SSIM(gt_im=gt, gen_im=gen) == pytest.approx(
            JSSIM().compute_SSIM(gt_im=gt, gen_im=gen), abs=ATOL)


def test_count_token_length_equals_jax():
    b = _batch()
    ours, ref = CountTokenLength(), JCount()
    for gt, gen in zip(b["gt_svg"], b["gen_svg"]):
        assert ours.count(gt_svg=gt, gen_svg=gen) == ref.count(gt_svg=gt, gen_svg=gen)


@pytest.mark.parametrize("dim", [4, 32])
def test_frechet_distance_equals_jax(dim):
    rng = np.random.default_rng(dim)
    f1, f2 = rng.standard_normal((2, 40, dim))
    f2 = 0.7 * f2 + 0.3
    args = (f1.mean(0), np.cov(f1, rowvar=False), f2.mean(0), np.cov(f2, rowvar=False))
    assert frechet_distance(*args) == pytest.approx(jfrechet(*args), abs=ATOL)
    assert frechet_distance(args[0], args[1], args[0], args[1]) == pytest.approx(0, abs=1e-6)


CONFIG = {"L2": True, "Masked-L2": True, "SSIM": True, "CountTokenLength": True,
          "ratio_post_processed": True, "ratio_non_compiling": True}


def _assert_same_results(ours, ref):
    (avg, per), (javg, jper) = ours, ref
    assert list(avg) == list(javg)
    for k, v in javg.items():
        if k.startswith("ratio_") or k == "CountTokenLength":
            assert avg[k] == v, k
        else:
            assert avg[k] == pytest.approx(v, abs=ATOL), k
    assert list(per) == list(jper)
    for sid, row in jper.items():
        assert list(per[sid]) == list(row)
        for k, v in row.items():
            assert per[sid][k] == pytest.approx(v, abs=ATOL) and type(per[sid][k]) is type(v)


@pytest.mark.parametrize("seed", [0, 1])
def test_svg_metrics_equals_jax(seed):
    """Averages and per-sample dicts, the ratio keys (the no_compile flag
    read for ratio_non_compiling), on the same batch."""
    ours = SVGMetrics(CONFIG, device="cpu").calculate_metrics(_batch(seed=seed))
    ref = JSVGMetrics(CONFIG).calculate_metrics(_batch(seed=seed))
    _assert_same_results(ours, ref)
    flags = [j["no_compile"] for j in _batch(seed=seed)["json"]]
    assert ours[0]["ratio_non_compiling"] == sum(flags) / len(flags)
    assert ours[0]["ratio_post_processed"] == ref[0]["ratio_post_processed"]


@needs_native
def test_svg_metrics_rasterizes_svg_only_batches_as_jax():
    b = _batch()
    for key in ("gt_im", "gen_im"):
        del b[key]
    ours = SVGMetrics(CONFIG, device="cpu").calculate_metrics(dict(b))
    ref = JSVGMetrics(CONFIG).calculate_metrics(dict(b))
    _assert_same_results(ours, ref)


def test_svg_metrics_skips_failed_samples_index_aligned():
    b = _batch(3)
    b["gen_im"][1] = None  # this sample's pixel metrics fail and stay unattributed
    ours = SVGMetrics({"L2": True, "SSIM": True}, device="cpu").calculate_metrics(b)
    ref = JSVGMetrics({"L2": True, "SSIM": True}).calculate_metrics(_batch(3) | {
        "gen_im": b["gen_im"]})
    _assert_same_results(ours, ref)
    assert "L2" not in ours[1]["s1"] and "L2" in ours[1]["s2"]


def test_missing_sample_id_raises():
    b = _batch(2)
    b["json"][1].pop("sample_id")
    with pytest.raises(ValueError, match="missing outpath_filename"):
        SVGMetrics({"L2": True}, device="cpu").calculate_metrics(b)


def test_neural_metrics_refuse_the_card_when_none_is_visible():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the metrics' default runs there")
    SVGMetrics(CONFIG)  # no neural metric: nothing asks for the card
    for name in ("LPIPS", "FID", "FID_clip", "CLIPScore", "DinoScore"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SVGMetrics({name: True})
