"""The port's real-checkpoint harness (starvector_tpu_torch/validation/
parity_real.py), mirroring tests/test_parity_real.py: the probe set, the
scoring identity, run_parity on a tiny port model on the CPU (greedy
generation, scores, the converter round trip, the report), token_match,
and the converter's bit-exact round trip; the real-weights test runs only
when STARVECTOR_CKPT_DIR points at a StarVector checkpoint, and skips with
a reason otherwise. Scores equal the JAX harness's on the same rasters."""

import json
import os

import numpy as np
import pytest
import torch

from starvector_tpu.validation import parity_real as jparity
from starvector_tpu.validation.parity_samples import SAMPLES as JSAMPLES
from starvector_tpu_torch.api import StarVectorForCausalLM
from starvector_tpu_torch.data.rasterize import rasterize_svg, rasterizer_available
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
from starvector_tpu_torch.validation import parity_real
from starvector_tpu_torch.validation.parity_samples import SAMPLES

CKPT = os.environ.get("STARVECTOR_CKPT_DIR")
needs_native = pytest.mark.skipif(not rasterizer_available(),
                                  reason="librsvg/cairo unavailable")


@pytest.fixture(scope="module")
def tiny_model():
    return StarVectorForCausalLM.from_config(tsv.tiny_config(), seed=0,
                                             tokenizer=build_test_tokenizer("v1"), device="cpu")


def test_probe_set_is_the_jax_packages():
    assert SAMPLES == JSAMPLES and len(SAMPLES) == 8


@needs_native
def test_probe_set_rasterizes():
    """Every probe SVG rasterizes to a non-white image: otherwise its
    metrics are vacuous."""
    for sid, svg in SAMPLES:
        img = np.asarray(rasterize_svg(svg, 224))
        assert img.shape == (224, 224, 3), sid
        assert img.min() < 250, f"{sid} rasterized all-white"


@needs_native
def test_score_generation_identity_and_jax_scores():
    sid, svg = SAMPLES[0]
    scores = parity_real.score_generation(svg, svg)
    assert scores["mse"] < 1e-6 and scores["ssim"] > 0.999 and not scores["post_processed"]
    other = SAMPLES[2][1]
    ours, ref = parity_real.score_generation(svg, other), jparity.score_generation(svg, other)
    assert ours["svg"] == ref["svg"] and ours["post_processed"] == ref["post_processed"]
    assert ours["mse"] == pytest.approx(ref["mse"], abs=1e-7)
    assert ours["ssim"] == pytest.approx(ref["ssim"], abs=1e-7)


@needs_native
def test_run_parity_synthetic(tiny_model, tmp_path):
    """A full harness pass on a tiny random model: generation, scoring,
    the converter round trip and the report. Random weights draw garbage;
    the plumbing is under test."""
    report = parity_real.run_parity("synthetic", str(tmp_path), model=tiny_model,
                                    samples=SAMPLES[:2], max_new_tokens=8, resolution=64,
                                    with_reference=False)
    assert report["torch"]["mean_mse"] >= 0 and len(report["torch"]["per_sample"]) == 2
    rt = report["converter_roundtrip"]
    assert rt["bit_exact"], rt["mismatched"]
    assert rt["n_leaves"] > 20 and rt["decoder"] == "gpt_bigcode"
    on_disk = json.load(open(tmp_path / "parity_report.json"))
    assert on_disk["n_samples"] == 2 and "reference" not in on_disk
    assert (tmp_path / f"{SAMPLES[0][0]}.torch.svg").read_text().startswith("<svg")


def test_reference_level_is_gated(tmp_path):
    """The paired reference level needs the checkpoint's config: without
    it run_parity records why it skipped."""
    assert parity_real._reference_unavailable_reason(str(tmp_path)) == \
        "checkpoint carries no config"
    assert parity_real.generate_reference(str(tmp_path), SAMPLES[:1]) == \
        jparity.generate_reference(str(tmp_path), JSAMPLES[:1])


def test_converter_self_consistency_catches_drift(tiny_model, tmp_path):
    """The round trip is bit-exact; a leaf the checkpoint does not carry
    back is reported by its path."""
    rt = parity_real.converter_self_consistency(tiny_model.params, tiny_model.cfg,
                                                tiny_model.tokenizer, str(tmp_path / "a"))
    assert rt["bit_exact"] and not rt["mismatched"]
    drifted = {**tiny_model.params,
               "svg_transformer": {**tiny_model.params["svg_transformer"],
                                   "stray": torch.ones(3)}}
    rt = parity_real.converter_self_consistency(drifted, tiny_model.cfg, tiny_model.tokenizer,
                                                str(tmp_path / "b"))
    assert not rt["bit_exact"] and rt["mismatched"] == ["/svg_transformer/stray"]


def test_token_match_semantics(tiny_model):
    tok = tiny_model.tokenizer
    m = parity_real.token_match(tok, "<svg a b", "<svg a b")
    assert m["exact"] and m["prefix_ratio"] == 1.0
    m2 = parity_real.token_match(tok, "<svg a b", "<svg a c d")
    assert not m2["exact"] and 0 < m2["prefix_match"] <= m2["len_a"]
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtok

    assert m2 == jparity.token_match(jtok("v1"), "<svg a b", "<svg a c d")


@pytest.mark.skipif(
    not (CKPT and os.path.isdir(CKPT)),
    reason="STARVECTOR_CKPT_DIR not set: real-weights parity needs a StarVector "
    "checkpoint, which the repository does not hold",
)
def test_real_checkpoint_parity(tmp_path):
    """The north-star artifact on the card: greedy decode fidelity of a real
    checkpoint through the port (thresholds of the JAX harness's test)."""
    report = parity_real.run_parity(CKPT, str(tmp_path), samples=SAMPLES, max_new_tokens=1024,
                                    device="cuda" if torch.cuda.is_available() else "cpu")
    assert report["converter_roundtrip"]["bit_exact"]
    assert report["torch"]["mean_ssim"] > 0.8
    ref = report.get("reference", {})
    if "token_exact_rate" in ref:
        assert ref["token_prefix_ratio"] > 0.95
        assert abs(ref["mse_delta_vs_torch"]) < 0.01
        assert abs(ref["ssim_delta_vs_torch"]) < 0.02
