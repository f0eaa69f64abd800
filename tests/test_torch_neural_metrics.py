"""The port's neural metrics against the JAX package's: LPIPS-VGG and the
FID InceptionV3 (starvector_tpu_torch/metrics/{lpips_vgg,inception_v3}.py,
PyTorch modules, against starvector_tpu/metrics/'s JAX ones) from the same
random state dicts in the torchvision naming at narrow widths (VGG blocks
8/16/32/64/64, Inception channels / 16) and small inputs (LPIPS 32²,
Inception 75²): taps, distances and pool3 features equal at fp32 rtol 1e-4,
atol 1e-5; the LPIPS and FID calculators end to end through a temporary
STARVECTOR_METRICS_DIR; and the DINO, CLIP and FID-CLIP calculators on tiny
offline HF checkpoints. Everything on the CPU (device="cpu")."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from starvector_tpu.metrics import inception_v3 as jinc
from starvector_tpu.metrics import lpips_vgg as jlp
from starvector_tpu.metrics import model_metrics as jmm
from starvector_tpu_torch.metrics import SVGMetrics
from starvector_tpu_torch.metrics import inception_v3 as tinc
from starvector_tpu_torch.metrics import lpips_vgg as tlp
from starvector_tpu_torch.metrics import model_metrics as tmm

RTOL, ATOL = 1e-4, 1e-5
NARROW_VGG = (8, 16, 32, 64, 64)


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _imgs(n, seed=0, size=28):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)) for _ in range(n)]


@pytest.fixture(scope="module")
def vgg_sds():
    return tlp.random_state_dicts(0, NARROW_VGG)


@pytest.fixture(scope="module")
def inception_sd():
    return tinc.random_state_dict(0, divisor=16)


def test_lpips_taps_and_distance_equal_jax(vgg_sds):
    x, y = _uniform((3, 32, 32, 3), 1), _uniform((3, 32, 32, 3), 2)
    jparams = jlp.from_torch_state_dicts(*vgg_sds)
    net = tlp.LPIPSVGG.from_torch_state_dicts(*vgg_sds, device="cpu")
    for ours, ref in zip(net.taps(torch.from_numpy(x)), jlp._taps(jparams, jnp.asarray(x))):
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    d = tlp.lpips_distance(net, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(d, np.asarray(jlp.lpips_distance(jparams, x, y)), rtol=RTOL,
                               atol=ATOL)
    assert (d > 0).all()
    np.testing.assert_allclose(tlp.lpips_distance(net, x, x).numpy(), 0, atol=ATOL)


def test_inception_features_equal_jax(inception_sd):
    x = _uniform((3, 75, 75, 3), 3)
    ref = np.asarray(jinc.features(jinc.from_torch_state_dict(inception_sd), jnp.asarray(x)))
    net = tinc.InceptionV3.from_torch_state_dict(inception_sd, device="cpu")
    ours = tinc.features(net, torch.from_numpy(x)).numpy()
    assert ours.shape == (3, tinc.FEATURE_DIM // 16) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_inception_state_dict_names_and_checks(inception_sd):
    """torchvision's extra keys (fc, AuxLogits, num_batches_tracked) are
    ignored; a missing conv or a kernel of the wrong shape raises."""
    extra = dict(inception_sd, **{"fc.weight": torch.zeros(2, 128),
                                  "Mixed_5b.branch1x1.bn.num_batches_tracked": torch.tensor(0)})
    net = tinc.InceptionV3.from_torch_state_dict(extra, device="cpu")
    assert set(net.state_dict()) == set(inception_sd)
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool"):
        tinc.InceptionV3.from_torch_state_dict(
            {k: v for k, v in inception_sd.items() if not k.startswith("Mixed_7c.branch_pool")},
            device="cpu")
    bad = dict(inception_sd, **{"Conv2d_1a_3x3.conv.weight": torch.zeros(2, 3, 5, 5)})
    with pytest.raises(ValueError, match="Conv2d_1a_3x3"):
        tinc.InceptionV3.from_torch_state_dict(bad, device="cpu")


@pytest.mark.parametrize("module,size", [(tlp, 224), (tinc, 299)])
def test_preprocess_equals_jax(module, size):
    jmod = jlp if module is tlp else jinc
    ims = _imgs(2, 5, size=40)
    np.testing.assert_array_equal(module.preprocess(ims, size=size).numpy(),
                                  np.asarray(jmod.preprocess(ims, size=size)))


@pytest.fixture
def weights_dir(tmp_path, monkeypatch, vgg_sds, inception_sd):
    """A STARVECTOR_METRICS_DIR with the lpips-vgg and inception layout."""
    (tmp_path / "lpips-vgg").mkdir()
    (tmp_path / "inception").mkdir()
    torch.save(vgg_sds[0], tmp_path / "lpips-vgg" / "vgg16.pth")
    torch.save(vgg_sds[1], tmp_path / "lpips-vgg" / "lpips_vgg.pth")
    torch.save(inception_sd, tmp_path / "inception" / "inception_v3.pth")
    monkeypatch.setenv("STARVECTOR_METRICS_DIR", str(tmp_path))
    return tmp_path


def test_lpips_calculator_equals_jax(weights_dir):
    gt, gen = _imgs(3, 6, size=48), _imgs(3, 7, size=48)
    ours = tmm.LPIPSDistanceCalculator(device="cpu")
    ref = jmm.LPIPSDistanceCalculator()
    for a, b in zip(gt, gen):
        assert ours.lpips(gt_im=a, gen_im=b) == pytest.approx(
            ref.lpips(gt_im=a, gen_im=b), rel=RTOL, abs=ATOL)
    assert isinstance(ours._vgg, tlp.LPIPSVGG)  # the real network, not the CLIP stand-in


def test_fid_inception_calculator_equals_jax(weights_dir):
    batch = {"gt_im": _imgs(6, 8, size=40), "gen_im": _imgs(6, 9, size=40)}
    ours = tmm.FIDCalculator(model_name="InceptionV3", device="cpu")
    ref = jmm.FIDCalculator(model_name="InceptionV3")
    f_ours, f_ref = ours._features(batch["gt_im"]), ref._features(batch["gt_im"])
    np.testing.assert_allclose(f_ours, f_ref, rtol=RTOL, atol=ATOL)
    score = ours.calculate_score(batch)
    assert score > 0 and score == pytest.approx(ref.calculate_score(batch), rel=RTOL)


def test_svg_metrics_with_lpips_and_fid_equal_jax(weights_dir):
    from starvector_tpu.metrics import SVGMetrics as JSVGMetrics

    config = {"L2": True, "LPIPS": True, "FID": True}
    batch = {"gt_im": _imgs(4, 10, size=40), "gen_im": _imgs(4, 11, size=40),
             "json": [{"sample_id": f"s{i}", "post_processed": False, "no_compile": False}
                      for i in range(4)]}
    avg, per = SVGMetrics(config, device="cpu").calculate_metrics(dict(batch))
    javg, jper = JSVGMetrics(config).calculate_metrics(dict(batch))
    assert list(avg) == list(javg) and list(per) == list(jper)
    assert avg["FID"] == pytest.approx(javg["FID"], rel=RTOL)
    assert avg["LPIPS"] == pytest.approx(javg["LPIPS"], rel=RTOL, abs=ATOL)
    for sid in per:
        assert per[sid]["LPIPS"] == pytest.approx(jper[sid]["LPIPS"], rel=RTOL, abs=ATOL)
        assert "FID" not in per[sid]  # FID reports an average only


# -- DINO, CLIP, FID-CLIP on tiny offline HF checkpoints ---------------------

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """dinov2-base and clip-vit-base-patch32 directories of tiny random HF
    models (the fixture of tests/test_metric_calculators.py)."""
    from transformers import (
        BitImageProcessor, CLIPConfig, CLIPImageProcessor, CLIPModel,
        CLIPProcessor, CLIPTextConfig, CLIPTokenizer, CLIPVisionConfig,
        Dinov2Config, Dinov2Model,
    )

    d = tmp_path_factory.mktemp("metrics_weights")
    torch.manual_seed(0)
    p1 = str(d / "dinov2-base")
    Dinov2Model(Dinov2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=28, patch_size=14,
    )).save_pretrained(p1)
    BitImageProcessor(
        size={"shortest_edge": 28}, crop_size={"height": 28, "width": 28}
    ).save_pretrained(p1)

    p2 = str(d / "clip-vit-base-patch32")
    os.makedirs(p2, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz"):
        vocab[ch + "</w>"] = 2 + i
        vocab[ch] = 28 + i
    with open(os.path.join(p2, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(p2, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = CLIPTokenizer(os.path.join(p2, "vocab.json"), os.path.join(p2, "merges.txt"))
    CLIPModel(CLIPConfig(
        text_config=CLIPTextConfig(
            vocab_size=len(vocab) + 10, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64, max_position_embeddings=77,
        ).to_dict(),
        vision_config=CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, image_size=28, patch_size=14,
        ).to_dict(),
        projection_dim=16,
    )).save_pretrained(p2)
    CLIPProcessor(
        image_processor=CLIPImageProcessor(
            size={"shortest_edge": 28}, crop_size={"height": 28, "width": 28}),
        tokenizer=tok,
    ).save_pretrained(p2)
    return str(d)


def test_dino_score_equals_jax(hf_dir, monkeypatch):
    monkeypatch.setenv("STARVECTOR_METRICS_DIR", hf_dir)
    ours, ref = tmm.DINOScoreCalculator(device="cpu"), jmm.DINOScoreCalculator()
    im1, im2 = _imgs(2)
    for a, b in ((im1, im1), (im1, im2)):
        assert ours.calculate_DINOv2_similarity_score(gt_im=a, gen_im=b) == pytest.approx(
            ref.calculate_DINOv2_similarity_score(gt_im=a, gen_im=b), abs=1e-6)
    assert ours.calculate_DINOv2_similarity_score(gt_im=im1, gen_im=im1) == pytest.approx(1.0)


def test_clip_score_equals_jax(hf_dir, monkeypatch):
    monkeypatch.setenv("STARVECTOR_METRICS_DIR", hf_dir)
    ours, ref = tmm.CLIPScoreCalculator(device="cpu"), jmm.CLIPScoreCalculator()
    for im, caption in zip(_imgs(2, 1), ("a red square", "two dots")):
        s = ours.clip_score(caption=caption, gen_im=im)
        assert 0.0 <= s <= 100.0
        assert s == pytest.approx(ref.clip_score(caption=caption, gen_im=im), abs=1e-4)


def test_fid_clip_equals_jax(hf_dir, monkeypatch):
    monkeypatch.setenv("STARVECTOR_METRICS_DIR", hf_dir)
    batch = {"gt_im": _imgs(6, 1), "gen_im": _imgs(6, 2)}
    ours = tmm.FIDCalculator(model_name="ViT-B/32", device="cpu").calculate_score(batch)
    ref = jmm.FIDCalculator(model_name="ViT-B/32").calculate_score(batch)
    assert np.isfinite(ours) and ours == pytest.approx(ref, rel=1e-5, abs=1e-6)


def test_lpips_without_vgg_weights_takes_the_clip_stand_in_as_jax(hf_dir, monkeypatch):
    """No lpips-vgg directory: both packages fall back to the CLIP feature
    distance (the JAX package's documented deviation), with equal values."""
    monkeypatch.setenv("STARVECTOR_METRICS_DIR", hf_dir)
    a, b = _imgs(2, 4)
    ours = tmm.LPIPSDistanceCalculator(device="cpu").lpips(gt_im=a, gen_im=b)
    assert ours == pytest.approx(jmm.LPIPSDistanceCalculator().lpips(gt_im=a, gen_im=b),
                                 rel=1e-5)
