"""Neural quality metrics: DINOScore, CLIPScore, LPIPS, FID (the port of
starvector_tpu/metrics/model_metrics.py).

Parity targets (reference: starvector/metrics/compute_dino_score.py,
compute_clip_score.py, compute_LPIPS.py, compute_fid.py): cosine similarity
of DINOv2 mean-pooled features rescaled to [0,1]; CLIP image-text similarity;
VGG-based perceptual distance; Fréchet distance over InceptionV3/CLIP
features.

Pretrained weights must exist locally: each calculator accepts `model_path`
(a local checkpoint) or reads the STARVECTOR_METRICS_DIR env var (subdirs
dinov2-base / clip-vit-base-patch32 / lpips-vgg / inception). Without
weights they raise at first use; the SVGMetrics config gates them off by
default, matching the reference's config-gated metric set
(configs/metrics/*.yaml).

Every network runs on the calculator's `device`: the card unless the caller
asks for the CPU (`device="cpu"`); a calculator raises at construction when
it names the card and none is visible. LPIPS-VGG and InceptionV3 are the
port's own modules (metrics/lpips_vgg.py, metrics/inception_v3.py); DINOv2
and CLIP are HF torch models, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.metrics.base_metric import BaseMetric

CPU_OPTION = 'device="cpu"'


def _models_dir() -> str | None:
    return os.environ.get("STARVECTOR_METRICS_DIR")


def _resolve(model_path: str | None, subdir: str) -> str:
    if model_path:
        return model_path
    base = _models_dir()
    if base and os.path.isdir(os.path.join(base, subdir)):
        return os.path.join(base, subdir)
    raise FileNotFoundError(
        f"weights for {subdir} not found: pass model_path or set "
        "STARVECTOR_METRICS_DIR to a directory of local checkpoints "
        "(weights are never downloaded)"
    )


class DINOScoreCalculator(BaseMetric):
    """Cosine similarity of mean-pooled DINOv2 features, rescaled to [0,1]
    (reference compute_dino_score.py:9-55)."""

    def __init__(self, config=None, model_path: str | None = None, device="cuda"):
        super().__init__()
        self.config = config
        self.model_path = model_path
        self.device = require_device(device, CPU_OPTION)
        self._model = None
        self.metric = self.calculate_DINOv2_similarity_score

    def _load(self):
        if self._model is None:
            from transformers import AutoImageProcessor, AutoModel

            path = _resolve(self.model_path, "dinov2-base")
            self._processor = AutoImageProcessor.from_pretrained(path)
            self._model = AutoModel.from_pretrained(path).eval().to(self.device)
        return self._model

    def get_embedding(self, image):
        model = self._load()
        inputs = self._processor(images=image, return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = model(**inputs)
        return out.last_hidden_state.mean(dim=1)

    def calculate_DINOv2_similarity_score(self, **kwargs):
        f1 = self.get_embedding(kwargs["gt_im"])
        f2 = self.get_embedding(kwargs["gen_im"])
        sim = torch.nn.functional.cosine_similarity(f1, f2).item()
        return (sim + 1) / 2


class CLIPScoreCalculator(BaseMetric):
    """CLIP image-text score (reference compute_clip_score.py:11-50:
    torchmetrics CLIPScore semantics = 100 * max(cos(img, text), 0))."""

    def __init__(self, config=None, model_path: str | None = None, device="cuda"):
        super().__init__()
        self.config = config
        self.model_path = model_path
        self.device = require_device(device, CPU_OPTION)
        self._model = None
        self.metric = self.clip_score

    def _load(self):
        if self._model is None:
            from transformers import CLIPModel, CLIPProcessor

            path = _resolve(self.model_path, "clip-vit-base-patch32")
            self._processor = CLIPProcessor.from_pretrained(path)
            self._model = CLIPModel.from_pretrained(path).eval().to(self.device)
        return self._model

    def clip_score(self, **kwargs):
        model = self._load()
        inputs = self._processor(
            text=[kwargs["caption"]], images=kwargs["gen_im"],
            return_tensors="pt", padding=True, truncation=True,
        ).to(self.device)
        with torch.no_grad():
            out = model(**inputs)
        img = out.image_embeds / out.image_embeds.norm(dim=-1, keepdim=True)
        txt = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
        return float(100 * (img * txt).sum(-1).clamp(min=0).item())


class LPIPSDistanceCalculator(BaseMetric):
    """Perceptual distance with the REAL LPIPS-VGG net (metrics/lpips_vgg.py,
    reference compute_LPIPS.py:9-55) when its weights are available:
    `STARVECTOR_METRICS_DIR/lpips-vgg/{vgg16.pth, lpips_vgg.pth}` (torch
    state dicts: torchvision VGG16 features + lpips 'vgg' linear layers).
    Without them, falls back to an LPIPS-style normalized feature distance
    over a local CLIP ViT — monotonic stand-in, NOT comparable to paper
    LPIPS numbers (the JAX package's documented deviation)."""

    def __init__(self, config=None, model_path: str | None = None, device="cuda"):
        super().__init__()
        self.config = config
        self.model_path = model_path
        self.device = require_device(device, CPU_OPTION)
        self._model = None
        self._vgg = None
        self.metric = self.lpips

    # -- real LPIPS-VGG path --------------------------------------------------
    def _load_vgg(self):
        if self._vgg is not None:
            return self._vgg
        base = self.model_path or (
            os.path.join(_models_dir(), "lpips-vgg") if _models_dir() else None
        )
        if base and os.path.isdir(base):
            from starvector_tpu_torch.metrics.lpips_vgg import LPIPSVGG

            vgg_sd = torch.load(os.path.join(base, "vgg16.pth"), map_location="cpu",
                                weights_only=True)
            lin_sd = torch.load(os.path.join(base, "lpips_vgg.pth"), map_location="cpu",
                                weights_only=True)
            self._vgg = LPIPSVGG.from_torch_state_dicts(vgg_sd, lin_sd, device=self.device)
            return self._vgg
        return None

    def _load(self):
        if self._model is None:
            from transformers import CLIPModel, CLIPProcessor

            path = _resolve(None, "clip-vit-base-patch32")
            self._processor = CLIPProcessor.from_pretrained(path)
            self._model = CLIPModel.from_pretrained(path).vision_model.eval().to(self.device)
        return self._model

    def _feats(self, image):
        model = self._load()
        inputs = self._processor(images=image, return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = model(inputs["pixel_values"], output_hidden_states=True)
        return [h / (h.norm(dim=-1, keepdim=True) + 1e-10) for h in out.hidden_states[1::4]]

    def lpips(self, **kwargs):
        vgg = self._load_vgg()
        if vgg is not None:
            from starvector_tpu_torch.metrics import lpips_vgg

            x = lpips_vgg.preprocess([kwargs["gt_im"]])
            y = lpips_vgg.preprocess([kwargs["gen_im"]])
            return float(lpips_vgg.lpips_distance(vgg, x, y)[0])
        fa = self._feats(kwargs["gt_im"])
        fb = self._feats(kwargs["gen_im"])
        d = sum(((a - b) ** 2).sum(-1).mean() for a, b in zip(fa, fb))
        return float(d / len(fa))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between Gaussians (reference compute_fid.py:15-145).
    sqrtm is called without `disp=False` (the JAX package's call), which
    SciPy 1.18 removes; the square root is the same."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


class FIDCalculator:
    """FID over InceptionV3 pool3 features (the REAL FID network,
    metrics/inception_v3.py — reference inception.py:16-340) when
    `model_name='InceptionV3'` and a state dict exists at
    `STARVECTOR_METRICS_DIR/inception/inception_v3.pth` (pytorch-fid or
    torchvision naming). `model_name='ViT-B/32'` computes FID-CLIP over a
    local CLIP checkpoint (the reference's clip mode, compute_fid.py)."""

    def __init__(self, model_name: str = "ViT-B/32", model_path: str | None = None,
                 device="cuda"):
        self.model_name = model_name
        self.model_path = model_path
        self.device = require_device(device, CPU_OPTION)
        self._model = None
        self._inception = None
        self.class_name = self.__class__.__name__

    def reset(self):
        pass

    def _load_inception(self):
        if self._inception is None:
            from starvector_tpu_torch.metrics.inception_v3 import InceptionV3

            path = self.model_path or _resolve(None, "inception")
            f = path if path.endswith(".pth") else os.path.join(path, "inception_v3.pth")
            sd = torch.load(f, map_location="cpu", weights_only=True)
            self._inception = InceptionV3.from_torch_state_dict(sd, device=self.device)
        return self._inception

    def _load(self):
        if self._model is None:
            from transformers import CLIPModel, CLIPProcessor

            path = _resolve(
                self.model_path if self.model_name != "InceptionV3" else None,
                "clip-vit-base-patch32",
            )
            self._processor = CLIPProcessor.from_pretrained(path)
            self._model = CLIPModel.from_pretrained(path).eval().to(self.device)
        return self._model

    def _features(self, images) -> np.ndarray:
        if self.model_name == "InceptionV3":
            from starvector_tpu_torch.metrics import inception_v3

            net = self._load_inception()
            out = []
            for i in range(0, len(images), 16):
                x = inception_v3.preprocess(images[i:i + 16])
                out.append(inception_v3.features(net, x).cpu().numpy())
            return np.concatenate(out)
        model = self._load()
        feats = []
        for im in images:
            inputs = self._processor(images=im, return_tensors="pt").to(self.device)
            with torch.no_grad():
                f = model.get_image_features(**inputs)
            feats.append(f[0].cpu().numpy())
        return np.stack(feats)

    def calculate_score(self, batch: dict) -> float:
        f1 = self._features(batch["gt_im"])
        f2 = self._features(batch["gen_im"])
        mu1, s1 = f1.mean(0), np.cov(f1, rowvar=False)
        mu2, s2 = f2.mean(0), np.cov(f2, rowvar=False)
        return frechet_distance(mu1, s1, mu2, s2)


class CountTokenLength(BaseMetric):
    """Token-length stats of generated vs gt SVG (reference
    count_token_length.py:9-55), on the port's byte-level test tokenizer
    unless one is given (the StarCoder2 tokenizer is not downloaded)."""

    def __init__(self, config=None, tokenizer=None):
        super().__init__()
        self.config = config
        if tokenizer is None:
            from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

            tokenizer = build_test_tokenizer()
        self.tokenizer = tokenizer
        self.metric = self.count

    def count(self, **kwargs):
        gen = len(self.tokenizer.token_ids(kwargs["gen_svg"]))
        gt = len(self.tokenizer.token_ids(kwargs["gt_svg"]))
        return float(gen - gt)
