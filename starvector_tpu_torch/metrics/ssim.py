"""SSIM with skimage-parity semantics (reference: starvector/metrics/
compute_SSIM.py calls skimage.structural_similarity with win_size=11,
channel_axis=-1, sigma=1.5 — note skimage IGNORES sigma unless
gaussian_weights=True, so the effective window is the 11x11 uniform filter;
we reproduce that, including sample-covariance normalization). The port's
copy of starvector_tpu/metrics/ssim.py, which the port does not import."""

from __future__ import annotations

import numpy as np

from starvector_tpu_torch.metrics.base_metric import BaseMetric


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter with skimage's reflect padding."""
    out = img.astype(np.float64)
    for axis in range(2):
        pad = size // 2
        padded = np.pad(
            out,
            [(pad, pad) if a == axis else (0, 0) for a in range(out.ndim)],
            mode="reflect",
        )
        c = np.cumsum(padded, axis=axis)
        zero = np.zeros_like(np.take(c, [0], axis=axis))
        c = np.concatenate([zero, c], axis=axis)
        upper = np.take(c, range(size, size + out.shape[axis]), axis=axis)
        lower = np.take(c, range(0, out.shape[axis]), axis=axis)
        out = (upper - lower) / size
    return out


def ssim_single(
    img1: np.ndarray, img2: np.ndarray, *, win_size: int = 11,
    data_range: float | None = None,
) -> float:
    """2D single-channel SSIM, skimage defaults (uniform window,
    use_sample_covariance=True, K1=.01, K2=.03)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if data_range is None:
        data_range = 255.0
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size**2
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter(img1, win_size)
    uy = _uniform_filter(img2, win_size)
    uxx = _uniform_filter(img1 * img1, win_size)
    uyy = _uniform_filter(img2 * img2, win_size)
    uxy = _uniform_filter(img1 * img2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


class SSIMDistanceCalculator(BaseMetric):
    def __init__(self, config=None):
        super().__init__()
        self.config = config
        self.metric = self.compute_SSIM

    def compute_SSIM(self, **kwargs):
        img1 = np.array(kwargs["gt_im"])
        img2 = np.array(kwargs["gen_im"])
        win = kwargs.get("win_size", 11)
        data_range = 255.0 if img1.dtype == np.uint8 else None
        if img1.ndim == 3 and img1.shape[2] == 3:
            vals = [
                ssim_single(img1[..., c], img2[..., c], win_size=win,
                            data_range=data_range)
                for c in range(3)
            ]
            return float(np.mean(vals))
        if img1.ndim == 3:
            img1 = img1.mean(axis=2)
            img2 = img2.mean(axis=2)
        return ssim_single(img1, img2, win_size=win, data_range=data_range)
