"""L2 / Masked-L2 pixel MSE (reference: starvector/metrics/compute_l2.py;
the port's copy of starvector_tpu/metrics/l2.py, which the port does not
import).

Masked variant: mask = non-white pixels in BOTH images (overlap), applied
before the MSE — but the mean still runs over ALL pixels (torch F.mse_loss
over the full masked tensors), matching the reference exactly."""

from __future__ import annotations

import numpy as np

from starvector_tpu_torch.metrics.base_metric import BaseMetric


def _to_float(img) -> np.ndarray:
    arr = np.asarray(img, np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    return arr


class L2DistanceCalculator(BaseMetric):
    def __init__(self, config=None, masked_l2: bool = False):
        super().__init__()
        self.config = config
        self.masked_l2 = masked_l2
        self.metric = self.l2_distance

    def l2_distance(self, **kwargs):
        image1 = _to_float(kwargs["gt_im"])
        image2 = _to_float(kwargs["gen_im"])
        if self.masked_l2:
            mask1 = (image1 != 1.0).any(axis=-1).astype(np.float32)
            mask2 = (image2 != 1.0).any(axis=-1).astype(np.float32)
            combined = (mask1 * mask2)[..., None]
            image1 = image1 * combined
            image2 = image2 * combined
        return float(np.mean((image1 - image2) ** 2))
