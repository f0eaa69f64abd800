"""Image preprocessing: RGBA over white, pad to a white square, bicubic
resize, CLIP or SigLIP normalization, channels-last (port of
starvector_tpu/data/processor.py::ImageProcessor).

The JAX package resizes with PIL on the host. This port resizes with
`F.interpolate(mode="bicubic", antialias=True)`, PIL's own filter
(a = -0.5, widened when downscaling), and rounds to 8-bit pixels as PIL's
output is; the two agree to within a couple of 8-bit steps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the statistics of starvector_tpu/data/processor.py, repeated so that the
# port imports nothing of the JAX package
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


class ImageProcessor:
    """__call__ takes a uint8 (H, W, 3|4) array or tensor (or a PIL image,
    where PIL is installed) and returns (size, size, 3) float32, normalised
    with `mean` and `std` (CLIP's by default)."""

    def __init__(self, size: int = 224, mean=None, std=None, *, device="cpu"):
        self.size = size
        self.device = torch.device(device)
        self.mean = torch.tensor(CLIP_MEAN if mean is None else mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(CLIP_STD if std is None else std, dtype=torch.float32,
                                device=self.device)

    def _to_tensor(self, img) -> torch.Tensor:
        if not isinstance(img, (np.ndarray, torch.Tensor)):
            # a PIL image: the only path that needs PIL
            mode = getattr(img, "mode", None)
            img = np.array(img if mode in ("RGB", "RGBA") else img.convert("RGB"))
        x = torch.as_tensor(img, device=self.device)
        if x.dtype != torch.uint8 or x.ndim != 3 or x.shape[-1] not in (3, 4):
            raise ValueError(f"expected a uint8 (H, W, 3|4) image, got {x.dtype} {tuple(x.shape)}")
        return x

    def __call__(self, img) -> torch.Tensor:
        x = self._to_tensor(img).float()
        if x.shape[-1] == 4:
            # alpha-composite over white, rounded to 8 bits like PIL's paste
            a = x[..., 3:] / 255.0
            x = torch.round(x[..., :3] * a + 255.0 * (1.0 - a))
        H, W, _ = x.shape
        m = max(H, W)
        if H != W:
            top, left = (m - H) // 2, (m - W) // 2
            sq = torch.full((m, m, 3), 255.0, device=x.device)
            sq[top:top + H, left:left + W] = x
            x = sq
        # PIL resizes in two passes, horizontal first, and stores 8-bit pixels
        # after each: clipping the bicubic overshoot in between matters
        x = x.permute(2, 0, 1)[None]
        for size in ((m, self.size), (self.size, self.size)):
            x = F.interpolate(x, size=size, mode="bicubic", antialias=True, align_corners=False)
            x = torch.round(x.clamp(0.0, 255.0))
        x = x[0].permute(1, 2, 0) / 255.0
        return (x - self.mean) / self.std

    def batch(self, images) -> torch.Tensor:
        return torch.stack([self(im) for im in images])


def processor_for_encoder(image_encoder_type: str, image_size: int | None = None,
                          *, device="cpu") -> ImageProcessor:
    """CLIP's statistics for the clip tower at 224; SigLIP's for
    siglip_384 at 384 (the JAX package's rule)."""
    if image_encoder_type == "clip":
        return ImageProcessor(size=image_size or 224, device=device)
    if image_encoder_type == "siglip_384":
        return ImageProcessor(size=image_size or 384, mean=SIGLIP_MEAN, std=SIGLIP_STD,
                              device=device)
    raise NotImplementedError(
        f"the {image_encoder_type!r} processor is not ported yet (ROADMAP queue 1, item 11)")
