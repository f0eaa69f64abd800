"""The eval harness's metrics (the port of starvector_tpu/metrics/): pixel
L2, Masked-L2 and SSIM in numpy, LPIPS-VGG and InceptionV3 (FID) as PyTorch
modules, the DINO and CLIP calculators on HF torch models, and the
SVGMetrics orchestrator."""

from starvector_tpu_torch.metrics.metrics import SVGMetrics

__all__ = ["SVGMetrics"]
