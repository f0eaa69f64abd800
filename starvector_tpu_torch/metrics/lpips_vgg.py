"""LPIPS (VGG16 variant) in PyTorch (the port of starvector_tpu/metrics/
lpips_vgg.py, which is JAX).

Parity target: the reference computes perceptual distance with the `lpips`
package's VGG16 net (reference: starvector/metrics/compute_LPIPS.py:9-55):
  d(x, y) = Σ_l  mean_hw ‖ w_l ⊙ ( x̂_l − ŷ_l ) ‖²
where x̂_l are channel-unit-normalized VGG16 activations at relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3, and w_l are the LPIPS linear (1x1, non-negative)
calibration weights. Inputs are scaled to [-1, 1] then normalized by the
package's fixed shift/scale.

The public functions take (B, H, W, 3) images in [-1, 1], as the JAX
package's do; the network runs NCHW on the device it was loaded to (the
card unless the caller asks for the CPU). Weights load from torch state
dicts (torchvision VGG16 `features.*` + the lpips `lin*.model.1.weight`
tensors); the convolutions take their widths from them, so a narrow state
dict runs as well as the real one."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from starvector_tpu_torch import require_device

# lpips package ScalingLayer constants (inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision `features` indices of the conv layers, block by block; a relu
# tap after each block
_TORCH_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
VGG16_WIDTHS = (64, 128, 256, 512, 512)


class LPIPSVGG(nn.Module):
    """VGG16's five blocks of 3x3 convolutions and the LPIPS linear weights.
    `widths[b]` lists block b's (in, out) channels, conv by conv."""

    def __init__(self, widths):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1) for cin, cout in block)
            for block in widths)
        self.lins = nn.ParameterList(nn.Parameter(torch.zeros(block[-1][1]))
                                     for block in widths)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    @classmethod
    def from_torch_state_dicts(cls, vgg_sd: dict, lpips_sd: dict, *, dtype=torch.float32,
                               device="cuda") -> "LPIPSVGG":
        """vgg_sd: torchvision vgg16 state dict (features.N.weight OIHW);
        lpips_sd: lpips 'vgg' checkpoint (lin{i}.model.1.weight, (C,1,1,1)).
        On the card unless `device="cpu"`."""
        device = require_device(device, 'device="cpu"')
        widths = [[tuple(vgg_sd[f"features.{i}.weight"].shape[1::-1]) for i in idxs]
                  for idxs in _TORCH_IDX]
        net = cls(widths)
        with torch.no_grad():
            for block, idxs in zip(net.blocks, _TORCH_IDX):
                for conv, i in zip(block, idxs):
                    conv.weight.copy_(torch.as_tensor(vgg_sd[f"features.{i}.weight"]))
                    conv.bias.copy_(torch.as_tensor(vgg_sd[f"features.{i}.bias"]))
            for i, w in enumerate(net.lins):
                w.copy_(torch.as_tensor(lpips_sd[f"lin{i}.model.1.weight"]).reshape(-1))
        return net.to(device=device, dtype=dtype).eval().requires_grad_(False)

    def taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x in [-1,1], (B,H,W,3) → the five relu taps, NCHW."""
        x = torch.as_tensor(x, device=self.shift.device).permute(0, 3, 1, 2)
        x = ((x - self.shift) / self.scale).to(self.lins[0].dtype)
        taps = []
        for bi, block in enumerate(self.blocks):
            if bi > 0:
                x = F.max_pool2d(x, 2)
            for conv in block:
                x = F.relu(conv(x))
            taps.append(x)
        return taps


@torch.no_grad()
def lpips_distance(net: LPIPSVGG, x, y) -> torch.Tensor:
    """x, y: (B, H, W, 3) in [-1, 1]. Returns (B,) LPIPS distances."""
    total = 0.0
    for fx, fy, w in zip(net.taps(x), net.taps(y), net.lins):
        nx = fx * torch.rsqrt(torch.sum(fx * fx, 1, keepdim=True) + 1e-10)
        ny = fy * torch.rsqrt(torch.sum(fy * fy, 1, keepdim=True) + 1e-10)
        d = (nx - ny) ** 2                       # (B, C, H, W)
        total = total + torch.mean(torch.sum(d * w.view(1, -1, 1, 1), 1), dim=(1, 2))
    return total


def preprocess(pil_images, size: int = 224) -> torch.Tensor:
    """PIL → (B, size, size, 3) in [-1, 1] on the host (the lpips convention;
    the reference feeds [0,1] tensors with normalize=True, compute_LPIPS.py:30)."""
    arrs = []
    for im in pil_images:
        im = im.convert("RGB").resize((size, size))
        arrs.append(np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0)
    return torch.from_numpy(np.stack(arrs))


def random_state_dicts(seed: int, widths=VGG16_WIDTHS) -> tuple[dict, dict]:
    """(vgg_sd, lpips_sd) of seeded random weights in the torchvision and
    lpips naming, at the given block widths (VGG16's by default): He-scaled
    convolutions, small biases, non-negative linear weights."""
    rng = np.random.default_rng(seed)
    vgg_sd, lin_sd = {}, {}
    cin = 3
    for b, (idxs, cout) in enumerate(zip(_TORCH_IDX, widths)):
        for i in idxs:
            w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
            vgg_sd[f"features.{i}.weight"] = torch.from_numpy(w.astype(np.float32))
            vgg_sd[f"features.{i}.bias"] = torch.from_numpy(
                (0.01 * rng.standard_normal(cout)).astype(np.float32))
            cin = cout
        lin_sd[f"lin{b}.model.1.weight"] = torch.from_numpy(
            (0.1 * np.abs(rng.standard_normal((1, cout, 1, 1)))).astype(np.float32))
    return vgg_sd, lin_sd
