"""ConvNeXt-Base trunk, open_clip's 'convnext_base_w' visual tower (port of
starvector_tpu/models/vision/convnext.py).

The reference's 'convnext' backend runs the trunk's forward_features and
flattens the (B, 1024, 7, 7) last stage into 49 visual tokens of width
1024. Geometry: a 4x4 / 4 stem convolution, then LayerNorm; 4 stages of
depths (3, 3, 27, 3) and widths (128, 256, 512, 1024), each stage after the
first opening with LayerNorm and a 2x2 / 2 convolution. A block: 7x7
depthwise convolution (groups = width) -> LayerNorm over channels (fp32,
eps 1e-6) -> 4x pointwise expansion -> exact GELU -> pointwise projection
-> layer-scale `gamma` -> residual.

Parameters keep the JAX package's layout (HWIO kernels, lists of stages
and blocks); activations are channels-last from end to end
(ops/layers.py::conv_nhwc), so the LayerNorms and the pointwise MLP act on
the last axis and the tokens come out in JAX's reshape(B, H*W, C) order.
Weights load from an open_clip state dict (`from_torch_state_dict`, timm
trunk names, prefix "visual.trunk."); none ships with the repo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from starvector_tpu_torch.ops.layers import DTypePolicy, conv_nhwc, layer_norm, normal_
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.zero import gathered


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple[int, ...] = (3, 3, 27, 3)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    patch: int = 4
    ln_eps: float = 1e-6

    def tokens_for(self, image_size: int) -> int:
        side = image_size // (self.patch * 2 ** (len(self.dims) - 1))
        return side * side


def tiny_config(**kw) -> ConvNeXtConfig:
    base = dict(depths=(1, 1), dims=(8, 16))
    base.update(kw)
    return ConvNeXtConfig(**base)


# -- parameters (the JAX package's distributions, drawn from a torch.Generator)

def _conv_p(gen, kh: int, kw: int, cin: int, cout: int, device, dtype, groups: int = 1) -> dict:
    return {"kernel": normal_((kh, kw, cin // groups, cout), (kh * kw * cin // groups) ** -0.5,
                              gen, device, dtype),
            "bias": torch.zeros(cout, device=device, dtype=dtype)}


def _ln_p(c: int, device, dtype) -> dict:
    return {"scale": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


def _block_p(gen, dim: int, device, dtype) -> dict:
    return {
        "conv_dw": _conv_p(gen, 7, 7, dim, dim, device, dtype, groups=dim),
        "norm": _ln_p(dim, device, dtype),
        "mlp": {"fc1": {"kernel": normal_((dim, 4 * dim), dim ** -0.5, gen, device, dtype),
                        "bias": torch.zeros(4 * dim, device=device, dtype=dtype)},
                "fc2": {"kernel": normal_((4 * dim, dim), (4 * dim) ** -0.5, gen, device, dtype),
                        "bias": torch.zeros(dim, device=device, dtype=dtype)}},
        "gamma": torch.full((dim,), 1e-6, device=device, dtype=dtype),
    }


def init_params(cfg: ConvNeXtConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    params: dict = {"stem": {"conv": _conv_p(gen, cfg.patch, cfg.patch, 3, cfg.dims[0], device,
                                             dtype),
                             "norm": _ln_p(cfg.dims[0], device, dtype)}}
    stages = []
    for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage: dict = {"blocks": [_block_p(gen, dim, device, dtype) for _ in range(depth)]}
        if si > 0:
            stage["downsample"] = {"norm": _ln_p(cfg.dims[si - 1], device, dtype),
                                   "conv": _conv_p(gen, 2, 2, cfg.dims[si - 1], dim, device,
                                                   dtype)}
        stages.append(stage)
    params["stages"] = stages
    return params


# -- forward -------------------------------------------------------------------

def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias in x's dtype (the JAX einsum, then the bias)."""
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


def _block(p: dict, cfg: ConvNeXtConfig, x: torch.Tensor) -> torch.Tensor:
    h = conv_nhwc(p["conv_dw"], x, groups=x.shape[-1])
    h = layer_norm(p["norm"], h, cfg.ln_eps)
    h = F.gelu(_linear(p["mlp"]["fc1"], h), approximate="none")
    h = _linear(p["mlp"]["fc2"], h)
    return x + h * p["gamma"].to(h.dtype)


def partition_rules() -> list[tuple[str, P]]:
    """Every leaf replicated (the JAX package's rule)."""
    return [(r".*", P(None))]


def forward(params: dict, cfg: ConvNeXtConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, tokens, dims[-1]), the last
    stage's map flattened. `remat` is taken and ignored, as in the JAX
    package."""
    params = gathered(params)  # replicated by its rules; whole on a layout
    x = conv_nhwc(params["stem"]["conv"], policy.cast(images), stride=cfg.patch, padding="valid")
    x = layer_norm(params["stem"]["norm"], x, cfg.ln_eps)
    for stage in params["stages"]:
        if "downsample" in stage:
            x = layer_norm(stage["downsample"]["norm"], x, cfg.ln_eps)
            x = conv_nhwc(stage["downsample"]["conv"], x, stride=2, padding="valid")
        for bp in stage["blocks"]:
            x = _block(bp, cfg, x)
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


# -- checkpoint conversion -------------------------------------------------------

def from_torch_state_dict(sd, cfg: ConvNeXtConfig, *, dtype=None, prefix: str = "visual.trunk.",
                          device="cpu") -> dict:
    """An open_clip ConvNeXt state dict (timm trunk names: stem.0 / stem.1,
    stages.i.downsample.0 / .1, stages.i.blocks.j.{conv_dw, norm, mlp.fc1,
    mlp.fc2, gamma}) -> this module's parameters."""
    import numpy as np

    from starvector_tpu_torch.models.convert import to_tensor

    def t(name, transpose=None):
        a = np.asarray(sd[prefix + name], np.float32)
        return to_tensor(a if transpose is None else a.transpose(transpose), dtype, device)

    def conv(name):
        return {"kernel": t(name + ".weight", (2, 3, 1, 0)), "bias": t(name + ".bias")}

    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    def lin(name):
        return {"kernel": t(name + ".weight", (1, 0)), "bias": t(name + ".bias")}

    params: dict = {"stem": {"conv": conv("stem.0"), "norm": ln("stem.1")}}
    stages = []
    for si, depth in enumerate(cfg.depths):
        stage: dict = {"blocks": []}
        if si > 0:
            stage["downsample"] = {"norm": ln(f"stages.{si}.downsample.0"),
                                   "conv": conv(f"stages.{si}.downsample.1")}
        for bi in range(depth):
            base = f"stages.{si}.blocks.{bi}"
            stage["blocks"].append({"conv_dw": conv(base + ".conv_dw"), "norm": ln(base + ".norm"),
                                    "mlp": {"fc1": lin(base + ".mlp.fc1"),
                                            "fc2": lin(base + ".mlp.fc2")},
                                    "gamma": t(base + ".gamma")})
        stages.append(stage)
    params["stages"] = stages
    return params
