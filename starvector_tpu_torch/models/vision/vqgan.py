"""VQGAN (taming-transformers) convolutional encoder (port of
starvector_tpu/models/vision/vqgan.py).

The reference's 'vqgan' backend feeds the taming `Encoder`'s (B, 256, 14,
14) feature map as 196 visual tokens of width 256. The f16 geometry: ch 128,
ch_mult (1, 1, 2, 2, 4), 2 res blocks a level, attention at the deepest
level and in the mid stack, GroupNorm(32, eps 1e-6) in fp32 and swish
everywhere. Downsampling pads (0, 1, 0, 1) and convolves 3x3 at stride 2
without padding. The attention block is one head over the H x W positions,
scaled by C ** -0.5, its softmax in fp32.

Parameters keep the JAX package's layout (HWIO kernels, lists of levels and
blocks); activations are channels-last (B, H, W, C) from end to end
(ops/layers.py::conv_nhwc), so the tokens come out in JAX's
reshape(B, H*W, C) order. Weights load from a taming checkpoint's encoder
(`from_torch_state_dict`, prefix "encoder."); none ships with the repo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from starvector_tpu_torch.ops.layers import DTypePolicy, conv_nhwc, normal_, swish
from starvector_tpu_torch.parallel.mesh import P
from starvector_tpu_torch.parallel.zero import gathered


@dataclasses.dataclass(frozen=True)
class VQGANEncoderConfig:
    in_channels: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    attn_levels: tuple[int, ...] = (4,)  # taming attn_resolutions=[16] at resolution 256
    group_norm_groups: int = 32

    @property
    def num_levels(self) -> int:
        return len(self.ch_mult)

    def tokens_for(self, image_size: int) -> int:
        side = image_size // (2 ** (self.num_levels - 1))
        return side * side


def tiny_config(**kw) -> VQGANEncoderConfig:
    base = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=16, attn_levels=(1,),
                group_norm_groups=4)
    base.update(kw)
    return VQGANEncoderConfig(**base)


# -- parameters (the JAX package's distributions, drawn from a torch.Generator)

def _conv_p(gen, kh: int, kw: int, cin: int, cout: int, device, dtype) -> dict:
    return {"kernel": normal_((kh, kw, cin, cout), (kh * kw * cin) ** -0.5, gen, device, dtype),
            "bias": torch.zeros(cout, device=device, dtype=dtype)}


def _gn_p(c: int, device, dtype) -> dict:
    return {"scale": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


def _res_block_p(gen, cin: int, cout: int, device, dtype) -> dict:
    p = {"norm1": _gn_p(cin, device, dtype), "conv1": _conv_p(gen, 3, 3, cin, cout, device, dtype),
         "norm2": _gn_p(cout, device, dtype), "conv2": _conv_p(gen, 3, 3, cout, cout, device, dtype)}
    if cin != cout:
        p["nin_shortcut"] = _conv_p(gen, 1, 1, cin, cout, device, dtype)
    return p


def _attn_block_p(gen, c: int, device, dtype) -> dict:
    p = {"norm": _gn_p(c, device, dtype)}
    for name in ("q", "k", "v", "proj_out"):
        p[name] = _conv_p(gen, 1, 1, c, c, device, dtype)
    return p


def init_params(cfg: VQGANEncoderConfig, gen: torch.Generator, *, device="cpu",
                dtype=torch.float32) -> dict:
    params: dict = {"conv_in": _conv_p(gen, 3, 3, cfg.in_channels, cfg.ch, device, dtype)}
    cin, down = cfg.ch, []
    for lvl, mult in enumerate(cfg.ch_mult):
        cout = cfg.ch * mult
        level: dict = {"block": []}
        for _ in range(cfg.num_res_blocks):
            level["block"].append(_res_block_p(gen, cin, cout, device, dtype))
            if lvl in cfg.attn_levels:
                level.setdefault("attn", []).append(_attn_block_p(gen, cout, device, dtype))
            cin = cout
        if lvl != cfg.num_levels - 1:
            level["downsample"] = {"conv": _conv_p(gen, 3, 3, cout, cout, device, dtype)}
        down.append(level)
    params["down"] = down
    params["mid"] = {"block_1": _res_block_p(gen, cin, cin, device, dtype),
                     "attn_1": _attn_block_p(gen, cin, device, dtype),
                     "block_2": _res_block_p(gen, cin, cin, device, dtype)}
    params["norm_out"] = _gn_p(cin, device, dtype)
    params["conv_out"] = _conv_p(gen, 3, 3, cin, cfg.z_channels, device, dtype)
    return params


# -- forward -------------------------------------------------------------------

def _group_norm(p: dict, x: torch.Tensor, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of NHWC x with fp32 statistics and affine, one rounding."""
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), groups, p["scale"].float(),
                     p["bias"].float(), eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _res_block(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv_nhwc(p["conv1"], swish(_group_norm(p["norm1"], x, groups)))
    h = conv_nhwc(p["conv2"], swish(_group_norm(p["norm2"], h, groups)))
    if "nin_shortcut" in p:
        x = conv_nhwc(p["nin_shortcut"], x)
    return x + h


def _attn_block(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """One head over the H x W positions: scores accumulated in fp32 from
    the exact products, scaled by C ** -0.5, softmax in fp32, probabilities
    rounded to x's dtype before the product with v."""
    B, H, W, C = x.shape
    h = _group_norm(p["norm"], x, groups)
    q, k, v = (conv_nhwc(p[n], h).reshape(B, H * W, C) for n in ("q", "k", "v"))
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * (C ** -0.5)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.bmm(a, v).reshape(B, H, W, C)
    return x + conv_nhwc(p["proj_out"], out)


def partition_rules() -> list[tuple[str, P]]:
    """Every leaf replicated: the convolutions are small beside the
    decoders (the JAX package's rule)."""
    return [(r".*", P(None))]


def forward(params: dict, cfg: VQGANEncoderConfig, images: torch.Tensor, *,
            policy: DTypePolicy = DTypePolicy(), remat: bool | str = False) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, tokens, z_channels), the
    flattened feature map (the reference's view(B, C, -1).permute(0, 2, 1)).
    `remat` is taken and ignored, as in the JAX package: the tower is
    shallow."""
    params = gathered(params)  # replicated by its rules; whole on a layout
    g = cfg.group_norm_groups
    x = conv_nhwc(params["conv_in"], policy.cast(images))
    for level in params["down"]:
        for i, bp in enumerate(level["block"]):
            x = _res_block(bp, x, g)
            if "attn" in level:
                x = _attn_block(level["attn"][i], x, g)
        if "downsample" in level:
            # taming pads the bottom and the right by one, then convolves
            # at stride 2 without padding
            x = conv_nhwc(level["downsample"]["conv"], F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2,
                          padding="valid")
    x = _res_block(params["mid"]["block_1"], x, g)
    x = _attn_block(params["mid"]["attn_1"], x, g)
    x = _res_block(params["mid"]["block_2"], x, g)
    x = conv_nhwc(params["conv_out"], swish(_group_norm(params["norm_out"], x, g)))
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


# -- checkpoint conversion -------------------------------------------------------

def from_torch_state_dict(sd, cfg: VQGANEncoderConfig, *, dtype=None, prefix: str = "encoder.",
                          device="cpu") -> dict:
    """A taming checkpoint's encoder weights (OIHW convolutions, numpy or
    torch values) -> this module's parameters. Attention blocks and
    downsampling are taken where the state dict holds them, as the JAX
    converter does."""
    import numpy as np

    from starvector_tpu_torch.models.convert import to_tensor

    def t(name):
        return to_tensor(np.asarray(sd[prefix + name], np.float32), dtype, device)

    def conv(name):
        w = np.asarray(sd[prefix + name + ".weight"], np.float32).transpose(2, 3, 1, 0)
        return {"kernel": to_tensor(w, dtype, device), "bias": t(name + ".bias")}

    def gn(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    def res(name, has_nin):
        p = {"norm1": gn(name + ".norm1"), "conv1": conv(name + ".conv1"),
             "norm2": gn(name + ".norm2"), "conv2": conv(name + ".conv2")}
        if has_nin:
            p["nin_shortcut"] = conv(name + ".nin_shortcut")
        return p

    def attn(name):
        return {"norm": gn(name + ".norm"),
                **{n: conv(f"{name}.{n}") for n in ("q", "k", "v", "proj_out")}}

    params: dict = {"conv_in": conv("conv_in")}
    cin, down = cfg.ch, []
    for lvl, mult in enumerate(cfg.ch_mult):
        cout = cfg.ch * mult
        level: dict = {"block": []}
        for i in range(cfg.num_res_blocks):
            level["block"].append(res(f"down.{lvl}.block.{i}", cin != cout))
            if f"{prefix}down.{lvl}.attn.{i}.norm.weight" in sd:
                level.setdefault("attn", []).append(attn(f"down.{lvl}.attn.{i}"))
            cin = cout
        if f"{prefix}down.{lvl}.downsample.conv.weight" in sd:
            level["downsample"] = {"conv": conv(f"down.{lvl}.downsample.conv")}
        down.append(level)
    params["down"] = down
    params["mid"] = {"block_1": res("mid.block_1", False), "attn_1": attn("mid.attn_1"),
                     "block_2": res("mid.block_2", False)}
    params["norm_out"] = gn("norm_out")
    params["conv_out"] = conv("conv_out")
    return params
