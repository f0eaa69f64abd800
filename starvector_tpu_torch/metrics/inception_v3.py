"""InceptionV3 pool3 feature extractor (the FID network) in PyTorch (the
port of starvector_tpu/metrics/inception_v3.py, which is JAX).

Parity target: the reference vendors pytorch-fid's InceptionV3 and computes
FID over its 2048-dim pool3 features (reference:
starvector/metrics/inception.py:16-340, compute_fid.py:15-145). Modules carry
the pytorch-fid / torchvision names, so their state dicts load as they are:
BasicConv2d is a conv without bias, then BatchNorm (eps 1e-3, applied in
fp32), then relu; the Inception A/B/C/D/E towers pool with a 3x3 average
(count_include_pad=False, pytorch-fid's FIDInception{A,C,E} patch), but for
Mixed_7c's pool branch, a 3x3 MAX pool (FIDInceptionE_2); the end is a
global mean. Each convolution takes its widths from the state dict, so a
narrow one runs as well as the real one. This is not torchvision's
inception_v3 (torchvision is not a dependency).

The public functions take (B, H, W, 3) images in [-1, 1], as the JAX
package's do; the network runs NCHW on the device it was loaded to (the
card unless the caller asks for the CPU)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from starvector_tpu_torch import require_device

_BN_EPS = 1e-3
FEATURE_DIM = 2048

# ---------------------------------------------------------------------------
# architecture: torch name -> (stock in, stock out, (kh, kw), stride, (ph, pw))
# ---------------------------------------------------------------------------

_STEM = (
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    "maxpool",
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    "maxpool",
)


def _inception_a(cin, pool_features):
    return {
        "branch1x1": [(cin, 64, (1, 1), 1, (0, 0))],
        "branch5x5": [(cin, 48, (1, 1), 1, (0, 0)), (48, 64, (5, 5), 1, (2, 2))],
        "branch3x3dbl": [(cin, 64, (1, 1), 1, (0, 0)), (64, 96, (3, 3), 1, (1, 1)),
                         (96, 96, (3, 3), 1, (1, 1))],
        "branch_pool": [(cin, pool_features, (1, 1), 1, (0, 0))],
    }


def _inception_b(cin):
    return {
        "branch3x3": [(cin, 384, (3, 3), 2, (0, 0))],
        "branch3x3dbl": [(cin, 64, (1, 1), 1, (0, 0)), (64, 96, (3, 3), 1, (1, 1)),
                         (96, 96, (3, 3), 2, (0, 0))],
    }


def _inception_c(cin, c7):
    return {
        "branch1x1": [(cin, 192, (1, 1), 1, (0, 0))],
        "branch7x7": [(cin, c7, (1, 1), 1, (0, 0)), (c7, c7, (1, 7), 1, (0, 3)),
                      (c7, 192, (7, 1), 1, (3, 0))],
        "branch7x7dbl": [(cin, c7, (1, 1), 1, (0, 0)), (c7, c7, (7, 1), 1, (3, 0)),
                         (c7, c7, (1, 7), 1, (0, 3)), (c7, c7, (7, 1), 1, (3, 0)),
                         (c7, 192, (1, 7), 1, (0, 3))],
        "branch_pool": [(cin, 192, (1, 1), 1, (0, 0))],
    }


def _inception_d(cin):
    return {
        "branch3x3": [(cin, 192, (1, 1), 1, (0, 0)), (192, 320, (3, 3), 2, (0, 0))],
        "branch7x7x3": [(cin, 192, (1, 1), 1, (0, 0)), (192, 192, (1, 7), 1, (0, 3)),
                        (192, 192, (7, 1), 1, (3, 0)), (192, 192, (3, 3), 2, (0, 0))],
    }


def _inception_e(cin):
    # every entry is a single conv matching its torch module name exactly
    return {
        "branch1x1": [(cin, 320, (1, 1), 1, (0, 0))],
        "branch3x3_1": [(cin, 384, (1, 1), 1, (0, 0))],
        "branch3x3_2a": [(384, 384, (1, 3), 1, (0, 1))],
        "branch3x3_2b": [(384, 384, (3, 1), 1, (1, 0))],
        "branch3x3dbl_1": [(cin, 448, (1, 1), 1, (0, 0))],
        "branch3x3dbl_2": [(448, 384, (3, 3), 1, (1, 1))],
        "branch3x3dbl_3a": [(384, 384, (1, 3), 1, (0, 1))],
        "branch3x3dbl_3b": [(384, 384, (3, 1), 1, (1, 0))],
        "branch_pool": [(cin, 192, (1, 1), 1, (0, 0))],
    }


_MIXED = (
    ("Mixed_5b", _inception_a(192, 32), "A"),
    ("Mixed_5c", _inception_a(256, 64), "A"),
    ("Mixed_5d", _inception_a(288, 64), "A"),
    ("Mixed_6a", _inception_b(288), "B"),
    ("Mixed_6b", _inception_c(768, 128), "C"),
    ("Mixed_6c", _inception_c(768, 160), "C"),
    ("Mixed_6d", _inception_c(768, 160), "C"),
    ("Mixed_6e", _inception_c(768, 192), "C"),
    ("Mixed_7a", _inception_d(768), "D"),
    ("Mixed_7b", _inception_e(1280), "E"),
    ("Mixed_7c", _inception_e(2048), "E"),
)


def _torch_names(spec: dict) -> dict[str, list[tuple[str, tuple]]]:
    """branch -> [(torch module name, conv spec)]: a branch of one conv
    takes the bare name, a longer one branchX_1..N."""
    return {br: [(br if len(convs) == 1 else f"{br}_{i + 1}", c) for i, c in enumerate(convs)]
            for br, convs in spec.items()}


def _convs():
    """Every BasicConv2d as (full torch name, stock spec), in order."""
    for entry in _STEM:
        if entry != "maxpool":
            yield entry[0], entry[1:]
    for name, spec, _ in _MIXED:
        for convs in _torch_names(spec).values():
            for tname, c in convs:
                yield f"{name}.{tname}", c


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class _BatchNorm(nn.Module):
    """BatchNorm's four tensors under torch's names (inference only)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int, padding):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        inv = torch.rsqrt(bn.running_var.float() + _BN_EPS).view(1, -1, 1, 1)
        y = (self.conv(x).float() - bn.running_mean.float().view(1, -1, 1, 1)) * inv
        y = y * bn.weight.float().view(1, -1, 1, 1) + bn.bias.float().view(1, -1, 1, 1)
        return F.relu(y).to(x.dtype)


def _avgpool3s1_nocountpad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionV3(nn.Module):
    """The pool3 extractor; `widths` maps each conv's full torch name to its
    (in, out) channels."""

    def __init__(self, widths: dict[str, tuple[int, int]]):
        super().__init__()
        for entry in _STEM:
            if entry != "maxpool":
                name, _, _, k, s, p = entry
                self.add_module(name, BasicConv2d(*widths[name], k, s, p))
        for name, spec, _ in _MIXED:
            block = nn.Module()
            for convs in _torch_names(spec).values():
                for tname, (_, _, k, s, p) in convs:
                    block.add_module(tname, BasicConv2d(*widths[f"{name}.{tname}"], k, s, p))
            self.add_module(name, block)

    @classmethod
    def from_torch_state_dict(cls, sd: dict, *, dtype=torch.float32,
                              device="cuda") -> "InceptionV3":
        """A pytorch-fid / torchvision inception_v3 state dict (other keys,
        such as fc and AuxLogits, are ignored). On the card unless
        `device="cpu"`."""
        device = require_device(device, 'device="cpu"')
        widths = {}
        for name, (_, _, k, _, _) in _convs():
            shape = tuple(sd[f"{name}.conv.weight"].shape)
            if shape[2:] != k:
                raise ValueError(f"{name}.conv.weight has shape {shape}, not a {k} kernel")
            widths[name] = (shape[1], shape[0])
        net = cls(widths)
        net.load_state_dict({k: torch.as_tensor(sd[k]) for k in net.state_dict()})
        return net.to(device=device, dtype=dtype).eval().requires_grad_(False)

    def _branch(self, block, convs, x):
        for tname, _ in convs:
            x = getattr(block, tname)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1] → (B, 2048) pool3 features."""
        for entry in _STEM:
            x = F.max_pool2d(x, 3, 2) if entry == "maxpool" else getattr(self, entry[0])(x)
        for name, spec, kind in _MIXED:
            block, b = getattr(self, name), _torch_names(spec)

            def run(br, inp):
                return self._branch(block, b[br], inp)

            if kind == "A":
                outs = [run("branch1x1", x), run("branch5x5", x), run("branch3x3dbl", x),
                        run("branch_pool", _avgpool3s1_nocountpad(x))]
            elif kind == "B":
                outs = [run("branch3x3", x), run("branch3x3dbl", x), F.max_pool2d(x, 3, 2)]
            elif kind == "C":
                outs = [run("branch1x1", x), run("branch7x7", x), run("branch7x7dbl", x),
                        run("branch_pool", _avgpool3s1_nocountpad(x))]
            elif kind == "D":
                outs = [run("branch3x3", x), run("branch7x7x3", x), F.max_pool2d(x, 3, 2)]
            else:  # E
                m = run("branch3x3_1", x)
                b2 = torch.cat([run("branch3x3_2a", m), run("branch3x3_2b", m)], 1)
                m = run("branch3x3dbl_2", run("branch3x3dbl_1", x))
                b3 = torch.cat([run("branch3x3dbl_3a", m), run("branch3x3dbl_3b", m)], 1)
                # Mixed_7b = FIDInceptionE_1 (avg, count_include_pad=False);
                # Mixed_7c = FIDInceptionE_2 (MAX) — pytorch-fid parity
                pool_in = (F.max_pool2d(x, 3, 1, 1) if name == "Mixed_7c"
                           else _avgpool3s1_nocountpad(x))
                outs = [run("branch1x1", x), b2, b3, run("branch_pool", pool_in)]
            x = torch.cat(outs, 1)
        return torch.mean(x, dim=(2, 3))  # global average pool → (B, 2048)


@torch.no_grad()
def features(net: InceptionV3, x) -> torch.Tensor:
    """x: (B, 299, 299, 3) in [-1, 1] → (B, 2048) pool3 features, on the
    network's device."""
    w = net.Conv2d_1a_3x3.conv.weight
    x = torch.as_tensor(x, device=w.device).permute(0, 3, 1, 2).to(w.dtype)
    return net(x)


def preprocess(pil_images, size: int = 299) -> torch.Tensor:
    """PIL → (B, 299, 299, 3) in [-1, 1] on the host (PIL's default resize,
    then 2x - 1; reference inception.py:119-126)."""
    arrs = []
    for im in pil_images:
        im = im.convert("RGB").resize((size, size))
        arrs.append(np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0)
    return torch.from_numpy(np.stack(arrs))


def random_state_dict(seed: int, divisor: int = 1) -> dict:
    """A seeded random state dict in the torchvision naming, every width
    but the 3 input channels divided by `divisor` (1: the real network's
    shapes): He-scaled convolutions, BatchNorm statistics near identity."""
    rng = np.random.default_rng(seed)

    def width(c):
        return c if c == 3 else c // divisor

    sd = {}
    for name, (cin, cout, k, _, _) in _convs():
        cin, cout = width(cin), width(cout)
        w = rng.standard_normal((cout, cin, *k)) * np.sqrt(2.0 / (cin * k[0] * k[1]))
        sd[f"{name}.conv.weight"] = w
        sd[f"{name}.bn.weight"] = 1.0 + 0.1 * rng.standard_normal(cout)
        sd[f"{name}.bn.bias"] = 0.1 * rng.standard_normal(cout)
        sd[f"{name}.bn.running_mean"] = 0.1 * rng.standard_normal(cout)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, cout)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
