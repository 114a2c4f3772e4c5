"""LPIPS with the AlexNet backbone (counterpart of
``leftrefill_tpu/eval/lpips.py``): images in [-1, 1] (NHWC) through the
fixed ScalingLayer, the five AlexNet conv taps (each after its ReLU; 3x3 / 2
max pools after the first two), each tap unit-normalised over its channels,
the squared difference through a non-negative 1x1 ``lin`` conv without bias,
its spatial mean, and the sum over the taps: one distance per row.

The state_dict names are ``net.conv{i}.weight`` / ``.bias`` (OIHW) and
``lin{i}.weight`` ([1, C, 1, 1]); ``load_lpips_weights`` maps the standard
lpips checkpoint (``lin{i}.model.1.weight``) and torchvision's AlexNet
(``features.{0,3,6,8,10}.*``) onto them.  Without AlexNet weights the convs
are drawn from a seeded generator: the module runs, but it is not a
calibrated metric (JAX's fallback draws other values).  The convs are plain
``torch.nn.functional.conv2d``: the JAX package computes them in XLA,
outside any Pallas kernel."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the ScalingLayer's constants of the published LPIPS
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# AlexNet's feature convs: (out channels, kernel, stride, padding); max pool after taps 0 and 1
ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
POOL_AFTER = (0, 1)
ALEX_FEATURE_IDS = (0, 3, 6, 8, 10)  # torchvision's alexnet.features index of each conv


class AlexFeatures(nn.Module):
    """[B, 3, H, W] -> the five ReLU'd conv taps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, _, _) in enumerate(ALEX):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, k))
            cin = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i, (_, _, stride, pad) in enumerate(ALEX):
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=pad))
            feats.append(x)
            if i in POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """``forward(x, y)``: [B, H, W, 3] images in [-1, 1] -> [B] distances."""

    def __init__(self):
        super().__init__()
        self.net = AlexFeatures()
        for i, (ch, _, _, _) in enumerate(ALEX):
            setattr(self, f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net((x.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fy = self.net((y.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt((a**2).sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b**2).sum(dim=1, keepdim=True) + 1e-10)
            d = F.conv2d((a - b) ** 2, getattr(self, f"lin{i}").weight)
            total = total + d.mean(dim=(1, 2, 3))
        return total


def load_lpips_weights(weights_path: str, alexnet_path: Optional[str] = None,
                       generator: Optional[torch.Generator] = None) -> dict[str, torch.Tensor]:
    """The ``LPIPS`` state_dict from the lpips checkpoint (``lin{i}.model.1.weight``
    or ``lin{i}.weight``, e.g. lpips/weights/v0.1/alex.pth) and torchvision's
    AlexNet state_dict (``features.N.weight`` / ``.bias``), read through
    ``convert.checkpoint.load_torch_state_dict``.  Without ``alexnet_path``
    the convs are drawn from ``generator`` (seed 0 by default): a smoke-test
    metric, not a calibrated one."""
    from leftrefill_torch.convert.checkpoint import load_torch_state_dict

    out: dict[str, torch.Tensor] = {}
    if alexnet_path is None:
        g = generator or torch.Generator().manual_seed(0)
        cin = 3
        for i, (ch, k, _, _) in enumerate(ALEX):
            fan_in = cin * k * k
            out[f"net.conv{i}.weight"] = torch.randn((ch, cin, k, k), generator=g) / fan_in**0.5
            out[f"net.conv{i}.bias"] = torch.zeros(ch)
            cin = ch
    else:
        alex = load_torch_state_dict(alexnet_path)
        for i, fi in enumerate(ALEX_FEATURE_IDS):
            out[f"net.conv{i}.weight"] = alex[f"features.{fi}.weight"]
            out[f"net.conv{i}.bias"] = alex[f"features.{fi}.bias"]
    lin = load_torch_state_dict(weights_path)
    for i in range(len(ALEX)):
        key = f"lin{i}.model.1.weight" if f"lin{i}.model.1.weight" in lin else f"lin{i}.weight"
        out[f"lin{i}.weight"] = lin[key]
    return out
