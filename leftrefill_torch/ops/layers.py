"""Low-level layer ops shared by the models (counterpart of
``leftrefill_tpu/ops/layers.py``).  Spatial tensors are NHWC, as in the JAX
package."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from leftrefill_torch.ops import quant


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: int = 10000, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Sinusoidal embedding, cos first ([cos, sin]), fp32 math.  ``timesteps``
    may be integer or float (DPM-Solver++ calls the UNet at float t)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)


def adjust_groups(num_groups: int, c: int) -> int:
    """Real configs always have c % 32 == 0; clamp only for tiny test nets."""
    g = min(num_groups, c)
    while c % g:
        g -= 1
    return g


def group_norm32(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    fast_affine: bool = True,
) -> torch.Tensor:
    """GroupNorm over the last (channel) axis with fp32 statistics.

    (mean, rstd, gamma, beta) fold into a per-(batch, channel) affine A, B in
    fp32.  With ``fast_affine`` (the JAX package's default) a bf16 x takes
    one bf16 multiply-add with A and B rounded to bf16; otherwise, and always
    in fp32, the output is x*A + B in fp32, cast to x's dtype once."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    g = adjust_groups(num_groups, c)
    xg = x.reshape(b, -1, g, c // g).to(torch.float32)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    rstd = torch.rsqrt(var + eps)
    gamma = scale.to(torch.float32).reshape(g, c // g)
    beta = bias.to(torch.float32).reshape(g, c // g)
    one = (1,) * (x.ndim - 2)
    a = (rstd * gamma).reshape(b, *one, c)
    bb = (beta - mean * rstd * gamma).reshape(b, *one, c)
    if fast_affine and dtype != torch.float32:
        return x * a.to(dtype) + bb.to(dtype)
    return (x.to(torch.float32) * a + bb).to(dtype)


class GroupNorm32(nn.Module):
    """GroupNorm with the fp32 statistics island; parameters ``weight`` and
    ``bias`` as in torch's ``nn.GroupNorm`` (checkpoint key layout)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm32(x, self.weight, self.bias, self.num_groups, self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``, its parameters held in it.

    ``quant=True`` is the W8A8 arm (JAX: ``QDense`` with an int8 kernel): an
    int8 ``weight`` [out, in] with its per-output-channel ``weight_scale`` and
    an fp32 bias; x is quantized per row (or passed pre-quantized, so q/k/v
    of one activation share one pass) and goes through ``dense_int8``."""

    def __init__(self, din: int, dout: int, bias: bool = True, dtype: torch.dtype = torch.float32,
                 quant: bool = False):
        super().__init__(din, dout, bias=bias, dtype=dtype)
        self.compute_dtype, self.quant = dtype, quant
        if quant:
            self.weight = nn.Parameter(torch.empty(dout, din, dtype=torch.int8), requires_grad=False)
            self.weight_scale = nn.Parameter(torch.ones(dout))
            if bias:
                self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor, xq: torch.Tensor | None = None,
                x_scale: torch.Tensor | None = None) -> torch.Tensor:
        d = self.compute_dtype
        if self.quant:
            if xq is None:
                xq, x_scale = quant.quantize_activation_rowwise(x)
            return quant.dense_int8(xq, x_scale, self.weight, self.weight_scale, self.bias, out_dtype=d)
        b = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), b)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample on NHWC (each pixel repeated twice per axis)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def nearest_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize on NHWC with torch ``F.interpolate(mode='nearest')``
    index semantics (floor of the source index scaled by in/out)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = torch.from_numpy(np.floor(np.arange(oh) * (h / oh)).astype(np.int64)).to(x.device)
    cols = torch.from_numpy(np.floor(np.arange(ow) * (w / ow)).astype(np.int64)).to(x.device)
    return x.index_select(1, rows).index_select(2, cols)


def conv2d_nhwc(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int = 1, padding=1
) -> torch.Tensor:
    """Plain convolution on NHWC activations with an OIHW weight, computed in
    x's dtype (the JAX package's ``lax.conv`` sites).  ``padding`` is an int
    or torch's per-side tuple."""
    d = x.dtype
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(d), None if bias is None else bias.to(d),
        stride=stride, padding=padding,
    )
    return y.permute(0, 2, 3, 1).contiguous()
