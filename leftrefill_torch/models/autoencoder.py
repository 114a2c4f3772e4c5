"""AutoencoderKL (the frozen SD2 VAE) in PyTorch, NHWC (counterpart of
``leftrefill_tpu/models/autoencoder.py``).  Module names follow the SD2
checkpoint (``encoder.down.0.block.1.norm1.weight`` ...).  Every VAE conv is
a plain convolution, as in the JAX package.

``AutoencoderKL(quant_decoder=True)`` (JAX: autoencoder.py:44-60,
:190-226, the serving path's ``quant_vae``): the decoder's res-block convs,
its upsample convs and its ``nin_shortcut`` 1x1s are W8A8 int8 through the
UNet's ``Conv3x3(quant=True)`` and ``Conv1x1(quant=True)``: KI1 where
``ops.quant.conv3x3_int8_qualifies`` takes the shape, elsewhere the
dequantized weight through ``conv3x3_apply`` (K2 in bf16 on the card), and
``dense_int8`` for the 1x1s.  ``conv_in``, ``conv_out`` and the attention
block stay fp.  Their keys are the fp decoder's plus a ``weight_scale``;
``ops.quant.quantize_params_like`` fills them from an fp state_dict."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from leftrefill_torch.ops.attention import multi_head_attention
from leftrefill_torch.ops.layers import GroupNorm32, conv2d_nhwc, nearest_upsample_2x


class Conv(nn.Module):
    """k x k conv (OIHW weight + bias) on NHWC activations, computed in
    ``dtype``; ``padding`` is torch's (an int or a per-side tuple)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, padding=1, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding if k == 3 else 0, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x.to(self.dtype), self.weight, self.bias, self.stride, self.padding)


def _conv(cin: int, cout: int, k: int = 3, dtype=torch.float32, quant: bool = False) -> nn.Module:
    """A stride-1 conv of the VAE: the plain one, or ``quant`` the UNet's
    int8 3x3 or 1x1 (JAX: autoencoder.py:44-60)."""
    if not quant:
        return Conv(cin, cout, k=k, dtype=dtype)
    from leftrefill_torch.models.unet import Conv1x1, Conv3x3

    return Conv3x3(cin, cout, dtype=dtype, quant=True) if k == 3 else Conv1x1(cin, cout, dtype=dtype, quant=True)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.norm1 = GroupNorm32(cin, eps=1e-6)
        self.conv1 = _conv(cin, cout, dtype=dtype, quant=quant)
        self.norm2 = GroupNorm32(cout, eps=1e-6)
        self.conv2 = _conv(cout, cout, dtype=dtype, quant=quant)
        self.nin_shortcut = _conv(cin, cout, k=1, dtype=dtype, quant=quant) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head bottleneck self-attention over the flattened pixels; it
    takes the plain exact-softmax attention, as in JAX."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm32(c, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv(c, c, k=1, dtype=dtype) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, h * w, c) for m in (self.q, self.k, self.v))
        out = multi_head_attention(q, k, v, num_heads=1, plain=True).reshape(b, h, w, c)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric (0, 1) pad, then a stride-2 VALID conv."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(c, c, stride=2, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int, dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.conv = _conv(c, c, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


@dataclasses.dataclass(frozen=True)
class DDConfig:
    """AutoencoderKL's ddconfig (SD2: ch 128, ch_mult (1, 2, 4, 4), z 4)."""

    double_z: bool = True
    z_channels: int = 4
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = ()


def _level(blocks, attns=None, sample=None) -> nn.Module:
    m = nn.Module()
    m.block = nn.ModuleList(blocks)
    m.attn = nn.ModuleList(attns or [])
    if sample is not None:
        setattr(m, sample[0], sample[1])
    return m


class Encoder(nn.Module):
    def __init__(self, cfg: DDConfig = DDConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.conv_in = Conv(cfg.in_channels, cfg.ch, dtype=dtype)
        self.down = nn.ModuleList()
        ch, res = cfg.ch, cfg.resolution
        for i, mult in enumerate(cfg.ch_mult):
            out = cfg.ch * mult
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, out, dtype=dtype))
                ch = out
                if res in cfg.attn_resolutions:
                    attns.append(AttnBlock(ch, dtype=dtype))
            last = i == len(cfg.ch_mult) - 1
            self.down.append(_level(blocks, attns, None if last else ("downsample", Downsample(ch, dtype))))
            if not last:
                res //= 2
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(ch, ch, dtype=dtype)
        self.mid.attn_1 = AttnBlock(ch, dtype=dtype)
        self.mid.block_2 = ResnetBlock(ch, ch, dtype=dtype)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv(ch, zc, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for level in self.down:
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    """``quant``: the int8 decoder (module docstring)."""

    def __init__(self, cfg: DDConfig = DDConfig(), dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        n = len(cfg.ch_mult)
        ch = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = Conv(cfg.z_channels, ch, dtype=dtype)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(ch, ch, dtype=dtype, quant=quant)
        self.mid.attn_1 = AttnBlock(ch, dtype=dtype)
        self.mid.block_2 = ResnetBlock(ch, ch, dtype=dtype, quant=quant)
        levels = [None] * n
        for i in reversed(range(n)):
            out = cfg.ch * cfg.ch_mult[i]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, out, dtype=dtype, quant=quant))
                ch = out
                if res in cfg.attn_resolutions:
                    attns.append(AttnBlock(ch, dtype=dtype))
            levels[i] = _level(blocks, attns, ("upsample", Upsample(ch, dtype, quant)) if i else None)
            if i:
                res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv(ch, cfg.out_ch, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.to(self.dtype))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class DiagonalGaussian:
    """The VAE posterior, NHWC (split along the last axis).  ``sample`` takes
    the noise explicitly: the reference re-seeds its RNG on every call, and
    the JAX package draws from a fixed key that torch cannot reproduce, so
    callers inject the noise they want (a test feeds JAX's draw)."""

    def __init__(self, parameters: torch.Tensor):
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        return self.mean + self.std * noise


class AutoencoderKL(nn.Module):
    """``quant_decoder``: the int8 decoder (module docstring)."""

    def __init__(self, ddconfig: DDConfig = DDConfig(), embed_dim: int = 4, dtype=torch.float32,
                 quant_decoder: bool = False):
        super().__init__()
        self.ddconfig, self.embed_dim, self.quant_decoder = ddconfig, embed_dim, quant_decoder
        self.encoder = Encoder(ddconfig, dtype=dtype)
        self.decoder = Decoder(ddconfig, dtype=dtype, quant=quant_decoder)
        mult = 2 if ddconfig.double_z else 1
        self.quant_conv = Conv(mult * ddconfig.z_channels, mult * embed_dim, k=1, dtype=dtype)
        self.post_quant_conv = Conv(embed_dim, ddconfig.z_channels, k=1, dtype=dtype)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
