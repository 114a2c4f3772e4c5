"""K2: 3x3 stride-1 pad-1 convolution, NHWC x OHWI, and its dispatcher.

Source note.  Replaces ``leftrefill_tpu/ops/conv.py:_conv_kernel`` (sum9 taps,
``_conv3x3_pallas`` / ``conv3x3_op``).  The kernel (``csrc/conv3x3.cu``) is an
implicit GEMM: M = B*H*W output pixels, N = Co, K = 9*Ci, accumulated in fp32,
bias added in fp32, one cast to bf16.  At the UNet's shapes K is
2880..23040, far above the H100's ~295 flop/byte ridge: the tensor cores
bound it, and at the 16x32 level (8 tiles of 128 pixels) so does filling
132 SMs.  Design (wgmma + TMA):
a block owns a 128-pixel patch of one image by 160, 128, 80 or 64 output
channels (the host's launch plan picks the width that fills the card in the
fewest waves: 80 at the 16x32 level), two consumer warpgroups run wgmma
from shared memory, and a producer warp walks K as (tap, 64-channel slice)
steps through a 4-stage TMA ring.  Each step's input tile is one TMA box
over x at the tap's shifted origin, and TMA zero-fills what lies outside the
image or past Ci, so the TPU kernel's padded copy and its three
column-shifted copies (which exist for VMEM blocking) are gone and Ci = 960
or 1920 needs no channel padding.  The weight is read as OHWI: the module's
OIHW weight is held in channels-last memory, so no per-call transpose is
needed.
The gradient, as JAX's custom VJP (``conv3x3_op``: the XLA conv's VJP), is
cuDNN's gradient of the plain convolution in x's dtype: the TPU package has
no backward kernel for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leftrefill_torch import kernels
from leftrefill_torch.ops.layers import conv2d_nhwc


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version at its precision: the bf16 operands
    convolved with fp32 accumulation, bias added in fp32, one cast.
    x [B, H, W, Ci], w OHWI [Co, 3, 3, Ci], bias [Co] -> [B, H, W, Co]."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(torch.float32),
        w.permute(0, 3, 1, 2).to(torch.float32),
        bias.to(torch.float32),
        padding=1,
    )
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, Ci] bf16, w OHWI [Co, 3, 3, Ci] bf16, bias [Co] fp32.
    A CPU tensor runs the plain version; a CUDA tensor launches K2 or raises."""
    if not x.is_cuda:
        return conv3x3_plain(x, w, bias)
    b, h, wd, ci = x.shape
    co = w.shape[0]
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(w, "w", torch.bfloat16, (co, 3, 3, ci))
    kernels.require(bias, "bias", torch.float32, (co,))
    if ci % 8 or co % 8:
        raise ValueError(f"conv kernel needs Ci and Co multiples of 8, got {ci}, {co}")
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        code = lib.lr_conv3x3(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, ci, co, kernels.stream_of(x),
        )
    kernels.check(code, "conv3x3")
    conv3x3_op.launches += 1
    return out


conv3x3_op.launches = 0


class _Conv3x3(torch.autograd.Function):
    """K2 forward (:func:`conv3x3_op`, the plain version on a CPU tensor);
    the backward is the convolution's gradient in x's dtype, for the inputs
    that need one (a frozen weight gets none)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return conv3x3_op(x, w, bias)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        g = grad.to(x.dtype).permute(0, 3, 1, 2)
        w_oihw = w.to(x.dtype).permute(0, 3, 1, 2)
        dx = dw = db = None
        if need_x:
            dx = torch.nn.grad.conv2d_input(x.permute(0, 3, 1, 2).shape, w_oihw, g, padding=1).permute(0, 2, 3, 1)
        if need_w:
            dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), w_oihw.shape, g, padding=1)
            dw = dw.permute(0, 2, 3, 1).to(w.dtype)
        if need_b:
            db = grad.to(torch.float32).sum(dim=(0, 1, 2))
        return dx, dw, db


def conv3x3_qualifies(x: torch.Tensor, co: int) -> bool:
    """The JAX dispatcher's rule (bf16, Ci and Co at least 64, H*W at least
    256) on a CUDA tensor, plus the kernel's 8-channel alignment."""
    _, h, w, ci = x.shape
    return (
        kernels.uses_kernel(x)
        and x.dtype == torch.bfloat16
        and ci >= 64
        and co >= 64
        and h * w >= 256
        and ci % 8 == 0
        and co % 8 == 0
    )


def conv3x3_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 conv of NHWC ``x`` (in its compute dtype) with a
    torch-layout OIHW ``weight``: K2 where the shape qualifies, the plain
    convolution in x's dtype otherwise.  The bias is rounded to x's dtype
    first, as the JAX call site casts it before the kernel.  A channels-last
    weight in x's dtype reaches the kernel without a copy.  Differentiable on
    every device (``_Conv3x3``)."""
    if conv3x3_qualifies(x, weight.shape[0]):
        kernels.note_site("conv3x3", (*x.shape, weight.shape[0]))
        w = weight.to(x.dtype).permute(0, 2, 3, 1).contiguous()
        fn = conv3x3_plain if kernels.plain_kernels_active("conv3x3") else _Conv3x3.apply
        return fn(x.contiguous(), w, bias.to(x.dtype).to(torch.float32).contiguous())
    return conv2d_nhwc(x, weight, bias)
