"""The validation metrics (counterpart of ``leftrefill_tpu/eval/metrics.py``)
on torch tensors, NHWC: PSNR on [0, 1] images, SSIM on ITU-R 601-2 grey
maps with scikit-image's defaults (a 7x7 uniform window, K1 0.01, K2 0.03,
and the data range 2.0 that scikit-image takes for float images when none
is given, as the reference protocol does), and the two on the composited
target (right) half of a canvas."""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def psnr(pred01: torch.Tensor, target01: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-row PSNR over all non-batch dims; inputs in [0, 1]."""
    mse = ((pred01 - target01) ** 2).mean(dim=tuple(range(1, pred01.ndim)))
    return 10.0 * torch.log10(data_range**2 / mse.clamp_min(1e-12))


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 1] luma."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over every win x win window ('valid': no padding) of [B, H, W]."""
    kernel = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)
    return F.conv2d(x[:, None], kernel)[:, 0]


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """scikit-image's ``structural_similarity`` (uniform window, sample
    covariances) per row of [B, H, W] grey maps, in fp32 (fp64 inputs stay
    fp64)."""
    pred = pred.to(torch.float64 if pred.dtype == torch.float64 else torch.float32)
    target = target.to(pred.dtype)
    n = win_size * win_size
    cov_norm = n / (n - 1)
    ux, uy = _uniform_filter_valid(pred, win_size), _uniform_filter_valid(target, win_size)
    uxx = _uniform_filter_valid(pred * pred, win_size)
    uyy = _uniform_filter_valid(target * target, win_size)
    uxy = _uniform_filter_valid(pred * target, win_size)
    vx, vy, vxy = cov_norm * (uxx - ux * ux), cov_norm * (uyy - uy * uy), cov_norm * (uxy - ux * uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2))


def composite_metrics(pred: torch.Tensor, origin: torch.Tensor, mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """pred composited into the hole (mask 1) of origin, the right half kept
    when the canvas is wider than high, then PSNR on [0, 1] and SSIM on its
    grey map.  Inputs in [-1, 1], NHWC.  Returns {"psnr", "ssim",
    "composite"}."""
    comp = pred * mask + origin * (1 - mask)
    h, w = comp.shape[1:3]
    if w != h:
        comp, origin = comp[:, :, w // 2:], origin[:, :, w // 2:]
    p01, o01 = (comp + 1) / 2, (origin + 1) / 2
    return {"psnr": psnr(p01, o01),
            "ssim": ssim(rgb_to_grayscale(p01)[..., 0], rgb_to_grayscale(o01)[..., 0]),
            "composite": comp}
