"""What the benchmark draws from ``--seed``: the weights (by the fill rule
of the program's ``pipeline.fill_random_``, on the device, in one draw of
the served type), photos, brush-stroke masks, and the seeds of the
samplers.  Every draw has a generator of its own, seeded from the run's seed
and a tag, so adding a draw moves none of the others."""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw ``tag`` of the run seeded ``seed``."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(subseed(seed, tag))


def draw_weights(shapes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{key: tensor} of ``shapes``, one normal draw of ``dtype`` cut into the
    keys in their order: embedding tables 0.02 N, matrices and conv kernels
    N / sqrt(fan-in), norm scales 1 + 0.1 N, biases 0.02 N."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device, dtype=dtype)
    views = [v.view(shapes[n]) for n, v in zip(names, flat.split(sizes))]
    scales, ones = [], []
    for n, v in zip(names, views):
        if "embedding" in n:
            scales.append(0.02)
        elif v.ndim >= 2:
            scales.append(1.0 / math.sqrt(math.prod(v.shape[1:])))
        elif n.endswith("weight"):
            scales.append(0.1)
            ones.append(v)
        else:
            scales.append(0.02)
    torch._foreach_mul_(views, scales)
    if ones:
        torch._foreach_add_(ones, 1.0)
    return dict(zip(names, views))


def photos(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """[n, h, w, 3] in [-1, 1]: smooth colour fields (a 1/16-scale normal
    draw, bilinearly enlarged) with fine grain, each stretched to the range."""
    coarse = torch.randn((n, 3, max(h // 16, 2), max(w // 16, 2)), generator=gen, device=device)
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 0.15 * torch.randn((n, 3, h, w), generator=gen, device=device)
    lo, hi = x.amin(dim=(1, 2, 3), keepdim=True), x.amax(dim=(1, 2, 3), keepdim=True)
    return (2 * (x - lo) / (hi - lo) - 1).permute(0, 2, 3, 1).contiguous()


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    return ((x + 1) * 127.5).round().clamp(0, 255).to(torch.uint8)


def brush_mask(gen: torch.Generator, size: int, cover: tuple, device, strokes: int = 16) -> torch.Tensor:
    """[size, size] float32, 1 in the hole: thick random polylines (6
    segments each, widths 1/24 to 1/10 of the side) added until the hole
    covers a share drawn from ``cover`` (lo, hi - 0.06: a stroke adds at
    most about 0.06)."""
    lo, hi = cover
    target = lo + (hi - 0.06 - lo) * torch.rand((), generator=gen, device=device)
    seg = 6
    start = torch.rand((strokes, 1, 2), generator=gen, device=device) * size
    steps = (torch.rand((strokes, seg, 2), generator=gen, device=device) - 0.5) * (size / 3)
    pts = torch.cat([start, start + steps.cumsum(dim=1)], dim=1).clamp(0, size - 1)  # [S, seg + 1, 2]
    width = size * (1 / 24 + (1 / 10 - 1 / 24) * torch.rand((strokes, 1), generator=gen, device=device))
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32), indexing="ij")
    grid = torch.stack([xx.flatten(), yy.flatten()], dim=-1)  # [P, 2]
    a, b = pts[:, :-1], pts[:, 1:]  # [S, seg, 2]
    ab = b - a
    rel = grid[None, None] - a[:, :, None]  # [S, seg, P, 2]
    t = ((rel * ab[:, :, None]).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-6)[:, :, None]).clamp(0, 1)
    dist = (rel - t[..., None] * ab[:, :, None]).norm(dim=-1).amin(dim=1)  # [S, P]
    hit = (dist <= width / 2).to(torch.float32).cummax(dim=0).values  # union of the first k strokes
    share = hit.mean(dim=1)
    k = int(torch.searchsorted(share, target.reshape(1)).clamp(max=strokes - 1))
    return hit[k].reshape(size, size)


def pick(seed: int, tag: str, n: int) -> int:
    """An index below ``n`` drawn from the run's seed (which finished unit
    the check reads)."""
    return subseed(seed, tag) % n
