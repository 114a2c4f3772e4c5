"""The novel-view-synthesis training mask (counterpart of the NVS parts of
``leftrefill_tpu/data/masks.py``): the object's dilated alpha mask united
with a thick random polyline inside its (enlarged) bounding box.  The JAX
package draws the polyline with PIL's ``ImageDraw`` and dilates with
OpenCV; the port rasterizes the same shapes itself (:func:`draw_polyline_mask`)
and dilates with ``image_io.dilate``.  Random draws come from a
``random.Random`` and an explicit ``np.random.RandomState`` (JAX's code
draws the latter's values from numpy's global stream), in JAX's order."""

from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np

from leftrefill_torch.data.image_io import dilate, ellipse_kernel


def _round_up(v: np.ndarray) -> np.ndarray:
    """PIL's ROUND_UP: to nearest, halves away from zero."""
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """PIL's ROUND_DOWN: to nearest, halves towards zero."""
    return (np.sign(v) * np.ceil(np.abs(v) - 0.5)).astype(np.int64)


def _fill_polygon(mask: np.ndarray, verts: np.ndarray) -> None:
    """Fill a convex polygon (integer vertices, in order) as PIL's scanline
    fill does for each row y: the row's crossings of the edges, from the
    leftmost rounded up to the rightmost rounded down (PIL's corner
    adjustments are left out)."""
    h, w = mask.shape
    x0, y0 = verts[:, 0].astype(np.float64), verts[:, 1].astype(np.float64)
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    ys = np.arange(max(int(y0.min()), 0), min(int(y0.max()), h - 1) + 1)
    if ys.size == 0:
        return
    flat = y0 == y1
    for xa, xb, y in zip(x0[flat], x1[flat], y0[flat]):  # horizontal edges: drawn as they are
        if 0 <= y < h:
            mask[int(y), max(int(min(xa, xb)), 0):max(min(int(max(xa, xb)) + 1, w), 0)] = 1
    ea, eb = ~flat, ~flat
    yy = ys[:, None].astype(np.float64)
    lo, hi = np.minimum(y0, y1), np.maximum(y0, y1)
    inside = (yy >= lo) & (yy <= hi) & ea & eb
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = x0 + (yy - y0) * (x1 - x0) / (y1 - y0)
    left = np.where(inside, xs, np.inf).min(axis=1)
    right = np.where(inside, xs, -np.inf).max(axis=1)
    ok = np.isfinite(left)
    cols = np.arange(w)
    start, end = _round_up(left[ok]), _round_down(right[ok])
    mask[ys[ok]] |= ((cols >= start[:, None]) & (cols <= end[:, None])).astype(mask.dtype)


def _wide_segment(mask: np.ndarray, p0, p1, width: int) -> None:
    """One segment of PIL's wide line: the quadrilateral its
    ``ImagingDrawWideLine`` builds from integer end points (a point where
    they coincide)."""
    (xa, ya), (xb, yb) = (int(v) for v in p0), (int(v) for v in p1)
    dx, dy = xb - xa, yb - ya
    if dx == 0 and dy == 0:
        if 0 <= ya < mask.shape[0] and 0 <= xa < mask.shape[1]:
            mask[ya, xa] = 1
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    r_max, r_min = float(_round_up(np.float64(small))) / big, float(_round_down(np.float64(small))) / big
    dxmin, dxmax = int(_round_down(np.float64(r_min * dy))), int(_round_down(np.float64(r_max * dy)))
    dymin, dymax = int(_round_down(np.float64(r_min * dx))), int(_round_down(np.float64(r_max * dx)))
    verts = np.array([[xa - dxmin, ya + dymax], [xb - dxmin, yb + dymax],
                      [xb + dxmax, yb - dymin], [xa + dxmax, ya - dymin]])
    _fill_polygon(mask, verts)


def _quarter_rows(a: int, b: int) -> dict[int, int]:
    """PIL's quarter-ellipse walk over doubled coordinates from (a, b % 2)
    to (a % 2, b), each step to whichever of up, up-left and left leaves
    the smallest |a^2 y^2 + b^2 x^2 - a^2 b^2|: per y, the largest x."""
    cx, cy = a, b % 2
    a2, b2 = a * a, b * b

    def miss(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)

    rows = {}
    while True:
        rows[cy] = max(rows.get(cy, -1), cx)
        if cx == a % 2 and cy == b:
            return rows
        nx, ny = cx, cy + 2
        best = miss(nx, ny)
        if nx > 1:
            for px, py in ((cx - 2, cy + 2), (cx - 2, cy)):
                m = miss(px, py)
                if best > m:
                    nx, ny, best = px, py, m
        cx, cy = nx, ny


def _ellipse(mask: np.ndarray, box) -> None:
    """PIL's filled ellipse in the pixel box [x0, x1] x [y0, y1] (both ends
    included; nothing for a one-pixel box): for each doubled row y of the
    quarter walk, rows y0 + (b +- y) / 2 filled from x0 + (a - x) / 2 to
    x0 + (a + x) / 2, a = x1 - x0 and b = y1 - y0."""
    x0, y0, x1, y1 = (int(v) for v in box)
    a, b = x1 - x0, y1 - y0
    if a <= 0 and b <= 0:
        return
    h, w = mask.shape
    for y, x in _quarter_rows(a, b).items():
        for row in {y0 + (b + y) // 2, y0 + (b - y) // 2}:
            if 0 <= row < h:
                mask[row, max(x0 + (a - x) // 2, 0):max(min(x0 + (a + x) // 2 + 1, w), 0)] = 1


def draw_polyline_mask(points: np.ndarray, size: int, width: int, canvas_size: int | None = None) -> np.ndarray:
    """A closed thick polyline through ``points`` [N, 2] (x, y) and a filled
    ellipse of the line's width at each vertex, as 1 on a float32
    [canvas, canvas] zero mask: what the JAX package paints with PIL's
    ``ImageDraw.line(width=...)`` and ``ellipse``.  Each segment is PIL's
    quadrilateral with its scanline rounding and each ellipse PIL's; the
    scanline fill's corner adjustments are not reproduced, so a few pixels
    at the stroke's edge may differ (``tests/test_torch_data.py`` bounds
    them)."""
    canvas = canvas_size or size
    mask = np.zeros((canvas, canvas), np.uint8)
    pts = np.append(points, points[:1], axis=0).astype(np.float32)
    for p0, p1 in zip(pts[:-1], pts[1:]):
        _wide_segment(mask, p0, p1, width)
    half = width // 2
    for x, y in pts:
        _ellipse(mask, (x - half, y - half, x + half, y + half))
    return mask.astype(np.float32)


def nvs_object_mask(
    object_mask: np.ndarray,
    img_size: int,
    dilate_size: Sequence[int] = (8, 20),
    pts_size: Sequence[int] = (15, 30),
    mask_enlarge: Sequence[float] = (0.0, 0.0),
    width_range: Sequence[int] = (60, 120),
    complete_mask_rate: float = 0.0,
    rng: random.Random | None = None,
    np_rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """The NVS training mask: with chance ``complete_mask_rate`` the whole
    view, else the object mask dilated by an ellipse of random size, united
    with a thick random polyline inside its (optionally enlarged) bounding
    box; the whole view where the object is empty.  ``rng`` and ``np_rng``
    give the draws that JAX's code takes from ``random`` and numpy's global
    stream, in the same order."""
    rng = rng or random
    np_rng = np_rng or np.random.mtrand._rand
    if rng.random() < complete_mask_rate:
        return np.ones((img_size, img_size), np.float32)
    kernel_size = rng.randint(dilate_size[0], dilate_size[1])
    mask = dilate(object_mask, ellipse_kernel(kernel_size))
    if mask.sum() == 0:
        return np.ones((img_size, img_size), np.float32)
    ys, xs = np.where(mask > 0)
    h_min, h_max = ys.min(), ys.max()
    w_min, w_max = xs.min(), xs.max()
    if mask_enlarge[1] > mask_enlarge[0]:
        enlarge = rng.random() * (mask_enlarge[1] - mask_enlarge[0]) + mask_enlarge[0]
        diff = max(h_max - h_min, w_max - w_min) * enlarge
        h_min = np.clip(h_min - diff, 0, img_size - 1)
        h_max = np.clip(h_max + diff, 0, img_size - 1)
        w_min = np.clip(w_min - diff, 0, img_size - 1)
        w_max = np.clip(w_max + diff, 0, img_size - 1)
    n = rng.randint(pts_size[0], pts_size[1])
    rx = np_rng.randint(w_min, max(w_max, w_min + 1), size=n)
    ry = np_rng.randint(h_min, max(h_max, h_min + 1), size=n)
    pts = np.stack([rx, ry], axis=1)
    min_w = width_range[0] * (img_size / 512)
    max_w = width_range[1] * (img_size / 512)
    width = int(np_rng.randint(min_w, max(max_w, min_w + 1)))
    irr = draw_polyline_mask(pts, img_size, width)
    return np.clip(mask + irr, 0, 1).astype(np.float32)
