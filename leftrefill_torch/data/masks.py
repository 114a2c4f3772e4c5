"""The training masks (counterpart of ``leftrefill_tpu/data/masks.py``):
mask files read grey and thresholded (``load_mask_file``), the mask-file
sampler of the MegaDepth and single-image datasets (``FileMaskSampler``:
irregular, segmentation or their union, placed on one side of the canvas;
``random_stroke_mask`` without mask lists), the match-based mask of
reference-guided inpainting (``match_based_mask``: a thick polyline through
confident matcher keypoints), and the novel-view-synthesis mask
(``nvs_object_mask``: the object's dilated alpha mask united with a thick
random polyline inside its bounding box).  The JAX package reads and
resizes with OpenCV, draws the polylines with PIL's ``ImageDraw`` and
dilates with OpenCV; the port reads and resizes with ``data.image_io``,
rasterizes the same shapes itself (:func:`draw_polyline_mask`, PIL's pixels:
in C++ through ``data.native``, whose plain version is the Python here) and
dilates with ``image_io.dilate``.  Random draws come from a
``random.Random`` and an explicit ``np.random.RandomState`` (JAX's code
draws the latter's values from numpy's global stream), in JAX's order."""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np

from leftrefill_torch.data import native
from leftrefill_torch.data.image_io import IMREAD_GRAYSCALE, INTER_NEAREST, dilate, ellipse_kernel, imread, resize


def _round_up(v: np.ndarray) -> np.ndarray:
    """PIL's ROUND_UP: to nearest, halves away from zero."""
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """PIL's ROUND_DOWN: to nearest, halves towards zero."""
    return (np.sign(v) * np.ceil(np.abs(v) - 0.5)).astype(np.int64)


def _fill_polygon(mask: np.ndarray, verts: np.ndarray) -> None:
    """Fill a polygon (integer vertices, in order) as PIL's scanline fill
    does: horizontal edges drawn as they are; for each row y, every other
    edge that spans it gives a crossing x0 + (y - y0) * dx in float32 (dx
    the edge's float32 slope, (x0, y0) its first vertex), an edge that
    ends on y before the last row gives it twice; the row's
    crossings sorted and filled pairwise, from the first of a pair rounded
    up to the second rounded down (the halves of PIL's rounding added in
    float32 too)."""
    h, w = mask.shape
    x0, y0 = verts[:, 0].astype(np.int64), verts[:, 1].astype(np.int64)
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    lo, hi = np.minimum(y0, y1), np.maximum(y0, y1)
    for xa, xb, y in zip(x0[y0 == y1], x1[y0 == y1], y0[y0 == y1]):
        if 0 <= y < h:
            mask[y, max(min(xa, xb), 0):max(min(max(xa, xb) + 1, w), 0)] = 1
    ys = np.arange(max(int(lo.min()), 0), min(int(hi.max()), h) + 1)
    sloped = y0 != y1
    if ys.size == 0 or not sloped.any():
        return
    x0, y0, lo, hi = x0[sloped], y0[sloped], lo[sloped], hi[sloped]
    dx = (x1[sloped] - x0).astype(np.float32) / (y1[sloped] - y0).astype(np.float32)
    yy = ys[:, None]
    xs = (yy - y0).astype(np.float32) * dx + x0.astype(np.float32)
    inside = (yy >= lo) & (yy <= hi)
    twice = inside & (yy == hi) & (yy < ys[-1])  # PIL's last row: the polygon's, clipped to the image
    cross = np.sort(np.concatenate([np.where(inside, xs, np.inf), np.where(twice, xs, np.inf)], axis=1), axis=1)
    count = inside.sum(1) + twice.sum(1)
    cols = np.arange(w)
    rows = ys < h
    for i in range(1, cross.shape[1], 2):
        ok = rows & (count > i)
        if not ok.any():
            break
        start, end = _round_up(cross[ok, i - 1]), _round_down(cross[ok, i])
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
    ``ImageDraw.line(width=...)`` and ``ellipse``, pixel for pixel.  As in
    PIL, the coordinates are truncated to integers, each segment is PIL's
    quadrilateral filled by its float32 scanline rule and each ellipse
    PIL's.  Widths below 2 (PIL's one-pixel line, another algorithm) are
    refused.  The raster runs in C++ (``native.polyline_mask``) unless
    ``native.plain_image_ops`` routes "raster" to the Python below."""
    if width < 2:
        raise ValueError(f"width {width}: the polyline raster draws widths of 2 and more")
    canvas = canvas_size or size
    if native.active("raster"):
        return native.polyline_mask(points, width, canvas).astype(np.float32)
    mask = np.zeros((canvas, canvas), np.uint8)
    pts = np.append(points, points[:1], axis=0).astype(np.float32)
    for p0, p1 in zip(pts[:-1], pts[1:]):
        _wide_segment(mask, p0, p1, width)
    half = width // 2
    for x, y in pts:
        _ellipse(mask, (x - half, y - half, x + half, y + half))
    return mask.astype(np.float32)


def load_mask_file(path: str, img_size: int) -> np.ndarray:
    """A mask file read grey, resized to img_size x img_size (nearest),
    > 127 -> 1: float32 {0, 1}."""
    mask = resize(imread(path, IMREAD_GRAYSCALE), (img_size, img_size), INTER_NEAREST)
    return (mask > 127).astype(np.float32)


def random_stroke_mask(img_size: int, rng: Optional[random.Random] = None) -> np.ndarray:
    """The stand-in without mask lists: a closed polyline of 6 to 16
    random vertices, img_size / 12 to img_size / 5 wide."""
    rng = rng or random.Random()
    n_pts = rng.randint(6, 16)
    pts = np.stack(
        [
            np.asarray([rng.randint(0, img_size - 1) for _ in range(n_pts)]),
            np.asarray([rng.randint(0, img_size - 1) for _ in range(n_pts)]),
        ],
        axis=1,
    )
    width = rng.randint(img_size // 12, img_size // 5)
    return np.clip(draw_polyline_mask(pts, img_size, width), 0, 1)


class FileMaskSampler:
    """Training masks from the irregular (LaMa) and segmentation (COCO)
    mask lists: 40 % an irregular mask, 40 % a segmentation mask, 20 % the
    union of one of each (a missing list's share goes to the other);
    :func:`random_stroke_mask` when both lists are empty."""

    def __init__(self, irregular_list: Optional[Sequence[str]], segment_list: Optional[Sequence[str]],
                 img_size: int, rng: Optional[random.Random] = None):
        self.irregular = list(irregular_list or [])
        self.segment = list(segment_list or [])
        self.img_size = img_size
        self.rng = rng or random.Random()

    def _pick(self, pool: list) -> np.ndarray:
        return load_mask_file(pool[self.rng.randint(0, len(pool) - 1)], self.img_size)

    def sample_half(self) -> np.ndarray:
        """[img_size, img_size] mask of one view, {0, 1}."""
        if not self.irregular and not self.segment:
            return random_stroke_mask(self.img_size, self.rng)
        rdv = self.rng.random()
        if rdv < 0.4 and self.irregular:
            return self._pick(self.irregular)
        if rdv < 0.8 and self.segment:
            return self._pick(self.segment)
        if self.segment and self.irregular:
            m1 = self._pick(self.segment)
            m2 = self._pick(self.irregular)
            return np.clip(m1 + m2, 0, 1)
        return self._pick(self.segment or self.irregular)

    def sample_canvas(self) -> np.ndarray:
        """[img_size, 2 * img_size]: :meth:`sample_half` on a random side."""
        mask = self.sample_half()
        zero = np.zeros_like(mask)
        if self.rng.random() < 0.5:
            return np.concatenate([mask, zero], axis=1)
        return np.concatenate([zero, mask], axis=1)


def match_based_mask(
    match_result: dict,
    img_size: int,
    target_pos: str = "left",
    constant_place: bool = True,
    target_crop_info: Optional[dict] = None,
    source_crop_info: Optional[dict] = None,
    rng: Optional[random.Random] = None,
    place_on_canvas: bool = True,
    np_rng: Optional[np.random.RandomState] = None,
) -> Optional[np.ndarray]:
    """The match-based mask: the keypoints of the matches scoring above 0.8
    of the best (``match_result``: {"scores": [N], "mkpts0": [N, 2],
    "mkpts1": [N, 2]}, at the matcher's 832-pixel size) on the masked side
    (the target's unless ``constant_place`` is off and the draw picks the
    other), mapped to the 256-pixel mask (through the side's random crop
    where it has ``crop_info``, dropping points outside it), a random
    rectangle of 20-50 % of the mask's area over them (where their box is
    larger), then a closed polyline 35-70 pixels wide through up to 15-30 of
    them in random order, resized (nearest) to ``img_size`` and placed on
    its side of the canvas (``place_on_canvas``; else the one view's mask).
    None where fewer than 10 points remain, or their box has no area.
    ``rng`` and ``np_rng`` give the draws that JAX's code takes from
    ``random`` and numpy's global stream, in the same order."""
    rng = rng or random.Random()
    np_rng = np_rng or np.random.mtrand._rand
    min_width, max_width = 35, 70
    min_area_rate, max_area_rate = 0.2, 0.5
    num_vertex = rng.randint(15, 30)
    min_num = 10
    match_size, match_mask_size = 832, 256
    threshold_prob = 0.8

    scores = np.asarray(match_result["scores"])
    if scores.size == 0:
        return None
    scores_max = scores.max()
    rdv = 1.0 if constant_place else rng.random()
    if rdv < 0.5:
        mask_left = True
        mkpt = "mkpts0" if target_pos == "left" else "mkpts1"
        crop_info = target_crop_info if target_pos == "left" else source_crop_info
    else:
        mask_left = False
        mkpt = "mkpts1" if target_pos == "left" else "mkpts0"
        crop_info = source_crop_info if target_pos == "left" else target_crop_info

    good_pts = np.asarray(match_result[mkpt])[scores > scores_max * threshold_prob]
    if crop_info is None:
        good_pts = good_pts / match_size * match_mask_size
    else:
        good_pts = good_pts / match_size
        good_pts = good_pts.copy()
        good_pts[:, 0] *= crop_info["w"]
        good_pts[:, 1] *= crop_info["h"]
        good_pts[:, 0] -= crop_info["w_start"]
        good_pts[:, 1] -= crop_info["h_start"]
        ms = min(crop_info["w"], crop_info["h"]) / match_mask_size
        good_pts /= ms
        keep = ((good_pts[:, 0] >= 0) & (good_pts[:, 1] >= 0) & (good_pts[:, 0] < match_mask_size)
                & (good_pts[:, 1] < match_mask_size))
        good_pts = good_pts[keep]

    if len(good_pts) < min_num:
        return None

    x_min, x_max = good_pts[:, 0].min(), good_pts[:, 0].max()
    y_min, y_max = good_pts[:, 1].min(), good_pts[:, 1].max()
    good_w, good_h = x_max - x_min, y_max - y_min
    good_area = good_w * good_h
    if good_area == 0:
        return None

    rate = match_mask_size**2 * (min_area_rate + (max_area_rate - min_area_rate) * rng.random()) / good_area
    if rate < 1:
        a = good_w * math.sqrt(rate)
        b = good_h * math.sqrt(rate)
        x_start = x_min + np_rng.randint(0, int(good_w - a) + 1)
        y_start = y_min + np_rng.randint(0, int(good_h - b) + 1)
        sel = good_pts
        sel = sel[(sel[:, 0] > x_start) & (sel[:, 0] < x_start + a)]
        sel = sel[(sel[:, 1] > y_start) & (sel[:, 1] < y_start + b)]
        picked = np_rng.permutation(sel)
    else:
        picked = np_rng.permutation(good_pts)

    if picked.shape[0] < min_num:
        return None
    picked = picked[:num_vertex]
    width = np_rng.randint(min_width, max_width)
    mask = draw_polyline_mask(picked, match_mask_size, int(width))
    if img_size != match_mask_size:
        mask = resize(mask, (img_size, img_size), INTER_NEAREST)
    if not place_on_canvas:
        return mask
    zero = np.zeros_like(mask)
    if mask_left:
        return np.concatenate([mask, zero], axis=1)
    return np.concatenate([zero, mask], axis=1)


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
