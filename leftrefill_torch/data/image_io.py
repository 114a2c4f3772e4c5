"""Image files and the image operations of the data path, in numpy and the
standard library (``zlib``): the JAX package's data path calls OpenCV and
PIL for these, which the port does not depend on.

- :func:`read_png` / :func:`write_png`: 8-bit grey, RGB and RGBA PNG files,
  not interlaced, with the five scanline filters; channels in RGB(A) order
  (OpenCV reads BGR(A)).
- :func:`resize`: ``cv2.resize`` with ``INTER_LINEAR``, ``INTER_AREA`` and
  ``INTER_NEAREST`` on uint8 and float32 images, bit-equal to OpenCV's
  results: uint8 bilinear in OpenCV's fixed point (11-bit coefficients, the
  vertical pass's 16-bit products and their truncations), the vertical
  coefficients left unclamped at the borders as OpenCV leaves them, a
  2x-by-2x bilinear uint8 shrink as OpenCV's fast area average; the area
  average over its table of partial pixels (a shrink only).
- :func:`ellipse_kernel` / :func:`dilate`: ``getStructuringElement(MORPH_ELLIPSE, (k, k))``
  and ``cv2.dilate`` (one iteration, the anchor at the kernel's centre,
  nothing from outside the image).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

INTER_NEAREST, INTER_LINEAR, INTER_AREA = 0, 1, 3  # OpenCV's codes

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels (grey, RGB, RGBA)


# ---------------------------------------------------------------------------
# PNG

def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9): None, Sub, Up,
    Average and Paeth, with ``c`` bytes a pixel."""
    stride = w * c
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each channel along the row, mod 256
            cur = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each pixel needs its decoded left neighbour
            cur = np.zeros(stride, np.uint8)
            up = prior.astype(np.int16)
            left = np.zeros(c, np.int16)
            up_left = np.zeros(c, np.int16)
            for x in range(0, stride, c):
                b = up[x:x + c]
                if kind == 3:
                    pred = (left + b) >> 1
                else:
                    p = left + b - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, b, up_left))
                left = (line[x:x + c].astype(np.int16) + pred) & 0xFF
                cur[x:x + c] = left
                up_left = b
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = prior = cur
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    """An 8-bit grey ([H, W]), RGB ([H, W, 3]) or RGBA ([H, W, 4]) PNG file
    as uint8.  Anything else (other bit depths, palettes, grey + alpha,
    interlacing) raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit grey, RGB and RGBA PNGs without interlacing are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[colour])
    return img[..., 0] if colour == 0 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) image
    as a PNG file, every scanline unfiltered."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (1, 3, 4)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 1|3|4] images, got {img.dtype} {img.shape}")
    c = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    colour = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# resize

def _linear_taps(ssize: int, dsize: int, clamp: bool):
    """OpenCV's bilinear source index and fraction of each output index:
    fx = float32((d + 0.5) * scale - 0.5), its floor and the rest; with
    ``clamp`` (the horizontal pass) a fraction left of the first source
    pixel or right of the last is 0 there; the two source indices are
    clipped to the image either way."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= ssize - 1
        f[lo | hi] = 0
        s[lo], s[hi] = 0, ssize - 1
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), f


def _area_fast(img: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """OpenCV's integer-ratio area average: each output pixel the mean of
    its sx x sy block (the last partial block ignored, as the output size is
    the floor); for uint8 the integer sum times fp32 1 / (sx sy), rounded to
    nearest even, or (sum + 2) >> 2 for 2 x 2 blocks."""
    h, w = img.shape[0] // sy, img.shape[1] // sx
    block = img[: h * sy, : w * sx].reshape(h, sy, w, sx, -1)
    if img.dtype == np.uint8:
        n = sx * sy
        total = block.astype(np.int64).sum(axis=(1, 3))
        if (sx, sy) == (2, 2):  # OpenCV's vectorized 2x2 average
            return ((total + 2) >> 2).astype(np.uint8)
        return _saturate(total.astype(np.float32) * np.float32(1.0 / n), np.uint8)
    terms = [block[:, i, :, j] for i in range(sy) for j in range(sx)]  # the block in row-major order
    if (sx, sy) == (2, 2) and img.shape[2] in (1, 4):  # OpenCV's vectorized 2x2 average
        return ((terms[0] + terms[1]) + (terms[2] + terms[3])) * np.float32(0.25)
    out = np.zeros((h, w, img.shape[2]), np.float32)
    for k in range(0, len(terms) - 3, 4):  # four terms at a time, then the rest one by one
        out = out + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
    for k in range(len(terms) // 4 * 4, len(terms)):
        out = out + terms[k]
    return out * np.float32(1.0 / (sx * sy))


def _area_table(ssize: int, dsize: int):
    """OpenCV's ``computeResizeAreaTab``: for each output index the source
    indices it covers and their weights (float32), partial pixels of less
    than 1e-3 left out; as [dsize, k] index and weight arrays (zero weight
    pads)."""
    scale = ssize / dsize
    entries = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(int(np.floor(f2)), ssize - 1)
        s1 = min(int(np.ceil(f1)), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        entries.append(row)
    k = max(len(r) for r in entries)
    idx = np.zeros((dsize, k), np.int64)
    wgt = np.zeros((dsize, k), np.float32)
    for d, row in enumerate(entries):
        for j, (s, a) in enumerate(row):
            idx[d, j], wgt[d, j] = s, a
    return idx, wgt


def _area(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """OpenCV's general area average (a shrink): per output row, the
    covered source rows' horizontal sums (fp32, in table order) weighted and
    added in table order, rounded to uint8 at the end."""
    h, w, c = img.shape
    xi, xw = _area_table(w, dw)
    yi, yw = _area_table(h, dh)
    src = img.astype(np.float32)
    rows = np.zeros((h, dw, c), np.float32)
    for j in range(xi.shape[1]):
        rows += src[:, xi[:, j]] * xw[None, :, j, None]
    out = np.zeros((dh, dw, c), np.float32)
    for j in range(yi.shape[1]):
        out += rows[yi[:, j]] * yw[:, j, None, None]
    return _saturate(out, img.dtype)


def _saturate(x: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint8:
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return x.astype(dtype)


def resize(img: np.ndarray, size: tuple[int, int], interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=...)``: ``size`` is (width,
    height); img is uint8 or float32, [H, W] or [H, W, C]."""
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize takes uint8 or float32 images, got {img.dtype}")
    dw, dh = size
    two_d = img.ndim == 2
    x = img[..., None] if two_d else img
    h, w = x.shape[:2]
    if (dw, dh) == (w, h):
        out = x.copy()
    elif interpolation == INTER_NEAREST:
        sx = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
        sy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
        out = x[sy][:, sx]
    elif interpolation in (INTER_LINEAR, INTER_AREA):
        scale_x, scale_y = 1.0 / (dw / w), 1.0 / (dh / h)
        ix, iy = int(round(scale_x)), int(round(scale_y))
        fast = abs(scale_x - ix) < np.finfo(np.float64).eps and abs(scale_y - iy) < np.finfo(np.float64).eps
        if interpolation == INTER_LINEAR and fast and ix == iy == 2 and x.dtype == np.uint8:
            interpolation = INTER_AREA
        if interpolation == INTER_AREA:
            if scale_x < 1 or scale_y < 1:
                raise NotImplementedError("INTER_AREA enlarging (OpenCV's bilinear emulation) is not implemented")
            out = _area_fast(x, ix, iy) if fast else _area(x, dw, dh)
        else:
            out = _linear(x, dw, dh)
    else:
        raise ValueError(f"unsupported interpolation {interpolation}")
    return out[..., 0] if two_d else out


def _linear(x: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w = x.shape[:2]
    sx0, sx1, fx = _linear_taps(w, dw, clamp=True)
    sy0, sy1, fy = _linear_taps(h, dh, clamp=False)
    if x.dtype == np.uint8:
        one = np.float32(2048)  # 11-bit coefficients, each rounded on its own
        ax0, ax1 = (np.rint(v * one).astype(np.int64) for v in (np.float32(1) - fx, fx))
        by0, by1 = (np.rint(v * one).astype(np.int64)[:, None, None] for v in (np.float32(1) - fy, fy))
        src = x.astype(np.int64)
        rows = src[:, sx0] * ax0[None, :, None] + src[:, sx1] * ax1[None, :, None]
        # the vertical pass in 16-bit lanes: each row >> 4, times its
        # coefficient, the high 16 bits kept, the two added and rounded >> 2
        out = (((rows[sy0] >> 4) * by0 >> 16) + ((rows[sy1] >> 4) * by1 >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = x.astype(np.float32)
    a0, a1 = (np.float32(1) - fx)[None, :, None], fx[None, :, None]
    rows = src[:, sx0] * a0 + src[:, sx1] * a1
    b0, b1 = (np.float32(1) - fy)[:, None, None], fy[:, None, None]
    return (rows[sy0] * b0 + rows[sy1] * b1).astype(np.float32)


# ---------------------------------------------------------------------------
# morphology

def ellipse_kernel(k: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))``: uint8 [k, k]."""
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, kernel)``: each output pixel the largest input
    under the kernel placed with its centre (k // 2, k // 2) on it; pixels
    outside the image take no part.  [H, W] uint8 or float32."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape
    low = np.zeros((), img.dtype) if img.dtype == np.uint8 else np.array(-np.inf, img.dtype)
    pad = np.full((h + kh - 1, w + kw - 1), low, img.dtype)
    pad[ay:ay + h, ax:ax + w] = img
    out = np.full((h, w), low, img.dtype)
    for i in range(kh):
        cols = np.nonzero(kernel[i])[0]
        if cols.size == 0:
            continue
        j0, j1 = int(cols[0]), int(cols[-1]) + 1
        if not kernel[i, j0:j1].all():
            raise ValueError("dilate takes kernels whose rows are one run each (the ellipse)")
        band = pad[i:i + h]
        runs = np.lib.stride_tricks.sliding_window_view(band, j1 - j0, axis=1)[:, j0:j0 + w]
        np.maximum(out, runs.max(axis=-1), out=out)
    return out
