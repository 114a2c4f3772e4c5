"""Image files and the image operations of the data path, in the native
image layer and, as its plain versions, numpy and the standard library
(``zlib``): the JAX package's data path calls OpenCV and PIL for these,
which the port does not depend on.

- :func:`imread`: ``cv2.imread`` with ``IMREAD_COLOR`` (as RGB),
  ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED`` for PNG and JPEG files,
  the Exif orientation applied as OpenCV applies it; the JPEG decoding is
  ``data/jpeg.py``'s (libjpeg-turbo's pixels, bit for bit).
- :func:`read_png` / :func:`write_png`: PNG files of every colour type and
  bit depth (palettes expanded, 1-4-bit grey scaled, 16-bit kept as
  uint16), not interlaced, as OpenCV's unchanged read gives them; channels
  in RGB(A) order (OpenCV reads BGR(A)).  The writer writes 8-bit grey, RGB
  and RGBA.
- :func:`resize`: ``cv2.resize`` with ``INTER_LINEAR``, ``INTER_AREA`` and
  ``INTER_NEAREST`` on uint8 and float32 images, bit-equal to OpenCV's
  own code (float32 bilinear: OpenCV hands it to Intel IPP where it has
  it, whose CPU-dispatched arithmetic lands within 1e-5 of the largest
  value): uint8
  bilinear in OpenCV's fixed point (11-bit coefficients, the vertical
  pass's 16-bit products and their truncations), the vertical coefficients
  left unclamped at the borders as OpenCV leaves them, a 2x-by-2x bilinear
  uint8 shrink as OpenCV's fast area average; the area average over its
  table of partial pixels when shrinking, and when enlarging OpenCV's
  bilinear with area coefficients.
- :func:`ellipse_kernel` / :func:`dilate`: ``getStructuringElement(MORPH_ELLIPSE, (k, k))``
  and ``cv2.dilate`` (one iteration, the anchor at the kernel's centre,
  nothing from outside the image).

The pixel work (the JPEG decode, the PNG scanline filters, the resizes and
the dilation) runs in the native image layer (``data.native``, C++ with the
GIL released) unless ``native.plain_image_ops`` routes it to the numpy
versions below, which compute the same bits.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from leftrefill_torch.data import native
from leftrefill_torch.data.jpeg import exif_orientation, read_jpeg

INTER_NEAREST, INTER_LINEAR, INTER_AREA = 0, 1, 3  # OpenCV's codes

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel (grey, RGB, palette, grey+alpha, RGBA)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1  # OpenCV's codes
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) as OpenCV calls it: 15-bit coefficients
_GREY_RC, _GREY_GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GREY_BC = 32768 - _GREY_RC - _GREY_GC


# ---------------------------------------------------------------------------
# PNG

def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9): None, Sub, Up,
    Average and Paeth, over rows of ``stride`` bytes with ``bpp`` bytes a
    pixel (1 for bit depths below 8)."""
    if native.active("png_unfilter"):
        return native.png_unfilter(raw, h, stride, bpp)
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    c, w = bpp, stride // bpp
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each byte lane along the row, mod 256
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
    return out


def _png_chunks(data: bytes, path: str):
    """(IHDR fields, the IDAT data, PLTE, tRNS, eXIf) of a PNG file's bytes."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat, extra = 8, None, [], {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"PLTE", b"tRNS", b"eXIf"):
            extra[kind] = body
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    return header, b"".join(idat), extra


def _png_samples(data: bytes, path: str) -> tuple[np.ndarray, int, int, dict]:
    """The PNG's samples as stored: [H, W, samples a pixel], uint8 (palette
    indices, grey of 1-8 bits unscaled) or uint16; its colour type, bit
    depth and PLTE / tRNS / eXIf chunks."""
    (w, h, depth, colour, _, _, interlace), idat, extra = _png_chunks(data, path)
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"{path}: colour type {colour} at bit depth {depth} is no PNG")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    n = _CHANNELS[colour]
    stride = (w * n * depth + 7) // 8
    rows = _unfilter(zlib.decompress(idat), h, stride, max(1, n * depth // 8))
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(h, w, n)
    elif depth == 8:
        samples = rows.reshape(h, w, n)
    else:  # 1, 2 or 4 bits: unpack, the first sample in the high bits
        bits = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // depth, depth)
        vals = (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
        samples = vals[:, :w, None]
    return samples, colour, depth, extra


def read_png(path: str) -> np.ndarray:
    """A PNG file as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` gives it,
    channels in RGB(A) order: grey [H, W] (1, 2 and 4 bits scaled to 8, as
    libpng's ``expand_gray_1_2_4_to_8``), RGB [H, W, 3], RGBA [H, W, 4],
    grey + alpha as RGBA with the grey repeated, a palette expanded to RGB
    (RGBA where a tRNS chunk gives alpha), an RGB tRNS colour as alpha 0
    (RGBA); 16-bit files as uint16, the rest uint8.  Interlaced files
    raise."""
    with open(path, "rb") as f:
        return _png_decode(f.read(), path)[0]


def _png_decode(data: bytes, path: str) -> tuple[np.ndarray, int]:
    """(``read_png``'s image, the eXIf orientation)."""
    samples, colour, depth, extra = _png_samples(data, path)
    if colour == 3:
        plte = np.frombuffer(extra.get(b"PLTE", b""), np.uint8).reshape(-1, 3)
        if plte.size == 0:
            raise ValueError(f"{path}: a palette PNG without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)  # indices past the palette read as black, as libpng's
        lut[:len(plte)] = plte[:256]
        img = lut[samples[..., 0]]
        if b"tRNS" in extra:
            alpha = np.full(256, 255, np.uint8)
            trns = np.frombuffer(extra[b"tRNS"], np.uint8)[:256]
            alpha[:len(trns)] = trns
            img = np.concatenate([img, alpha[samples[..., 0]][..., None]], axis=2)
    elif colour == 0:
        img = samples[..., 0]
        if depth < 8:
            img = (img * (255 // (2**depth - 1))).astype(np.uint8)
    elif colour == 4:
        g, a = samples[..., 0], samples[..., 1]
        img = np.stack([g, g, g, a], axis=-1)
    elif colour == 2 and b"tRNS" in extra:
        key = np.array(struct.unpack(">3H", extra[b"tRNS"][:6]), samples.dtype)
        full = np.iinfo(samples.dtype).max
        alpha = np.where((samples == key).all(axis=-1), 0, full).astype(samples.dtype)
        img = np.concatenate([samples, alpha[..., None]], axis=2)
    else:
        img = samples
    orientation = exif_orientation(extra[b"eXIf"]) if b"eXIf" in extra else 1
    return np.ascontiguousarray(img), orientation


def _png_for_flags(data: bytes, path: str, flags: int) -> tuple[np.ndarray, int]:
    """A PNG as ``cv2.imread`` with ``flags`` gives it (RGB order): the
    colour read drops alpha, repeats grey and keeps 16-bit samples' high
    byte; the grey read is libpng's ``rgb_to_gray`` (15-bit coefficients,
    truncated at 8 bits, rounded at 16) of the RGB, then the high byte."""
    img, orientation = _png_decode(data, path)
    if flags == IMREAD_UNCHANGED:
        return img, orientation
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    if flags == IMREAD_GRAYSCALE and img.ndim == 3:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        half = 16384 if img.dtype == np.uint16 else 0  # libpng rounds its 16-bit sum, truncates its 8-bit one
        grey = (_GREY_RC * r + _GREY_GC * g + _GREY_BC * b + half) >> 15
        img = np.where((r == g) & (r == b), r, grey).astype(img.dtype)
    elif flags == IMREAD_COLOR and img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return img, orientation


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: the Exif Orientation tag's flips and
    transposes (1 or an unknown value: the image as stored)."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1), slice(None, None, -1)),
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1), slice(None, None, -1)), 8: (slice(None, None, -1),)}.get(orientation)
    return np.ascontiguousarray(img[flip] if flip else img)


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread(path, flags)`` for PNG and JPEG files (told apart by
    their first bytes), colour channels in RGB(A) order where OpenCV gives
    BGR(A):

    - ``IMREAD_COLOR``: [H, W, 3] uint8 RGB;
    - ``IMREAD_GRAYSCALE``: [H, W] uint8: a colour JPEG's Y plane as libjpeg
      decodes it (not a grey of its RGB), a colour PNG through libpng's
      ``rgb_to_gray``;
    - ``IMREAD_UNCHANGED``: the file's own channels (``read_png``; a JPEG's
      RGB or grey), no orientation applied.

    The colour and grey reads apply the Exif orientation (a JPEG's APP1, a
    PNG's eXIf chunk), as OpenCV does by default.  A file that is neither,
    or that the readers refuse, raises (where OpenCV returns None)."""
    if flags not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR):
        raise ValueError(f"imread takes IMREAD_UNCHANGED, IMREAD_GRAYSCALE or IMREAD_COLOR, got {flags}")
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        img, orientation = _png_for_flags(data, path, flags)
    elif data[:3] == b"\xff\xd8\xff":
        img, orientation = read_jpeg(data, grey=flags == IMREAD_GRAYSCALE)
        if flags == IMREAD_COLOR and img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
    else:
        raise ValueError(f"{path} is neither a PNG nor a JPEG file")
    return img if flags == IMREAD_UNCHANGED else apply_orientation(img, orientation)


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
    if min(dw, dh, w, h) <= 0:
        raise ValueError(f"resize takes non-empty images and sizes, got {img.shape} -> {size}")
    use_native = native.active("resize")
    if (dw, dh) == (w, h):
        out = x.copy()
    elif interpolation == INTER_NEAREST and use_native:
        out = native.resize_nearest(x, dw, dh)
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
        if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
            if fast:
                out = (native.area_fast if use_native else _area_fast)(x, ix, iy)
            else:
                out = (native.area if use_native else _area)(x, dw, dh)
        else:  # bilinear, or an area resize that enlarges: OpenCV's bilinear with area coefficients
            out = (native.linear if use_native else _linear)(x, dw, dh, area=interpolation == INTER_AREA)
    else:
        raise ValueError(f"unsupported interpolation {interpolation}")
    return out[..., 0] if two_d else out


def _area_taps(ssize: int, dsize: int, clamp: bool):
    """OpenCV's bilinear emulation of an enlarging area resize: source index
    floor(d * scale) and fraction float32((d + 1) - (s + 1) / scale), 0
    where that is not positive and its fractional part otherwise; with
    ``clamp`` (the horizontal pass) a fraction at or past the last source
    pixel is 0 there."""
    inv = dsize / ssize
    scale = 1.0 / inv
    d = np.arange(dsize)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    if clamp:
        hi = s >= ssize - 1
        f[hi], s[hi] = 0, ssize - 1
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), f


def _linear(x: np.ndarray, dw: int, dh: int, area: bool = False) -> np.ndarray:
    h, w = x.shape[:2]
    taps = _area_taps if area else _linear_taps
    sx0, sx1, fx = taps(w, dw, clamp=True)
    sy0, sy1, fy = taps(h, dh, clamp=False)
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
    runs = np.zeros((kh, 2), np.int32)
    for i in range(kh):
        cols = np.nonzero(kernel[i])[0]
        if cols.size:
            runs[i] = cols[0], cols[-1] + 1
            if not kernel[i, cols[0]:cols[-1] + 1].all():
                raise ValueError("dilate takes kernels whose rows are one run each (the ellipse)")
    if native.active("dilate"):
        return native.dilate(img, runs, kw)
    ay, ax = kh // 2, kw // 2
    h, w = img.shape
    low = np.zeros((), img.dtype) if img.dtype == np.uint8 else np.array(-np.inf, img.dtype)
    pad = np.full((h + kh - 1, w + kw - 1), low, img.dtype)
    pad[ay:ay + h, ax:ax + w] = img
    out = np.full((h, w), low, img.dtype)
    for i, (j0, j1) in enumerate(runs.tolist()):
        if j1 <= j0:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(pad[i:i + h], j1 - j0, axis=1)[:, j0:j0 + w]
        np.maximum(out, windows.max(axis=-1), out=out)
    return out
