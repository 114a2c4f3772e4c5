"""The native image layer: the data path's pixel work in C++
(``leftrefill_torch/csrc/host/*.cpp``), the port's counterpart of the
OpenCV and PIL calls of the JAX package's data path.

The sources are compiled at first use with the host C++ compiler (``$CXX``,
else ``c++`` or ``g++``), in one call, into
``leftrefill_torch/_build/<hash>/libleftrefill_image.so`` and loaded with
``ctypes.CDLL`` (``native_lib.Library``: the hash covers the sources, the
flags and the compiler; several processes can build at once), which releases
the GIL for every call: the loader's threads decode and resize in parallel.
A failed build raises with the compiler's output; nothing falls back to the
Python versions.

The Python/numpy versions in ``data/jpeg.py``, ``data/image_io.py`` and
``data/masks.py`` (the polyline raster) stay
as the plain versions, bit for bit the same: :func:`plain_image_ops` routes
the named operations to them (tests and profilers), the default on every
device is the native path.  Importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from leftrefill_torch import native_lib

SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
LIB_NAME = "libleftrefill_image.so"
# -ffp-contract=off: no multiply-add fused where the plain versions round twice
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

# the operations :func:`plain_image_ops` can route to their plain versions
NAMES = ("jpeg_entropy", "jpeg_idct", "jpeg_color", "resize", "dilate", "png_unfilter", "raster")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # data, n, start, out, seg_off, end -> segments
    "lr_jpeg_segments": ([_P, _L, _L, _P, _P, _P], _I),
    # data, seg_off, n_segs, ns, slot_info, coefs, tables, mcux, mcuy, interval, progressive, ss, se, ah, al
    "lr_jpeg_scan": ([_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I], _I),
    # coef, by, bx, quant, out
    "lr_jpeg_idct": ([_P, _I, _I, _P, _P], None),
    # plane, ph, pw, stride, fh, fv, out, height, width
    "lr_jpeg_upsample": ([_P, _I, _I, _L, _I, _I, _P, _I, _I], None),
    # y, cb, cr, n, out
    "lr_jpeg_ycc_rgb": ([_P, _P, _P, _L, _P], None),
    # src, h, w, bytes a pixel, dst, dh, dw
    "lr_resize_nearest": ([_P, _I, _I, _L, _P, _I, _I], None),
    # src, h, w, c, sx, sy, dst
    "lr_area_fast_u8": ([_P, _I, _I, _I, _I, _I, _P], None),
    "lr_area_fast_f32": ([_P, _I, _I, _I, _I, _I, _P], None),
    # src, h, w, c, dst, dh, dw
    "lr_area_u8": ([_P, _I, _I, _I, _P, _I, _I], None),
    "lr_area_f32": ([_P, _I, _I, _I, _P, _I, _I], None),
    # src, h, w, c, dst, dh, dw, area
    "lr_linear_u8": ([_P, _I, _I, _I, _P, _I, _I, _I], None),
    "lr_linear_f32": ([_P, _I, _I, _I, _P, _I, _I, _I], None),
    # img, h, w, runs, kh, kw, out
    "lr_dilate_u8": ([_P, _I, _I, _P, _I, _I, _P], None),
    "lr_dilate_f32": ([_P, _I, _I, _P, _I, _I, _P], None),
    # raw, h, stride, bpp, out -> -1 or the first row of an unknown filter type
    "lr_png_unfilter": ([_P, _I, _L, _I, _P], _I),
    # pts, n, width, canvas, out -> 0, or an error code of _RASTER_ERRORS
    "lr_polyline_mask": ([_P, _I, _I, _I, _P], _I),
    # x0, y0, x1, y1, h, w, out -> 0, or an error code
    "lr_ellipse": ([_L, _L, _L, _L, _I, _I, _P], _I),
}


def _sources() -> list[Path]:
    return sorted(SRC.glob("*.cpp"))


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on the path."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, c++ or g++): the native image layer cannot be built")
    return cxx


LIBRARY = native_lib.Library(
    LIB_NAME, _sources, compiler, CXX_FLAGS,
    lambda cxx, sources, work, target: [[[cxx, *CXX_FLAGS, "-o", str(target), *map(str, sources)]]], _SIGNATURES)
library_path, library = LIBRARY.path, LIBRARY.load

_ROUTER = native_lib.Router(NAMES, "image operations")


def active(name: str) -> bool:
    """Whether operation ``name`` takes the native path."""
    return not _ROUTER.is_plain(name)


def plain_image_ops(names=NAMES):
    """Route the operations ``names`` (default: all) to their plain Python /
    numpy versions, in every thread, while the context is open: how tests and
    profilers reach the plain versions.  The data path never enters it."""
    return _ROUTER.plain(names)


# ---------------------------------------------------------------------------
# wrappers: argument checks in Python, outputs allocated here

def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _c_array(a: np.ndarray, dtype) -> np.ndarray:
    if a.dtype != dtype:
        raise ValueError(f"expected {np.dtype(dtype)}, got {a.dtype}")
    return np.ascontiguousarray(a)


_SCAN_ERRORS = {
    1: "JPEG: corrupt data (a bad Huffman code)",
    2: "JPEG: corrupt data (a coefficient past the block)",
    3: "JPEG: fewer restart intervals than the scan needs",
    4: "JPEG: corrupt data (the scan runs past its data)",
}


def jpeg_segments(data: bytes, start: int) -> tuple[np.ndarray, np.ndarray, int]:
    """``jpeg._entropy_segments``: the scan's de-stuffed segments from
    ``start`` back to back, their offsets, and the offset of the marker that
    ends the scan."""
    src = np.frombuffer(data, np.uint8)
    room = max(len(data) - start, 0)
    out = np.empty(room + 1, np.uint8)
    off = np.empty(room // 2 + 2, np.int64)
    end = ctypes.c_int64()
    segs = library().lr_jpeg_segments(_ptr(src), len(data), start, _ptr(out), _ptr(off), ctypes.byref(end))
    return out, off[:segs + 1], end.value


def jpeg_scan(data: np.ndarray, off: np.ndarray, slots: list, coefs: list, tables: list, mcux: int, mcuy: int,
              interval: int, progressive: bool, ss: int, se: int, ah: int, al: int) -> None:
    """One scan's Huffman decode into ``coefs`` (each a C-contiguous int16
    [bh, bw, 64] array, written in place) from ``jpeg_segments``' data and
    offsets.  ``slots``: (h, v, bw, bx, by) of each component of the scan;
    ``tables``: its (DC, AC) tables as (counts, symbols) or None;
    ``interval``: blocks a restart interval (0: none)."""
    data, off = _c_array(data, np.uint8), _c_array(off, np.int64)
    info = np.asarray(slots, np.int32).reshape(len(slots), 5)
    spec = np.zeros((len(slots), 2, 272), np.uint8)
    for k, pair in enumerate(tables):
        for j, table in enumerate(pair):
            if table is not None:
                counts, symbols = table
                spec[k, j, :16] = counts
                spec[k, j, 16:16 + len(symbols)] = symbols
    for c in coefs:
        if c.dtype != np.int16 or not c.flags.c_contiguous:
            raise ValueError("the coefficients must be C-contiguous int16")
    ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
    code = library().lr_jpeg_scan(_ptr(data), _ptr(off), len(off) - 1, len(slots), _ptr(info), ptrs, _ptr(spec),
                                  mcux, mcuy, interval, int(progressive), ss, se, ah, al)
    if code:
        raise ValueError(_SCAN_ERRORS[code])


def jpeg_idct(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[by, bx, 64] int16 coefficients and their table (natural order) ->
    the [by * 8, bx * 8] uint8 plane."""
    coef = _c_array(coef, np.int16)
    quant = np.ascontiguousarray(quant, np.int64)
    by, bx = coef.shape[:2]
    out = np.empty((by * 8, bx * 8), np.uint8)
    library().lr_jpeg_idct(_ptr(coef), by, bx, _ptr(quant), _ptr(out))
    return out


def jpeg_upsample(plane: np.ndarray, fh: int, fv: int, width: int, height: int) -> np.ndarray:
    """``jpeg.upsample``: a uint8 plane (rows may be strided) -> [height, width]."""
    if plane.dtype != np.uint8 or plane.strides[1] != 1:
        plane = np.ascontiguousarray(plane, np.uint8)
    ph, pw = plane.shape
    if height > ph * fv or width > pw * fh:
        raise ValueError(f"a {ph}x{pw} plane upsampled by ({fh}, {fv}) does not cover {height}x{width}")
    out = np.empty((height, width), np.uint8)
    library().lr_jpeg_upsample(_ptr(plane), ph, pw, plane.strides[0], fh, fv, _ptr(out), height, width)
    return out


def jpeg_ycc_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jpeg.ycc_to_rgb``: three [H, W] uint8 planes -> [H, W, 3]."""
    y, cb, cr = (_c_array(p, np.uint8) for p in (y, cb, cr))
    if not y.shape == cb.shape == cr.shape:
        raise ValueError(f"planes of shapes {y.shape}, {cb.shape}, {cr.shape}")
    out = np.empty(y.shape + (3,), np.uint8)
    library().lr_jpeg_ycc_rgb(_ptr(y), _ptr(cb), _ptr(cr), y.size, _ptr(out))
    return out


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """``image_io._unfilter``: the IDAT bytes (each row after its filter
    type) -> [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = library().lr_png_unfilter(_ptr(rows) if rows.size else 0, h, stride, bpp, _ptr(out))
    if bad >= 0:
        raise ValueError(f"unknown PNG filter type {rows[bad * (stride + 1)]}")
    return out


def _image(x: np.ndarray) -> tuple[np.ndarray, str]:
    """A C-contiguous [H, W, C] uint8 or float32 image and its suffix."""
    if x.ndim != 3 or x.dtype not in (np.uint8, np.float32):
        raise ValueError(f"expected a uint8 or float32 [H, W, C] image, got {x.dtype} {x.shape}")
    return np.ascontiguousarray(x), "u8" if x.dtype == np.uint8 else "f32"


def resize_nearest(x: np.ndarray, dw: int, dh: int) -> np.ndarray:
    x, _ = _image(x)
    h, w, c = x.shape
    out = np.empty((dh, dw, c), x.dtype)
    library().lr_resize_nearest(_ptr(x), h, w, c * x.itemsize, _ptr(out), dh, dw)
    return out


def area_fast(x: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """``image_io._area_fast``: the integer-ratio area average."""
    x, kind = _image(x)
    h, w, c = x.shape
    out = np.empty((h // sy, w // sx, c), x.dtype)
    getattr(library(), f"lr_area_fast_{kind}")(_ptr(x), h, w, c, sx, sy, _ptr(out))
    return out


def area(x: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``image_io._area``: the general area average (a shrink)."""
    x, kind = _image(x)
    h, w, c = x.shape
    out = np.empty((dh, dw, c), x.dtype)
    getattr(library(), f"lr_area_{kind}")(_ptr(x), h, w, c, _ptr(out), dh, dw)
    return out


def linear(x: np.ndarray, dw: int, dh: int, area: bool = False) -> np.ndarray:
    """``image_io._linear``: bilinear, or with ``area`` OpenCV's bilinear
    with area coefficients (an enlarging area resize)."""
    x, kind = _image(x)
    h, w, c = x.shape
    out = np.empty((dh, dw, c), x.dtype)
    getattr(library(), f"lr_linear_{kind}")(_ptr(x), h, w, c, _ptr(out), dh, dw, int(area))
    return out


def dilate(img: np.ndarray, runs: np.ndarray, kw: int) -> np.ndarray:
    """``image_io.dilate``: [H, W] uint8 or float32, the kernel as each row's
    run of columns ([kh, 2] int32: [j0, j1), empty where j1 <= j0)."""
    if img.ndim != 2 or img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"dilate takes [H, W] uint8 or float32 images, got {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    runs = np.ascontiguousarray(runs, np.int32)
    out = np.empty_like(img)
    fn = library().lr_dilate_u8 if img.dtype == np.uint8 else library().lr_dilate_f32
    fn(_ptr(img), img.shape[0], img.shape[1], _ptr(runs), runs.shape[0], kw, _ptr(out))
    return out


_RASTER_ERRORS = {
    1: "a vertex lies past +-2^24: the raster takes coordinates that float32 holds as integers",
    2: "the ellipse box is too large for the raster's int64 arithmetic",
    3: "an ellipse box's second corner comes before its first",
}


def polyline_mask(points: np.ndarray, width: int, canvas: int) -> np.ndarray:
    """``masks.draw_polyline_mask``'s raster: the closed polyline through
    ``points`` [N, 2] (x, y; cast to float32 as the plain version does),
    ``width`` wide, and its vertex ellipses, as 1 on a [canvas, canvas]
    uint8 zero mask."""
    if not 2 <= width < 2**31 or len(points) >= 2**31:
        raise ValueError(f"polyline of width {width} through {len(points)} vertices: out of the raster's range")
    pts = np.ascontiguousarray(np.asarray(points).reshape(-1, 2), dtype=np.float32)
    out = np.zeros((canvas, canvas), np.uint8)
    if len(pts):
        code = library().lr_polyline_mask(_ptr(pts), len(pts), width, canvas, _ptr(out))
        if code:
            raise ValueError(f"polyline of width {width}: {_RASTER_ERRORS[code]}")
    return out


def ellipse(mask: np.ndarray, box) -> None:
    """``masks._ellipse``: PIL's filled ellipse in the integer pixel box
    (x0, y0, x1, y1), both ends included, written into the C-contiguous
    [H, W] uint8 ``mask``.  The data path draws its ellipses inside
    :func:`polyline_mask`; this export exists for the tests, which hold
    every box width 1..140, square or not, against PIL."""
    if mask.ndim != 2 or mask.dtype != np.uint8 or not mask.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous [H, W] uint8 mask, got {mask.dtype} {mask.shape}")
    box = tuple(int(v) for v in box)
    if any(abs(v) >= 2**62 for v in box):
        raise ValueError(f"ellipse {box}: {_RASTER_ERRORS[2]}")
    code = library().lr_ellipse(*box, mask.shape[0], mask.shape[1], _ptr(mask))
    if code:
        raise ValueError(f"ellipse {box}: {_RASTER_ERRORS[code]}")
