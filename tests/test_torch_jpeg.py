"""The port's image reader (``leftrefill_torch/data/jpeg.py`` and
``data/image_io.imread``) against ``cv2.imread`` (libjpeg-turbo, libpng) on
files the tests write with OpenCV or splice by hand, bit for bit:

- JPEG: baseline at 4:4:4, 4:2:2, 4:4:0, 4:2:0 and 4:1:1 and qualities
  30/75/95, progressive, restart intervals, optimized Huffman tables, a
  greyscale file, odd sizes (37x53, 17x9), the grey read of a colour file
  (its Y plane), every Exif orientation spliced into the bytes (and a PNG
  eXIf chunk), and the refusals (arithmetic coding, 12-bit samples, CMYK,
  a progressive file whose scans leave AC coefficients unrefined);
- PNG: palettes at 1, 2, 4 and 8 bits with and without tRNS, grey at 1, 2
  and 4 bits, 16-bit grey, RGB, grey + alpha and RGBA, an RGB tRNS colour,
  under each of the three read flags;
- ``resize`` with ``INTER_AREA`` enlarging, bit-equal on uint8 and within
  1e-5 of the image's largest value on float32 (the bound of the other
  float32 resizes, ``tests/test_torch_data.py``);
- the committed fixtures of ``tests/fixtures/jpeg`` equal to the cv2
  decodes stored beside them."""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from leftrefill_torch.data import image_io as io, jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
SAMPLING = {"444": 0x111111, "422": 0x211111, "440": 0x121111, "420": 0x221111, "411": 0x411111}


def _scene(h: int, w: int, seed: int, c: int = 3) -> np.ndarray:
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, c)).astype(np.uint8), (5, 5), 1.5)
    return img.reshape(h, w, c) if c > 1 else img.reshape(h, w)


def _encode(img: np.ndarray, params: list) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_rgb(data: bytes, flags: int = cv2.IMREAD_COLOR) -> np.ndarray:
    out = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    return out[..., ::-1] if out.ndim == 3 else out


def _same(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.dtype == ref.dtype and got.shape == ref.shape
    diff = got.astype(np.int64) != ref.astype(np.int64)
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} values differ"


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [30, 75, 95])
def test_baseline_matches_opencv(sampling, quality):
    """Baseline files at each sampling and quality, at 37x53, 64x64 and 17x9
    (sizes no multiple of the MCU, and a chroma plane two samples wide)."""
    for i, (h, w) in enumerate(((37, 53), (64, 64), (17, 9))):
        data = _encode(_scene(h, w, i), [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        got, orientation = jpeg.read_jpeg(data)
        _same(got, _cv2_rgb(data))
        assert orientation == 1


@pytest.mark.parametrize("mode", ["progressive", "restart", "optimize", "progressive_restart"])
@pytest.mark.parametrize("sampling", ["444", "422", "440", "420"])
def test_coding_modes_match_opencv(mode, sampling):
    """Progressive files (libjpeg's default scan script), restart intervals,
    optimized Huffman tables, each at qualities 30/75/95 and 37x53 / 80x96;
    the colour read and the grey read (the Y plane libjpeg outputs for
    ``JCS_GRAYSCALE``, no RGB -> grey of the pixels)."""
    extra = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
             "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
             "progressive_restart": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}[mode]
    for quality in (30, 75, 95):
        for i, (h, w) in enumerate(((37, 53), (80, 96))):
            data = _encode(_scene(h, w, 10 + i), [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]] + extra)
            _same(jpeg.read_jpeg(data)[0], _cv2_rgb(data))
            _same(jpeg.read_jpeg(data, grey=True)[0], _cv2_rgb(data, cv2.IMREAD_GRAYSCALE))
    if mode == "restart":  # the markers are there
        assert b"\xff\xd0" in data


@pytest.mark.parametrize("progressive", [False, True])
def test_greyscale_jpeg_matches_opencv(tmp_path, progressive):
    """A one-component file under the three flags (the colour read repeats
    the grey)."""
    data = _encode(_scene(37, 53, 3, c=1), [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    path = tmp_path / "g.jpg"
    path.write_bytes(data)
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
        _same(io.imread(str(path), flags), _cv2_rgb(data, flags))
    assert io.imread(str(path), io.IMREAD_UNCHANGED).ndim == 2


def _exif(orientation: int, big_endian: bool) -> bytes:
    e = ">" if big_endian else "<"
    return ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHII", 0x010F, 2, 4, 0)  # Make, before the tag that matters
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00\x00\x00\x00")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_opencv(tmp_path, orientation):
    """An APP1 Exif segment spliced after SOI (big- and little-endian TIFF),
    and a PNG eXIf chunk: the colour and grey reads turned as OpenCV turns
    them, the unchanged read as stored."""
    img = _scene(24, 40, orientation)
    data = _encode(img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    for big in (True, False):
        tiff = _exif(orientation, big)
        path = tmp_path / f"e{int(big)}.jpg"
        path.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(tiff) + 8) + b"Exif\x00\x00" + tiff + data[2:])
        for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
            _same(io.imread(str(path), flags), _cv2_rgb(path.read_bytes(), flags))
    raw = b"".join(b"\x00" + row.tobytes() for row in img[..., ::-1])
    png = tmp_path / "e.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 40, 24, 8, 2, 0, 0, 0))
                    + _chunk(b"eXIf", _exif(orientation, True)) + _chunk(b"IDAT", zlib.compress(raw))
                    + _chunk(b"IEND", b""))
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
        _same(io.imread(str(png), flags), _cv2_rgb(png.read_bytes(), flags))


def _segments(data: bytes) -> list:
    """(marker, bytes of the segment and, for SOS, its entropy-coded data)."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0x00,) and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((marker, data[pos:end]))
        pos = end
    return out


def test_refusals():
    """Arithmetic coding, 12-bit samples, four components and a progressive
    file cut before its AC refinements (libjpeg would smooth its blocks)
    raise; the same progressive file whole reads."""
    base = _encode(_scene(16, 16, 0), [cv2.IMWRITE_JPEG_QUALITY, 75])
    sof = base.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.read_jpeg(base[:sof + 1] + b"\xc9" + base[sof + 2:])
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.read_jpeg(base[:sof + 4] + b"\x0c" + base[sof + 5:])
    with pytest.raises(ValueError, match="lossless"):
        jpeg.read_jpeg(base[:sof + 1] + b"\xc3" + base[sof + 2:])
    cmyk = _encode(_scene(16, 16, 0, c=3), [cv2.IMWRITE_JPEG_QUALITY, 75])
    i = cmyk.index(b"\xff\xc0")
    body = bytearray(cmyk[i + 4:i + 4 + struct.unpack(">H", cmyk[i + 2:i + 4])[0] - 2])
    body[5] = 4
    forged = cmyk[:i + 2] + struct.pack(">H", len(body) + 2 + 3) + bytes(body) + bytes([4, 0x11, 0]) + \
        cmyk[i + 4 + len(body):]
    with pytest.raises(ValueError, match="components"):
        jpeg.read_jpeg(forged)
    prog = _encode(_scene(32, 32, 1), [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    _same(jpeg.read_jpeg(prog)[0], _cv2_rgb(prog))
    segs = _segments(prog)
    scans = [k for k, (m, _) in enumerate(segs) if m == 0xDA]
    cut = b"\xff\xd8" + b"".join(s for k, (_, s) in enumerate(segs) if k not in scans[3:]) + b"\xff\xd9"
    with pytest.raises(ValueError, match="unrefined"):
        jpeg.read_jpeg(cut)


def _png(path, w, h, depth, colour, rows, extra=b""):
    raw = b"".join(b"\x00" + r for r in rows)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                     + extra + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _pack(vals: np.ndarray, depth: int) -> bytes:
    bits = np.unpackbits(vals.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
    return np.packbits(np.concatenate([bits, np.zeros((-len(bits)) % 8, np.uint8)])).tobytes()


def _check_png(path) -> None:
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
        ref = cv2.imread(str(path), flags)
        if ref.ndim == 3:
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
        _same(io.imread(str(path), flags), ref)
    _same(io.read_png(str(path)), io.imread(str(path), io.IMREAD_UNCHANGED))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_and_low_bit_png_match_opencv(tmp_path, depth):
    """Palette files (with and without tRNS alpha) and grey files of 1-8
    bits, 13x21 (rows that end inside a byte)."""
    rng = np.random.RandomState(depth)
    h, w = 13, 21
    idx = rng.randint(0, 2**depth, (h, w))
    pal = rng.randint(0, 256, (2**depth, 3)).astype(np.uint8)
    rows = [_pack(r, depth) for r in idx]
    _png(tmp_path / "p.png", w, h, depth, 3, rows, _chunk(b"PLTE", pal.tobytes()))
    _check_png(tmp_path / "p.png")
    trns = rng.randint(0, 256, max(2**depth - 1, 1)).astype(np.uint8).tobytes()
    _png(tmp_path / "t.png", w, h, depth, 3, rows, _chunk(b"PLTE", pal.tobytes()) + _chunk(b"tRNS", trns))
    _check_png(tmp_path / "t.png")
    _png(tmp_path / "g.png", w, h, depth, 0, rows)
    _check_png(tmp_path / "g.png")


@pytest.mark.parametrize("colour", [0, 2, 4, 6])
@pytest.mark.parametrize("depth", [8, 16])
def test_grey_alpha_and_16_bit_png_match_opencv(tmp_path, colour, depth):
    """Grey, RGB, grey + alpha and RGBA at 8 and 16 bits (16 bits: the
    unchanged read keeps uint16, the others the high byte; the grey read of
    RGB through libpng's rgb_to_gray), with grey pixels among the RGB ones."""
    rng = np.random.RandomState(colour + depth)
    n = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    v = rng.randint(0, 2**depth, (13, 21, n)).astype(">u2" if depth == 16 else np.uint8)
    if n >= 3:
        v[2, :5, 1] = v[2, :5, 2] = v[2, :5, 0]
    _png(tmp_path / "x.png", 21, 13, depth, colour, [r.tobytes() for r in v])
    _check_png(tmp_path / "x.png")


def test_rgb_trns_png_matches_opencv(tmp_path):
    v = np.random.RandomState(0).randint(0, 256, (13, 21, 3)).astype(np.uint8)
    v[0, 0] = v[5, 7] = (1, 2, 3)
    _png(tmp_path / "t.png", 21, 13, 8, 2, [r.tobytes() for r in v], _chunk(b"tRNS", struct.pack(">3H", 1, 2, 3)))
    _check_png(tmp_path / "t.png")


@pytest.mark.parametrize("channels", [1, 3])
def test_area_enlarge_matches_opencv(channels):
    """``INTER_AREA`` where OpenCV runs its bilinear with area coefficients:
    enlarging one or both axes (one axis may shrink)."""
    rng = np.random.RandomState(channels)
    for (h, w), (dh, dw) in (((7, 9), (15, 20)), ((37, 53), (512, 512)), ((100, 30), (200, 31)),
                             ((512, 512), (512, 700)), ((37, 53), (7, 200)), ((120, 160), (512, 512))):
        x = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        if channels == 1:
            x = x[..., 0]
        _same(io.resize(x, (dw, dh), io.INTER_AREA), cv2.resize(x, (dw, dh), interpolation=cv2.INTER_AREA))
        xf = x.astype(np.float32) / 255
        ref = cv2.resize(xf, (dw, dh), interpolation=cv2.INTER_AREA)
        got = io.resize(xf, (dw, dh), io.INTER_AREA)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", json.loads((FIXTURES / "manifest.json").read_text()))
def test_fixtures_decode_as_stored(name):
    """Each committed fixture decodes to OpenCV's decode stored beside it
    (PNG, or the SHA-256 of the photo's), and OpenCV here still gives it."""
    entry = json.loads((FIXTURES / "manifest.json").read_text())[name]
    got = io.imread(str(FIXTURES / name), io.IMREAD_COLOR)
    assert list(got.shape) == entry["shape"] and hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    if "png" in entry:
        _same(got, io.read_png(str(FIXTURES / entry["png"])))
    _same(got, cv2.imread(str(FIXTURES / name), cv2.IMREAD_COLOR)[..., ::-1])
