"""The native image layer (``leftrefill_torch/data/native.py``,
``csrc/host/*.cpp``) against the plain Python/numpy versions it stands
beside, bit for bit, and its build:

- every JPEG fixture of ``tests/fixtures/jpeg``: the Huffman scans'
  coefficients equal, and the pixels with each stage routed to its plain
  version equal to the all-native decode (colour and grey reads); seeded
  progressive, restart-interval and optimized streams the same way;
- the IDCT on random coefficients whose products wrap libjpeg's 32-bit work
  array, every upsampling factor on planes one to five samples wide, the
  colour conversion on every (Y, Cb, Cr), the PNG scanline filters mixed row
  by row at each pixel size;
- corrupt streams raise the plain path's errors (or decode the same pixels);
- 8 threads decoding the photo fixture at once give its bits;
- two processes building into one fresh build directory leave one working
  library; a bad ``CXX`` raises a ``RuntimeError`` naming the compiler, and
  the decode raises it too (no fallback);
- the library is a ``ctypes.CDLL`` (calls release the GIL), not a ``PyDLL``.

The comparisons with OpenCV itself are in ``test_torch_jpeg.py`` and
``test_torch_data.py``, for both paths."""

import ctypes
import json
import re
import struct
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest

from leftrefill_torch import native_lib
from leftrefill_torch.data import image_io as io, jpeg, native

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "jpeg"
JPEGS = [n for n in json.loads((FIXTURES / "manifest.json").read_text()) if n.endswith(".jpg")]
SAMPLING = {"444": 0x111111, "422": 0x211111, "440": 0x121111, "420": 0x221111, "411": 0x411111}


def _coefs(data: bytes, plain: bool) -> list:
    if plain:
        with native.plain_image_ops(["jpeg_entropy"]):
            return [c.coef for c in jpeg.coefficients(data)[0]]
    return [c.coef for c in jpeg.coefficients(data)[0]]


def _equal_everywhere(data: bytes) -> None:
    """The coefficients of both entropy paths, then the colour and grey
    reads with each stage (and all) on its plain version, against the
    all-native read."""
    for a, b in zip(_coefs(data, False), _coefs(data, True)):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)
    for grey in (False, True):
        ref, orientation = jpeg.read_jpeg(data, grey=grey)
        for names in (["jpeg_entropy"], ["jpeg_idct"], ["jpeg_color"], native.NAMES):
            with native.plain_image_ops(names):
                got, o = jpeg.read_jpeg(data, grey=grey)
            assert o == orientation and got.dtype == ref.dtype and np.array_equal(got, ref), (grey, names)


@pytest.mark.parametrize("name", JPEGS)
def test_native_decode_equals_plain_on_every_fixture(name):
    _equal_everywhere((FIXTURES / name).read_bytes())


def _scene(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (5, 5), 1.5)


@pytest.mark.parametrize("mode", ["progressive", "restart1", "restart7", "progressive_restart", "optimize"])
def test_native_decode_equals_plain_on_seeded_streams(mode):
    """cv2-encoded streams of seeded scenes: progressive (libjpeg's scan
    script: DC first and refinement, AC first and refinement with EOB runs),
    restart markers every MCU and every 7, both, optimized tables; each
    sampling, qualities 20 and 97, sizes that are no multiple of the MCU."""
    extra = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], "restart1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
             "restart7": [cv2.IMWRITE_JPEG_RST_INTERVAL, 7],
             "progressive_restart": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
             "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}[mode]
    for k, sampling in enumerate(SAMPLING.values()):
        for quality in (20, 97):
            ok, buf = cv2.imencode(".jpg", _scene(45 + 8 * k, 67 - 5 * k, k + quality),
                                   [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
                                   + extra)
            assert ok
            _equal_everywhere(buf.tobytes())


def test_idct_upsample_and_colour_stages_equal_plain():
    rng = np.random.RandomState(0)
    # coefficients over int16's whole range and tables up to 65535: the
    # column pass's values pass 32 bits and wrap in the work array
    coef = rng.randint(-32768, 32768, (3, 5, 64)).astype(np.int16)
    coef[0, :, 1:] = 0  # DC-only blocks
    for quant in (rng.randint(1, 256, 64), rng.randint(1, 65536, 64)):
        quant = quant.astype(np.int64)
        plain = jpeg.idct_islow(coef.reshape(-1, 64), quant).reshape(3, 5, 8, 8).transpose(0, 2, 1, 3).reshape(24, 40)
        assert np.array_equal(native.jpeg_idct(coef, quant), plain)
    for fh in (1, 2, 3, 4):
        for fv in (1, 2, 3, 4):
            for pw in (1, 2, 3, 4, 5):
                for ph in (1, 2, 3):
                    plane = rng.randint(0, 256, (ph + 1, pw + 2)).astype(np.uint8)[:ph, :pw]  # strided rows
                    for height, width in ((ph * fv, pw * fh), (max(ph * fv - 1, 1), max(pw * fh - 1, 1))):
                        got = native.jpeg_upsample(plane, fh, fv, width, height)
                        assert np.array_equal(got, jpeg.upsample(plane, fh, fv, width, height)), (fh, fv, pw, ph)
    y, cb, cr = (v.reshape(256, 256, 256).copy() for v in np.meshgrid(*[np.arange(256, dtype=np.uint8)] * 3,
                                                                       indexing="ij"))
    assert np.array_equal(native.jpeg_ycc_rgb(y, cb, cr), jpeg.ycc_to_rgb(y, cb, cr))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_equals_plain(bpp):
    """Rows of random bytes, each with a random filter type (0-4), and an
    unknown filter type raising the plain version's error."""
    rng = np.random.RandomState(bpp)
    h, stride = 9, 7 * bpp
    raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, h)
    got = native.png_unfilter(raw.tobytes(), h, stride, bpp)
    with native.plain_image_ops(["png_unfilter"]):
        ref = io._unfilter(raw.tobytes(), h, stride, bpp)
    assert np.array_equal(got, ref)
    raw[5, 0] = 9
    for plain in (False, True):
        with native.plain_image_ops(["png_unfilter"] if plain else []):
            with pytest.raises(ValueError, match="unknown PNG filter type 9"):
                io._unfilter(raw.tobytes(), h, stride, bpp)


@pytest.mark.parametrize("values", ["nan", "inf", "signed"])
def test_float_dilate_equals_plain(values):
    """The float32 dilation takes NaN as ``np.maximum`` does (NaN wherever
    the kernel reaches one), and +-inf and negative values as the plain
    version does, at odd and even kernel sizes up to the novel-view masks'
    25."""
    rng = np.random.RandomState(["nan", "inf", "signed"].index(values))
    for k in (1, 2, 7, 10, 19, 25):
        img = rng.uniform(-3, 3, (61, 77)).astype(np.float32)
        if values == "nan":
            img[rng.rand(61, 77) > 0.995] = np.nan
        elif values == "inf":
            img[rng.rand(61, 77) > 0.99] = np.inf
            img[rng.rand(61, 77) > 0.9] = -np.inf
        got = io.dilate(img, io.ellipse_kernel(k))
        with native.plain_image_ops(("dilate",)):
            want = io.dilate(img, io.ellipse_kernel(k))
        assert got.dtype == np.float32 and np.array_equal(got, want, equal_nan=True), (values, k)
        assert np.isnan(got).any() == (values == "nan"), (values, k)


def _outcome(data: bytes, plain: bool):
    """(pixels or None, the error's type and text or None) of a decode."""
    with native.plain_image_ops(native.NAMES if plain else []):
        try:
            return jpeg.read_jpeg(data)[0], None
        except Exception as e:  # compared between the two paths
            return None, (type(e).__name__, str(e))


def _sos(data: bytes) -> tuple[int, int]:
    """(start, end) of the first scan's entropy-coded data."""
    i = data.index(b"\xff\xda")
    start = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    end = start
    while not (data[end] == 0xFF and data[end + 1] not in (0x00,) and not 0xD0 <= data[end + 1] <= 0xD7):
        end += 1
    return start, end


@pytest.mark.parametrize("mode", ["baseline", "progressive", "restart"])
def test_corrupt_streams_raise_as_the_plain_path(mode):
    """Seeded corruptions of a stream's first scan (bytes changed, the scan
    cut short, all-ones data that starts no Huffman code, a DHT whose DC
    symbols pass 15): the native and the plain path decode the same pixels
    or raise the same error; the all-ones data and the bad table raise."""
    extra = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
             "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}[mode]
    ok, buf = cv2.imencode(".jpg", _scene(40, 56, 3), [cv2.IMWRITE_JPEG_QUALITY, 75] + extra)
    data = buf.tobytes()
    start, end = _sos(data)
    rng = np.random.RandomState(len(mode))
    streams = []
    for _ in range(24):
        b = bytearray(data)
        for p in rng.randint(start, end, rng.randint(1, 4)):
            b[p] = rng.randint(0, 256)
        streams.append(bytes(b))
    for cut in (start + 3, (start + end) // 2, end - 2):
        streams.append(data[:cut] + data[end:])
    ones = data[:start] + b"\xff\x00" * 40 + data[end:]
    dht = data.index(b"\xff\xc4")
    bad_table = bytearray(data)
    bad_table[dht + 5 + 16] = 16  # the first DC symbol of the first table
    streams += [ones, bytes(bad_table)]
    raised = 0
    for s in streams:
        (a, ea), (b, eb) = _outcome(s, False), _outcome(s, True)
        assert ea == eb, (ea, eb)
        assert (a is None and b is None) or np.array_equal(a, b)
        raised += ea is not None
    assert _outcome(ones, False)[1] == ("ValueError", "JPEG: corrupt data (a bad Huffman code)")
    assert _outcome(bytes(bad_table), False)[1] == ("ValueError", "JPEG: a bad Huffman table")
    assert raised >= 2


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _entropy(bits: str) -> bytes:
    """Bits MSB first, padded with ones, each 0xFF byte stuffed."""
    bits += "1" * (-len(bits) % 8)
    out = bytearray()
    for i in range(0, len(bits), 8):
        out.append(int(bits[i:i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def _wrap16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def _overflowing_progressive(coef: int, al: int) -> bytes:
    """An 8x8 grey progressive stream (quantizers of 1): a DC scan of 0, a
    first AC scan at ``al`` writing ``coef`` (size 15, so 16384 <= |coef|)
    to the first AC coefficient, then one refinement a bit down to bit 0,
    each with a correction bit of 1 for it."""
    counts = bytes([0, 2] + [0] * 14)  # two codes of 2 bits: 00, 01
    dht = b"\x00" + counts + bytes([0, 1]) + b"\x10" + counts + bytes([0x00, 0x0F])  # DC {0, 1}, AC {EOB, 0/15}

    def sos(ss: int, se: int, ah: int, al: int, bits: str) -> bytes:
        return _segment(0xDA, bytes([1, 1, 0x00, ss, se, ah << 4 | al])) + _entropy(bits)

    raw = coef if coef > 0 else coef + 32767  # the 15 bits that extend to coef
    return (b"\xff\xd8" + _segment(0xDB, b"\x00" + bytes([1] * 64))
            + _segment(0xC2, bytes([8, 0, 8, 0, 8, 1, 1, 0x11, 0])) + _segment(0xC4, dht)
            + sos(0, 0, 0, 0, "00")  # DC difference 0
            + sos(1, 63, 0, al, "01" + format(raw, "015b") + "00")  # 0/15, the bits, EOB
            + b"".join(sos(1, 63, a + 1, a, "001") for a in reversed(range(al)))  # an EOB run of 1, bit 1
            + b"\xff\xd9")


@pytest.mark.parametrize("coef,al", [(20000, 1), (-20000, 1), (16400, 2), (-16384, 1)])
def test_progressive_coefficient_overflow_wraps_as_libjpeg(coef, al):
    """A first AC scan whose ``coef << Al`` passes int16 (and one that just
    fits): both entropy paths wrap each coefficient to int16 as they write
    it (libjpeg's JCOEF), so each refinement's sign test reads the wrapped
    value; the coefficients and the pixels agree.  (OpenCV's pixels are not
    compared: at these magnitudes they differ from jidctint.c's even where
    nothing wraps, 16400 at Al 0.)"""
    data = _overflowing_progressive(coef, al)
    want = _wrap16(coef << al)
    for a in reversed(range(al)):
        if not want & (1 << a):
            want = _wrap16(want + (1 << a if want >= 0 else -1 << a))
    for plain in (False, True):
        got = _coefs(data, plain)[0]
        assert got.dtype == np.int16 and got[0, 0, 1] == want and np.count_nonzero(got) == 1, plain
    (a, ea), (b, eb) = _outcome(data, False), _outcome(data, True)
    assert ea is None and eb is None and np.array_equal(a, b)


def test_threads_decode_the_photo_alike():
    """8 threads decoding the 1600x1200 photo at once (the GIL released in
    the native calls, a short switch interval) give the single decode's
    bits, and the area resize of each."""
    data = (FIXTURES / "photo_1600x1200_420.jpg").read_bytes()
    ref = jpeg.read_jpeg(data)[0]
    ref_small = io.resize(ref, (683, 512), io.INTER_AREA)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(lambda: io.resize(jpeg.read_jpeg(data)[0], (683, 512), io.INTER_AREA))
                       for _ in range(16)]
            outs = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert all(np.array_equal(o, ref_small) for o in outs)


_BUILD_AND_DECODE = """
import sys
from pathlib import Path
import numpy as np
from leftrefill_torch.data import jpeg, native
native.LIBRARY.root = Path(sys.argv[1])
img, _ = jpeg.read_jpeg(Path(sys.argv[2]).read_bytes())
assert native.library_path().exists()
print(int(img.astype(np.int64).sum()))
"""


def test_two_processes_build_one_library(tmp_path):
    """Two processes started together on an empty build directory: both
    decode, one library is left, no temporary file."""
    photo = str(FIXTURES / "baseline_420.jpg")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_DECODE, str(tmp_path), photo], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    want = int(jpeg.read_jpeg(Path(photo).read_bytes())[0].astype(np.int64).sum())
    assert [int(out) for out, _ in outs] == [want, want]
    libs = list(tmp_path.glob(f"*/{native.LIB_NAME}"))
    assert len(libs) == 1 and not list(tmp_path.glob("*/work"))
    assert libs[0].read_bytes()[:4] == b"\x7fELF"


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/c++-missing", "false"])
def test_bad_compiler_raises_without_fallback(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(native.LIBRARY, "root", tmp_path)
    monkeypatch.setattr(native.LIBRARY, "lib", None)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=re.escape(f"compiler '{cxx}'")):
        native.library()
    data = (FIXTURES / "baseline_420.jpg").read_bytes()
    with pytest.raises(RuntimeError, match="compiler"):
        jpeg.read_jpeg(data)
    with pytest.raises(RuntimeError, match="compiler"):
        io.resize(np.zeros((8, 8, 3), np.uint8), (5, 5))
    assert not list(tmp_path.glob(f"*/{native.LIB_NAME}"))


def test_library_is_a_cdll_so_calls_release_the_gil():
    """``ctypes.CDLL`` drops the GIL for each foreign call (``PyDLL`` would
    hold it): the loaded library is one, and the module loads it no other
    way; every entry point has its argument and result types declared."""
    lib = native.library()
    assert type(lib) is ctypes.CDLL and not isinstance(lib, ctypes.PyDLL)
    for module in (native, native_lib):
        source = Path(module.__file__).read_text()
        assert "PyDLL" not in source and "pythonapi" not in source
    assert "ctypes.CDLL(" in Path(native_lib.__file__).read_text()
    for name in native._SIGNATURES:
        assert getattr(lib, name).argtypes is not None, name


def test_default_is_native_and_names_are_checked():
    assert all(native.active(n) for n in native.NAMES)
    with native.plain_image_ops(["resize"]):
        assert not native.active("resize") and native.active("dilate")
        seen = []
        t = threading.Thread(target=lambda: seen.append(native.active("resize")))
        t.start()
        t.join(timeout=10)
        assert seen == [False]  # every thread: the loader's workers follow the switch
    assert native.active("resize")
    with pytest.raises(ValueError, match="unknown image operations"):
        with native.plain_image_ops(["jpeg"]):
            pass
