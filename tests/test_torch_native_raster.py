"""The native mask raster (``leftrefill_torch/csrc/host/raster.cpp`` through
``data.native``) against its plain Python version (``data/masks.py``, reached
through ``native.plain_image_ops(("raster",))``) and against the PIL raster
of the JAX package (``leftrefill_tpu/data/masks.py``), on the CPU, with no
tolerance (0 pixels differ):

- ``draw_polyline_mask`` on seeded integer and float strokes at the NVS and
  match-based widths, at every width 2..140, on canvases 32..512 (and a
  canvas other than ``size``), and on degenerate strokes (coincident
  vertices, horizontal and vertical segments, vertices far outside);
- the segments whose length libm's ``hypot`` (PIL's) rounds an ulp away
  from ``math.hypot`` (the port's): no width 2..140 moves their
  quadrilateral, and they draw as PIL's;
- the ellipse of every box width 1..140, inside the canvas and across its
  border;
- ``nvs_object_mask``, ``match_based_mask`` and ``random_stroke_mask``
  through the native raster against JAX's under the same seeded streams;
- ``NVS_OBJDataset._load_view``'s uint8 route against JAX's float64 one
  over every alpha and colour value, and a 16-bit render through the
  float64 route;
- the routing, the refusals, and a loader of 8 threads giving a loader of
  1 thread's batches while the raster runs with the GIL released.

The native layer is built at first use with the host C++ compiler."""

import ctypes
import ctypes.util
import math
import random

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw

from leftrefill_tpu.data import datasets as jd, masks as jm

from leftrefill_torch import tools
from leftrefill_torch.data import datasets as td, image_io as io, masks as tmk, native
from leftrefill_torch.data.loader import DataLoader


def _strokes(case: str):
    """(points, size, width, canvas_size) of each stroke of ``case``."""
    rng = np.random.RandomState(["nvs_int", "match_float", "widths", "canvases", "degenerate"].index(case))
    if case == "nvs_int":  # the NVS masks: 20-45 vertices in the object's box, widths 80-140 x 256/512
        for _ in range(60):
            lo = rng.randint(0, 160, 2)
            hi = lo + rng.randint(8, 256 - lo, 2)
            n = rng.randint(20, 46)
            pts = np.stack([rng.randint(lo[0], hi[0], n), rng.randint(lo[1], hi[1], n)], 1)
            yield pts, 256, int(rng.randint(40, 71)), None
    elif case == "match_float":  # the match-based masks: float keypoints, widths 35-70, some past the border
        for _ in range(60):
            yield rng.uniform(-40, 296, (rng.randint(15, 31), 2)), 256, int(rng.randint(35, 71)), None
    elif case == "widths":
        for width in range(2, 141):
            yield rng.uniform(-20, 276, (12, 2)).astype(np.float32), 256, width, None
    elif case == "canvases":
        for size, canvas in ((32, None), (48, None), (64, 96), (100, None), (128, None), (256, 200), (512, None)):
            for _ in range(4):
                c = canvas or size
                pts = rng.uniform(-c / 8, c * 9 / 8, (rng.randint(6, 17), 2))
                yield pts, size, int(rng.randint(2, max(c // 3, 3))), canvas
    else:
        for width in (2, 3, 9, 40, 71):
            yield np.array([[10, 10], [10, 10], [40, 50]]), 64, width, None  # coincident consecutive vertices
            yield np.array([[30, 30], [30, 30], [30, 30]]), 64, width, None  # one point
            yield np.array([[30, 31]]), 64, width, None  # one vertex
            yield np.array([[5, 20], [58, 20], [58, 44], [5, 44]]), 64, width, None  # horizontal and vertical
            yield np.array([[-5000, 20], [5000, 20], [20, 7000]]), 64, width, None  # far outside
            yield np.array([[-80, -90], [-3, -70], [-60, -2]]), 64, width, None  # wholly outside, negative
            yield np.array([[0, 0], [63, 0], [63, 63], [0, 63]]), 64, width, None  # on the border
            yield np.array([[-0.5, 12.999], [-1e-6, 40.0001], [63.5, -0.25], [31.5, 64.75]]), 64, width, None


@pytest.mark.parametrize("case", ["nvs_int", "match_float", "widths", "canvases", "degenerate"])
def test_polyline_native_matches_plain_and_pil(case):
    """Native, plain and PIL's (JAX's ``draw_polyline_mask``): 0 pixels differ."""
    strokes = 0
    for pts, size, width, canvas in _strokes(case):
        ref = jm.draw_polyline_mask(pts, size, width, canvas)
        got = tmk.draw_polyline_mask(pts, size, width, canvas)
        with native.plain_image_ops(("raster",)):
            plain = tmk.draw_polyline_mask(pts, size, width, canvas)
        assert got.dtype == np.float32 and got.shape == ref.shape == plain.shape, (case, strokes)
        assert int((got != ref).sum()) == 0 and int((plain != ref).sum()) == 0, (case, strokes, width)
        strokes += 1
    assert strokes >= 28


@pytest.mark.parametrize("where", ["inside", "border"])
def test_native_ellipse_matches_pil(where):
    """Every box width 1..140 (heights the width, one less, one more and a
    random one), inside a 160x160 canvas or across its border: native =
    plain = PIL's ``ellipse``."""
    rng = np.random.RandomState(0 if where == "inside" else 1)
    for w in range(1, 141):
        for h in (w, w - 1, w + 1, int(rng.randint(1, 141))):
            if not 1 <= h <= 150:
                continue
            if where == "inside":
                x0, y0 = rng.randint(0, 160 - w + 1), rng.randint(0, 160 - h + 1)
            else:
                x0, y0 = rng.randint(-w + 1, 160, 2)
                if 0 <= x0 <= 160 - w and 0 <= y0 <= 160 - h:
                    x0 = -w // 2
            box = (int(x0), int(y0), int(x0 + w - 1), int(y0 + h - 1))
            ref = Image.new("L", (160, 160), 0)
            ImageDraw.Draw(ref).ellipse(tuple(float(v) for v in box), fill=1)
            got, plain = np.zeros((160, 160), np.uint8), np.zeros((160, 160), np.uint8)
            native.ellipse(got, box)
            tmk._ellipse(plain, box)
            assert np.array_equal(got, np.asarray(ref)) and np.array_equal(plain, got), box


def _libm_hypot():
    """libm's ``hypot``, which PIL's ``ImagingDrawWideLine`` calls."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.hypot.restype, libm.hypot.argtypes = ctypes.c_double, [ctypes.c_double, ctypes.c_double]
    return libm.hypot


@pytest.mark.parametrize("case", ["nvs_int", "match_float"])
def test_libm_hypot_ulp_pairs_draw_as_pil(case):
    """The segments whose length libm's ``hypot`` rounds otherwise than the
    port's rasters (``math.hypot``, correctly rounded) do: for every such
    (dx, dy) on a 256 canvas and every width 2..140, the quadrilateral's
    four rounded offsets are the same with either length, and segments of seeded pairs among them, at the NVS
    (integer vertices, widths 40-70) or the match-based (float vertices,
    truncated onto the pair, widths 35-70) widths, draw native = plain =
    PIL's (JAX's ``draw_polyline_mask``).  Where libm's ``hypot`` is
    correctly rounded there are no such pairs and nothing to decide."""
    hypot = _libm_hypot()
    pairs = [(a, b) for a in range(256) for b in range(256) if hypot(a, b) != math.hypot(a, b)]
    small = (np.arange(2, 141) - 1) / 2.0
    for dx, dy in pairs:
        offsets = []
        for big in (hypot(dx, dy), math.hypot(dx, dy)):
            r_max, r_min = tmk._round_up(small) / big, tmk._round_down(small) / big
            offsets.append(tmk._round_down(np.stack([r_min * dy, r_max * dy, r_min * dx, r_max * dx])))
        assert np.array_equal(*offsets), (dx, dy)
    rng = np.random.RandomState(["nvs_int", "match_float"].index(case))
    lo, hi = (40, 71) if case == "nvs_int" else (35, 71)
    for k in rng.choice(len(pairs), min(40, len(pairs)), replace=False):
        dx, dy = pairs[k]
        x0, y0 = int(rng.randint(0, 256 - dx)), int(rng.randint(0, 256 - dy))
        pts = np.array([[x0, y0], [x0 + dx, y0 + dy]])
        if case == "match_float":
            pts = pts + rng.uniform(0, 1, (2, 2))
        width = int(rng.randint(lo, hi))
        ref = jm.draw_polyline_mask(pts, 256, width)
        got = tmk.draw_polyline_mask(pts, 256, width)
        with native.plain_image_ops(("raster",)):
            plain = tmk.draw_polyline_mask(pts, 256, width)
        assert int((got != ref).sum()) == 0 and int((plain != ref).sum()) == 0, (case, dx, dy, width)


def _object(size: int, s: int) -> np.ndarray:
    """An elliptic object of seed ``s``, some touching the border."""
    rng = np.random.RandomState(100 + s)
    yy, xx = np.mgrid[:size, :size] / size
    cy, cx, ry, rx = rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.35), rng.uniform(0.05, 0.35)
    return ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1).astype(np.float32)


@pytest.mark.parametrize("mask", ["nvs", "match", "stroke"])
def test_masks_through_native_raster_match_jax(mask):
    """The three masks that draw polylines, through the native raster,
    against JAX's under the same seeded streams: the NVS mask at 512 with
    JAX's default draws (dilation 8-20, 15-30 vertices, widths 60-120) on
    objects touching the border; the match-based mask on dense matches
    (every draw gives a mask) at 256 and 512; ``random_stroke_mask`` at 256
    and 512."""
    assert native.active("raster")
    for s in range(12):
        np.random.seed(s)
        if mask == "nvs":
            obj = _object(512, s)
            ref = jm.nvs_object_mask(obj, 512, rng=random.Random(s))
            got = tmk.nvs_object_mask(obj, 512, rng=random.Random(s), np_rng=np.random.RandomState(s))
        elif mask == "match":
            rng = np.random.RandomState(s)
            pts = [rng.uniform(0, 832, (400, 2)).astype(np.float32) for _ in range(2)]
            res = {"scores": rng.uniform(0.85, 1, 400).astype(np.float32), "mkpts0": pts[0], "mkpts1": pts[1]}
            size = (256, 512)[s % 2]
            ref = jm.match_based_mask(res, size, rng=random.Random(s))
            got = tmk.match_based_mask(res, size, rng=random.Random(s), np_rng=np.random.RandomState(s))
            assert ref is not None and got is not None and got.sum() > 0, s
        else:
            size = (256, 512)[s % 2]
            ref = jm.random_stroke_mask(size, random.Random(s))
            got = tmk.random_stroke_mask(size, random.Random(s))
        assert got.dtype == np.float32 and np.array_equal(got, ref), (mask, s)


def _load_view_pair(tmp_path, render: np.ndarray):
    io_dir = tmp_path / "obj"
    io_dir.mkdir(exist_ok=True)
    if render.dtype == np.uint8:
        io.write_png(str(io_dir / "000.png"), render)
    else:  # a 16-bit render, written by OpenCV (BGRA)
        cv2.imwrite(str(io_dir / "000.png"), render[:, :, [2, 1, 0, 3]])
    return td.NVS_OBJDataset._load_view(None, str(io_dir), 0), jd.NVS_OBJDataset._load_view(None, str(io_dir), 0)


def test_load_view_uint8_route_matches_jax(tmp_path):
    """Every alpha value (a column each) under every colour value (a row
    each, the three channels permuted): the uint8 route gives JAX's float64
    route's RGB and mask.  It rests on x / 255 * 255 truncated giving x back
    for every uint8 x."""
    x = np.arange(256)
    assert np.array_equal((x / 255.0 * 255.0).astype(np.uint8), x)
    yy, xx = np.mgrid[:256, :256]
    render = np.stack([yy, 255 - yy, (yy * 7 + xx) % 256, xx], axis=2).astype(np.uint8)
    (rgb, mask), (ref_rgb, ref_mask) = _load_view_pair(tmp_path, render)
    assert rgb.dtype == np.uint8 and mask.dtype == np.float32 and rgb.shape == (256, 256, 3)
    assert np.array_equal(rgb, ref_rgb) and np.array_equal(mask, ref_mask)
    assert (rgb[:, 0] == 255).all() and mask[:, 0].sum() == 0 and (mask[:, 1:] == 1).all()


def test_load_view_uint16_render_takes_float64_route(tmp_path):
    """A 16-bit RGBA render (read as uint16, as OpenCV reads it) goes
    through JAX's float64 route: its RGB and mask equal JAX's."""
    rng = np.random.RandomState(0)
    render = rng.randint(0, 256, (40, 48, 4)).astype(np.uint16)
    render[:, :8, 3] = 0
    (rgb, mask), (ref_rgb, ref_mask) = _load_view_pair(tmp_path, render)
    assert io.read_png(str(tmp_path / "obj" / "000.png")).dtype == np.uint16
    assert rgb.dtype == np.uint8 and np.array_equal(rgb, ref_rgb) and np.array_equal(mask, ref_mask)
    assert (rgb[:, :8] == 255).all() and mask[:, :8].sum() == 0


def test_plain_raster_route(monkeypatch):
    """``plain_image_ops(("raster",))`` routes ``draw_polyline_mask`` to the
    Python version, in every thread; outside it the native raster runs."""
    assert "raster" in native.NAMES

    def refused(*a, **kw):
        raise AssertionError("the native raster was called")

    pts = np.array([[3, 4], [50, 20], [20, 60]])
    want = tmk.draw_polyline_mask(pts, 64, 9)
    monkeypatch.setattr(native, "polyline_mask", refused)
    with native.plain_image_ops(("raster",)):
        assert not native.active("raster") and native.active("dilate")
        assert np.array_equal(tmk.draw_polyline_mask(pts, 64, 9), want)
    with pytest.raises(AssertionError, match="native raster was called"):
        tmk.draw_polyline_mask(pts, 64, 9)


def test_native_raster_refusals():
    """Widths below 2 are refused on both paths; the native raster refuses
    by name what its C int and int64 arithmetic cannot hold (widths past
    2^31, vertices past 2^24, ellipse boxes past 40000) and reversed
    ellipse boxes, where the plain walk would not end.  The segment length is Python's ``math.hypot``,
    which is the correctly rounded sqrt(dx^2 + dy^2) the native raster
    computes (libm's ``hypot`` is not, in the last bit)."""
    for impl in ("native", "plain"):
        with native.plain_image_ops(("raster",) if impl == "plain" else ()):
            with pytest.raises(ValueError, match="widths of 2"):
                tmk.draw_polyline_mask(np.zeros((3, 2)), 32, 1)
    with pytest.raises(ValueError, match=r"past \+-2\^24"):
        tmk.draw_polyline_mask(np.array([[0, 0], [2.0**25, 3]]), 32, 5)
    with pytest.raises(ValueError, match="past"):
        tmk.draw_polyline_mask(np.array([[0, 0], [np.nan, 3]]), 32, 5)
    with pytest.raises(ValueError, match="too large"):
        tmk.draw_polyline_mask(np.array([[0, 0], [4, 3]]), 32, 50000)
    with pytest.raises(ValueError, match="out of the raster's range"):
        tmk.draw_polyline_mask(np.array([[0, 0], [4, 3]]), 32, 2**32 + 5)  # a C int would wrap it to 5
    with pytest.raises(ValueError, match="comes before"):
        native.ellipse(np.zeros((8, 8), np.uint8), (5, 5, 2, 7))
    with pytest.raises(ValueError, match="too large"):
        native.ellipse(np.zeros((8, 8), np.uint8), (0, 0, 2**64 + 3, 3))  # int64 would wrap it to 3
    d = np.arange(0, 600)
    exact = np.sqrt((d[:, None] ** 2 + d[None, :] ** 2).astype(np.float64))
    assert all(math.hypot(int(a), int(b)) == exact[a, b] for a in range(0, 600, 3) for b in range(600))


def test_loader_threads_give_one_threads_batches(tmp_path):
    """NVS items whose draws are their own (a dataset seeded by the item's
    index), so that no draw depends on the order in which threads take
    them: a ``DataLoader`` of 8 threads, the raster and the dilation
    running with the GIL released, gives the batches of 1 thread."""
    paths = tools.write_nvs_renders(str(tmp_path), objects=4, views=6, size=96, seed=3)
    kw = dict(img_size=64, nviews=6, sp_token="<special-token>", repeat_sp_token=4, dilate_size=(10, 25),
              pts_size=(20, 45), mask_enlarge=(0.05, 0.2), width_range=(80, 140))

    class PerItem:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return td.NVS_OBJDataset(paths["datapath"], paths["train_list"], mode="train", seed=i, **kw)[i % 4]

    one, eight = (list(DataLoader(PerItem(), 8, num_workers=n)) for n in (1, 8))
    assert len(one) == len(eight) == 4
    for a, b in zip(one, eight):
        assert a.keys() == b.keys()
        for k in a:
            assert (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]), k


def test_collate_tokenizes_repeated_prompts_as_jax():
    """``collate`` tokenizes each distinct prompt of a batch once (the NVS
    batch repeats one prompt 16 times); the tokens equal JAX's ``collate``'s
    for repeated and distinct prompts, strings and per-view lists."""
    import warnings

    from leftrefill_tpu.data import loader as jl

    from leftrefill_torch.data import loader as tl
    from leftrefill_torch.models.tokenizer import SimpleTokenizer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok = SimpleTokenizer(special_tokens=["<a0>", "<a1>"])
    calls = []
    tokenize = tok.tokenize
    tok.tokenize = lambda t: calls.append(t) or tokenize(t)
    for txts in (["<a0> <a1> a photo"] * 16, ["<a0> x", "<a1> y", "<a0> x", ""],
                 [["<a0> v0", "<a1> v1"], ["<a0> v0", "<a1> v1"], ["<a1> v1", "<a0> v0"]]):
        items = [{"image": np.full((2, 2, 3), i, np.float32), "txt": t} for i, t in enumerate(txts)]
        calls.clear()
        got = tl.collate(items, tok)
        assert len(calls) == len({t if isinstance(t, str) else tuple(t) for t in txts})
        ref = jl.collate(items, tok)
        assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)
