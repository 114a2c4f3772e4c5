"""The port's data path without OpenCV and PIL (``leftrefill_torch/data``)
against the libraries the JAX package calls and against the JAX package's
own data path, on the CPU:

- the PNG codec: round trips, files written by OpenCV read as OpenCV reads
  them, each of the five scanline filters;
- ``resize`` equal to ``cv2.resize`` (bilinear, area, nearest; uint8 and
  float32) bit for bit, except float32 bilinear: OpenCV's vectorized fp32
  arithmetic rounds in an order not reproduced, held within 1e-5 of the
  image's largest value (readings ~5e-6);
- the ellipse kernel and the dilation equal to OpenCV's;
- the polyline raster equal to PIL's on every seeded stroke (the stated
  bound, at most 1 % of the stroke's pixels differing and all within one
  pixel of its edge, is the limit; the reading is 0 pixels);
- ``nvs_object_mask``, ``NVS_OBJDataset`` items (training, evaluation with
  mask files, complete masks), ``collate``, ``DataLoader`` and
  ``BalancedRandomSampler`` equal to JAX's under the same seeds."""

import random
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw

from leftrefill_tpu.data import datasets as jd, loader as jl, masks as jm

from leftrefill_torch import tools
from leftrefill_torch.data import datasets as td, image_io as io, loader as tl, masks as tmk


# ---------------------------------------------------------------------------
# PNG

def _images(seed: int):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (37, 53, 4)).astype(np.uint8)
    smooth = cv2.GaussianBlur(base, (7, 7), 3)
    return {"grey": smooth[..., 0], "rgb": smooth[..., :3], "rgba": smooth, "noise": base[..., :3]}


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "noise"])
def test_png_round_trip_and_opencv_agree(tmp_path, kind):
    """Our writer -> our reader and OpenCV's; OpenCV's writer -> our reader
    (OpenCV's channels are BGR(A))."""
    img = _images(0)[kind]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv.png")
    io.write_png(ours, img)
    assert np.array_equal(io.read_png(ours), img)
    order = [2, 1, 0, 3][: img.shape[2]] if img.ndim == 3 else None
    cv_read = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    assert np.array_equal(cv_read if order is None else cv_read[..., order], img)
    cv2.imwrite(theirs, img if order is None else img[..., order])
    assert np.array_equal(io.read_png(theirs), img)


def _filtered_png(path, img: np.ndarray, kind: int):
    """A PNG whose every scanline uses filter ``kind`` (PNG spec section 9),
    filtered here independently of the reader."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    raw = bytearray()
    for y in range(h):
        cur, prev = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(k, body):
        return struct.pack(">I", len(body)) + k + body + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF)

    colour = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_reads_every_scanline_filter(tmp_path, kind):
    for img in (_images(1)["rgba"], _images(1)["noise"], _images(1)["grey"][..., None]):
        path = str(tmp_path / "f.png")
        _filtered_png(path, img, kind)
        got = io.read_png(path)
        assert np.array_equal(got if got.ndim == 3 else got[..., None], img)
        cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)  # the files are valid PNGs
        assert cv.shape[:2] == img.shape[:2]


def test_png_refuses_what_it_does_not_read(tmp_path):
    """Interlaced files and bit depths no PNG has raise (16-bit files read,
    as OpenCV reads them: tests/test_torch_jpeg.py)."""
    path = str(tmp_path / "g16.png")
    cv2.imwrite(path, np.zeros((4, 4), np.uint16))
    assert io.read_png(path).dtype == np.uint16
    data = open(path, "rb").read()
    # IHDR's bytes: 24 bit depth, 25 colour type, 28 interlace
    for fields, match in (({28: 1}, "interlaced"), ({24: 4, 25: 2}, "bit depth")):
        body = bytearray(data[12:29])
        for field, value in fields.items():
            body[field - 12] = value
        chunk = bytes(body)
        bad = data[:12] + chunk + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF) + data[33:]
        (tmp_path / "bad.png").write_bytes(bad)
        with pytest.raises(ValueError, match=match):
            io.read_png(str(tmp_path / "bad.png"))


# ---------------------------------------------------------------------------
# resize, ellipse, dilation

def _resize_cases(seed: int, interp: int, n: int = 40):
    rng = np.random.RandomState(seed)
    cases = [((48, 48), (32, 32)), ((256, 256), (256, 256)), ((64, 64), (32, 32))]
    cases += [] if interp == io.INTER_AREA else [((37, 53), (64, 29))]  # area enlarging: test_torch_jpeg.py
    while len(cases) < n:
        h, w = (int(v) for v in rng.randint(2, 90, 2))
        dh, dw = (int(v) for v in rng.randint(1, 120, 2))
        if interp == io.INTER_AREA:
            dh, dw = min(dh, h), min(dw, w)
        cases.append(((h, w), (dh, dw)))
    return cases


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("interp", [io.INTER_LINEAR, io.INTER_AREA, io.INTER_NEAREST], ids=["linear", "area", "nearest"])
def test_resize_matches_opencv(interp, dtype):
    rng = np.random.RandomState(interp)
    for i, ((h, w), (dh, dw)) in enumerate(_resize_cases(interp, interp)):
        c = (1, 3, 4)[i % 3]
        src = (rng.randint(0, 256, (h, w, c)) if dtype == np.uint8 else rng.rand(h, w, c) * 255).astype(dtype)
        if c == 1:
            src = src[..., 0]
        ref = cv2.resize(src, (dw, dh), interpolation=interp)
        got = io.resize(src, (dw, dh), interp)
        assert got.shape == ref.shape and got.dtype == ref.dtype, (h, w, dh, dw)
        if dtype == np.float32 and interp == io.INTER_LINEAR:
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), (h, w, dh, dw)
        else:
            assert np.array_equal(got, ref), (h, w, c, dh, dw)


def test_ellipse_kernel_and_dilation_match_opencv():
    for k in range(1, 41):
        assert np.array_equal(io.ellipse_kernel(k), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))), k
    rng = np.random.RandomState(0)
    for k in (1, 2, 7, 10, 25, 30):
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        binary = (rng.rand(64, 80) > 0.97).astype(np.float32)
        values = binary * rng.rand(64, 80).astype(np.float32)
        grey = rng.randint(0, 256, (40, 33)).astype(np.uint8)
        for img in (binary, values, grey):
            assert np.array_equal(io.dilate(img, kernel), cv2.dilate(img, kernel, iterations=1)), k


# ---------------------------------------------------------------------------
# masks

def _stroke_cases():
    rng = np.random.RandomState(0)
    for size, widths, points in ((256, (40, 70), (20, 45)), (64, (7, 15), (15, 30)), (32, (2, 8), (3, 30))):
        for _ in range(40):
            n = rng.randint(*points)
            lo = rng.randint(-size // 8, size // 2, 2)
            hi = lo + rng.randint(4, size // 2 + size // 4, 2)
            yield np.stack([rng.randint(lo[0], hi[0], n), rng.randint(lo[1], hi[1], n)], 1), size, int(rng.randint(*widths))


def test_polyline_raster_matches_pil():
    """The stated bound per stroke (at most 1 % of PIL's stroke pixels
    differing, each within one pixel of its edge), on 120 seeded strokes at
    the novel-view widths and below, some reaching past the border.
    Reading: no pixel differs."""
    differing = 0
    for pts, size, width in _stroke_cases():
        ref, got = jm.draw_polyline_mask(pts, size, width), tmk.draw_polyline_mask(pts, size, width)
        d = ref != got
        pad = np.pad(ref, 1, mode="edge")
        nb = np.stack([pad[i:i + size, j:j + size] for i in range(3) for j in range(3)])
        edge = (nb.min(0) == 0) & (nb.max(0) == 1)
        assert got.dtype == np.float32 and d.sum() <= 0.01 * ref.sum() and not (d & ~edge).any()
        differing += int(d.sum())
    assert differing == 0


def test_ellipse_matches_pil():
    """PIL's filled ellipse, boxes of every width 1..60, inside and across the border."""
    rng = np.random.RandomState(1)
    for w in range(1, 61):
        x, y = rng.randint(-10, 74, 2)
        box = (x - w // 2, y - w // 2, x + w // 2, y + w // 2)
        ref = Image.new("L", (64, 64), 0)
        ImageDraw.Draw(ref).ellipse(tuple(float(v) for v in box), fill=1)
        got = np.zeros((64, 64), np.uint8)
        tmk._ellipse(got, box)
        assert np.array_equal(np.asarray(ref), got), box


@pytest.mark.parametrize("size,kw", [
    (64, {}),
    (256, dict(dilate_size=(10, 25), pts_size=(20, 45), mask_enlarge=(0.05, 0.2), width_range=(80, 140))),
    (64, dict(complete_mask_rate=0.5)),
])
def test_nvs_object_mask_matches_jax(size, kw):
    """The same draws in the same order: JAX's from ``random.Random(s)`` and
    numpy's global stream seeded with s, the port's from ``random.Random(s)``
    and ``RandomState(s)``; an empty object gives the whole view."""
    yy, xx = np.mgrid[:size, :size] / size
    for s in range(6):
        obj = (((yy - 0.5) / 0.2) ** 2 + ((xx - 0.4 - 0.03 * s) / 0.25) ** 2 <= 1).astype(np.float32)
        if s == 5:
            obj[:] = 0
        np.random.seed(s)
        ref = jm.nvs_object_mask(obj, size, rng=random.Random(s), **kw)
        got = tmk.nvs_object_mask(obj, size, rng=random.Random(s), np_rng=np.random.RandomState(s), **kw)
        assert got.dtype == np.float32 and np.array_equal(got, ref), s


# ---------------------------------------------------------------------------
# the dataset, the loader, the sampler

@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nvs"))
    return tools.write_nvs_renders(root, objects=4, views=6, size=96, seed=3, val_masks=2, img_size=64)


DATA_CONFIG = dict(img_size=64, nviews=6, sp_token="<special-token>", repeat_sp_token=4, dilate_size=(10, 25),
                   pts_size=(20, 45), mask_enlarge=(0.05, 0.2), width_range=(80, 140))


@pytest.mark.parametrize("mode,extra", [("train", {}), ("val", "masks"), ("val", {"mask_type": "complete"}),
                                        ("train", {"complete_mask_rate": 0.5, "repeat_sp_token": 0})])
def test_nvs_dataset_items_match_jax(renders, mode, extra):
    """Every entry of each item equal to JAX's (views picked, alpha made
    white, 96 -> 64 bilinear and area resizes, the mask, the masked canvas,
    the relative pose, the prompt) under the same seeds, item after item."""
    kw = dict(DATA_CONFIG, **({"mask_file_path": renders["mask_file_path"]} if extra == "masks" else extra or {}))
    lst = renders["train_list"] if mode == "train" else renders["val_list"]
    np.random.seed(7)
    random.seed(7)  # the templates' choice (repeat_sp_token 0) draws from the module stream, as JAX's
    ref_ds = jd.NVS_OBJDataset(renders["datapath"], lst, mode=mode, seed=7, **kw)
    refs = [ref_ds[i % len(ref_ds)] for i in range(6)]
    random.seed(7)
    ds = td.NVS_OBJDataset(renders["datapath"], lst, mode=mode, seed=7, **kw)
    for i, ref in enumerate(refs):
        got = ds[i % len(ds)]
        assert got.keys() == ref.keys()
        for k in ref:
            if k == "txt":
                assert got[k] == ref[k]
            else:
                assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), (i, k)
    assert got["image"].shape == (64, 128, 3) and got["mask"].shape == (64, 128, 1)


def test_collate_loader_and_sampler_match_jax(renders):
    from leftrefill_torch.models.tokenizer import SimpleTokenizer

    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok = SimpleTokenizer(special_tokens=[f"<special-token{i}>" for i in range(4)])
    kw = dict(DATA_CONFIG, mask_file_path=renders["mask_file_path"])
    items = [td.NVS_OBJDataset(renders["datapath"], renders["val_list"], mode="val", **kw)[i] for i in range(2)]
    for with_tok in (None, tok):
        a, b = tl.collate(items, with_tok), jl.collate(items, with_tok)
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] == b[k]) if k == "txt" else np.array_equal(a[k], b[k]), k
    ds = td.NVS_OBJDataset(renders["datapath"], renders["val_list"], mode="val", **kw)
    for shuffle, drop_last in ((False, True), (True, False)):
        ours = tl.DataLoader(ds, 1, tokenizer=tok, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=3)
        ref = jl.DataLoader(ds, 1, tokenizer=tok, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=3)
        ours.set_epoch(1)
        ref.set_epoch(1)
        got, want = list(ours), list(ref)
        assert len(ours) == len(ref) == len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert all(np.array_equal(g[k], w[k]) for k in w)
    image_dict = {i: f"/d/scene{i % 3}/imgs/{i}.jpg" for i in range(30)}
    pairs = [{"source": [i], "target": [(i + 1) % 30]} for i in range(30)]
    for rank, replicas in ((0, 1), (1, 3)):
        a = td.BalancedRandomSampler(image_dict, pairs, n_sample_per_scene=7, rank=rank, num_replicas=replicas)
        b = jd.BalancedRandomSampler(image_dict, pairs, n_sample_per_scene=7, rank=rank, num_replicas=replicas)
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b) and len(a) == len(b)


def test_loader_hands_on_a_worker_error():
    """An item that raises ends the iteration with its error (JAX's loader
    would wait for a batch that never comes)."""

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"item {i} is unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(tl.DataLoader(Broken(), 2, num_workers=1))
