"""The MegaDepth training data of the port against the JAX package's on the
CPU, under the same seeds (JAX's draws from ``random.Random(seed)``, the
global ``random`` module and numpy's global stream seeded with the seed; the
port's from its own ``random.Random`` streams and ``RandomState(seed)``):

- the training masks: ``load_mask_file``, ``random_stroke_mask``,
  ``FileMaskSampler`` (both lists, one, none) and ``match_based_mask`` (the
  crop-info and the no-crop mappings, both sides, ``constant_place`` on and
  off, ``place_on_canvas`` off, and the None returns) bit-equal;
- the training items of ``InpaintingCrossViewDataset``,
  ``InpaintingMultiViewDataset`` and ``InpaintingDataset`` bit-equal, item
  after item, over several seeds and configurations (``constant_place``
  on and off, ``only_mask_image``, ``flip``, ``view_mask_rate`` 0 and 1,
  match masks, template prompts, ``source_shuffle``, ``concat_target``),
  at image sizes that take each branch of the area resize (both axes
  shrinking, both enlarging, one of each), the 1600x1200 photo included;
- the pickles of ``build_megadepth_pairs`` and
  ``extend_pairs_for_multiview`` equal to JAX's.

Every comparison is exact (the port's polyline raster is PIL's pixel for
pixel); the match-based masks are drawn through the native raster and
through its plain Python version (``impl``)."""

import os
import pickle
import random

import numpy as np
import pytest

from leftrefill_tpu.data import datasets as jd, masks as jm, preprocess as jp

from leftrefill_torch import tools
from leftrefill_torch.data import datasets as td, masks as tmk, native, preprocess as tp

SMALL = tools.MEGADEPTH_IMAGES[1:]  # the 120x160 fixtures: the photo's decode is slow in Python


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("megadepth"))
    return tools.write_megadepth_scenes(root, scenes=2, images_per_scene=5, seed=1, train_pairs_per_scene=12,
                                        other_pairs_per_scene=4, images=SMALL, mask_size=96)


@pytest.fixture(scope="module")
def photo_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("megadepth_photo"))
    return tools.write_megadepth_scenes(root, scenes=1, images_per_scene=3, seed=2, train_pairs_per_scene=4,
                                        other_pairs_per_scene=0, images=tools.MEGADEPTH_IMAGES[:2], mask_size=64)


def _equal(got: dict, ref: dict, where) -> None:
    assert got.keys() == ref.keys(), where
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (where, k)
        else:
            assert got[k] == v, (where, k)


# ---------------------------------------------------------------------------
# masks

def test_load_mask_file_and_stroke_mask_match_jax(tree):
    names = open(tree["train_mask_path"][0]).read().split() + open(tree["train_mask_path"][1]).read().split()
    for name in names:
        for size in (32, 64, 96, 131, 256):
            got, ref = tmk.load_mask_file(name, size), jm.load_mask_file(name, size)
            assert got.dtype == np.float32 and np.array_equal(got, ref), (name, size)
    for size in (24, 64, 256):
        for s in range(8):
            ref = jm.random_stroke_mask(size, random.Random(s))
            assert np.array_equal(tmk.random_stroke_mask(size, random.Random(s)), ref), (size, s)


@pytest.mark.parametrize("lists", ["both", "irregular", "segment", "none"])
def test_file_mask_sampler_matches_jax(tree, lists):
    """40 draws of each: the half mask and the canvas, one stream."""
    irregular, segment = (td._read_list(p) for p in tree["train_mask_path"])
    irr, seg = {"both": (irregular, segment), "irregular": (irregular, None), "segment": (None, segment),
                "none": (None, None)}[lists]
    for s in range(2):
        ours = tmk.FileMaskSampler(irr, seg, 64, random.Random(s))
        ref = jm.FileMaskSampler(irr, seg, 64, random.Random(s))
        for i in range(20):
            assert np.array_equal(ours.sample_half(), ref.sample_half()), (s, i)
            got, want = ours.sample_canvas(), ref.sample_canvas()
            assert got.shape == (64, 128) and np.array_equal(got, want), (s, i)


def _match(rng: np.random.RandomState, n: int, spread: float):
    lo = rng.uniform(0, 832 - spread, (2, 2))
    pts = [(lo[i] + rng.uniform(0, spread, (n, 2))).astype(np.float32) for i in range(2)]
    return {"scores": rng.uniform(0, 1, n).astype(np.float32), "mkpts0": pts[0], "mkpts1": pts[1]}


@pytest.fixture(params=["plain", "native"])
def impl(request):
    """The polyline raster's path for the test: the plain Python version, or
    the native one (the default)."""
    if request.param == "plain":
        with native.plain_image_ops(("raster",)):
            yield request.param
    else:
        yield request.param


def test_match_based_mask_matches_jax(impl):
    """Seeded matcher outputs (dense and sparse, wide and narrow spreads,
    an empty one), with and without crop info, both target sides,
    ``constant_place`` on and off, at 256 (the mask's own size) and 512
    (the nearest resize), and the one view's mask: bit-equal, both masks and
    None returns among them, on both raster paths."""
    rng = np.random.RandomState(0)
    outcomes = {"mask": 0, "none": 0}
    for c in range(60):
        res = _match(rng, int(rng.choice([0, 12, 40, 300])), float(rng.choice([60, 300, 800])))
        crop = lambda: {"w_start": int(rng.randint(0, 120)), "h_start": int(rng.randint(0, 60)),
                        "w": int(rng.choice([341, 384])), "h": 256}
        tci, sci = (crop() if rng.rand() < 0.6 else None), (crop() if rng.rand() < 0.6 else None)
        kw = dict(img_size=int(rng.choice([256, 512])), target_pos=str(rng.choice(["left", "right"])),
                  constant_place=bool(rng.rand() < 0.5), target_crop_info=tci, source_crop_info=sci,
                  place_on_canvas=bool(rng.rand() < 0.7))
        np.random.seed(c)
        ref = jm.match_based_mask(res, rng=random.Random(c), **kw)
        got = tmk.match_based_mask(res, rng=random.Random(c), np_rng=np.random.RandomState(c), **kw)
        if ref is None:
            assert got is None, c
            outcomes["none"] += 1
        else:
            size = kw["img_size"]
            assert got.dtype == np.float32 and got.shape == (size, 2 * size if kw["place_on_canvas"] else size), c
            assert np.array_equal(got, ref) and got.sum() > 0, c
            outcomes["mask"] += 1
    assert outcomes["mask"] >= 10 and outcomes["none"] >= 10, outcomes


# ---------------------------------------------------------------------------
# the datasets' training items

CROSS_CASES = [
    dict(img_size=32, constant_place=True, view_mask_rate=0.0, match_mask=True, match_mask_rate=0.5),
    dict(img_size=128, constant_place=False, view_mask_rate=0.0, match_mask=True, match_mask_rate=1.0, flip=True),
    dict(img_size=256, constant_place=True, view_mask_rate=1.0, flip=True),
    dict(img_size=64, constant_place=False, only_mask_image=True),
    dict(img_size=48, constant_place=False, view_mask_rate=0.5, repeat_sp_token=0, sp_token=None,
         token_map={"left_token": "<l>", "right_token": "<r>"}),
]


def _ds_kwargs(tree, case):
    kw = dict(sp_token="<special-token>", repeat_sp_token=4, match_path=tree["match_path"])
    kw.update(case)
    return kw


@pytest.mark.parametrize("case", range(len(CROSS_CASES)))
def test_cross_view_training_items_match_jax(tree, case):
    """Every item of the tree (the random crops, the side draw, the mask,
    the flips, the prompt) under seeds 0 and 1, item after item."""
    kw = _ds_kwargs(tree, CROSS_CASES[case])
    for seed in range(2):
        np.random.seed(seed)
        ref_ds = jd.InpaintingCrossViewDataset(tree["image_path"], tree["train_pair"], tree["train_mask_path"],
                                               mode="train", seed=seed, **kw)
        refs = [ref_ds[i] for i in range(len(ref_ds))]
        ds = td.InpaintingCrossViewDataset(tree["image_path"], tree["train_pair"], tree["train_mask_path"],
                                           mode="train", seed=seed, **kw)
        assert len(ds) == len(refs) == 24
        for i, ref in enumerate(refs):
            _equal(ds[i], ref, (seed, i))
        s = kw["img_size"]
        assert ref["image"].shape == (s, 2 * s, 3) and ref["mask"].shape == (s, 2 * s, 1)


def test_cross_view_items_with_the_photo_match_jax(photo_tree):
    """The 1600x1200 photo beside a 120x160 image at 256: the crop's and the
    square resize's area shrink of the photo, the small image enlarged."""
    kw = dict(img_size=256, constant_place=True, view_mask_rate=0.0, match_mask=True, match_mask_rate=1.0,
              sp_token="<special-token>", repeat_sp_token=4, match_path=photo_tree["match_path"])
    np.random.seed(3)
    args = (photo_tree["image_path"], photo_tree["train_pair"], photo_tree["train_mask_path"])
    ref_ds = jd.InpaintingCrossViewDataset(*args, mode="train", seed=3, **kw)
    refs = [ref_ds[i] for i in range(len(ref_ds))]
    ds = td.InpaintingCrossViewDataset(*args, mode="train", seed=3, **kw)
    for i, ref in enumerate(refs):
        _equal(ds[i], ref, i)


MV_CASES = [
    dict(img_size=32, view_num=4, view_mask_rate=0.0, match_mask=True, match_mask_rate=1.0, constant_place=True),
    dict(img_size=64, view_num=3, view_mask_rate=0.0, match_mask=True, match_mask_rate=0.5, constant_place=False,
         source_shuffle=True),
    dict(img_size=48, view_num=4, view_mask_rate=1.0, concat_target=True, source_shuffle=True),
    dict(img_size=128, view_num=2, view_mask_rate=0.5, repeat_sp_token=0, sp_token=None, view_token_len=3),
]


@pytest.mark.parametrize("case", range(len(MV_CASES)))
def test_multiview_training_items_match_jax(tree, case):
    """Every extended pair's item (per-view crops, the source order, the
    view-0 mask, the view prompts, ``idx``) under seeds 0 and 1."""
    kw = _ds_kwargs(tree, {"view_token_len": 2, **MV_CASES[case]})
    mv = tree["mv_train_pair"]
    for seed in range(2):
        np.random.seed(seed)
        random.seed(seed)  # JAX's view prompts draw their template from the module stream
        ref_ds = jd.InpaintingMultiViewDataset(tree["image_path"], mv, tree["train_mask_path"], mode="train",
                                               seed=seed, **kw)
        refs = [ref_ds[i] for i in range(0, len(ref_ds), 2)]
        ds = td.InpaintingMultiViewDataset(tree["image_path"], mv, tree["train_mask_path"], mode="train", seed=seed,
                                           **kw)
        for i, ref in zip(range(0, len(ds), 2), refs):
            _equal(ds[i], ref, (seed, i))
        v = kw["view_num"] - 1 if kw.get("concat_target") else kw["view_num"]
        assert ref["image"].shape[0] == v and len(ref["txt"]) == v


def test_multiview_pair_with_too_few_sources_raises(tree, tmp_path):
    """JAX fails on the missing source with an IndexError; the port raises
    one too, naming the pair, before reading any view."""
    pairs = pickle.load(open(tree["mv_train_pair"], "rb"))[:2]
    pairs[1] = dict(pairs[1], source=pairs[1]["source"][:1])
    path = str(tmp_path / "short.pkl")
    pickle.dump(pairs, open(path, "wb"))
    kw = dict(img_size=32, view_num=4, sp_token="<special-token>", repeat_sp_token=4, seed=0)
    with pytest.raises(IndexError):
        jd.InpaintingMultiViewDataset(tree["image_path"], path, tree["train_mask_path"], mode="train", **kw)[1]
    ds = td.InpaintingMultiViewDataset(tree["image_path"], path, tree["train_mask_path"], mode="train", **kw)
    assert ds[0]["image"].shape == (4, 32, 32, 3)
    with pytest.raises(IndexError, match="pair 1 .*1 sources, view_num 4 needs 3"):
        ds[1]


@pytest.mark.parametrize("masks", ["both", "one", "none"])
def test_single_image_training_items_match_jax(tree, tmp_path, masks):
    """``InpaintingDataset`` in training: a list file of images, the file
    sampler's half masks (or the strokes without lists), template prompts."""
    images = [os.path.join(tree["val_image_path"], d, "target.jpg") for d in sorted(os.listdir(tree["val_image_path"]))]
    listing = tmp_path / "images.txt"
    listing.write_text("\n".join(images) + "\n")
    mask_path = {"both": tree["train_mask_path"], "one": tree["train_mask_path"][:1], "none": None}[masks]
    kw = dict(img_size=48, repeat_sp_token=0, sp_token=None, token_map={"task_token": "<t>"})
    for seed in range(2):
        random.seed(seed)
        ref_ds = jd.InpaintingDataset(str(listing), mask_path, mode="train", seed=seed, **kw)
        refs = [ref_ds[i] for i in range(len(ref_ds))]
        random.seed(seed)
        ds = td.InpaintingDataset(str(listing), mask_path, mode="train", seed=seed, **kw)
        for i, ref in enumerate(refs):
            _equal(ds[i], ref, (seed, i))


# ---------------------------------------------------------------------------
# the preprocessors

def test_preprocessors_write_jax_pickles(tree, tmp_path):
    """``build_megadepth_pairs`` on the tree's scene-info files (the
    shuffled subset under the same seed) and ``extend_pairs_for_multiview``
    on its pairs: the same pickles, object for object and byte for byte."""
    root = os.path.dirname(tree["match_path"])
    info = os.path.join(root, "scene_info")
    for side, build in (("jax", jp.build_megadepth_pairs), ("port", tp.build_megadepth_pairs)):
        out = str(tmp_path / side)
        if side == "jax":
            random.seed(5)
            counts = build(root, f"{info}/train", f"{info}/test", out)
        else:
            assert build(root, f"{info}/train", f"{info}/test", out, rng=random.Random(5)) == counts
    assert counts == {"images": 10, "train_pairs": 24, "test_pairs": 4}
    for name in ("image_dict", "train_pairs", "test_pairs", "test_pairs_100"):
        ours, ref = (open(tmp_path / side / f"{name}.pkl", "rb").read() for side in ("port", "jax"))
        assert ours == ref and pickle.loads(ours) == pickle.loads(ref), name
    image_dict = pickle.load(open(tmp_path / "jax" / "image_dict.pkl", "rb"))
    train = pickle.load(open(tmp_path / "jax" / "train_pairs.pkl", "rb"))
    for extra, least, sources in ((3, 0.2, {4}), (2, 0.5, {2, 3})):
        args = (f"{info}/train", train, image_dict)
        ref = jp.extend_pairs_for_multiview(*args, str(tmp_path / "jax_mv.pkl"), extra, least)
        got = tp.extend_pairs_for_multiview(*args, str(tmp_path / "mv.pkl"), extra, least)
        assert got == ref and open(tmp_path / "mv.pkl", "rb").read() == open(tmp_path / "jax_mv.pkl", "rb").read()
        assert {len(p["source"]) for p in got} == sources  # at 0.5 some targets lack a second extra view
