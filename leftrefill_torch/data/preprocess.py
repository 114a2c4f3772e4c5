"""The offline preprocessors of the MegaDepth training data (counterpart of
``leftrefill_tpu/data/preprocess.py``, numpy and ``pickle`` only):

- ``build_megadepth_pairs``: the LoFTR scene-info ``.npz`` files (each with
  ``pair_infos`` [((i0, i1), overlap, ...)] and ``image_paths``) ->
  ``image_dict.pkl`` (image id -> ``root_path``/file), ``train_pairs.pkl``
  (the training scenes' pairs with an overlap in [lo, hi]),
  ``test_pairs.pkl`` (every test pair) and ``test_pairs_100.pkl`` (100 of
  them, shuffled);
- ``extend_pairs_for_multiview``: each pair's target with its source and up
  to ``extra_views`` more views of the scene that overlap the target by at
  least ``min_overlap`` (the most overlapping first), for the multi-view
  dataset."""

from __future__ import annotations

import os
import pickle
import random
from glob import glob
from typing import Optional

import numpy as np

PROMPT = "[REFERENCE_INPAINTING]"


def build_megadepth_pairs(
    root_path: str,
    train_info_path: str,
    test_info_path: str,
    out_path: str,
    overlap: tuple[float, float] = (0.4, 0.7),
    rng: Optional[random.Random] = None,
) -> dict:
    """Write the four pickles under ``out_path``; image ids are given in the
    order the images are first met (training scenes first, each scene's
    ``.npz`` files sorted by name).  ``rng`` shuffles the 100-pair subset
    (seeded as the JAX package's global ``random``, the same subset).
    Returns the counts {"images", "train_pairs", "test_pairs"}."""
    img_name_to_id: dict[str, int] = {}
    img_id_to_name: dict[int, str] = {}

    def intern(name: str) -> int:
        if name not in img_name_to_id:
            idx = len(img_name_to_id)
            img_name_to_id[name] = idx
            img_id_to_name[idx] = os.path.join(root_path, name)
        return img_name_to_id[name]

    def collect(info_path: str, filter_overlap: bool) -> list[dict]:
        pairs = []
        for f in sorted(glob(f"{info_path}/*.npz")):
            scene_info = np.load(f, allow_pickle=True)
            pair_infos = scene_info["pair_infos"]
            image_paths = scene_info["image_paths"]
            for idx in range(len(pair_infos)):
                (idx0, idx1), score, _ = pair_infos[idx]
                if filter_overlap and (score < overlap[0] or score > overlap[1]):
                    continue
                pairs.append({"source": intern(image_paths[idx0]), "target": intern(image_paths[idx1]),
                              "prompt": PROMPT})
        return pairs

    train_set = collect(train_info_path, filter_overlap=True)
    test_set = collect(test_info_path, filter_overlap=False)

    os.makedirs(out_path, exist_ok=True)
    for name, obj in (("image_dict", img_id_to_name), ("train_pairs", train_set), ("test_pairs", test_set)):
        with open(f"{out_path}/{name}.pkl", "wb") as w:
            pickle.dump(obj, w)
    subset = list(test_set)
    (rng or random.Random()).shuffle(subset)
    with open(f"{out_path}/test_pairs_100.pkl", "wb") as w:
        pickle.dump(subset[:100], w)
    return {"images": len(img_id_to_name), "train_pairs": len(train_set), "test_pairs": len(test_set)}


def extend_pairs_for_multiview(
    info_path: str,
    pairs: list[dict],
    image_dict: dict[int, str],
    out_file: str,
    extra_views: int = 3,
    min_overlap: float = 0.2,
) -> list[dict]:
    """Write and return the extended pairs {"target": [tid], "source": [sid,
    extra ...], "idx": i}: the scene-info files' images are matched to
    ``image_dict``'s ids by their path (or its last parts), the extra views
    are those overlapping the target by at least ``min_overlap``, the most
    overlapping first."""
    suffix_to_id: dict[str, int] = {}
    for i, full in image_dict.items():
        suffix_to_id[full] = i
        parts = full.split("/")
        for k in range(1, min(len(parts), 6)):
            suffix_to_id.setdefault("/".join(parts[-k:]), i)

    overlap_of: dict[tuple[int, int], float] = {}
    for f in sorted(glob(f"{info_path}/*.npz")):
        scene_info = np.load(f, allow_pickle=True)
        pair_infos = scene_info["pair_infos"]
        image_paths = scene_info["image_paths"]
        for idx in range(len(pair_infos)):
            (i0, i1), score, _ = pair_infos[idx]
            a = suffix_to_id.get(str(image_paths[i0]))
            b = suffix_to_id.get(str(image_paths[i1]))
            if a is None or b is None:
                continue
            overlap_of[(a, b)] = float(score)
            overlap_of[(b, a)] = float(score)

    extended = []
    for i, p in enumerate(pairs):
        src, tgt = p["source"], p["target"]
        candidates = [(s, ov) for (a, s), ov in overlap_of.items() if a == tgt and s not in (src, tgt)
                      and ov >= min_overlap]
        candidates.sort(key=lambda x: -x[1])
        extra = [s for s, _ in candidates[:extra_views]]
        extended.append({"target": [tgt], "source": [src] + extra, "idx": i})
    with open(out_file, "wb") as w:
        pickle.dump(extended, w)
    return extended
