"""The datasets of the port's data path (counterpart of
``leftrefill_tpu/data/datasets.py``): the prompt text and the relative
camera pose of novel-view synthesis, the Objaverse novel-view dataset
``NVS_OBJDataset``, the scene-balanced ``BalancedRandomSampler``, the
MegaDepth datasets of reference-guided inpainting
(``InpaintingCrossViewDataset``, ``InpaintingMultiViewDataset``) and the
single-image ``InpaintingDataset``, each in its training and its test mode,
and ``TestInpaintingDataset`` (pair directories of source, target and
mask).  The numpy parts are copies, so the port imports nothing of the JAX
package (``tests/test_torch_isolation.py`` holds them equal to the
originals); the image files (JPEG and PNG) are read and resized through
``data.image_io`` (no OpenCV), the masks drawn by ``data.masks``.  The
random draws come from the dataset's own streams, in JAX's order: a
``random.Random``, and those JAX's code takes from the global ``random``
module and numpy's global stream from a second ``random.Random`` and an
``np.random.RandomState``, all three seeded by ``seed``."""

from __future__ import annotations

import collections
import math
import os
import pickle
import random
from glob import glob
from typing import Optional

import numpy as np

from leftrefill_torch.data.image_io import IMREAD_COLOR, INTER_AREA, INTER_NEAREST, imread, read_png, resize
from leftrefill_torch.data.masks import FileMaskSampler, load_mask_file, match_based_mask, nvs_object_mask

PROMPT_TEMPLATES = [
    "Both {left} and {right} images show the {real} with different {task}.",
    "The {real} remains the same in both the {left} and {right} images, but the {task} are different.",
    "The {left} and {right} images depict identical {real}, but from different {task}.",
    "The painting depicts the {real}, but from two different {task}; one from the {left} and one from the {right}.",
    "Both figures capture the same {real}, but the {left} one and the {right} one are taken from different {task}.",
    "The two drawings show the {real}, but one is from the {left} side and the other is from the {right} side, and they are from different {task}",
    "Both pictures depict the same {real}, but the {left} image and the {right} image are captured with different {task}.",
]


def build_prompt(
    repeat_sp_token: int,
    sp_token: Optional[str],
    token_map: Optional[dict] = None,
    mode: str = "train",
    deep_prompt: bool = False,
    cross_attn_layers: int = 16,
    rng: random.Random | None = None,
):
    """The repeated special-token prompt ("<t0> <t1> ..."), its per-layer
    variants for deep_prompt, or one of the 7 natural-language templates
    (the first outside training)."""
    if repeat_sp_token > 0 and sp_token is not None:
        text = " ".join(sp_token.replace(">", f"{i}>") for i in range(repeat_sp_token))
        if deep_prompt:
            return [text.replace(">", f"-layer{i}>") for i in range(cross_attn_layers)]
        return text
    tm = token_map or {}
    templates = [
        t.format(
            left=tm.get("left_token", "<left>"),
            right=tm.get("right_token", "<right>"),
            task=tm.get("task_token", "<viewpoints>"),
            real=tm.get("real_token", "<same-scene>"),
        )
        for t in PROMPT_TEMPLATES
    ]
    if mode == "train":
        return (rng or random).choice(templates)
    return templates[0]


def cartesian_to_spherical(xyz: np.ndarray) -> np.ndarray:
    """[N, 3] points -> [3, N] (polar angle, azimuth, radius)."""
    xy = xyz[:, 0] ** 2 + xyz[:, 1] ** 2
    z = np.sqrt(xy + xyz[:, 2] ** 2)
    theta = np.arctan2(np.sqrt(xy), xyz[:, 2])
    azimuth = np.arctan2(xyz[:, 1], xyz[:, 0])
    return np.array([theta, azimuth, z])


def get_relative_pose(target_RT: np.ndarray, cond_RT: np.ndarray) -> np.ndarray:
    """(dtheta, sin dphi, cos dphi, dz) float32 from two [3, 4] world-to-camera
    matrices: the cameras' centres in spherical coordinates, target minus
    condition."""
    R, T = target_RT[:3, :3], target_RT[:, -1]
    t_target = -R.T @ T
    R, T = cond_RT[:3, :3], cond_RT[:, -1]
    t_cond = -R.T @ T
    th_c, az_c, z_c = cartesian_to_spherical(t_cond[None])
    th_t, az_t, z_t = cartesian_to_spherical(t_target[None])
    d_theta = th_t - th_c
    d_az = (az_t - az_c) % (2 * math.pi)
    d_z = z_t - z_c
    return np.array(
        [d_theta.item(), math.sin(d_az.item()), math.cos(d_az.item()), d_z.item()],
        np.float32,
    )


class NVS_OBJDataset:
    """Objaverse renders for novel-view synthesis: each line of ``listfile``
    names an object folder under ``datapath`` holding ``nviews`` RGBA views
    ``%03d.png`` and their [3, 4] world-to-camera matrices ``%03d.npy``.
    An item is a target view and a condition view (two random views in
    training, views 0 and 2 otherwise) with the transparent background made
    white, stitched [condition | target] at ``img_size``, the target's
    training mask (``masks.nvs_object_mask``; in evaluation the mask file of
    ``mask_file_path`` or, ``mask_type="complete"``, the whole view), the
    masked canvas, the relative pose and the prompt.  ``seed`` seeds both
    random streams (the view pair and mask from a ``random.Random``, the
    polyline from an ``np.random.RandomState``); the mask curriculum sets
    ``complete_mask_rate`` on the live dataset."""

    def __init__(
        self,
        datapath,
        listfile,
        mode="train",
        img_size=512,
        nviews=12,
        token_map=None,
        test_limit=150,
        dilate_size=(8, 20),
        pts_size=(15, 30),
        mask_enlarge=(0.0, 0.0),
        mask_file_path=None,
        mask_type="fix",
        width_range=(60, 120),
        complete_mask_rate=0.0,
        use_ref_mask=False,
        seed: Optional[int] = None,
        **kwargs,
    ):
        self.rng = random.Random(seed) if seed is not None else random.Random()
        self.np_rng = np.random.RandomState(seed)
        with open(listfile) as f:
            self.metas = [os.path.join(datapath, line.strip()) for line in f.readlines()]
        if mode == "val" and test_limit < len(self.metas):
            self.metas = self.metas[:: len(self.metas) // test_limit]
        self.mode = mode
        self.img_size = img_size
        self.nviews = nviews
        self.token_map = token_map
        self.repeat_sp_token = kwargs.get("repeat_sp_token", 0)
        self.sp_token = kwargs.get("sp_token")
        self.deep_prompt = kwargs.get("deep_prompt", False)
        self.dilate_size = dilate_size
        self.pts_size = pts_size
        self.mask_enlarge = mask_enlarge
        self.mask_file_path = mask_file_path
        self.mask_type = mask_type
        self.width_range = width_range
        self.complete_mask_rate = complete_mask_rate
        self.use_ref_mask = use_ref_mask
        self.warmup_mask_steps = kwargs.get("warmup_mask_steps", 0)

    def __len__(self):
        return len(self.metas)

    def _load_view(self, filename: str, index: int):
        """(RGB uint8 with the transparent pixels white, the alpha > 0 mask
        as float32).  JAX's code takes the render through float64 (x / 255
        * 255, truncated), which gives every uint8 value back: a uint8
        render is read in uint8; a 16-bit one takes JAX's float64 route."""
        path = os.path.join(filename, "%03d.png" % index)
        raw = read_png(path)
        if raw.ndim != 3 or raw.shape[2] != 4:
            raise ValueError(f"{path}: an RGBA render is expected, got shape {raw.shape}")
        if raw.dtype == np.uint8:
            alpha = raw[:, :, 3]
            white = (alpha == 0).view(np.uint8) * np.uint8(255)  # x | 255 = 255, x | 0 = x
            return raw[:, :, :3] | white[:, :, None], (alpha > 0).astype(np.float32)
        im = raw / 255.0
        alpha_mask = im[:, :, -1].copy()
        alpha_mask[alpha_mask > 0] = 1
        im[im[:, :, -1] == 0.0] = [1.0, 1.0, 1.0, 1.0]
        rgb = (im[:, :, :3] * 255.0).astype(np.uint8)
        return rgb, alpha_mask.astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        filename = self.metas[idx]
        s = self.img_size
        if self.mode == "train":
            index_target, index_cond = self.rng.sample(range(self.nviews), 2)
        else:
            index_target, index_cond = 0, 2

        target_im, mask = self._load_view(filename, index_target)
        cond_im, _ = self._load_view(filename, index_cond)
        target_im = resize(target_im, (s, s))
        cond_im = resize(cond_im, (s, s))
        mask = resize(mask, (s, s), INTER_AREA)
        mask[mask > 0] = 1

        if self.mask_file_path is not None and self.mode != "train" and self.mask_type == "fix":
            i = index_cond if self.use_ref_mask else index_target
            m = read_png(os.path.join(self.mask_file_path, filename.split("/")[-1], "%03d.png" % i))
            # the first channel of OpenCV's BGR read: grey, or the blue channel
            mask = ((m if m.ndim == 2 else m[:, :, 2]) / 255.0).astype(np.float32)
        elif self.mode != "train" and self.mask_type == "complete":
            mask = np.ones((s, s), np.float32)
        else:
            mask = nvs_object_mask(
                mask, s, self.dilate_size, self.pts_size, self.mask_enlarge,
                self.width_range, self.complete_mask_rate, self.rng, self.np_rng,
            )

        image = np.concatenate([cond_im, target_im], axis=1)
        mask = np.concatenate([np.zeros_like(mask), mask], axis=1)
        image = (image.astype(np.float32) / 127.5) - 1.0
        mask = mask[:, :, None].astype(np.float32)
        if self.mode != "train" and self.use_ref_mask:
            masked = np.concatenate([cond_im, np.ones_like(cond_im) * 255], axis=1)
            masked = (masked.astype(np.float32) / 127.5) - 1.0
            masked_image = masked * (mask < 0.5)
        else:
            masked_image = image * (mask < 0.5)

        target_RT = np.load(os.path.join(filename, "%03d.npy" % index_target))
        cond_RT = np.load(os.path.join(filename, "%03d.npy" % index_cond))
        return dict(
            image=image,
            masked_image=masked_image,
            mask=mask,
            rel_pose=get_relative_pose(target_RT, cond_RT),
            txt=build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode),
        )


def _read_rgb(path: str) -> np.ndarray:
    """A colour read, RGB (OpenCV's BGR read then BGR -> RGB)."""
    return imread(path, IMREAD_COLOR)


def _find_image(path_no_ext: str) -> str:
    """``path_no_ext`` + ".jpg" or, failing that, ".png" (".jpg" where
    neither exists, so that the read names the missing file)."""
    for ext in (".jpg", ".png"):
        if os.path.exists(path_no_ext + ext):
            return path_no_ext + ext
    return path_no_ext + ".jpg"


def _read_list(path: str) -> list[str]:
    with open(path) as f:
        return sorted((line.strip() for line in f.readlines()), key=lambda x: x.split("/")[-1])


def _sorted_dir(path: str) -> list[str]:
    return sorted(glob(path + "/*"), key=lambda x: x.split("/")[-1])


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _streams(seed: Optional[int]):
    """(the dataset's ``random.Random``, the stream JAX's code takes from the
    global ``random`` module, the ``RandomState`` that stands for numpy's
    global stream).  Without a seed JAX's dataset draws from the global
    module itself, so the first two are one stream."""
    rng = random.Random(seed) if seed is not None else random.Random()
    return rng, (random.Random(seed) if seed is not None else rng), np.random.RandomState(seed)


class InpaintingCrossViewDataset:
    """MegaDepth reference-guided inpainting pairs.

    Training (``mode="train"``): ``image_path`` and ``pair_path`` are the
    pickles of ``data.preprocess.build_megadepth_pairs`` (image id -> file,
    and the pairs {"source", "target"} of ids).  Each view is resized to
    ``img_size`` (area), or, with chance 1/2, its short side resized to
    ``img_size`` (area) and a random square cropped (``crop_info``); the
    canvas is [source | target] (the sides swapped with chance 1/2 unless
    ``constant_place``); the mask is the whole target view
    (``only_mask_image``), or with chance 1 - ``view_mask_rate`` a training
    mask (with chance ``match_mask_rate`` the match-based mask of
    ``match_path/%08d.pkl`` where that file exists and gives one, else a
    ``FileMaskSampler`` mask from the two lists of ``mask_path`` on a random
    side), else a whole random side; ``flip`` mirrors each side with chance
    1/2.  ``seed`` seeds the draws (a ``random.Random``, and an
    ``np.random.RandomState`` for those JAX's code takes from numpy's
    global stream).

    Test mode: each pair directory (``image_path`` a directory of them,
    thinned to about ``test_limit``, or a pair of list files read second
    then first up to ``test_limit`` lines) holds ``source`` and ``target``
    (.jpg, else .png), resized to ``img_size`` (area), stitched [source |
    target], and ``mask.png`` or the ``mask_path`` directory's file of that
    index, read grey, > 127, on the right half."""

    def __init__(
        self,
        image_path,
        pair_path,
        mask_path,
        mode: str = "train",
        img_size: int = 256,
        only_mask_image: bool = False,
        token_map: Optional[dict] = None,
        view_mask_rate: float = 0.9,
        test_limit: int = 150,
        flip: bool = False,
        constant_place: bool = False,
        seed: Optional[int] = None,
        **kwargs,
    ):
        """``kwargs``: the data config's other keys (``repeat_sp_token``,
        ``sp_token``, ``deep_prompt``, ``match_mask``, ``match_mask_rate``
        and ``match_path`` are read)."""
        self.rng, self.py_rng, self.np_rng = _streams(seed)
        if mode == "train":
            self.image_dict = _load_pickle(image_path)
            self.pairs = _load_pickle(pair_path)
        elif isinstance(image_path, str) and os.path.isdir(image_path):  # JAX's isdir raises on the list form
            self.pairs = _sorted_dir(image_path)
            self.pairs = self.pairs[:: max(len(self.pairs) // test_limit, 1)]
        else:
            files = []
            with open(image_path[1]) as f:
                files.extend(f.readlines())
            with open(image_path[0]) as f:
                files.extend(f.readlines()[: test_limit - len(files)])
            self.pairs = [p.strip() for p in files]
        self.mode = mode
        self.img_size = img_size
        self.only_mask_image = only_mask_image
        self.token_map = token_map
        self.view_mask_rate = view_mask_rate
        self.repeat_sp_token = kwargs.get("repeat_sp_token", 0)
        self.sp_token = kwargs.get("sp_token")
        self.match_mask = kwargs.get("match_mask", False)
        self.match_mask_rate = kwargs.get("match_mask_rate", 0.0)
        self.match_path = kwargs.get("match_path")
        self.deep_prompt = kwargs.get("deep_prompt", False)
        self.cross_attn_layers = 16
        self.flip = flip
        self.constant_place = constant_place
        if mode == "train":
            self.mask_sampler = FileMaskSampler(_read_list(mask_path[0]), _read_list(mask_path[1]), img_size,
                                                self.rng)
            self.mask_list = None
        else:
            # mask_path may be omitted when every pair directory holds a mask.png
            self.mask_list = _sorted_dir(mask_path) if mask_path else None
            self.mask_sampler = None

    def __len__(self):
        return len(self.pairs)

    def resize_and_crop(self, image: np.ndarray):
        """(the view at img_size x img_size, its crop_info or None): in
        training with chance 1/2 the short side resized to img_size (area)
        and a random square cropped, crop_info {"w_start", "h_start", "w",
        "h"} (the crop's corner, the resized size); else a resize (area)."""
        crop_info = None
        s = self.img_size
        if self.mode == "train" and self.rng.random() >= 0.5:
            h, w, _ = image.shape
            if h < w:
                long_side = max(s, int(w * (s / h)))
                image = resize(image, (long_side, s), INTER_AREA)
            else:
                long_side = max(s, int(h * (s / w)))
                image = resize(image, (s, long_side), INTER_AREA)
            rh, rw, _ = image.shape
            w_start = self.rng.randint(0, image.shape[1] - s)
            h_start = self.rng.randint(0, image.shape[0] - s)
            image = image[h_start: h_start + s, w_start: w_start + s]
            crop_info = {"w_start": w_start, "h_start": h_start, "w": rw, "h": rh}
        else:
            image = resize(image, (s, s), INTER_AREA)
        return image, crop_info

    def _match_result(self, idx: int) -> Optional[dict]:
        """The matcher's output for pair ``idx`` when the match-mask draw
        takes it and its file exists (a draw only with ``match_mask``)."""
        if self.match_mask and self.rng.random() < self.match_mask_rate:
            pkl_name = os.path.join(self.match_path or "", str(idx).zfill(8) + ".pkl")
            if os.path.exists(pkl_name):
                return _load_pickle(pkl_name)
        return None

    def load_mask(self, idx, gt_pos, target_crop_info, source_crop_info) -> np.ndarray:
        """The training mask of pair ``idx`` on the canvas: the match-based
        mask where drawn and possible, else the file sampler's."""
        res = self._match_result(idx)
        if res is not None:
            mask = match_based_mask(res, self.img_size, gt_pos, self.constant_place, target_crop_info,
                                    source_crop_info, self.rng, np_rng=self.np_rng)
            if mask is not None:
                return mask
        return self.mask_sampler.sample_canvas()

    def _mask_file(self, pair: str, idx: int) -> str:
        mask_file = pair + "/mask.png"
        if not os.path.exists(mask_file):
            mask_file = self.mask_list[idx % len(self.mask_list)]
        return mask_file

    def __getitem__(self, idx: int) -> dict:
        pair = self.pairs[idx]
        train = self.mode == "train"
        if train:
            source_filename = self.image_dict[pair["source"]]
            target_filename = self.image_dict[pair["target"]]
        else:
            source_filename = _find_image(pair + "/source")
            target_filename = _find_image(pair + "/target")
        source, source_crop_info = self.resize_and_crop(_read_rgb(source_filename))
        target, target_crop_info = self.resize_and_crop(_read_rgb(target_filename))

        # the side draw is taken in training even where constant_place ignores it
        if train and self.rng.random() < 0.5 and not self.constant_place:
            gt_pos = "left"
            image = np.concatenate([target, source], axis=1)
        else:
            gt_pos = "right"
            image = np.concatenate([source, target], axis=1)

        s = self.img_size
        if not train:
            half = load_mask_file(self._mask_file(pair, idx), s)
            mask = np.concatenate([np.zeros_like(half), half], axis=1)
        elif self.only_mask_image:
            mask = np.zeros((s, 2 * s), np.float32)
            if gt_pos == "left":
                mask[:, :s] = 1
            else:
                mask[:, s:] = 1
        elif self.rng.random() < 1.0 - self.view_mask_rate:
            mask = self.load_mask(idx, gt_pos, target_crop_info, source_crop_info)
        else:
            mask = np.zeros((s, 2 * s), np.float32)
            if self.rng.random() < 0.5:
                mask[:, :s] = 1
            else:
                mask[:, s:] = 1

        if train and self.flip:
            if self.rng.random() < 0.5:
                image[:, :s] = image[:, :s][:, ::-1]
                mask[:, :s] = mask[:, :s][:, ::-1]
            if self.rng.random() < 0.5:
                image[:, s:] = image[:, s:][:, ::-1]
                mask[:, s:] = mask[:, s:][:, ::-1]

        image = (image.astype(np.float32) / 127.5) - 1.0
        mask = mask[:, :, None].astype(np.float32)
        prompt = build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode,
                              self.deep_prompt, self.cross_attn_layers, self.rng)
        return dict(image=image, txt=prompt, masked_image=image * (mask < 0.5), mask=mask)


class InpaintingMultiViewDataset(InpaintingCrossViewDataset):
    """Target + (view_num - 1) reference views as a 5-D stack (V, H, W, C)
    with only view 0 masked (``concat_target``: V - 1 canvases [source j |
    target]), per-view prompts with ``<view_direct-j-l>`` suffixes.

    Training: the pairs of ``data.preprocess.extend_pairs_for_multiview``
    ({"target": [id], "source": [ids], "idx"}), each view resized or
    randomly cropped as the cross-view dataset's, the sources in a random
    order with ``source_shuffle``; the mask of view 0 with chance 1 -
    ``view_mask_rate`` the match-based mask of the pair's ``idx`` (the one
    view's, not placed on a canvas) or a ``FileMaskSampler`` mask, else the
    whole view.  A pair with fewer than view_num - 1 sources raises.

    Test mode: a pair directory's ``target`` and ``source``, ``source_1`` ..
    ``source_3``, and ``idx`` the directory's number where its name is one."""

    def __init__(self, *args, **kwargs):
        self.view_num = kwargs.pop("view_num", 4)
        self.view_token_len = kwargs.pop("view_token_len", 30)
        self.source_shuffle = kwargs.pop("source_shuffle", False)
        self.concat_target = kwargs.pop("concat_target", False)
        super().__init__(*args, **kwargs)

    def get_view_prompts(self) -> list[str]:
        """Per-view prompts with <view_direct-j-l> suffixes (the closing '>'
        is in the dataset's strings; the tokenizer's table lacks it, so the
        dataset token matches the table's prefix).  A template prompt is
        drawn from the stream of JAX's global ``random``."""
        base = build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode, rng=self.py_rng)
        n = self.view_num - 1 if self.concat_target else self.view_num
        prompts = []
        for j in range(n):
            t = base
            for l in range(self.view_token_len):
                t = t + f"<view_direct-{j}-{l}>"
            prompts.append(t)
        return prompts

    def _view_mask(self, pair_idx: int, target_crop_info) -> np.ndarray:
        """The training mask of view 0 ([s, s])."""
        s = self.img_size
        if self.rng.random() >= 1.0 - self.view_mask_rate:
            return np.ones((s, s), np.float32)
        mask = None
        res = self._match_result(pair_idx)
        if res is not None:
            mask = match_based_mask(res, s, "right", self.constant_place, target_crop_info, None, self.rng,
                                    place_on_canvas=False, np_rng=self.np_rng)
        return self.mask_sampler.sample_half() if mask is None else mask

    def __getitem__(self, idx: int) -> dict:
        pair = self.pairs[idx]
        s = self.img_size
        train = self.mode == "train"
        if train:
            if len(pair["source"]) < self.view_num - 1:
                raise IndexError(f"pair {idx} {pair}: {len(pair['source'])} sources, view_num {self.view_num} "
                                 f"needs {self.view_num - 1}")
            target_filename = self.image_dict[pair["target"][0]]
            source_filenames = [self.image_dict[i] for i in pair["source"]]
            pair_idx = pair.get("idx", idx) if isinstance(pair, dict) else idx
        else:
            source_filenames = [_find_image(pair + name) for name in ("/source", "/source_1", "/source_2",
                                                                      "/source_3")]
            target_filename = _find_image(pair + "/target")
        target, target_crop_info = self.resize_and_crop(_read_rgb(target_filename))
        if self.source_shuffle:
            order = self.np_rng.choice(self.view_num - 1, self.view_num - 1, replace=False)
        else:
            order = range(self.view_num - 1)
        sources = [self.resize_and_crop(_read_rgb(source_filenames[i]))[0] for i in order]
        image = np.array([target, *sources])
        mask = self._view_mask(pair_idx, target_crop_info) if train else load_mask_file(self._mask_file(pair, idx), s)

        image = (image.astype(np.float32) / 127.5) - 1.0
        mask = mask[:, :, None].astype(np.float32)
        masked_image = image.copy()
        masked_image[0] = masked_image[0] * (mask < 0.5)
        final_mask = np.repeat(mask[None], len(image), axis=0)
        final_mask[1:] = 0

        if self.concat_target:
            v = self.view_num - 1
            ci = np.zeros((v, s, 2 * s, 3), np.float32)
            cm = np.zeros((v, s, 2 * s, 3), np.float32)
            cmask = np.zeros((v, s, 2 * s, 1), np.float32)
            for i in range(len(sources)):
                ci[i, :, s:] = image[0]
                ci[i, :, :s] = image[i + 1]
                cm[i, :, s:] = masked_image[0]
                cm[i, :, :s] = masked_image[i + 1]
                cmask[i, :, s:] = final_mask[0]
                cmask[i, :, :s] = final_mask[i + 1]
            image, masked_image, final_mask = ci, cm, cmask

        if not train:
            name = str(pair).split("/")[-1]
            pair_idx = int(name) if name.isdigit() else idx
        return dict(image=image, txt=self.get_view_prompts(), masked_image=masked_image, mask=final_mask,
                    idx=pair_idx)


class InpaintingDataset:
    """Plain single-image inpainting / outpainting: each image (a
    directory's files, or a list file's lines; outside training thinned to
    about ``test_limit``) resized to ``img_size`` (area).  Training masks
    come from a ``FileMaskSampler`` over ``mask_path``'s lists (either or
    both may be missing: ``random_stroke_mask`` without any); outside
    training the right ``right_strip_frac`` of the image is masked."""

    def __init__(
        self,
        image_path,
        mask_path,
        mode: str = "train",
        img_size: int = 256,
        token_map: Optional[dict] = None,
        test_limit: int = 150,
        right_strip_frac: float = 0.5,
        seed: Optional[int] = None,
        **kwargs,
    ):
        self.rng, self.py_rng, _ = _streams(seed)
        if os.path.isdir(image_path):
            self.files = sorted(glob(image_path + "/*"))
        else:
            with open(image_path) as f:
                self.files = [line.strip() for line in f.readlines()]
        if mode != "train" and len(self.files) > test_limit:
            self.files = self.files[:: len(self.files) // test_limit]
        self.mode = mode
        self.img_size = img_size
        self.token_map = token_map
        self.repeat_sp_token = kwargs.get("repeat_sp_token", 0)
        self.sp_token = kwargs.get("sp_token")
        self.right_strip_frac = right_strip_frac
        self.mask_sampler = None
        if mode == "train":
            self.mask_sampler = FileMaskSampler(
                _read_list(mask_path[0]) if mask_path else None,
                _read_list(mask_path[1]) if mask_path and len(mask_path) > 1 else None,
                img_size, self.rng)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        s = self.img_size
        image = resize(_read_rgb(self.files[idx]), (s, s), INTER_AREA)
        if self.mode == "train":
            mask = self.mask_sampler.sample_half()
        else:
            mask = np.zeros((s, s), np.float32)
            mask[:, int(s * (1 - self.right_strip_frac)):] = 1
        image = (image.astype(np.float32) / 127.5) - 1.0
        mask = mask[:, :, None].astype(np.float32)
        prompt = build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode, rng=self.py_rng)
        return dict(image=image, txt=prompt, masked_image=image * (mask < 0.5), mask=mask)


class TestInpaintingDataset:
    """Directories of {source, target, mask} (``root_path`` a directory of
    them or a list file): source and target resized to ``img_size`` (area)
    and stitched, the mask the first channel of OpenCV's colour read of
    ``mask.png`` (or of the ``mask_path`` directory's file of that index),
    resized (nearest) and scaled to [0, 1] without a threshold, on the right
    half."""

    __test__ = False  # not a pytest class

    def __init__(self, root_path, img_size=256, token_map=None, mask_path=None, **kwargs):
        self.img_size = img_size
        self.token_map = token_map
        if os.path.isdir(root_path):
            self.pairs = _sorted_dir(root_path)
        else:
            with open(root_path) as f:
                self.pairs = [p.strip() for p in f.readlines()]
        self.mask_list = _sorted_dir(mask_path) if mask_path else None
        self.repeat_sp_token = kwargs.get("repeat_sp_token", 0)
        self.sp_token = kwargs.get("sp_token")
        self.deep_prompt = kwargs.get("deep_prompt", False)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> dict:
        pair = self.pairs[idx]
        s = self.img_size
        source = resize(_read_rgb(_find_image(pair + "/source")), (s, s), INTER_AREA)
        target = resize(_read_rgb(_find_image(pair + "/target")), (s, s), INTER_AREA)
        image = np.concatenate([source, target], axis=1)
        image = (image.astype(np.float32) / 127.5) - 1.0
        mask_file = pair + "/mask.png" if self.mask_list is None else self.mask_list[idx % len(self.mask_list)]
        mask = _read_rgb(mask_file)[:, :, 2]  # OpenCV's BGR read's first channel: blue
        mask = resize(mask, (s, s), INTER_NEAREST)
        mask = (mask.astype(np.float32) / 255.0)[:, :, None]
        mask = np.concatenate([np.zeros_like(mask), mask], axis=1)
        return dict(image=image,
                    txt=build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, "test", self.deep_prompt),
                    masked_image=image * (mask < 0.5), mask=mask)


class BalancedRandomSampler:
    """Scene-bucketed, epoch-seeded, rank-strided index sampler (a copy of
    the JAX package's): each epoch, ``n_sample_per_scene`` pairs of every
    scene (``image_dict[source]``'s third-last path part) shuffled with
    ``random.Random(epoch)``, all of them shuffled, then every
    ``num_replicas``-th from ``rank``."""

    def __init__(self, image_dict, pairs, n_sample_per_scene=100, rank=0, num_replicas=1):
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"Invalid rank {rank}, rank should be in the interval [0, {num_replicas - 1}]"
            )
        self.n_sample_per_scene = n_sample_per_scene
        self.rank = rank
        self.num_replicas = num_replicas
        self.epoch = 0
        self.scene_idx = collections.defaultdict(list)
        for i, p in enumerate(pairs):
            src = p["source"][0] if isinstance(p["source"], (list, tuple)) else p["source"]
            scene = image_dict[src].split("/")[-3]
            self.scene_idx[scene].append(i)
        for scene in self.scene_idx:
            if n_sample_per_scene > len(self.scene_idx[scene]):
                raise ValueError(
                    "n_sample_per_scene should be less than the min scene sample "
                    f"but got {n_sample_per_scene}>{len(self.scene_idx[scene])}"
                )
        self.n_scene = len(self.scene_idx)
        total_size = self.n_scene * self.n_sample_per_scene
        if total_size % num_replicas != 0:
            self.num_samples = math.ceil((total_size - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(total_size / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        rng = random.Random(self.epoch)
        new_list = []
        for scene in self.scene_idx:
            idxs = list(self.scene_idx[scene])
            rng.shuffle(idxs)
            self.scene_idx[scene] = idxs
            new_list.extend(idxs[: self.n_sample_per_scene])
        rng.shuffle(new_list)
        indices = new_list[: self.total_size]
        if len(indices) != self.total_size:
            raise RuntimeError(f"{len(indices)} indices, expected {self.total_size}")
        return iter(indices[self.rank: self.total_size: self.num_replicas])

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
