"""The datasets of the port's data path (counterpart of
``leftrefill_tpu/data/datasets.py``): the prompt text and the relative
camera pose of novel-view synthesis, the Objaverse novel-view dataset
``NVS_OBJDataset``, the scene-balanced ``BalancedRandomSampler``, and the
evaluation datasets of inpainting: ``TestInpaintingDataset`` (pair
directories of source, target and mask), the MegaDepth
``InpaintingCrossViewDataset`` and ``InpaintingMultiViewDataset`` and the
single-image ``InpaintingDataset``, the last three in their test mode.  The
numpy parts are copies, so the port imports nothing of the JAX package
(``tests/test_torch_isolation.py`` holds them equal to the originals); the
image files (JPEG and PNG) are read and resized through ``data.image_io``
(no OpenCV), the masks drawn by ``data.masks``.  The training modes of the
MegaDepth and single-image datasets need the training masks (the mask-file
sampler and the match-based masks), which the port does not have yet: they
raise."""

from __future__ import annotations

import collections
import math
import os
import random
from glob import glob
from typing import Optional

import numpy as np

from leftrefill_torch.data.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE, INTER_AREA, INTER_NEAREST, imread, \
    read_png, resize
from leftrefill_torch.data.masks import nvs_object_mask

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
        as float32)."""
        path = os.path.join(filename, "%03d.png" % index)
        raw = read_png(path)
        if raw.ndim != 3 or raw.shape[2] != 4:
            raise ValueError(f"{path}: an RGBA render is expected, got shape {raw.shape}")
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


def _training_masks(name: str):
    raise NotImplementedError(f"{name} in training mode: the training masks (the mask-file sampler "
                              "FileMaskSampler and match_based_mask) are not ported yet; test mode reads")


def _half_mask(mask_file: str, s: int) -> np.ndarray:
    """A mask file read grey, resized to s x s (nearest), > 127 -> 1."""
    half = resize(imread(mask_file, IMREAD_GRAYSCALE), (s, s), INTER_NEAREST)
    return (half > 127).astype(np.float32)


class InpaintingCrossViewDataset:
    """MegaDepth reference-guided inpainting pairs, test mode: each pair
    directory (``image_path`` a directory of them, thinned to about
    ``test_limit``, or a pair of list files read second then first up to
    ``test_limit`` lines) holds ``source`` and ``target`` (.jpg, else .png),
    resized to ``img_size`` (area), stitched [source | target], and
    ``mask.png`` or the ``mask_path`` directory's file of that index, read
    grey, > 127, on the right half."""

    def __init__(
        self,
        image_path,
        pair_path,
        mask_path,
        mode: str = "train",
        img_size: int = 256,
        token_map: Optional[dict] = None,
        test_limit: int = 150,
        **kwargs,
    ):
        """``kwargs``: the data config's other keys (the training mode's
        masks, crops, flips and side swaps; ``repeat_sp_token``,
        ``sp_token`` and ``deep_prompt`` are read)."""
        if mode == "train":
            _training_masks(type(self).__name__)
        if isinstance(image_path, str) and os.path.isdir(image_path):  # JAX's isdir raises on the list form
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
        self.token_map = token_map
        self.repeat_sp_token = kwargs.get("repeat_sp_token", 0)
        self.sp_token = kwargs.get("sp_token")
        self.deep_prompt = kwargs.get("deep_prompt", False)
        self.cross_attn_layers = 16
        # mask_path may be omitted when every pair directory holds a mask.png
        self.mask_list = _sorted_dir(mask_path) if mask_path else None

    def __len__(self):
        return len(self.pairs)

    def resize_and_crop(self, image: np.ndarray):
        """The test mode's resize to img_size x img_size (area); no crop."""
        return resize(image, (self.img_size, self.img_size), INTER_AREA), None

    def _mask_file(self, pair: str, idx: int) -> str:
        mask_file = pair + "/mask.png"
        if not os.path.exists(mask_file):
            mask_file = self.mask_list[idx % len(self.mask_list)]
        return mask_file

    def __getitem__(self, idx: int) -> dict:
        pair = self.pairs[idx]
        source, _ = self.resize_and_crop(_read_rgb(_find_image(pair + "/source")))
        target, _ = self.resize_and_crop(_read_rgb(_find_image(pair + "/target")))
        image = np.concatenate([source, target], axis=1)
        half = _half_mask(self._mask_file(pair, idx), self.img_size)
        mask = np.concatenate([np.zeros_like(half), half], axis=1)
        image = (image.astype(np.float32) / 127.5) - 1.0
        mask = mask[:, :, None].astype(np.float32)
        prompt = build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode,
                              self.deep_prompt, self.cross_attn_layers)
        return dict(image=image, txt=prompt, masked_image=image * (mask < 0.5), mask=mask)


class InpaintingMultiViewDataset(InpaintingCrossViewDataset):
    """Target + (view_num - 1) reference views, test mode: a pair directory's
    ``target`` and ``source``, ``source_1`` .. ``source_3`` as a 5-D stack
    (V, H, W, C) with only view 0 masked (``concat_target``: V - 1 canvases
    [source j | target]), per-view prompts with ``<view_direct-j-l>``
    suffixes, and ``idx`` the directory's number where its name is one."""

    def __init__(self, *args, **kwargs):
        self.view_num = kwargs.pop("view_num", 4)
        self.view_token_len = kwargs.pop("view_token_len", 30)
        self.source_shuffle = kwargs.pop("source_shuffle", False)
        self.concat_target = kwargs.pop("concat_target", False)
        super().__init__(*args, **kwargs)

    def get_view_prompts(self) -> list[str]:
        """Per-view prompts with <view_direct-j-l> suffixes (the closing '>'
        is in the dataset's strings; the tokenizer's table lacks it, so the
        dataset token matches the table's prefix)."""
        base = build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode)
        n = self.view_num - 1 if self.concat_target else self.view_num
        prompts = []
        for j in range(n):
            t = base
            for l in range(self.view_token_len):
                t = t + f"<view_direct-{j}-{l}>"
            prompts.append(t)
        return prompts

    def __getitem__(self, idx: int) -> dict:
        pair = self.pairs[idx]
        s = self.img_size
        source_filenames = [_find_image(pair + name) for name in ("/source", "/source_1", "/source_2", "/source_3")]
        target, _ = self.resize_and_crop(_read_rgb(_find_image(pair + "/target")))
        if self.source_shuffle:
            order = np.random.choice(self.view_num - 1, self.view_num - 1, replace=False)
        else:
            order = range(self.view_num - 1)
        sources = [self.resize_and_crop(_read_rgb(source_filenames[i]))[0] for i in order]
        image = np.array([target, *sources])
        mask = _half_mask(self._mask_file(pair, idx), s)

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

        name = str(pair).split("/")[-1]
        return dict(image=image, txt=self.get_view_prompts(), masked_image=masked_image, mask=final_mask,
                    idx=int(name) if name.isdigit() else idx)


class InpaintingDataset:
    """Plain single-image inpainting / outpainting, test mode: each image
    (a directory's files, or a list file's lines, thinned to about
    ``test_limit``) resized to ``img_size`` (area) with the right
    ``right_strip_frac`` of it masked."""

    def __init__(
        self,
        image_path,
        mask_path,
        mode: str = "train",
        img_size: int = 256,
        token_map: Optional[dict] = None,
        test_limit: int = 150,
        right_strip_frac: float = 0.5,
        **kwargs,
    ):
        if mode == "train":
            _training_masks(type(self).__name__)
        if os.path.isdir(image_path):
            self.files = sorted(glob(image_path + "/*"))
        else:
            with open(image_path) as f:
                self.files = [line.strip() for line in f.readlines()]
        if len(self.files) > test_limit:
            self.files = self.files[:: len(self.files) // test_limit]
        self.mode = mode
        self.img_size = img_size
        self.token_map = token_map
        self.repeat_sp_token = kwargs.get("repeat_sp_token", 0)
        self.sp_token = kwargs.get("sp_token")
        self.right_strip_frac = right_strip_frac

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        s = self.img_size
        image = resize(_read_rgb(self.files[idx]), (s, s), INTER_AREA)
        mask = np.zeros((s, s), np.float32)
        mask[:, int(s * (1 - self.right_strip_frac)):] = 1
        image = (image.astype(np.float32) / 127.5) - 1.0
        mask = mask[:, :, None].astype(np.float32)
        return dict(image=image, txt=build_prompt(self.repeat_sp_token, self.sp_token, self.token_map, self.mode),
                    masked_image=image * (mask < 0.5), mask=mask)


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
