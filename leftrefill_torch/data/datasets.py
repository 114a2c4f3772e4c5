"""The datasets of the port's data path (counterpart of
``leftrefill_tpu/data/datasets.py``): the prompt text and the relative
camera pose of novel-view synthesis, the Objaverse novel-view dataset
``NVS_OBJDataset`` and the scene-balanced ``BalancedRandomSampler``.  The
numpy parts are copies, so the port imports nothing of the JAX package
(``tests/test_torch_isolation.py`` holds them equal to the originals); the
image files are read and resized through ``data.image_io`` (no OpenCV), the
masks drawn by ``data.masks``.  The MegaDepth datasets (1-reference and
multi-view) read JPEG files and wait for a JPEG reader."""

from __future__ import annotations

import collections
import math
import os
import random
from typing import Optional

import numpy as np

from leftrefill_torch.data.image_io import INTER_AREA, read_png, resize
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
