"""The numpy-only pieces of the JAX package's ``data/datasets.py`` that serving
needs: the prompt text and the relative camera pose of novel-view
synthesis.  Copies, so the port imports nothing of the JAX package
(``tests/test_torch_isolation.py`` holds them equal to the originals)."""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

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
