"""Training observability (counterpart of ``leftrefill_tpu/train/logger.py``):
a JSONL metric stream, sample grids written as PNG files (``ImageLogger``,
through ``data.image_io``: JAX's writes JPEG files with PIL), the prompt
tokens' drift from their first values, and per-step wall times with a
``torch.profiler`` trace window."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from leftrefill_torch.data.image_io import write_png


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(_numpy(img), np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def make_grid(images: dict, max_images: int = 4) -> np.ndarray:
    """One row per sample (at most ``max_images``), the entries side by side
    in the dict's order (1-channel ones as grey RGB); each value [B, H, W, C]."""
    images = {k: np.asarray(_numpy(v)) for k, v in images.items()}
    n = min(max_images, next(iter(images.values())).shape[0])
    rows = [np.concatenate([to_uint8(np.broadcast_to(v[i], v[i].shape[:2] + (3,)) if v[i].shape[-1] == 1 else v[i])
                            for v in images.values()], axis=1) for i in range(n)]
    return np.concatenate(rows, axis=0)


class ImageLogger:
    """A sample grid every ``batch_frequency`` steps, as a PNG file
    ``gs-<step>_e-<epoch>_<split>.png`` in ``save_dir``."""

    def __init__(self, save_dir: str, batch_frequency: int = 200, max_images: int = 4):
        self.save_dir, self.batch_frequency, self.max_images = save_dir, batch_frequency, max_images
        os.makedirs(save_dir, exist_ok=True)

    def should_log(self, step: int) -> bool:
        return step % self.batch_frequency == 0

    def log(self, step: int, epoch: int, images: dict, split: str = "train") -> str:
        path = os.path.join(self.save_dir, f"gs-{step:06}_e-{epoch:06}_{split}.png")
        write_png(path, make_grid(images, self.max_images))
        return path


class MetricLogger:
    """Append-only JSONL metric stream, echoed to stdout every ``echo_every``
    records."""

    def __init__(self, save_dir: str, echo_every: int = 50):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self.echo_every = echo_every
        self._n = 0

    def log(self, step: int, metrics: dict[str, Any]):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            rec[k] = float(v) if np.isscalar(v) or np.ndim(v) == 0 else v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self.echo_every == 0:
            print(f"[step {step}] " + " ".join(f"{k}={rec[k]:.5g}" for k in metrics))


class TokenDriftLogger:
    """Each prompt token's L2 drift from the initial table."""

    def __init__(self, initial_table):
        self.initial = np.asarray(_numpy(initial_table), np.float32).copy()

    def drift(self, current_table) -> dict[str, float]:
        per_token = np.linalg.norm(np.asarray(_numpy(current_table), np.float32) - self.initial, axis=-1)
        return {"token_drift/mean": float(per_token.mean()), "token_drift/max": float(per_token.max())}


def _numpy(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else x


class StepTimer:
    """Per-step wall time and its moving average (0.9 / 0.1), with a
    ``torch.profiler`` trace of steps ``trace_steps[0]`` to ``trace_steps[1]``
    written to ``trace_dir`` as a Chrome trace.  ``stop`` synchronises the
    card first, so the time is the step's, not its enqueue's."""

    def __init__(self, trace_dir: Optional[str] = None, trace_steps: tuple[int, int] = (10, 13)):
        self.trace_dir, self.trace_steps = trace_dir, trace_steps
        self._t0 = None
        self.ema = None
        self._prof = None

    def start(self, step: int):
        if self.trace_dir and step == self.trace_steps[0]:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        self._t0 = time.time()

    def stop(self, step: int) -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.time() - self._t0
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        if self._prof is not None and step >= self.trace_steps[1]:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.trace_dir, f"trace_steps_{self.trace_steps[0]}_{step}.json"))
            self._prof = None
        return dt
