"""Training observability (counterpart of ``leftrefill_tpu/train/logger.py``):
a JSONL metric stream, sample grids written as PNG files (``ImageLogger``,
through ``data.image_io``: JAX's writes JPEG files with PIL), the prompt
tokens' drift from their first values, and per-step wall times with a
``torch.profiler`` trace window that carries the program's spans."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from leftrefill_torch import trace
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
                v = trace.to_host(v.detach()).numpy()
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
    return trace.to_host(x.detach().float()).numpy() if isinstance(x, torch.Tensor) else x


class StepTimer:
    """Wall time per train step, and a ``torch.profiler`` trace of steps
    ``trace_steps[0]`` to ``trace_steps[1]`` written to ``trace_dir`` as a
    Chrome trace with the program's spans and syncs (``leftrefill_torch.trace``)
    as a track of their own.  It never waits on the card: ``mean_step_s``,
    read after something that does (a metric's ``float``), is the mean wall
    time of the steps since its last reading."""

    def __init__(self, trace_dir: Optional[str] = None, trace_steps: tuple[int, int] = (10, 13)):
        self.trace_dir, self.trace_steps = trace_dir, trace_steps
        self._t0 = self._last = None
        self._busy_s, self._steps = 0.0, 0
        self._prof = None
        self._window_ns = 0

    def start(self, step: int):
        if self.trace_dir and step == self.trace_steps[0]:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._window_ns = time.time_ns()
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> None:
        self._last = time.perf_counter()
        self._busy_s += self._last - self._t0
        self._steps += 1
        if self._prof is not None and step >= self.trace_steps[1]:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, f"trace_steps_{self.trace_steps[0]}_{step}.json")
            self._prof.export_chrome_trace(path)
            add_program_track(path, self._window_ns)
            self._prof = None

    def mean_step_s(self) -> float:
        """The steps' host time since the last reading plus the wait from
        the last step's end until now, over the steps (nan with none)."""
        if not self._steps:
            return float("nan")
        mean = (self._busy_s + time.perf_counter() - self._last) / self._steps
        self._busy_s, self._steps = 0.0, 0
        return mean


PROGRAM_TRACK = "leftrefill_torch spans"


def add_program_track(path: str, since_ns: int) -> None:
    """Add the spans and syncs recorded since ``since_ns`` to the Chrome
    trace at ``path``, as complete and instant events of a process of their
    own, on the trace's clock (``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    us = lambda ns: (ns - base) / 1e3
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": PROGRAM_TRACK, "args": {"name": PROGRAM_TRACK}})
    for s in trace.spans():
        if s.start_ns >= since_ns:
            events.append({"ph": "X", "name": s.name, "pid": PROGRAM_TRACK, "tid": s.thread, "ts": us(s.start_ns),
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": {"unit": s.unit, "id": s.id, "parent": s.parent, **s.attrs}})
    for y in trace.syncs():
        if y.t_ns >= since_ns:
            events.append({"ph": "i", "s": "t", "name": f"sync.{y.kind}", "pid": PROGRAM_TRACK, "tid": y.thread,
                           "ts": us(y.t_ns), "args": {"unit": y.unit, "nbytes": y.nbytes}})
    with open(path, "w") as f:
        json.dump(doc, f)
