"""Training observability (counterpart of ``leftrefill_tpu/train/logger.py``):
a JSONL metric stream, the prompt tokens' drift from their first values, and
per-step wall times with a ``torch.profiler`` trace window.  The image grids
(``ImageLogger``) come with the training CLI."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch


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
