"""Exponential moving average of parameters (counterpart of
``leftrefill_tpu/train/ema.py``): the reference's LitEma with its warm-up
decay min(decay, (1 + n) / (10 + n)).  LeftRefill ships with ``use_ema:
False``; the EMA is part of the training surface all the same.

The EMA holds its own copies of the tensors it follows, by name (a
``state_dict`` or any name -> tensor mapping)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
    ema_params: dict[str, torch.Tensor]
    num_updates: int = 0
    decay: float = 0.9999

    def swap(self, params: dict) -> tuple[dict, dict]:
        """The ema scope: (the EMA values to evaluate with, the originals kept)."""
        return self.ema_params, params


def init_ema(params: dict, decay: float = 0.9999) -> EMAState:
    return EMAState({k: v.detach().clone() for k, v in params.items()}, 0, decay)


@torch.no_grad()
def update_ema(state: EMAState, params: dict) -> EMAState:
    """One EMA step with the warm-up decay, computed in fp32 as JAX does;
    the EMA tensors are updated in place."""
    n = state.num_updates + 1
    decay = float(np.minimum(np.float32(state.decay), np.float32(1.0 + n) / np.float32(10.0 + n)))
    for k, e in state.ema_params.items():
        e.mul_(decay).add_(params[k].detach().to(e.dtype), alpha=1.0 - decay)
    return EMAState(state.ema_params, n, state.decay)
