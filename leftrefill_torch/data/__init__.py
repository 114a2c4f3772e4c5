"""Batches of the training data (counterpart of ``leftrefill_tpu/data``).  The
datasets and the loader come with the training CLI."""

from __future__ import annotations

import numpy as np
import torch


def flatten_views(batch: dict) -> dict:
    """A multi-view batch (B, V, H, W, C) -> (B*V, H, W, C), its tokens
    (B, V, 77) -> (B*V, 77): each scene's V views become consecutive rows,
    the layout the multi-view UNet folds.  Other entries are kept as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 3:
            out[k] = v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
        else:
            out[k] = v
    return out
