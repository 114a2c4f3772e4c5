"""Random weights for the quality studies (``tools/quality.py``), the port's
copies of two of the JAX package's helpers, acting on a ``state_dict`` (the
port's layout: a weight's first axis is its output) with a
``torch.Generator``:

- ``realistic_init_``: the "realistic" init of the JAX quality scripts
  (``scripts/tpu_r3_int8_quality.py`` ``mk``): every weight of two or more
  axes drawn as a normal over the square root of its fan-in, every norm
  scale 1, every bias 0.02 times a normal;
- ``unzero_``: ``tests/test_tasks.py`` ``unzero_kernels``: every weight of
  two or more axes that is all zero (a freshly initialised model's output
  convs and projections) filled with 0.02 times a normal, so that eps is not
  trivially small.

Draws run on the generator's device and are moved to each tensor's."""

from __future__ import annotations

import math
from typing import MutableMapping

import torch

SCALE = 0.02  # the JAX scripts' bias scale (``mk``) and fill scale (``unzero_kernels``)


def _normal(shape, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    n = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32)
    return n.to(device=like.device, dtype=like.dtype)


def realistic_init_(state: MutableMapping[str, torch.Tensor],
                    generator: torch.Generator) -> MutableMapping[str, torch.Tensor]:
    """Fill ``state`` in place, in its key order: a tensor of two or more
    axes with normals over sqrt(fan-in) (every axis but the first: a linear's
    input width, a conv's input channels times its taps), a 1-D ``weight``
    (a norm's scale) with ones, any other 1-D tensor (a bias) with
    ``SCALE`` times a normal.  Returns ``state``."""
    with torch.no_grad():
        for key, t in state.items():
            if not t.is_floating_point():
                raise ValueError(f"{key}: {t.dtype} is not a floating-point weight")
            if t.ndim >= 2:
                t.copy_(_normal(t.shape, generator, t) / math.sqrt(max(t[0].numel(), 1)))
            elif t.ndim == 1 and key.endswith("weight"):
                t.fill_(1.0)
            else:
                t.copy_(SCALE * _normal(t.shape, generator, t))
    return state


def unzero_(state: MutableMapping[str, torch.Tensor], generator: torch.Generator) -> MutableMapping[str, torch.Tensor]:
    """Fill, in place and in key order, every tensor of ``state`` with two or
    more axes whose values are all zero with ``SCALE`` times a normal; the
    rest is left as it is.  Returns ``state``."""
    with torch.no_grad():
        for t in state.values():
            if t.ndim >= 2 and t.numel() and not bool(t.any()):
                t.copy_(SCALE * _normal(t.shape, generator, t))
    return state
