"""The CFG-doubled UNet batch split over the ranks of a group (counterpart
of ``leftrefill_tpu/parallel/batch.py``), the serving latency mode: at the
single-canvas request (CFG batch 2) two ranks run the uncond and the cond
row at once.

Every rank holds the whole sampler state (x, the conditioning, the K/V
cache), as JAX's replicated ``P()`` specs keep it: each runs the UNet on its
own contiguous rows and the outputs are gathered back in rank order, so the
sampler goes on with the whole batch on every rank."""

from __future__ import annotations

import torch
import torch.distributed as dist

from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.parallel.mesh import all_gather_cat


def take_rows(tree, sl: slice):
    """``tree`` (tensors in lists and tuples, the K/V cache) with every
    tensor cut to the batch rows ``sl``."""
    if isinstance(tree, torch.Tensor):
        return tree[sl]
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(t, sl) for t in tree)
    return tree


def batch_parallel_apply(model, group: dist.ProcessGroup, cross_kv=None):
    """``apply_fn(x, t, cond)`` that runs ``model.apply_model`` on this
    rank's rows of x, t, the conditioning and the K/V cache ``cross_kv``
    (built on the same CFG-doubled batch) and gathers every rank's output.
    The batch must divide by the group's size.  The shared CFG prefix
    (``cfg_dup``) stays off: a rank's rows are not the two equal halves it
    needs."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)

    def apply_fn(x: torch.Tensor, t: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        if x.shape[0] % size != 0:
            raise ValueError(
                f"batch-parallel sampling needs the (CFG-doubled) UNet batch ({x.shape[0]}) divisible by the "
                f"group's {size} ranks; use a canvas batch that is a multiple of {size} (CFG doubles it) or "
                f"fewer ranks")
        n = x.shape[0] // size
        sl = slice(rank * n, (rank + 1) * n)
        local = Conditioning(*(take_rows(c, sl) for c in (cond.c_concat, cond.c_crossattn, cond.c_input)))
        out = model.apply_model(x[sl], t[sl], local, cross_kv=take_rows(cross_kv, sl), cfg_dup=False)
        return all_gather_cat(out, group, 0)

    return apply_fn
