"""Context-parallel multi-view attention (counterpart of
``leftrefill_tpu/parallel/context.py``): the views of a scene split over the
ranks of a view group, each rank holding its views' tokens through the
whole UNet.  Only the joint self-attention meets the other views: it
gathers K and V over the group while the queries stay local, so each rank
computes its own rows of the joint attention, complete softmax rows over
every view's keys.

Forward only: ``torch.distributed``'s gather has no gradient, and no path
trains through the view-sharded UNet."""

from __future__ import annotations

import torch
import torch.distributed as dist

from leftrefill_torch.ops.attention import multi_head_attention
from leftrefill_torch.parallel.mesh import all_gather_cat, group_rank, group_size, shard_rows


def _forward_only(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("the context-parallel attention has no gradient (its K/V gather is forward "
                           "only): run the view-sharded UNet under torch.no_grad()")


def make_context_parallel_attn(view_group: dist.ProcessGroup, view_num: int):
    """An attention function with ``multi_head_attention``'s signature for the
    multi-view self-attention (``CrossAttention.attn_fn``): q, k and v hold
    this rank's views, [B, V_local * HW, inner]; K and V are gathered along
    the token axis in rank order (the view order) and the flash dispatcher
    picks K1 by JAX's rule for Nq = V_local * HW against Nk = V * HW."""
    size = dist.get_world_size(view_group)
    if view_num % size:
        raise ValueError(f"{view_num} views do not split over a view group of {size} ranks")

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
        _forward_only(q, k, v)
        return multi_head_attention(q, all_gather_cat(k, view_group, 1), all_gather_cat(v, view_group, 1),
                                    num_heads)

    return attn


def context_parallel_joint_attention(view_group: dist.ProcessGroup, q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The 4-D form: q, k, v [B, V_local, HW, inner] of this rank's views ->
    its rows of the joint self-attention over every view, [B, V_local, HW,
    inner]."""
    _forward_only(q, k, v)
    b, v_loc, hw, inner = q.shape
    k_all, v_all = (all_gather_cat(t.reshape(b, v_loc * hw, inner), view_group, 1) for t in (k, v))
    out = multi_head_attention(q.reshape(b, v_loc * hw, inner), k_all, v_all, num_heads)
    return out.reshape(b, v_loc, hw, inner)


def local_views(x: torch.Tensor, view_num: int, view_group: dist.ProcessGroup, data_group=None) -> torch.Tensor:
    """This rank's rows of a batch of whole scenes, [scenes * view_num, ...]
    scene-major: its contiguous block of the scenes over ``data_group``
    (JAX's 'data' axis) and, of each, its contiguous block of the views
    over ``view_group`` ('view'), scene-major again."""
    v_size, v_rank = group_size(view_group), group_rank(view_group)
    scenes = shard_rows(x.reshape(x.shape[0] // view_num, view_num, *x.shape[1:]), group_rank(data_group),
                        group_size(data_group))
    local = view_num // v_size
    return scenes[:, v_rank * local: (v_rank + 1) * local].reshape(-1, *x.shape[1:])
