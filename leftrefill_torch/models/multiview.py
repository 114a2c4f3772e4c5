"""Multi-view rearranged self-attention and the multi-view UNet (counterpart
of ``leftrefill_tpu/models/multiview.py``).

The views of a scene are consecutive rows of the batch.  Before the
self-attention they fold out of the batch into the sequence, so that all
views attend jointly, and fold back before the per-view cross-attention and
feed-forward:

- default (``concat_target=False``, the shipped setting):
  (b·v, hw, c) -> (b, v·hw, c).  With 64x64 latents per view (512x512
  images) the ds-1 joint sequence is 8192 tokens at V=2 and 16384 at V=4,
  where JAX streams K/V (K11) and the port's flash kernel takes any length;
- ``concat_target``: each of the v-1 rows is a [view | target] canvas; the
  sequence is [the first canvas's target half, every canvas's view half],
  and the attended target half is written back into every canvas's right
  half;
- ``no_rearrange_selfattn`` (with ``concat_target``): the v-1 canvases of a
  scene attend jointly as they are.

The parameter tree is the 1-reference UNet's, so the same checkpoint keys
load.

``view_group`` (JAX's ``view_mesh``, context parallelism): the views of
every scene split over the ranks of a ``torch.distributed`` group, each rank
holding ``view_num / size`` consecutive views of each scene (rows of the
batch) through the whole UNet; only the joint self-attention gathers K and V
from the other ranks (``parallel.context``).  The default mode only: a
``concat_target`` or ``no_rearrange_selfattn`` sequence needs views that
another rank holds, so those raise under a group (JAX runs them on one
device, which holds every view).
"""

from __future__ import annotations

import torch

from leftrefill_torch.models.unet import BasicTransformerBlock, UNetModel


class MultiViewBasicTransformerBlock(BasicTransformerBlock):
    """Self-attention over the joint view sequence; cross-attention and the
    feed-forward stay per view (JAX: multiview.py:37-144).  The int8
    ``lnq`` arm is the base block's, around the regrouped tokens.  JAX's
    block calls attn2 without ``return_attn`` (multiview.py:130, :142), so a
    multi-view UNet yields no attention maps.  ``view_group``: the rows hold
    this rank's ``view_num / size`` views of each scene, and the
    self-attention gathers the others' K and V (module docstring)."""

    collects_attention = False

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: int, dtype=torch.float32,
                 quant: bool = False, fused: bool = True, view_num: int = 4, concat_target: bool = False,
                 no_rearrange_selfattn: bool = False, view_group=None):
        super().__init__(dim, n_heads, d_head, context_dim, dtype=dtype, quant=quant, fused=fused)
        self.view_num, self.concat_target = view_num, concat_target
        self.no_rearrange_selfattn = no_rearrange_selfattn
        self.local_views = view_num
        if view_group is not None:
            if concat_target or no_rearrange_selfattn:
                raise ValueError("a view group splits the default joint sequence only: concat_target and "
                                 "no_rearrange_selfattn need the views another rank holds")
            from leftrefill_torch.parallel.context import make_context_parallel_attn
            from leftrefill_torch.parallel.mesh import group_size

            self.attn1.attn_fn = make_context_parallel_attn(view_group, view_num)
            self.local_views = view_num // group_size(view_group)

    def forward(self, x, context=None, cross_kv=None, dup_to_context: bool = False):
        if dup_to_context:
            # JAX's block drops dup_to_context (multiview.py:70-76) and its
            # multi-view sampling never asks for it: the shared CFG prefix
            # would leave the batch halved across the view fold
            raise ValueError("the multi-view UNet runs without cfg_dup")
        bv, hw, c = x.shape
        if not self.concat_target:
            b = bv // self.local_views
            return self.cross_attention_ff(
                self.self_attention(x.reshape(b, self.local_views * hw, c)).reshape(bv, hw, c), context, cross_kv)
        pairs = self.view_num - 1  # canvases per scene
        b = bv // pairs
        if self.no_rearrange_selfattn:
            x = self.self_attention(x.reshape(b, pairs * hw, c)).reshape(bv, hw, c)
        else:
            s = int((hw // 2) ** 0.5)  # canvases are s x 2s
            xn = x.reshape(b, pairs, s, 2 * s, c)
            seq = torch.cat([xn[:, 0:1, :, s:], xn[:, :, :, :s]], dim=1).reshape(b, self.view_num * s * s, c)
            seq = self.self_attention(seq).reshape(b, self.view_num, s, s, c)
            target = seq[:, 0:1].expand(b, pairs, s, s, c)
            x = torch.cat([seq[:, 1:], target], dim=3).reshape(bv, hw, c)
        return self.cross_attention_ff(x, context, cross_kv)


def MultiViewUnetModel(view_num: int = 4, concat_target: bool = False, no_rearrange_selfattn: bool = False,
                       view_group=None, **unet_kwargs) -> UNetModel:
    """The UNet with the multi-view block at every transformer (JAX:
    multiview.py:147-169); the parameter tree is ``UNetModel``'s.
    ``view_group``: the views split over its ranks (module docstring)."""
    return UNetModel(
        block_cls=MultiViewBasicTransformerBlock,
        block_kwargs=dict(view_num=view_num, concat_target=concat_target,
                          no_rearrange_selfattn=no_rearrange_selfattn, view_group=view_group),
        **unet_kwargs,
    )
