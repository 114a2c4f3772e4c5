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
load.  JAX's ``view_mesh`` (views sharded across chips, context
parallelism) is not ported.
"""

from __future__ import annotations

import torch

from leftrefill_torch.models.unet import BasicTransformerBlock, UNetModel


class MultiViewBasicTransformerBlock(BasicTransformerBlock):
    """Self-attention over the joint view sequence; cross-attention and the
    feed-forward stay per view (JAX: multiview.py:37-144).  The int8
    ``lnq`` arm is the base block's, around the regrouped tokens.  JAX's
    block calls attn2 without ``return_attn`` (multiview.py:130, :142), so a
    multi-view UNet yields no attention maps."""

    collects_attention = False

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: int, dtype=torch.float32,
                 quant: bool = False, fused: bool = True, view_num: int = 4, concat_target: bool = False,
                 no_rearrange_selfattn: bool = False):
        super().__init__(dim, n_heads, d_head, context_dim, dtype=dtype, quant=quant, fused=fused)
        self.view_num, self.concat_target = view_num, concat_target
        self.no_rearrange_selfattn = no_rearrange_selfattn

    def forward(self, x, context=None, cross_kv=None, dup_to_context: bool = False):
        if dup_to_context:
            # JAX's block drops dup_to_context (multiview.py:70-76) and its
            # multi-view sampling never asks for it: the shared CFG prefix
            # would leave the batch halved across the view fold
            raise ValueError("the multi-view UNet runs without cfg_dup")
        bv, hw, c = x.shape
        if not self.concat_target:
            b = bv // self.view_num
            return self.cross_attention_ff(
                self.self_attention(x.reshape(b, self.view_num * hw, c)).reshape(bv, hw, c), context, cross_kv)
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
                       **unet_kwargs) -> UNetModel:
    """The UNet with the multi-view block at every transformer (JAX:
    multiview.py:147-169); the parameter tree is ``UNetModel``'s."""
    return UNetModel(
        block_cls=MultiViewBasicTransformerBlock,
        block_kwargs=dict(view_num=view_num, concat_target=concat_target,
                          no_rearrange_selfattn=no_rearrange_selfattn),
        **unet_kwargs,
    )
