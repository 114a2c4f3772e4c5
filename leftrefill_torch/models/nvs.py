"""The novel-view-synthesis models in PyTorch (counterpart of
``leftrefill_tpu/models/nvs.py``): the UNet with the learned separator
column and the ``c_input`` residual, the refinement CNN, the relative-pose
MLP and the pose-conditioned prompt embedder.  Module names follow the
NVS checkpoint: ``model.diffusion_model.sep_token.<width>``,
``refinement_model.<index>.*`` and ``refinement_alpha`` (on the
``LeftRefillModel``), ``cond_stage_model.rel_pos_model.mlp1.0.*``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from leftrefill_torch.models.clip import PromptCLIPEmbedder
from leftrefill_torch.models.unet import Downsample, UNetModel, Upsample
from leftrefill_torch.ops.layers import GroupNorm32, Linear, conv2d_nhwc, timestep_embedding


class NVSUnetModel(UNetModel):
    """The UNet with, under ``use_sep``, a learned per-channel separator
    column spliced between the two canvas halves around every block that is
    not a resample block (input, middle and output) and stripped after it,
    and the additive ``c_input`` residual after input block 0: over the full
    width where the shapes match, over the right half otherwise.  As in JAX
    the residual is added after the separator strip (the reference adds it
    before, a combination no shipped config enables)."""

    def __init__(self, *args, use_sep: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_sep = use_sep
        if use_sep:
            self.sep_token = nn.ParameterDict(
                {str(c): nn.Parameter(torch.empty(c)) for c in self._sep_channel_set()})

    def _sep_channel_set(self) -> list[int]:
        """The widths that get a separator column (JAX: nvs.py:41-66): the
        input widths of the stem, of every input ResBlock, of the middle
        block and of every output block (skip concatenation included).
        (9, 320, 640, 960, 1280, 1920, 2560) at SD2 width."""
        nrb, mc = self.num_res_blocks, self.model_channels
        chans = {self.in_channels}
        ch, skips = mc, [mc]
        for level, mult in enumerate(self.channel_mult):
            for _ in range(nrb):
                chans.add(skips[-1])
                ch = mult * mc
                skips.append(ch)
            if level != len(self.channel_mult) - 1:
                skips.append(ch)
        chans.add(ch)
        h_ch = ch
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for _ in range(nrb + 1):
                chans.add(h_ch + skips.pop())
                h_ch = mc * mult
        return sorted(chans)

    def _sep_seq(self, layers, h, emb, context, kv_iter, state, middle: bool = False):
        """``_apply_seq`` with the separator column spliced in the middle of
        the width before the block and stripped after it, unless the block
        is a resample block (the middle block always takes it)."""
        if not (self.use_sep and (middle or not isinstance(layers[-1], (Downsample, Upsample)))):
            return self._apply_seq(layers, h, emb, context, kv_iter, state)
        b, hh, w, c = h.shape
        col = self.sep_token[str(c)].to(h.dtype).expand(b, hh, 1, c)
        h = torch.cat([h[:, :, : w // 2], col, h[:, :, w // 2:]], dim=2)
        h = self._apply_seq(layers, h, emb, context, kv_iter, state)
        return torch.cat([h[:, :, : w // 2], h[:, :, -(w // 2):]], dim=2)

    def forward(self, x, timesteps, context=None, cross_kv=None, cfg_dup: bool = False,
                c_input: Optional[torch.Tensor] = None):
        """As ``UNetModel.forward``, with the separator columns and the
        ``c_input`` residual.  Under ``cfg_dup`` the prefix runs on the
        first half of the batch, so only the first half of c_input is added
        there: its two CFG halves are equal by construction (the
        unconditional branch shares the conditional one's c_input)."""
        t_emb = timestep_embedding(timesteps, self.model_channels, dtype=self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        h = x.to(self.dtype)
        if context is not None:
            context = context.to(self.dtype)
        state = {"dup": bool(cfg_dup and context is not None)}
        if state["dup"]:
            assert h.shape[0] % 2 == 0, "cfg_dup needs the CFG-doubled batch"
            h = h[: h.shape[0] // 2]
        kv_iter = iter(cross_kv) if cross_kv is not None else None
        hs = []
        for i, layers in enumerate(self.input_blocks):
            h = self._sep_seq(layers, h, emb, context, kv_iter, state)
            if i == 0 and c_input is not None:
                ci = c_input[: h.shape[0]].to(h.dtype)
                if ci.shape == h.shape:
                    h = h + ci
                else:  # the refinement covers the right (target) half only
                    half = h.shape[2] // 2
                    h = torch.cat([h[:, :, :half], h[:, :, half:] + ci], dim=2)
            hs.append(h)
        h = self._sep_seq(self.middle_block, h, emb, context, kv_iter, state, middle=True)
        for layers in self.output_blocks:
            skip = hs.pop()
            if skip.shape[0] != h.shape[0]:  # stored before the duplication point
                skip = torch.cat([skip, skip], dim=0)
            h = self._sep_seq(layers, torch.cat([h, skip], dim=-1), emb, context, kv_iter, state)
        if state["dup"]:  # no transformer consumed the context
            h = torch.cat([h, h], dim=0)
        h = F.silu(self.out[0](h.to(x.dtype)))
        return self.out[2](h).to(x.dtype)


# the refinement CNN's Sequential: (index, kind, output channels, stride or groups)
_REFINEMENT = ((0, "conv", 32, 1), (2, "conv", 64, 2), (3, "norm", 64, 16), (5, "conv", 64, 1),
               (6, "norm", 64, 16), (8, "conv", 128, 2), (9, "norm", 128, 32), (11, "conv", 128, 1),
               (12, "norm", 128, 32), (14, "conv", 256, 2), (15, "norm", 256, 32), (17, "conv", None, 1),
               (18, "norm", None, 32))


class RefinementCNN(nn.Sequential):
    """The refinement branch (JAX: nvs.py:151-184): [masked image, mask]
    (4 channels) -> ``model_channels`` at 1/8 resolution through seven 3x3
    convs (three of stride 2) with SiLU, and GroupNorm + SiLU after each but
    the first.  The reference's Sequential indices: convs 0, 2, 5, 8, 11,
    14, 17, GroupNorms 3, 6, 9, 12, 15, 18, SiLUs between.  The convs are
    plain convolutions (XLA's in JAX, not a Pallas kernel); it computes in
    fp32, as JAX's does.  Its learned scale ``refinement_alpha`` lives on
    the ``LeftRefillModel`` (``LeftRefillModel.refine``)."""

    def __init__(self, model_channels: int = 320, dtype=torch.float32):
        layers, cin = [], 4
        for idx, kind, ch, arg in _REFINEMENT:
            ch = model_channels if ch is None else ch
            while len(layers) < idx:
                layers.append(nn.SiLU())
            if kind == "conv":
                layers.append(nn.Conv2d(cin, ch, 3, stride=arg, padding=1, dtype=dtype))
                cin = ch
            else:
                layers.append(GroupNorm32(ch, num_groups=arg))
        layers.append(nn.SiLU())
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, masked_image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """masked_image [B, H, W, 3], mask [B, H, W, 1] (NHWC) -> [B, H/8, W/8, C]."""
        x = torch.cat([masked_image, mask], dim=-1).to(self.dtype)
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                x = conv2d_nhwc(x, layer.weight, layer.bias, stride=layer.stride[0], padding=1)
            elif isinstance(layer, nn.SiLU):
                x = F.silu(x)
            else:
                x = layer(x)
        return x


class RelPosModel(nn.Module):
    """4-d relative pose (dtheta, sin dphi, cos dphi, dz) -> a prompt
    embedding (JAX: nvs.py:187-204): ``mlp1`` = Linear, SiLU, Linear; with
    ``pos_strengthen`` also ``mlp2`` = SiLU, Linear on mlp1's output."""

    def __init__(self, input_ch: int = 4, out_ch: int = 1024, pos_strengthen: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp1 = nn.ModuleList([Linear(input_ch, out_ch // 2, dtype=dtype), nn.SiLU(),
                                   Linear(out_ch // 2, out_ch, dtype=dtype)])
        self.mlp2 = nn.ModuleList([nn.SiLU(), Linear(out_ch, out_ch, dtype=dtype)]) if pos_strengthen else None

    def forward(self, x: torch.Tensor):
        """-> (the pose token [B, out_ch], the strengthening token or None)."""
        x1 = self.mlp1[2](F.silu(self.mlp1[0](x.to(self.dtype))))
        return x1, (None if self.mlp2 is None else self.mlp2[1](F.silu(x1)))


class NVSCLIPEmbedder(PromptCLIPEmbedder):
    """``PromptCLIPEmbedder`` with the relative-pose token and the
    training-time CFG prompt dropout (JAX: nvs.py:207-267).

    ``forward(tokens, rel_pose=None, null_tokens=None, generator=None,
    cfg_draws=None)``:
    - rel_pose [B, 4]: its MLP embedding overwrites token slot
      ``num_special_tokens + 1`` before the transformer;
    - CFG dropout, where ``cfg_rate`` > 0 and ``generator`` or
      ``cfg_draws`` is given (training): a row whose uniform draw is below
      ``cfg_rate`` takes the token embedding of the null prompt
      ``null_tokens`` [1, L] instead; the draws come from ``generator``,
      or are ``cfg_draws`` [B] themselves;
    - ``pos_strengthen``: the second MLP output overwrites the last context
      token after the transformer, where the row was not dropped."""

    def __init__(self, *args, pos_strengthen: bool = False, cfg_rate: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pos_strengthen, self.cfg_rate = pos_strengthen, cfg_rate
        width = self.model.token_embedding.weight.shape[1]
        self.rel_pos_model = RelPosModel(4, width, pos_strengthen, dtype=self.dtype)

    def forward(self, tokens: torch.Tensor, rel_pose: Optional[torch.Tensor] = None,
                null_tokens: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                cfg_draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        text_emb = self.blend_embeddings(tokens)
        emb2 = None
        if rel_pose is not None:
            emb1, emb2 = self.rel_pos_model(rel_pose)
            text_emb = text_emb.clone()
            text_emb[:, self.num_special_tokens + 1] = emb1.to(text_emb.dtype)
        m = None
        if self.cfg_rate > 0.0 and (generator is not None or cfg_draws is not None):
            if cfg_draws is None:
                cfg_draws = torch.rand((text_emb.shape[0],), generator=generator, device=text_emb.device)
            null_emb = self.model.token_embedding.weight[null_tokens[0]].to(text_emb.dtype)
            m = (cfg_draws.to(text_emb.device) < self.cfg_rate).to(text_emb.dtype)[:, None, None]
            text_emb = (1 - m) * text_emb + m * null_emb[None]
        z = self.model(text_emb, skip_last=self.skip_last)
        if emb2 is not None:
            pose_z = emb2.to(z.dtype)
            if m is not None:
                mz = m[:, 0].to(z.dtype)
                pose_z = pose_z * (1 - mz) + z[:, -1] * mz
            z = torch.cat([z[:, :-1], pose_z[:, None]], dim=1)
        return z
