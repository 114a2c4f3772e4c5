"""Latent diffusion core: the model bundle, conditioning assembly and
q_sample (counterpart of ``leftrefill_tpu/diffusion/core.py``).

``LeftRefillModel`` is an ``nn.Module`` laid out like the LDM checkpoint:
``model.diffusion_model`` (UNet), ``first_stage_model`` (VAE) and
``cond_stage_model`` (prompt CLIP), so ``load_state_dict`` takes the SD2
checkpoint's keys as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from leftrefill_torch.diffusion.schedules import DiffusionSchedule

from leftrefill_torch.models.autoencoder import AutoencoderKL, DiagonalGaussian
from leftrefill_torch.models.clip import PromptCLIPEmbedder
from leftrefill_torch.models.unet import UNetModel
from leftrefill_torch.ops.layers import nearest_resize

VAE_NOISE_SEED = 42  # the reference re-seeds its RNG to 42 before every VAE sample


@dataclasses.dataclass(frozen=True)
class Conditioning:
    """The hybrid conditioning: c_concat [B, h, w, 5] (mask and masked-image
    latent) and c_crossattn [B, L, C] (text context)."""

    c_concat: Optional[torch.Tensor] = None
    c_crossattn: Optional[torch.Tensor] = None

    def concat_batch(self, other: "Conditioning") -> "Conditioning":
        """[other; self] along the batch: the CFG layout, uncond first."""

        def cat(a, b):
            return None if a is None else torch.cat([a, b], dim=0)

        return Conditioning(cat(other.c_concat, self.c_concat), cat(other.c_crossattn, self.c_crossattn))


class DiffusionWrapper(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


class LeftRefillModel(nn.Module):
    def __init__(
        self,
        unet: UNetModel,
        vae: AutoencoderKL,
        cond_model: PromptCLIPEmbedder,
        schedule: DiffusionSchedule,
        scale_factor: float = 0.18215,
    ):
        super().__init__()
        self.model = DiffusionWrapper(unet)
        self.first_stage_model = vae
        self.cond_stage_model = cond_model
        self.schedule = schedule
        self.scale_factor = scale_factor  # eps parameterization, as SD2-inpainting

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    # ---------- first stage ------------------------------------------------

    def encode_first_stage(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Image in [-1, 1], NHWC -> scaled latent.  ``noise`` is the posterior
        sample's noise; by default a fixed draw (seed 42, as the reference)."""
        moments = self.first_stage_model.encode_moments(x)
        dist = DiagonalGaussian(moments)
        if noise is None:
            gen = torch.Generator(device=moments.device).manual_seed(VAE_NOISE_SEED)
            noise = torch.randn(dist.mean.shape, generator=gen, device=moments.device)
        return self.scale_factor * dist.sample(noise.to(dist.mean.dtype))

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.first_stage_model.decode(z / self.scale_factor)

    # ---------- conditioning ----------------------------------------------

    def get_learned_conditioning(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.cond_stage_model(tokens)

    def build_inpaint_cond(
        self,
        tokens: torch.Tensor,
        mask: torch.Tensor,
        masked_image: torch.Tensor,
        vae_noise: Optional[torch.Tensor] = None,
    ) -> Conditioning:
        """c_concat = [mask resized (nearest) to the latent size, VAE(masked_image)]."""
        z = self.encode_first_stage(masked_image, vae_noise)
        mask_lat = nearest_resize(mask.to(torch.float32), tuple(z.shape[1:3]))
        c_cat = torch.cat([mask_lat, z.to(torch.float32)], dim=-1)
        return Conditioning(c_concat=c_cat, c_crossattn=self.get_learned_conditioning(tokens))

    def cross_attention_kv(self, context: torch.Tensor) -> list:
        """Every cross-attention layer's (k, v) for a fixed context."""
        return self.unet.cross_kv(context)

    # ---------- model application -----------------------------------------

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor, cond: Conditioning, **kwargs) -> torch.Tensor:
        """Hybrid conditioning: channel-concat c_concat, cross-attend c_crossattn."""
        xc = torch.cat([x_noisy, cond.c_concat.to(x_noisy.dtype)], dim=-1)
        return self.unet(xc, t, cond.c_crossattn, **kwargs)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        s = self.schedule

        def bcast(table):
            v = torch.as_tensor(table, device=x_start.device)[t.to(torch.long)]
            return v.reshape(t.shape[0], *([1] * (x_start.ndim - 1)))

        return bcast(s.sqrt_alphas_cumprod) * x_start + bcast(s.sqrt_one_minus_alphas_cumprod) * noise
