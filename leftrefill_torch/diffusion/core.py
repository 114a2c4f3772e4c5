"""Latent diffusion core: the model bundle, conditioning assembly, q_sample,
the parameterizations and the training loss (counterpart of
``leftrefill_tpu/diffusion/core.py``).

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

from leftrefill_torch import trace
from leftrefill_torch.diffusion.schedules import DiffusionSchedule, eps_from_z_and_v, start_from_z_and_v

from leftrefill_torch.models.autoencoder import AutoencoderKL, DiagonalGaussian
from leftrefill_torch.models.clip import PromptCLIPEmbedder
from leftrefill_torch.models.unet import UNetModel
from leftrefill_torch.ops.layers import nearest_resize

VAE_NOISE_SEED = 42  # the reference re-seeds its RNG to 42 before every VAE sample


def fixed_vae_noise(shape, device) -> torch.Tensor:
    """The VAE posterior's default noise: a draw of ``shape`` from a
    generator seeded ``VAE_NOISE_SEED``."""
    gen = torch.Generator(device=device).manual_seed(VAE_NOISE_SEED)
    return torch.randn(tuple(shape), generator=gen, device=device)


@dataclasses.dataclass(frozen=True)
class Conditioning:
    """The conditioning bundle: c_concat [B, h, w, 5] (mask and masked-image
    latent), c_crossattn [B, L, C] (text context) and c_input, the novel-view
    refinement residual of ``hybrid-refine`` [B, h, w, model_channels] (or
    over the right half of the width)."""

    c_concat: Optional[torch.Tensor] = None
    c_crossattn: Optional[torch.Tensor] = None
    c_input: Optional[torch.Tensor] = None

    def concat_batch(self, other: "Conditioning") -> "Conditioning":
        """[other; self] along the batch: the CFG layout, uncond first.  A
        field is None only where both sides have none."""

        def cat(a, b):
            if a is None and b is None:
                return None
            return torch.cat([a, b], dim=0)

        return Conditioning(cat(other.c_concat, self.c_concat), cat(other.c_crossattn, self.c_crossattn),
                            cat(other.c_input, self.c_input))


class DiffusionWrapper(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


CONDITIONING_KEYS = ("concat", "crossattn", "hybrid", "hybrid-refine")


class LeftRefillModel(nn.Module):
    """``conditioning_key`` (JAX: core.py:137-165) says how ``apply_model``
    hands the conditioning to the UNet: ``concat`` channel-concatenates
    c_concat, ``crossattn`` cross-attends c_crossattn, ``hybrid`` does both
    and ``hybrid-refine`` adds c_input after the UNet's first block
    (``models.nvs.NVSUnetModel``).  ``refinement`` (novel-view synthesis,
    ``models.nvs.RefinementCNN``) is held as ``refinement_model`` beside its
    learned scale ``refinement_alpha``, the checkpoint's keys."""

    def __init__(
        self,
        unet: UNetModel,
        vae: AutoencoderKL,
        cond_model: PromptCLIPEmbedder,
        schedule: DiffusionSchedule,
        scale_factor: float = 0.18215,
        conditioning_key: str = "hybrid",
        refinement: Optional[nn.Module] = None,
    ):
        super().__init__()
        if conditioning_key not in CONDITIONING_KEYS:
            raise NotImplementedError(conditioning_key)
        self.model = DiffusionWrapper(unet)
        self.first_stage_model = vae
        self.cond_stage_model = cond_model
        self.schedule = schedule
        self.scale_factor = scale_factor
        self.conditioning_key = conditioning_key
        self.refinement_model = refinement
        if refinement is not None:
            self.refinement_alpha = nn.Parameter(torch.zeros(()))

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    # ---------- first stage ------------------------------------------------

    def encode_first_stage(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Image in [-1, 1], NHWC -> scaled latent.  ``noise`` is the posterior
        sample's noise; by default a fixed draw (seed 42, as the reference)."""
        with trace.span("vae.encode"):
            moments = self.first_stage_model.encode_moments(x)
            dist = DiagonalGaussian(moments)
            if noise is None:
                noise = fixed_vae_noise(dist.mean.shape, moments.device)
            return self.scale_factor * dist.sample(noise.to(dist.mean.dtype))

    def latent_shape(self, image_shape) -> tuple:
        """The latent shape [B, h, w, C] of an NHWC image batch."""
        vae = self.first_stage_model
        ds = 2 ** (len(vae.ddconfig.ch_mult) - 1)
        return (image_shape[0], image_shape[1] // ds, image_shape[2] // ds, vae.post_quant_conv.weight.shape[1])

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        with trace.span("vae.decode"):
            return self.first_stage_model.decode(z / self.scale_factor)

    # ---------- conditioning ----------------------------------------------

    def get_learned_conditioning(self, tokens: torch.Tensor) -> torch.Tensor:
        with trace.span("text"):
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

    def refine(self, masked_image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The refinement residual c_input: the refinement CNN on [image, mask]
        at 1/8 resolution, times ``refinement_alpha``."""
        x = self.refinement_model(masked_image, mask)
        return x * self.refinement_alpha.to(x.dtype)

    def cross_attention_kv(self, context: torch.Tensor) -> Optional[list]:
        """Every cross-attention layer's (k, v) for a fixed context; None
        for ``concat`` conditioning, which has no context."""
        if self.conditioning_key == "concat":
            return None
        with trace.span("cross_kv"):
            return self.unet.cross_kv(context)

    # ---------- model application -----------------------------------------

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor, cond: Conditioning, **kwargs) -> torch.Tensor:
        """The UNet on x_noisy under ``conditioning_key``.  ``hybrid-refine``
        with no c_input is ``hybrid`` exactly."""
        key = self.conditioning_key
        with trace.span("unet"):
            if key == "crossattn":
                return self.unet(x_noisy, t, cond.c_crossattn, **kwargs)
            xc = torch.cat([x_noisy, cond.c_concat.to(x_noisy.dtype)], dim=-1)
            if key == "concat":
                return self.unet(xc, t, None, **kwargs)
            if key == "hybrid-refine" and cond.c_input is not None:
                kwargs["c_input"] = cond.c_input
            if key in ("hybrid", "hybrid-refine"):
                return self.unet(xc, t, cond.c_crossattn, **kwargs)
        raise NotImplementedError(key)

    # ---------- forward process / parameterizations ------------------------

    def _bcast(self, name: str, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The schedule table ``name`` at each row's t, broadcast over x."""
        v = trace.to_device(getattr(self.schedule, name), device=x.device)[t.to(torch.long)]
        return v.reshape(t.shape[0], *([1] * (x.ndim - 1)))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return (self._bcast("sqrt_alphas_cumprod", t, x_start) * x_start
                + self._bcast("sqrt_one_minus_alphas_cumprod", t, x_start) * noise)

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return (self._bcast("sqrt_alphas_cumprod", t, x) * noise
                - self._bcast("sqrt_one_minus_alphas_cumprod", t, x) * x)

    def predict_eps_from_z_and_v(self, x: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return eps_from_z_and_v(x, v, self._bcast("sqrt_alphas_cumprod", t, x),
                                self._bcast("sqrt_one_minus_alphas_cumprod", t, x))

    def predict_start_from_z_and_v(self, x: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return start_from_z_and_v(x, v, self._bcast("sqrt_alphas_cumprod", t, x),
                                  self._bcast("sqrt_one_minus_alphas_cumprod", t, x))

    # ---------- training loss ----------------------------------------------

    def p_losses(
        self,
        z: torch.Tensor,
        cond: Conditioning,
        t: torch.Tensor,
        noise: torch.Tensor,
        loss_type: str = "l2",
        l_simple_weight: float = 1.0,
        original_elbo_weight: float = 0.0,
        per_element: bool = False,
    ):
        """The latent loss with logvar 0 (LeftRefill never learns it):
        ``l_simple_weight`` * mean(loss_simple) + ``original_elbo_weight`` *
        the lvlb term; returns (loss, metrics).  ``per_element=True``
        returns the unreduced [B, H, W, C] error (the multi-view loss keeps
        view 0 of it).  The target follows the schedule's parameterization
        ("eps" for SD2-inpainting), which also set its ``lvlb_weights``."""
        model_output = self.apply_model(self.q_sample(z, t, noise), t, cond)
        parameterization = self.schedule.parameterization
        if parameterization == "x0":
            target = z
        elif parameterization == "eps":
            target = noise
        elif parameterization == "v":
            target = self.get_v(z, noise, t)
        else:
            raise NotImplementedError(parameterization)
        diff = model_output.to(torch.float32) - target
        if loss_type == "l1":
            err = diff.abs()
        elif loss_type == "l2":
            err = diff**2
        else:
            raise NotImplementedError(loss_type)
        if per_element:
            return err
        loss_simple = err.mean(dim=(1, 2, 3))
        weights = trace.to_device(self.schedule.lvlb_weights, device=err.device)[t.to(torch.long)]
        loss_vlb = (weights * loss_simple).mean()
        loss = l_simple_weight * loss_simple.mean() + original_elbo_weight * loss_vlb
        return loss, {"loss_simple": loss_simple.mean(), "loss_vlb": loss_vlb, "loss": loss}
