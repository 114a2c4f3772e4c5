"""Task objects (counterpart of ``leftrefill_tpu/tasks.py``): novel-view
synthesis serving, ``NVSTask``.  The task runs on the card unless its
``device`` is "cpu"; without a card it raises."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.diffusion.ddim import NoiseFn, ddim_sample
from leftrefill_torch.ops.layers import nearest_resize
from leftrefill_torch.pipeline import NVSBundle, request_device

DEFAULT_SEED = 42  # JAX's log_images draws from PRNGKey(42) unless given a key


class NVSTask:
    """Novel view synthesis (JAX: ``NVSTask``, tasks.py:375-515): a canvas
    [reference view | target view], the target masked, conditioned on the
    relative camera pose through the prompt embedder (``hybrid-refine``:
    the masked canvas's latent concatenated, the pose-conditioned prompt
    cross-attended, and the refinement residual c_input where the bundle
    has the refinement branch)."""

    def __init__(self, bundle: NVSBundle, device="cuda"):
        self.model, self.tokenizer = bundle.model, bundle.tokenizer
        self.refinement_config = dict(bundle.refinement_config)
        self.device = device
        self.mask_steps = 0  # the mask-rate warm-up curriculum's step

    # ---------- tokens ------------------------------------------------------

    def prompt_tokens(self, txt) -> np.ndarray:
        """A prompt (or a list of them) -> [B, 77] ids."""
        return np.asarray(self.tokenizer.tokenize(list(txt) if isinstance(txt, (list, tuple)) else txt))

    def uncond_tokens(self, n: int) -> np.ndarray:
        """The empty prompt, n times: [n, 77]."""
        return np.repeat(np.asarray(self.tokenizer.tokenize("")), n, axis=0)

    # ---------- conditioning ----------------------------------------------

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=request_device(self.device))

    def build_cond(self, batch: dict, train: bool = False, generator: Optional[torch.Generator] = None,
                   cfg_draws: Optional[torch.Tensor] = None, vae_noise: Optional[torch.Tensor] = None
                   ) -> Conditioning:
        """The inpainting c_concat (the mask at latent size, the masked
        canvas's latent), the pose-conditioned context and, with the
        refinement branch, c_input (JAX: tasks.py:403-442).  ``train`` with
        ``generator`` or ``cfg_draws``: the embedder's CFG prompt dropout."""
        m = self.model
        masked, mask = self._tensor(batch["masked_image"]), self._tensor(batch["mask"])
        z = m.encode_first_stage(masked, vae_noise)
        mask_lat = nearest_resize(mask, tuple(z.shape[1:3]))
        c_cat = torch.cat([mask_lat, z.to(torch.float32)], dim=-1)
        kwargs = {}
        if train and (generator is not None or cfg_draws is not None) and m.cond_stage_model.cfg_rate > 0:
            kwargs = dict(null_tokens=self._tensor(self.uncond_tokens(1), torch.long), generator=generator,
                          cfg_draws=cfg_draws)
        c_cross = m.cond_stage_model(self._tensor(batch["tokens"], torch.long), self._tensor(batch["rel_pose"]),
                                     **kwargs)
        c_input = None
        if m.refinement_model is not None:
            only_masked = self.refinement_config.get("only_masked_refine")
            img_key, mask_key = ("clean_masked_image", "clean_mask") if only_masked else ("masked_image",
                                                                                          "subpixel_mask")
            c_input = m.refine(self._tensor(batch.get(img_key, batch["masked_image"])),
                               self._tensor(batch.get(mask_key, batch["mask"])))
        return Conditioning(c_concat=c_cat, c_crossattn=c_cross, c_input=c_input)

    # ---------- sampling ----------------------------------------------------

    @torch.inference_mode()
    def log_images(
        self,
        batch: dict,
        N: Optional[int] = None,
        ddim_steps: int = 50,
        ddim_eta: float = 0.0,
        unconditional_guidance_scale: float = 9.0,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
        vae_noise: Optional[torch.Tensor] = None,
    ) -> dict:
        """DDIM over the pose-conditioned canvas (JAX: tasks.py:444-506):
        CFG with the empty prompt only for a guidance scale above 1 (the
        unconditional branch shares c_concat and c_input), decode, clip to
        [-1, 1].  The cross-attention K/V are computed once per canvas and
        the CFG pair shares the UNet prefix at half batch (``cfg_dup``).
        Returns {"pred", "origin_image", "masked_image", "mask"} for the
        first N rows; ``x_T``, ``noise_fn`` and ``vae_noise`` as the
        pipeline's, the rest drawn from ``generator`` (seed 42 by default)."""
        dev = request_device(self.device)
        n = N or batch["image"].shape[0]
        rows = {k: batch[k][:n] for k in ("image", "mask", "masked_image", "tokens", "rel_pose")}
        for k in ("clean_masked_image", "clean_mask", "subpixel_mask"):
            if k in batch:
                rows[k] = batch[k][:n]
        generator = generator or torch.Generator(dev).manual_seed(DEFAULT_SEED)
        m = self.model
        cond = self.build_cond(rows, vae_noise=vae_noise)
        b, h, w, _ = cond.c_concat.shape
        shape = (b, h, w, m.unet.out_channels)
        tables = m.schedule.ddim_tables(ddim_steps, eta=ddim_eta)
        guided = unconditional_guidance_scale > 1.0
        uncond = None
        if guided:
            uc_cross = m.cond_stage_model(self._tensor(self.uncond_tokens(b), torch.long))
            uncond = Conditioning(c_concat=cond.c_concat, c_crossattn=uc_cross, c_input=cond.c_input)
        # every cross-attention K/V once per canvas, in the CFG batch's [uncond; cond] order
        kv = m.cross_attention_kv(torch.cat([uncond.c_crossattn, cond.c_crossattn]) if guided else cond.c_crossattn)

        def apply_fn(x, t, c):
            return m.apply_model(x, t, c, cross_kv=kv, cfg_dup=guided)

        z = ddim_sample(apply_fn, m.schedule, tables, cond, shape, uncond=uncond,
                        guidance_scale=unconditional_guidance_scale, x_T=x_T, generator=generator,
                        noise_fn=noise_fn, device=dev)
        pred = m.decode_first_stage(z).to(torch.float32).clamp(-1.0, 1.0)
        return {"pred": pred, "origin_image": self._tensor(rows["image"]),
                "masked_image": self._tensor(rows["masked_image"]), "mask": self._tensor(rows["mask"])}

    def update_mask_curriculum(self, dataset, step: int) -> None:
        """The mask-rate warm-up: the dataset's ``complete_mask_rate`` ramps
        with the training step over its ``warmup_mask_steps``."""
        warmup = getattr(dataset, "warmup_mask_steps", 0)
        if warmup and step < warmup:
            dataset.complete_mask_rate = min(1.0, step / warmup)
        self.mask_steps = step
