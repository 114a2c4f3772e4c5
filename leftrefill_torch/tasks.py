"""Task objects (counterpart of ``leftrefill_tpu/tasks.py``): 1-reference
inpainting (``RefInpaintTask``), its multi-view variant
(``MultiViewRefInpaintTask``) and novel-view synthesis (``NVSTask``), each
around a bundle (``config.ModelBundle``, or ``pipeline.NVSBundle`` for
serving): initialization of its parameters, sampling for the image log,
validation metrics and, for novel-view synthesis, the training
conditioning.  ``build_task`` picks the task of a model YAML's target.  The
tasks run on the card unless their ``device`` is "cpu"; without a card they
raise."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.diffusion.ddim import NoiseFn, PickFn, ddim_multi_sample, ddim_sample, default_noise_fn
from leftrefill_torch.diffusion.samplers_extra import ddpm_sample
from leftrefill_torch.eval.metrics import composite_metrics
from leftrefill_torch.ops.layers import nearest_resize
from leftrefill_torch.pipeline import fill_random_, request_device

DEFAULT_SEED = 42  # JAX's log_images draws from PRNGKey(42) unless given a key
LOG_EVERY_T = 200  # the diffusion row's timestep stride (JAX: tasks.py:177)
DENOISE_ROW_STEPS = 8  # the most DDIM steps the denoise row keeps


def _memoized(noise_fn: NoiseFn) -> NoiseFn:
    """``noise_fn`` drawn once per step index, then replayed."""
    draws = {}

    def fn(i, shape):
        if i not in draws:
            draws[i] = noise_fn(i, shape)
        return draws[i]

    return fn


class RefInpaintTask:
    """Reference-guided inpainting with one reference (JAX: tasks.py:36-305)."""

    def __init__(self, bundle, device="cuda"):
        self.bundle = bundle
        self.model, self.tokenizer = bundle.model, bundle.tokenizer
        self.device = device

    # ---------- parameters -------------------------------------------------

    def init_params(self, generator: torch.Generator, sd_state_dict: Optional[dict] = None) -> dict:
        """Random values for every parameter (``pipeline.fill_random_``), then
        a checkpoint's where given (``convert.checkpoint.load_over_base``,
        the report printed as JAX prints it), then the prompt table from its
        init text.  Returns the load report (empty without a checkpoint)."""
        from leftrefill_torch.convert.checkpoint import load_over_base
        from leftrefill_torch.models.clip import init_prompt_table

        fill_random_(self.model, generator)
        self._init_extra()
        report = {}
        if sd_state_dict is not None:
            report = load_over_base(self.model, sd_state_dict)
            if report["missing"]:
                print(f"[init] {len(report['missing'])} params missing from checkpoint")
            if report["unexpected"]:
                print(f"[init] {len(report['unexpected'])} unexpected checkpoint keys")
        cb = self.bundle.cond_bundle
        init_prompt_table(self.model.cond_stage_model, cb.tokenizer, cb.special_tokens, cb.init_text,
                          cb.tokenwise_init)
        return report

    def _init_extra(self) -> None:
        """Task-specific initial values (the refinement scale's)."""

    # ---------- tokens ------------------------------------------------------

    def prompt_tokens(self, txt) -> np.ndarray:
        """A prompt (or a list of them) -> [B, 77] ids."""
        return np.asarray(self.tokenizer.tokenize(list(txt) if isinstance(txt, (list, tuple)) else txt))

    def uncond_tokens(self, n: int) -> np.ndarray:
        """The empty prompt, n times: [n, 77]."""
        return np.repeat(np.asarray(self.tokenizer.tokenize("")), n, axis=0)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=request_device(self.device))

    # ---------- sampling ----------------------------------------------------

    def _rows(self, batch: dict, n: int, keys) -> dict:
        return {k: batch[k][:n] for k in keys if k in batch}

    @torch.inference_mode()
    def log_images(self, batch: dict, N: Optional[int] = None, ddim_steps: int = 50, ddim_eta: float = 0.0,
                   unconditional_guidance_scale: float = 9.0, generator: Optional[torch.Generator] = None,
                   x_T: Optional[torch.Tensor] = None, noise_fn: Optional[NoiseFn] = None,
                   vae_noise: Optional[torch.Tensor] = None, plot_diffusion_rows: bool = False,
                   plot_denoise_rows: bool = False, plot_progressive_rows: bool = False,
                   diffusion_noise_fn: Optional[NoiseFn] = None, ddpm_noise_fn: Optional[NoiseFn] = None) -> dict:
        """DDIM over the inpainting canvas (JAX: tasks.py:142-164): CFG with
        the empty prompt for a guidance scale above 1, the unconditional
        branch alone at 0, the conditional one otherwise; decoded and clipped
        to [-1, 1].  Returns {"pred", "origin_image", "masked_image",
        "mask"} for the first N rows; ``x_T``, ``noise_fn`` and ``vae_noise``
        as the pipeline's.

        The ``plot_*`` flags add JAX's diagnostic rows (tasks.py:169-231),
        each decoded as one stack, clipped, [S, B, H, W, 3], on the same x_T
        as "pred": "diffusion_row", the encoded image q-sampled at t in
        ``range(0, T, 200) + [T - 1]`` (the noise of row i from
        ``diffusion_noise_fn(i, shape)``; JAX ``fold_in(key, 1000 + i)``);
        "denoise_row", the x0 predictions of "pred"'s DDIM loop at up to 8
        evenly spaced steps (at g = 0 of a second loop on the same per-step
        noise); "progressive_row", the x0 of the full DDPM loop at the end
        of each fifth of it (``ddpm_noise_fn(t, shape)``; JAX
        ``fold_in(key', t)``).  The rows
        guide with the empty prompt only for a scale above 1, and sample the
        conditional branch otherwise: at 0 they do not take "pred"'s
        unconditional branch (JAX's rule, kept).  Every stream defaults to
        ``generator`` (seed 42)."""
        dev = request_device(self.device)
        n = N or batch["image"].shape[0]
        rows = self._rows(batch, n, ("image", "mask", "masked_image", "tokens"))
        generator = generator or torch.Generator(dev).manual_seed(DEFAULT_SEED)
        m = self.model
        cond = m.build_inpaint_cond(self._tensor(rows["tokens"], torch.long), self._tensor(rows["mask"]),
                                    self._tensor(rows["masked_image"]), vae_noise)
        b, h, w, _ = cond.c_concat.shape
        shape = (b, h, w, m.unet.out_channels)
        g = unconditional_guidance_scale
        uc = None
        if g > 1.0 or g == 0.0:
            uc = Conditioning(cond.c_concat, m.get_learned_conditioning(self._tensor(self.uncond_tokens(b),
                                                                                      torch.long)))
        tables = m.schedule.ddim_tables(ddim_steps, eta=ddim_eta)
        apply_fn = lambda x, t, c: m.apply_model(x, t, c)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=dev)
        noise_fn = noise_fn or default_noise_fn(generator, dev)
        # for g != 0 the denoise row is "pred"'s own loop; at g = 0 it is a
        # second loop (the conditional branch) on "pred"'s per-step draws
        rerun_row = plot_denoise_rows and g == 0.0
        keep_inter = plot_denoise_rows and not rerun_row
        if rerun_row:
            noise_fn = _memoized(noise_fn)
        p_cond, p_uncond = (uc, None) if g == 0.0 else (cond, uc)
        res = ddim_sample(apply_fn, m.schedule, tables, p_cond, shape, uncond=p_uncond,
                          guidance_scale=g if p_uncond is not None else 1.0, x_T=x_T, noise_fn=noise_fn, device=dev,
                          return_intermediates=keep_inter)
        z, inter = res if keep_inter else (res, None)
        out = {"pred": m.decode_first_stage(z).to(torch.float32).clamp(-1.0, 1.0),
               "origin_image": self._tensor(rows["image"]), "masked_image": self._tensor(rows["masked_image"]),
               "mask": self._tensor(rows["mask"])}
        row_uc = uc if g > 1.0 else None

        def decode_stack(zs: torch.Tensor) -> torch.Tensor:
            dec = m.decode_first_stage(zs.reshape(-1, *zs.shape[2:])).to(torch.float32).clamp(-1.0, 1.0)
            return dec.reshape(*zs.shape[:2], *dec.shape[1:])

        if plot_diffusion_rows:
            z0 = m.encode_first_stage(out["origin_image"], vae_noise)
            n_t = m.schedule.num_timesteps
            draw = diffusion_noise_fn or default_noise_fn(generator, dev)
            zs = [m.q_sample(z0, torch.full((b,), t, dtype=torch.long, device=dev), draw(i, tuple(z0.shape)))
                  for i, t in enumerate([*range(0, n_t, LOG_EVERY_T), n_t - 1])]
            out["diffusion_row"] = decode_stack(torch.stack(zs))
        if rerun_row:
            _, inter = ddim_sample(apply_fn, m.schedule, tables, cond, shape, x_T=x_T, noise_fn=noise_fn,
                                   device=dev, return_intermediates=True)
        if plot_denoise_rows:
            idx = np.linspace(0, ddim_steps - 1, min(DENOISE_ROW_STEPS, ddim_steps)).astype(int)
            out["denoise_row"] = decode_stack(inter["pred_x0"][torch.as_tensor(idx, device=dev)])
        if plot_progressive_rows:
            _, x0s = ddpm_sample(apply_fn, m.schedule, cond, shape, uncond=row_uc, guidance_scale=g, x_T=x_T,
                                 return_x0_every=max(m.schedule.num_timesteps // 5, 1), generator=generator,
                                 noise_fn=ddpm_noise_fn, device=dev)
            out["progressive_row"] = decode_stack(x0s)
        return out

    # ---------- validation --------------------------------------------------

    def validation_metrics(self, batch: dict, cfg_scale: float, lpips_fn=None, ddim_steps: int = 50,
                           generator: Optional[torch.Generator] = None, **sampling) -> dict:
        """PSNR and SSIM of the sampled canvas composited into the hole, on
        its right half (JAX: tasks.py:277-301), and with ``lpips_fn`` (an
        ``eval.lpips.LPIPS``, or any f(x, y) -> [B] on [-1, 1] NHWC) LPIPS
        of that composite against the origin's right half; ``sampling``:
        ``log_images``' x_T, noise_fn, vae_noise.  The training CLI passes
        no ``lpips_fn``, as JAX's does."""
        log = self.log_images(batch, ddim_steps=ddim_steps, unconditional_guidance_scale=cfg_scale,
                              generator=generator, **sampling)
        return self._scores(log["pred"], log["origin_image"], log["mask"], lpips_fn)

    @staticmethod
    def _scores(pred: torch.Tensor, origin: torch.Tensor, mask: torch.Tensor, lpips_fn) -> dict:
        m = composite_metrics(pred, origin, mask)
        out = {"val/psnr": float(m["psnr"].mean()), "val/ssim": float(m["ssim"].mean())}
        if lpips_fn is not None:
            h, w = origin.shape[1:3]
            origin_r = origin[:, :, w // 2:] if w != h else origin  # cropped as composite_metrics crops
            with torch.no_grad():
                out["val/lpips"] = float(lpips_fn(m["composite"], origin_r).mean())
        return out

    # ---------- the loss's view options ------------------------------------

    @property
    def view_reduced(self) -> bool:
        return False

    @property
    def view_num(self) -> int:
        return 1


class MultiViewRefInpaintTask(RefInpaintTask):
    """Multi-view inpainting (JAX: tasks.py:307-372): 5-D batches flattened to
    (B*V) rows, the view-0 loss, the log split per view."""

    @property
    def view_reduced(self) -> bool:
        return self.bundle.reduced_loss

    @property
    def view_num(self) -> int:
        return self.bundle.view_num

    def flatten_batch(self, batch: dict) -> dict:
        from leftrefill_torch.data.loader import flatten_views

        return flatten_views(batch)

    def log_images(self, batch: dict, N: Optional[int] = None, **kw) -> dict:
        """N counts scenes (each V flat rows); every entry split to
        [B, V, ...], plus "reference" (views 1..V-1) without concat_target.
        The diagnostic rows split on their batch axis: [S, B, V, ...]
        (JAX splits their leading step axis, tasks.py:344: its rows come out
        scrambled, or it raises where V does not divide the steps)."""
        flat = self.flatten_batch(batch) if batch["image"].ndim == 5 else batch
        v = self.view_num if not self.bundle.concat_target else self.view_num - 1
        n_rows = None if N is None else min(N, flat["image"].shape[0] // v) * v
        log = super().log_images(flat, N=n_rows, **kw)
        out = {k: (val.reshape(val.shape[0], val.shape[1] // v, v, *val.shape[2:]) if k.endswith("_row")
                   else val.reshape(val.shape[0] // v, v, *val.shape[1:])) for k, val in log.items()}
        if not self.bundle.concat_target and out["origin_image"].shape[1] > 1:
            out["reference"] = out["origin_image"][:, 1:]
        return out

    @torch.inference_mode()
    def multi_cond_sample(self, conds: Conditioning, unconds: Optional[Conditioning], shape: tuple,
                          guidance_scale: float, ddim_steps: int = 50, eta: float = 0.0,
                          generator: Optional[torch.Generator] = None, x_T: Optional[torch.Tensor] = None,
                          noise_fn: Optional[NoiseFn] = None, pick_fn: Optional[PickFn] = None) -> torch.Tensor:
        """Test-time multi-reference consistent sampling (JAX:
        tasks.py:353-372): ``conds`` / ``unconds`` stack K conditionings on a
        leading axis, ``ddim_multi_sample`` steps the K latents as one batch
        and shares one latent's right half after each step; returns latent 0
        [*shape].  The draws (``x_T``, ``noise_fn``, ``pick_fn`` as the
        sampler's) default to ``generator`` (seed 42)."""
        dev = request_device(self.device)
        generator = generator or torch.Generator(dev).manual_seed(DEFAULT_SEED)
        m = self.model
        return ddim_multi_sample(lambda x, t, c: m.apply_model(x, t, c), m.schedule,
                                 m.schedule.ddim_tables(ddim_steps, eta=eta), conds, shape, unconds=unconds,
                                 guidance_scale=guidance_scale, x_T=x_T, generator=generator, noise_fn=noise_fn,
                                 pick_fn=pick_fn, device=dev)

    def validation_metrics(self, batch: dict, cfg_scale: float, lpips_fn=None, ddim_steps: int = 50,
                           generator: Optional[torch.Generator] = None, **sampling) -> dict:
        """The 1-reference task's scores over the views with a hole (each
        scene's target; the reference views have none and would composite
        to themselves), on the sampled scenes' flat rows.  JAX's task hands
        its per-view [B, V, ...] log to the 4-D metrics and raises."""
        log = self.log_images(batch, ddim_steps=ddim_steps, unconditional_guidance_scale=cfg_scale,
                              generator=generator, **sampling)
        pred, origin, mask = (log[k].reshape(-1, *log[k].shape[2:]) for k in ("pred", "origin_image", "mask"))
        holed = mask.reshape(mask.shape[0], -1).amax(dim=1) > 0
        return self._scores(pred[holed], origin[holed], mask[holed], lpips_fn)


class NVSTask(RefInpaintTask):
    """Novel view synthesis (JAX: ``NVSTask``, tasks.py:375-515): a canvas
    [reference view | target view], the target masked, conditioned on the
    relative camera pose through the prompt embedder (``hybrid-refine``:
    the masked canvas's latent concatenated, the pose-conditioned prompt
    cross-attended, and the refinement residual c_input where the bundle
    has the refinement branch)."""

    def __init__(self, bundle, device="cuda"):
        super().__init__(bundle, device)
        self.refinement_config = dict(bundle.refinement_config)
        self.mask_steps = 0  # the mask-rate warm-up curriculum's step

    def _init_extra(self) -> None:
        """The refinement branch's scale starts at 0 (JAX's initializer), so
        the branch adds nothing before training."""
        if self.model.refinement_model is not None:
            with torch.no_grad():
                self.model.refinement_alpha.zero_()

    # ---------- conditioning ----------------------------------------------

    def build_cond(self, batch: dict, train: bool = False, generator: Optional[torch.Generator] = None,
                   cfg_draws: Optional[torch.Tensor] = None, vae_noise: Optional[torch.Tensor] = None
                   ) -> Conditioning:
        """The inpainting c_concat (the mask at latent size, the masked
        canvas's latent, encoded without a graph), the pose-conditioned
        context and, with the refinement branch, c_input (JAX:
        tasks.py:403-442).  ``train`` with ``generator`` or ``cfg_draws``:
        the embedder's CFG prompt dropout (a dropped row takes the null
        prompt's embedding, pose slot included, as JAX's)."""
        m = self.model
        masked, mask = self._tensor(batch["masked_image"]), self._tensor(batch["mask"])
        with torch.no_grad():
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

    def cond_builder(self, batch: dict, cfg_draws: Optional[torch.Tensor] = None,
                     vae_noise: Optional[torch.Tensor] = None) -> Conditioning:
        """The training conditioning (``train.compute_loss``'s
        ``cond_builder``): :meth:`build_cond` with the CFG dropout's draws."""
        return self.build_cond(batch, train=True, cfg_draws=cfg_draws, vae_noise=vae_noise)

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
        rows = self._rows(batch, n, ("image", "mask", "masked_image", "tokens", "rel_pose", "clean_masked_image",
                                     "clean_mask", "subpixel_mask"))
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


def build_task(bundle, device="cuda"):
    """The task of a ``config.ModelBundle``'s target (the reference's class
    names)."""
    t = bundle.task_target
    if t == "inpainting_ldm.ref_inpainting_ldm.RefInpaintLDM":
        return RefInpaintTask(bundle, device)
    if t == "inpainting_ldm.multiview_ref_inpainting_ldm.RefInpaintLDM":
        return MultiViewRefInpaintTask(bundle, device)
    if t == "inpainting_ldm.NVS_ldm.NVSLDM":
        return NVSTask(bundle, device)
    raise KeyError(t)
