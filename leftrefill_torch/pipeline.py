"""Reference-guided inpainting inference, end to end (counterpart of
``leftrefill_tpu/pipeline.py``): stitch [reference | target], VAE-encode the
masked canvas, build the prompt context, run the sampler with CFG over the
UNet (cross-attention K/V computed once per canvas, the CFG prefix shared at
half batch), decode, clip and composite into the hole.  The multi-view
request (``MultiViewInpaintPipeline``) runs the same steps over the views of
a scene, one row each.  Both run on the card unless the caller passes
``device="cpu"``; without a card they raise.  ``build_sd2_nvs_bundle``
builds the novel-view-synthesis bundle that ``tasks.NVSTask`` serves."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from leftrefill_torch.diffusion.core import Conditioning, LeftRefillModel
from leftrefill_torch.diffusion.ddim import NoiseFn, ddim_sample
from leftrefill_torch.diffusion.samplers_extra import dpm_solver_pp_2m_sample
from leftrefill_torch.diffusion.schedules import DiffusionSchedule
from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
from leftrefill_torch.models.clip import PromptCLIPEmbedder, build_prompt_tokenizer, init_prompt_table
from leftrefill_torch.models.multiview import MultiViewUnetModel
from leftrefill_torch.models.nvs import NVSCLIPEmbedder, NVSUnetModel, RefinementCNN
from leftrefill_torch.models.tokenizer import SimpleTokenizer, multiview_prompts
from leftrefill_torch.models.unet import UNetModel
from leftrefill_torch.ops.quant import quantize_params_like


def request_device(device) -> torch.device:
    """The request's device; the card unless the caller asked for the CPU,
    and an error, not the CPU, where there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the pipeline runs on the card and CUDA is not available (pass device='cpu' "
                           "to run on the CPU)")
    return dev


@dataclasses.dataclass
class RefInpaintPipeline:
    """Left = reference, right = target canvas; ``sampler`` is "ddim"
    (the reference protocol, DDIM-50 at eta 1) or "dpm++2m".

    ``group`` (JAX's ``mesh``): a ``torch.distributed`` group whose ranks
    split the CFG-doubled UNet batch (``parallel.batch``); every rank of it
    calls the pipeline with the same request and generator seed, runs the
    rest of the request whole and returns the same canvas."""

    model: LeftRefillModel
    tokenizer: SimpleTokenizer
    special_tokens: Sequence[str]
    device: torch.device | str = "cuda"
    ddim_steps: int = 50
    guidance_scale: float = 2.5
    eta: float = 1.0
    sampler: str = "ddim"
    group: Optional[object] = None

    def __post_init__(self):
        if self.sampler not in ("ddim", "dpm++2m"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        self._prompt_tokens = np.asarray(self.tokenizer.tokenize(" ".join(self.special_tokens)))
        self._uncond_tokens = np.asarray(self.tokenizer.tokenize(""))

    def prompt_tokens(self, batch: int) -> np.ndarray:
        return np.repeat(self._prompt_tokens, batch, axis=0)

    def uncond_tokens(self, batch: int) -> np.ndarray:
        return np.repeat(self._uncond_tokens, batch, axis=0)

    @torch.inference_mode()
    def __call__(
        self,
        image,
        mask,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
        vae_noise: Optional[torch.Tensor] = None,
        tokens=None,
    ) -> torch.Tensor:
        """image [B, H, 2W, 3] in [-1, 1] (stitched, NHWC), mask [B, H, 2W, 1]
        with 1 = hole; ``tokens`` [B, 77] replaces the prompt's (the special
        tokens) where given.  Returns the composited canvas [B, H, 2W, 3] fp32."""
        dev = request_device(self.device)
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        b = image.shape[0]
        return _generate(
            self.model, image, mask,
            torch.as_tensor(self.prompt_tokens(b) if tokens is None else tokens, dtype=torch.long, device=dev),
            torch.as_tensor(self.uncond_tokens(b), dtype=torch.long, device=dev),
            ddim_steps=self.ddim_steps, eta=self.eta, guidance_scale=self.guidance_scale,
            sampler=self.sampler, generator=generator, x_T=x_T, noise_fn=noise_fn,
            vae_noise=vae_noise, group=self.group,
        )

    def inpaint_right_half(self, image, mask, generator: Optional[torch.Generator] = None, **kw) -> np.ndarray:
        """The serving return contract: the right half of the composited
        canvas, [B, H, W, 3] fp32 in [-1, 1] (numpy); ``kw`` as ``__call__``'s."""
        out = self(image, mask, generator, **kw)
        return out[:, :, out.shape[2] // 2:].cpu().numpy()


def _generate(
    model: LeftRefillModel,
    image: torch.Tensor,
    mask: torch.Tensor,
    tokens: torch.Tensor,
    uncond_tokens: torch.Tensor,
    *,
    ddim_steps: int,
    eta: float,
    guidance_scale: float,
    sampler: str = "ddim",
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    noise_fn: Optional[NoiseFn] = None,
    vae_noise: Optional[torch.Tensor] = None,
    cfg_dup: bool = True,
    group=None,
) -> torch.Tensor:
    """``cfg_dup``: share the UNet prefix of the CFG pair at half batch (the
    1-reference request; the multi-view UNet runs without it).  ``group``:
    the UNet batch split over its ranks, without the shared prefix."""
    masked_image = image * (mask < 0.5)
    cond = model.build_inpaint_cond(tokens, mask, masked_image, vae_noise)
    uncond = Conditioning(cond.c_concat, model.get_learned_conditioning(uncond_tokens))
    b, h, w, _ = cond.c_concat.shape
    shape = (b, h, w, model.unet.out_channels)
    # the text context is step-invariant: every cross-attention K/V once per
    # canvas, in the [uncond; cond] order of the CFG batch
    use_cfg = guidance_scale != 1.0
    ctx = torch.cat([uncond.c_crossattn, cond.c_crossattn]) if use_cfg else cond.c_crossattn
    kv = model.cross_attention_kv(ctx)
    if group is not None:
        from leftrefill_torch.parallel.batch import batch_parallel_apply

        apply_fn = batch_parallel_apply(model, group, cross_kv=kv)
    else:
        def apply_fn(x, t, c):
            # cond and uncond share x and c_concat: the prefix before the
            # first cross-attention runs once at half batch
            return model.apply_model(x, t, c, cross_kv=kv, cfg_dup=use_cfg and cfg_dup)

    common = dict(uncond=uncond, guidance_scale=guidance_scale, x_T=x_T, generator=generator,
                  device=image.device)
    if sampler == "dpm++2m":
        z = dpm_solver_pp_2m_sample(apply_fn, model.schedule, cond, shape,
                                    num_steps=ddim_steps, **common)
    else:
        tables = model.schedule.ddim_tables(ddim_steps, eta=eta)
        z = ddim_sample(apply_fn, model.schedule, tables, cond, shape, noise_fn=noise_fn, **common)
    pred = model.decode_first_stage(z).to(torch.float32).clamp(-1.0, 1.0)
    return pred * mask + image * (1.0 - mask)


@dataclasses.dataclass
class MultiViewInpaintPipeline:
    """Multi-view reference inpainting (JAX: ``MultiViewRefInpaintTask.log_images``,
    tasks.py:333-351, over the DDIM sampling of tasks.py:142-164, then the
    composite of the test CLI).  A scene is V views; view 0 is the masked
    target and views 1..V-1 carry zero masks.  The B·V views run as one flat
    batch, view j with ``view_prompts[j]``, through a ``MultiViewUnetModel``
    of ``view_num`` V, whose self-attention folds each scene's V rows into
    one sequence.  CFG runs [uncond; cond] as one doubled batch with the
    cross-attention K/V computed once, and without the shared-prefix
    ``cfg_dup``, as JAX's multi-view sampling does."""

    model: LeftRefillModel
    tokenizer: SimpleTokenizer
    view_prompts: Sequence[str]
    device: torch.device | str = "cuda"
    ddim_steps: int = 50
    guidance_scale: float = 2.5
    eta: float = 1.0

    def __post_init__(self):
        self._tokens = np.asarray(self.tokenizer.tokenize(list(self.view_prompts)))
        self._uncond_tokens = np.asarray(self.tokenizer.tokenize(""))

    def prompt_tokens(self, scenes: int) -> np.ndarray:
        """[scenes * V, 77]: each scene's V view prompts in view order."""
        return np.tile(self._tokens, (scenes, 1))

    def uncond_tokens(self, scenes: int) -> np.ndarray:
        return np.repeat(self._uncond_tokens, scenes * len(self.view_prompts), axis=0)

    @torch.inference_mode()
    def __call__(
        self,
        images,
        masks,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
        vae_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """images [B, V, H, W, 3] in [-1, 1] (NHWC), masks [B, V, H, W, 1]
        with 1 = hole.  Returns the composited views [B, V, H, W, 3] fp32;
        ``x_T``, ``noise_fn`` and ``vae_noise`` are over the B·V flat rows."""
        dev = request_device(self.device)
        image = torch.as_tensor(images, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(masks, dtype=torch.float32, device=dev)
        b, v = image.shape[:2]
        if v != len(self.view_prompts):
            raise ValueError(f"{v} views, but {len(self.view_prompts)} view prompts")
        out = _generate(
            self.model, image.flatten(0, 1), mask.flatten(0, 1),
            torch.as_tensor(self.prompt_tokens(b), dtype=torch.long, device=dev),
            torch.as_tensor(self.uncond_tokens(b), dtype=torch.long, device=dev),
            ddim_steps=self.ddim_steps, eta=self.eta, guidance_scale=self.guidance_scale,
            generator=generator, x_T=x_T, noise_fn=noise_fn, vae_noise=vae_noise, cfg_dup=False,
        )
        return out.reshape(b, v, *out.shape[1:])


def stitch_canvas(reference: np.ndarray, source: np.ndarray, mask_right: np.ndarray):
    """[reference | source] side by side with a zero left mask (NHWC)."""
    image = np.concatenate([reference, source], axis=2)
    mask = np.concatenate([np.zeros_like(mask_right), mask_right], axis=2)
    return image, mask


def sd2_schedule() -> DiffusionSchedule:
    return DiffusionSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                                    linear_end=0.0120)


def fill_random_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator``: matrices and conv kernels with
    normals scaled by 1/sqrt(fan-in), embedding tables with 0.02-scaled
    normals, norm scales with 1 + 0.1 * normal, biases with 0.02 * normal."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            n = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
            if "embedding" in name:
                p.copy_(0.02 * n)
            elif p.ndim >= 2:
                p.copy_(n / np.sqrt(p[0].numel()))
            elif "sep_token" in name:  # JAX draws the separator columns from N(0, 1)
                p.copy_(n)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * n)
            else:
                p.copy_(0.02 * n)


def _empty_bundle(device, dtype: torch.dtype, quant: bool, fused: bool, view_num: Optional[int],
                  remat: bool = False, quant_vae: bool = False) -> LeftRefillModel:
    with torch.device("meta"):
        if view_num is None:
            unet, n_special = UNetModel(dtype=dtype, quant=quant, fused=fused, remat=remat), 50
        else:
            unet = MultiViewUnetModel(view_num=view_num, dtype=dtype, quant=quant, fused=fused, remat=remat)
            n_special = len(multiview_prompts(view_num)[0])
        model = LeftRefillModel(
            unet=unet,
            vae=AutoencoderKL(DDConfig(), embed_dim=4, dtype=dtype, quant_decoder=quant_vae),
            cond_model=PromptCLIPEmbedder(dtype=dtype, num_special_tokens=n_special),
            schedule=sd2_schedule(),
        )
    return model.to_empty(device=device)


def build_sd2_inpaint_bundle(
    device="cuda", dtype: torch.dtype = torch.bfloat16, generator: Optional[torch.Generator] = None,
    quant: bool = False, fused: bool = True, view_num: Optional[int] = None, remat: bool = False,
    quant_vae: bool = False,
) -> LeftRefillModel:
    """The full-width SD2-inpainting bundle (865M UNet, f8 VAE, ViT-H text
    tower) computing in ``dtype``, every parameter drawn from ``generator``.

    ``view_num`` V gives the multi-view bundle (``configs/multiview_ref_inpainting.yaml``):
    the UNet is ``MultiViewUnetModel(view_num=V)`` and the text tower holds
    20 + 30·V prompt tokens (``models.tokenizer.multiview_prompts``); by
    default the 1-reference bundle with 50 prompt tokens.

    ``quant=True`` gives the W8A8 int8 UNet, built as ``bench.py`` builds
    the JAX one: the fp32 weights are drawn first, exactly as for the fp
    bundle of the same generator, then the UNet's quantized sites are
    quantized per output channel (``quantize_params_like``).  ``fused``
    (default on, JAX's default) selects its fused int8 prologues;
    ``fused=False`` is JAX's unfused int8 configuration.

    ``quant_vae=True`` (JAX's ``BENCH_QUANT_VAE``) likewise quantizes the VAE
    decoder's int8 sites (``AutoencoderKL(quant_decoder=True)``), so that
    the request decodes through the int8 decoder.

    ``remat=True`` (training, ``leftrefill_torch.train``) recomputes the
    UNet's ResBlocks and SpatialTransformers in the backward, as JAX's
    training UNet does; the forward is the same."""
    if not (quant or quant_vae):
        model = _empty_bundle(device, dtype, False, fused, view_num, remat)
        fill_random_(model, generator)
        return model.eval()
    fp = _empty_bundle(device, torch.float32, False, fused, view_num)
    fill_random_(fp, generator)
    model = _empty_bundle(device, dtype, quant, fused, view_num, remat, quant_vae)
    state = quantize_params_like(model, fp.state_dict())
    del fp
    model.load_state_dict(state, strict=True)
    return model.eval()


# configs/novel_view_synthesis.yaml: the embedder's prompt table and its init text
NVS_SPECIAL_TOKENS = ["repeat_73_<special-token>"]
NVS_INIT_TEXT = ["Left is the reference image, while the right one is the target image with different "
                 "viewpoint. The relative pose:"]
NVS_CFG_RATE = 0.15


@dataclasses.dataclass
class NVSBundle:
    """What ``tasks.NVSTask`` serves: the model, its tokenizer, the prompt
    tokens and the refinement settings (JAX: the ``ModelBundle`` of
    ``configs/novel_view_synthesis.yaml``)."""

    model: LeftRefillModel
    tokenizer: SimpleTokenizer
    special_tokens: Sequence[str]
    refinement_config: dict


def build_sd2_nvs_bundle(
    device="cuda", dtype: torch.dtype = torch.bfloat16, generator: Optional[torch.Generator] = None,
    use_sep: bool = False, refinement: bool = False,
) -> NVSBundle:
    """The full-width novel-view-synthesis bundle of
    ``configs/novel_view_synthesis.yaml`` computing in ``dtype``: the 865M
    ``NVSUnetModel`` (``use_sep``: the separator columns), the f8 VAE, the
    ViT-H ``NVSCLIPEmbedder`` with 73 prompt tokens (initialised from the
    config's init text), CFG dropout 0.15 and no ``pos_strengthen``,
    ``conditioning_key="hybrid-refine"``, and with ``refinement`` the
    refinement branch (fp32, as JAX's); every parameter drawn from
    ``generator``.  On the card unless ``device="cpu"``; without a card it
    raises."""
    dev = request_device(device)
    tok, sp, init = build_prompt_tokenizer(NVS_SPECIAL_TOKENS, NVS_INIT_TEXT)
    with torch.device("meta"):
        model = LeftRefillModel(
            unet=NVSUnetModel(dtype=dtype, use_sep=use_sep),
            vae=AutoencoderKL(DDConfig(), embed_dim=4, dtype=dtype),
            cond_model=NVSCLIPEmbedder(dtype=dtype, num_special_tokens=len(sp), cfg_rate=NVS_CFG_RATE),
            schedule=sd2_schedule(),
            conditioning_key="hybrid-refine",
            refinement=RefinementCNN(320) if refinement else None,
        )
    model = model.to_empty(device=dev)
    fill_random_(model, generator)
    init_prompt_table(model.cond_stage_model, tok, sp, init)
    return NVSBundle(model.eval(), tok, sp, {"use_input_refinement": refinement, "only_masked_refine": False})
