"""The quality studies of the port: how far its own paths move the output,
on random weights (counterparts of the JAX package's
``scripts/tpu_r3_int8_quality.py``, ``tpu_r4_mv_quality.py``,
``tpu_r5_solver_quality.py`` with its CPU precursor ``cpu_dpm20_quality.py``,
and ``cpu_vae8_quality.py``):

    python -m leftrefill_torch.tools.quality {int8,mv,solver,vae8,all} [--tiny] [--device cpu] [--seed 0]

- ``int8``: (1) the eps deviation of the bf16 and the fused W8A8 int8 UNet
  from an fp32 forward of the same weights at t in {1, 250, 500, 750, 999}
  (B = 2 at the canvas latent, 64x128): ``max_rel`` and ``mean_rel``, the
  largest and the mean absolute difference over the fp32 output's rms;
  (2) bf16 against int8 through a whole DDIM-50 request (eta 1, CFG 2.5) on
  the same 512x1024 canvas and seed: PSNR over [-1, 1] (peak-to-peak 2),
  MSE and the largest difference.
- ``mv``: the same two parts on the V=2 multi-view UNet (its joint
  self-attention over 2 x 8192 tokens), part (2) a 2-view CFG DDIM-50 scene
  and its VAE decode.
- ``solver``: from one x_T (the pipeline's ``x_T`` input), the eta-0 ODE
  family (a DDIM-200 gold trajectory, DDIM-50, DPM++(2M)-20, -15 and -12)
  and the eta-1 family (DDIM-50 and DDIM-200 from one base generator): each
  run's PSNR against gold over the decoded right half,
  ``psnr_ddim50eta1_vs_ddim200eta1_db`` (the reference protocol's own
  spread) and ``dpm15_vs_ddim50eta0``.  ``--tiny`` is the CPU precursor's
  bundle.
- ``vae8``: one latent (a unit normal over the scale factor, as decode
  receives it) through the fp32, bf16 and int8 VAE decoders: the three
  PSNRs.  The port's plain int8 versions quantize activations as the kernels
  do, so no switch is needed for exact W8A8 numerics on the CPU.

Weights: every parameter drawn from the generator (``pipeline.fill_random_``),
then the UNet's and the VAE's redrawn with the JAX scripts' "realistic" init
(``tools.weights.realistic_init_``) and any all-zero weight filled
(``unzero_``).  These numbers bound the kernels' and the quantization's
noise on random weights; they say nothing of a trained model's quality.
The JAX scripts' ``bf16_fp32_affine`` arm has no counterpart: the port's
UNet has no switch for the GroupNorm affine's precision.

Each study is a function of ``device`` and ``generator`` (``chip_smoke.py``
calls them), returns its numbers and prints one JSON line with the card's
name and power limit (``tools.card_line``) beside them.  The ``draws``
arguments take the inputs and random streams from outside (the CPU tests
feed JAX's draws, which torch cannot reproduce).  Full width on the card by
default; ``--tiny`` with ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import warnings
from typing import Optional

import torch

from leftrefill_torch import tools

TIMESTEPS = (1, 250, 500, 750, 999)
GUIDANCE = 2.5
SEED = 7  # the request generator's seed (the JAX scripts' PRNGKey(7))
SOLVER_RUNS = {  # name -> (sampler, steps, eta)
    "gold_ddim200": ("ddim", 200, 0.0),
    "ddim50_eta0": ("ddim", 50, 0.0),
    "dpm20": ("dpm++2m", 20, 0.0),
    "dpm15": ("dpm++2m", 15, 0.0),
    "dpm12": ("dpm++2m", 12, 0.0),
    "ddim50_eta1": ("ddim", 50, 1.0),
    "ddim200_eta1": ("ddim", 200, 1.0),
}


@dataclasses.dataclass(frozen=True)
class Arch:
    """A bundle's shape: the UNet's, VAE's (``DDConfig``) and text tower's
    keyword arguments, the square image side (the canvas is side x 2 side),
    and the prompt table's tokens and init text."""

    unet: dict
    vae: dict
    clip: dict
    side: int
    special_tokens: tuple
    init_text: Optional[tuple]

    @property
    def context_dim(self) -> int:
        return self.unet.get("context_dim", 1024)

    @property
    def latent_hw(self) -> tuple:
        ds = 2 ** (len(self.vae.get("ch_mult", (1, 2, 4, 4))) - 1)
        return self.side // ds, 2 * self.side // ds


# the SD2-inpainting bundle at full width (865M UNet, f8 VAE, ViT-H text tower, 50 prompt tokens)
FULL = Arch({}, {}, {"num_special_tokens": 50}, 512, ("repeat_50_<special-token>",), ("init",))
# the tiny bundle of the JAX package's tests/test_pipeline.py (a 2x VAE, 4 prompt tokens)
TINY = Arch(dict(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1, attention_resolutions=(1,),
                 channel_mult=(1, 2), num_head_channels=8, context_dim=24),
            dict(z_channels=4, resolution=64, ch=16, ch_mult=(1, 2), num_res_blocks=1),
            dict(vocab_size=49408, width=24, heads=2, layers=2, num_special_tokens=4),
            32, tuple(f"<special-token{i}>" for i in range(4)), None)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off inside, so that an fp32 reference is fp32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def bundle(arch: Arch, device, dtype: torch.dtype, state: Optional[dict] = None, quant: bool = False,
           quant_vae: bool = False, view_num: Optional[int] = None):
    """The bundle of ``arch`` computing in ``dtype`` on ``device`` (the
    fused int8 UNet with ``quant``, the int8 VAE decoder with ``quant_vae``,
    the multi-view UNet with ``view_num``), loaded from the fp32 ``state``
    (its int8 sites quantized per output channel)."""
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.ops.quant import quantize_params_like
    from leftrefill_torch.pipeline import sd2_schedule

    with torch.device("meta"):
        unet = (UNetModel(dtype=dtype, quant=quant, **arch.unet) if view_num is None
                else MultiViewUnetModel(view_num=view_num, dtype=dtype, quant=quant, **arch.unet))
        model = LeftRefillModel(unet, AutoencoderKL(DDConfig(**arch.vae), embed_dim=4, dtype=dtype,
                                                    quant_decoder=quant_vae),
                                PromptCLIPEmbedder(dtype=dtype, **arch.clip), sd2_schedule())
    model = model.to_empty(device=device)
    if state is not None:
        model.load_state_dict(quantize_params_like(model, state), strict=True)
    return model.eval()


def draw_state(arch: Arch, generator: torch.Generator, view_num: Optional[int] = None) -> dict:
    """The studies' fp32 weights, on the generator's device: every parameter
    from ``fill_random_``, then the UNet's and the VAE's from
    ``realistic_init_``, then ``unzero_`` over all."""
    from leftrefill_torch.pipeline import fill_random_
    from leftrefill_torch.tools.weights import realistic_init_, unzero_

    model = bundle(arch, generator.device, torch.float32, view_num=view_num)
    fill_random_(model, generator)
    realistic_init_(model.unet.state_dict(), generator)
    realistic_init_(model.first_stage_model.state_dict(), generator)
    return unzero_(dict(model.state_dict()), generator)


def eps_inputs(arch: Arch, generator: torch.Generator, rows: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Part (1)'s inputs: x [rows, *latent, 9] unit normal, the context
    [rows, 77, C] half a unit normal."""
    dev = generator.device
    x = torch.randn((rows, *arch.latent_hw, 9), generator=generator, device=dev)
    ctx = 0.5 * torch.randn((rows, 77, arch.context_dim), generator=generator, device=dev)
    return x, ctx


@torch.inference_mode()
def eps_sweep(ref, arms: dict, x: torch.Tensor, ctx: torch.Tensor, timesteps=TIMESTEPS) -> list[dict]:
    """Part (1): for each t, each UNet of ``arms`` against the fp32 UNet
    ``ref`` on the same inputs: {"t", "ref_rms", name: {"max_rel",
    "mean_rel"}}, the absolute difference's largest and mean value over the
    fp32 output's rms."""
    lines = []
    for t_val in timesteps:
        tt = torch.full((x.shape[0],), t_val, dtype=torch.long, device=x.device)
        with fp32_exact():
            r = ref(x, tt, ctx).float()
        rms = float(r.square().mean().sqrt())
        line = {"t": t_val, "ref_rms": rms}
        for name, unet in arms.items():
            d = (unet(x, tt, ctx).float() - r).abs()
            line[name] = {"max_rel": float(d.max()) / rms, "mean_rel": float(d.mean()) / rms}
        lines.append(line)
    return lines


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR over [-1, 1] (peak-to-peak 2, so peak^2 = 4)."""
    mse = float((a.double() - b.double()).square().mean())
    return 10 * math.log10(4.0 / max(mse, 1e-12))


def _ab(a: torch.Tensor, b: torch.Tensor) -> dict:
    return {"mse": float((a.double() - b.double()).square().mean()), "psnr_bf16_vs_int8_db": psnr_db(a, b),
            "maxdiff": float((a.float() - b.float()).abs().max())}


def pipeline(arch: Arch, model, device, **kw):
    """The 1-reference pipeline of ``model`` with ``arch``'s prompt tokens
    (``kw``: steps, eta, sampler, as ``RefInpaintPipeline``'s)."""
    from leftrefill_torch.models.clip import build_prompt_tokenizer
    from leftrefill_torch.pipeline import RefInpaintPipeline

    with warnings.catch_warnings():  # no merges file: the byte-level vocab
        warnings.simplefilter("ignore")
        tok, sp, _ = build_prompt_tokenizer(list(arch.special_tokens), arch.init_text and list(arch.init_text))
    return RefInpaintPipeline(model=model, tokenizer=tok, special_tokens=sp, device=device, guidance_scale=GUIDANCE,
                              **kw)


def _draws(draws: Optional[dict], *keys) -> dict:
    return {k: v for k, v in (draws or {}).items() if k in keys}


def card() -> str:
    return tools.card_line() if torch.cuda.is_available() else "cpu"


def int8_bundles(arch: Arch, state: dict, device) -> dict:
    """The int8 study's bundles of one fp32 state: "fp32", "bf16", "int8"
    (fused W8A8, JAX's default)."""
    return {"fp32": bundle(arch, device, torch.float32, state), "bf16": bundle(arch, device, torch.bfloat16, state),
            "int8": bundle(arch, device, torch.bfloat16, state, quant=True)}


def int8_study(device="cuda", generator: Optional[torch.Generator] = None, arch: Arch = FULL,
               state: Optional[dict] = None, bundles: Optional[dict] = None, steps: int = 50,
               draws: Optional[dict] = None) -> dict:
    """``scripts/tpu_r3_int8_quality.py``: part (1), the eps sweep of the
    bf16 and int8 UNets from fp32; part (2), bf16 against int8 through a
    DDIM-``steps`` request at eta 1, CFG 2.5, the same seed.  ``draws``:
    "x" and "ctx" (part (1)), "x_T", "noise_fn", "vae_noise" (part (2))."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    if bundles is None:
        bundles = int8_bundles(arch, draw_state(arch, gen) if state is None else state, dev)
    x, ctx = (draws["x"], draws["ctx"]) if draws and "x" in draws else eps_inputs(arch, gen)
    eps = eps_sweep(bundles["fp32"].unet, {"bf16": bundles["bf16"].unet, "int8": bundles["int8"].unet}, x, ctx)
    image, mask = tools.request_canvas(side=arch.side)
    outs = {name: pipeline(arch, bundles[name], dev, ddim_steps=steps, eta=1.0)(
                image, mask, torch.Generator(dev).manual_seed(SEED), **_draws(draws, "x_T", "noise_fn", "vae_noise"))
            for name in ("bf16", "int8")}
    return {"study": "int8", "eps": eps,
            "pipeline_ab": {"sampler": f"ddim{steps}", "eta": 1.0, "scale": GUIDANCE, **_ab(outs["bf16"], outs["int8"])},
            "seconds": time.perf_counter() - t0}


def mv_study(device="cuda", generator: Optional[torch.Generator] = None, arch: Arch = FULL,
             state: Optional[dict] = None, views: int = 2, steps: int = 50, draws: Optional[dict] = None) -> dict:
    """``scripts/tpu_r4_mv_quality.py``: part (1) on the ``views``-view
    multi-view UNet (x [V, *latent, 9]); part (2), one V-view scene (zero
    c_concat, the part-(1) context against a zero unconditional one, CFG
    2.5, DDIM-``steps`` at eta 1, the bf16 VAE decode) in bf16 and int8 from
    the same x_T and noise.  ``draws``: "x", "ctx", "x_T", "noise_fn"."""
    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.diffusion.ddim import ddim_sample

    t0 = time.perf_counter()
    dev = torch.device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    state = draw_state(arch, gen, views) if state is None else state
    arms = {"fp32": bundle(arch, dev, torch.float32, state, view_num=views),
            "bf16": bundle(arch, dev, torch.bfloat16, state, view_num=views),
            "int8": bundle(arch, dev, torch.bfloat16, state, quant=True, view_num=views)}
    x, ctx = (draws["x"], draws["ctx"]) if draws and "x" in draws else eps_inputs(arch, gen, views)
    eps = eps_sweep(arms.pop("fp32").unet, {k: m.unet for k, m in arms.items()}, x, ctx)
    h, w = arch.latent_hw
    c_concat = torch.zeros((views, h, w, 5), device=dev)
    cond, uncond = Conditioning(c_concat, ctx), Conditioning(c_concat, torch.zeros_like(ctx))
    x_T = draws["x_T"] if draws and "x_T" in draws else torch.randn((views, h, w, 4), generator=gen, device=dev)
    outs = {}
    for name, m in arms.items():
        with torch.inference_mode():
            kv = m.cross_attention_kv(torch.cat([uncond.c_crossattn, cond.c_crossattn]).to(m.unet.dtype))
            z = ddim_sample(lambda xx, tt, cc, m=m, kv=kv: m.apply_model(xx, tt, cc, cross_kv=kv), m.schedule,
                            m.schedule.ddim_tables(steps, eta=1.0), cond, (views, h, w, 4), uncond=uncond,
                            guidance_scale=GUIDANCE, x_T=x_T, generator=torch.Generator(dev).manual_seed(SEED),
                            noise_fn=(draws or {}).get("noise_fn"), device=dev)
            outs[name] = m.decode_first_stage(z).float()
    return {"study": "mv", "views": views, "eps": eps,
            "scene_ab": {"sampler": f"ddim{steps}", "eta": 1.0, "scale": GUIDANCE, **_ab(outs["bf16"], outs["int8"])},
            "seconds": time.perf_counter() - t0}


def solver_study(device="cuda", generator: Optional[torch.Generator] = None, arch: Arch = FULL,
                 state: Optional[dict] = None, dtype: Optional[torch.dtype] = None, runs: Optional[dict] = None,
                 draws: Optional[dict] = None) -> dict:
    """``scripts/tpu_r5_solver_quality.py`` (``cpu_dpm20_quality.py`` with
    the tiny ``arch``): every run of ``runs`` (default ``SOLVER_RUNS``) from
    one x_T, CFG 2.5, the eta-1 runs from one generator seed, in ``dtype``
    (bf16 on the card, fp32 on the CPU); PSNR over the decoded right half
    against ``gold_ddim200``.  ``draws``: "x_T", "noise_fn" (the eta-1
    runs' step noise), "vae_noise"."""
    from leftrefill_torch.serving.gradio_app import compute_dtype

    t0 = time.perf_counter()
    dev = torch.device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    state = draw_state(arch, gen) if state is None else state
    model = bundle(arch, dev, dtype or compute_dtype(dev), state)
    image, mask = tools.request_canvas(side=arch.side)
    x_T = draws["x_T"] if draws and "x_T" in draws else torch.randn((1, *arch.latent_hw, 4), generator=gen, device=dev)
    outs = {}
    for name, (sampler, steps, eta) in (runs or SOLVER_RUNS).items():
        outs[name] = pipeline(arch, model, dev, ddim_steps=steps, eta=eta, sampler=sampler)(
            image, mask, torch.Generator(dev).manual_seed(SEED), x_T=x_T,
            **_draws(draws, "noise_fn", "vae_noise"))[:, :, arch.side:]  # the generated right half
    gold = outs["gold_ddim200"]
    report = {n: {"psnr_vs_gold_db": psnr_db(o, gold)} for n, o in outs.items() if n != "gold_ddim200"}
    if {"ddim50_eta1", "ddim200_eta1"} <= set(outs):
        report["eta1_self_spread"] = {"psnr_ddim50eta1_vs_ddim200eta1_db":
                                      psnr_db(outs["ddim50_eta1"], outs["ddim200_eta1"])}
    if {"dpm15", "ddim50_eta0"} <= set(outs):
        report["dpm15_vs_ddim50eta0"] = {"psnr_db": psnr_db(outs["dpm15"], outs["ddim50_eta0"])}
    return {"study": "solver", "dtype": str(next(model.parameters()).dtype).replace("torch.", ""), **report,
            "seconds": time.perf_counter() - t0}


def vae8_study(device="cuda", generator: Optional[torch.Generator] = None, arch: Arch = FULL,
               state: Optional[dict] = None, draws: Optional[dict] = None) -> dict:
    """``scripts/cpu_vae8_quality.py``: one latent z [1, *latent, 4] (a
    unit normal over the scale factor 0.18215) through the fp32, bf16 and
    int8 decoders.  ``state``: the VAE's fp32 state_dict; ``draws``: "z"."""
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.ops.quant import quantize_params_like
    from leftrefill_torch.tools.weights import realistic_init_

    t0 = time.perf_counter()
    dev = torch.device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)

    def vae(dtype, quant=False):
        with torch.device("meta"):
            m = AutoencoderKL(DDConfig(**arch.vae), embed_dim=4, dtype=dtype, quant_decoder=quant)
        return m.to_empty(device=dev).eval()

    if state is None:
        state = realistic_init_(dict(vae(torch.float32).state_dict()), gen)
    z = draws["z"] if draws and "z" in draws else (
        torch.randn((1, *arch.latent_hw, 4), generator=gen, device=dev) / 0.18215)
    dec = {}
    for name, dtype, quant in (("fp32", torch.float32, False), ("bf16", torch.bfloat16, False),
                               ("int8", torch.bfloat16, True)):
        m = vae(dtype, quant)
        m.load_state_dict(quantize_params_like(m, state), strict=True)
        with torch.inference_mode(), fp32_exact():
            dec[name] = m.decode(z).float()
    return {"study": "vae8", "shape": list(dec["fp32"].shape), "psnr_fp32_vs_bf16_db": psnr_db(dec["fp32"], dec["bf16"]),
            "psnr_bf16_vs_int8_db": psnr_db(dec["bf16"], dec["int8"]),
            "psnr_fp32_vs_int8_db": psnr_db(dec["fp32"], dec["int8"]),
            "maxdiff_bf16_vs_int8": float((dec["bf16"] - dec["int8"]).abs().max()),
            "out_rms": float(dec["fp32"].square().mean().sqrt()), "seconds": time.perf_counter() - t0}


STUDIES = {"int8": int8_study, "mv": mv_study, "solver": solver_study, "vae8": vae8_study}


def emit(result: dict, arch_name: str, device) -> str:
    """The study's JSON line: its numbers beside the card (or "cpu") and the
    bundle's width."""
    line = json.dumps({**result, "arch": arch_name, "device": str(device), "card": card()})
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    from leftrefill_torch.pipeline import request_device

    p = argparse.ArgumentParser(description="The port's quality studies on random weights")
    p.add_argument("study", choices=(*STUDIES, "all"))
    p.add_argument("--tiny", action="store_true", help="the tiny bundle (for the CPU) instead of full width")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="the weights' and inputs' generator seed")
    args = p.parse_args(argv)
    dev = request_device(args.device)
    arch, name = (TINY, "tiny") if args.tiny else (FULL, "full")
    for study in (STUDIES if args.study == "all" else (args.study,)):
        emit(STUDIES[study](dev, torch.Generator(dev).manual_seed(args.seed), arch), name, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
