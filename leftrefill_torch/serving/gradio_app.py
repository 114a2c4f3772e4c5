"""Interactive serving of 1-reference inpainting (counterpart of
``leftrefill_tpu/serving/gradio_app.py``): ``initialize_model`` builds the
pipeline of an experiment directory, ``predict`` serves one request (the
reference, the target and its painted mask, resized to ``img_size``
squared, stitched [reference | target] with the target masked, sampled
``num_samples`` times from a seeded start code, the right halves as uint8),
and ``build_ui`` / ``main`` put a gradio page around them.

gradio is imported only inside ``build_ui`` (and so ``main``): without it
those raise ``ImportError`` and ``predict`` / ``initialize_model`` serve
headless.  Everything runs on the card unless the caller passes
``device="cpu"``; without a card it raises.  The start code comes from
``torch.Generator(device).manual_seed(seed)``, so a seed gives other images
than the JAX package's ``jax.random`` draws.

CFG-parallel serving (JAX's ``dp_devices``): ``main --dp N`` under
``torchrun --nproc_per_node N`` builds the pipeline on every rank with the
CFG-doubled UNet batch split over the ranks (``parallel.batch``); rank 0
serves the UI, and each ``predict`` there first hands its arguments to the
other ranks, which run the same request in ``serve_followers`` until
``stop_followers``."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from leftrefill_torch.data.image_io import INTER_AREA, INTER_NEAREST, resize
from leftrefill_torch.pipeline import RefInpaintPipeline, request_device, stitch_canvas

INIT_SEED = 42  # JAX's initialize_model draws the random weights from PRNGKey(42)


def pad_to_multiple(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Pad H and W up to a multiple of ``multiple`` by repeating the last
    row and column."""
    h, w = img.shape[:2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return img
    return np.pad(img, [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2), mode="edge")


def load_experiment(exp_dir: str, sd_ckpt: Optional[str] = None, seed: int = INIT_SEED, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """The task of an experiment directory with its parameters: the bundle
    of ``<exp_dir>/model_config.yaml`` (``config.build_model_from_config``)
    computing in ``dtype`` (bf16 on the card, fp32 on the CPU), every
    parameter drawn from a generator seeded ``seed``, the SD checkpoint
    ``sd_ckpt`` over them where the file exists (``convert.checkpoint``), the
    prompt table from its init text, then the best (or ``last``) checkpoint
    of ``<exp_dir>/ckpts`` restored over them (``train.checkpoints``).  The
    bundle is the task's ``.bundle``."""
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.tasks import build_task
    from leftrefill_torch.train.checkpoints import CheckpointManager, restore_over_base

    dev = request_device(device)
    if dtype is None:
        dtype = compute_dtype(dev)
    bundle = build_model_from_config(os.path.join(exp_dir, "model_config.yaml"), dtype=dtype, device=dev)
    task = build_task(bundle, dev)
    sd_sd = None
    if sd_ckpt and os.path.exists(sd_ckpt):
        from leftrefill_torch.convert.checkpoint import load_torch_state_dict

        sd_sd = load_torch_state_dict(sd_ckpt)
    task.init_params(torch.Generator(dev).manual_seed(seed), sd_state_dict=sd_sd)
    ckpt_dir = os.path.join(exp_dir, "ckpts")
    if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        mgr = CheckpointManager(ckpt_dir)
        name = mgr.best_name() or "last"
        restore_over_base(bundle.model, mgr.restore(name))
        print(f"Restored trained weights from {name}")
    return task


def compute_dtype(device) -> torch.dtype:
    """The entry points' compute dtype: bf16 on the card, fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def initialize_model(
    exp_dir: str,
    sd_ckpt: Optional[str] = None,
    img_size: int = 512,
    quantized: bool = False,
    dp_devices: int = 0,
    quant_vae: bool = False,
    sampler: str = "ddim",
    device="cuda",
) -> RefInpaintPipeline:
    """The serving pipeline of an experiment directory (``load_experiment``
    with JAX's seed 42), bf16 on the card and fp32 on the CPU; DDIM at eta 1
    or ``sampler`` "dpm++2m".  ``img_size`` is JAX's (it sizes JAX's
    parameter init; the port's modules take any size).

    ``quantized=True`` gives JAX's default int8 UNet (W8A8, the fused
    prologues): the weights are drawn, loaded and restored in fp32, the
    UNet's quantized sites quantized per output channel
    (``ops.quant.quantize_params_like``) into an int8 UNet and the other
    modules' weights copied into the serving dtype.  ``quant_vae`` does the
    same for the VAE decoder's int8 sites (JAX: gradio_app.py:106-118,
    ``AutoencoderKL(quant_decoder=True)``), with or without ``quantized``.

    ``dp_devices > 1`` splits the CFG-doubled UNet batch over the ranks of
    the initialised default process group, whose size it must be (torchrun
    starts them; ``parallel.mesh.init_from_env`` gives each its
    ``device``); every rank calls this, and the ranks other than 0 then run
    ``serve_followers``."""
    import torch.distributed as dist

    from leftrefill_torch.config import build_model_from_config, instantiate_from_config
    from leftrefill_torch.models.autoencoder import AutoencoderKL
    from leftrefill_torch.ops.quant import quantize_params_like

    del img_size
    group = None
    if dp_devices and dp_devices > 1:
        if not dist.is_initialized() or dist.get_world_size() != dp_devices:
            raise RuntimeError(f"dp_devices={dp_devices} serves from {dp_devices} ranks: start them with "
                               f"torchrun (python -m torch.distributed.run --nproc_per_node {dp_devices} -m "
                               f"leftrefill_torch.serving.gradio_app --dp {dp_devices} ...)")
        group = dist.group.WORLD
    dev = request_device(device)
    dtype = compute_dtype(dev)
    bundle = load_experiment(exp_dir, sd_ckpt, INIT_SEED, dev,
                             torch.float32 if quantized or quant_vae else dtype).bundle
    if quantized or quant_vae:  # the served bundle on meta, its int8 parts, then filled from the fp32 one
        fp_model = bundle.model
        bundle = build_model_from_config(os.path.join(exp_dir, "model_config.yaml"), dtype=dtype, device="meta")
        with torch.device("meta"):
            if quantized:
                bundle.model.model.diffusion_model = instantiate_from_config(
                    bundle.raw_config["model"]["params"]["unet_config"], dtype=dtype, quant=True)
            if quant_vae:
                vae = bundle.model.first_stage_model
                bundle.model.first_stage_model = AutoencoderKL(vae.ddconfig, vae.embed_dim, dtype=dtype,
                                                               quant_decoder=True)
        state = quantize_params_like(bundle.model, fp_model.state_dict())
        del fp_model
        bundle.model.to_empty(device=dev).eval().load_state_dict(state, strict=True)
        del state
    return RefInpaintPipeline(model=bundle.model, tokenizer=bundle.tokenizer, special_tokens=bundle.special_tokens,
                              device=dev, eta=1.0, sampler=sampler, group=group)


def pipeline_variant(pipeline: RefInpaintPipeline, ddim_steps: int, scale: float,
                     sampler: Optional[str] = None) -> RefInpaintPipeline:
    """The pipeline of a request's (steps, scale, sampler): the base one
    where they are its own, else a copy sharing its model, made once per
    configuration and kept on the base pipeline (so that concurrent requests
    never change a shared object)."""
    sampler = sampler or pipeline.sampler
    if (ddim_steps, scale, sampler) == (pipeline.ddim_steps, pipeline.guidance_scale, pipeline.sampler):
        return pipeline
    cache = pipeline.__dict__.setdefault("_variants", {})
    key = (ddim_steps, scale, sampler)
    if key not in cache:
        cache[key] = dataclasses.replace(pipeline, ddim_steps=ddim_steps, guidance_scale=scale, sampler=sampler)
    return cache[key]


def request_canvas(reference: np.ndarray, source: np.ndarray, mask: np.ndarray, num_samples: int = 1,
                   img_size: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """``predict``'s canvas: both images resized to img_size squared (area),
    the mask (nearest, its first channel, any painted pixel a hole), each
    padded to a multiple of 64 by edge repetition, in [-1, 1], stitched
    [reference | source] with a zero left mask, repeated ``num_samples``
    times.  Returns (image [N, H, 2W, 3], mask [N, H, 2W, 1]) fp32."""
    ref = resize(np.asarray(reference), (img_size, img_size), INTER_AREA)
    src = resize(np.asarray(source), (img_size, img_size), INTER_AREA)
    m = resize(np.asarray(mask), (img_size, img_size), INTER_NEAREST)
    if m.ndim == 3:
        m = m[..., 0]
    m = (m > 0).astype(np.float32)
    ref, src = pad_to_multiple(ref), pad_to_multiple(src)
    m = pad_to_multiple(m)[None, :, :, None]
    ref = (ref.astype(np.float32) / 127.5 - 1.0)[None]
    src = (src.astype(np.float32) / 127.5 - 1.0)[None]
    image, full_mask = stitch_canvas(ref, src, m)
    return np.repeat(image, num_samples, axis=0), np.repeat(full_mask, num_samples, axis=0)


def predict(
    pipeline: RefInpaintPipeline,
    reference: np.ndarray,
    source: np.ndarray,
    mask: np.ndarray,
    ddim_steps: int = 50,
    num_samples: int = 1,
    scale: float = 2.5,
    seed: int = 42,
    img_size: int = 512,
    sampler: Optional[str] = None,
) -> list[np.ndarray]:
    """One request: uint8 RGB ``reference`` and ``source`` and the painted
    ``mask`` (grey or colour; nonzero = hole) of any sizes -> ``num_samples``
    inpainted targets, [img_size, img_size, 3] uint8 each.  The start code
    x_T is the first draw of ``torch.Generator(device).manual_seed(seed)``,
    which then draws the sampler's noise; the result is truncated to uint8
    after clipping, as JAX's.  On rank 0 of a CFG-parallel pipeline the
    request is first handed to the ranks in ``serve_followers``."""
    args = (reference, source, mask, ddim_steps, num_samples, scale, seed, img_size, sampler)
    if pipeline.group is not None:
        _broadcast_request(args)
    return _predict(pipeline, *args)


def _broadcast_request(args):
    import torch.distributed as dist

    box = [args]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def serve_followers(pipeline: RefInpaintPipeline) -> int:
    """The loop of a CFG-parallel pipeline's ranks other than 0: run each
    request rank 0's ``predict`` hands over, until ``stop_followers``.
    Returns the number of requests served."""
    served = 0
    while True:
        args = _broadcast_request(None)
        if args is None:
            return served
        _predict(pipeline, *args)
        served += 1


def stop_followers(pipeline: RefInpaintPipeline) -> None:
    """On rank 0: end the followers' ``serve_followers`` loops."""
    if pipeline.group is not None:
        _broadcast_request(None)


def _predict(pipeline, reference, source, mask, ddim_steps, num_samples, scale, seed, img_size, sampler):
    image, full_mask = request_canvas(reference, source, mask, num_samples, img_size)
    pipeline = pipeline_variant(pipeline, ddim_steps, scale, sampler)
    dev = request_device(pipeline.device)
    model = pipeline.model
    ds = 2 ** (len(model.first_stage_model.ddconfig.ch_mult) - 1)  # the VAE's downsampling
    generator = torch.Generator(dev).manual_seed(seed)
    x_T = torch.randn((num_samples, image.shape[1] // ds, image.shape[2] // ds, model.unet.out_channels),
                      generator=generator, device=dev)
    right = pipeline.inpaint_right_half(image, full_mask, generator, x_T=x_T)
    right = right[:, :img_size, :img_size]  # drop the edge padding (none at 512)
    return [np.clip((r + 1) * 127.5, 0, 255).astype(np.uint8) for r in right]


def _gradio():
    try:
        import gradio
    except ImportError as e:
        raise ImportError("gradio is not installed: serve headless through predict()") from e
    return gradio


def build_ui(pipeline: RefInpaintPipeline):
    """The gradio Blocks page: reference, target with a sketched mask,
    steps, number of images, guidance scale, seed and sampler."""
    gr = _gradio()

    with gr.Blocks() as demo:
        gr.Markdown("## LeftRefill: reference-guided inpainting")
        with gr.Row():
            ref_img = gr.Image(label="Reference (left)", type="numpy")
            src_img = gr.Image(label="Target with mask sketch", type="numpy", tool="sketch")
            out_gallery = gr.Gallery(label="Results")
        with gr.Row():
            steps = gr.Slider(1, 200, value=50, step=1, label="Steps")
            n_samples = gr.Slider(1, 4, value=1, step=1, label="Images")
            scale = gr.Slider(0.0, 10.0, value=2.5, step=0.1, label="Guidance Scale")
            seed = gr.Slider(0, 2147483647, value=42, step=1, label="Seed")
            sampler = gr.Dropdown(["ddim", "dpm++2m"], value=pipeline.sampler, label="Sampler")
        run = gr.Button("Inpaint")

        def _run(ref, src_and_mask, steps, n, scale, seed, sampler):
            return predict(pipeline, ref, src_and_mask["image"], src_and_mask["mask"],
                           int(steps), int(n), float(scale), int(seed), sampler=str(sampler))

        run.click(_run, [ref_img, src_img, steps, n_samples, scale, seed, sampler], [out_gallery])
    return demo


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--sd_ckpt", default=None)
    p.add_argument("--port", default=7860, type=int)
    p.add_argument("--quantized", action="store_true", help="W8A8 int8 UNet (JAX's fused configuration)")
    p.add_argument("--dp", default=0, type=int,
                   help="ranks for the CFG-doubled UNet batch (> 1: under torchrun --nproc_per_node N)")
    p.add_argument("--sampler", default="ddim", choices=["ddim", "dpm++2m"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    _gradio()  # before the model is built
    device, rank = args.device, 0
    if args.dp > 1:
        from leftrefill_torch.parallel.mesh import init_from_env

        ranks = init_from_env(args.device)
        device, rank = ranks.device, ranks.rank
    pipe = initialize_model(args.model_path, args.sd_ckpt, quantized=args.quantized, dp_devices=args.dp,
                            sampler=args.sampler, device=device)
    if rank:
        serve_followers(pipe)
        return
    try:
        build_ui(pipe).launch(server_port=args.port)
    finally:
        stop_followers(pipe)


if __name__ == "__main__":
    main()
