"""The real-weights runbook: one command from the released artifacts to
numbers (counterpart of ``scripts/real_weights_runbook.py``).  When the SD2
512-inpainting checkpoint, the OpenCLIP BPE merges file and the LPIPS
weights are in the repository:

    python -m leftrefill_torch.tools.runbook \\
        --sd_ckpt 512-inpainting-ema.ckpt \\
        --bpe_merges bpe_simple_vocab_16e6.txt.gz \\
        --lpips_weights lpips_alex.pth \\
        --model_config configs/ref_inpainting.yaml \\
        [--prompt_ckpt check_points/run1/ckpts] \\
        --test_path <megadepth match_test_image_pairs dir> \\
        --out runbook_out [--limit 25] [--device cpu]

It only takes paths: nothing is downloaded.  Stages (each prints PASS or
FAIL with its numbers; ``<out>/report.json`` holds them all; the exit code
is 1 when any stage fails, and an error in a stage is raised, never passed):

1. tokenizer: the BPE engine of the merges file
   (``models.tokenizer.SimpleTokenizer(bpe_path=)``); with the full OpenCLIP
   merges (more than 40000) the canonical ids of 'a photo of a cat', else
   the engine's smoke check (the start token first, the end token present).
2. convert: the checkpoint (``convert.checkpoint.load_torch_state_dict``)
   loaded over the bundle of the model YAML (``load_over_base``): the
   counts of keys skipped by design, missing, of another shape and
   unexpected.  It passes when nothing but the trained prompt table
   (``special_embeddings``) is missing, nothing has another shape or is
   unexpected, and fewer than 5 keys are skipped besides the schedule's
   buffers and the EMA copy (``checkpoint.recomputed``).  The JAX runbook
   counts every skipped key against its 5, which a LatentDiffusion
   checkpoint's 12 schedule buffers alone exceed.
3. parity: on the loaded weights, one CFG-doubled UNet call (the first test
   pair's canvas at t = 500, the text tower's context, the cross-attention
   K/V cache and the shared CFG prefix, as the sampler makes it) and one VAE
   decode of that canvas's latent.  On the card: through the kernels against
   the same calls with the kernels routed to their plain versions
   (``kernels.plain_kernels``): the bf16 UNet call, and the fused int8
   bundle's UNet call and int8 VAE decode, each within relative L2 3e-2 (a
   wrong kernel reads about 1; the bf16 decoder runs no kernel, so it has
   nothing to hold there).  Two int8 forwards that differ anywhere drift apart to the int8
   noise level (~5e-2 on random weights), so the int8 UNet is held block by
   block, each block fed the kernels' input to it (``tools.teacher_forced``),
   its end-to-end reading printed beside.  On the CPU, where only the plain
   versions exist: the bf16 calls against fp32, the rounding floor, within
   the same limit.  This replaces the JAX runbook's ``golden`` stage, which
   loaded the checkpoint into torch oracles from the reference checkout to
   hold the JAX modules to them: the port is itself torch, held to the JAX
   package by its tests, so on real weights what is left to check is the
   port's own kernels against their plain versions.  Real weights bring the
   activation outliers random weights lack, and those are what K1's clamp
   of the scores at 75 and the int8 scales meet.
4. eval: the evaluation CLI (``cli.test``) on the test pairs with LPIPS,
   ``--limit`` batches at DDIM-50 (a synthetic run: 4 steps on the CPU, 10
   on the card); it passes when the metrics file holds PSNR, SSIM and (with
   LPIPS weights) LPIPS.
5. ab: the serving pipeline (``serving.gradio_app.initialize_model``) in
   bf16, fused int8 (``quantized=True``) and fused int8 with the int8 VAE
   decoder (``quant_vae=True``) on the same first pairs (2 to 8) with the
   same generator: each variant's PSNR and SSIM (``eval.metrics.composite_metrics``)
   and the cross-PSNR of bf16 against each int8 variant over [-1, 1]
   (peak-to-peak 2); on the card also each variant's kernel launches.

``--synthetic`` writes stand-ins in the real formats under ``<out>/synthetic``
and runs every stage on them (``build_synthetic``): the dry run that keeps
the runbook working until the artifacts arrive; ``--full_width`` makes them
at the width of ``configs/ref_inpainting.yaml`` (865M UNet, f8 VAE, ViT-H
text tower; a 2.6 GB fp16 checkpoint).  Everything runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import time
import warnings

import numpy as np
import torch

CANONICAL = [49406, 320, 1125, 539, 320, 2368, 49407]  # 'a photo of a cat'
STAGES = ("tokenizer", "convert", "parity", "eval", "ab")
PARITY_REL_L2 = 3e-2  # PERF.md section 2's limit for a forward and a decode, kernels vs plain
PARITY_T = 500
AB_SEED = 7
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The real-weights runbook (tokenizer, convert, parity, eval, ab)")
    p.add_argument("--sd_ckpt")
    p.add_argument("--bpe_merges")
    p.add_argument("--lpips_weights")
    p.add_argument("--model_config")
    p.add_argument("--prompt_ckpt", default=None, help="a trained ckpts/ directory (optional)")
    p.add_argument("--test_path")
    p.add_argument("--out", default="runbook_out")
    p.add_argument("--limit", type=int, default=25)
    p.add_argument("--test_size", type=int, default=512)
    p.add_argument("--synthetic", action="store_true", help="build stand-in artifacts and dry-run every stage")
    p.add_argument("--full_width", action="store_true", help="with --synthetic: stand-ins at full width")
    p.add_argument("--skip", default="", help="comma list of stages: " + ",".join(STAGES))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# the synthetic stand-ins

SYN_YAML = """
model:
  target: inpainting_ldm.ref_inpainting_ldm.RefInpaintLDM
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    timesteps: 1000
    conditioning_key: hybrid
    scale_factor: 0.18215
    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params: {in_channels: 9, out_channels: 4, model_channels: 32,
               attention_resolutions: [1], num_res_blocks: 1,
               channel_mult: [1, 2], num_head_channels: 8, context_dim: 24}
    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ddconfig: {double_z: true, z_channels: 4, resolution: 64, in_channels: 3,
                   out_ch: 3, ch: 32, ch_mult: [1, 2], num_res_blocks: 1,
                   attn_resolutions: [], dropout: 0.0}
    cond_stage_config:
      target: ldm.modules.encoders.Refill_modules.PromptCLIPEmbedder
      params:
        layer: penultimate
        special_tokens: ["repeat_4_<special-token>"]
        init_text: ["two views of one scene"]
        width: 24
        heads: 2
        layers: 2
    data_config: {img_size: 32, cfg: 2.5, sp_token: "<special-token>", repeat_sp_token: 4}
    save_prompt_only: true
"""

# a released SD2 checkpoint's text-tower keys that the prompt embedder does
# not read (skipped by design), written into the stand-in beside the others
SKIPPED_EXTRA = ("cond_stage_model.model.text_projection", "cond_stage_model.model.logit_scale")
# a LatentDiffusion checkpoint's schedule buffers (the schedule recomputes them)
SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")
# the EMA copy of a checkpoint saved with one (LitEma: its counters and the weights, dots dropped)
EMA_KEYS = ("model_ema.decay", "model_ema.num_updates", "model_ema.diffusion_modelout2weight")
SKIP_LIMIT = 5  # convert passes with fewer skipped keys than this besides SCHEDULE_BUFFERS and model_ema.*
SYN_SEED = 0
MERGES = "#version: 0.2\nh e\nl l\nhe ll\nhell o</w>\na photo</w>\n"


def build_synthetic(out: str, full_width: bool = False, device="cpu") -> dict:
    """Stand-ins in the real artifacts' formats, under ``<out>/synthetic``:
    an SD-layout checkpoint (``{"state_dict": ...}``) of the port's own
    bundle of the model YAML with seeded random weights
    (``model.diffusion_model.*``, ``first_stage_model.*``,
    ``cond_stage_model.*`` without the trained ``special_embeddings``, the
    schedule's buffers, an EMA copy's counters and one of its weights, and
    two text-tower keys the embedder skips), a gzip merges file of a few
    handcrafted merges, random LPIPS ``lin{i}`` weights (the layout
    ``eval.lpips.load_lpips_weights`` reads), three test pair directories
    ({source, target, mask}.png) and the model YAML.  The tiny YAML
    (``SYN_YAML``, fp32 checkpoint) or, ``full_width``,
    ``configs/ref_inpainting.yaml`` (fp16 checkpoint, ~2.6 GB).  The
    weights are drawn on ``device``.  Returns the paths and the test size."""
    from leftrefill_torch.config import build_model_from_config, dump_yaml, load_yaml, parse_yaml
    from leftrefill_torch.data.image_io import write_png
    from leftrefill_torch.eval.lpips import ALEX
    from leftrefill_torch.pipeline import fill_random_, sd2_schedule

    syn = os.path.join(out, "synthetic")
    os.makedirs(syn, exist_ok=True)
    cfg = load_yaml(os.path.join(REPO, "configs", "ref_inpainting.yaml")) if full_width else parse_yaml(SYN_YAML)
    with warnings.catch_warnings():  # the weights need no merges file
        warnings.simplefilter("ignore")
        model = build_model_from_config(cfg, dtype=torch.float32, device=device).model
    gen = torch.Generator(device).manual_seed(SYN_SEED)
    fill_random_(model, gen)
    keep = torch.float16 if full_width else torch.float32
    sd = {k: v.detach().to(keep).cpu() for k, v in model.state_dict().items() if "special_embeddings" not in k}
    del model
    width = sd["cond_stage_model.model.token_embedding.weight"].shape[1]
    sd[SKIPPED_EXTRA[0]] = torch.zeros((width, width), dtype=keep)
    sd[SKIPPED_EXTRA[1]] = torch.tensor(4.6052, dtype=keep)
    schedule = sd2_schedule()
    sd.update({k: torch.from_numpy(getattr(schedule, k)) for k in SCHEDULE_BUFFERS})
    sd[EMA_KEYS[0]] = torch.tensor(0.9999)
    sd[EMA_KEYS[1]] = torch.tensor(0, dtype=torch.int32)
    sd[EMA_KEYS[2]] = sd["model.diffusion_model.out.2.weight"].clone()
    ckpt = os.path.join(syn, "sd_stand_in.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    del sd

    merges = os.path.join(syn, "merges.txt.gz")
    with gzip.open(merges, "wt") as f:
        f.write(MERGES)

    g = torch.Generator().manual_seed(SYN_SEED)
    lpips = os.path.join(syn, "lpips_alex.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, ch, 1, 1), generator=g) * 0.01
                for i, (ch, _, _, _) in enumerate(ALEX)}, lpips)

    rng = np.random.RandomState(SYN_SEED)
    side = 256 if full_width else 48
    test_path = os.path.join(syn, "testpairs")
    for i in range(3):
        d = os.path.join(test_path, f"{i:06d}")
        os.makedirs(d, exist_ok=True)
        for name in ("source", "target"):
            write_png(os.path.join(d, name + ".png"), rng.randint(0, 255, (side, side, 3)).astype(np.uint8))
        m = np.zeros((side, side), np.uint8)
        m[side // 6: side * 5 // 6, side // 6: side * 5 // 6] = 255
        write_png(os.path.join(d, "mask.png"), m)

    config = os.path.join(syn, "model_config.yaml")
    with open(config, "w") as f:
        f.write(dump_yaml(cfg))
    return dict(sd_ckpt=ckpt, bpe_merges=merges, lpips_weights=lpips, test_path=test_path, model_config=config,
                test_size=512 if full_width else 32)


# ---------------------------------------------------------------------------
# the stages: each (args, report, state) -> passed

def stage_tokenizer(args, report, state) -> bool:
    from leftrefill_torch.models.tokenizer import SimpleTokenizer

    tok = SimpleTokenizer(bpe_path=args.bpe_merges, special_tokens=["<special-token0>"])
    ids = np.asarray(tok.tokenize("a photo of a cat"))[0]
    got = [int(v) for v in ids[:7]]
    with gzip.open(args.bpe_merges, "rt", encoding="utf-8") as f:
        n_merges = sum(1 for _ in f) - 1
    if n_merges > 40000:  # only the real merges file (~48k) carries the canonical vocab
        ok = got == CANONICAL
        report["tokenizer"] = {"ok": ok, "merges": n_merges, "ids": got, "expected": CANONICAL}
        print(f"[tokenizer] full OpenCLIP merges ({n_merges}); canonical ids {'MATCH' if ok else 'MISMATCH'} {got}")
    else:  # stand-in merges: the engine uses the start and end tokens
        ok = got[0] == tok.sot_token and tok.eot_token in ids
        report["tokenizer"] = {"ok": ok, "merges": n_merges, "ids": got, "note": "stand-in merges (engine smoke)"}
        print(f"[tokenizer] stand-in merges ({n_merges}); engine {'OK' if ok else 'BROKEN'} ids={got}")
    return ok


def convert_verdict(loaded: dict) -> dict:
    """The convert stage's counts and verdict from ``load_over_base``'s
    report: nothing missing but the prompt table (trained, never in the SD
    checkpoint), nothing of another shape or unexpected, and fewer than
    ``SKIP_LIMIT`` keys skipped besides the schedule's buffers and the EMA
    copy."""
    from leftrefill_torch.convert.checkpoint import recomputed

    missing = [m for m in loaded["missing"] if "special_embeddings" not in m]
    other = [k for k in loaded["skipped"] if not recomputed(k)]
    ok = not missing and not loaded["shape_mismatch"] and not loaded["unexpected"] and len(other) < SKIP_LIMIT
    return {"ok": ok, "skipped": len(loaded["skipped"]), "skipped_recomputed": len(loaded["skipped"]) - len(other),
            "skipped_other": len(other), "missing": len(missing), "shape_mismatch": len(loaded["shape_mismatch"]),
            "unexpected": len(loaded["unexpected"]), "skipped_keys": loaded["skipped"][:50],
            "missing_keys": missing[:10], "shape_mismatch_keys": loaded["shape_mismatch"][:10],
            "unexpected_keys": loaded["unexpected"][:10]}


def stage_convert(args, report, state) -> bool:
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.convert.checkpoint import load_torch_state_dict
    from leftrefill_torch.serving.gradio_app import INIT_SEED, compute_dtype
    from leftrefill_torch.tasks import build_task

    bundle = build_model_from_config(state["config"], dtype=compute_dtype(state["device"]), device=state["device"])
    task = build_task(bundle, state["device"])
    sd = load_torch_state_dict(args.sd_ckpt)
    loaded = task.init_params(torch.Generator(state["device"]).manual_seed(INIT_SEED), sd_state_dict=sd)
    v = report["convert"] = {"loaded_keys": len(sd), **convert_verdict(loaded)}
    print(f"[convert] {len(sd)} checkpoint keys; skipped={v['skipped']} ({v['skipped_recomputed']} schedule buffers "
          f"and EMA, {v['skipped_other']} other; limit {SKIP_LIMIT} other) missing={v['missing']} "
          f"shape_mismatch={v['shape_mismatch']} unexpected={v['unexpected']} -> {'PASS' if v['ok'] else 'FAIL'}")
    state["task"] = task
    return v["ok"]


def _first_pair(args, task) -> dict:
    """The first test pair's item, batched (``TestInpaintingDataset``, as
    the evaluation CLI reads it), with its prompt tokens."""
    from leftrefill_torch.data.datasets import TestInpaintingDataset

    dc = task.bundle.data_config
    item = TestInpaintingDataset(root_path=args.test_path, img_size=args.test_size, token_map=dc.get("token_map"),
                                 repeat_sp_token=dc.get("repeat_sp_token", 0), sp_token=dc.get("sp_token"))[0]
    out = {k: item[k][None] for k in ("image", "mask", "masked_image")}
    out["tokens"] = task.prompt_tokens([item["txt"]])
    return out


def _parity_calls(model, pair, uncond_tokens, device):
    """(UNet call, decode) on ``model``: the CFG-doubled call of the
    sampler at t = PARITY_T on a seeded latent, and the decode of the
    canvas's latent."""
    from leftrefill_torch.diffusion.core import Conditioning

    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    with torch.inference_mode():
        cond = model.build_inpaint_cond(t(pair["tokens"]).long(), t(pair["mask"]), t(pair["masked_image"]))
        uncond = Conditioning(cond.c_concat, model.get_learned_conditioning(t(uncond_tokens).long()))
        kv = model.cross_attention_kv(torch.cat([uncond.c_crossattn, cond.c_crossattn]))
        z = model.encode_first_stage(t(pair["image"]))
    x = torch.randn(tuple(z.shape), generator=torch.Generator(device).manual_seed(PARITY_T), device=device)
    steps = torch.full((2,), PARITY_T, dtype=torch.long, device=device)
    both = cond.concat_batch(uncond)

    @torch.inference_mode()
    def unet_call():
        return model.apply_model(torch.cat([x, x]), steps, both, cross_kv=kv, cfg_dup=True)

    @torch.inference_mode()
    def decode():
        return model.decode_first_stage(z)

    return unet_call, decode


def _pipeline(args, state, quantized: bool, quant_vae: bool):
    """The serving pipeline of a variant, built once a run."""
    from leftrefill_torch.serving.gradio_app import initialize_model

    key = (quantized, quant_vae)
    if key not in state["pipes"]:
        state["pipes"][key] = initialize_model(state["exp_dir"], args.sd_ckpt, img_size=args.test_size,
                                               quantized=quantized, quant_vae=quant_vae, device=state["device"])
    return state["pipes"][key]


def stage_parity(args, report, state) -> bool:
    from leftrefill_torch import kernels, tools
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.serving.gradio_app import load_experiment

    dev = state["device"]
    task = state.get("task") or load_experiment(state["exp_dir"], args.sd_ckpt, device=dev)
    pair = _first_pair(args, task)
    uncond = task.uncond_tokens(1)
    out = {}
    if dev.type == "cuda":
        unet_call, _ = _parity_calls(task.model, pair, uncond, dev)
        got = unet_call()
        with kernels.plain_kernels():
            ref = unet_call()
        out["bf16_unet"] = {"rel_l2": tools.rel_l2(got, ref), "finite": bool(torch.isfinite(got).all())}
        model = _pipeline(args, state, True, True).model
        unet_call, decode = _parity_calls(model, pair, uncond, dev)
        blocks, e2e = tools.teacher_forced(model.unet, unet_call, kernels.NAMES)
        worst = max(blocks, key=lambda k: blocks[k][1])
        out["int8_unet_blocks"] = {"rel_l2": blocks[worst][1], "block": worst, "blocks": len(blocks),
                                   "finite": bool(torch.isfinite(unet_call()).all()), "end_to_end_rel_l2": e2e}
        got = decode()
        with kernels.plain_kernels():
            ref = decode()
        out["int8_decode"] = {"rel_l2": tools.rel_l2(got, ref), "finite": bool(torch.isfinite(got).all())}
        against = "the same calls through the plain versions"
    else:  # the CPU runs the plain versions only: bf16 against fp32, the rounding floor
        fp = task.model
        if next(fp.parameters()).dtype != torch.float32:
            raise ValueError("the CPU parity stage holds bf16 against the fp32 bundle")
        bf = build_model_from_config(state["config"], dtype=torch.bfloat16, device=dev).model
        bf.load_state_dict(fp.state_dict(), strict=True)
        calls = {"fp32": _parity_calls(fp, pair, uncond, dev), "bf16": _parity_calls(bf.eval(), pair, uncond, dev)}
        for i, what in enumerate(("bf16_unet", "bf16_decode")):
            got, ref = calls["bf16"][i](), calls["fp32"][i]()
            out[what] = {"rel_l2": tools.rel_l2(got, ref), "finite": bool(torch.isfinite(got).all())}
        against = "fp32 (the rounding floor)"
    ok = all(v["finite"] and v["rel_l2"] <= PARITY_REL_L2 for v in out.values())
    report["parity"] = {"ok": ok, "limit_rel_l2": PARITY_REL_L2, "against": against, "t": PARITY_T, **out}
    print(f"[parity] against {against}: " + " ".join(f"{k}={v['rel_l2']:.3e}" for k, v in out.items())
          + f" (limit {PARITY_REL_L2}) -> {'PASS' if ok else 'FAIL'}")
    return ok


def _metrics_file(path: str) -> dict:
    with open(path) as f:
        return {k.strip(): float(v) for k, v in (line.split(":", 1) for line in f if ":" in line)}


def stage_eval(args, report, state) -> bool:
    from leftrefill_torch.cli import test as test_cli

    mdir = os.path.join(args.out, "metric_outputs")
    argv = ["--model_path", state["exp_dir"], "--test_path", args.test_path, "--sd_ckpt", args.sd_ckpt,
            "--test_size", str(args.test_size), "--metric_size", str(args.test_size),
            "--output_path", os.path.join(args.out, "eval"), "--metric_output", mdir,
            "--limit", str(args.limit), "--ddim_steps", str(state["steps"]), "--device", str(state["device"])]
    if args.lpips_weights:
        argv += ["--lpips_weights", args.lpips_weights]
    rc = test_cli.main(argv)
    files = sorted(os.path.join(mdir, f) for f in os.listdir(mdir) if f.endswith(".txt")) if os.path.isdir(mdir) else []
    metrics = _metrics_file(files[0]) if files else {}
    want = {"PSNR", "SSIM"} | ({"LPIPS"} if args.lpips_weights else set())
    ok = rc == 0 and want <= set(metrics) and all(np.isfinite(v) for v in metrics.values())
    report["eval"] = {"ok": bool(ok), "metric_files": files, "ddim_steps": state["steps"], **metrics}
    print(f"[eval] DDIM-{state['steps']} {metrics} -> {'PASS' if ok else 'FAIL'}")
    return bool(ok)


def _source_target(pair_dir: str, size: int) -> tuple[np.ndarray, np.ndarray]:
    from leftrefill_torch.data.image_io import IMREAD_COLOR, imread, resize

    def read(name):
        path = next((os.path.join(pair_dir, f) for f in sorted(os.listdir(pair_dir))
                     if os.path.splitext(f)[0] == name), None)
        if path is None:
            raise FileNotFoundError(f"no {name} image in {pair_dir}")
        return resize(imread(path, IMREAD_COLOR), (size, size)).astype(np.float32) / 127.5 - 1.0

    return read("source"), read("target")


def stage_ab(args, report, state) -> bool:
    from leftrefill_torch import tools
    from leftrefill_torch.eval.metrics import composite_metrics
    from leftrefill_torch.pipeline import stitch_canvas
    from leftrefill_torch.tools.quality import psnr_db

    dev = state["device"]
    s = args.test_size
    dirs = sorted(os.listdir(args.test_path))[: max(2, min(args.limit, 8))]
    canvases = []
    for d in dirs:
        src, tgt = _source_target(os.path.join(args.test_path, d), s)
        canvases.append(stitch_canvas(src[None], tgt[None], np.ones((1, s, s, 1), np.float32)))
    results, outs, launches = {}, {}, {}
    for name, quantized, quant_vae in (("bf16", False, False), ("int8", True, False), ("int8+vae8", True, True)):
        pipe = _pipeline(args, state, quantized, quant_vae)
        pipe.ddim_steps = state["steps"]
        preds, metrics = [], []
        tools.reset_launches()
        for image, mask in canvases:
            out = pipe(image, mask, torch.Generator(dev).manual_seed(AB_SEED))
            preds.append(out.cpu())
            m = composite_metrics(out, torch.as_tensor(image, device=dev), torch.as_tensor(mask, device=dev))
            metrics.append({k: float(m[k].float().mean()) for k in ("psnr", "ssim")})
        launches[name] = {k: v for k, v in tools.launches().items() if v}
        outs[name] = torch.cat(preds)
        results[name] = {k: float(np.mean([mm[k] for mm in metrics])) for k in ("psnr", "ssim")}
        del state["pipes"][(quantized, quant_vae)]
    for other in ("int8", "int8+vae8"):
        results[f"cross_psnr_bf16_vs_{other}_db"] = psnr_db(outs["bf16"], outs[other])
    ok = all(np.isfinite(results[f"cross_psnr_bf16_vs_{o}_db"]) for o in ("int8", "int8+vae8")) and all(
        np.isfinite(results[n][k]) for n in ("bf16", "int8", "int8+vae8") for k in ("psnr", "ssim"))
    report["ab"] = {"ok": bool(ok), "pairs": len(canvases), "ddim_steps": state["steps"], "seed": AB_SEED,
                    **results, **({"launches": launches} if dev.type == "cuda" else {})}
    print(f"[ab] {len(canvases)} pairs DDIM-{state['steps']}: bf16={results['bf16']} int8={results['int8']} "
          f"int8+vae8={results['int8+vae8']} cross_psnr int8={results['cross_psnr_bf16_vs_int8_db']:.2f} dB "
          f"int8+vae8={results['cross_psnr_bf16_vs_int8+vae8_db']:.2f} dB -> {'PASS' if ok else 'FAIL'}")
    return bool(ok)


STAGE_FNS = {"tokenizer": stage_tokenizer, "convert": stage_convert, "parity": stage_parity, "eval": stage_eval,
             "ab": stage_ab}


def main(argv=None) -> int:
    from leftrefill_torch.config import dump_yaml, load_yaml
    from leftrefill_torch.pipeline import request_device

    args = parse_args(argv)
    dev = request_device(args.device)
    skip = {s for s in args.skip.split(",") if s}
    if skip - set(STAGES):
        raise ValueError(f"unknown stages {sorted(skip - set(STAGES))}; the stages are {STAGES}")
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        t0 = time.perf_counter()
        for k, v in build_synthetic(args.out, args.full_width, dev).items():
            setattr(args, k, v)
        print(f"[synthetic] stand-ins {'at full width' if args.full_width else '(tiny)'} in "
              f"{time.perf_counter() - t0:.1f} s under {os.path.join(args.out, 'synthetic')}")
    for req in ("sd_ckpt", "bpe_merges", "model_config", "test_path"):
        if not getattr(args, req):
            print(f"missing --{req} (or use --synthetic)")
            return 2

    # the runbook's experiment directory: the YAML with the merges file (and trained checkpoints if given)
    exp_dir = os.path.join(args.out, "exp")
    os.makedirs(exp_dir, exist_ok=True)
    cfg = load_yaml(args.model_config)
    cfg["model"]["params"]["cond_stage_config"]["params"]["bpe_path"] = os.path.abspath(args.bpe_merges)
    with open(os.path.join(exp_dir, "model_config.yaml"), "w") as f:
        f.write(dump_yaml(cfg))
    if args.prompt_ckpt and os.path.isdir(args.prompt_ckpt) and not os.path.exists(os.path.join(exp_dir, "ckpts")):
        shutil.copytree(args.prompt_ckpt, os.path.join(exp_dir, "ckpts"))

    state = {"device": dev, "config": cfg, "exp_dir": exp_dir, "pipes": {},
             "steps": (10 if dev.type == "cuda" else 4) if args.synthetic else 50}
    report: dict = {}
    ok = True
    for name in STAGES:
        if name in skip:
            continue
        t0 = time.perf_counter()
        passed = STAGE_FNS[name](args, report, state)
        report[name]["seconds"] = round(time.perf_counter() - t0, 3)
        ok &= bool(passed)
    state.clear()
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"RUNBOOK {'PASS' if ok else 'FAIL'} -> {os.path.join(args.out, 'report.json')}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
