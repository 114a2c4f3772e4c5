"""Where the time of one full-width request, or one train step, goes, on one
CUDA GPU.

    python -m leftrefill_torch.tools.profile_request [--int8 [--unfused] | --multiview V] [--json PATH]
    python -m leftrefill_torch.tools.profile_request --train [--multiview V] [--json PATH]

The bundle is the full-width SD2-inpainting one (``build_sd2_inpaint_bundle``,
random weights from seed 0), bf16, CFG 2.5, batch 1; ``--int8`` takes its
W8A8 int8 twin (the same weights quantized) in JAX's default configuration,
the fused prologues K4, K7 and K8 (``--unfused``: JAX's unfused int8
configuration); ``--multiview V`` the V-view multi-view bundle, a scene of V
512x512 views.  It prints, and writes to PATH as one JSON object:

1. stage times: VAE encode, the text tower for [uncond; cond], the
   cross-attention K/V, one CFG-doubled UNet forward and VAE decode (host
   clock around synchronised calls, median of 5 after a warm-up);
2. one request (bf16: DDIM-50; int8: DPM-Solver++(2M) 15 steps, its serving
   configuration; multi-view: DDIM-50) timed without the profiler, with its
   kernel launches per UNet forward, then the same request under
   ``torch.profiler`` (after a profiled warm-up request, which absorbs the
   tracer's start-up): the sum of device time (kernels, copies, memsets;
   one stream, so they do not overlap) and their count, the device idle share 1 -
   device/wall against both wall times, device time by group (K1-K3,
   KI1-KI3, K4/K7/K8, cuDNN convs, cuBLAS GEMMs, everything else) and the
   largest kernels by name;
3. for the 1-reference bundles, DPM-Solver++(2M) requests at 15 and 50
   steps: seconds per request (two each, after a warm-up), kernel launches
   per UNet call, and the left half of each canvas checked against the
   input.

``--train`` profiles prompt-tuning training instead (``leftrefill_torch.train``,
the released AdamW, remat on): a 1-reference batch of 8 512x1024 canvases, or
with ``--multiview V`` one scene of V 512x512 views a step.  After two
warm-up steps: one step timed without the profiler with its kernel launches,
then one under ``torch.profiler`` as for a request, the device time grouped
into the forward kernels (K1-K3, forward and remat recompute), the backward
kernels (dq: K12 + K14, dk/dv: K13), the library backward (cuDNN's conv
gradients, cuBLAS GEMMs) and the plain ops, with the idle share.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from leftrefill_torch import tools
from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

# device-time groups, tried in order on each kernel's name
GROUPS = (
    ("K1 flash_fwd", r"flash_fwd_kernel"),
    ("K12+K14 flash_bwd_dq", r"flash_bwd_dq_kernel"),
    ("K13 flash_bwd_dkv", r"flash_bwd_dkv_kernel"),
    ("K2 conv3x3", r"conv3x3_kernel"),
    ("K3 geglu", r"geglu_(up|down)_kernel"),
    ("KI1 conv3x3_int8", r"conv3x3_int8_"),
    ("KI2 dense_int8_res", r"dense_int8_res_"),
    ("KI3 geglu_int8", r"geglu_int8_"),
    ("K4 affine_silu_quant", r"affine_silu_quant_kernel"),
    ("K7 ln_quant", r"ln_quant_kernel"),
    ("K8 gn_quant", r"gn_quant_kernel"),
    ("P1 flash_int8 (probe)", r"flash_int8_kernel"),  # the timing probes: on no request's path
    ("P5 noop (probe)", r"noop_kernel"),
    ("cuDNN conv", r"fprop|dgrad|wgrad|conv|cudnn"),
    ("cuBLAS GEMM", r"gemm|nvjet|cublas|cutlass|splitK"),
)


# a train step's device-time groups by kind
TRAIN_KINDS = {"K1 flash_fwd": "forward kernels", "K2 conv3x3": "forward kernels", "K3 geglu": "forward kernels",
               "K12+K14 flash_bwd_dq": "backward kernels", "K13 flash_bwd_dkv": "backward kernels",
               "cuDNN conv": "cuDNN / cuBLAS", "cuBLAS GEMM": "cuDNN / cuBLAS"}


def host_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stage_times(model, pipe, image, mask, multiview: bool) -> dict:
    img = torch.as_tensor(image, device="cuda")
    msk = torch.as_tensor(mask, device="cuda")
    if multiview:
        img, msk = img.flatten(0, 1), msk.flatten(0, 1)
    rows = img.shape[0]
    masked = img * (msk < 0.5)
    tokens = torch.as_tensor(np.concatenate([pipe.uncond_tokens(1), pipe.prompt_tokens(1)]),
                             dtype=torch.long, device="cuda")
    z = model.encode_first_stage(masked)
    ctx = model.get_learned_conditioning(tokens)
    kv = model.cross_attention_kv(ctx)
    c_concat = torch.zeros((2 * rows, *z.shape[1:3], 5), device="cuda")
    cond = Conditioning(c_concat, ctx)
    x = torch.randn((2 * rows, *z.shape[1:]), device="cuda")
    t = torch.full((2 * rows,), 981, dtype=torch.long, device="cuda")
    return {
        "vae_encode_ms": host_ms(lambda: model.encode_first_stage(masked)),
        "text_tower_ms": host_ms(lambda: model.get_learned_conditioning(tokens)),
        "cross_attention_kv_ms": host_ms(lambda: model.cross_attention_kv(ctx)),
        "unet_forward_ms": host_ms(lambda: model.apply_model(x, t, cond, cross_kv=kv, cfg_dup=not multiview)),
        "vae_decode_ms": host_ms(lambda: model.decode_first_stage(z)),
    }


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def timed_request(pipe, image, mask) -> float:
    t0 = time.perf_counter()
    pipe(image, mask, torch.Generator("cuda").manual_seed(5))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(run, calls: int, launches_key: str) -> dict:
    """``run()`` (returns its wall seconds) once without the profiler, with
    the kernel launches per one of its ``calls``, then once under
    ``torch.profiler`` after a profiled warm-up run."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tools.reset_launches()
    unprofiled_s = run()
    per_call = {n: c / calls for n, c in tools.launches().items()}
    with profile(activities=activities):  # warm-up: the tracer's start-up
        run()
    with profile(activities=activities) as prof:
        wall_s = run()
    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.key][0] += _device_us(evt)
            per_kernel[evt.key][1] += evt.count
    device_s = sum(us for us, _ in per_kernel.values()) / 1e6
    if device_s == 0:
        raise SystemExit("profile_request: the profiler recorded no device time")
    groups = defaultdict(float)
    for name, (us, _) in per_kernel.items():
        group = next((g for g, pat in GROUPS if re.search(pat, name)), "other")
        groups[group] += us / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "unprofiled_wall_s": unprofiled_s,
        launches_key: per_call,
        "profiled_wall_s": wall_s,
        "device_s": device_s,
        "device_kernel_launches": sum(c for _, c in per_kernel.values()),
        "idle_share_profiled": 1.0 - device_s / wall_s,
        "idle_share_unprofiled": 1.0 - device_s / unprofiled_s,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": us / 1e3, "count": c} for n, (us, c) in top],
    }


def dpm_requests(model, image, mask, per_forward: dict) -> dict:
    img = torch.as_tensor(image, device="cuda")
    out = {}
    for steps in (15, 50):
        pipe = tools.serving_pipeline(model, sampler="dpm++2m", steps=steps)
        pipe(image, mask, torch.Generator("cuda").manual_seed(99))  # warm-up
        torch.cuda.synchronize()
        tools.reset_launches()
        secs = []
        for seed in (1, 2):
            t0 = time.perf_counter()
            canvas = pipe(image, mask, torch.Generator("cuda").manual_seed(seed))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if not (torch.isfinite(canvas).all() and torch.equal(canvas[:, :, :512], img[:, :, :512])):
                raise SystemExit(f"dpm++2m {steps} steps: non-finite output or left half changed")
        calls = 2 * steps  # one CFG-doubled UNet call per step, two requests
        per_call = {n: c / calls for n, c in tools.launches().items()}
        if per_call != per_forward:
            raise SystemExit(f"dpm++2m {steps} steps: launches per UNet call {per_call}")
        out[f"steps_{steps}"] = {"seconds_per_request": secs, "launches_per_unet_call": per_call}
    return out


def profile_training(view_num) -> dict:
    """One full-width train step (module docstring), profiled."""
    from leftrefill_torch.models.clip import init_prompt_table
    from leftrefill_torch.train import OptimizerConfig, create_train_state, make_train_step, view_options

    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0),
                                     view_num=view_num, remat=True)
    if view_num:
        batch = tools.multiview_training_batch(view_num)
    else:
        tok, sp, init = tools.prompt_tokenizer()
        init_prompt_table(model.cond_stage_model, tok, sp, init)
        batch = tools.training_batch(8)
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx, *view_options(model))
    gen = torch.Generator("cuda").manual_seed(7)

    def run() -> float:
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        if not np.isfinite(float(metrics["loss"])):
            raise SystemExit("profile_request --train: non-finite loss")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(2):  # warm-up steps
        run()
    torch.cuda.reset_peak_memory_stats()
    out = profiled(run, 1, "kernel_launches_per_step")
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    kinds = defaultdict(float)
    for group, ms in out["device_ms_by_group"].items():
        kinds[TRAIN_KINDS.get(group, "plain ops")] += ms
    out["device_ms_by_kind"] = dict(kinds)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true", help="profile the W8A8 int8 bundle (fused prologues)")
    ap.add_argument("--unfused", action="store_true", help="with --int8: JAX's unfused int8 configuration")
    ap.add_argument("--multiview", type=int, metavar="V", help="profile the V-view multi-view bundle (bf16)")
    ap.add_argument("--train", action="store_true", help="profile one prompt-tuning train step (bf16)")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    if args.unfused and not args.int8 or args.multiview and args.int8 or args.train and args.int8:
        ap.error("--unfused goes with --int8, --multiview and --train with neither")
    if not torch.cuda.is_available():
        raise SystemExit("profile_request: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        result = {"card": tools.card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
                  "bundle": f"train_multiview_v{args.multiview}" if args.multiview else "train_1ref_b8"}
        print(result["card"])
        result["train_step_profiled"] = profile_training(args.multiview)
        print("train_step_profiled", json.dumps(result["train_step_profiled"]))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    bundle = (f"multiview_v{args.multiview}" if args.multiview else
              ("int8_unfused" if args.unfused else "int8_fused") if args.int8 else "bf16")
    result = {"card": tools.card_line(), "torch": torch.__version__, "cuda": torch.version.cuda, "bundle": bundle}
    print(result["card"])
    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0),
                                     quant=args.int8, fused=not args.unfused, view_num=args.multiview)
    sampler, steps = ("dpm++2m", 15) if args.int8 else ("ddim", 50)
    if args.multiview:
        image, mask = tools.multiview_scene(args.multiview)
        pipe = tools.multiview_pipeline(model, args.multiview, steps=steps)
    else:
        image, mask = tools.request_canvas()
        pipe = tools.serving_pipeline(model, sampler=sampler, steps=steps)
    with torch.inference_mode():
        result["stages"] = stage_times(model, pipe, image, mask, multiview=bool(args.multiview))
    print("stages", json.dumps(result["stages"]))
    pipe(image, mask, torch.Generator("cuda").manual_seed(99))  # warm-up request
    torch.cuda.synchronize()
    key = f"{sampler}{steps}_profiled"
    result[key] = profiled(lambda: timed_request(pipe, image, mask), steps, "kernel_launches_per_unet_call")
    print(key, json.dumps(result[key]))
    if not args.multiview:
        per_forward = (tools.PER_FORWARD_INT8_UNFUSED if args.unfused else tools.PER_FORWARD_INT8) if args.int8 \
            else tools.PER_FORWARD_BF16
        result["dpm"] = dpm_requests(model, image, mask, per_forward)
        print("dpm++2m", json.dumps(result["dpm"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
