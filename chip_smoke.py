#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``leftrefill_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (phase 2 one line per kernel shape):
1. set-up: the card's name and power limit, versions, the kernel build;
2. each hand-written kernel (K1 flash forward, K2 3x3 conv, K3 fused GEGLU)
   at every shape one full-width UNet forward gives it, against its plain
   PyTorch version (relative L2 <= 1e-2), timed with CUDA events; then the
   flash kernel's head-dim-128 instantiation, off the main path;
3. one full-width UNet forward (CFG batch 2, 64x128 latent, bf16, cfg_dup
   and the cross-attention K/V cache on) through the kernels against the
   same forward through the plain versions (relative L2 <= 3e-2);
4. serving: two 512x1024 requests (DDIM-50, eta 1, CFG 2.5, batch 1, each
   with its own seed) on the full-width SD2-inpainting bundle with random
   weights; the outputs are checked and the kernel launch counts must be
   33 conv, 15 flash and 16 GEGLU per UNet forward.
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLASH_REL_L2 = CONV_REL_L2 = GEGLU_REL_L2 = 1e-2  # bf16 kernel vs its plain version
UNET_REL_L2 = 3e-2  # 16 transformer blocks and 22 res blocks of bf16 rounding
PER_FORWARD = {"conv3x3": 33, "flash_fwd": 15, "geglu": 16}
KERNELS = {
    "flash_fwd": ("leftrefill_torch/csrc/flash_fwd.cu", "leftrefill_tpu/ops/flash_attention.py:211"),
    "conv3x3": ("leftrefill_torch/csrc/conv3x3.cu", "leftrefill_tpu/ops/conv.py:181"),
    "geglu": ("leftrefill_torch/csrc/geglu.cu", "leftrefill_tpu/ops/mlp.py:86"),
}


def main() -> int:
    if not (ROOT / "leftrefill_torch" / "csrc").is_dir():
        print("chip_smoke.py: the leftrefill_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3

    # ---- phase 1: set-up ---------------------------------------------------
    from leftrefill_torch import kernels, tools
    from leftrefill_torch.tools import cuda_ms, rel_l2

    print(tools.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 1 setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built from leftrefill_torch/csrc "
          f"in {time.perf_counter() - t0:.1f} s -> {kernels.library_path().relative_to(ROOT)}; "
          f"tf32 off")

    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0))
    unet = model.unet
    gen = torch.Generator("cuda").manual_seed(1)
    x, tsteps, ctx = tools.unet_inputs(gen)

    # ---- phase 2: each kernel at the UNet forward's own shapes -------------
    with torch.inference_mode():
        kv = unet.cross_kv(ctx)
        report = {}
        for (name, shape), n_sites in sorted(tools.unet_sites(unet, x, tsteps, ctx, kv).items()):
            site = tools.site_args(name, shape, gen)
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            got, ref = run(), plain()
            torch.cuda.synchronize()
            err, mae = rel_l2(got, ref), float((got.float() - ref.float()).abs().max())
            bound = {"flash_fwd": FLASH_REL_L2, "conv3x3": CONV_REL_L2, "geglu": GEGLU_REL_L2}[name]
            if not (err <= bound and torch.isfinite(got).all()):
                raise SystemExit(f"{name} {shape}: rel L2 {err:.3e} > {bound} or non-finite")
            ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
            print(f"phase 2 {name} shape={shape} sites={n_sites} rel_l2={err:.3e} "
                  f"max_abs_err={mae:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            r = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "sites": 0})
            r["max_abs_err"] = max(r["max_abs_err"], mae)
            r["ms"] += n_sites * ms
            r["plain_ms"] += n_sites * plain_ms
            r["sites"] += n_sites
        # the flash kernel's other instantiation, off the main path: head dim 128
        shape = (2, 5, 1024, 1024, 128)
        site = tools.site_args("flash_fwd", shape, gen)
        run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS["flash_fwd"])
        got, ref = run(), plain()
        err = rel_l2(got, ref)
        if not err <= FLASH_REL_L2:
            raise SystemExit(f"flash_fwd {shape}: rel L2 {err:.3e} > {FLASH_REL_L2}")
        print(f"phase 2 flash_fwd shape={shape} (off the main path) rel_l2={err:.3e} "
              f"kernel_ms={cuda_ms(run, 5):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
        for name, n in PER_FORWARD.items():
            if report.get(name, {}).get("sites") != n:
                raise SystemExit(f"{name}: {report.get(name, {}).get('sites')} sites per forward, expected {n}")

        # ---- phase 3: the full-width UNet forward, kernels vs plain --------
        fwd = lambda: unet(x, tsteps, ctx, cross_kv=kv, cfg_dup=True)
        out_k = fwd()
        with kernels.plain_kernels():
            out_p = fwd()
            plain_fwd_ms = cuda_ms(fwd, 1)
        kern_fwd_ms = cuda_ms(fwd, 3)
        err = rel_l2(out_k, out_p)
        if not (out_k.shape == (2, 64, 128, 4) and torch.isfinite(out_k).all() and err <= UNET_REL_L2):
            raise SystemExit(f"UNet forward: rel L2 {err:.3e} > {UNET_REL_L2} or bad output")
        print(f"phase 3 unet forward [2,64,128,9] bf16 cfg_dup cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_fwd_ms:.2f} plain_versions_ms={plain_fwd_ms:.2f}")
        del out_k, out_p

    # ---- phase 4: serving two 512x1024 requests ----------------------------
    pipe = tools.serving_pipeline(model, sampler="ddim", steps=50)
    image, mask = tools.request_canvas()
    pipe(image, mask, torch.Generator("cuda").manual_seed(99))  # warm-up request
    torch.cuda.synchronize()
    tools.reset_launches()
    outs, secs = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        outs.append(pipe(image, mask, torch.Generator("cuda").manual_seed(seed)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = tools.launches()
    forwards = 2 * pipe.ddim_steps  # one CFG-doubled UNet forward per step
    img = torch.as_tensor(image, device="cuda")
    for o in outs:
        if o.shape != (1, 512, 1024, 3) or not torch.isfinite(o).all():
            raise SystemExit("request output has the wrong shape or is not finite")
        if not torch.equal(o[:, :, :512], img[:, :, :512]):
            raise SystemExit("left half of the canvas is not the input")
    if torch.equal(outs[0], outs[1]):
        raise SystemExit("two seeds gave the same canvas")
    for name, n in PER_FORWARD.items():
        if launches[name] != n * forwards:
            raise SystemExit(f"{name}: {launches[name]} launches, expected {n} x {forwards}")
    print(f"phase 4 serving 512x1024 ddim50 eta1 cfg2.5 b1: seconds_per_request="
          f"{[round(s, 3) for s in secs]} launches={launches} unet_forwards={forwards}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]}
        for name in PER_FORWARD
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
