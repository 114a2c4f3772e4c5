"""Measurement scripts for the port on one CUDA GPU, and the helpers they
share with ``chip_smoke.py``.

- ``python -m leftrefill_torch.tools.profile_request [--int8]``: where the
  time of a full-width 512x1024 request goes (stage times, a profiled
  request with device time by kernel group and the device idle share, and
  DPM-Solver++(2M) requests), on the bf16 or the W8A8 int8 bundle.
- ``python -m leftrefill_torch.tools.library_baselines``: each hand-written
  kernel against the library path for the same product, at the main path's
  shapes.  The library calls are timed for reference only; none is on the
  port's path.
"""

from __future__ import annotations

import subprocess
from collections import Counter

import numpy as np
import torch

from leftrefill_torch import kernels
from leftrefill_torch.ops import conv, flash_attention, mlp, quant

# kernel name -> (wrapper, plain version), both taking the arguments of site_args
KERNEL_FNS = {
    "flash_fwd": (lambda *a: flash_attention.flash_forward(*a)[0],
                  lambda *a: flash_attention.flash_forward_plain(*a)[0]),
    "conv3x3": (conv.conv3x3_op, conv.conv3x3_plain),
    "geglu": (mlp.geglu_fused, mlp.geglu_plain),
    "conv3x3_int8": (quant.conv3x3_int8_op, quant.conv3x3_int8_plain),
    "dense_int8_res": (quant.dense_int8_res_op, quant.dense_int8_res_plain),
    "geglu_int8": (mlp.geglu_int8_fused, mlp.geglu_int8_plain),
}
# kernel launches per CFG-batch-2 UNet forward at full width (cfg_dup and the
# cross-attention K/V cache on): the JAX package's Pallas counts on a TPU
PER_FORWARD_BF16 = {"flash_fwd": 15, "conv3x3": 33, "geglu": 16,
                    "conv3x3_int8": 0, "dense_int8_res": 0, "geglu_int8": 0}
PER_FORWARD_INT8 = {"flash_fwd": 15, "conv3x3": 0, "geglu": 0,
                    "conv3x3_int8": 47, "dense_int8_res": 11, "geglu_int8": 16}
LAUNCH_COUNTERS = {"flash_fwd": flash_attention.flash_forward, "conv3x3": conv.conv3x3_op,
                   "geglu": mlp.geglu_fused, "conv3x3_int8": quant.conv3x3_int8_op,
                   "dense_int8_res": quant.dense_int8_res_op, "geglu_int8": mlp.geglu_int8_fused}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in bf16 steps (adjacent
    representable values are one step apart, across zero included)."""
    ia, ib = (t.contiguous().view(torch.int16).to(torch.int32) for t in (a, b))
    ia = torch.where(ia < 0, -32768 - ia, ia)  # sign-magnitude bits -> ordered integers
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return int((ia - ib).abs().max())


def site_args(name: str, shape: tuple, generator: torch.Generator) -> tuple:
    """Seeded arguments on the card for one kernel site, ``shape`` as
    ``kernels.record_sites`` reports it."""
    bf, dev = torch.bfloat16, "cuda"

    def randn(*s, scale=1.0, dtype=bf):
        return (torch.randn(s, generator=generator, device=dev) * scale).to(dtype)

    if name == "flash_fwd":
        b, h, nq, nk, d = shape
        return randn(b, nq, h * d), randn(b, nk, h * d), randn(b, nk, h * d), h, d**-0.5
    if name == "conv3x3":
        b, h, w, ci, co = shape
        return (randn(b, h, w, ci), randn(co, 3, 3, ci, scale=(9 * ci) ** -0.5),
                randn(co, scale=0.1, dtype=torch.float32))
    if name == "geglu":
        r, din, inner, dout = shape
        return (randn(r, din), randn(2 * inner, din, scale=din**-0.5),
                randn(2 * inner, scale=0.1, dtype=torch.float32),
                randn(dout, inner, scale=inner**-0.5), randn(dout, scale=0.1, dtype=torch.float32))
    # int8 kernels: seeded bf16 activations and fp32 weights, quantized as the UNet quantizes them
    f32 = torch.float32
    if name == "conv3x3_int8":
        b, h, w, ci, co = shape
        xq, sx = quant.quantize_activation(randn(b, h, w, ci))
        wq, sw = quant.quantize_weight(randn(co, 3, 3, ci, scale=(9 * ci) ** -0.5, dtype=f32))
        return xq, sx * sw, wq, randn(co, scale=0.1, dtype=f32)
    if name == "dense_int8_res":
        r, k, n = shape
        xq, sx = quant.quantize_activation_rowwise(randn(r, k))
        wq, sw = quant.quantize_weight(randn(n, k, scale=k**-0.5, dtype=f32))
        return xq, sx, wq, sw, randn(n, scale=0.1, dtype=f32), randn(r, n)
    r, din, inner, dout, chunk = shape
    xq, sx = quant.quantize_activation_rowwise(randn(r, din))
    w1q, s1 = quant.quantize_weight(randn(2 * inner, din, scale=din**-0.5, dtype=f32))
    w2q, s2 = quant.quantize_weight(randn(dout, inner, scale=inner**-0.5, dtype=f32))
    return (xq, sx, w1q, s1, randn(2 * inner, scale=0.1, dtype=f32), w2q, s2,
            randn(dout, scale=0.1, dtype=f32), chunk)


def unet_inputs(generator: torch.Generator):
    """One full-width CFG-batch-2 UNet call: x [2, 64, 128, 9] (the two
    halves equal, as CFG gives them), t, context [2, 77, 1024]."""
    x = torch.randn((1, 64, 128, 9), generator=generator, device="cuda").repeat(2, 1, 1, 1)
    t = torch.full((2,), 981, dtype=torch.long, device="cuda")
    ctx = torch.randn((2, 77, 1024), generator=generator, device="cuda")
    return x, t, ctx


def unet_sites(unet, x, t, ctx, kv) -> Counter:
    """(kernel, shape) -> number of sites in one forward with cfg_dup and
    the cross-attention K/V cache on."""
    with kernels.record_sites() as sites:
        unet(x, t, ctx, cross_kv=kv, cfg_dup=True)
    torch.cuda.synchronize()
    return Counter(sites)


def request_canvas(seed: int = 0):
    """A stitched 512x1024 canvas (reference | target) and its right-half
    mask, NHWC numpy."""
    from leftrefill_torch.pipeline import stitch_canvas

    rng = np.random.RandomState(seed)
    return stitch_canvas(
        rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32),
        rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32),
        np.ones((1, 512, 512, 1), np.float32),
    )


def serving_pipeline(model, sampler: str = "ddim", steps: int = 50):
    """The 1-reference pipeline on the card with 50 prompt tokens, CFG 2.5
    (and eta 1 for DDIM)."""
    from leftrefill_torch.models.clip import build_prompt_tokenizer
    from leftrefill_torch.pipeline import RefInpaintPipeline

    tok, sp, _ = build_prompt_tokenizer(["repeat_50_<special-token>"], ["init"])
    return RefInpaintPipeline(model=model, tokenizer=tok, special_tokens=sp, device="cuda",
                              ddim_steps=steps, guidance_scale=2.5, eta=1.0, sampler=sampler)


def reset_launches() -> None:
    for c in LAUNCH_COUNTERS.values():
        c.launches = 0


def launches() -> dict:
    return {name: c.launches for name, c in LAUNCH_COUNTERS.items()}
