"""Measurement scripts for the port on one CUDA GPU, and the helpers they
share with ``chip_smoke.py``.

- ``python -m leftrefill_torch.tools.profile_request [--int8 [--unfused] |
  --multiview V]``: where the time of a full-width request goes (stage
  times, a profiled request with device time by kernel group and the device
  idle share, and DPM-Solver++(2M) requests), on the bf16 bundle, the W8A8
  int8 bundle (JAX's default fused configuration, or ``--unfused``) or the
  V-view multi-view bundle; ``--train [--multiview V]``: the same for one
  prompt-tuning train step.
- ``python -m leftrefill_torch.tools.library_baselines``: each hand-written
  kernel against the library path for the same product, at the main path's
  shapes (``--int8``: the int8 kernels in device ms).  The library calls
  are timed for reference only; none is on the port's path.
- ``python -m leftrefill_torch.tools.geglu_variants [--int8]``: the GEGLU
  kernels' up and down device time, and that of timing-only variants;
  ``python -m leftrefill_torch.tools.conv_int8_variants``: KI1's;
  ``python -m leftrefill_torch.tools.int8_epilogue_variants``: KI2's and
  K4's.
- ``python -m leftrefill_torch.tools.probes.<name>``: the JAX package's
  probe scripts on the port's probe kernels (``ops/probes.py``), one JSON
  row a cell (``tools/probes/__init__.py``).
"""

from __future__ import annotations

import functools
import math
import os
import random
import subprocess
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from leftrefill_torch import kernels
from leftrefill_torch.ops import conv, flash_attention, mlp, probes, quant

# kernel name -> (wrapper, plain version), both taking the arguments of site_args
KERNEL_FNS = {
    "flash_fwd": (lambda *a: flash_attention.flash_forward(*a)[0],
                  lambda *a: flash_attention.flash_forward_plain(*a)[0]),
    "flash_bwd_dq": (flash_attention.flash_bwd_dq, flash_attention.flash_bwd_dq_plain),
    "flash_bwd_dkv": (flash_attention.flash_bwd_dkv, flash_attention.flash_bwd_dkv_plain),
    "conv3x3": (conv.conv3x3_op, conv.conv3x3_plain),
    "geglu": (mlp.geglu_fused, mlp.geglu_plain),
    "conv3x3_int8": (quant.conv3x3_int8_op, quant.conv3x3_int8_plain),
    "dense_int8_res": (quant.dense_int8_res_op, quant.dense_int8_res_plain),
    "geglu_int8": (mlp.geglu_int8_fused, mlp.geglu_int8_plain),
    "affine_silu_quant": (quant.silu_quant_op, quant.silu_quant_plain),
    "ln_quant": (quant.ln_quant_op, quant.ln_quant_plain),
    "gn_quant": (quant.gn_quant_op, quant.gn_quant_plain),
    # the timing probes, off the main path (tools/probes)
    "flash_int8": (probes.flash_int8, probes.flash_int8_plain),
    "flash_variant": (lambda q, k, v, scale, exp, clamp, lse, rows:
                      probes.flash_variant(q, k, v, scale, exp=exp, clamp=clamp, lse=lse, rows=rows),
                      lambda q, k, v, scale, exp, clamp, lse, rows:
                      probes.flash_variant_plain(q, k, v, scale, exp=exp, clamp=clamp, lse=lse, rows=rows)),
    "noop": (probes.noop, probes.noop_plain),
}
LAUNCH_COUNTERS = {"flash_fwd": flash_attention.flash_forward, "flash_bwd_dq": flash_attention.flash_bwd_dq,
                   "flash_bwd_dkv": flash_attention.flash_bwd_dkv, "conv3x3": conv.conv3x3_op,
                   "geglu": mlp.geglu_fused, "conv3x3_int8": quant.conv3x3_int8_op,
                   "dense_int8_res": quant.dense_int8_res_op, "geglu_int8": mlp.geglu_int8_fused,
                   "affine_silu_quant": quant.silu_quant_op, "ln_quant": quant.ln_quant_op,
                   "gn_quant": quant.gn_quant_op, "flash_int8": probes.flash_int8,
                   "flash_variant": probes.flash_variant, "noop": probes.noop}
# the timing probes' kernels: launched by tools/probes and chip_smoke.py
# phase 2p, routed by no dispatcher (not in kernels.NAMES)
PROBES = ("flash_int8", "flash_variant", "noop")
# kernel launches per CFG-doubled UNet forward at full width (the K/V cache
# on; cfg_dup on in 1-reference requests): the JAX package's Pallas counts on
# a TPU (tests/test_torch_tools.py holds them to the port's dispatch on meta)
_NONE = dict.fromkeys(LAUNCH_COUNTERS, 0)
PER_FORWARD_BF16 = {**_NONE, "flash_fwd": 15, "conv3x3": 33, "geglu": 16}
PER_FORWARD_INT8_UNFUSED = {**_NONE, "flash_fwd": 15, "conv3x3_int8": 47, "dense_int8_res": 11, "geglu_int8": 16}
PER_FORWARD_INT8 = {**PER_FORWARD_INT8_UNFUSED, "affine_silu_quant": 44, "ln_quant": 48, "gn_quant": 16}
# the V=4 multi-view bf16 forward: 8 rows of 64x64 views, no cfg_dup; five of
# the 16 flash launches are the 16384-token joint attentions (K11's sites)
PER_FORWARD_MV4 = {**_NONE, "flash_fwd": 16, "conv3x3": 33, "geglu": 16}
# the V=2 multi-view forward at 64x128 views (the quality study, tools/quality.py
# mv; 2 or, CFG-doubled, 4 rows) launches PER_FORWARD_MV4: its joint sequences
# of 2 x 8192 / 2048 / 512 / 128 tokens are the V=4 scene's of 64x64 views, the
# middle block's 256 taking K1 too; the int8 arm adds the fused int8 forward's sites
PER_FORWARD_MV2_INT8 = {**PER_FORWARD_INT8, "flash_fwd": 16}
# one rank's share of the V=4 forward with the views split over a view group
# (chip_smoke.py phase 14v: 8 rows of 64x64 views, the CFG pair of one
# scene): each rank holds V / n_view views of its scenes, and K1 takes its
# V_local * HW queries against the gathered V * HW keys.  The middle
# block's 128 (2 view ranks) or 64 (4) queries are below K1's 256: the
# exact softmax, 15 K1 launches where the whole forward has 16.  K2 and K3
# as the whole forward's (the fewest rows, the middle block's 128 at 2 rows
# a rank, still take K3)
PER_FORWARD_MV4_VIEW_RANK = {**PER_FORWARD_MV4, "flash_fwd": 15}
# K1's (b, heads, nq, nk, d) sites of one rank's share, by (n_data, n_view):
# the 8 rows of a view-2 or view-4 rank are the CFG pair's two scenes; a
# (2 data, 2 view) rank holds one of them
VIEW_RANK_SITES = {
    (1, 2): {(2, 5, 8192, 16384, 64): 5, (2, 10, 2048, 4096, 64): 5, (2, 20, 512, 1024, 64): 5},
    (1, 4): {(2, 5, 4096, 16384, 64): 5, (2, 10, 1024, 4096, 64): 5, (2, 20, 256, 1024, 64): 5},
    (2, 2): {(1, 5, 8192, 16384, 64): 5, (1, 10, 2048, 4096, 64): 5, (1, 20, 512, 1024, 64): 5},
}
# the novel-view-synthesis bf16 forward at the 256x512 canvas (CFG batch 2 of
# 32x64 latents, cfg_dup, the K/V cache, c_input): K1 at 2048 and 512 tokens
# (128 and 32 are below its 256), K2 at the 32x64 and 16x32 levels, K3 at
# 4096, 1024 and 256 rows (the middle block's 64 are below its 128).  With
# the separator columns (use_sep) only the two output blocks that end in an
# Upsample keep multiples of 128 for K1 and K3; K2 takes the 65- and
# 33-wide levels
PER_FORWARD_NVS = {**_NONE, "flash_fwd": 10, "conv3x3": 22, "geglu": 15}
PER_FORWARD_NVS_SEP = {**_NONE, "flash_fwd": 1, "conv3x3": 22, "geglu": 2}
# four poses in one request (CFG batch 8): the middle block's 256 rows take K3 too
PER_FORWARD_NVS_B4 = {**PER_FORWARD_NVS, "geglu": 16}
# kernel launches per decode of the int8 VAE decoder (``quant_vae``) at the
# 512x1024 canvas (a 64x128 latent): KI1 where ``quant.conv3x3_int8_qualifies``
# takes the shape, 10 at 64x128 (512 -> 512: the middle blocks and up level
# 3) and 7 at 128x256 (level 3's upsample conv and level 2); K2 on the
# dequantized weight at the 256x512 (7) and 512x1024 (7) levels; the two
# nin_shortcut 1x1s are ``dense_int8`` (no kernel)
PER_DECODE_VAE8 = {**_NONE, "conv3x3_int8": 17, "conv3x3": 14}
# the UNet options no shipped config sets, at full width (chip_smoke.py phase
# 15u): (A) scale-shift norms, which move no launch: the same sites as the
# SD2 UNet's, the fused int8 ResBlocks folding the scale-shift into K4's affine
UNET_A = dict(use_scale_shift_norm=True)
PER_FORWARD_UNET_A = PER_FORWARD_BF16
PER_FORWARD_UNET_A_INT8 = PER_FORWARD_INT8
# (B) five heads a transformer (64, 128 and 256 wide at the three levels), 1x1
# conv projections, the resamplers without convs: K1 at D = 64 (8192
# tokens) and D = 128 (2048), the exact softmax at D = 256; no Upsample conv
UNET_B = dict(num_heads=5, num_head_channels=-1, use_linear_in_transformer=False, conv_resample=False)
PER_FORWARD_UNET_B = {**_NONE, "flash_fwd": 10, "conv3x3": 30, "geglu": 16}
# kernel launches per prompt-tuning train step at full width, remat on (the
# UNet's ResBlocks and SpatialTransformers run their forward again in the
# backward): 1-reference batch 8 and the V=4 scene.  The prompt reaches the
# UNet only through the cross-attentions, so nothing before the first one
# has a backward: the first transformer's self-attention and the ResBlock
# before it are neither differentiated nor run again (flash: 15 forward + 15
# again, 14 backward; conv: 33 + the 28 in ResBlocks after the first
# cross-attention, the Upsample convs are not rematerialized; GEGLU: 16 + 16).
# The multi-view UNet adds its mid-block joint attention (256 tokens)
PER_TRAIN_STEP = {**_NONE, "flash_fwd": 30, "flash_bwd_dq": 14, "flash_bwd_dkv": 14, "conv3x3": 61, "geglu": 32}
PER_TRAIN_STEP_MV4 = {**PER_TRAIN_STEP, "flash_fwd": 32, "flash_bwd_dq": 15, "flash_bwd_dkv": 15}
# the same steps as the training CLI runs them: without remat (JAX drops the
# model YAML's use_checkpoint), so each forward site launches once and the
# backward sites are those above (flash: 15 forward, 14 backward; conv 33;
# GEGLU 16; V=4: 16 forward, 15 backward)
PER_TRAIN_STEP_CLI = {**PER_TRAIN_STEP, "flash_fwd": 15, "conv3x3": 33, "geglu": 16}
PER_TRAIN_STEP_CLI_MV4 = {**PER_TRAIN_STEP_MV4, "flash_fwd": 16, "conv3x3": 33, "geglu": 16}
# kernel launches per novel-view-synthesis train step at full width, batch 16
# of 256x512 canvases (32x64 latents), no remat (JAX drops use_checkpoint),
# LoRA on the attention projections and the GEGLU input, the refinement
# branch's c_input after the first block: every self-attention needs its
# backward (flash: 10 forward, 10 backward at the 2048- and 512-token levels;
# the 128- and 32-token levels and the 77-key cross-attentions take the exact
# softmax), K2 at the 32x64 and 16x32 levels (its backward is the plain
# convolution's), K3 at every transformer (its VJP is plain math)
PER_TRAIN_STEP_NVS = {**_NONE, "flash_fwd": 10, "flash_bwd_dq": 10, "flash_bwd_dkv": 10, "conv3x3": 22,
                      "geglu": 16}
# each backward kernel's sites per train step, (b, heads, nq, nk, d) -> launches:
# batch 8 of 64x128 latents; one V=4 scene of 64x64 views (joint sequences of
# 4 x 4096 / 1024 / 256 / 64 tokens, the mid block's 256 among them)
TRAIN_SITES = {(8, 5, 8192, 8192, 64): 4, (8, 10, 2048, 2048, 64): 5, (8, 20, 512, 512, 64): 5}
TRAIN_SITES_MV4 = {(1, 5, 16384, 16384, 64): 4, (1, 10, 4096, 4096, 64): 5, (1, 20, 1024, 1024, 64): 5,
                   (1, 20, 256, 256, 64): 1}

TRAIN_SITES_NVS = {(16, 5, 2048, 2048, 64): 5, (16, 10, 512, 512, 64): 5}

# the H100 SXM's published dense peaks and memory rate (NVIDIA's data sheet)
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12


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


def teacher_forced(unet, fwd, names) -> tuple[dict, float]:
    """The forward through the kernels, then through the plain versions of
    ``names`` with every top-level block's output replaced by the kernels'
    run's, so each block is fed the kernels' input to it and its difference
    is its own (two int8 forwards that differ anywhere drift apart to the
    int8 noise level, so an int8 UNet is held block by block).  Returns
    ({block: (kind, rel L2, max abs / max|out|, ||out||)}, end-to-end rel L2
    of the two free-running forwards)."""
    blocks = {f"{part}.{i}.{j}": m for part, seq in (("input_blocks", unet.input_blocks),
                                                      ("middle_block", [unet.middle_block]),
                                                      ("output_blocks", unet.output_blocks))
              for i, layers in enumerate(seq) for j, m in enumerate(layers)}
    outs, errs = {}, {}
    hooks = [m.register_forward_hook(lambda mod, i, o, k=k: outs.__setitem__(k, o)) for k, m in blocks.items()]
    out_k = fwd()
    for h in hooks:
        h.remove()

    def force(mod, inputs, o, k):
        want = outs[k]
        errs[k] = (type(mod).__name__, rel_l2(o, want),
                   float((o.float() - want.float()).abs().max() / want.float().abs().max()), float(want.float().norm()))
        return want

    hooks = [m.register_forward_hook(functools.partial(force, k=k)) for k, m in blocks.items()]
    with kernels.plain_kernels(names):
        fwd()
    for h in hooks:
        h.remove()
    with kernels.plain_kernels(names):
        out_p = fwd()
    return errs, rel_l2(out_k, out_p)


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
    bf, dev, f32 = torch.bfloat16, "cuda", torch.float32

    def randn(*s, scale=1.0, dtype=bf):
        return (torch.randn(s, generator=generator, device=dev) * scale).to(dtype)

    if name == "flash_fwd":
        b, h, nq, nk, d = shape
        return randn(b, nq, h * d), randn(b, nk, h * d), randn(b, nk, h * d), h, d**-0.5
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        return flash_backward_args(shape, generator)
    # the probes: the scripts' [B, H, N, D] layout, normal draws
    if name == "flash_int8":
        b, h, nq, nk, d, pv_int8 = shape
        return randn(b, h, nq, d), randn(b, h, nk, d), randn(b, h, nk, d), d**-0.5, pv_int8
    if name == "flash_variant":
        b, h, nq, nk, d = shape[:5]
        return (randn(b, h, nq, d), randn(b, h, nk, d), randn(b, h, nk, d), d**-0.5, *shape[5:])
    if name == "noop":
        return (randn(*shape),)
    if name == "conv3x3":
        b, h, w, ci, co = shape
        return (randn(b, h, w, ci), randn(co, 3, 3, ci, scale=(9 * ci) ** -0.5),
                randn(co, scale=0.1, dtype=f32))
    if name == "geglu":
        r, din, inner, dout = shape
        return (randn(r, din), randn(2 * inner, din, scale=din**-0.5),
                randn(2 * inner, scale=0.1, dtype=f32),
                randn(dout, inner, scale=inner**-0.5), randn(dout, scale=0.1, dtype=f32))
    # int8 kernels: seeded bf16 activations and fp32 weights, quantized as the UNet quantizes them
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
    if name == "geglu_int8":
        r, din, inner, dout, chunk = shape
        xq, sx = quant.quantize_activation_rowwise(randn(r, din))
        w1q, s1 = quant.quantize_weight(randn(2 * inner, din, scale=din**-0.5, dtype=f32))
        w2q, s2 = quant.quantize_weight(randn(dout, inner, scale=inner**-0.5, dtype=f32))
        return (xq, sx, w1q, s1, randn(2 * inner, scale=0.1, dtype=f32), w2q, s2,
                randn(dout, scale=0.1, dtype=f32), chunk)
    # the fused prologues: a GroupNorm-like fold (a, bb) per (batch, channel)
    if name == "ln_quant":
        r, c, norm_out = shape
        return randn(r, c, scale=2.0), 1 + randn(c, scale=0.1, dtype=f32), randn(c, scale=0.1, dtype=f32), 1e-5, norm_out
    b, h, w, c = shape[:4]
    x, a, bb = randn(b, h, w, c), 1 + randn(b, c, scale=0.3, dtype=f32), randn(b, c, scale=0.5, dtype=f32)
    return (x, a, bb, shape[4]) if name == "gn_quant" else (x, a, bb)


def flash_backward_args(shape: tuple, generator: torch.Generator) -> tuple:
    """Seeded arguments of the backward kernels at ``shape`` (b, heads, nq,
    nk, d) on the card: q, k, v and dO normal, every 16th query row's q
    scaled by 25 (its scores, std 25, pass the clamp at 75, so the envelope
    mask is exercised); o and lse from K1, D = rowsum(dO * O).  A few scores
    fall within a rounding of 75 (:func:`clamp_straddles`)."""
    b, h, nq, nk, d = shape
    amp = torch.where(torch.arange(nq, device="cuda")[None, :, None] % 16 == 0, 25.0, 1.0)
    q, k, v, do = (torch.randn((b, n, h * d), generator=generator, device="cuda") for n in (nq, nk, nk, nq))
    q, k, v, do = ((q * amp).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16), do.to(torch.bfloat16))
    o, lse = flash_attention.flash_forward(q, k, v, h, d**-0.5)
    return q, k, v, do, lse, flash_attention.flash_delta(o, do, h), h, d**-0.5


# scores this close to the clamp may lie on its other side in the kernels: their
# fp32 sums of the same bf16 products run in another order than cuBLAS's (a few
# fp32 ulps of q.k, ~1e-5 at 75; the band is ~100 times wider)
STRADDLE_BAND = 1e-3


def clamp_straddles(q, k, heads: int, scale: float, band: float = STRADDLE_BAND):
    """The scores within ``band`` of the clamp at 75 as the plain backward
    computes them ((scale q).k in fp32, in its query chunks): (their
    (batch, head, query, key) indices [m, 4], the scores [m]).  The envelope
    mask steps there: a kernel whose sum lands on the other side of 75 keeps
    a dS term the plain version zeroes, or zeroes one it keeps."""
    fa = flash_attention
    nq = q.shape[1]
    chunk = fa._q_chunk(q, k, heads)
    kh = fa._heads(k, heads).transpose(-1, -2)
    idx, vals = [], []
    for q0 in range(0, nq, chunk):
        s = torch.matmul(fa._heads(q[:, q0:q0 + chunk], heads) * scale, kh)
        hit = ((s - fa.CLAMP).abs() <= band).nonzero()
        vals.append(s[tuple(hit.T)])
        hit[:, 2] += q0
        idx.append(hit)
    return torch.cat(idx), torch.cat(vals)


def straddle_terms(q, k, v, do, lse, delta, heads: int, scale: float, idx, s):
    """Each straddling score's share of the gradients, as the plain version
    computes it unmasked: dS = p (dO_i.v_j - D_i) rounded to bf16, its term
    of dq at query i (scale dS k_j) and of dk at key j (dS bf16(scale q_i)),
    and whether the plain version keeps it (s <= 75)."""
    bi, hi, qi, kj = idx.T
    d = q.shape[2] // heads
    cols = hi[:, None] * d + torch.arange(d, device=q.device)
    row = lambda t, n: t[bi[:, None], n[:, None], cols].float()  # noqa: E731
    bh = bi * heads + hi
    p = torch.exp(torch.clamp(s, max=flash_attention.CLAMP) - lse[bh, qi])
    ds = (p * ((row(do, qi) * row(v, kj)).sum(-1) - delta[bh, qi])).to(q.dtype).float()
    dq_term = scale * ds[:, None] * row(k, kj)
    dk_term = ds[:, None] * (row(q, qi) * scale).to(q.dtype).float()
    return dq_term, dk_term, s <= flash_attention.CLAMP


def kernel_side(got, ref, batch, rows, heads: int, terms, kept):
    """``ref`` (fp32) with each straddling term put on the side of the clamp
    that brings ``got``'s row (of ``rows``, head ``heads`` of each entry)
    nearer: removed if the plain version kept it, added if it zeroed it, or
    left as it is.  Returns (that tensor, the positions of the entries whose
    term moved)."""
    out, moved = ref.float().clone(), []
    d = terms.shape[1]
    entries = zip(batch.tolist(), rows.tolist(), heads.tolist(), terms, kept.tolist())
    for i, (b, n, h, t, keep) in enumerate(entries):
        c = slice(h * d, (h + 1) * d)
        cur, g = out[b, n, c], got[b, n, c].float()
        alt = cur - t if keep else cur + t
        if (g - alt).norm() < (g - cur).norm():
            out[b, n, c] = alt
            moved.append(i)
    return out, moved


def exact_scores(q, k, heads: int, scale: float, idx) -> torch.Tensor:
    """The scores at ``idx`` [m, 4] (batch, head, query, key), scale q.k
    summed in fp64: exact to fp64's rounding (each bf16 product is exact),
    so it tells which side of 75 a score lies on whatever order an fp32 sum
    takes."""
    bi, hi, qi, kj = idx.T
    d = q.shape[2] // heads
    cols = hi[:, None] * d + torch.arange(d, device=q.device)
    return (q[bi[:, None], qi[:, None], cols].double() * k[bi[:, None], kj[:, None], cols].double()).sum(-1) * scale


def site_cost(name: str, shape: tuple) -> tuple[float, float]:
    """(bytes, operations) one launch at ``shape`` must move and compute:
    each input read once, each output written once; tensor-core operations
    for the products (bf16, or int8 for the int8 kernels), none counted for
    the elementwise prologues (a few fp32 operations an element, far below
    the bytes' time)."""
    if name == "flash_fwd":
        b, h, nq, nk, d = shape
        return 2 * b * h * d * (2 * nq + 2 * nk) + 4 * b * h * nq, 4 * b * h * nq * nk * d
    if name == "flash_variant":  # shape: b, h, nq, nk, d, exp, clamp, lse, rows
        b, h, nq, nk, d, _, _, lse, _ = shape
        return 2 * b * h * d * (2 * nq + 2 * nk) + 4 * b * h * nq * lse, 4 * b * h * nq * nk * d
    if name == "flash_int8":
        # int8 q, k with fp32 row scales and v (bf16, or int8 Vq^T) in, bf16 o
        # out; Q K^T and P V once each (the function's work: the second Q K^T
        # of the kernel's two passes with pv_int8 is not counted)
        b, h, nq, nk, d, pv_int8 = shape
        bh = b * h
        nbytes = bh * d * (nq + nk) + 4 * bh * (nq + nk) + (1 if pv_int8 else 2) * bh * nk * d + 2 * bh * nq * d
        return nbytes, 2 * 2 * bh * nq * nk * d
    if name == "noop":
        return 4 * math.prod(shape), 0
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        # q, dO, k, v bf16 and lse, D fp32 in; dq (or dk and dv) bf16 out; the
        # products S and dP, then dQ (or dV and dK), each 2 B H Nq Nk D
        b, h, nq, nk, d = shape
        reads = 2 * b * h * d * (2 * nq + 2 * nk) + 8 * b * h * nq
        if name == "flash_bwd_dq":
            return reads + 2 * b * h * nq * d, 3 * 2 * b * h * nq * nk * d
        return reads + 4 * b * h * nk * d, 4 * 2 * b * h * nq * nk * d
    if name in ("conv3x3", "conv3x3_int8"):
        b, h, w, ci, co = shape
        e = 2 if name == "conv3x3" else 1
        return e * (b * h * w * ci + 9 * ci * co) + 8 * co + 2 * b * h * w * co, 2 * b * h * w * 9 * ci * co
    if name in ("geglu", "geglu_int8"):
        r, din, inner, dout = shape[:4]
        e = 2 if name == "geglu" else 1
        return (e * (r * din + 2 * inner * din + inner * dout) + 8 * (2 * inner + dout) + 2 * r * dout + 4 * r,
                2 * r * din * 2 * inner + 2 * r * inner * dout)
    if name == "dense_int8_res":
        r, k, n = shape
        return r * k + 4 * r + k * n + 8 * n + 4 * r * n, 2 * r * k * n
    if name == "ln_quant":
        r, c, norm_out = shape
        return (3 + 2 * norm_out) * r * c + 4 * r + 8 * c, 0
    b, h, w, c = shape[:4]
    n = b * h * w * c
    if name == "gn_quant":
        return (3 + 2 * shape[4]) * n + 4 * b * h * w + 8 * b * c, 0
    return 3 * n + 8 * b * c + 4, 0  # affine_silu_quant


def bound_ms(name: str, shape: tuple) -> tuple[float, str]:
    """The least time the H100 could take for one launch: the larger of its
    bytes over the memory rate and its operations over the tensor-core peak
    of their type.  Returns (ms, "bytes" | "operations")."""
    nbytes, ops = site_cost(name, shape)
    peak = PEAK_INT8 if name in ("conv3x3_int8", "dense_int8_res", "geglu_int8") else PEAK_BF16
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    if name == "flash_int8":  # Q K^T at the int8 peak, P V at its type's
        t_ops = (ops / 2 / PEAK_INT8 + ops / 2 / (PEAK_INT8 if shape[5] else PEAK_BF16)) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def library_fn(name: str, args: tuple):
    """One PyTorch call computing a kernel's function on the same inputs,
    where there is one (timed for reference only, never on the port's path):
    ``scaled_dot_product_attention`` for the flash forward and its fp32-exp
    clamped probe variants (exact softmax: the clamp at 75 is not reached by
    these inputs) and its backward through
    ``torch.autograd.grad`` on a kept graph for the backward kernels (exact
    softmax too: the same work, not the same values), cuDNN's ``conv2d`` for
    the bf16 3x3 conv; for the GEGLUs (no single call computes one; see
    ``COMPOSED``) the cuBLAS composition :func:`mlp.geglu_vjp_math` at bf16
    (two ``F.linear`` with the gated GELU in fp32 between them, the biases
    rounded to bf16 once outside the call: the same work, not the same
    values) and for the int8 one the two ``torch._int_mm`` products at its
    shapes alone, [R, din] x [din, 2I] and [R, I] x [I, dout] (a floor for
    its tensor work; the requant between them is left out); for the int8
    3x3 conv (no call computes one on CUDA) the ``torch._int_mm`` product of
    the same M x 9 Ci x Co on an int8 im2col built beforehand (its tensor
    work alone: the gather and the epilogue are left out); for the int8
    proj_out (no call computes a GEMM with its residual epilogue) the
    ``torch._int_mm`` product [R, K] x [K, N] alone (a floor for its tensor
    work: the dequant, bias and residual are left out); None for the others
    (no single call computes a fused normalize-and-quantize, nor an int8 or
    bf16-exp attention); ``x + 1`` for the no-op probe."""
    if name == "flash_fwd":
        q, k, v, h, scale = args
        b, nq, inner = q.shape
        heads = lambda a: a.view(b, a.shape[1], h, inner // h).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale).transpose(1, 2).reshape(b, nq, inner)
    if name == "flash_variant":  # the fp32-exp clamped variants (any lse, any block) only
        q, k, v, scale, exp, clamp = args[:6]
        return (lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)) if exp == "f32" and clamp else None
    if name == "noop":
        return lambda: args[0] + 1.0
    if name == "conv3x3":
        x, w, bias = args
        xc, wc, bb = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), bias.to(x.dtype)
        return lambda: F.conv2d(xc, wc, bb, padding=1).permute(0, 2, 3, 1)
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        # SDPA's backward computes dq, dk and dv in one call: both rows time it
        q, k, v, do, _, _, h, scale = args
        b, nq, inner = q.shape
        heads = lambda a: a.detach().view(b, a.shape[1], h, inner // h).transpose(1, 2)  # noqa: E731
        qh, kh, vh = (heads(a).requires_grad_(True) for a in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        g = heads(do)
        return lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)
    if name == "geglu":
        x, w1, b1, w2, b2 = args
        b1h, b2h = b1.to(x.dtype), b2.to(x.dtype)
        return lambda: mlp.geglu_vjp_math(x, w1, b1h, w2, b2h)
    if name == "geglu_int8":
        xq, w1, w2 = args[0], args[2], args[5]
        hq = torch.ones((xq.shape[0], w2.shape[1]), dtype=torch.int8, device=xq.device)
        return lambda: (torch._int_mm(xq, w1.t()), torch._int_mm(hq, w2.t()))
    if name == "conv3x3_int8":
        cols, wmat = conv3x3_int8_operands(args[0], args[2])
        return lambda: torch._int_mm(cols, wmat.t())
    if name == "dense_int8_res":
        xq, wq = args[0], args[2]
        return lambda: torch._int_mm(xq, wq.t())
    return None


def conv3x3_int8_operands(xq: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """KI1's product as a plain GEMM: the int8 im2col of xq [B, H, W, Ci]
    (zero border, taps in (dy, dx) order) as [B H W, 9 Ci], and w
    [Co, 3, 3, Ci] as [Co, 9 Ci]."""
    b, h, wd, ci = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)], dim=-1)
    return cols.reshape(b * h * wd, 9 * ci), w.reshape(w.shape[0], 9 * ci)


# kernels whose ``library_fn`` is a composition of calls (or, int8, its
# products alone), not one call computing the kernel's function: a yardstick
# the kernel is measured against, never its library time
COMPOSED = ("geglu", "geglu_int8", "conv3x3_int8", "dense_int8_res")


def unet_inputs(generator: torch.Generator, rows: int = 2, hw: tuple = (64, 128)):
    """One full-width CFG-doubled UNet call: x [rows, *hw, 9] (the two
    halves equal, as CFG gives them), t, context [rows, 77, 1024].  The
    default is the 1-reference canvas; the V-view multi-view scene is
    ``rows=2 * V, hw=(64, 64)``."""
    x = torch.randn((rows // 2, *hw, 9), generator=generator, device="cuda").repeat(2, 1, 1, 1)
    t = torch.full((rows,), 981, dtype=torch.long, device="cuda")
    ctx = torch.randn((rows, 77, 1024), generator=generator, device="cuda")
    return x, t, ctx


def unet_sites(unet, x, t, ctx, kv, cfg_dup: bool = True, **kwargs) -> Counter:
    """(kernel, shape) -> number of sites in one forward with the
    cross-attention K/V cache on (``kwargs``: the NVS UNet's c_input)."""
    with kernels.record_sites() as sites:
        unet(x, t, ctx, cross_kv=kv, cfg_dup=cfg_dup, **kwargs)
    torch.cuda.synchronize()
    return Counter(sites)


def request_canvas(seed: int = 0, side: int = 512):
    """A stitched side x 2 side canvas (reference | target) of uniform noise
    in [-1, 1] and its right-half mask, NHWC numpy."""
    from leftrefill_torch.pipeline import stitch_canvas

    rng = np.random.RandomState(seed)
    return stitch_canvas(
        rng.uniform(-1, 1, (1, side, side, 3)).astype(np.float32),
        rng.uniform(-1, 1, (1, side, side, 3)).astype(np.float32),
        np.ones((1, side, side, 1), np.float32),
    )


def multiview_scene(view_num: int, seed: int = 0):
    """One scene of ``view_num`` 512x512 views in [-1, 1] and their masks:
    view 0 holds a 256x384 hole, the other views none (NHWC numpy,
    [1, V, 512, 512, 3] and [1, V, 512, 512, 1])."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (1, view_num, 512, 512, 3)).astype(np.float32)
    masks = np.zeros((1, view_num, 512, 512, 1), np.float32)
    masks[0, 0, 128:384, 64:448] = 1.0
    return images, masks


def nvs_cameras(n: int, seed: int = 0) -> list:
    """``n`` seeded [3, 4] world-to-camera matrices whose centres lie on a
    sphere of radius 1.5 around the object (random orientations)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        theta, phi = rng.uniform(0.3, 1.4), rng.uniform(0, 2 * np.pi)
        centre = 1.5 * np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
        rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        out.append(np.concatenate([rot, (-rot @ centre)[:, None]], axis=1))
    return out


def nvs_request(tokenizer, poses: int = 1, seed: int = 0) -> dict:
    """A novel-view request at 256x512: ``poses`` rows of one seeded
    reference view beside a fully masked 256x256 target view, each row with
    the relative pose of its own target camera to the reference camera
    (``data.datasets.get_relative_pose`` of seeded cameras), the 73-token
    prompt of ``configs/novel_view_synthesis.yaml`` (numpy)."""
    from leftrefill_torch.data.datasets import build_prompt, get_relative_pose

    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    image = np.concatenate([ref, rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)], axis=2)
    image = np.repeat(image, poses, axis=0)
    mask = np.zeros((poses, 256, 512, 1), np.float32)
    mask[:, :, 256:] = 1.0
    cond, *targets = nvs_cameras(poses + 1, seed)
    return {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
            "tokens": tokenizer.tokenize([build_prompt(73, "<special-token>")] * poses),
            "rel_pose": np.stack([get_relative_pose(t, cond) for t in targets])}


def write_nvs_renders(root: str, objects: int, views: int = 12, size: int = 256, seed: int = 0,
                      val_masks: int = 0, img_size: int | None = None) -> dict:
    """Seeded synthetic Objaverse renders in the layout ``NVS_OBJDataset``
    reads: ``root/objs/obj<i>/%03d.png`` (RGBA, an elliptic opaque blob of
    smooth random colour on a transparent background, a different blob per
    view) and ``%03d.npy`` (the view's [3, 4] world-to-camera matrix, from
    :func:`nvs_cameras`); the list files ``train.txt`` (every object) and
    ``val.txt`` (the first ``val_masks`` objects, each with an evaluation
    mask ``root/masks/obj<i>/000.png`` at the dataset's ``img_size``
    (default ``size``): the lower half of the view).
    Returns the paths {"datapath", "train_list", "val_list", "mask_file_path"}."""
    from leftrefill_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size] / size
    names = []
    for i in range(objects):
        name = f"obj{i}"
        names.append(name)
        obj = f"{root}/objs/{name}"
        os.makedirs(obj, exist_ok=True)
        for v, cam in enumerate(nvs_cameras(views, seed=seed * 1000 + i)):
            cy, cx, ry, rx = rng.uniform(0.35, 0.65), rng.uniform(0.35, 0.65), rng.uniform(0.15, 0.3), rng.uniform(0.15, 0.3)
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            colour = rng.uniform(0, 255, 3) * (0.6 + 0.4 * np.stack([yy, xx, 1 - yy], -1))
            img = np.zeros((size, size, 4), np.uint8)
            img[..., :3] = np.where(blob[..., None], colour, 0).astype(np.uint8)
            img[..., 3] = np.where(blob, 255, 0)
            write_png(f"{obj}/{v:03d}.png", img, level=1)
            np.save(f"{obj}/{v:03d}.npy", cam)
    for i in range(val_masks):
        os.makedirs(f"{root}/masks/obj{i}", exist_ok=True)
        m = np.zeros((img_size or size, img_size or size), np.uint8)
        m[(img_size or size) // 2:] = 255
        write_png(f"{root}/masks/obj{i}/000.png", m)
    with open(f"{root}/train.txt", "w") as f:
        f.write("\n".join(names))
    with open(f"{root}/val.txt", "w") as f:
        f.write("\n".join(names[:val_masks]))
    return {"datapath": f"{root}/objs", "train_list": f"{root}/train.txt", "val_list": f"{root}/val.txt",
            "mask_file_path": f"{root}/masks"}


JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                             "tests", "fixtures", "jpeg")
MEGADEPTH_IMAGES = ("photo_1600x1200_420.jpg", "baseline_420.jpg", "progressive_420.jpg", "baseline_444.jpg",
                    "exif_orientation_6.jpg", "grey.jpg")


def _match_result(rng: np.random.RandomState, kind: str) -> dict:
    """A matcher output at the matcher's 832-pixel size: "good" (300
    matches in a random box, about a fifth of them above 0.8 of the best
    score), "weak" (30 matches, 5 above it: too few for a mask) or "empty"."""
    n = {"good": 300, "weak": 30, "empty": 0}[kind]
    lo = rng.uniform(0, 500, (2, 2))
    size = rng.uniform(150, 330, (2, 2))
    pts = [(lo[i] + rng.uniform(0, 1, (n, 2)) * size[i]).astype(np.float32) for i in range(2)]
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if kind == "weak":
        scores = np.where(np.arange(n) < 5, 0.95, 0.1).astype(np.float32)
    return {"scores": scores, "mkpts0": pts[0], "mkpts1": pts[1]}


def write_megadepth_scenes(root: str, scenes: int = 2, images_per_scene: int = 14, seed: int = 0,
                           train_pairs_per_scene: int = 155, other_pairs_per_scene: int = 12,
                           images: tuple = MEGADEPTH_IMAGES, mask_size: int = 256) -> dict:
    """A seeded synthetic MegaDepth tree in the real layout, through the
    port's preprocessors: ``root/<scene>/images/<name>.jpg`` (copies of the
    JPEG fixtures ``images``, in turn: the 1600x1200 4:2:0 photo first, so
    its decode is on the path), each scene's LoFTR-style scene info
    ``root/scene_info/{train,test}/<scene>.npz`` (``image_paths`` and
    ``pair_infos`` [((i0, i1), overlap, matches)]: per scene
    ``train_pairs_per_scene`` distinct pairs with an overlap in [0.4, 0.7]
    and ``other_pairs_per_scene`` outside it, every overlap at least 0.2),
    the pickles of ``build_megadepth_pairs`` (``root/pairs``) and of
    ``extend_pairs_for_multiview`` (three extra views a pair), the mask lists
    ``root/masks/{irregular,segment}.txt`` of 6 seeded grey PNGs each
    (``mask_size``, strokes and blocks), the matcher outputs
    ``root/matching_results/%08d.pkl`` of the training pairs (of every
    four: two good, one weak, one without a file; every eighth empty
    instead of weak) and 4 test-mode pair directories (a validation batch)
    ``root/val_pairs/%04d`` (target, source, source_1 .. source_3, mask.png).
    Returns the paths the training YAML names: {"image_path",
    "train_pair", "mv_train_pair", "val_image_path", "val_mask_path",
    "train_mask_path": [irregular, segment], "match_path"}."""
    import pickle
    import shutil

    from leftrefill_torch.data.image_io import write_png
    from leftrefill_torch.data.masks import draw_polyline_mask
    from leftrefill_torch.data.preprocess import build_megadepth_pairs, extend_pairs_for_multiview

    if images_per_scene * (images_per_scene - 1) < train_pairs_per_scene + other_pairs_per_scene:
        raise ValueError(f"{images_per_scene} images give fewer than {train_pairs_per_scene + other_pairs_per_scene} "
                         "distinct pairs")
    rng = np.random.RandomState(seed)
    k = 0
    for split in ("train", "test"):
        os.makedirs(f"{root}/scene_info/{split}", exist_ok=True)
    for sc in range(scenes):
        scene = f"{sc:04d}"
        os.makedirs(f"{root}/{scene}/images", exist_ok=True)
        paths = []
        for i in range(images_per_scene):
            src = images[k % len(images)]
            k += 1
            paths.append(f"{scene}/images/{i:03d}_{os.path.splitext(src)[0]}.jpg")
            shutil.copy(os.path.join(JPEG_FIXTURES, src), f"{root}/{paths[-1]}")
        ordered = [(a, b) for a in range(images_per_scene) for b in range(images_per_scene) if a != b]
        chosen = rng.permutation(len(ordered))[: train_pairs_per_scene + other_pairs_per_scene]
        inside = rng.uniform(0.4, 0.7, train_pairs_per_scene)
        outside = np.where(rng.uniform(size=other_pairs_per_scene) < 0.5, rng.uniform(0.2, 0.39, other_pairs_per_scene),
                           rng.uniform(0.71, 0.95, other_pairs_per_scene))
        overlaps = rng.permutation(np.concatenate([inside, outside]))
        infos = np.empty(len(chosen), dtype=object)
        for j, (c, ov) in enumerate(zip(chosen, overlaps)):
            infos[j] = (ordered[c], float(ov), np.zeros((0, 2)))
        np.savez(f"{root}/scene_info/train/{scene}.npz", image_paths=np.array(paths, dtype=object), pair_infos=infos)
        test = np.empty(2, dtype=object)
        test[0], test[1] = ((0, 1), 0.5, np.zeros((0, 2))), ((1, 2), 0.3, np.zeros((0, 2)))
        np.savez(f"{root}/scene_info/test/{scene}.npz", image_paths=np.array(paths, dtype=object), pair_infos=test)
    out = f"{root}/pairs"
    build_megadepth_pairs(root, f"{root}/scene_info/train", f"{root}/scene_info/test", out,
                          rng=random.Random(seed))
    with open(f"{out}/image_dict.pkl", "rb") as f:
        image_dict = pickle.load(f)
    with open(f"{out}/train_pairs.pkl", "rb") as f:
        train = pickle.load(f)
    extend_pairs_for_multiview(f"{root}/scene_info/train", train, image_dict, f"{out}/4-extended_train_pairs.pkl")

    lists = {}
    for kind in ("irregular", "segment"):
        os.makedirs(f"{root}/masks/{kind}", exist_ok=True)
        names = []
        for i in range(6):
            m = np.zeros((mask_size, mask_size), np.uint8)
            if kind == "irregular":
                pts = rng.randint(0, mask_size, (int(rng.randint(4, 12)), 2))
                m[draw_polyline_mask(pts, mask_size, int(rng.randint(mask_size // 16, mask_size // 6))) > 0] = 255
            else:
                y, x = rng.randint(0, mask_size * 3 // 4, 2)
                h, w = rng.randint(mask_size // 8, mask_size // 2, 2)
                m[y:y + h, x:x + w] = 255
            names.append(f"{root}/masks/{kind}/{i:03d}.png")
            write_png(names[-1], m)
        lists[kind] = f"{root}/masks/{kind}.txt"
        with open(lists[kind], "w") as f:
            f.write("\n".join(names) + "\n")

    os.makedirs(f"{root}/matching_results", exist_ok=True)
    for idx in range(len(train)):
        if idx % 4 == 3:
            continue
        kind = "good" if idx % 4 < 2 else ("empty" if idx % 8 == 6 else "weak")
        with open(f"{root}/matching_results/{idx:08d}.pkl", "wb") as f:
            pickle.dump(_match_result(rng, kind), f)

    for i in range(4):
        d = f"{root}/val_pairs/{i:04d}"
        os.makedirs(d, exist_ok=True)
        for j, name in enumerate(("target", "source", "source_1", "source_2", "source_3")):
            shutil.copy(os.path.join(JPEG_FIXTURES, images[(i + j) % len(images)]), f"{d}/{name}.jpg")
        m = np.zeros((mask_size, mask_size), np.uint8)
        m[mask_size // 4: 3 * mask_size // 4, mask_size // 4 + i: 3 * mask_size // 4] = 255
        write_png(f"{d}/mask.png", m)
    os.makedirs(f"{root}/val_masks", exist_ok=True)
    write_png(f"{root}/val_masks/000.png", np.full((mask_size, mask_size), 255, np.uint8))
    return {"image_path": f"{out}/image_dict.pkl", "train_pair": f"{out}/train_pairs.pkl",
            "mv_train_pair": f"{out}/4-extended_train_pairs.pkl", "val_image_path": f"{root}/val_pairs",
            "val_mask_path": f"{root}/val_masks", "train_mask_path": [lists["irregular"], lists["segment"]],
            "match_path": f"{root}/matching_results"}


def prompt_tokenizer():
    """The 1-reference prompt set-up: (tokenizer, the 50 prompt tokens, their
    init text)."""
    from leftrefill_torch.models.clip import build_prompt_tokenizer

    return build_prompt_tokenizer(["repeat_50_<special-token>"], ["init"])


def serving_pipeline(model, sampler: str = "ddim", steps: int = 50):
    """The 1-reference pipeline on the card with 50 prompt tokens, CFG 2.5
    (and eta 1 for DDIM)."""
    from leftrefill_torch.pipeline import RefInpaintPipeline

    tok, sp, _ = prompt_tokenizer()
    return RefInpaintPipeline(model=model, tokenizer=tok, special_tokens=sp, device="cuda",
                              ddim_steps=steps, guidance_scale=2.5, eta=1.0, sampler=sampler)


def training_batch(rows: int = 8, seed: int = 0) -> dict:
    """A 1-reference training batch: ``rows`` seeded 512x1024 canvases
    [reference | target] in [-1, 1], the target (right) half masked, and the
    50 prompt tokens (numpy)."""
    tok, sp, _ = prompt_tokenizer()
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (rows, 512, 1024, 3)).astype(np.float32)
    mask = np.zeros((rows, 512, 1024, 1), np.float32)
    mask[:, :, 512:] = 1.0
    return {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
            "tokens": tok.tokenize([" ".join(sp)] * rows)}


def multiview_training_batch(view_num: int, seed: int = 0) -> dict:
    """One multi-view scene (``multiview_scene``) with its view prompts,
    flattened to V consecutive rows."""
    from leftrefill_torch.data import flatten_views
    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer

    tok, _, prompts = build_multiview_prompt_tokenizer(view_num)
    images, masks = multiview_scene(view_num, seed)
    return flatten_views({"image": images, "mask": masks, "masked_image": images * (masks < 0.5),
                          "tokens": tok.tokenize(prompts)[None]})


def multiview_pipeline(model, view_num: int, steps: int = 50):
    """The multi-view pipeline on the card: DDIM at eta 1, CFG 2.5, the
    view prompts of ``configs/multiview_ref_inpainting.yaml``."""
    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer
    from leftrefill_torch.pipeline import MultiViewInpaintPipeline

    tok, _, prompts = build_multiview_prompt_tokenizer(view_num)
    return MultiViewInpaintPipeline(model=model, tokenizer=tok, view_prompts=prompts, device="cuda",
                                    ddim_steps=steps, guidance_scale=2.5, eta=1.0)


def with_unet(model, unet):
    """The same bundle (VAE, text tower, schedule: shared, not copied) around
    another UNet."""
    from leftrefill_torch.diffusion.core import LeftRefillModel

    return LeftRefillModel(unet, model.first_stage_model, model.cond_stage_model, model.schedule,
                           model.scale_factor).eval()


def unfused_twin(model):
    """The int8 bundle with JAX's unfused int8 UNet (``fused=False``) on the
    same int8 weights."""
    from leftrefill_torch.models.unet import UNetModel

    with torch.device("meta"):
        unet = UNetModel(dtype=model.unet.dtype, quant=True, fused=False)
    unet = unet.to_empty(device=next(model.unet.parameters()).device)
    unet.load_state_dict(model.unet.state_dict(), strict=True)
    return with_unet(model, unet)


def reset_launches() -> None:
    for c in LAUNCH_COUNTERS.values():
        c.launches = 0


def launches() -> dict:
    return {name: c.launches for name, c in LAUNCH_COUNTERS.items()}
