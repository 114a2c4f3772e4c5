#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``leftrefill_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the kernel phases one line per kernel shape):
1. set-up: the card's name and power limit, versions, the kernel build (its
   time, and ptxas's registers, spills and barriers with the dynamic shared
   memory of each instantiation of the flash forward, the bf16 and int8
   convs, the two flash backward kernels and the GEGLUs' up and down
   kernels, bf16 and int8, and the registers of K7's and K8's);
2. each bf16 kernel (K1 flash forward, K2 3x3 conv, K3 fused GEGLU) at every
   shape one full-width bf16 UNet forward gives it, against its plain
   PyTorch version (relative L2 <= 1e-2), timed with CUDA events beside its
   bound and the library call where one exists, with the share of the bound
   it reaches and its factor to the library call (as at every kernel site
   below; K3, KI3 and KI1, which no single call computes, beside their
   yardsticks: the cuBLAS composition of the same function, the two int8
   products alone, and KI1's int8 product on a pre-built im2col,
   ``tools.COMPOSED``), and K3's and KI3's launch plan
   (``mlp.geglu_plan``) equal to the launchers'; two launches of K3 at its
   largest site bit-equal; then off the main path, against the plain
   versions: the flash
   kernel's head-dim-128 instantiation, the flash kernel at 1088 tokens (a
   key and a query tail past a multiple of 128), and K2 at 72 input
   channels (a channel tail past a multiple of 64);
3. one full-width bf16 UNet forward (CFG batch 2, 64x128 latent, cfg_dup
   and the cross-attention K/V cache on) through the kernels against the
   same forward through the plain versions (relative L2 <= 3e-2);
4. bf16 serving: two 512x1024 requests (DDIM-50, eta 1, CFG 2.5, batch 1,
   each with its own seed) on the full-width SD2-inpainting bundle with
   random weights; the outputs are checked and the kernel launch counts must
   be 33 conv, 15 flash and 16 GEGLU per UNet forward;
2i. JAX's unfused int8 configuration (``fused=False``, the same fp weights
   quantized): each int8 kernel (KI1 3x3 conv, KI2 proj_out GEMM + residual,
   KI3 GEGLU) at every shape one full-width int8 forward gives it, against
   its plain version, each within 1 bf16 ulp per element, timed, and two
   launches of KI3 at its largest site bit-equal, KI1's launch plan at each
   site (``quant.conv3x3_int8_plan``: tile, K split over a thread cluster,
   patch, shared memory) equal to the launcher's; then off the main path:
   KI1's fp32 output arm equal to its plain version, and KI3 at a 1280-wide
   requant chunk (a cluster of 10 blocks, past the portable 8) and din = 320
   within 1 ulp;
3i. that full-width int8 forward through the kernels against the same
   forward with KI1-KI3 through their plain versions (relative L2 <= 3e-2;
   K1 stays on its kernel in both), and, for information, against the
   forward with every kernel plain and against the bf16 forward of phase 3;
5. unfused int8 serving: two 512x1024 requests (DPM-Solver++(2M) 15 steps,
   CFG 2.5, batch 1) after a warm-up request, checked as in phase 4, with 47
   KI1, 11 KI2, 16 KI3 and 15 K1 launches per UNet forward;
2f. JAX's default int8 configuration (the fused prologues, the same int8
   weights): K4 (GN affine + SiLU + quantize), K7 (LayerNorm + per-row
   quantize) and K8 (GN affine + per-pixel quantize) at every shape one
   full-width fused int8 forward gives them, against their plain versions
   (int8 values at most one step apart on at most 1e-3 of the elements,
   scales within 8 fp32 ulps, a bf16 output within one bf16 ulp of its
   largest value), timed;
   then K7 and K8 with their bf16 output, off the main path;
3f. that fused forward with K4, K7 and K8 against the same forward with the
   three routed to their plain versions (KI1-KI3 and K1 on their kernels in
   both), block by block with each block fed the kernels' input to it:
   every block within 2e-2 of its max|out|, the transformers together
   within 3e-3 rel L2 (end to end within 3e-2 where every block is equal);
   for information the end-to-end difference and the fused against the
   unfused forward;
5f. fused int8 serving: two 512x1024 DPM-Solver++(2M)-15 requests after a
   warm-up, checked as in phase 5, with 44 K4, 47 KI1, 48 K7, 16 K8, 11
   KI2, 16 KI3 and 15 K1 launches per UNet forward;
2m. the flash kernel at the multi-view joint self-attention shapes (64x64
   views, CFG 2 scene rows): V=4, 16384 tokens (the JAX package's
   streaming-K/V kernel K11 takes it) and V=2, 8192 tokens, against the
   query-chunked plain version (relative L2 <= 1e-2), timed;
3m. one full-width V=4 multi-view bf16 UNet forward (8 rows of 64x64
   views, the K/V cache on, no cfg_dup): its 16 flash (five at 16384
   tokens), 33 conv and 16 GEGLU sites, each kernel at each of their shapes
   against its plain version as in phase 2, then the forward through the
   kernels against the plain versions (relative L2 <= 3e-2);
6. multi-view serving: V=4 scenes of 512x512 views (DDIM-50, eta 1, CFG
   2.5), a short warm-up scene, then two scenes with their own seeds: finite
   output, the unmasked views and view 0 outside its hole returned as they
   were, different outputs for different seeds, and the launch counts of
   phase 3m per forward; seconds per scene.
2t. the flash-attention backward kernels (dq: K12 + K14; dk/dv: K13) at
   every shape a full-width train step gives them (1-reference batch 8:
   8192/2048/512 tokens; the V=4 scene: 16384 (K14's path in JAX), 4096,
   1024 and 256 tokens), on seeded normal inputs (every 16th query row's
   logits past the clamp at 75), with o and lse from K1: dq, dk and dv each
   within relative L2 1e-2 of the plain version, outside the rows that a
   score within 1e-3 of the clamp reaches (there the envelope mask steps,
   and the two versions' sums may round to its two sides), and over every
   row once each such score's term is put on the kernel's side; timed
   beside the bound and the backward of ``scaled_dot_product_attention``;
   then both off the main path, held the same way: at head dim 128, at
   1088 tokens (a 64-row tail past a multiple of 128) and at 576 queries
   against 1216 keys (Nq != Nk, both with tails); and two launches of each
   at the 8192-token site must give bit-equal outputs (no atomics); then
   K3 at every GEGLU site of both train steps (the forward and the remat
   recompute launch each), held and timed as in phase 2, and two launches
   at the 65536-row site bit-equal;
7. 1-reference prompt-tuning training at full width (remat on, the released
   AdamW: lr 3e-5, weight decay 0.01): batch 8 of seeded 512x1024 canvases,
   a warm-up step, then three timed steps with the launches per step of
   every kernel checked; the loss finite, the prompt table moved, every
   other parameter bit-unchanged; then at batch 2 one step's prompt-table
   gradient through the kernels against the same step with every kernel
   routed to its plain version (relative L2 <= 5e-2);
8. V=4 multi-view prompt-tuning training: one scene of four 512x512 views a
   step, the view-0 loss, a warm-up step and two timed steps with their
   launches checked; the loss finite and the table moved.
The line before the last is a JSON summary of the eleven kernels; the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before them.
"""

from __future__ import annotations

import functools
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REL_L2 = {"flash_fwd": 1e-2, "flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2, "conv3x3": 1e-2,
          "geglu": 1e-2}  # kernel vs plain
# exact int32 sums and the plain version's fp32 operations in its order (KI3:
# the same erff, so the requant of h agrees too); 1 ulp leaves room for a
# contracted multiply-add, which the kernels avoid
ULPS = {"conv3x3_int8": 1, "dense_int8_res": 1, "geglu_int8": 1}
# the fused prologues: K4 and K8 repeat their plain versions' fp32 operations,
# K7 sums each row in another order than PyTorch's reductions, which moves
# its mean and scale by a few ulps and a normalized value near zero by many
# of its own (tiny) ulps: int8 values at most one step apart on at most 1e-3
# of them, scales within 8 fp32 ulps, the bf16 output within one bf16 ulp of
# its largest value
STEP_SHARE, SCALE_ULPS, NORM_MAX_REL = 1e-3, 8, 2.0**-8
BF16_NAMES, INT8_NAMES = ("flash_fwd", "conv3x3", "geglu"), ("conv3x3_int8", "dense_int8_res", "geglu_int8")
PROLOGUES = ("affine_silu_quant", "ln_quant", "gn_quant")
UNET_REL_L2 = 3e-2  # 16 transformer blocks and 22 res blocks of rounding
# the prompt table's gradient through the kernels against the plain versions:
# the forward's rounding differences (rel L2 ~1.6e-2 at the UNet output) and
# the backward's, through every layer after the first cross-attention
PROMPT_GRAD_REL_L2 = 5e-2
BWD_NAMES = ("flash_bwd_dq", "flash_bwd_dkv")
BLOCK_MAX_REL, TRANSFORMERS_L2 = 2e-2, 3e-3  # teacher-forced blocks (tests/test_torch_quant_unet_fused.py)
VIEWS = 4
KERNELS = {
    "flash_fwd": ("leftrefill_torch/csrc/flash_fwd.cu",
                  "leftrefill_tpu/ops/flash_attention.py:211 (K1) and leftrefill_tpu/ops/flash_attention.py:252 (K11)"),
    "flash_bwd_dq": ("leftrefill_torch/csrc/flash_bwd.cu",
                     "leftrefill_tpu/ops/flash_attention.py:418 (K12) and leftrefill_tpu/ops/flash_attention.py:456 (K14)"),
    "flash_bwd_dkv": ("leftrefill_torch/csrc/flash_bwd.cu", "leftrefill_tpu/ops/flash_attention.py:506 (K13)"),
    "conv3x3": ("leftrefill_torch/csrc/conv3x3.cu", "leftrefill_tpu/ops/conv.py:181"),
    "geglu": ("leftrefill_torch/csrc/geglu.cu", "leftrefill_tpu/ops/mlp.py:86"),  # and csrc/geglu.cuh
    "conv3x3_int8": ("leftrefill_torch/csrc/conv3x3_int8.cu",
                     "leftrefill_tpu/ops/quant.py:390 and leftrefill_tpu/ops/quant.py:277"),
    "dense_int8_res": ("leftrefill_torch/csrc/dense_int8_res.cu", "leftrefill_tpu/ops/quant.py:106"),
    "geglu_int8": ("leftrefill_torch/csrc/geglu_int8.cu", "leftrefill_tpu/ops/mlp.py:204"),
    "affine_silu_quant": ("leftrefill_torch/csrc/quant_prologue.cu", "leftrefill_tpu/ops/quant.py:603"),
    "ln_quant": ("leftrefill_torch/csrc/quant_prologue.cu", "leftrefill_tpu/ops/quant.py:682"),
    "gn_quant": ("leftrefill_torch/csrc/quant_prologue.cu", "leftrefill_tpu/ops/quant.py:758"),
}


# off the main path, held to the plain versions in phase 2
OFF_PATH = (("flash_fwd", (2, 5, 1024, 1024, 128)), ("flash_fwd", (2, 5, 1088, 1088, 64)),
            ("conv3x3", (2, 32, 64, 72, 64)))
# the backward kernels off the main path, held to the plain versions in phase
# 2t: head dim 128, a 64-row tail past a multiple of 128, Nq != Nk with tails
OFF_PATH_BWD = ((2, 5, 1024, 1024, 128), (2, 5, 1088, 1088, 64), (2, 5, 576, 1216, 64))


def ptxas_report(log: str, kernel: str) -> list[str]:
    """ptxas's report (``-Xptxas -v`` in the build log) for each template
    instantiation of ``kernel``: registers, barriers, stack and spills."""
    lines, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = entry.group(1) if kernel in entry.group(1) else None
            if current:
                args = ",".join(re.findall(r"Li(\d+)E", current))
                lines.append(f"{kernel}<{args}>:")
        elif current and ("stack frame" in line or "Used" in line):
            lines[-1] += " " + line.split(":", 1)[-1].strip() + ";"
    return lines


def check_plan(name: str, shape: tuple) -> str:
    """K3's or KI3's launch plan as ``mlp.geglu_plan`` mirrors it, held to
    the launchers' own (down tile and shared memory); returns its reading."""
    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.ops import mlp

    lib = kernels.library()
    int8 = name == "geglu_int8"
    tile, smem = (lib.lr_geglu_int8_tile, lib.lr_geglu_int8_smem) if int8 else (lib.lr_geglu_tile, lib.lr_geglu_smem)
    plan = mlp.geglu_plan(*shape[:4], torch.cuda.get_device_properties(0).multi_processor_count,
                          chunk=shape[4] if int8 else None)
    up, down = plan["up"], plan["down"]
    bn = tile(shape[0], shape[3])
    if (bn, smem(0, 0), smem(1, bn)) != (down["tile"][1], up["smem"], down["smem"]):
        raise SystemExit(f"{name} {shape}: the plan mirror {plan} differs from the launcher's "
                         f"(tile {bn}, shared memory {smem(0, 0)} / {smem(1, bn)})")
    return (f"up_grid={up['grid'] or 'persistent'} up_items={up['items']} up_cluster={up['cluster']} "
            f"down_tile={down['tile']} down_grid={down['grid']} smem={up['smem']}/{down['smem']}")


def check_conv_int8_plan(shape: tuple) -> str:
    """KI1's launch plan as ``quant.conv3x3_int8_plan`` mirrors it, held to
    the launcher's own (``lr_conv3x3_int8_plan``); returns its reading."""
    import ctypes

    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.ops import quant

    got = (ctypes.c_int * 5)()
    kernels.check(kernels.library().lr_conv3x3_int8_plan(*shape, ctypes.addressof(got)), "conv3x3_int8 plan")
    plan = quant.conv3x3_int8_plan(*shape, torch.cuda.get_device_properties(0).multi_processor_count)
    if tuple(got) != (plan["tile"][1], plan["splits"], *plan["patch"], plan["smem"]):
        raise SystemExit(f"conv3x3_int8 {shape}: the plan mirror {plan} differs from the launcher's {tuple(got)}")
    return (f"tile={plan['tile']} patch={plan['patch']} grid={plan['grid']} cluster={plan['cluster']} "
            f"smem={plan['smem']}")


def check_bit_equal(name: str, shape: tuple, gen, label: str) -> None:
    """Two launches of one kernel on the same inputs give the same bits."""
    import torch

    from leftrefill_torch import tools

    site = tools.site_args(name, shape, gen)
    first, second = (tools.KERNEL_FNS[name][0](*site) for _ in range(2))
    if not torch.equal(first, second):
        raise SystemExit(f"phase {label} {name} {shape}: two launches differ")
    print(f"phase {label} {name} shape={shape}: two launches bit-equal")


def compare(name: str, got, ref) -> tuple[str, float]:
    """Hold one kernel output to its plain version's; returns (the bound's
    reading, max abs difference) or exits."""
    import torch

    from leftrefill_torch.tools import bf16_ulps, rel_l2

    if name in PROLOGUES:
        (gn, gq, gs), (rn, rq, rs) = (o if isinstance(o, tuple) else (None, o, None) for o in (got, ref))
        steps = (gq.to(torch.int32) - rq.to(torch.int32)).abs()
        share = float((steps > 0).float().mean())
        if int(steps.max()) > 1 or share > STEP_SHARE:
            raise SystemExit(f"{name}: int8 values {int(steps.max())} steps apart on {share:.2e} of them")
        reading = f"steps<=1 on {share:.2e}"
        if gs is not None:
            ulp = torch.nextafter(rs.abs(), torch.full_like(rs, float("inf"))) - rs.abs()
            ulps = float(((gs - rs).abs() / ulp).max())
            if ulps > SCALE_ULPS:
                raise SystemExit(f"{name}: scales {ulps:.0f} ulps apart")
            reading += f" scale_ulps={ulps:.0f}"
        if gn is not None:
            d = float((gn.float() - rn.float()).abs().max() / rn.float().abs().max())
            if d > NORM_MAX_REL:
                raise SystemExit(f"{name}: bf16 output {d:.3e} of its max apart ({bf16_ulps(gn, rn)} ulps)")
            reading += f" norm_max_rel={d:.3e} norm_ulps={bf16_ulps(gn, rn)}"
        return reading, float(steps.max())
    if isinstance(got, tuple):  # dk and dv: each held to the bound
        readings = [compare(name, g, r) for g, r in zip(got, ref)]
        return " ".join(r for r, _ in readings), max(m for _, m in readings)
    if not torch.isfinite(got).all():
        raise SystemExit(f"{name}: non-finite output")
    err, mae = rel_l2(got, ref), float((got.float() - ref.float()).abs().max())
    if name in ULPS:
        ulps = bf16_ulps(got, ref)
        if ulps > ULPS[name]:
            raise SystemExit(f"{name}: {ulps} bf16 ulps from the plain version > {ULPS[name]}")
        return f"ulps={ulps} rel_l2={err:.3e}", mae
    if err > REL_L2[name]:
        raise SystemExit(f"{name}: rel L2 {err:.3e} > {REL_L2[name]}")
    return f"rel_l2={err:.3e}", mae


def compare_backward(name: str, site: tuple, got, ref) -> tuple[str, float]:
    """Hold a backward kernel's dq, or dk and dv, to the plain version's
    outside the rows that a score within a rounding of the clamp at 75
    reaches (``tools.clamp_straddles``: dq's query rows and dk's key rows of
    those scores; dv does not see the mask), each within ``REL_L2``.  Also
    reads every row: as they are, and with each straddling score's dS term
    put on the side of the clamp the kernel's row shows
    (``tools.kernel_side``); the latter must hold too, which locates every
    difference past the bound at those scores.  Returns (the readings, max
    abs difference of the held rows) or exits."""
    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.tools import rel_l2

    q, _, _, _, _, _, heads, scale = site
    idx, s = tools.clamp_straddles(q, site[1], heads, scale)
    dq_term, dk_term, kept = tools.straddle_terms(*site, idx, s)
    d = q.shape[2] // heads
    if name == "flash_bwd_dq":
        parts = [("dq", got, ref, idx[:, 2], dq_term)]
    else:
        parts = [("dk", got[0], ref[0], idx[:, 3], dk_term), ("dv", got[1], ref[1], None, None)]
    readings, mae = [f"straddling_scores={len(idx)}"], 0.0
    for label, g, r, rows, terms in parts:
        if not torch.isfinite(g).all():
            raise SystemExit(f"{name} {label}: non-finite output")
        gm, rm = g.float().clone(), r.float().clone()
        if rows is not None:
            for b, n, h in zip(idx[:, 0].tolist(), rows.tolist(), idx[:, 1].tolist()):
                gm[b, n, h * d:(h + 1) * d] = rm[b, n, h * d:(h + 1) * d] = 0.0
        err, every = rel_l2(gm, rm), rel_l2(g, r)
        reading = f"{label}_rel_l2={err:.3e}"
        if rows is not None:
            side, moved = tools.kernel_side(g, r, idx[:, 0], rows, idx[:, 1], terms, kept)
            at_side = rel_l2(g, side)
            reading += (f" (rows out: {len(set(zip(idx[:, 0].tolist(), rows.tolist(), idx[:, 1].tolist())))}) "
                        f"{label}_rel_l2_every_row={every:.3e} terms_on_the_other_side={len(moved)} "
                        f"{label}_rel_l2_kernel_side={at_side:.3e}")
            if moved:  # each moved score: the plain version's fp32 sum and the fp64 one, in fp32 ulps of 75
                exact = tools.exact_scores(q, site[1], heads, scale, idx[moved])
                reading += " moved=" + ",".join(
                    f"{tuple(idx[i].tolist())}:plain_s={float(s[i]):.7f}({(float(s[i]) - 75) / 2**-17:+.1f}ulp)"
                    f"/fp64_s={float(e):.9f}({(float(e) - 75) / 2**-17:+.2f}ulp)"
                    for i, e in zip(moved, exact))
            err = max(err, at_side)
        if err > REL_L2[name]:
            raise SystemExit(f"{name}: {reading} > {REL_L2[name]}")
        readings.append(reading)
        mae = max(mae, float((gm - rm).abs().max()))
    return " ".join(readings), mae


def check_site(name: str, shape: tuple, gen, n_sites: int, report: dict, label: str) -> None:
    """One kernel site: kernel against plain version, both timed with the
    library call where one exists, the bound beside them."""
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.tools import cuda_ms

    site = tools.site_args(name, shape, gen)
    run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
    got, ref = run(), plain()
    torch.cuda.synchronize()
    reading, mae = compare_backward(name, site, got, ref) if name in BWD_NAMES else compare(name, got, ref)
    ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
    library = tools.library_fn(name, site)
    # a composition of calls (tools.COMPOSED) is a yardstick, not a library time
    composed = name in tools.COMPOSED
    library_ms = None if library is None else cuda_ms(library, 20)
    composition_ms, library_ms = (library_ms, None) if composed else (None, library_ms)
    bound, bound_by = tools.bound_ms(name, shape)
    if name == "conv3x3":  # the launch plan's output channels per block
        reading += f" channels_per_block={kernels.library().lr_conv3x3_tile(*shape[:3], shape[4])}"
    if name == "conv3x3_int8":
        reading += " " + check_conv_int8_plan(shape)
    elif composed:
        reading += " " + check_plan(name, shape)
    print(f"phase {label} {name} shape={shape} sites={n_sites} {reading} max_abs_err={mae:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
          f"bound_share={bound / ms:.3f} library_ms={'none' if library_ms is None else f'{library_ms:.4f}'}"
          f"{'' if library_ms is None else f' kernel_over_library={ms / library_ms:.2f}'}"
          f"{'' if composition_ms is None else f' composition_ms={composition_ms:.4f} kernel_over_composition={ms / composition_ms:.2f}'}")
    r = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                 "library_ms": None if library_ms is None else 0.0, "sites": 0,
                                 "bound_ops_ms": 0.0, **({"composition_ms": 0.0} if composed else {})})
    r["max_abs_err"] = max(r["max_abs_err"], mae)
    r["ms"] += n_sites * ms
    r["plain_ms"] += n_sites * plain_ms
    r["bound_ms"] += n_sites * bound
    r["bound_ops_ms"] += n_sites * bound * (bound_by == "operations")
    if library_ms is not None:
        r["library_ms"] += n_sites * library_ms
    if composition_ms is not None:
        r["composition_ms"] += n_sites * composition_ms
    r["sites"] += n_sites


def check_kernels(sites: dict, gen, report: dict, label: str, names) -> None:
    """Every site of the kernels ``names`` in one forward's ``sites``
    ({(kernel, shape): launches}, from ``tools.unet_sites``)."""
    for (name, shape), n_sites in sorted(sites.items()):
        if name in names:
            check_site(name, shape, gen, n_sites, report, label)


def check_sites(report: dict, per_forward: dict, label: str) -> None:
    for name, n in per_forward.items():
        got = report.get(name, {}).get("sites", 0)
        if got != n:
            raise SystemExit(f"{label} {name}: {got} sites per forward, expected {n}")


def check_forward(unet, x, tsteps, ctx, kv, label: str, names, cfg_dup: bool = True):
    """One full-width forward through the kernels against the same forward
    with the kernels ``names`` routed to their plain versions."""
    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.tools import cuda_ms, rel_l2

    fwd = lambda: unet(x, tsteps, ctx, cross_kv=kv, cfg_dup=cfg_dup)
    out_k = fwd()
    with kernels.plain_kernels(names):
        out_p = fwd()
        plain_fwd_ms = cuda_ms(fwd, 1)
    kern_fwd_ms = cuda_ms(fwd, 3)
    err = rel_l2(out_k, out_p)
    if not (out_k.shape == (*x.shape[:3], 4) and torch.isfinite(out_k).all() and err <= UNET_REL_L2):
        raise SystemExit(f"{label} UNet forward: rel L2 {err:.3e} > {UNET_REL_L2} or bad output")
    return out_k, out_p, err, kern_fwd_ms, plain_fwd_ms


def teacher_forced(unet, fwd, names) -> tuple[dict, float]:
    """The forward through the kernels, then through the plain versions of
    ``names`` with every top-level block's output replaced by the kernels'
    run's, so each block is fed the kernels' input to it and its difference
    is its own.  Returns ({block: (kind, rel L2, max abs / max|out|,
    ||out||)}, end-to-end rel L2 of the two free-running forwards)."""
    from leftrefill_torch import kernels
    from leftrefill_torch.tools import rel_l2

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


def serve(model, sampler: str, steps: int, per_forward: dict, label: str) -> dict:
    """Two timed requests after a warm-up; the canvases and the launch counts
    per UNet forward are checked.  Returns the launch counts."""
    import torch

    from leftrefill_torch import tools

    pipe = tools.serving_pipeline(model, sampler=sampler, steps=steps)
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
    forwards = 2 * steps  # one CFG-doubled UNet forward per step (DDIM and DPM++(2M) alike)
    img = torch.as_tensor(image, device="cuda")
    for o in outs:
        if o.shape != (1, 512, 1024, 3) or not torch.isfinite(o).all():
            raise SystemExit(f"{label}: request output has the wrong shape or is not finite")
        if not torch.equal(o[:, :, :512], img[:, :, :512]):
            raise SystemExit(f"{label}: left half of the canvas is not the input")
    if torch.equal(outs[0], outs[1]):
        raise SystemExit(f"{label}: two seeds gave the same canvas")
    check_launches(launches, per_forward, forwards, label)
    print(f"{label}: seconds_per_request={[round(s, 3) for s in secs]} launches={launches} "
          f"unet_forwards={forwards}")
    return launches


def check_launches(launches: dict, per_forward: dict, forwards: int, label: str) -> None:
    for name, n in per_forward.items():
        if launches[name] != n * forwards:
            raise SystemExit(f"{label}: {name} {launches[name]} launches, expected {n} x {forwards}")


def serve_multiview(model, per_forward: dict, label: str) -> dict:
    """A short warm-up scene, then two V-view scenes of DDIM-50 with their
    own seeds; outputs and launch counts per forward checked."""
    import torch

    from leftrefill_torch import tools

    images, masks = tools.multiview_scene(VIEWS)
    tools.multiview_pipeline(model, VIEWS, steps=2)(images, masks, torch.Generator("cuda").manual_seed(99))
    torch.cuda.synchronize()
    pipe = tools.multiview_pipeline(model, VIEWS, steps=50)
    tools.reset_launches()
    outs, secs = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        outs.append(pipe(images, masks, torch.Generator("cuda").manual_seed(seed)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = tools.launches()
    img, keep = torch.as_tensor(images, device="cuda"), torch.as_tensor(masks, device="cuda") == 0
    for o in outs:
        if o.shape != images.shape or not torch.isfinite(o).all():
            raise SystemExit(f"{label}: scene output has the wrong shape or is not finite")
        if not torch.equal(o[keep.expand_as(o)], img[keep.expand_as(img)]):
            raise SystemExit(f"{label}: a view changed where its mask is 0")
    if torch.equal(outs[0], outs[1]):
        raise SystemExit(f"{label}: two seeds gave the same views")
    check_launches(launches, per_forward, 2 * pipe.ddim_steps, label)
    print(f"{label}: seconds_per_scene={[round(s, 3) for s in secs]} launches={launches} "
          f"unet_forwards={2 * pipe.ddim_steps}")
    return launches


def train_steps(step, state, batch, steps: int, per_step: dict, sites: dict, label: str):
    """A warm-up step with its backward kernel sites recorded and checked
    against ``sites``, then ``steps`` timed steps with their kernel launches
    checked against ``per_step``.  Returns (state, the losses, seconds per
    timed step, the timed steps' launches)."""
    import torch
    from collections import Counter

    from leftrefill_torch import kernels, tools

    gen = torch.Generator("cuda").manual_seed(7)
    with kernels.record_sites() as recorded:
        state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    for name in BWD_NAMES:
        got = dict(Counter(shape for n, shape in recorded if n == name))
        if got != sites:
            raise SystemExit(f"{label}: {name} sites per step {got}, expected {sites}")
    losses = [float(metrics["loss"])]
    tools.reset_launches()
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))  # reads the loss back: the step has ended
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = tools.launches()
    check_launches(launches, per_step, steps, label)
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"{label}: non-finite loss {losses}")
    return state, losses, secs, launches


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
    from leftrefill_torch.ops import quant
    from leftrefill_torch.tools import cuda_ms, rel_l2
    from leftrefill_torch.tools.library_baselines import geglu_sites

    print(tools.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"phase 1 setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built from leftrefill_torch/csrc "
          f"in {time.perf_counter() - t0:.1f} s -> {kernels.library_path().relative_to(ROOT)}; "
          f"tf32 off")
    log = (kernels.library_path().parent / "build.log").read_text()
    for kernel, smem_of in (("flash_fwd_kernel", lib.lr_flash_fwd_smem), ("conv3x3_kernel", lib.lr_conv3x3_smem),
                            ("flash_bwd_dq_kernel", lib.lr_flash_bwd_dq_smem),
                            ("flash_bwd_dkv_kernel", lib.lr_flash_bwd_dkv_smem),
                            ("geglu_up_kernel", lambda n: lib.lr_geglu_smem(0, 0)),
                            ("geglu_down_kernel", lambda n: lib.lr_geglu_smem(1, n)),
                            ("geglu_int8_up_kernel", lambda n: lib.lr_geglu_int8_smem(0, 0)),
                            ("geglu_int8_down_kernel", lambda n: lib.lr_geglu_int8_smem(1, n)),
                            ("conv3x3_int8_kernel", quant.conv3x3_int8_smem),
                            ("ln_quant_kernel", lambda n: "8 C (gamma, beta)"), ("gn_quant_kernel", lambda n: 0)):
        for line in ptxas_report(log, kernel):
            n = re.search(r"<(\d*)", line).group(1)
            print(f"phase 1 ptxas {line}; dynamic shared memory {smem_of(int(n or 0))} bytes")

    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0))
    unet = model.unet
    gen = torch.Generator("cuda").manual_seed(1)
    x, tsteps, ctx = tools.unet_inputs(gen)
    report = {}
    launches = {}

    # ---- phase 2: each bf16 kernel at the UNet forward's own shapes --------
    with torch.inference_mode():
        kv = unet.cross_kv(ctx)
        sites_bf16 = tools.unet_sites(unet, x, tsteps, ctx, kv, True)
        check_kernels(sites_bf16, gen, report, "2", BF16_NAMES)
        # off the main path: head dim 128, and the key/query and channel tails
        for name, shape in OFF_PATH:
            site = tools.site_args(name, shape, gen)
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            reading, _ = compare(name, run(), plain())
            print(f"phase 2 {name} shape={shape} (off the main path) {reading} "
                  f"kernel_ms={cuda_ms(run, 5):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
        check_sites(report, {n: tools.PER_FORWARD_BF16[n] for n in BF16_NAMES}, "bf16")
        check_bit_equal("geglu", max(s for n, s in sites_bf16 if n == "geglu"), gen, "2")

        # ---- phase 3: the full-width UNet forward, kernels vs plain --------
        out_bf16, _, err, kern_ms, plain_ms = check_forward(unet, x, tsteps, ctx, kv, "bf16", kernels.NAMES)
        print(f"phase 3 unet forward [2,64,128,9] bf16 cfg_dup cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f}")

    # ---- phase 4: serving two 512x1024 bf16 requests -----------------------
    launches["bf16_ddim50"] = serve(model, "ddim", 50, tools.PER_FORWARD_BF16,
                                    "phase 4 serving 512x1024 bf16 ddim50 eta1 cfg2.5 b1")
    del model, unet, kv

    # ---- phase 2i: the unfused int8 UNet's kernels at their own shapes -----
    t0 = time.perf_counter()
    qmodel = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), quant=True)
    umodel = tools.unfused_twin(qmodel)
    torch.cuda.synchronize()
    print(f"phase 2i int8 bundle: the seed-0 fp32 weights quantized per output channel "
          f"in {time.perf_counter() - t0:.1f} s; fused and unfused UNets on the same int8 weights")
    qunet, uunet = qmodel.unet, umodel.unet
    with torch.inference_mode():
        qkv = uunet.cross_kv(ctx)
        sites_int8 = tools.unet_sites(uunet, x, tsteps, ctx, qkv, True)
        check_kernels(sites_int8, gen, report, "2i", INT8_NAMES)
        check_sites(report, {n: tools.PER_FORWARD_INT8_UNFUSED[n] for n in INT8_NAMES}, "int8")
        check_bit_equal("geglu_int8", max(s for n, s in sites_int8 if n == "geglu_int8"), gen, "2i")
        # KI3 off the main path: a 1280-wide requant chunk (the up kernel's
        # cluster of 10 blocks) over a din of 320 (a 64-byte K tail)
        shape = (128, 320, 1280, 320, 1280)
        site = tools.site_args("geglu_int8", shape, gen)
        run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS["geglu_int8"])
        reading, _ = compare("geglu_int8", run(), plain())
        print(f"phase 2i geglu_int8 shape={shape} (off the main path) {reading} {check_plan('geglu_int8', shape)} "
              f"kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
        # KI1's fp32 output arm (an fp32 int8 model), off the main path
        shape = (2, 32, 64, 640, 640)
        site = (*tools.site_args("conv3x3_int8", shape, gen), torch.float32)
        run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS["conv3x3_int8"])
        got, ref = run(), plain()
        if not (got.dtype == ref.dtype == torch.float32 and torch.equal(got, ref)):
            raise SystemExit(f"conv3x3_int8 fp32 {shape}: differs from the plain version "
                             f"(max abs {float((got - ref).abs().max()):.3e})")
        print(f"phase 2i conv3x3_int8 fp32 shape={shape} (off the main path) equal to the plain version "
              f"kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")

        # ---- phase 3i: the full-width unfused int8 forward, kernels vs plain
        # the int8 kernels routed to their plain versions, K1 on its kernel in
        # both forwards: any rounding difference (K1's ~2e-4 a call) moves
        # int8 values by a step, which the following quantized stages spread
        # to the int8 noise level; with K1 routed too the difference is shown
        out_unfused, _, err, kern_ms, plain_ms = check_forward(uunet, x, tsteps, ctx, qkv, "int8", INT8_NAMES)
        with kernels.plain_kernels():
            out_all_plain = uunet(x, tsteps, ctx, cross_kv=qkv, cfg_dup=True)
        print(f"phase 3i unet forward [2,64,128,9] int8 unfused cfg_dup cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f}; for information: "
              f"rel_l2_with_k1_plain_too={rel_l2(out_unfused, out_all_plain):.3e} "
              f"rel_l2_vs_bf16_forward={rel_l2(out_unfused, out_bf16):.3e}")
        del out_all_plain

    # ---- phase 5: serving two 512x1024 unfused int8 requests ---------------
    launches["int8_unfused_dpm15"] = serve(umodel, "dpm++2m", 15, tools.PER_FORWARD_INT8_UNFUSED,
                                           "phase 5 serving 512x1024 int8 unfused dpm++2m15 cfg2.5 b1")
    del umodel, uunet

    # ---- phase 2f: the fused prologues at the fused forward's shapes -------
    with torch.inference_mode():
        check_kernels(tools.unet_sites(qunet, x, tsteps, ctx, qkv, True), gen, report, "2f", PROLOGUES)
        check_sites(report, {n: tools.PER_FORWARD_INT8[n] for n in PROLOGUES}, "int8 fused")
        # K7 and K8 writing their bf16 output too, off the main path
        for name, shape in (("ln_quant", (16384, 320, True)), ("gn_quant", (2, 64, 128, 320, True))):
            site = tools.site_args(name, shape, gen)
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            reading, _ = compare(name, run(), plain())
            print(f"phase 2f {name} shape={shape} (off the main path) {reading} "
                  f"kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")

        # ---- phase 3f: the fused forward, K4/K7/K8 vs their plain versions --
        fwd = lambda: qunet(x, tsteps, ctx, cross_kv=qkv, cfg_dup=True)
        errs, e2e = teacher_forced(qunet, fwd, PROLOGUES)
        worst = max(errs.items(), key=lambda kv_: kv_[1][2])
        st = [e for e in errs.values() if e[0] == "SpatialTransformer"]
        st_l2 = (sum((e[1] * e[3]) ** 2 for e in st) / sum(e[3] ** 2 for e in st)) ** 0.5
        exact = all(e[1] == 0 for e in errs.values())
        if worst[1][2] > BLOCK_MAX_REL or st_l2 > TRANSFORMERS_L2 or (exact and e2e > UNET_REL_L2):
            raise SystemExit(f"phase 3f: block {worst[0]} max rel {worst[1][2]:.3e} > {BLOCK_MAX_REL}, or the "
                             f"transformers' rel L2 {st_l2:.3e} > {TRANSFORMERS_L2}, or end to end {e2e:.3e}")
        out_fused = fwd()
        kern_ms = cuda_ms(fwd, 3)
        print(f"phase 3f unet forward [2,64,128,9] int8 fused cfg_dup cross_kv, teacher-forced blocks "
              f"({len(errs)}): max_block_max_rel={worst[1][2]:.3e} ({worst[0]}) transformers_rel_l2={st_l2:.3e} "
              f"blocks_equal={sum(e[1] == 0 for e in errs.values())}/{len(errs)} kernels_ms={kern_ms:.2f}; "
              f"for information: rel_l2_end_to_end={e2e:.3e} rel_l2_vs_unfused_forward={rel_l2(out_fused, out_unfused):.3e}")
        del out_fused, out_unfused, out_bf16, qkv

    # ---- phase 5f: serving two 512x1024 fused int8 requests ----------------
    launches["int8_fused_dpm15"] = serve(qmodel, "dpm++2m", 15, tools.PER_FORWARD_INT8,
                                         "phase 5f serving 512x1024 int8 fused dpm++2m15 cfg2.5 b1")
    del qmodel, qunet

    # ---- phase 2m: the flash kernel at the multi-view joint shapes ---------
    multiview = {}
    with torch.inference_mode():
        for views in (4, 2):
            shape = (2, 5, 4096 * views, 4096 * views, 64)
            mv_report = {}
            check_site("flash_fwd", shape, gen, 1, mv_report, f"2m V={views}")
            multiview[f"V{views}_{shape[2]}_tokens"] = {k: mv_report["flash_fwd"][k] for k in
                                                       ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}

    # ---- phase 3m: one full-width V=4 multi-view forward, kernels vs plain --
    mvmodel = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0),
                                       view_num=VIEWS)
    mvunet = mvmodel.unet
    with torch.inference_mode():
        xm, tm, cm = tools.unet_inputs(gen, rows=2 * VIEWS, hw=(64, 64))
        mkv = mvunet.cross_kv(cm)
        sites = tools.unet_sites(mvunet, xm, tm, cm, mkv, cfg_dup=False)
        per_forward = {n: sum(c for (name, _), c in sites.items() if name == n) for n in tools.LAUNCH_COUNTERS}
        joint = sum(c for (name, shape), c in sites.items() if name == "flash_fwd" and shape[3] == 4096 * VIEWS)
        if per_forward != tools.PER_FORWARD_MV4 or joint != 5:
            raise SystemExit(f"phase 3m: sites per forward {per_forward}, {joint} at {4096 * VIEWS} tokens")
        # every site of the V=4 forward, the joint attentions' and the
        # 8-row convs' and GEGLUs' shapes that the 1-reference path lacks
        mv_forward = {}
        check_kernels(sites, gen, mv_forward, "3m", BF16_NAMES)
        _, _, err, kern_ms, plain_ms = check_forward(mvunet, xm, tm, cm, mkv, "multiview", kernels.NAMES,
                                                     cfg_dup=False)
        print(f"phase 3m unet forward [{2 * VIEWS},64,64,9] bf16 multi-view V={VIEWS} cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f} sites={per_forward}")
        del mkv

    # ---- phase 6: multi-view serving, V=4 ----------------------------------
    launches["multiview_v4_ddim50"] = serve_multiview(mvmodel, tools.PER_FORWARD_MV4,
                                                      f"phase 6 serving V={VIEWS} 512x512 views bf16 ddim50 eta1 cfg2.5")

    del mvmodel, mvunet

    # ---- phase 2t: the flash backward kernels at the train steps' shapes ---
    # (outside inference mode: the library time is SDPA's autograd backward)
    mv_train = {}
    for shape, n_sites in sorted(tools.TRAIN_SITES.items()):
        for name in BWD_NAMES:
            check_site(name, shape, gen, n_sites, report, "2t 1-reference")
    for shape, n_sites in sorted(tools.TRAIN_SITES_MV4.items()):
        for name in BWD_NAMES:
            check_site(name, shape, gen, n_sites, mv_train, f"2t V={VIEWS}")
    # off the main path: head dim 128, the 64-row tails, Nq != Nk
    for shape in OFF_PATH_BWD:
        site = tools.site_args("flash_bwd_dq", shape, gen)
        for name in BWD_NAMES:
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            reading, _ = compare_backward(name, site, run(), plain())
            print(f"phase 2t {name} shape={shape} (off the main path) {reading} "
                  f"kernel_ms={cuda_ms(run, 5):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
    # determinism: no block writes another's rows, so two launches agree bit for bit
    shape = max(tools.TRAIN_SITES, key=lambda sh: sh[2])
    site = tools.site_args("flash_bwd_dq", shape, gen)
    for name in BWD_NAMES:
        first, second = (tools.KERNEL_FNS[name][0](*site) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (first, second)))):
            raise SystemExit(f"phase 2t {name} {shape}: two launches differ")
        print(f"phase 2t {name} shape={shape}: two launches bit-equal")
    del site, first, second
    # K3 at the train steps' GEGLU sites: the forward and the remat recompute
    train_geglu = {}
    with torch.inference_mode():
        for views, key in ((None, "train_1ref_b8"), (VIEWS, "train_mv4")):
            train_geglu[key] = {}
            for shape, n_sites in geglu_sites(views, True, False):
                check_site("geglu", shape, gen, n_sites, train_geglu[key], f"2t {key}")
            if train_geglu[key]["geglu"]["sites"] != tools.PER_TRAIN_STEP["geglu"]:
                raise SystemExit(f"phase 2t {key}: {train_geglu[key]['geglu']['sites']} GEGLU sites a step")
        check_bit_equal("geglu", max(s for s, _ in geglu_sites(None, True, False)), gen, "2t")

    # ---- phase 7: 1-reference prompt-tuning training at full width --------
    from leftrefill_torch.models.clip import init_prompt_table
    from leftrefill_torch.train import OptimizerConfig, compute_loss, create_train_state, make_train_step, view_options

    t0 = time.perf_counter()
    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), remat=True)
    tok, sp, init = tools.prompt_tokenizer()
    init_prompt_table(model.cond_stage_model, tok, sp, init)
    state, tx = create_train_state(model, OptimizerConfig())  # the released optimizer: AdamW 3e-5, wd 0.01
    table = model.cond_stage_model.special_embeddings.weight
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = tools.training_batch(8)
    torch.cuda.synchronize()
    print(f"phase 7 set-up: remat bundle, prompt table {tuple(table.shape)} {table.dtype} initialised from "
          f"its init text, {sum(p.numel() for p in model.parameters() if p.requires_grad)} trainable of "
          f"{sum(p.numel() for p in model.parameters())} parameters, in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, launches["train_1ref_b8"] = train_steps(
        make_train_step(model, tx, *view_options(model)), state, batch, 3, tools.PER_TRAIN_STEP,
        tools.TRAIN_SITES, "phase 7 training")
    after = model.state_dict()
    changed = sorted(k for k in before if not torch.equal(before[k], after[k]))
    if changed != ["cond_stage_model.special_embeddings.weight"]:
        raise SystemExit(f"phase 7: parameters changed by training: {changed[:5]} (only the prompt table may)")
    per_step = {n: c // 3 for n, c in launches["train_1ref_b8"].items() if c}
    print(f"phase 7 training 1-reference b8 512x1024 remat AdamW(3e-5, wd 0.01): seconds_per_step="
          f"{[round(x, 3) for x in secs]} losses={[round(x, 5) for x in losses]} launches_per_step={per_step} "
          f"table_moved_max_abs={float((after[changed[0]].float() - before[changed[0]].float()).abs().max()):.3e} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del before, after

    # one step's prompt-table gradient at batch 2, kernels against plain versions
    small = {k: v[:2] for k, v in batch.items()}
    g2 = torch.Generator("cuda").manual_seed(11)
    t_fix = torch.randint(0, 1000, (2,), generator=g2, device="cuda")
    noise = torch.randn((2, 64, 128, 4), generator=g2, device="cuda").to(torch.bfloat16)

    def prompt_grad():
        table.grad = None
        compute_loss(model, small, t_fix, noise)[0].backward()
        torch.cuda.synchronize()
        return table.grad.clone()

    grad_k = prompt_grad()
    with kernels.plain_kernels():
        grad_p = prompt_grad()
    table.grad = None
    err = rel_l2(grad_k, grad_p)
    if not (torch.isfinite(grad_k).all() and grad_k.abs().max() > 0 and err <= PROMPT_GRAD_REL_L2):
        raise SystemExit(f"phase 7: prompt-table gradient through the kernels rel L2 {err:.3e} from the plain "
                         f"versions' (limit {PROMPT_GRAD_REL_L2}) or zero / non-finite")
    print(f"phase 7 prompt-table gradient b2 t={t_fix.tolist()}: kernels vs plain versions rel_l2={err:.3e} "
          f"(limit {PROMPT_GRAD_REL_L2}) grad_norm={float(grad_k.norm()):.4e}")
    del model, state, tx, table, grad_k, grad_p, batch, small

    # ---- phase 8: V=4 multi-view prompt-tuning training --------------------
    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0),
                                     view_num=VIEWS, remat=True)
    state, tx = create_train_state(model, OptimizerConfig())
    table = model.cond_stage_model.special_embeddings.weight
    start = table.detach().clone()
    reduced, view_num = view_options(model)
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, launches["train_mv4"] = train_steps(
        make_train_step(model, tx, reduced, view_num), state, tools.multiview_training_batch(VIEWS), 2,
        tools.PER_TRAIN_STEP_MV4, tools.TRAIN_SITES_MV4, "phase 8 training")
    moved = float((table.detach() - start).abs().max())
    if not moved > 0:
        raise SystemExit("phase 8: the prompt table did not move")
    per_step = {n: c // 2 for n, c in launches["train_mv4"].items() if c}
    print(f"phase 8 training V={VIEWS} 512x512 views, view-0 loss (view_reduced={reduced}), table "
          f"{tuple(table.shape)}: seconds_per_step={[round(x, 3) for x in secs]} losses={[round(x, 5) for x in losses]} "
          f"launches_per_step={per_step} table_moved_max_abs={moved:.3e} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del model, state, tx, table

    entries = []
    for name, (source, replaces) in KERNELS.items():
        rep = report[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        tag = {"flash_fwd": " (K1, K11)", "flash_bwd_dq": " (K12, K14)", "flash_bwd_dkv": " (K13)"}.get(name, "")
        entry = {"name": name + tag, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": rep["max_abs_err"], "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                 "bound_ms": rep["bound_ms"],
                 "bound_by": "operations" if 2 * rep["bound_ops_ms"] > rep["bound_ms"] else "bytes",
                 "library_ms": rep["library_ms"],
                 ("sites_per_train_step" if name in BWD_NAMES else "sites_per_forward"): rep["sites"]}
        if name in mv_train:  # the V=4 train step's sites, held and timed in phase 2t
            entry["multiview_v4_train_step"] = {k: mv_train[name][k] for k in
                                                ("sites", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
            entry["max_abs_err"] = max(entry["max_abs_err"], mv_train[name]["max_abs_err"])
        if name in tools.COMPOSED:  # the yardstick: a composition of calls, not one library call
            entry["composition_ms"] = rep["composition_ms"]
        if name == "geglu":  # the train steps' sites, held and timed in phase 2t
            for key, rep_t in train_geglu.items():
                entry[key] = {k: rep_t["geglu"][k] for k in
                              ("sites", "ms", "plain_ms", "bound_ms", "composition_ms", "max_abs_err")}
                entry["max_abs_err"] = max(entry["max_abs_err"], rep_t["geglu"]["max_abs_err"])
        if name in mv_forward:  # the V=4 forward's sites, held and timed in phase 3m
            entry["multiview_v4_forward"] = {k: mv_forward[name][k] for k in
                                             ("sites", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                                              "composition_ms") if k in mv_forward[name]}
            entry["max_abs_err"] = max(entry["max_abs_err"], mv_forward[name]["max_abs_err"])
        if name == "flash_fwd":
            entry["multiview_joint_attention"] = multiview
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
