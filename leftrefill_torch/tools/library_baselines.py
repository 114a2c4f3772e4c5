"""Each hand-written kernel against the library path for the same product,
at the main path's own shapes, on one CUDA GPU.

    python -m leftrefill_torch.tools.library_baselines [--multiview V] [--json PATH]
    python -m leftrefill_torch.tools.library_baselines --train [--multiview 4] [--json PATH]
    python -m leftrefill_torch.tools.library_baselines --geglu [--multiview 4] [--train] [--int8] [--json PATH]
    python -m leftrefill_torch.tools.library_baselines --int8 [--unfused] [--json PATH]

The sites are those of one full-width CFG-doubled bf16 UNet forward: the
1-reference canvas (2 rows of 64x128 latents, ``cfg_dup`` on), or with
``--multiview V`` the V-view scene (2 V rows of 64x64 views, whose joint
self-attentions reach V x 4096 tokens: K11's sites in the JAX package).

The library paths (``tools.library_fn``), bf16 with fp32 accumulation:
- K1 flash forward: ``scaled_dot_product_attention`` on the same q, k, v
  viewed as [B, H, N, D] (exact softmax; the kernel clamps at 75, which these
  inputs never reach);
- K2 3x3 conv: ``conv2d`` (cuDNN) on the same NHWC input and OHWI weight
  viewed as channels-last NCHW / OIHW.
With ``--train`` the sites are the flash backward's in one full-width train
step (``tools.TRAIN_SITES``; with ``--multiview 4`` the V=4 scene's,
``tools.TRAIN_SITES_MV4``): dq (K12 + K14) and dk/dv (K13) each, and their
sum, against the backward of ``scaled_dot_product_attention`` (dq, dk and dv
in one call, exact softmax: the same work, not the same values), each with
its bound and bound share.  Below ~0.1 ms a launch the card waits on the
host between back-to-back calls, so ``--train`` also gives each its device
ms: the summed durations of the kernels one call launches (``torch.profiler``),
which leave those gaps out.
With ``--geglu`` the sites are every GEGLU site of the path (``geglu_sites``:
the 1-reference or V=4 forward, with ``--train`` the train step's forward and
remat recompute, with ``--int8`` the int8 forward's KI3 sites with their
requant chunk), and each kernel is held against its yardstick, which is no
single library call: K3 against the cuBLAS composition (``F.linear``, the
gated GELU in fp32, ``F.linear``: ``mlp.geglu_vjp_math`` with bf16 biases),
KI3 against its two ``torch._int_mm`` products alone; each in CUDA-event
and device ms, with its bound, its share and the host's microseconds per
call, and a per-path total.
With ``--int8`` (and no ``--geglu``) the sites are every KI1 (int8 3x3
conv), KI2 (int8 proj_out + residual), K4 (GN affine + SiLU + quantize), K7
(LayerNorm + row quantize) and K8 (GN affine + pixel quantize) site of one
fused int8 forward (``INT8_SITES``; with ``--unfused`` the unfused forward's
KI1 and KI2 sites), each in device ms, CUDA-event ms and host µs a call,
with its bound and bound share, KI1 and KI2 beside their yardsticks (the
``torch._int_mm`` product of the same M x K x N, KI1's on a pre-built int8
im2col: the tensor work alone), and a total per kernel a forward.  A K4
site is timed as the site function ``quant.silu_quant(x, a, bb)`` (the
per-tensor scale and the quantize: one launch of K4, or in an earlier tree
the scale's eager PyTorch glue and K4 on 1 / scale), in device ms with its
device launches a call counted by the profiler, and K4's kernel alone
beside it.  Below ~0.1 ms a launch the CUDA-event ms are partly the
host's; the device ms are the card's.
They are timed for reference only (CUDA events, after warm-up, kernel and
library in turn within one process); none of them is on the port's path.
Each line also gives the relative L2 between the two outputs, the site's
bound (``tools.bound_ms``), the kernel's share of it (bound / kernel ms),
and the host's microseconds per call of the kernel's wrapper and of the
library call (host clock over back-to-back calls that nothing synchronises:
what each costs a request whose host, not its card, sets the pace).
The script uses only helpers that the port has had since its training
slice (``--train``'s ``TRAIN_SITES``, ``site_args``, backward
``library_fn`` and ``profile_request._device_us`` among them), and keeps its
own copy of the GEGLU, KI1 and KI2 yardsticks for a tree whose
``library_fn`` lacks them, so it can time an earlier tree's kernels too:
``PYTHONPATH=<that tree> python leftrefill_torch/tools/library_baselines.py``.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch
import torch.nn.functional as F

from leftrefill_torch import tools
from leftrefill_torch.models.multiview import MultiViewUnetModel
from leftrefill_torch.models.unet import UNetModel
from leftrefill_torch.tools.profile_request import _device_us


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back calls
    (their launches queue up on the card; the queue is deeper than that)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def warm_up(fn, seconds: float = 2.0) -> None:
    """Call ``fn`` for ``seconds``, so the card's clocks have settled under
    load before the first timing (a cold and a warm turn of one kernel
    differed by 13 %)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()


def device_ms(fn, calls: int = 50, tries: int = 10, kernel: str | None = None) -> float:
    """Device ms per call of ``fn``: the durations of the kernels (and
    copies) that ``calls`` calls launch, summed by ``torch.profiler`` after a
    warm-up call, with no host gap between launches counted (only the
    kernels whose name holds ``kernel``, where it is given).  The profiler
    can lose events (one of 50 in a window, or all of them), so each kernel
    counts as its mean duration over the events recorded times its launches
    a call (the recorded count over ``calls``, rounded, at least one); a
    window with no device event is profiled again, up to ``tries`` windows
    (three empty windows in a row were seen at a 5-call window of a 17 µs
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count
                  and (kernel is None or kernel in e.key)]
        if events:
            return sum(_device_us(e) / e.count * max(1, round(e.count / calls)) for e in events) / 1e3
    raise SystemExit(f"library_baselines: the profiler recorded no device time in {tries} windows")


def device_launches(fn, calls: int = 20, tries: int = 3) -> float:
    """Device launches (kernels and copies) per call of ``fn``, counted by
    ``torch.profiler`` over ``calls`` calls after a warm-up call; the most
    of ``tries`` windows (the profiler can lose events, never add them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA))
    return most / calls


# the GEGLU sites of each path, (R, din, inner, dout[, chunk]) -> launches
# (tests/test_torch_tools.py holds them to the port's dispatch on meta):
# a CFG-doubled 1-reference forward (2 rows of 64x128 latents), the V=4
# forward (8 rows of 64x64), the int8 forward (its requant chunks), and the
# train steps (batch 8 of 64x128, or 4 rows of 64x64), whose forward and
# remat recompute each launch every site
_LEVELS = ((320, 1280, 320, 5), (640, 2560, 640, 5), (1280, 5120, 1280, 5), (1280, 5120, 1280, 1))


def _sites(rows: int, per_site: int = 1) -> dict:
    return {(rows >> (2 * lvl), din, inner, dout): n * per_site
            for lvl, (din, inner, dout, n) in enumerate(_LEVELS)}


GEGLU_SITES = {"forward": _sites(16384), "forward_mv4": _sites(32768), "train": _sites(65536, 2),
               "train_mv4": _sites(16384, 2)}
GEGLU_INT8_SITES = {(*shape, chunk): n for (shape, n), chunk in zip(_sites(16384).items(), (640, 640, 256, 640))}


def geglu_sites(views, train: bool, int8: bool) -> list:
    """The GEGLU's (shape, launches) of one path, in the order ``--geglu``
    walks them: the 1-reference or V=4 forward, their train steps, or the
    int8 forward (the 1-reference one, its KI3 sites)."""
    if views not in (None, 4) or int8 and (views or train):
        raise SystemExit("library_baselines --geglu: the paths are the 1-reference and V=4 forwards and train "
                         "steps, and the 1-reference int8 forward")
    if int8:
        return sorted(GEGLU_INT8_SITES.items())
    return sorted(GEGLU_SITES[("train" if train else "forward") + ("_mv4" if views else "")].items())


def geglu_yardstick(name: str, site: tuple):
    """``tools.library_fn`` for the GEGLUs, or this script's own copy of it
    where the tree's ``library_fn`` has none (a tree from before the GEGLU
    yardsticks): the cuBLAS composition for K3, the two int8 products for
    KI3."""
    fn = tools.library_fn(name, site)
    if fn is not None:
        return fn
    if name == "geglu":
        x, w1, b1, w2, b2 = site
        b1h, b2h = b1.to(x.dtype), b2.to(x.dtype)

        def composition():
            val, gate = F.linear(x, w1, b1h).chunk(2, dim=-1)
            return F.linear((val.float() * F.gelu(gate.float())).to(x.dtype), w2, b2h)

        return composition
    xq, w1, w2 = site[0], site[2], site[5]
    hq = torch.ones((xq.shape[0], w2.shape[1]), dtype=torch.int8, device=xq.device)
    return lambda: (torch._int_mm(xq, w1.t()), torch._int_mm(hq, w2.t()))


def geglu_rows(views, train: bool, int8: bool, gen) -> list:
    """K3 (or KI3) against its yardstick at every GEGLU site of the path,
    and the path's totals."""
    name = "geglu_int8" if int8 else "geglu"
    rows, total = [], {"kernel": name, "shape": "total", "sites": 0}
    for shape, n_sites in geglu_sites(views, train, int8):
        site = tools.site_args(name, shape, gen)
        kernel = functools.partial(tools.KERNEL_FNS[name][0], *site)
        yardstick = geglu_yardstick(name, site)
        row = {"kernel": name, "shape": list(shape), "sites": n_sites,
               "kernel_ms": tools.cuda_ms(kernel, 20), "yardstick_ms": tools.cuda_ms(yardstick, 20)}
        if not int8:
            row["rel_l2_to_yardstick"] = tools.rel_l2(kernel(), yardstick())
        row["kernel_device_ms"], row["yardstick_device_ms"] = device_ms(kernel), device_ms(yardstick)
        row["kernel_over_yardstick"] = row["kernel_device_ms"] / row["yardstick_device_ms"]
        row["bound_ms"], row["bound_by"] = tools.bound_ms(name, shape)
        row["bound_share"] = row["bound_ms"] / row["kernel_device_ms"]
        row["host_us"], row["yardstick_host_us"] = host_us(kernel), host_us(yardstick)
        rows.append(row)
        print(json.dumps(row))
        for key in ("kernel_ms", "yardstick_ms", "kernel_device_ms", "yardstick_device_ms", "bound_ms"):
            total[key] = total.get(key, 0.0) + n_sites * row[key]
        total["sites"] += n_sites
        del site, kernel, yardstick
    total["kernel_over_yardstick"] = total["kernel_device_ms"] / total["yardstick_device_ms"]
    total["bound_share"] = total["bound_ms"] / total["kernel_device_ms"]
    rows.append(total)
    print(json.dumps(total))
    return rows


# the int8 kernels' sites of one CFG-doubled 1-reference int8 forward (2
# rows of 64x128 latents, cfg_dup on: the first level's input convs, norm
# and transformer run on one row), (kernel, shape) -> launches
# (tests/test_torch_tools.py holds them to the port's dispatch on meta): KI1
# and KI2 are the same in both arms, the fused one adds K4, K7 and K8
_KI1_SITES = {
    (1, 64, 128, 320, 320): 2, (2, 64, 128, 320, 320): 5, (2, 64, 128, 640, 320): 2, (2, 64, 128, 640, 640): 1,
    (2, 64, 128, 960, 320): 1, (2, 32, 64, 320, 640): 1, (2, 32, 64, 640, 640): 6, (2, 32, 64, 960, 640): 1,
    (2, 32, 64, 1280, 640): 1, (2, 32, 64, 1280, 1280): 1, (2, 32, 64, 1920, 640): 1, (2, 16, 32, 640, 1280): 1,
    (2, 16, 32, 1280, 1280): 7, (2, 16, 32, 1920, 1280): 1, (2, 16, 32, 2560, 1280): 2, (2, 8, 16, 1280, 1280): 11,
    (2, 8, 16, 2560, 1280): 3,
}
_KI2_SITES = {(4096, 640, 640): 5, (1024, 1280, 1280): 5, (256, 1280, 1280): 1}
# K4 runs before each KI1 site but the Upsample convs' (no GroupNorm before them)
_K4_SITES = {
    (1, 64, 128, 320): 2, (2, 64, 128, 320): 5, (2, 64, 128, 640): 2, (2, 64, 128, 960): 1, (2, 32, 64, 320): 1,
    (2, 32, 64, 640): 6, (2, 32, 64, 960): 1, (2, 32, 64, 1280): 1, (2, 32, 64, 1920): 1, (2, 16, 32, 640): 1,
    (2, 16, 32, 1280): 6, (2, 16, 32, 1920): 1, (2, 16, 32, 2560): 2, (2, 8, 16, 1280): 11, (2, 8, 16, 2560): 3,
}
_K7_SITES = {(8192, 320, False): 1, (16384, 320, False): 14, (4096, 640, False): 15, (1024, 1280, False): 15,
             (256, 1280, False): 3}
_K8_SITES = {(1, 64, 128, 320, False): 1, (2, 64, 128, 320, False): 4, (2, 32, 64, 640, False): 5,
             (2, 16, 32, 1280, False): 5, (2, 8, 16, 1280, False): 1}
_UNFUSED = {**{("conv3x3_int8", s): n for s, n in _KI1_SITES.items()},
            **{("dense_int8_res", s): n for s, n in _KI2_SITES.items()}}
INT8_SITES = {"unfused": _UNFUSED,
              "fused": {**_UNFUSED, **{("affine_silu_quant", s): n for s, n in _K4_SITES.items()},
                        **{("ln_quant", s): n for s, n in _K7_SITES.items()},
                        **{("gn_quant", s): n for s, n in _K8_SITES.items()}}}


def int8_sites(unfused: bool) -> list:
    """The int8 kernels' ((kernel, shape), launches) of one forward of the
    fused (JAX's default) or the unfused int8 UNet, in the order ``--int8``
    walks them."""
    return sorted(INT8_SITES["unfused" if unfused else "fused"].items())


def conv_int8_yardstick(site: tuple):
    """``tools.library_fn`` for KI1, or this script's own copy of it where
    the tree's ``library_fn`` has none (a tree from before KI1's yardstick):
    the ``torch._int_mm`` product on a pre-built int8 im2col."""
    fn = tools.library_fn("conv3x3_int8", site)
    if fn is not None:
        return fn
    xq, w = site[0], site[2]
    b, h, wd, ci = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)], dim=-1)
    cols, wmat = cols.reshape(b * h * wd, 9 * ci), w.reshape(w.shape[0], 9 * ci)
    return lambda: torch._int_mm(cols, wmat.t())


def dense_int8_yardstick(site: tuple):
    """``tools.library_fn`` for KI2, or this script's own copy of it where
    the tree's ``library_fn`` has none (a tree from before KI2's yardstick):
    the ``torch._int_mm`` product [R, K] x [K, N] alone."""
    fn = tools.library_fn("dense_int8_res", site)
    if fn is not None:
        return fn
    xq, wq = site[0], site[2]
    return lambda: torch._int_mm(xq, wq.t())


YARDSTICKS = {"conv3x3_int8": conv_int8_yardstick, "dense_int8_res": dense_int8_yardstick}


def int8_rows(unfused: bool, gen) -> list:
    """Each int8 kernel at every site of the forward in device ms, event ms
    and host µs, with its bound (KI1 and KI2 beside their yardsticks, K4 as
    its site function with its device launches), and each kernel's total a
    forward."""
    from leftrefill_torch.ops import quant

    rows, totals = [], {}
    sites = int8_sites(unfused)
    (name, shape), _ = max(sites, key=lambda s: tools.bound_ms(*s[0])[0])
    warm_up(functools.partial(tools.KERNEL_FNS[name][0], *tools.site_args(name, shape, gen)))
    for (name, shape), n_sites in sites:
        site = tools.site_args(name, shape, gen)
        row = {"kernel": name, "shape": list(shape), "sites": n_sites}
        if name == "affine_silu_quant":  # the site: the scale and the quantize (x, a, bb in any tree)
            kernel = functools.partial(quant.silu_quant, *site[:3])
            row["kernel_ms"] = tools.cuda_ms(kernel, 20)
            row["kernel_device_ms"] = device_ms(kernel, kernel="affine_silu_quant_kernel")
            row["site_device_ms"], row["site_launches"] = device_ms(kernel), device_launches(kernel)
        else:
            kernel = functools.partial(tools.KERNEL_FNS[name][0], *site)
            row["kernel_ms"], row["kernel_device_ms"] = tools.cuda_ms(kernel, 20), device_ms(kernel)
        row["bound_ms"], row["bound_by"] = tools.bound_ms(name, shape)
        row["bound_share"] = row["bound_ms"] / row["kernel_device_ms"]
        if "site_device_ms" in row:
            row["site_bound_share"] = row["bound_ms"] / row["site_device_ms"]
        row["host_us"] = host_us(kernel)
        if name in YARDSTICKS:
            yardstick = YARDSTICKS[name](site)
            row["yardstick_ms"], row["yardstick_device_ms"] = tools.cuda_ms(yardstick, 20), device_ms(yardstick)
            row["kernel_over_yardstick"] = row["kernel_device_ms"] / row["yardstick_device_ms"]
            del yardstick
        rows.append(row)
        print(json.dumps(row))
        total = totals.setdefault(name, {"kernel": name, "shape": "total", "sites": 0})
        for key in ("kernel_ms", "kernel_device_ms", "bound_ms", "yardstick_ms", "yardstick_device_ms",
                    "site_device_ms", "site_launches"):
            if key in row:
                total[key] = total.get(key, 0.0) + n_sites * row[key]
        total["sites"] += n_sites
        del site, kernel
    for total in totals.values():
        total["bound_share"] = total["bound_ms"] / total["kernel_device_ms"]
        if "site_device_ms" in total:
            total["site_bound_share"] = total["bound_ms"] / total["site_device_ms"]
        if "yardstick_device_ms" in total:
            total["kernel_over_yardstick"] = total["kernel_device_ms"] / total["yardstick_device_ms"]
        rows.append(total)
        print(json.dumps(total))
    return rows


def train_sites(views) -> list:
    """The flash backward's (shape, launches) of one train step, in the
    order ``--train`` walks them: the 1-reference step's, or the V=4 scene's."""
    if views not in (None, 4):
        raise SystemExit("library_baselines --train: the train steps are the 1-reference one and V=4")
    return sorted((tools.TRAIN_SITES if views is None else tools.TRAIN_SITES_MV4).items())


def forward_rows(views, gen) -> list:
    """K1 and K2 against SDPA and cuDNN at each site of one UNet forward."""
    with torch.device("cuda"):
        unet = UNetModel(dtype=torch.bfloat16) if views is None else MultiViewUnetModel(view_num=views,
                                                                                      dtype=torch.bfloat16)
    unet.eval()
    rows = []
    with torch.inference_mode():
        x, t, ctx = tools.unet_inputs(gen) if views is None else tools.unet_inputs(gen, rows=2 * views, hw=(64, 64))
        sites = tools.unet_sites(unet, x, t, ctx, unet.cross_kv(ctx), cfg_dup=views is None)
        del unet
        for (name, shape), n_sites in sorted(sites.items()):
            site = tools.site_args(name, shape, gen)
            kernel = functools.partial(tools.KERNEL_FNS[name][0], *site)
            library = tools.library_fn(name, site)
            if library is None:
                continue
            err = tools.rel_l2(kernel(), library())
            row = {"kernel": name, "shape": list(shape), "sites": n_sites, "rel_l2": err,
                   "kernel_ms": tools.cuda_ms(kernel, 20), "library_ms": tools.cuda_ms(library, 20)}
            row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
            row["bound_ms"], row["bound_by"] = tools.bound_ms(name, shape)
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["host_us"], row["library_host_us"] = host_us(kernel), host_us(library)
            rows.append(row)
            print(json.dumps(row))
    return rows


def backward_rows(views, gen) -> list:
    """dq, dk/dv and their sum against SDPA's backward at each train site."""
    rows = []
    for shape, n_sites in train_sites(views):
        site = tools.site_args("flash_bwd_dq", shape, gen)
        dq, dkv = (functools.partial(tools.KERNEL_FNS[name][0], *site) for name in ("flash_bwd_dq", "flash_bwd_dkv"))
        library = tools.library_fn("flash_bwd_dq", site)
        row = {"kernel": "flash_bwd", "shape": list(shape), "sites": n_sites,
               "dq_ms": tools.cuda_ms(dq, 20), "dkv_ms": tools.cuda_ms(dkv, 20), "library_ms": tools.cuda_ms(library, 20)}
        row["sum_ms"] = row["dq_ms"] + row["dkv_ms"]
        row["sum_over_library"] = row["sum_ms"] / row["library_ms"]
        for part, fn in (("dq", dq), ("dkv", dkv), ("library", library)):
            row[f"{part}_device_ms"] = device_ms(fn)
        row["sum_device_over_library"] = (row["dq_device_ms"] + row["dkv_device_ms"]) / row["library_device_ms"]
        for part, name in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
            row[f"{part}_bound_ms"] = tools.bound_ms(name, shape)[0]
            row[f"{part}_bound_share"] = row[f"{part}_bound_ms"] / row[f"{part}_ms"]
        row["sum_bound_ms"] = row["dq_bound_ms"] + row["dkv_bound_ms"]
        row["sum_bound_share"] = row["sum_bound_ms"] / row["sum_ms"]
        row["dq_host_us"], row["dkv_host_us"], row["library_host_us"] = host_us(dq), host_us(dkv), host_us(library)
        rows.append(row)
        print(json.dumps(row))
        del site, library
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multiview", type=int, metavar="V", help="the V-view scene's sites")
    ap.add_argument("--train", action="store_true", help="the flash backward at the train step's sites")
    ap.add_argument("--geglu", action="store_true", help="K3 (or KI3) against its yardstick at every GEGLU site")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 kernels (KI1, KI2, K4, K7, K8) at the int8 forward's sites; with --geglu: KI3")
    ap.add_argument("--unfused", action="store_true", help="with --int8: the unfused int8 forward's KI1 and KI2")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    if args.unfused and (not args.int8 or args.geglu):
        ap.error("--unfused goes with --int8 alone")
    if args.int8 and not args.geglu and (args.train or args.multiview):
        ap.error("--int8 walks the 1-reference int8 forward")
    if args.geglu:
        geglu_sites(args.multiview, args.train, args.int8)
    elif args.train:
        train_sites(args.multiview)
    if not torch.cuda.is_available():
        raise SystemExit("library_baselines: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = tools.card_line()
    print(card)
    gen = torch.Generator("cuda").manual_seed(0)
    views = args.multiview
    if args.geglu:
        rows = geglu_rows(views, args.train, args.int8, gen)
    elif args.int8:
        rows = int8_rows(args.unfused, gen)
    else:
        rows = backward_rows(views, gen) if args.train else forward_rows(views, gen)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "multiview": views, "train": args.train,
                       "geglu": args.geglu, "int8": args.int8, "unfused": args.unfused, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
