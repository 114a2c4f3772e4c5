"""Each hand-written kernel against the library path for the same product,
at the main path's own shapes, on one CUDA GPU.

    python -m leftrefill_torch.tools.library_baselines [--multiview V] [--json PATH]
    python -m leftrefill_torch.tools.library_baselines --train [--multiview 4] [--json PATH]

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
K3 has no single library call (two cuBLAS products with the GEGLU between
them would write h to device memory) and is left out.
With ``--train`` the sites are the flash backward's in one full-width train
step (``tools.TRAIN_SITES``; with ``--multiview 4`` the V=4 scene's,
``tools.TRAIN_SITES_MV4``): dq (K12 + K14) and dk/dv (K13) each, and their
sum, against the backward of ``scaled_dot_product_attention`` (dq, dk and dv
in one call, exact softmax: the same work, not the same values), each with
its bound and bound share.  Below ~0.1 ms a launch the card waits on the
host between back-to-back calls, so ``--train`` also gives each its device
ms: the summed durations of the kernels one call launches (``torch.profiler``),
which leave those gaps out.
They are timed for reference only (CUDA events, after warm-up, kernel and
library in turn within one process); none of them is on the port's path.
Each line also gives the relative L2 between the two outputs, the site's
bound (``tools.bound_ms``), the kernel's share of it (bound / kernel ms),
and the host's microseconds per call of the kernel's wrapper and of the
library call (host clock over back-to-back calls that nothing synchronises:
what each costs a request whose host, not its card, sets the pace).
The script uses only helpers that the port has had since its training
slice (``--train``'s ``TRAIN_SITES``, ``site_args``, backward
``library_fn`` and ``profile_request._device_us`` among them), so it can time an earlier tree's kernels too:
``PYTHONPATH=<that tree> python leftrefill_torch/tools/library_baselines.py``.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

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


def device_ms(fn, calls: int = 50) -> float:
    """Device ms per call of ``fn``: the durations of the kernels (and
    copies) that ``calls`` calls launch, summed by ``torch.profiler`` after a
    warm-up call, with no host gap between launches counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    if us == 0:
        raise SystemExit("library_baselines: the profiler recorded no device time")
    return us / 1e3 / calls


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
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    if args.train:
        train_sites(args.multiview)
    if not torch.cuda.is_available():
        raise SystemExit("library_baselines: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = tools.card_line()
    print(card)
    gen = torch.Generator("cuda").manual_seed(0)
    views = args.multiview
    rows = backward_rows(views, gen) if args.train else forward_rows(views, gen)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "multiview": views, "train": args.train,
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
