"""Each hand-written kernel against the library path for the same product,
at the main path's own shapes, on one CUDA GPU.

    python -m leftrefill_torch.tools.library_baselines [--multiview V] [--json PATH]

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
They are timed for reference only (CUDA events, after warm-up, kernel and
library in turn within one process); none of them is on the port's path.
Each line also gives the relative L2 between the two outputs, the site's
bound (``tools.bound_ms``), the kernel's share of it (bound / kernel ms),
and the host's microseconds per call of the kernel's wrapper and of the
library call (host clock over back-to-back calls that nothing synchronises:
what each costs a request whose host, not its card, sets the pace).
The script uses only helpers that the port has had since its multi-view
slice, so it can time an earlier tree's kernels too:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multiview", type=int, metavar="V", help="the V-view scene's sites")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("library_baselines: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = tools.card_line()
    print(card)
    gen = torch.Generator("cuda").manual_seed(0)
    views = args.multiview
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
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "multiview": views, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
