"""Where the GEGLU kernels' time goes, on one CUDA GPU: the device ms of the
up and down kernels (``csrc/geglu.cuh``) at every GEGLU site of one
full-width forward, for the kernels as built and for timing-only variants.

    python -m leftrefill_torch.tools.geglu_variants [--int8] [--json PATH]

A variant is an edited copy of ``csrc/`` (``VARIANTS``: text replacements in
one source), built beside the port's own build under ``_build/variants/``
and loaded in its place for its turn.  It leaves work out to show that
work's cost, so its outputs are wrong by design and are not checked; the
kernels as built are held to their plain versions (K3 rel L2, KI3 bf16
ulps) in the same run.  The variants run in turns (as built first and
last), each site timed by ``torch.profiler`` over 30 calls after a warm-up.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from leftrefill_torch import kernels, tools
from leftrefill_torch.tools.library_baselines import geglu_sites
from leftrefill_torch.tools.profile_request import _device_us

_CSRC = kernels.CSRC  # the port's own sources
_ERF_BF16 = "erff(gate * 0.70710678118654752f)"
_ERF_INT8 = "erff(__fmul_rn(gt, 0.70710678118654752f))"
_PUSH = "cluster.map_shared_rank(mine_max, q)[rank * BM + row + 8 * half] = mx[half];"
_BARRIER = '''  asm volatile("barrier.cluster.arrive;\\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\\n" ::: "memory");'''
# kernel -> variant -> [(source file, text, replacement)]
VARIANTS = {
    "geglu": {
        "as built": [],
        "no erf": [("geglu.cu", _ERF_BF16, "gate")],
    },
    "geglu_int8": {
        "as built": [],
        "no erf": [("geglu_int8.cu", _ERF_INT8, "gt")],
        # each block keeps its own row maxima and no block waits on another
        "no row-max exchange": [("geglu_int8.cu", _PUSH, "mine_max[rank * BM + row + 8 * half] = mx[half];"),
                                ("geglu_int8.cu", _BARRIER, "")],
    },
}


def variant_source(name: str, edits: list) -> dict:
    """{file name: text} of the ``csrc/`` sources with ``edits`` applied;
    each edit's text must occur exactly once."""
    sources = {p.name: p.read_text() for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for fname, old, new in edits:
        if sources[fname].count(old) != 1:
            raise SystemExit(f"geglu_variants: {name}: the text to replace is not once in {fname}")
        sources[fname] = sources[fname].replace(old, new)
    return sources


def use_variant(name: str, edits: list) -> None:
    """Build (once) and load the variant's library in place of the port's."""
    csrc = kernels.BUILD_ROOT / "variants" / name.replace(" ", "_") / "csrc" if edits else _CSRC
    if edits:
        shutil.rmtree(csrc, ignore_errors=True)
        csrc.mkdir(parents=True)
        for fname, text in variant_source(name, edits).items():
            (csrc / fname).write_text(text)
    kernels.CSRC, kernels._lib = csrc, None
    kernels.library()


def site_times(name: str, args: dict, sites: list) -> dict:
    """{shape: (up device ms, down device ms)} a launch."""
    out = {}
    for shape, _ in sites:
        run = functools.partial(tools.KERNEL_FNS[name][0], *args[shape])
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(30):
                run()
            torch.cuda.synchronize()
        per = defaultdict(float)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and "geglu" in e.key:
                per["up" if "up_kernel" in e.key else "down"] += _device_us(e) / 30 / 1e3
        out[shape] = (per["up"], per["down"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true", help="KI3 at the int8 forward's sites (default: K3, bf16)")
    ap.add_argument("--json", help="also write the result to this file")
    args_ = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("geglu_variants: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = tools.card_line()
    print(card)
    name = "geglu_int8" if args_.int8 else "geglu"
    sites = geglu_sites(None, False, args_.int8)
    gen = torch.Generator("cuda").manual_seed(0)
    args = {shape: tools.site_args(name, shape, gen) for shape, _ in sites}
    variants = VARIANTS[name]
    order = list(variants) + ["as built"]
    result = {"card": card, "kernel": name, "rows": []}
    try:
        for turn, variant in enumerate(order):
            use_variant(variant, variants[variant])
            if variant == "as built":  # the kernels as built, held to their plain versions
                for shape, _ in sites:
                    got, ref = (fn(*args[shape]) for fn in tools.KERNEL_FNS[name])
                    ok = tools.bf16_ulps(got, ref) <= 1 if args_.int8 else tools.rel_l2(got, ref) <= 1e-2
                    if not ok:
                        raise SystemExit(f"geglu_variants: {name} {shape} differs from its plain version")
            times = site_times(name, args, sites)
            up = sum(n * times[s][0] for s, n in sites)
            down = sum(n * times[s][1] for s, n in sites)
            row = {"variant": variant, "turn": turn, "up_ms_per_forward": up, "down_ms_per_forward": down,
                   "sites": {str(list(s)): {"up_ms": times[s][0], "down_ms": times[s][1], "launches": n}
                             for s, n in sites}}
            result["rows"].append(row)
            print(json.dumps({k: row[k] for k in ("variant", "turn", "up_ms_per_forward", "down_ms_per_forward")}))
    finally:
        kernels.CSRC, kernels._lib = _CSRC, None
    if args_.json:
        with open(args_.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
