"""Where KI2's and K4's time goes, on one CUDA GPU: the device ms of the int8
proj_out GEMM (``csrc/dense_int8_res.cu``) and of K4, the GN affine + SiLU +
per-tensor quantize with its scale (``csrc/quant_prologue.cu``), at every
one of their sites in one full-width fused int8 forward, for the kernels as
built and for timing-only variants.

    python -m leftrefill_torch.tools.int8_epilogue_variants [--variants NAME ...] [--json PATH]

A variant is an edited copy of ``csrc/`` (``VARIANTS``: text replacements,
built and loaded in the port's place by ``geglu_variants.use_variant``),
timed at the sites of the kernel it edits.  The variants run in turns (as
built first and last, after two seconds of warm-up), each site in device ms
(``library_baselines.device_ms``); each output is compared with the plain
version (KI2: its largest bf16 distance; K4: its largest int8 step and
whether the scale is equal), and the kernels as built must be exact.
Variants marked "wrong by design" leave work out to take its time apart.

KI2:
- "4-block clusters": the K split allowed up to 4 blocks (the 256-row site
  then takes 64 x 160 tiles in 4-block clusters);
- "3 stages", "5 stages": the ring that deep, not 4;
- "main loop only" (wrong by design): every thread returns after the
  products; "no epilogue" (wrong by design): after the int32 tile is staged.
K4:
- "streamed only": no site keeps its silu values in registers (pass 2
  reads x again and recomputes them); "cache <= 2": at most 2 chunks a
  thread in registers, not 4;
- "no pass-1 filter": a streamed site computes silu for every element in
  pass 1 too;
- "pass 1 only", "through the barrier" (wrong by design): every thread
  returns after pass 1's slot write, or after the grid barrier;
  "pass 2 without silu" (wrong by design): a streamed site quantizes y.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from leftrefill_torch import kernels, tools
from leftrefill_torch.tools.geglu_variants import _CSRC, use_variant, variant_source
from leftrefill_torch.tools.library_baselines import device_ms, int8_sites, warm_up

_D, _P = "dense_int8_res.cu", "quant_prologue.cu"
_STAGED = "  cluster_barrier();  // every block's tile is staged (a plain block barrier where splits == 1)\n"
_SLOT = "  if (threadIdx.x == 0) slots[blockIdx.x] = m;\n"
_BARRIER = "  cooperative_groups::this_grid().sync();\n"
_PASS2 = "q[e] = quant_rne(__fmul_rn(silu_of(affine(v[e], av[e], bv[e])), inv));"

# variant -> (the kernel it edits, edits)
VARIANTS = {
    "as built": (None, []),
    "4-block clusters": ("dense_int8_res", [(_D, "constexpr int MAX_SPLITS = 2;", "constexpr int MAX_SPLITS = 4;")]),
    "3 stages": ("dense_int8_res", [(_D, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]),
    "5 stages": ("dense_int8_res", [(_D, "constexpr int STAGES = 4;", "constexpr int STAGES = 5;")]),
    "main loop only": ("dense_int8_res", [(_D, "  // ---- the int32 tile, staged in the ring",
                                           "  if (k > 0) return;\n  // ---- the int32 tile, staged in the ring")]),
    "no epilogue": ("dense_int8_res", [(_D, _STAGED, _STAGED + "  if (k > 0) {\n    cluster_barrier();\n    return;\n  }\n")]),
    "streamed only": ("affine_silu_quant", [(_P, "constexpr int SQ_MAX_CACHED = 4;", "constexpr int SQ_MAX_CACHED = 0;")]),
    "cache <= 2": ("affine_silu_quant", [(_P, "constexpr int SQ_MAX_CACHED = 4;", "constexpr int SQ_MAX_CACHED = 2;")]),
    "no pass-1 filter": ("affine_silu_quant", [(_P, "            if (silu_bound(y) > mw) m = fmaxf(m, fabsf(silu_of(y)));",
                                                "            m = fmaxf(m, fabsf(silu_of(y)));")]),
    "pass 1 only": ("affine_silu_quant", [(_P, _SLOT, _SLOT + "  if (c > 0) return;\n")]),
    "through the barrier": ("affine_silu_quant", [(_P, _BARRIER, _BARRIER + "  if (c > 0) return;\n")]),
    "pass 2 without silu": ("affine_silu_quant", [(_P, _PASS2, "q[e] = quant_rne(__fmul_rn(affine(v[e], av[e], bv[e]), inv));")]),
}
NAMES = ("dense_int8_res", "affine_silu_quant")


def distance(name: str, got, ref) -> list:
    """KI2: [bf16 ulps]; K4: [largest int8 step, scale equal]."""
    if name == "dense_int8_res":
        return [tools.bf16_ulps(got, ref)]
    return [int((got[0].int() - ref[0].int()).abs().max()), bool(torch.equal(got[1], ref[1]))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result to this file")
    ap.add_argument("--variants", nargs="*", help="only these variants (and the kernels as built)")
    opts = ap.parse_args()
    for name, (_, edits) in VARIANTS.items():  # a stale edit is refused before anything runs
        variant_source(name, edits)
    if not torch.cuda.is_available():
        raise SystemExit("int8_epilogue_variants: CUDA is not available")
    card = tools.card_line()
    print(card)
    sites = [(name, shape, n) for (name, shape), n in int8_sites(False) if name in NAMES]
    gen = torch.Generator("cuda").manual_seed(0)
    args = {(name, shape): tools.site_args(name, shape, gen) for name, shape, _ in sites}
    ref = {key: tools.KERNEL_FNS[key[0]][1](*a) for key, a in args.items()}
    names = [v for v in VARIANTS if v != "as built" and (not opts.variants or v in opts.variants)]
    result = {"card": card, "rows": []}
    try:
        for turn, variant in enumerate(["as built", *names, "as built"]):
            kernel, edits = VARIANTS[variant]
            use_variant(variant, edits)
            if turn == 0:
                warm_up(lambda: [tools.KERNEL_FNS[k][0](*a) for (k, _), a in args.items()])
            row = {"variant": variant, "turn": turn, "sites": {}, "ms_per_forward": {}}
            for name, shape, n in sites:
                if kernel not in (None, name):
                    continue
                run = functools.partial(tools.KERNEL_FNS[name][0], *args[(name, shape)])
                dist = distance(name, run(), ref[(name, shape)])
                if variant == "as built" and dist != ([0] if name == "dense_int8_res" else [0, True]):
                    raise SystemExit(f"int8_epilogue_variants: {name} {shape} differs from its plain version: {dist}")
                ms = device_ms(run)
                row["sites"][f"{name} {list(shape)}"] = {"ms": ms, "launches": n, "distance": dist}
                row["ms_per_forward"][name] = row["ms_per_forward"].get(name, 0.0) + n * ms
            result["rows"].append(row)
            print(json.dumps(row))
    finally:
        kernels.CSRC, kernels._lib = _CSRC, None
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
