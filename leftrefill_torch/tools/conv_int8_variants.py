"""Where KI1's time goes, on one CUDA GPU: the device ms of the int8 3x3 conv
kernel (``csrc/conv3x3_int8.cu``) at every KI1 site of one full-width int8
forward, for the kernel as built and for timing-only variants.

    python -m leftrefill_torch.tools.conv_int8_variants [--json PATH]

A variant is an edited copy of ``csrc/`` (``VARIANTS``: text replacements,
built and loaded in the port's place by ``geglu_variants.use_variant``),
timed at the sites it applies to.  The variants run in turns (as built
first and last, after two seconds of warm-up), each site in device ms
(``library_baselines.device_ms``); each variant's output is compared with the plain version and
its largest bf16 distance reported (a variant that leaves work out is wrong
by design; the kernel as built must be bit-equal).

- "K6 probe (slab)": ``scripts/tpu_conv_single_probe.py:41`` ``kernel_single``
  (one padded input slab per channel block, the 9 taps taken from it in
  on-chip memory) on the card: per 128-channel slice, one TMA box of the
  patch with its 1-pixel halo ((rows + 2) x (cols + 2) pixels) lands in a
  double-buffered slab, and each tap's A operand is a wgmma descriptor into
  it at the tap's shifted pixel (a 64-pixel run of one patch row: the
  64x128 and 32x64 levels, where a consumer's 64 pixels lie in one row;
  the descriptor's base-offset field stays 0, as the 128-byte swizzle is
  taken from the address).  The weight tiles stream through the ring alone
  (6 stages of them, beside the two slabs).
  A's bytes from L2 drop from 9 boxes a slice to one (1.1-1.3x the patch).
- "tail skip": the k32 steps past a slice's channel tail (Ci = 320, 960:
  half of the last slice) are not issued; ptxas then serializes the
  wgmma instructions (a product in a divergent path).
- "splits <= 8", "splits <= 2", "no split": the cluster split of K (the
  16x32 and 8x16 levels) allowed up to 8 blocks, or capped.
- "6 stages", "5 stages", "3 stages": the ring that deep, not 4.
- "no products", "no A loads", "no loads": wrong by design, to take a
  part's time apart: the consumers issue no wgmma; the producer loads the
  weight tiles alone; or it loads nothing and arrives on the barriers
  itself (the products run on whatever the ring holds).
"""

from __future__ import annotations

import argparse
import functools
import json

import torch
from leftrefill_torch import kernels, tools
from leftrefill_torch.ops import quant
from leftrefill_torch.tools.geglu_variants import _CSRC, use_variant, variant_source
from leftrefill_torch.tools.library_baselines import device_ms, int8_sites, warm_up

_F = "conv3x3_int8.cu"

# ---- the slab variant (the K6 probe) -----------------------------------------
# the ring holds the weight tiles alone; two slabs of the halo'd patch follow it
_SLAB_STRUCT = (
    "  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;\n",
    "  static constexpr int STAGE_BYTES = B_BYTES;\n"
    "  static constexpr int SLAB = 50176;  // (rows + 2) x (cols + 2) x 128 bytes at most, 1024-aligned\n",
)
_SLAB_SMEM = (
    "  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;\n",
    "  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * SLAB + 2 * STAGES * 8 + 4 * 8;\n",
)
_SLAB_BARRIERS = (
    "  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);\n"
    "  uint64_t* empty = full + STAGES;\n",
    "  unsigned char* slab = ring + STAGES * C::STAGE_BYTES;  // two [rows + 2][cols + 2][128] halo'd patches\n"
    "  uint64_t* full = reinterpret_cast<uint64_t*>(slab + 2 * C::SLAB);\n"
    "  uint64_t* empty = full + STAGES;\n"
    "  uint64_t* slab_full = empty + STAGES;\n"
    "  uint64_t* slab_empty = slab_full + 2;\n",
)
_SLAB_INIT = (
    "      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp\n    }\n",
    "      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp\n    }\n"
    "    for (int s = 0; s < 2; ++s) {\n"
    "      mbar_init(&slab_full[s], 1);\n"
    "      mbar_init(&slab_empty[s], CONSUMERS / 32);\n"
    "    }\n",
)
# steps slice-major (slice ks / 9, tap ks % 9): the slab of a slice, then its 9 weight tiles
_SLAB_PRODUCER = (
    """        const int ks = s_begin + i, s = i % STAGES, tap = ks / nci, c0 = (ks - tap * nci) * 128;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(st, &xmap, &full[s], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
        tma_load_3d(st + A_BYTES, &wmap, &full[s], c0, tap, n0);
""",
    """        const int ks = s_begin + i, s = i % STAGES, sl = ks / 9, tap = ks % 9, c0 = sl * 128;
        if (tap == 0) {
          mbar_wait(&slab_empty[sl % 2], ((sl / 2) & 1) ^ 1);
          mbar_expect_tx(&slab_full[sl % 2], (rows + 2) * (cols + 2) * 128);
          tma_load_4d(slab + (sl % 2) * C::SLAB, &xmap, &slab_full[sl % 2], c0, x0 - 1, y0 - 1, b);
        }
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_3d(st, &wmap, &full[s], c0, tap, n0);
""",
)
_SLAB_CONSUMER = (
    """      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = ring + s * C::STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaS8<BN>::ss(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                        desc_sw128(st + A_BYTES + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with their stage
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
""",
    """      const int ks = s_begin + i, sl = ks / 9, tap = ks % 9;
      if (tap == 0) mbar_wait(&slab_full[sl % 2], (sl / 2) & 1);
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = ring + s * C::STAGE_BYTES;
      // this warpgroup's 64 pixels: one run of patch row r, columns c .. c + 63, shifted by the tap
      const int r = wg * 64 / cols + tap / 3, c = wg * 64 % cols + tap % 3;
      const unsigned char* a = slab + (sl % 2) * C::SLAB + (r * (cols + 2) + c) * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaS8<BN>::ss(acc, desc_sw128(a + kk * 32, 16, 1024), desc_sw128(st + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with their stage
      if (i > 0 && lane == 0) {
        mbar_arrive(&empty[(i - 1) % STAGES]);
        if ((ks - 1) % 9 == 8) mbar_arrive(&slab_empty[((ks - 1) / 9) % 2]);
      }
""",
)
_SLAB_BOX = (
    "  const uint32_t box[4] = {128, static_cast<uint32_t>(p.cols), static_cast<uint32_t>(p.rows), 1};\n",
    "  const uint32_t box[4] = {128, static_cast<uint32_t>(p.cols + 2), static_cast<uint32_t>(p.rows + 2), 1};\n",
)
_SPLITS = "constexpr int MAX_SPLITS = 4;"
_STAGES = "constexpr int STAGES = 4;"
# the ring holds weight tiles alone there: 6 stages, so the int32 tile staged in it at the end fits
_SLAB = [(_F, old, new) for old, new in ((_STAGES, "constexpr int STAGES = 6;"), _SLAB_STRUCT, _SLAB_SMEM,
                                          _SLAB_BARRIERS, _SLAB_INIT, _SLAB_PRODUCER, _SLAB_CONSUMER, _SLAB_BOX)]


def _slab_sites(shape: tuple) -> bool:
    """The slab variant's levels: 64 pixels of a consumer in one patch row,
    K not split, the halo'd patch within a slab."""
    b, h, w, ci, co = shape
    plan = quant.conv3x3_int8_plan(b, h, w, ci, co, 132)
    rows, cols = plan["patch"]
    return cols >= 64 and plan["splits"] == 1 and (rows + 2) * (cols + 2) * 128 <= 50176


def _split_sites(shape: tuple) -> bool:
    b, h, w, ci, co = shape
    return quant.conv3x3_int8_plan(b, h, w, ci, co, 132)["splits"] > 1


_PRODUCTS = """        WgmmaS8<BN>::ss(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                        desc_sw128(st + A_BYTES + kk * 32, 16, 1024), 1);
"""
_A_LOAD = "        tma_load_4d(st, &xmap, &full[s], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);\n"
_EXPECT = "        mbar_expect_tx(&full[s], C::STAGE_BYTES);\n"
_B_LOAD = "        tma_load_3d(st + A_BYTES, &wmap, &full[s], c0, tap, n0);\n"

# variant -> (edits, the sites it applies to)
VARIANTS = {
    "as built": ([], lambda shape: True),
    "K6 probe (slab)": (_SLAB, _slab_sites),
    "tail skip": ([(_F, _PRODUCTS, "        if (kk < min(4, (ci - (s_begin + i) % nci * 128 + 31) / 32))\n" + _PRODUCTS)],
                  lambda shape: shape[3] % 128 != 0),
    "splits <= 8": ([(_F, _SPLITS, "constexpr int MAX_SPLITS = 8;")], _split_sites),
    "splits <= 2": ([(_F, _SPLITS, "constexpr int MAX_SPLITS = 2;")], _split_sites),
    "no split": ([(_F, _SPLITS, "constexpr int MAX_SPLITS = 1;")], _split_sites),
    "6 stages": ([(_F, _STAGES, "constexpr int STAGES = 6;")], lambda shape: True),
    "5 stages": ([(_F, _STAGES, "constexpr int STAGES = 5;")], lambda shape: True),
    "3 stages": ([(_F, _STAGES, "constexpr int STAGES = 3;")], lambda shape: True),
    "no products": ([(_F, _PRODUCTS, "          (void)st;\n")], lambda shape: True),
    "no A loads": ([(_F, _EXPECT + _A_LOAD, "        mbar_expect_tx(&full[s], C::B_BYTES);\n")], lambda shape: True),
    "no loads": ([(_F, _EXPECT + _A_LOAD + _B_LOAD, "        mbar_arrive(&full[s]);\n")], lambda shape: True),
}


def site_ms(args: tuple) -> float:
    """KI1's device ms a launch on ``args`` (``library_baselines.device_ms``)."""
    return device_ms(functools.partial(tools.KERNEL_FNS["conv3x3_int8"][0], *args))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result to this file")
    ap.add_argument("--variants", nargs="*", help="only these variants (and the kernel as built)")
    opts = ap.parse_args()
    for name, (edits, _) in VARIANTS.items():  # a stale edit is refused before anything runs
        variant_source(name, edits)
    if not torch.cuda.is_available():
        raise SystemExit("conv_int8_variants: CUDA is not available")
    card = tools.card_line()
    print(card)
    sites = [(shape, n) for (name, shape), n in int8_sites(True) if name == "conv3x3_int8"]
    gen = torch.Generator("cuda").manual_seed(0)
    args = {shape: tools.site_args("conv3x3_int8", shape, gen) for shape, _ in sites}
    ref = {shape: tools.KERNEL_FNS["conv3x3_int8"][1](*args[shape]) for shape, _ in sites}
    names = [v for v in VARIANTS if v != "as built" and (not opts.variants or v in opts.variants)]
    result = {"card": card, "rows": []}
    try:
        for turn, variant in enumerate(["as built", *names, "as built"]):
            edits, applies = VARIANTS[variant]
            use_variant(variant, edits)
            if turn == 0:
                warm_up(lambda: [tools.KERNEL_FNS["conv3x3_int8"][0](*a) for a in args.values()])
            row = {"variant": variant, "turn": turn, "sites": {}}
            for shape, n in sites:
                if not applies(shape):
                    continue
                got = tools.KERNEL_FNS["conv3x3_int8"][0](*args[shape])
                ulps = tools.bf16_ulps(got, ref[shape])
                if variant == "as built" and ulps:
                    raise SystemExit(f"conv_int8_variants: KI1 {shape} is {ulps} ulps from its plain version")
                row["sites"][str(list(shape))] = {"ms": site_ms(args[shape]), "launches": n, "ulps": ulps}
            row["ms_per_forward_at_its_sites"] = sum(s["ms"] * s["launches"] for s in row["sites"].values())
            result["rows"].append(row)
            print(json.dumps(row))
    finally:
        kernels.CSRC = _CSRC
        kernels.LIBRARY.reset()
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
