"""P3 and the head-packing cells of ``scripts/tpu_r5_headpack.py`` on the card.

    python -m leftrefill_torch.tools.probes.r5_headpack [--json PATH]

The six matrix-product cells (``qk64`` .. ``pvbd``) as ``torch.matmul`` in
bf16 (XLA dots in the script, outside any kernel: a library product is the
counterpart), with the script's pack verdicts (packing two D = 64 heads
block-diagonally wins only if the packed product takes under 1.85 times the
single one); then the flash forward with its lse at BH 10, N 8192 and
256-row blocks, as built and with the exp made the identity (p = min(s,
75): wrong math on purpose, the exp's share of the time).
"""

from __future__ import annotations

import torch

from leftrefill_torch import tools
from leftrefill_torch.ops import probes
from leftrefill_torch.tools.probes import emit, finish, randn, start, timed

M, N, D = 8192, 8192, 64
CELLS = (  # name, a shape, b shape, useful flops
    ("qk64", (M, D), (D, N), 2 * M * D * N),
    ("qk128", (M, 2 * D), (2 * D, N), 2 * M * 2 * D * N),
    ("qkbd", (M, 2 * D), (2 * D, 2 * N), 2 * (2 * M * D * N)),
    ("pv64", (M, N), (N, D), 2 * M * N * D),
    ("pv128", (M, N), (N, 2 * D), 2 * M * N * 2 * D),
    ("pvbd", (M, 2 * N), (2 * N, 2 * D), 2 * (2 * M * N * D)),
)


def main() -> int:
    args, card, gen = start(__doc__)
    rows, ms = [], {}
    for name, sa, sb, flops in CELLS:
        a, b = randn(gen, *sa), randn(gen, *sb)
        ms[name] = timed(lambda: torch.matmul(a, b))
        emit(rows, cell=name, a=list(sa), b=list(sb), ms=ms[name], tflops_useful=flops / ms[name] / 1e9)
        del a, b
    for side in ("qk", "pv"):
        packed, single = ms[f"{side}bd"], ms[f"{side}64"]
        emit(rows, cell=f"pack verdict {side.upper()}", blockdiag_ms=packed, two_single_ms=2 * single,
             verdict="WIN" if packed < 1.85 * single else "NO WIN")
    bh = 10
    q, k, v = (randn(gen, bh, N, D) for _ in range(3))
    for exp, name in (("f32", "full "), ("identity", "noexp")):
        t = timed(lambda: probes.flash_variant(q, k, v, D**-0.5, exp=exp, lse=True, rows=256))
        emit(rows, cell=f"flash fwd {name.strip()} (P3)", shape=[bh, N, D], rows_per_block=256, ms=t,
             tflops=4 * bh * N * N * D / t / 1e9,
             bound_ms=tools.bound_ms("flash_variant", (1, bh, N, N, D, exp, True, True, 256))[0])
    return finish(args, card, "scripts/tpu_r5_headpack.py", rows)


if __name__ == "__main__":
    raise SystemExit(main())
