"""P2, the cheaper-softmax variants of ``scripts/tpu_r3_attnprobe2.py``, on the card.

    python -m leftrefill_torch.tools.probes.r3_attnprobe2 [--json PATH]

The script's six configurations (its lines 105-112): each one's error
against the exact softmax at (1, 2, 512, 64) (max |out - ref| over max
|ref|, the script's reading, on its normal draws rounded to the kernel's
bf16) and its device ms at the ds-1 shape (2, 5, 8192, 64).  The 512-row
block has no counterpart: eight 64-row consumer warpgroups and a producer
warp would be 1056 threads, past the block limit of 1024.
"""

from __future__ import annotations

from leftrefill_torch import tools
from leftrefill_torch.ops import probes
from leftrefill_torch.tools.probes import emit, exact_attention, finish, randn, script_error, start, timed

VARIANTS = (  # name, exp, clamp, rows
    ("fp32exp+clamp (baseline)", "f32", True, 128),
    ("fp32exp no-clamp", "f32", False, 128),
    ("bf16exp+clamp", "bf16", True, 128),
    ("bf16exp+clamp blk256", "bf16", True, 256),
    ("fp32exp+clamp blk256", "f32", True, 256),
    ("bf16exp+clamp blk512", "bf16", True, 512),
)
NO_COUNTERPART = "no Hopper block of 512 query rows: 8 consumer warpgroups + a producer warp = 1056 threads > 1024"


def main() -> int:
    args, card, gen = start(__doc__)
    rows = []
    d = 64
    small = [randn(gen, 1, 2, 512, d) for _ in range(3)]
    ref = exact_attention(*small, d**-0.5)
    b, h, n = 2, 5, 8192
    q, k, v = (randn(gen, b, h, n, d) for _ in range(3))
    flops = 4 * b * h * n * n * d
    for name, exp, clamp, blk in VARIANTS:
        if blk == 512:
            emit(rows, cell=name, shape=[b, h, n, d], status="no counterpart", reason=NO_COUNTERPART)
            continue
        kw = dict(exp=exp, clamp=clamp, lse=False, rows=blk)
        _, rel = script_error(probes.flash_variant(*small, d**-0.5, **kw), ref)
        ms = timed(lambda: probes.flash_variant(q, k, v, d**-0.5, **kw))
        emit(rows, cell=name, shape=[b, h, n, d], ms=ms, tflops=flops / ms / 1e9, rel_err=rel,
             bound_ms=tools.bound_ms("flash_variant", (b, h, n, n, d, exp, clamp, False, blk))[0])
    return finish(args, card, "scripts/tpu_r3_attnprobe2.py", rows)


if __name__ == "__main__":
    raise SystemExit(main())
