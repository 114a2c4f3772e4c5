"""P4, K1 as built against the simplified probe kernel of
``scripts/tpu_r5_attn_ab.py``, on the card.

    python -m leftrefill_torch.tools.probes.r5_attn_ab [--json PATH]

At BH 10 (batch 1, 10 heads; N 8192, D 64) and again at BH 20 (the CFG
batch 2): K1 as built (``flash_attention.flash_forward`` on the packed
[B, N, H*D] layout), the probe (256 query rows a block, with its lse), the
probe at 128 rows and the probe without its lse; first the largest
difference between K1's and the probe's outputs on the same values.
"""

from __future__ import annotations

from leftrefill_torch import tools
from leftrefill_torch.ops import flash_attention, probes
from leftrefill_torch.tools.probes import emit, finish, randn, start, timed

N, D = 8192, 64


def packed(x):
    """[B, H, N, D] -> [B, N, H*D]: K1's layout."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d).contiguous()


def main() -> int:
    args, card, gen = start(__doc__)
    rows = []
    q, k, v = (randn(gen, 1, 10, N, D) for _ in range(3))
    for b in (1, 2):
        q4, k4, v4 = (x.repeat(b, 1, 1, 1) for x in (q, k, v))  # batch 2: the batch-1 values twice, as the script
        qp, kp, vp = (packed(x) for x in (q4, k4, v4))
        h, scale, bh = 10, D**-0.5, 10 * b
        q3, k3, v3 = (x.reshape(bh, N, D) for x in (q4, k4, v4))
        if b == 1:
            o_ship = flash_attention.flash_forward(qp, kp, vp, h, scale)[0]
            o_probe = probes.flash_variant(q3, k3, v3, scale, rows=256)[0]
            diff = (o_ship.reshape(1, N, h, D).transpose(1, 2).reshape(bh, N, D).float() - o_probe.float()).abs()
            emit(rows, cell="maxdiff shipped-vs-probe", shape=[bh, N, D], max_abs=float(diff.max()))
        flops = 4 * bh * N * N * D
        cells = (("shipped (K1)", lambda: flash_attention.flash_forward(qp, kp, vp, h, scale), True, 128),
                 ("probe", lambda: probes.flash_variant(q3, k3, v3, scale, rows=256), True, 256),
                 ("probe-blk128", lambda: probes.flash_variant(q3, k3, v3, scale, rows=128), True, 128),
                 ("probe-nolse", lambda: probes.flash_variant(q3, k3, v3, scale, lse=False, rows=256), False, 256))
        for name, fn, lse, blk in cells:
            ms = timed(fn)
            emit(rows, cell=f"{name} b{b}", shape=[bh, N, D], rows_per_block=blk, lse=lse, ms=ms,
                 tflops=flops / ms / 1e9,
                 bound_ms=tools.bound_ms("flash_variant", (b, h, N, N, D, "f32", True, lse, blk))[0])
    return finish(args, card, "scripts/tpu_r5_attn_ab.py", rows)


if __name__ == "__main__":
    raise SystemExit(main())
