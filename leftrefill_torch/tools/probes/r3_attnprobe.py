"""P1 and the ds-1 attention cells of ``scripts/tpu_r3_attnprobe.py`` on the card.

    python -m leftrefill_torch.tools.probes.r3_attnprobe [--json PATH]

Cells: the no-op floor (P5); K1 on the packed [B, N, H*D] layout at the ds-1
shape (B 2, H 5, N 8192, D 64), ``ops.attention.multi_head_attention`` end
to end on the same input, and a head-transpose round trip of it; P1's
parity at (1, 2, 512, 64) against the exact softmax, as the script reports
it; then at 8192, 2048 and 512 tokens (B 2; H 5, 10, 20) K1 (the
as-built variant on the scripts' [B, H, N, D] layout) beside P1 with and
without ``pv_int8``: the kernel's device ms, and the wrapper's with its
quantization in PyTorch.
"""

from __future__ import annotations

from leftrefill_torch import tools
from leftrefill_torch.ops import attention, flash_attention, probes
from leftrefill_torch.tools.probes import emit, exact_attention, finish, randn, script_error, start, timed

SHAPES = ((8192, 5), (2048, 10), (512, 20))  # tokens, heads at batch 2


def main() -> int:
    args, card, gen = start(__doc__)
    rows = []
    x = randn(gen, 8, 128)
    emit(rows, cell="floor (P5 no-op)", ms=timed(lambda: probes.noop(x), calls=200))

    b, h, n, d = 2, 5, 8192, 64
    qp, kp, vp = (randn(gen, b, n, h * d) for _ in range(3))
    flops = 4 * b * h * n * n * d
    ms = timed(lambda: flash_attention.flash_forward(qp, kp, vp, h, d**-0.5))
    emit(rows, cell="flash direct [B,N,H*D] (K1)", shape=[b, h, n, d], ms=ms, tflops=flops / ms / 1e9,
         bound_ms=tools.bound_ms("flash_fwd", (b, h, n, n, d))[0])
    emit(rows, cell="mha end-to-end [B,N,C]", shape=[b, h, n, d],
         ms=timed(lambda: attention.multi_head_attention(qp, qp, qp, h)))
    # [B, N, H*D] -> [B, H, N, D] -> back, each transpose materialized (two copies, as XLA's)
    emit(rows, cell="transpose round-trip x1", shape=[b, n, h * d],
         ms=timed(lambda: qp.reshape(b, n, h, d).transpose(1, 2).contiguous().transpose(1, 2).reshape(b, n, h * d)))

    # parity at the script's small shape (its fp32 draws, rounded to the kernel's bf16)
    qs, ks, vs = (randn(gen, 1, 2, 512, d) for _ in range(3))
    ref = exact_attention(qs, ks, vs, d**-0.5)
    for pv in (False, True):
        err, rel = script_error(probes.flash_int8(qs, ks, vs, d**-0.5, pv), ref)
        emit(rows, cell=f"int8 flash parity pv_int8={pv}", shape=[1, 2, 512, d], max_err=err, rel=rel)

    for n, h in SHAPES:
        q, k, v = (randn(gen, 2, h, n, d) for _ in range(3))
        flops = 4 * 2 * h * n * n * d
        ms = timed(lambda: probes.flash_variant(q, k, v, d**-0.5))
        emit(rows, cell=f"bf16 flash N={n} (K1)", shape=[2, h, n, d], ms=ms, tflops=flops / ms / 1e9,
             bound_ms=tools.bound_ms("flash_variant", (2, h, n, n, d, "f32", True, True, 128))[0])
        for pv in (False, True):
            run = lambda: probes.flash_int8(q, k, v, d**-0.5, pv)  # noqa: E731
            kms = timed(run, kernel="flash_int8_kernel")
            emit(rows, cell=f"int8 flash N={n} pv_int8={pv} (P1)", shape=[2, h, n, d], kernel_ms=kms,
                 wrapper_ms=timed(run), tflops_equiv=flops / kms / 1e9,
                 bound_ms=tools.bound_ms("flash_int8", (2, h, n, n, d, pv))[0])
    return finish(args, card, "scripts/tpu_r3_attnprobe.py", rows)


if __name__ == "__main__":
    raise SystemExit(main())
