"""K3: fused GEGLU feed-forward and its dispatcher.

Source note.  Replaces ``leftrefill_tpu/ops/mlp.py:_geglu_kernel``
(``_geglu_pallas`` / ``geglu_fused``).  The kernel (``csrc/geglu.cu``)
takes the weights in torch's Linear layout (W1 [2I, din] with the value
rows first, W2 [dout, I]: no per-call transposes) and computes, per 64-wide
inner chunk c, v = x.W1[c]^T + b1, g = x.W1[I+c]^T + b1,
h = v * gelu(g) in fp32 (exact erf through CUDA's ``erff``; the TPU kernel
used the Abramowitz-Stegun 7.1.26 polynomial), then acc += bf16(h).W2[:, c]^T
in fp32 and out = bf16(acc + b2).  Both products run in the kernel body; h
never reaches device memory.  A block owns 32 rows and keeps their
[32, dout] fp32 accumulator in shared memory (160 KB at dout = 1280); where
the rows give fewer blocks than SMs (R = 256, 1024, 4096), the inner
dimension is also split and the fp32 partials are added in a fixed order by
a second kernel.  At these widths the products bound it (compute, with
W1/W2 re-read from L2 per 32-row block).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leftrefill_torch import kernels

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _smem_bytes(dout: int) -> int:
    """Shared memory of the kernel's block (mirrors csrc/geglu.cu)."""
    return 32 * (dout + 4) * 4 + 32 * 72 * 2 + 2 * 64 * 72 * 2 + 2 * 32 * 68 * 4 + 32 * 72 * 2 + 64 * 72 * 2


def inner_splits(r: int, inner: int, sms: int) -> int:
    """How many ways the kernel splits the inner dimension: doubled while the
    doubled grid still fits in one wave over the SMs (one block per SM: the
    fp32 accumulator takes most of the shared memory), as long as every split
    stays a whole number of 64-wide chunks."""
    s = 1
    while (r // 32) * s * 2 <= sms and inner % (2 * s * 64) == 0:
        s *= 2
    return s


def geglu_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel's plain version at its precision: bf16 operands with fp32
    accumulation, fp32 biases, v * gelu_erf(g) in fp32, h rounded to bf16
    before the second product, one cast at the end.
    x [R, din], w1 [2I, din] rows packed [value | gate], b1 [2I], w2 [dout, I],
    b2 [dout] (torch Linear layout)."""
    f32 = torch.float32
    xg = torch.matmul(x.to(f32), w1.to(f32).t()) + b1.to(f32)
    val, gate = xg.chunk(2, dim=-1)
    h = (val * F.gelu(gate)).to(x.dtype)
    out = torch.matmul(h.to(f32), w2.to(f32).t()) + b2.to(f32)
    return out.to(x.dtype)


def geglu_fused(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [R, din] bf16, w1 [2I, din] bf16, b1 [2I] fp32, w2 [dout, I] bf16,
    b2 [dout] fp32 -> [R, dout] bf16.  A CPU tensor runs the plain version;
    a CUDA tensor launches K3 or raises."""
    if not x.is_cuda:
        return geglu_plain(x, w1, b1, w2, b2)
    r, din = x.shape
    dout, inner = w2.shape
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(w1, "w1", torch.bfloat16, (2 * inner, din))
    kernels.require(b1, "b1", torch.float32, (2 * inner,))
    kernels.require(w2, "w2", torch.bfloat16, (dout, inner))
    kernels.require(b2, "b2", torch.float32, (dout,))
    if r % 32 or din % 64 or inner % 64 or dout % 64 or _smem_bytes(dout) > SMEM_LIMIT:
        raise ValueError(f"GEGLU kernel does not take R={r} din={din} inner={inner} dout={dout}")
    out = torch.empty((r, dout), dtype=x.dtype, device=x.device)
    splits = inner_splits(r, inner, torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty((splits, r, dout), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = kernels.library()
    with torch.cuda.device(x.device):
        code = lib.lr_geglu(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            r, din, inner, dout, splits, kernels.stream_of(x),
        )
    kernels.check(code, "geglu")
    geglu_fused.launches += 1
    return out


geglu_fused.launches = 0


def geglu_fused_qualifies(x: torch.Tensor, din: int, inner: int, dout: int) -> bool:
    """The JAX dispatcher's rule for bf16 (R >= 128 in whole 128-row blocks,
    din and dout >= 64, inner in 128-wide chunks) on a CUDA tensor, plus the
    kernel's 64-alignment of din/dout and its shared-memory bound."""
    r = x.numel() // x.shape[-1]
    return (
        kernels.uses_kernel(x)
        and x.dtype == torch.bfloat16
        and r >= 128
        and r % 128 == 0
        and din >= 64
        and dout >= 64
        and inner % 128 == 0
        and din % 64 == 0
        and dout % 64 == 0
        and _smem_bytes(dout) <= SMEM_LIMIT
    )
