"""K3: fused GEGLU feed-forward and its dispatcher; KI3: its W8A8 twin.

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
W1/W2 re-read from L2 per 32-row block).  The gradient differentiates
:func:`geglu_vjp_math` recomputed from the saved inputs (``_GEGLU``), as
JAX's custom VJP differentiates ``_geglu_xla_math``: bf16 products.

KI3 replaces ``leftrefill_tpu/ops/mlp.py:_geglu_int8_kernel`` (K10,
``geglu_fused_int8`` with its default int8 second product; the
``LEFTREFILL_GEGLU_INT8_W2=bf16`` arm is not ported).  Per inner chunk c:
v and g from int8 products dequantized per row and column plus b1,
h = v * gelu_erf(g), h requantized per row over the chunk
(sh = max|h| / 127), an int8 product with W2 dequantized by sh * s2 into an
fp32 sum, b2 at the end.  The chunk width is part of the function (the
requant scale spans one chunk), so it is the TPU plan's
(:func:`geglu_int8_chunk`, a copy of ``_plan``).  The kernel
(``csrc/geglu_int8.cu``) runs one block per (32 rows, chunk), keeps h in
shared memory, and adds the chunks' fp32 contributions in chunk order in a
second kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leftrefill_torch import kernels
from leftrefill_torch.ops.quant import int_mm, over_127

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


def geglu_vjp_math(x, w1, b1, w2, b2) -> torch.Tensor:
    """The function the GEGLU's gradient differentiates, JAX's
    ``_geglu_xla_math``: bf16 products with fp32 accumulation (fp32 ones for
    an fp32 x) and bf16 biases, v * gelu_erf(g) in fp32, h rounded to bf16
    before the second product.  Arguments as :func:`geglu_plain`."""
    cd = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    val, gate = F.linear(x.to(cd), w1.to(cd), b1.to(cd)).chunk(2, dim=-1)
    h = val.float() * F.gelu(gate.float())
    return F.linear(h.to(cd), w2.to(cd), b2.to(cd)).to(x.dtype)


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


class _GEGLU(torch.autograd.Function):
    """K3 forward (:func:`geglu_fused`, the plain version on a CPU tensor);
    the backward recomputes :func:`geglu_vjp_math` from the saved inputs and
    differentiates it, as JAX's custom VJP differentiates
    ``_geglu_xla_math``: the TPU package has no backward kernel for it.
    Only the inputs that need a gradient get one."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return geglu_fused(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
        with torch.enable_grad():
            out = geglu_vjp_math(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)))
        return tuple(next(grads) if need else None for need in ctx.needs_input_grad)


def geglu_apply(x, w1, b1, w2, b2) -> torch.Tensor:
    """The GEGLU dispatcher's call for a qualifying site: K3, differentiable
    on every device, or its plain version where ``kernels.plain_kernels``
    routes it."""
    fn = geglu_plain if kernels.plain_kernels_active("geglu") else _GEGLU.apply
    return fn(x, w1, b1, w2, b2)


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


# ---------------------------------------------------------------------------
# KI3: the W8A8 GEGLU


def geglu_int8_plan(r: int, din: int, inner: int, dout: int):
    """(blk_r, chunk) of K10's VMEM plan, or None (a copy of
    ``leftrefill_tpu/ops/mlp.py:_plan`` with its int8 element sizes; the
    largest (blk_r, chunk) that fits, the first in this descending order)."""
    for blk_r in (512, 256, 128):
        if r % blk_r:
            continue
        for ci in (1280, 1024, 640, 512, 256, 128):
            if inner % ci:
                continue
            # x, W1, W2 and the bf16 out double-buffered; the fp32 acc and three fp32 intermediates
            vmem = 2 * blk_r * din + 4 * din * ci + 2 * ci * dout + 8 * blk_r * dout + 12 * blk_r * ci
            if vmem <= int(11.0 * 1024 * 1024):
                return blk_r, ci
    return None


def geglu_int8_qualifies(r: int, din: int, inner: int, dout: int) -> bool:
    """JAX's ``geglu_fused_qualifies(..., int8=True)`` without the TPU probe."""
    return r >= 128 and din >= 64 and dout >= 64 and geglu_int8_plan(r, din, inner, dout) is not None


def geglu_int8_chunk(r: int, din: int, inner: int, dout: int) -> int:
    """The requant chunk width: the int8 TPU plan's."""
    return geglu_int8_plan(r, din, inner, dout)[1]


def geglu_int8_plain(xq, sx, w1, s1, b1, w2, s2, b2, chunk: int) -> torch.Tensor:
    """The kernel's plain version, the same fp32 operations in the same
    order (on the card the two agree bit for bit).  xq [R, din] int8, sx [R, 1] fp32,
    w1 [2I, din] int8 rows [value | gate], s1/b1 [2I] fp32, w2 [dout, I]
    int8, s2/b2 [dout] fp32 -> [R, dout] bf16."""
    f32 = torch.float32
    inner = w2.shape[1]
    acc = torch.zeros((xq.shape[0], w2.shape[0]), dtype=f32, device=xq.device)
    for c0 in range(0, inner, chunk):
        cv, cg = slice(c0, c0 + chunk), slice(inner + c0, inner + c0 + chunk)
        v = int_mm(xq, w1[cv]).to(f32) * (sx * s1[cv]) + b1[cv]
        g = int_mm(xq, w1[cg]).to(f32) * (sx * s1[cg]) + b1[cg]
        h = v * (g * 0.5 * (1.0 + torch.erf(g * 0.7071067811865476)))  # the kernel's gelu, op for op
        sh = over_127(h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
        hq = torch.round(h / sh).clamp(-127, 127).to(torch.int8)
        acc = acc + int_mm(hq, w2[:, c0:c0 + chunk].contiguous()).to(f32) * (sh * s2)
    return (acc + b2).to(torch.bfloat16)


def geglu_int8_fused(xq, sx, w1, s1, b1, w2, s2, b2, chunk: int) -> torch.Tensor:
    """KI3 on the arguments of :func:`geglu_int8_plain`.  A CPU tensor runs
    the plain version; a CUDA tensor launches KI3 or raises."""
    if not xq.is_cuda:
        return geglu_int8_plain(xq, sx, w1, s1, b1, w2, s2, b2, chunk)
    r, din = xq.shape
    dout, inner = w2.shape
    f32 = torch.float32
    kernels.require(xq, "xq", torch.int8)
    kernels.require(sx, "sx", f32, (r, 1))
    kernels.require(w1, "w1", torch.int8, (2 * inner, din))
    kernels.require(s1, "s1", f32, (2 * inner,))
    kernels.require(b1, "b1", f32, (2 * inner,))
    kernels.require(w2, "w2", torch.int8, (dout, inner))
    kernels.require(s2, "s2", f32, (dout,))
    kernels.require(b2, "b2", f32, (dout,))
    if r % 32 or din % 64 or chunk % 128 or inner % chunk or dout % 2:
        raise ValueError(f"int8 GEGLU kernel does not take R={r} din={din} inner={inner} dout={dout} chunk={chunk}")
    out = torch.empty((r, dout), dtype=torch.bfloat16, device=xq.device)
    partial = torch.empty((inner // chunk, r, dout), dtype=f32, device=xq.device)
    with torch.cuda.device(xq.device):
        code = kernels.library().lr_geglu_int8(
            xq.data_ptr(), sx.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(), partial.data_ptr(),
            r, din, inner, dout, chunk, kernels.stream_of(xq),
        )
    kernels.check(code, "geglu_int8")
    geglu_int8_fused.launches += 1
    return out


geglu_int8_fused.launches = 0
