"""K3: fused GEGLU feed-forward and its dispatcher; KI3: its W8A8 twin.

Source note.  Replaces ``leftrefill_tpu/ops/mlp.py:_geglu_kernel``
(``_geglu_pallas`` / ``geglu_fused``).  The kernel (``csrc/geglu.cu``)
takes the weights in torch's Linear layout (W1 [2I, din] with the value
rows first, W2 [dout, I]: no per-call transposes) and computes
v = x.W1[c]^T + b1, g = x.W1[I+c]^T + b1, h = bf16(v * gelu(g)) in fp32
(exact erf through CUDA's ``erff``; the TPU kernel used the
Abramowitz-Stegun 7.1.26 polynomial), and out = bf16(h.W2^T + b2), one fp32
sum over the whole inner dimension.  It is two wgmma + TMA launches
(``csrc/geglu.cuh``): an up kernel whose blocks own 128 rows x 128 inner
columns and write h [R, I] in bf16 to device memory (a 128-row fp32
accumulator of the TPU kernel's kind, 640 KB at dout 1280, fits no SM), and
a down kernel whose blocks own 128 rows x 160, 128 or 64 output columns
(:func:`geglu_plan`) and read h back: 2 R I bytes each way, mostly from L2.
At these widths the products bound it.  The gradient differentiates
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
(``csrc/geglu_int8.cu``) is the same two launches on int8 wgmma.  The up
kernel runs persistent thread clusters of chunk / 128 blocks (5 or 2 at full
width, 10 at a 1280-wide chunk), each walking (128 rows, chunk) items and
exchanging its rows' max |h| through distributed shared memory, so h in
fp32 never leaves the SM and only hq (int8, [R, I]) and sh ([R, I / chunk])
cross device memory; the down kernel adds the chunks' contributions in
chunk order in registers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leftrefill_torch import kernels
from leftrefill_torch.ops.quant import int_mm, over_127

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# the kernels' frame (csrc/geglu.cuh): 128-row blocks, up blocks 128 inner
# columns wide, a 4-stage ring of tiles 128 bytes wide
BM, BI, STAGES, TILE = 128, 128, 4, 128 * 128
UP_SMEM = 1024 + STAGES * 3 * TILE + 16 * STAGES
MAX_CLUSTER = 16  # blocks of a thread cluster on an H100 (8 portable)
# the int8 up block also stages its hq tile and two items' row maxima of its cluster
UP8_SMEM = UP_SMEM + TILE + 2 * 4 * BM * MAX_CLUSTER


def down_smem(bn: int) -> int:
    return 1024 + STAGES * (TILE + bn * 128) + 16 * STAGES


def down_tile(r: int, dout: int, sms: int) -> int:
    """The down kernel's output columns per block (``geglu.cuh:down_tile``):
    among 160 and 128 (each where it divides dout) and 64, the one whose
    waves over the SMs times its width is least, the widest on a tie."""
    best = None
    for bn in (160, 128, 64):
        if dout % bn and bn != 64:
            continue
        blocks = -(-r // BM) * -(-dout // bn)
        cost = -(-blocks // sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn)
    return best[1]


def geglu_plan(r: int, din: int, inner: int, dout: int, sms: int, chunk: int | None = None) -> dict:
    """The launch plan of K3 (or, with ``chunk``, KI3) at this shape, as the
    ``.cu`` launchers compute it: each kernel's block tile (rows, columns),
    its items (tiles), grid (x, y), thread cluster along x and dynamic shared
    memory.  KI3's up kernel is persistent: its grid is as many clusters as
    the card holds at once (asked of CUDA at launch), at most one an
    item, so it has no fixed grid here."""
    bn = down_tile(r, dout, sms)
    rows = -(-r // BM)
    return {
        "up": {"tile": (BM, BI), "items": rows * inner // BI, "grid": (inner // BI, rows) if chunk is None else None,
               "cluster": 1 if chunk is None else chunk // BI, "smem": UP_SMEM if chunk is None else UP8_SMEM},
        "down": {"tile": (BM, bn), "items": rows * -(-dout // bn), "grid": (-(-dout // bn), rows), "cluster": 1,
                 "smem": down_smem(bn)},
    }


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
    a CUDA tensor launches K3 (its up and down kernels) or raises."""
    if not x.is_cuda:
        return geglu_plain(x, w1, b1, w2, b2)
    r, din = x.shape
    dout, inner = w2.shape
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(w1, "w1", torch.bfloat16, (2 * inner, din))
    kernels.require(b1, "b1", torch.float32, (2 * inner,))
    kernels.require(w2, "w2", torch.bfloat16, (dout, inner))
    kernels.require(b2, "b2", torch.float32, (dout,))
    if not _kernel_takes(r, din, inner, dout):
        raise ValueError(f"GEGLU kernel does not take R={r} din={din} inner={inner} dout={dout}")
    h = torch.empty((r, inner), dtype=x.dtype, device=x.device)
    out = torch.empty((r, dout), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        code = lib.lr_geglu(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                            h.data_ptr(), out.data_ptr(), r, din, inner, dout, kernels.stream_of(x))
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


def _kernel_takes(r: int, din: int, inner: int, dout: int) -> bool:
    """K3's own constraints: whole 128-row blocks and 128-wide inner tiles,
    din in 64-wide K steps, dout in 64-wide column tiles."""
    return r > 0 and r % BM == 0 and din % 64 == 0 and inner % BI == 0 and dout % 64 == 0


def geglu_fused_qualifies(x: torch.Tensor, din: int, inner: int, dout: int) -> bool:
    """The JAX dispatcher's rule for bf16 (R >= 128, din and dout >= 64, a
    VMEM plan of the TPU kernel) on a CUDA tensor, plus the kernel's own
    constraints (:func:`_kernel_takes`)."""
    r = x.numel() // x.shape[-1]
    return (
        kernels.uses_kernel(x)
        and x.dtype == torch.bfloat16
        and r >= 128
        and din >= 64
        and dout >= 64
        and _vmem_plan(r, din, inner, dout, 2) is not None
        and _kernel_takes(r, din, inner, dout)
    )


# ---------------------------------------------------------------------------
# KI3: the W8A8 GEGLU


def _vmem_plan(r: int, din: int, inner: int, dout: int, elt: int):
    """(blk_r, chunk) of the TPU kernel's VMEM plan for operands of ``elt``
    bytes, or None (a copy of ``leftrefill_tpu/ops/mlp.py:_plan``: the
    largest (blk_r, chunk) that fits, the first in this descending order)."""
    for blk_r in (512, 256, 128):
        if r % blk_r:
            continue
        for ci in (1280, 1024, 640, 512, 256, 128):
            if inner % ci:
                continue
            # x, W1, W2 and the bf16 out double-buffered; the fp32 acc and three fp32 intermediates
            vmem = (2 * elt * (blk_r * din + 2 * din * ci + ci * dout) + 8 * blk_r * dout
                    + 12 * blk_r * ci)
            if vmem <= int(11.0 * 1024 * 1024):
                return blk_r, ci
    return None


def geglu_int8_plan(r: int, din: int, inner: int, dout: int):
    """(blk_r, chunk) of K10's VMEM plan (int8 operands), or None."""
    return _vmem_plan(r, din, inner, dout, 1)


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
    the plain version; a CUDA tensor launches KI3 (its up and down kernels)
    or raises."""
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
    if din % 16 or chunk % 128 or chunk > MAX_CLUSTER * BI or inner % chunk or dout % 8:
        raise ValueError(f"int8 GEGLU kernel does not take R={r} din={din} inner={inner} dout={dout} chunk={chunk}")
    hq = torch.empty((r, inner), dtype=torch.int8, device=xq.device)
    sh = torch.empty((r, inner // chunk), dtype=f32, device=xq.device)
    out = torch.empty((r, dout), dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        code = kernels.library().lr_geglu_int8(
            xq.data_ptr(), sx.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), hq.data_ptr(), sh.data_ptr(), out.data_ptr(),
            r, din, inner, dout, chunk, kernels.stream_of(xq),
        )
    kernels.check(code, "geglu_int8")
    geglu_int8_fused.launches += 1
    return out


geglu_int8_fused.launches = 0
