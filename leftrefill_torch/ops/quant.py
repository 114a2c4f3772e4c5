"""W8A8 int8 inference ops (counterpart of ``leftrefill_tpu/ops/quant.py``):
the quantization helpers, the int8 dense, the TPU dispatch rules of the int8
kernels, kernels KI1 (int8 3x3 conv) and KI2 (int8 proj_out GEMM plus
residual), and the fused int8 prologues of JAX's default configuration, K4
(GN affine + SiLU + quantize), K7 (LayerNorm + per-row quantize) and K8 (GN
affine + per-pixel quantize), each kernel beside its plain PyTorch version.

Scheme, as the JAX package: weights per output channel, symmetric, int8 at
rest; activations quantized at run time, per tensor for the convs and per row
for the dense sites; int32 accumulation and an fp32 dequant epilogue.

The int8 dispatch depends on the shape only, never on the device: the
qualifiers are the JAX dispatchers' shape rules (their TPU probe dropped), so
the CPU runs the same function the card does, through the plain versions.
The rules read the TPU kernels' VMEM plans, which are copied here as pure
functions (``tests/test_torch_quant_plans.py`` holds each copy to the
original).

Source notes.
- KI1 (``csrc/conv3x3_int8.cu``) replaces ``_conv_int8_kernel`` (K5, three
  column-shifted copies) and ``_conv_int8_single_kernel`` (K6, one padded
  slab): the same function, blocked two ways for VMEM.  It is an implicit
  GEMM (M = B*H*W, N = Co, K = 9*Ci) on int8 wgmma that loads each tap of a
  128-pixel patch by TMA from the NHWC input, the border and the Ci tail
  zero-filled; at the small-M levels a thread-block cluster splits K and
  adds the int32 tiles through distributed shared memory (exact), in the
  same launch.  Epilogue acc * (s_x * s_w[c]) + bias in fp32, one cast to
  bf16 (or an fp32 store, for an fp32 model).  :func:`conv3x3_int8_plan`
  mirrors the launch plan (``lr_conv3x3_int8_plan``).
- KI2 (``csrc/dense_int8_res.cu``) replaces ``_dense_int8_res_mom_kernel``
  (K9) without its [B, 4, N] moments output, which nothing reads.
- ``dense_int8`` is an XLA dot in JAX, outside any Pallas kernel: here it is
  ``torch._int_mm`` (int32 accumulation) on both devices.
- K4, K7 and K8 (``csrc/quant_prologue.cu``) replace
  ``_affine_silu_quant_kernel``, ``_ln_quant_kernel`` and
  ``_gn_affine_quant_kernel``: elementwise and row passes bound by device
  memory, each rounding spelled out so the plain versions repeat them (K4
  multiplies by 1 / scale, K7 and K8 divide by the scale, as JAX does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from leftrefill_torch import kernels

F32 = torch.float32

# ---------------------------------------------------------------------------
# quantization helpers (JAX: quant.py:51-103), bit-equal to the JAX package's


def divide(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d as an IEEE division, as the JAX package and the kernels divide
    (a Python-scalar divisor would make PyTorch on CUDA multiply by the
    rounded reciprocal instead, which differs in the last bit)."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def over_127(t: torch.Tensor) -> torch.Tensor:
    return divide(t, 127.0)


def quantize_weight(w: torch.Tensor, axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of ``w`` (the output channel on
    ``axis``, dim 0 in torch's layouts): (wq int8, scale fp32 [co])."""
    wf = w.to(F32)
    red = tuple(i for i in range(wf.ndim) if i != axis % wf.ndim)
    scale = over_127(wf.abs().amax(dim=red).clamp_min(1e-8))
    shape = [1] * wf.ndim
    shape[axis % wf.ndim] = -1
    wq = torch.round(wf / scale.reshape(shape)).clamp(-127, 127).to(torch.int8)
    return wq, scale


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 with a dynamic abs-max scale (fp32 scalar)."""
    xf = x.to(F32)
    scale = over_127(xf.abs().amax().clamp_min(1e-8))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_activation_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: abs-max over the last dim, scale [..., 1] fp32."""
    xf = x.to(F32)
    scale = over_127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int32 product of a [M, K] int8 and b_t [N, K] int8 -> [M, N].  On the
    card ``torch._int_mm`` needs M > 16 and K, N multiples of 8: every UNet
    site meets that, and a site that does not raises (nothing is padded)."""
    m, k = a.shape
    n = b_t.shape[0]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int8 GEMM [{m}, {k}] x [{k}, {n}]: torch._int_mm on CUDA needs M > 16, K and N % 8 == 0")
    return torch._int_mm(a, b_t.t())


def dense_int8(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 GEMM + fp32 dequant: xq [..., K] int8, wq [N, K] int8 (torch
    Linear layout), w_scale [N]; x_scale a scalar or [..., 1].
    out = acc * (x_scale * w_scale) (+ bias), cast to ``out_dtype``."""
    k = xq.shape[-1]
    acc = int_mm(xq.reshape(-1, k), wq).reshape(*xq.shape[:-1], wq.shape[0])
    out = acc.to(F32) * (x_scale * w_scale)
    if bias is not None:
        out = out + bias.to(F32)
    return out.to(out_dtype)


def quantize_params_like(quant_model: torch.nn.Module, state: dict) -> dict:
    """The int8 state_dict of ``quant_model`` from an fp ``state`` with the
    same keys (JAX: ``quantize_params_like``): wherever the quant model holds
    a ``weight_scale``, the fp ``weight`` is replaced by its per-output-channel
    int8 quantization and the scale filled in; every other entry is taken
    from ``state`` unchanged.  Load it with ``quant_model.load_state_dict``."""
    out = {}
    for key in quant_model.state_dict():
        if key.endswith(".weight_scale"):
            continue
        scale_key = key[: -len("weight")] + "weight_scale"
        if key.endswith(".weight") and scale_key in quant_model.state_dict():
            out[key], out[scale_key] = quantize_weight(state[key])
        else:
            out[key] = state[key]
    return out


# ---------------------------------------------------------------------------
# the int8 TPU kernels' VMEM plans, copied with the int8 sizes filled in (JAX:
# ops/conv.py:68-146 under quant.py's _INT8_PLAN_KW, quant.py:144-162,
# quant.py:245-274, quant.py:375-378, quant.py:526-538)

_VMEM_BUDGET = int(11.5 * 1024 * 1024)


def _ceil128(c: int) -> int:
    return -(-c // 128) * 128


def _chan_blocks(total: int) -> list[int]:
    out = [total]
    for c in (1024, 896, 768, 640, 512, 384, 256, 128):
        if c < total and total % c == 0:
            out.append(c)
    return out


def _copy3_blocks(h, w, ci, co):
    """(blk_w, blk_ci, blk_co) of JAX's ``pick_conv_blocks`` at the int8
    sizes (block widths 128/64/32, int8 x and weights, bf16 out, no row
    floor), or None."""
    widths = [bw for bw in (128, 64, 32) if w % bw == 0]
    if not widths or ci < 64 or co < 64:
        return None
    best, best_score = None, None
    for bw in widths:
        for bci in _chan_blocks(ci):
            for bco in _chan_blocks(co):
                # three shifted x copies, weights and the bf16 out double-buffered; the fp32 acc
                if 6 * (h + 2) * bw * bci + 18 * bci * bco + 8 * h * bw * bco > _VMEM_BUDGET:
                    continue
                score = (round((bci / _ceil128(bci)) * (bco / _ceil128(bco)), 3), bci * bco, bw)
                if best_score is None or score > best_score:
                    best, best_score = (bw, bci, bco), score
    return best


def plan_int8(h, w, ci, co):
    """K5's (copy3) plan, Ci zero-padded to a multiple of 128 where the
    unpadded Ci has none: ((blk_w, blk_ci, blk_co), ci_eff) or None."""
    for ci_eff in dict.fromkeys((ci, _ceil128(ci))):
        blocks = _copy3_blocks(h, w, ci_eff, co)
        if blocks is not None:
            return blocks, ci_eff
    return None


def plan_int8_single(h, w, ci, co):
    """K6's (single padded slab) plan: (blk_ci, blk_co, ci_eff, co_eff) or None."""
    best, best_score = None, None
    for ci_eff in {ci, _ceil128(ci)}:
        for bci in _chan_blocks(ci_eff):
            for co_eff in {co, _ceil128(co)}:
                for bco in _chan_blocks(co_eff):
                    x_b = (h + 2) * (w + 2) * bci * 2
                    w_b = 9 * bci * bco * 2
                    acc_b = h * w * bco * 4
                    o_b = h * w * bco * 2 * 2
                    if x_b + w_b + acc_b + o_b > _VMEM_BUDGET:
                        continue
                    tiles = ((ci_eff // bci) * (-(-bci // 128))) * ((co_eff // bco) * (-(-bco // 128)))
                    score = (-tiles, bci * bco, -(ci_eff + co_eff))
                    if best_score is None or score > best_score:
                        best, best_score = (bci, bco, ci_eff, co_eff), score
    return best


def conv3x3_int8_qualifies(h: int, w: int, ci: int, co: int) -> bool:
    """JAX's ``conv3x3_int8_qualifies`` without the TPU probe: the int8 conv
    kernel takes the shape where K5 or K6 has a plan."""
    return (ci >= 64 and co >= 64 and h * w >= 128
            and (plan_int8(h, w, ci, co) is not None or plan_int8_single(h, w, ci, co) is not None))


def plan_dense_rows(rows_per_sample: int, k: int, n: int) -> Optional[int]:
    """K9's row block."""
    for blk in (1024, 512, 256, 128):
        if rows_per_sample % blk == 0 and blk * (k + 3 * n) * 4 <= 10 * 1024 * 1024:
            return blk
    return None


def dense_int8_res_qualifies(b: int, rows_per_sample: int, k: int, n: int) -> bool:
    """JAX's ``dense_int8_res_mom_qualifies`` without the TPU probe."""
    return k % 128 == 0 and n >= 128 and plan_dense_rows(rows_per_sample, k, n) is not None


# ---------------------------------------------------------------------------
# KI1: int8 3x3 conv

# the kernel's frame (csrc/conv3x3_int8.cu): 128-pixel patches, K steps of
# one tap by 128 input channels through a 4-stage ring, K split over a
# thread cluster of at most 4 blocks, each split at least 4 steps
CONV_BM, CONV_STAGES, CONV_MAX_SPLITS, CONV_MIN_SPLIT_STEPS = 128, 4, 4, 4


def conv3x3_int8_plan(b: int, h: int, w: int, ci: int, co: int, sms: int) -> dict:
    """KI1's launch plan at this shape, as ``lr_conv3x3_int8_plan`` computes
    it: the patch of 128 pixels (cols the power of two at or above W, at most
    128), the output channels per block (160 or 128 where they divide Co, or
    64), each with the K split over a cluster that doubles from 1 while the
    split grid stays within one wave over the SMs (up to 4, each split at
    least 4 steps), the width with the least (waves over the SMs) x width /
    split winning, the widest on a tie; with the grid (patches, Co tiles,
    splits), the cluster and the dynamic shared memory."""
    cols = 1
    while cols < w and cols < CONV_BM:
        cols *= 2
    rows = CONV_BM // cols
    m_tiles = b * -(-w // cols) * -(-h // rows)
    nsteps = 9 * -(-ci // 128)
    best = None
    for bn in (160, 128, 64):
        if co % bn and bn != 64:
            continue
        blocks = m_tiles * -(-co // bn)
        s = 1
        while 2 * s <= CONV_MAX_SPLITS and blocks * 2 * s <= sms and nsteps >= CONV_MIN_SPLIT_STEPS * 2 * s:
            s *= 2
        cost = -(-blocks * s // sms) * bn * (CONV_MAX_SPLITS // s)
        if best is None or cost < best[0]:
            best = (cost, bn, s)
    _, bn, splits = best
    return {"tile": (CONV_BM, bn), "patch": (rows, cols), "splits": splits,
            "grid": (m_tiles, -(-co // bn), splits), "cluster": (1, 1, splits), "smem": conv3x3_int8_smem(bn)}


def conv3x3_int8_smem(bn: int) -> int:
    """KI1's dynamic shared memory a block of ``bn`` output channels, bytes:
    the 1024-byte alignment slack, the ring of 128-pixel A and bn-row B
    tiles 128 bytes wide, and a full and an empty barrier a stage."""
    return 1024 + CONV_STAGES * (CONV_BM + bn) * 128 + 16 * CONV_STAGES


def conv3x3_int8_plain(xq: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's plain version: an int8 im2col (zero border) times the
    OHWI weight through ``torch._int_mm`` (int32), then
    acc * scale + bias in fp32 and one cast.  xq [B, H, W, Ci] int8,
    scale [Co] fp32 (s_x * s_w), w [Co, 3, 3, Ci] int8, bias [Co] fp32."""
    b, h, wd, ci = xq.shape
    co = w.shape[0]
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)], dim=-1)
    acc = int_mm(cols.reshape(b * h * wd, 9 * ci), w.reshape(co, 9 * ci))
    return (acc.to(F32) * scale + bias).to(out_dtype).reshape(b, h, wd, co)


def conv3x3_int8_op(xq: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """KI1: the arguments of :func:`conv3x3_int8_plain` -> [B, H, W, Co] in
    ``out_dtype`` (bf16 or fp32).  A CPU tensor runs the plain version; a
    CUDA tensor launches KI1 or raises."""
    if not xq.is_cuda:
        return conv3x3_int8_plain(xq, scale, w, bias, out_dtype)
    if out_dtype not in (torch.bfloat16, F32):
        raise ValueError(f"int8 conv kernel writes bf16 or fp32, not {out_dtype}")
    b, h, wd, ci = xq.shape
    co = w.shape[0]
    kernels.require(xq, "xq", torch.int8)
    kernels.require(w, "w", torch.int8, (co, 3, 3, ci))
    kernels.require(scale, "scale", F32, (co,))
    kernels.require(bias, "bias", F32, (co,))
    if ci % 16 or co % 8:
        raise ValueError(f"int8 conv kernel needs Ci % 16 == 0 and Co % 8 == 0, got {ci}, {co}")
    out = torch.empty((b, h, wd, co), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        code = kernels.library().lr_conv3x3_int8(
            xq.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, ci, co, int(out_dtype == F32), kernels.stream_of(xq),
        )
    kernels.check(code, "conv3x3_int8")
    conv3x3_int8_op.launches += 1
    return out


conv3x3_int8_op.launches = 0


def conv3x3_int8_pre(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """KI1 on a pre-quantized activation (JAX ``_conv3x3_int8_pre``,
    quant.py:877, and the ``*_pre`` kernels): xq [B, H, W, Ci] int8 with its
    per-tensor scale sx, w OHWI int8, w_scale [Co], bias [Co] fp32."""
    kernels.note_site("conv3x3_int8", (*xq.shape, w.shape[0]))
    fn = conv3x3_int8_plain if kernels.plain_kernels_active("conv3x3_int8") else conv3x3_int8_op
    return fn(xq, sx * w_scale, w, bias, out_dtype)


def conv3x3_int8_apply(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The int8 conv site (JAX ``conv3x3_int8``, the caller having checked
    :func:`conv3x3_int8_qualifies`): x quantized per tensor, then KI1, with
    the output in x's dtype (bf16, or fp32 for an fp32 model: JAX's kernel
    takes either).  x [B, H, W, Ci], w OHWI int8, w_scale [Co], bias [Co] fp32."""
    xq, sx = quantize_activation(x)
    return conv3x3_int8_pre(xq, sx, w, w_scale, bias, x.dtype)


# ---------------------------------------------------------------------------
# KI2: int8 proj_out GEMM + bias + residual


def dense_int8_res_plain(xq, sx, wq, w_scale, bias, res) -> torch.Tensor:
    """The kernel's plain version: ((acc * sx) * sw + bias) + res in fp32,
    one cast to bf16.  xq [R, K] int8, sx [R, 1] fp32, wq [N, K] int8,
    w_scale/bias [N] fp32, res [R, N] bf16."""
    acc = int_mm(xq, wq)
    return (acc.to(F32) * sx * w_scale + bias + res.to(F32)).to(torch.bfloat16)


def dense_int8_res_op(xq, sx, wq, w_scale, bias, res) -> torch.Tensor:
    """KI2 on the arguments of :func:`dense_int8_res_plain` -> [R, N] bf16.
    A CPU tensor runs the plain version; a CUDA tensor launches KI2 or raises."""
    if not xq.is_cuda:
        return dense_int8_res_plain(xq, sx, wq, w_scale, bias, res)
    r, k = xq.shape
    n = wq.shape[0]
    kernels.require(xq, "xq", torch.int8)
    kernels.require(sx, "sx", F32, (r, 1))
    kernels.require(wq, "wq", torch.int8, (n, k))
    kernels.require(w_scale, "w_scale", F32, (n,))
    kernels.require(bias, "bias", F32, (n,))
    kernels.require(res, "res", torch.bfloat16, (r, n))
    if k % 16:
        raise ValueError(f"int8 dense kernel needs K % 16 == 0, got {k}")
    lib = kernels.library()
    out = torch.empty((r, n), dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        splits = kernels.splits(lib.lr_dense_int8_res_splits(r, k, n), "dense_int8_res")
        partial = torch.empty((splits, r, n), dtype=torch.int32, device=xq.device) if splits > 1 else None
        code = lib.lr_dense_int8_res(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
            res.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
            r, k, n, splits, kernels.stream_of(xq),
        )
    kernels.check(code, "dense_int8_res")
    dense_int8_res_op.launches += 1
    return out


dense_int8_res_op.launches = 0


# ---------------------------------------------------------------------------
# the fused int8 prologues of JAX's default configuration (LEFTREFILL_FUSED_RES
# and LEFTREFILL_FUSED_LNQ on): K4, K7 and K8, and the functions around them.
# The statistics and the per-tensor amax stay plain PyTorch, as they are XLA
# outside the Pallas kernels in JAX.


def sigmoid(y: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-y)), spelled as K4 computes it (an IEEE divide)."""
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return one / (1.0 + torch.exp(-y))


def gn_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) spatial mean and E[x^2] of x [B, H, W, C], fp32."""
    xf = x.to(F32)
    return xf.mean(dim=(1, 2)), (xf * xf).mean(dim=(1, 2))


def gn_affine_ab(m_c, q_c, gamma, beta, num_groups: int, eps: float, emb=None, scale_shift=None):
    """GroupNorm (+ emb-add before it, or scale-shift after it) folded into a
    per-(batch, channel) affine, normalize(x) == x * a + bb, from the channel
    moments m_c, q_c [B, C] (JAX ``_gn_affine_ab``, quant.py:841-874): with e
    constant over space, the group mean of x + e is mean_g(m_c + e_c) and
    E[(x + e)^2] = q_c + 2 e_c m_c + e_c^2.  Returns (a, bb) [B, C] fp32."""
    b, c = m_c.shape
    g = num_groups
    e_c = emb.to(F32) if emb is not None else torch.zeros_like(m_c)
    mg = (m_c + e_c).reshape(b, g, c // g).mean(dim=-1)
    q2 = q_c + 2.0 * e_c * m_c + e_c * e_c
    vg = q2.reshape(b, g, c // g).mean(dim=-1) - mg * mg
    rstd_c = torch.rsqrt(vg + eps).repeat_interleave(c // g, dim=-1)
    mg_c = mg.repeat_interleave(c // g, dim=-1)
    a = rstd_c * gamma.to(F32)[None]
    bb = (e_c - mg_c) * a + beta.to(F32)[None]
    if scale_shift is not None:
        s, t = scale_shift
        s = 1.0 + s.to(F32)
        a = a * s
        bb = bb * s + t.to(F32)
    return a.contiguous(), bb.contiguous()


def _affine(x: torch.Tensor, a: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """x * a + bb in fp32 (a multiply, then an add), a/bb [B, C] over [B, H, W, C]."""
    return x.to(F32) * a[:, None, None, :] + bb[:, None, None, :]


def _round_int8(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v).clamp(-127, 127).to(torch.int8)


# ---- K4: GN affine + SiLU + per-tensor quantize -----------------------------


def affine_silu_quant_plain(x, a, bb, inv_scale) -> torch.Tensor:
    """K4's plain version, the kernel's fp32 operations in its order:
    int8(clip(round(silu(x * a + bb) * inv_scale))).  x [B, H, W, C] bf16,
    a/bb [B, C] fp32, inv_scale a 0-dim fp32 tensor."""
    y = _affine(x, a, bb)
    return _round_int8(y * sigmoid(y) * inv_scale)


def affine_silu_quant_op(x, a, bb, inv_scale) -> torch.Tensor:
    """K4 (JAX ``affine_silu_quant``, quant.py:631; kernel :603) -> [B, H, W, C]
    int8.  A CPU tensor runs the plain version; a CUDA tensor launches K4 or
    raises."""
    if not x.is_cuda:
        return affine_silu_quant_plain(x, a, bb, inv_scale)
    b, h, w, c = x.shape
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(a, "a", F32, (b, c))
    kernels.require(bb, "bb", F32, (b, c))
    kernels.require(inv_scale, "inv_scale", F32, ())
    if c % 8:
        raise ValueError(f"K4 needs C % 8 == 0, got {c}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        code = kernels.library().lr_affine_silu_quant(
            x.data_ptr(), a.data_ptr(), bb.data_ptr(), inv_scale.data_ptr(), out.data_ptr(),
            b, h * w, c, kernels.stream_of(x))
    kernels.check(code, "affine_silu_quant")
    affine_silu_quant_op.launches += 1
    return out


affine_silu_quant_op.launches = 0


def silu_scale(x: torch.Tensor, a: torch.Tensor, bb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, 1 / scale) of the per-tensor int8 quantization of
    silu(x * a + bb): a plain-PyTorch amax of those values (JAX: an XLA
    reduce, quant.py:924-928), 0-dim fp32 tensors."""
    y = _affine(x, a, bb)
    scale = over_127((y * sigmoid(y)).abs().amax().clamp_min(1e-8))
    return scale, torch.ones_like(scale) / scale


def silu_quant(x: torch.Tensor, a: torch.Tensor, bb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xq, scale): the per-tensor int8 quantization of silu(x * a + bb),
    :func:`silu_scale`, then K4 on 1 / scale."""
    scale, inv_scale = silu_scale(x, a, bb)
    kernels.note_site("affine_silu_quant", tuple(x.shape))
    fn = affine_silu_quant_plain if kernels.plain_kernels_active("affine_silu_quant") else affine_silu_quant_op
    return fn(x.contiguous(), a, bb, inv_scale), scale


def gn_silu_conv3x3_int8_qualifies(h: int, w: int, ci: int, co: int, num_groups: int = 32) -> bool:
    """JAX's rule (quant.py:932) without the TPU probe."""
    return conv3x3_int8_qualifies(h, w, ci, co) and ci % num_groups == 0


def gn_silu_conv3x3_int8(x, gamma, beta, w, w_scale, bias, *, num_groups: int = 32, eps: float = 1e-5,
                         emb=None, scale_shift=None) -> torch.Tensor:
    """GroupNorm (+ emb-add | scale-shift) + SiLU + int8 quantize + 3x3 int8
    conv (JAX ``gn_silu_conv3x3_int8``, quant.py:887-929): the moments and
    the fold plain, K4, then KI1 on the pre-quantized input.  x [B, H, W, C]
    bf16 (the pre-GN activation), w OHWI int8, w_scale/bias [Co] fp32 (the
    bias is not rounded to bf16 here, as in JAX), emb [B, C] added before the
    GN, scale_shift (s, t) [B, C] applied after it.  Output in x's dtype."""
    m_c, q_c = gn_moments(x)
    a, bb = gn_affine_ab(m_c, q_c, gamma, beta, num_groups, eps, emb, scale_shift)
    xq, scale = silu_quant(x, a, bb)
    return conv3x3_int8_pre(xq, scale, w, w_scale, bias, x.dtype)


# ---- K7: LayerNorm + per-row quantize ---------------------------------------


def plan_ln_rows(r: int, c: int) -> Optional[int]:
    """K7's row block (JAX ``_plan_ln_rows``, quant.py:663): the largest of
    512..32 dividing r with the block's ~22 bytes an element in 8 MiB."""
    for blk in (512, 256, 128, 64, 32):
        if r % blk == 0 and blk * c * 22 <= 8 * 1024 * 1024:
            return blk
    return None


def ln_quant_qualifies(r: int, c: int) -> bool:
    """JAX's ``ln_quant_qualifies`` (quant.py:676) without the TPU probe."""
    return plan_ln_rows(r, c) is not None


def ln_quant_plain(x, gamma, beta, eps: float, norm_out: bool):
    """K7's plain version: fp32 mean, two-pass variance,
    y = (x - m) * rsqrt(v + eps) * gamma + beta, then scale =
    max(max|y|, 1e-8) / 127 per row and xq = int8(clip(round(y / scale))).
    x [R, C] bf16, gamma/beta [C] fp32 -> (y in bf16 or None, xq [R, C] int8,
    scale [R, 1] fp32)."""
    c = x.shape[-1]
    xf = x.to(F32)
    d = xf - divide(xf.sum(dim=-1, keepdim=True), c)
    v = divide((d * d).sum(dim=-1, keepdim=True), c)
    y = d * torch.rsqrt(v + eps) * gamma + beta
    scale = over_127(y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return (y.to(x.dtype) if norm_out else None), _round_int8(y / scale), scale


def ln_quant_op(x, gamma, beta, eps: float, norm_out: bool):
    """K7 (kernel quant.py:682) on the arguments of :func:`ln_quant_plain`.
    A CPU tensor runs the plain version; a CUDA tensor launches K7 or raises."""
    if not x.is_cuda:
        return ln_quant_plain(x, gamma, beta, eps, norm_out)
    r, c = x.shape
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(gamma, "gamma", F32, (c,))
    kernels.require(beta, "beta", F32, (c,))
    if c % 8 or c > 2048:
        raise ValueError(f"K7 needs C % 8 == 0 and C <= 2048, got {c}")
    xn = torch.empty_like(x) if norm_out else None
    xq = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((r, 1), dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        code = kernels.library().lr_ln_quant(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), None if xn is None else xn.data_ptr(),
            xq.data_ptr(), scale.data_ptr(), r, c, float(eps), kernels.stream_of(x))
    kernels.check(code, "ln_quant")
    ln_quant_op.launches += 1
    return xn, xq, scale


ln_quant_op.launches = 0


def ln_quant_rowwise(x, gamma, beta, eps: float = 1e-5, norm_out: bool = True):
    """Fused fp32 LayerNorm + per-row int8 quantization over the last dim
    (JAX ``ln_quant_rowwise``, quant.py:703; the caller checked
    :func:`ln_quant_qualifies`): (x_norm or None, xq, scales [..., 1])."""
    *lead, c = x.shape
    x2 = x.reshape(-1, c).contiguous()
    kernels.note_site("ln_quant", (x2.shape[0], c, norm_out))
    fn = ln_quant_plain if kernels.plain_kernels_active("ln_quant") else ln_quant_op
    xn, xq, sc = fn(x2, gamma, beta, eps, norm_out)
    return (None if xn is None else xn.reshape(*lead, c)), xq.reshape(*lead, c), sc.reshape(*lead, 1)


# ---- K8: GroupNorm affine + per-pixel quantize ------------------------------


def gn_quant_qualifies(h: int, w: int, c: int, num_groups: int = 32) -> bool:
    """JAX's ``gn_quant_qualifies`` (quant.py:776) without the TPU probe."""
    return c % num_groups == 0 and w % 8 == 0


def gn_quant_plain(x, a, bb, norm_out: bool):
    """K8's plain version: y = x * a + bb in fp32, then per pixel scale =
    max(max|y|, 1e-8) / 127 and xq = int8(clip(round(y / scale))).
    x [B, H, W, C] bf16, a/bb [B, C] fp32 -> (y in bf16 or None, xq int8,
    scale [B, H, W, 1] fp32)."""
    y = _affine(x, a, bb)
    scale = over_127(y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return (y.to(x.dtype) if norm_out else None), _round_int8(y / scale), scale


def gn_quant_op(x, a, bb, norm_out: bool):
    """K8 (kernel quant.py:758) on the arguments of :func:`gn_quant_plain`.
    A CPU tensor runs the plain version; a CUDA tensor launches K8 or raises."""
    if not x.is_cuda:
        return gn_quant_plain(x, a, bb, norm_out)
    b, h, w, c = x.shape
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(a, "a", F32, (b, c))
    kernels.require(bb, "bb", F32, (b, c))
    if c % 8 or c > 2048:
        raise ValueError(f"K8 needs C % 8 == 0 and C <= 2048, got {c}")
    xn = torch.empty_like(x) if norm_out else None
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((b, h, w, 1), dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        code = kernels.library().lr_gn_quant(
            x.data_ptr(), a.data_ptr(), bb.data_ptr(), None if xn is None else xn.data_ptr(),
            xq.data_ptr(), scale.data_ptr(), b, h * w, c, kernels.stream_of(x))
    kernels.check(code, "gn_quant")
    gn_quant_op.launches += 1
    return xn, xq, scale


gn_quant_op.launches = 0


def gn_quant_rowwise(x, gamma, beta, *, num_groups: int = 32, eps: float = 1e-6, norm_out: bool = True):
    """Fused GroupNorm + per-pixel int8 quantization for the
    SpatialTransformer norm -> proj_in site (JAX ``gn_quant_rowwise``,
    quant.py:782; the caller checked :func:`gn_quant_qualifies`): the moments
    and the fold plain, then K8.  Returns (x_norm or None, xq, scales
    [B, H, W, 1])."""
    m_c, q_c = gn_moments(x)
    a, bb = gn_affine_ab(m_c, q_c, gamma, beta, num_groups, eps)
    kernels.note_site("gn_quant", (*x.shape, norm_out))
    fn = gn_quant_plain if kernels.plain_kernels_active("gn_quant") else gn_quant_op
    return fn(x.contiguous(), a, bb, norm_out)
