"""The timing probes of the JAX package's scripts, P1-P5, each kernel beside
its plain PyTorch version at the script's precision.  None is on the port's
serving or training path: ``leftrefill_torch/tools/probes/`` drives them.

- P1 :func:`flash_int8` (``csrc/flash_int8.cu``) replaces
  ``scripts/tpu_r3_attnprobe.py:_flash_i8_kernel``: attention with an int8
  Q K^T on per-row q and k scales, and with ``pv_int8`` an int8 P V on
  p / l quantized to 1/127 steps and a per-tensor v scale.  The
  quantization of q, k and v is plain PyTorch here, as it was XLA outside the
  kernel there (``torch.round`` rounds half to even, as ``jnp.round``).
- P2-P4 :func:`flash_variant` (``csrc/flash_fwd.cu`` ``lr_flash_fwd_variant``)
  replaces K1's variants in ``scripts/tpu_r3_attnprobe2.py:make_kernel``
  (no lse; the clamp optional; exp on bf16(s) with an fp32 row sum),
  ``scripts/tpu_r5_headpack.py:_kernel`` (with the lse; ``use_exp=False``
  takes p = min(s, 75), wrong math on purpose) and
  ``scripts/tpu_r5_attn_ab.py:_kernel`` / ``_kernel_nolse``: K1's kernel
  built with the exp, the clamp, the lse store and the query rows a block
  (128 or 256) as compile-time flags.  The scripts' 512-row block has no
  counterpart: eight 64-row consumer warpgroups and a producer warp would
  be 1056 threads, past the block limit of 1024.
- P5 :func:`noop` (``csrc/noop.cu``) replaces
  ``scripts/tpu_r3_overhead.py:_noop_kernel``: o = x + 1 on an [8, 128]
  bf16 tile, a probe of the launch floor.

The probes read the scripts' head-major layout [B, H, N, D] (or [B*H, N, D]),
which the variant kernel reads as K1's packed layout with one head.
"""

from __future__ import annotations

import torch

from leftrefill_torch import kernels
from leftrefill_torch.ops.quant import over_127

CLAMP = 75.0
TINY = torch.finfo(torch.float32).tiny
SCORE_CHUNK_BYTES = 1 << 30  # the plain versions' fp64 (P1) or fp32 scores held at once

EXP_MODES = {"f32": 0, "bf16": 1, "identity": 2}  # csrc/flash_fwd.cu's ExpMode


def _chunk(bh: int, nk: int, item: int) -> int:
    return max(1, SCORE_CHUNK_BYTES // (bh * nk * item))


# ---------------------------------------------------------------------------
# P1: the int8 Q K^T flash forward


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x [..., D]: (codes int8, scales fp32 [...])."""
    xf = x.to(torch.float32)
    s = over_127(xf.abs().amax(-1, keepdim=True).clamp_min(1e-8))
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s[..., 0]


def int8_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pv_int8: bool):
    """The script's quantization outside the kernel, q, k, v [B, H, N, D]:
    (qi [BH, Nq, D] int8, sq [BH, Nq], ki [BH, Nk, D] int8, sk [BH, Nk], v as
    [BH, Nk, D]: v itself, or with ``pv_int8`` its per-tensor int8 codes, and
    the v scale (a 0-d fp32 tensor, None without ``pv_int8``))."""
    d = q.shape[-1]
    qi, sq = quantize_rows(q.reshape(-1, q.shape[-2], d))
    ki, sk = quantize_rows(k.reshape(-1, k.shape[-2], d))
    vf = v.reshape(-1, v.shape[-2], d)
    if not pv_int8:
        return qi, sq, ki, sk, vf, None
    vf = vf.to(torch.float32)
    sv = over_127(vf.abs().amax().clamp_min(1e-8))
    # a divisor in a tensor (not a Python scalar) is an IEEE division on the card too
    return qi, sq, ki, sk, torch.round(vf / sv).clamp(-127, 127).to(torch.int8), sv


def vq_key_order(nk: int, device=None) -> torch.Tensor:
    """The key each position of the kernel's Vq^T rows holds: within each
    chunk of 32 keys, position 16h + 4t + m holds key 16h + 2t + m (m < 2)
    or 16h + 8 + 2t + m - 2, the order in which a thread's columns of the
    S accumulator fill the int8 A fragment of the P V product."""
    pos = torch.arange(32, device=device)
    h, t, m = pos // 16, pos % 16 // 4, pos % 4
    within = 16 * h + torch.where(m < 2, 2 * t + m, 8 + 2 * t + m - 2)
    keys = torch.arange(nk, device=device)
    return keys // 32 * 32 + within[keys % 32]


def _int8_out(o: torch.Tensor, sv, pv_int8: bool, shape) -> torch.Tensor:
    if pv_int8:
        o = o * sv.to(o.dtype)
    return o.reshape(shape)


def int8_probs(qi, sq, kt, sk, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """P1's p = exp(min(f32(s32) * (sq * sk) * scale, 75)) and l = max(sum
    p, FLT_MIN) [..., 1] for int8 query rows qi [BH, n, D] with scales sq
    [BH, n] against kt (the int8 keys as fp32, [BH, D, Nk]) with scales sk
    [BH, Nk]: the int32 Q K^T is exact in fp32 (64 * 127^2 < 2^24)."""
    s = torch.matmul(qi.to(torch.float32), kt) * (sq[..., None] * sk[:, None, :]) * scale
    p = torch.exp(torch.clamp(s, max=CLAMP))
    return p, torch.clamp(p.sum(-1, keepdim=True), min=TINY)


def flash_int8_plain(q, k, v, scale: float, pv_int8: bool = False) -> torch.Tensor:
    """P1 at the script's precision on q, k, v [B, H, N, D]: exact int32
    Q K^T (fp32 sums of int8 products stay below 2^24), s = f32(s32) *
    (sq * sk) * scale, p = exp(min(s, 75)), l = max(sum p, FLT_MIN); then
    o = (p in v's dtype . v) / l, or with ``pv_int8`` pq = clip(round(p / l
    * 127), 0, 127), o = f32(pq . vq) * (1 / 127) in q's dtype (the int8 sum
    in fp64: it passes 2^24), times the v scale.  Query rows in chunks."""
    qi, sq, ki, sk, vin, sv = int8_operands(q, k, v, pv_int8)
    bh, nq, _ = qi.shape
    kt = ki.to(torch.float32).transpose(-1, -2)
    vd = vin.to(torch.float64) if pv_int8 else vin.to(torch.float32)
    outs, chunk = [], _chunk(bh, ki.shape[1], 8)
    for q0 in range(0, nq, chunk):
        rows = slice(q0, q0 + chunk)
        p, l = int8_probs(qi[:, rows], sq[:, rows], kt, sk, scale)
        if pv_int8:
            pq = torch.clamp(torch.round(p / l * 127.0), 0, 127)
            outs.append((torch.matmul(pq.to(torch.float64), vd).to(torch.float32) * (1.0 / 127.0)).to(q.dtype))
        else:
            o = torch.matmul(p.to(vin.dtype).to(torch.float32), vd) / l
            outs.append(o.to(q.dtype))
    return _int8_out(torch.cat(outs, dim=1), sv, pv_int8, q.shape)


def flash_int8(q, k, v, scale: float, pv_int8: bool = False) -> torch.Tensor:
    """P1 on q, k, v [B, H, N, D] (D = 64, N a multiple of 128): the
    quantization in PyTorch, then ``lr_flash_int8``.  A CPU tensor runs the
    plain version; a CUDA tensor (bf16) launches the kernel or raises."""
    if not q.is_cuda:
        return flash_int8_plain(q, k, v, scale, pv_int8)
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.require(t, name, torch.bfloat16)
    if q.shape[-1] != 64 or k.shape != v.shape or q.shape[:-2] != k.shape[:-2] or q.shape[-2] % 128 \
            or k.shape[-2] % 128:
        raise ValueError(f"flash_int8 needs D = 64 and N % 128 == 0, got {tuple(q.shape)} {tuple(k.shape)}")
    qi, sq, ki, sk, vin, sv = int8_operands(q, k, v, pv_int8)
    bh, nq, _ = qi.shape
    nk = ki.shape[1]
    if pv_int8:  # Vq^T [BH, 64, Nk], each 32-key chunk in the kernel's key order
        vin = vin.transpose(1, 2)[:, :, vq_key_order(nk, q.device)].contiguous()
    o = torch.empty((bh, nq, 64), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        code = kernels.library().lr_flash_int8(
            qi.data_ptr(), sq.data_ptr(), ki.data_ptr(), sk.data_ptr(), vin.data_ptr(), o.data_ptr(),
            bh, nq, nk, float(scale), int(pv_int8), kernels.stream_of(q))
    kernels.check(code, "flash_int8")
    flash_int8.launches += 1
    return _int8_out(o, sv, pv_int8, q.shape)


flash_int8.launches = 0


# ---------------------------------------------------------------------------
# P2-P4: K1's variants


def flash_variant_plain(q, k, v, scale: float, *, exp: str = "f32", clamp: bool = True, lse: bool = True,
                        rows: int = 128):
    """K1's variant at the scripts' precision on q, k, v [..., N, D]: s =
    (f32(q) * scale) . f32(k), min(s, 75) with ``clamp``; p = exp(s) in fp32,
    or exp(bf16(s)) in bf16 with an fp32 row sum, or s itself ("identity")
    (the kernel's bf16 exp takes 2^(bf16(s log2 e)), two scores an SFU
    operation: the same precision, a bf16 rounding of another argument);
    l = max(sum p, FLT_MIN), o = (p in v's dtype . v) / l in q's dtype, and
    with ``lse`` also log l [..., Nq].  ``rows`` (the kernel's block) does not
    change the function."""
    if exp not in EXP_MODES:
        raise ValueError(f"exp must be one of {sorted(EXP_MODES)}, got {exp!r}")
    lead, (nq, d), nk = q.shape[:-2], q.shape[-2:], k.shape[-2]
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d) for t in (q, k, v))
    kt, vf = k3.to(torch.float32).transpose(-1, -2), v3.to(torch.float32)
    outs, lses, chunk = [], [], _chunk(q3.shape[0], nk, 4)
    for q0 in range(0, nq, chunk):
        s = torch.matmul(q3[:, q0:q0 + chunk].to(torch.float32) * scale, kt)
        if clamp:
            s = torch.clamp(s, max=CLAMP)
        if exp == "bf16":
            p = torch.exp(s.to(torch.bfloat16))
            l = torch.clamp(p.to(torch.float32).sum(-1, keepdim=True), min=TINY)
        else:
            p = torch.exp(s) if exp == "f32" else s
            l = torch.clamp(p.sum(-1, keepdim=True), min=TINY)
        del s
        outs.append((torch.matmul(p.to(v.dtype).to(torch.float32), vf) / l).to(q.dtype))
        lses.append(torch.log(l)[..., 0])
    o = torch.cat(outs, dim=1).reshape(q.shape)
    return (o, torch.cat(lses, dim=1).reshape(*lead, nq)) if lse else o


def flash_variant(q, k, v, scale: float, *, exp: str = "f32", clamp: bool = True, lse: bool = True,
                  rows: int = 128):
    """K1's variant on q, k, v [..., N, D] (bf16, D = 64, N a multiple of
    64): o, and with ``lse`` (o, lse [..., Nq]).  A CPU tensor runs the plain
    version; a CUDA tensor launches ``lr_flash_fwd_variant`` or raises (a
    combination outside :func:`built_variants` is refused by the kernel's
    entry)."""
    if not q.is_cuda:
        return flash_variant_plain(q, k, v, scale, exp=exp, clamp=clamp, lse=lse, rows=rows)
    if exp not in EXP_MODES:
        raise ValueError(f"exp must be one of {sorted(EXP_MODES)}, got {exp!r}")
    d, nq, nk = q.shape[-1], q.shape[-2], k.shape[-2]
    bh = q.numel() // (nq * d)
    kernels.require(q, "q", torch.bfloat16)
    kernels.require(k, "k", torch.bfloat16, (*q.shape[:-2], nk, d))
    kernels.require(v, "v", torch.bfloat16, (*q.shape[:-2], nk, d))
    o = torch.empty_like(q)
    lse_out = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device) if lse else None
    with torch.cuda.device(q.device):
        code = kernels.library().lr_flash_fwd_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0 if lse_out is None else lse_out.data_ptr(),
            bh, 1, nq, nk, d, float(scale), EXP_MODES[exp], int(clamp), int(lse), rows, kernels.stream_of(q))
    kernels.check(code, f"flash_variant(exp={exp}, clamp={clamp}, lse={lse}, rows={rows})")
    flash_variant.launches += 1
    return (o, lse_out) if lse else o


flash_variant.launches = 0


def built_variants() -> list[tuple[str, bool, bool, int]]:
    """The (exp, clamp, lse, rows) combinations ``lr_flash_fwd_variant`` is
    built for, as the kernel library reports them (``LR_VARIANTS`` in
    ``csrc/flash_fwd.cu``, the one list of them)."""
    lib = kernels.library()
    return [(e, c, l, r) for e in EXP_MODES for c in (True, False) for l in (True, False) for r in (128, 256)
            if lib.lr_flash_fwd_variant_built(EXP_MODES[e], int(c), int(l), r)]


# ---------------------------------------------------------------------------
# P5: the launch-floor no-op


def noop_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def noop(x: torch.Tensor) -> torch.Tensor:
    """x + 1 (bf16, a multiple of 8 values).  A CPU tensor runs the plain
    version; a CUDA tensor launches ``lr_noop`` or raises."""
    if not x.is_cuda:
        return noop_plain(x)
    kernels.require(x, "x", torch.bfloat16)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = kernels.library().lr_noop(x.data_ptr(), o.data_ptr(), x.numel(), kernels.stream_of(x))
    kernels.check(code, "noop")
    noop.launches += 1
    return o


noop.launches = 0
