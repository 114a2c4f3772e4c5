"""K1 and K11: flash-attention forward with the clamp softmax; K12-K14: its
backward.

Source note, forward.  Replaces ``leftrefill_tpu/ops/flash_attention.py:_flash_kernel``
(K1, K/V resident, Nk <= 8192) and ``_flash_kvchunk_kernel`` (K11, K/V
streamed in chunks beyond 8192, the multi-view joint attention at V=4): the
same function, blocked two ways for VMEM, which one kernel covers here; it
is held against both.  The kernel computes, per
query row, s = scale * q.k, p = exp(min(s, 75)), l = max(sum p, FLT_MIN),
o = (bf16(p) . v) / l and lse = log l; no row max is taken, so no online
rescale is needed and the K/V tiles just add into l and o.
What bounds it on the H100: at head dim 64 each score costs 256
tensor-core flops and one exp, and an SM does about 8 times more of the
former per clock, so the exps take about as long as the products and only
overlapping them reaches the tensor-core bound.  Design (``csrc/flash_fwd.cu``,
wgmma + TMA): a block owns 128
query rows of one (batch, head), two consumer warpgroups of 64 rows and a
producer warp that streams K/V tiles (128 keys at D = 64) through a 3-stage
TMA ring on mbarriers, straight from the packed [B, N, H*D] projection
layout (no head transposes are materialized); S = Q K^T runs on wgmma from
shared memory, p stays in registers and feeds O += P V as wgmma's register
operand, and the two warpgroups take turns to issue their products so one's
exps run under the other's products.  A last K/V tile past Nk has its p
zeroed; a ragged query tile is clipped by the TMA store.
The kernel takes bf16 only: no workload runs attention in fp32 on the card,
and the dispatcher sends fp32 to the exact-softmax path.
Long sequences: the grid is (Nq / 128, B*H), and shared memory holds one
128-row Q tile and three K/V tiles whatever Nk is, so 16384 and 32768 tokens
(V=4 at 64x64 and 64x128 views) need no change; B*H must stay within the
grid's 65535 rows.

Source note, backward.  Replaces ``_flash_bwd_dq_kernel`` (K12, K/V
resident), ``_flash_bwd_dq_chunk_kernel`` (K14, K/V streamed beyond 8192
keys) and ``_flash_bwd_dkv_kernel`` (K13), launched by ``_flash_backward``.
D = rowsum(dO * O) is one plain fp32 pass, as in JAX; then per score
p = exp(min(s, 75) - lse) from the forward's lse, dS = p * (dP - D) with
dP = dO . v, zeroed where s > 75 (the clamp envelope: the forward is flat in
s there).  ``csrc/flash_bwd.cu`` holds two kernels.  ``lr_flash_bwd_dq``
covers K12 and K14 (they differ only in VMEM blocking), dq = scale *
bf16(dS) . k; ``lr_flash_bwd_dkv`` (K13), dv = bf16(p)^T . dO and dk =
scale * bf16(dS)^T . q.  What bounds them on the H100: three (dq) or four
(dk/dv) products of 2 Nq Nk D flops against one exp and a few fp32
operations per score, which at D = 64 cost about as much SM time as the
products, as in the forward (the exp is ``ex2.approx.ftz``: without flush
to zero the elementwise pass, not the products, set dq's time).  Design (wgmma + TMA, as K1): a block
owns 128 rows (queries for dq, keys for dk/dv), two consumer warpgroups of
64 and a producer warpgroup that gives them its registers (setmaxnreg) and
streams the other side's tiles (dq: 128 keys at D = 64; dk/dv: 64 queries
with their lse and D) through a 4-stage TMA ring; S and dP (dk/dv: S^T = K Q^T and
dP^T = V dO^T, so P^T and dS^T come out in the layout of the next product's
A operand) are wgmma products from shared memory, the elementwise pass runs
in registers, and bf16(dS) (and bf16(P^T)) feed the gradient products as
wgmma's register operand with the streamed tile read transposed; the two
warpgroups take turns to issue products so one's elementwise pass runs
under the other's.  The gradients stay in fp32 accumulators and leave by a
TMA store, which clips a ragged tile; no block writes another's rows, so
there are no atomics and the result is deterministic.  Both read the packed
layout and take bf16, D in (64, 128) and N % 64 == 0.
The safe-softmax and exp2 modes of the JAX package are not ported (off by
default there).
"""

from __future__ import annotations

import torch

from leftrefill_torch import kernels

CLAMP = 75.0


SCORE_CHUNK_BYTES = 1 << 30  # fp32 scores the plain versions hold at once


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, H, N, D] in fp32."""
    b, n, inner = x.shape
    return x.reshape(b, n, heads, inner // heads).transpose(1, 2).to(torch.float32)


def _packed(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D] in ``dtype``."""
    b, h, n, d = x.shape
    return x.to(dtype).transpose(1, 2).reshape(b, n, h * d)


def _q_chunk(q: torch.Tensor, k: torch.Tensor, heads: int) -> int:
    """Query rows whose [B*H, rows, Nk] fp32 scores fit ``SCORE_CHUNK_BYTES``
    (at the V=4 multi-view shape, B*H = 10 and Nq = Nk = 16384, the whole
    score tensor would take 10.7 GB)."""
    return max(1, SCORE_CHUNK_BYTES // (q.shape[0] * heads * k.shape[1] * 4))


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float):
    """The kernel's plain version at its precision: fp32 scores from the bf16
    operands, fp32 exp and row sum, p rounded to v's dtype before an
    fp32-accumulated PV product.  q [B, Nq, H*D], k/v [B, Nk, H*D] ->
    (o [B, Nq, H*D] in q's dtype, lse [B*H, Nq] fp32).  Query rows share
    nothing, so they run in chunks (``_q_chunk``)."""
    b, nq, _ = q.shape
    q_chunk = _q_chunk(q, k, heads)
    kh, vh = _heads(k, heads), _heads(v, heads)
    outs, lses = [], []
    for q0 in range(0, nq, q_chunk):
        qh = _heads(q[:, q0:q0 + q_chunk], heads)
        s = torch.matmul(qh * scale, kh.transpose(-1, -2))
        p = torch.exp(torch.clamp(s, max=CLAMP))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=torch.finfo(torch.float32).tiny)
        del s
        o = torch.matmul(p.to(v.dtype).to(torch.float32), vh) / l
        outs.append(_packed(o, q.dtype))
        lses.append(torch.log(l).reshape(b * heads, qh.shape[2]))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float):
    """(o, lse) for q [B, Nq, H*D], k/v [B, Nk, H*D] in the packed
    projection layout.  A CPU tensor runs the plain version; a CUDA tensor
    (bf16) launches K1 or raises."""
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, heads, scale)
    b, nq, inner = q.shape
    nk, d = k.shape[1], inner // heads
    kernels.require(q, "q", torch.bfloat16)
    kernels.require(k, "k", torch.bfloat16, (b, nk, inner))
    kernels.require(v, "v", torch.bfloat16, (b, nk, inner))
    if d * heads != inner or d not in (64, 128) or nq % 64 or nk % 64:
        raise ValueError(f"flash kernel needs D in (64, 128) and N % 64 == 0, got {q.shape} {k.shape}, {heads} heads")
    o = torch.empty_like(q)
    lse = torch.empty((b * heads, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = kernels.library().lr_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, heads, nq, nk, d, float(scale), kernels.stream_of(q),
        )
    kernels.check(code, "flash_fwd")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


# ---------------------------------------------------------------------------
# the backward: K12 + K14 (dq) and K13 (dk, dv)


def flash_delta(o: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, [B*H, Nq] (one plain pass, as in JAX)."""
    b, n, inner = o.shape
    d = (do.to(torch.float32) * o.to(torch.float32)).reshape(b, n, heads, inner // heads).sum(-1)
    return d.transpose(1, 2).reshape(b * heads, n).contiguous()


def _backward_plain(q, k, v, do, lse, delta, heads: int, scale: float, want_dq: bool, want_dkv: bool):
    """The backward kernels' function at their precision: s from fp32
    products of the bf16 operands, p = exp(min(s, 75) - lse), dP = dO.v^T
    with fp32 accumulation, dS = p (dP - D) zeroed where s > 75;
    dq = scale bf16(dS).k, dv = bf16(p)^T.dO, dk = bf16(dS)^T.bf16(scale q).
    In query-row chunks (``_q_chunk``), dk and dv summed over them.
    Returns (dq or None, dk or None, dv or None) in the packed layout."""
    b, nq, _ = q.shape
    f32 = torch.float32
    q_chunk = _q_chunk(q, k, heads)
    kh, vh = _heads(k, heads), _heads(v, heads)
    lse4, delta4 = lse.reshape(b, heads, nq, 1), delta.reshape(b, heads, nq, 1)
    rounded = lambda x: x.to(q.dtype).to(f32)  # noqa: E731  (the kernels' bf16 operands)
    dqs, dk, dv = [], 0.0, 0.0
    for q0 in range(0, nq, q_chunk):
        rows = slice(q0, q0 + q_chunk)
        qh, doh = _heads(q[:, rows], heads) * scale, _heads(do[:, rows], heads)
        s = torch.matmul(qh, kh.transpose(-1, -2))
        p = torch.exp(torch.clamp(s, max=CLAMP) - lse4[:, :, rows])
        dp = torch.matmul(doh, vh.transpose(-1, -2))
        ds = rounded(torch.where(s <= CLAMP, p * (dp - delta4[:, :, rows]), 0.0))
        del s, dp
        if want_dq:
            dqs.append(torch.matmul(ds, kh) * scale)
        if want_dkv:
            dv = dv + torch.matmul(rounded(p).transpose(-1, -2), doh)
            dk = dk + torch.matmul(ds.transpose(-1, -2), rounded(qh))
    return (_packed(torch.cat(dqs, dim=2), q.dtype) if want_dq else None,
            _packed(dk, k.dtype) if want_dkv else None,
            _packed(dv, v.dtype) if want_dkv else None)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, heads: int, scale: float) -> torch.Tensor:
    return _backward_plain(q, k, v, do, lse, delta, heads, scale, True, False)[0]


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, heads: int, scale: float):
    return _backward_plain(q, k, v, do, lse, delta, heads, scale, False, True)[1:]


def flash_backward_plain(q, k, v, o, lse, do, heads: int, scale: float):
    """(dq, dk, dv) of the clamp-softmax attention at the kernels' precision,
    from the forward's o and lse and the output gradient dO."""
    return _backward_plain(q, k, v, do, lse, flash_delta(o, do, heads), heads, scale, True, True)


def _require_backward(q, k, v, do, lse, delta, heads: int) -> tuple[int, int, int, int, int]:
    b, nq, inner = q.shape
    nk, d = k.shape[1], inner // heads
    kernels.require(q, "q", torch.bfloat16)
    kernels.require(k, "k", torch.bfloat16, (b, nk, inner))
    kernels.require(v, "v", torch.bfloat16, (b, nk, inner))
    kernels.require(do, "dout", torch.bfloat16, (b, nq, inner))
    kernels.require(lse, "lse", torch.float32, (b * heads, nq))
    kernels.require(delta, "delta", torch.float32, (b * heads, nq))
    if d * heads != inner or d not in (64, 128) or nq % 64 or nk % 64:
        raise ValueError(f"flash backward kernels need D in (64, 128) and N % 64 == 0, got {q.shape} {k.shape}, "
                         f"{heads} heads")
    return b, nq, nk, d, inner


def flash_bwd_dq(q, k, v, do, lse, delta, heads: int, scale: float) -> torch.Tensor:
    """dq [B, Nq, H*D] from q, dO [B, Nq, H*D], k/v [B, Nk, H*D] (bf16,
    packed) and the fp32 lse and D [B*H, Nq].  A CPU tensor runs the plain
    version; a CUDA tensor launches ``lr_flash_bwd_dq`` (K12 + K14) or raises."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, heads, scale)
    b, nq, nk, d, _ = _require_backward(q, k, v, do, lse, delta, heads)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = kernels.library().lr_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, heads, nq, nk, d, float(scale), kernels.stream_of(q),
        )
    kernels.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, heads: int, scale: float):
    """(dk, dv) [B, Nk, H*D] on the arguments of :func:`flash_bwd_dq`.  A CPU
    tensor runs the plain version; a CUDA tensor launches ``lr_flash_bwd_dkv``
    (K13) or raises."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, heads, scale)
    b, nq, nk, d, _ = _require_backward(q, k, v, do, lse, delta, heads)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = kernels.library().lr_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, heads, nq, nk, d, float(scale), kernels.stream_of(q),
        )
    kernels.check(code, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, o, lse, do, heads: int, scale: float):
    """(dq, dk, dv) through the dispatchers of the two backward kernels;
    ``kernels.plain_kernels`` routes either to its plain version."""
    args = (q, k, v, do, lse, flash_delta(o, do, heads), heads, scale)
    b, nq, inner = q.shape
    shape = (b, heads, nq, k.shape[1], inner // heads)
    kernels.note_site("flash_bwd_dq", shape)
    dq = (flash_bwd_dq_plain if kernels.plain_kernels_active("flash_bwd_dq") else flash_bwd_dq)(*args)
    kernels.note_site("flash_bwd_dkv", shape)
    dk, dv = (flash_bwd_dkv_plain if kernels.plain_kernels_active("flash_bwd_dkv") else flash_bwd_dkv)(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward (or its plain version where ``kernels.plain_kernels``
    routes it), the backward through :func:`flash_backward`; q, k, v, o and
    lse are saved (under remat the forward runs again instead)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        fwd = flash_forward_plain if kernels.plain_kernels_active("flash_fwd") else flash_forward
        o, lse = fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.heads, ctx.scale = heads, scale
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_backward(q, k, v, o, lse, grad.to(q.dtype).contiguous(), ctx.heads, ctx.scale), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Attention output [B, Nq, H*D] through K1, differentiable through the
    backward kernels."""
    return _FlashAttention.apply(q, k, v, heads, scale)
