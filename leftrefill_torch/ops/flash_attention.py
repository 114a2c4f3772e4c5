"""K1 and K11: flash-attention forward with the clamp softmax.

Source note.  Replaces ``leftrefill_tpu/ops/flash_attention.py:_flash_kernel``
(K1, K/V resident, Nk <= 8192) and ``_flash_kvchunk_kernel`` (K11, K/V
streamed in chunks beyond 8192, the multi-view joint attention at V=4): the
same function, blocked two ways for VMEM, which one kernel covers here; it
is held against both.  The kernel (``csrc/flash_fwd.cu``) computes, per query
row, s = scale * q.k, p = exp(min(s, 75)), l = max(sum p, FLT_MIN),
o = (bf16(p) . v) / l and lse = log l; no row max is taken, so no online
rescale is needed and the K/V tiles just add into l and o.  On the H100 a
block owns 64 query rows and streams K/V in 64-key tiles (at Nk = 8192 one
head's K/V, 2 MB, cannot stay in shared memory); the products run on the
tensor cores through bf16 WMMA fragments with fp32 accumulation, and q, k, v
and o stay in the packed [B, N, H*D] projection layout (no head transposes
are materialized).  At head dim 64 the exp and the shared-memory round trip
of the score tile, not the tensor cores, bound this first version.
The kernel takes bf16 only: no workload runs attention in fp32 on the card,
and the dispatcher sends fp32 to the exact-softmax path.
Long sequences: the grid is (Nq / 64, B*H), every global offset is a size_t
product, and shared memory holds one 64-row Q tile and two 64-key K/V tiles
whatever Nk is, so 16384 and 32768 tokens (V=4 at 64x64 and 64x128 views)
need no change; B*H must stay within the grid's 65535 rows.

The backward (TPU kernels K12-K14) is not ported yet: differentiating through
:func:`flash_attention` raises.
"""

from __future__ import annotations

import torch

from leftrefill_torch import kernels

CLAMP = 75.0


SCORE_CHUNK_BYTES = 1 << 30  # fp32 scores the plain version holds at once


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float):
    """The kernel's plain version at its precision: fp32 scores from the bf16
    operands, fp32 exp and row sum, p rounded to v's dtype before an
    fp32-accumulated PV product.  q [B, Nq, H*D], k/v [B, Nk, H*D] ->
    (o [B, Nq, H*D] in q's dtype, lse [B*H, Nq] fp32).

    Query rows share nothing, so they run in chunks of as many rows as keep
    the [B*H, rows, Nk] fp32 scores within ``SCORE_CHUNK_BYTES``: at the V=4
    multi-view shape (B*H = 10, Nq = Nk = 16384) the whole score tensor
    would take 10.7 GB."""
    b, nq, inner = q.shape
    nk, d = k.shape[1], inner // heads
    q_chunk = max(1, SCORE_CHUNK_BYTES // (b * heads * nk * 4))
    kh = k.reshape(b, nk, heads, d).transpose(1, 2).to(torch.float32)
    vh = v.reshape(b, nk, heads, d).transpose(1, 2).to(torch.float32)
    outs, lses = [], []
    for q0 in range(0, nq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        qh = qc.reshape(b, qc.shape[1], heads, d).transpose(1, 2).to(torch.float32)
        s = torch.matmul(qh * scale, kh.transpose(-1, -2))
        p = torch.exp(torch.clamp(s, max=CLAMP))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=torch.finfo(torch.float32).tiny)
        del s
        o = torch.matmul(p.to(v.dtype).to(torch.float32), vh) / l
        outs.append(o.to(q.dtype).transpose(1, 2).reshape(b, qc.shape[1], inner))
        lses.append(torch.log(l).reshape(b * heads, qc.shape[1]))
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


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        return flash_forward(q, k, v, heads, scale)[0]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the flash-attention backward (TPU kernels K12-K14: _flash_bwd_dq_kernel, "
            "_flash_bwd_dkv_kernel, _flash_bwd_dq_chunk_kernel) is not ported yet"
        )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Attention output [B, Nq, H*D] through K1 (no backward yet)."""
    return _FlashAttention.apply(q, k, v, heads, scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    return flash_forward_plain(q, k, v, heads, scale)[0]
