"""K1: flash-attention forward with the clamp softmax.

Source note.  Replaces ``leftrefill_tpu/ops/flash_attention.py:_flash_kernel``
(``_flash_forward``).  The kernel (``csrc/flash_fwd.cu``) computes, per query
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

The backward (TPU kernels K12-K14) is not ported yet: differentiating through
:func:`flash_attention` raises.
"""

from __future__ import annotations

import torch

from leftrefill_torch import kernels

CLAMP = 75.0


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float):
    """The kernel's plain version at its precision: fp32 scores from the bf16
    operands, fp32 exp and row sum, p rounded to v's dtype before an
    fp32-accumulated PV product.  q [B, Nq, H*D], k/v [B, Nk, H*D] ->
    (o [B, Nq, H*D] in q's dtype, lse [B*H, Nq] fp32)."""
    b, nq, inner = q.shape
    nk, d = k.shape[1], inner // heads
    qh = q.reshape(b, nq, heads, d).transpose(1, 2).to(torch.float32)
    kh = k.reshape(b, nk, heads, d).transpose(1, 2).to(torch.float32)
    vh = v.reshape(b, nk, heads, d).transpose(1, 2)
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))
    p = torch.exp(torch.clamp(s, max=CLAMP))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=torch.finfo(torch.float32).tiny)
    o = torch.matmul(p.to(v.dtype).to(torch.float32), vh.to(torch.float32)) / l
    return o.to(q.dtype).transpose(1, 2).reshape(b, nq, inner), torch.log(l).reshape(b * heads, nq)


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
