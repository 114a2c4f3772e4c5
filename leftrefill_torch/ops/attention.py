"""Multi-head attention: the exact-softmax plain path and the dispatcher to
the flash kernel K1 and its backward (counterpart of
``leftrefill_tpu/ops/attention.py``).
Packed layout at the public functions: q, k, v are [B, N, H*D]."""

from __future__ import annotations

import torch

from leftrefill_torch import kernels
from leftrefill_torch.ops import flash_attention as fa

KV_RESIDENT_MAX = 8192  # the JAX package's fp32 carve-out bound (ops/flash_attention.py)


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, H, Nq, D] x [B, H, Nk, D] -> [B, H, Nq, D]: fp32 scores and softmax,
    probabilities cast to v's dtype before the PV product."""
    sim = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def flash_qualifies(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> bool:
    """The JAX dispatcher's rule (``leftrefill_tpu/ops/attention.py:48-74``),
    with a CUDA tensor in place of the TPU: head dim 64 or 128, Nq and Nk at
    least 256 and multiples of 128, and no fp32 at 4096 <= Nk <= 8192.
    q: [B, Nq, H*D], k: [B, Nk, H*D]."""
    d = q.shape[-1] // num_heads
    nq, nk = q.shape[1], k.shape[1]
    if q.dtype == torch.float32 and 4096 <= nk <= KV_RESIDENT_MAX:
        return False
    return (
        kernels.uses_kernel(q)
        and d in (64, 128)
        and nq >= 256
        and nk >= 256
        and nq % 128 == 0
        and nk % 128 == 0
    )


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, plain: bool = False
) -> torch.Tensor:
    """q: [B, Nq, H*D], k/v: [B, Nk, H*D] -> [B, Nq, H*D] in q's dtype.
    ``plain=True`` always takes the exact-softmax path (the VAE bottleneck).
    K1 takes bf16 only: another dtype takes the exact-softmax path even
    where the shapes qualify."""
    b, nq, inner = q.shape
    nk = k.shape[1]
    d = inner // num_heads
    scale = d**-0.5
    if not plain and q.dtype == torch.bfloat16 and flash_qualifies(q, k, num_heads):
        kernels.note_site("flash_fwd", (b, num_heads, nq, nk, d))
        return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), num_heads, scale)
    qh = q.reshape(b, nq, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, nk, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, nk, num_heads, d).transpose(1, 2)
    out = _plain_attention(qh, kh, vh, scale)
    return out.transpose(1, 2).reshape(b, nq, inner).to(q.dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Head-averaged attention probabilities for visualization (JAX
    ``attention_probs``, computed in XLA there, outside any kernel): q
    [B, Nq, H*D], k [B, Nk, H*D] -> [B, Nq, Nk] fp32; fp32 scores scaled by
    d**-0.5, softmax over the keys, mean over the heads."""
    b, nq, inner = q.shape
    nk = k.shape[1]
    d = inner // num_heads
    qh = q.reshape(b, nq, num_heads, d).transpose(1, 2).to(torch.float32)
    kh = k.reshape(b, nk, num_heads, d).transpose(1, 2).to(torch.float32)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) * d**-0.5
    return torch.softmax(sim, dim=-1).mean(dim=1)


def causal_text_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Causal self-attention for the CLIP text tower: fp32 scores, the
    masked entries set to the fp32 minimum, fp32 softmax."""
    b, n, inner = q.shape
    d = inner // num_heads
    qh = q.reshape(b, n, num_heads, d).transpose(1, 2).to(torch.float32)
    kh = k.reshape(b, n, num_heads, d).transpose(1, 2).to(torch.float32)
    vh = v.reshape(b, n, num_heads, d).transpose(1, 2)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) * d**-0.5
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    sim = sim.masked_fill(~mask, torch.finfo(torch.float32).min)
    attn = torch.softmax(sim, dim=-1)
    out = torch.matmul(attn.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(b, n, inner).to(q.dtype)
