"""The flash-attention backward in the port against the JAX package's Pallas
backward kernels (K12 ``_flash_bwd_dq_kernel``, K13 ``_flash_bwd_dkv_kernel``,
K14 ``_flash_bwd_dq_chunk_kernel``) in interpret mode, called through
``jax.vjp`` of ``flash_attention`` as the JAX package's own tests call them.
The CUDA kernels (``csrc/flash_bwd.cu``) run only on the card, where
``chip_smoke.py`` holds them to the plain version tested here.

Every case drives some logits past the clamp at 75 (every 8th query row
scaled by 30), so the envelope mask (dS = 0 where s > 75) is exercised.
Tolerances: fp32 max abs 1e-4 (JAX's own bound for its backward, which
also holds its Pallas kernels against an XLA reference); bf16 rel L2 1e-2
for each of dq, dk and dv (the two sides round dS, p and the outputs to
bf16 at the same points; only fp32 summation orders differ).  Readings
on the CPU: fp32 max abs <= 3.9e-5 (dk; dq and dv <= 7.2e-6), bf16 rel
L2 <= 3.6e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import rel_l2

from leftrefill_torch import kernels
from leftrefill_torch.ops import flash_attention as tfa

FP32_ABS, BF16_L2 = 1e-4, 1e-2


def _inputs(seed: int, b: int, h: int, nq: int, nk: int, d: int, dtype: str):
    """q, k, v, dO [B, H, N, D] (numpy fp32, rounded to ``dtype``), every
    8th query row scaled by 30."""
    rng = np.random.RandomState(seed)
    amp = np.ones((1, 1, nq, 1), np.float32)
    amp[:, :, ::8] = 30.0
    arrs = [rng.standard_normal((b, h, nq, d)) * amp, rng.standard_normal((b, h, nk, d)),
            rng.standard_normal((b, h, nk, d)), rng.standard_normal((b, h, nq, d))]
    return [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype)).float().numpy() for a in arrs]


def _jax_vjp(q, k, v, do, dtype, scale):
    from leftrefill_tpu.ops.flash_attention import flash_attention

    qj, kj, vj, gj = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, scale), qj, kj, vj)
        return [np.asarray(g, np.float32) for g in vjp(gj)]


def _port(q, k, v, do, dtype):
    """The port's plain backward on the packed [B, N, H*D] layout, from its
    plain forward's o and lse; results back in [B, H, N, D]."""
    b, h, _, d = q.shape
    pack = lambda a: torch.from_numpy(a).to(getattr(torch, dtype)).transpose(1, 2).reshape(b, a.shape[2], h * d)
    qt, kt, vt, dot = (pack(a) for a in (q, k, v, do))
    o, lse = tfa.flash_forward(qt, kt, vt, h, d**-0.5)
    grads = tfa.flash_backward_plain(qt, kt, vt, o, lse, dot, h, d**-0.5)
    return [g.float().reshape(b, g.shape[1], h, d).transpose(1, 2).numpy() for g in grads]


def _check(got, want, dtype):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        if dtype == "float32":
            assert np.abs(g - w).max() < FP32_ABS, name
        else:
            assert rel_l2(g, w) < BF16_L2, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", [(256, 256), (384, 256), (256, 384)])
def test_backward_plain_matches_resident_kernels(dtype, nq, nk):
    """K12 (dq, K/V resident) and K13 (dk, dv) on square and rectangular shapes."""
    b, h, d = 1, 2, 64
    q, k, v, do = _inputs(nq + nk, b, h, nq, nk, d, dtype)
    assert (np.einsum("bhqd,bhkd->bhqk", q, k) * d**-0.5).max() > 75.0
    _check(_port(q, k, v, do, dtype), _jax_vjp(q, k, v, do, dtype, d**-0.5), dtype)
    assert tfa.flash_bwd_dq.launches == tfa.flash_bwd_dkv.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_streaming_kernels(monkeypatch, dtype):
    """K14 (dq with K/V streamed) and K13: the resident budget shrunk so 512
    keys stream in four 128-key chunks."""
    from leftrefill_tpu.ops import flash_attention as jfa

    monkeypatch.setattr(jfa, "KV_RESIDENT_MAX", 256)
    monkeypatch.setattr(jfa, "KV_CHUNK", 128)
    assert jfa._kv_chunk_for(512) == 128
    calls = []
    monkeypatch.setattr(jfa, "_flash_bwd_dq_chunk_kernel",
                        lambda *a, _f=jfa._flash_bwd_dq_chunk_kernel, **kw: calls.append(1) or _f(*a, **kw))
    b, h, nq, nk, d = 1, 2, 256, 512, 64
    q, k, v, do = _inputs(7, b, h, nq, nk, d, dtype)
    want = _jax_vjp(q, k, v, do, dtype, d**-0.5)
    assert calls  # the streaming dq kernel ran
    _check(_port(q, k, v, do, dtype), want, dtype)


def test_backward_plain_query_chunks_equal_one_chunk(monkeypatch):
    """Query-row chunks: dq exactly the one-chunk result, dk and dv (summed
    over the chunks in another order) within fp32 rounding."""
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(2, 512, 128, generator=g).to(torch.bfloat16) for _ in range(4))
    o, lse = tfa.flash_forward(q, k, v, 2, 0.125)
    whole = tfa.flash_backward_plain(q, k, v, o, lse, do, 2, 0.125)
    monkeypatch.setattr(tfa, "SCORE_CHUNK_BYTES", 4 * 64 * 512 * 4)  # 64 query rows a chunk
    dq, dk, dv = tfa.flash_backward_plain(q, k, v, o, lse, do, 2, 0.125)
    assert torch.equal(dq, whole[0])
    for got, want in ((dk, whole[1]), (dv, whole[2])):
        assert rel_l2(got.float().numpy(), want.float().numpy()) < 4e-3  # a bf16 rounding apart at most


def test_flash_attention_gradients_are_the_backward(monkeypatch):
    """The autograd Function's gradients are the plain backward's on the
    CPU; with the dispatchers patched to take the kernel route (CUDA stands
    in), dq and dk/dv each go through their wrapper once, and
    ``record_sites`` lists the backward sites."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(1, 256, 128, generator=g).to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(1, 256, 128, generator=g).to(torch.bfloat16)
    o = tfa.flash_attention(q, k, v, 2, 0.125)
    grads = torch.autograd.grad(o, (q, k, v), do)
    o2, lse = tfa.flash_forward_plain(q.detach(), k.detach(), v.detach(), 2, 0.125)
    for got, want in zip(grads, tfa.flash_backward_plain(q.detach(), k.detach(), v.detach(), o2, lse, do, 2, 0.125)):
        assert torch.equal(got, want)
    calls = []
    monkeypatch.setattr(tfa, "flash_bwd_dq", lambda *a: calls.append("dq") or tfa.flash_bwd_dq_plain(*a))
    monkeypatch.setattr(tfa, "flash_bwd_dkv", lambda *a: calls.append("dkv") or tfa.flash_bwd_dkv_plain(*a))
    with kernels.record_sites() as sites:
        torch.autograd.grad(tfa.flash_attention(q, k, v, 2, 0.125), (q, k, v), do)
    assert calls == ["dq", "dkv"]
    assert sites == [("flash_bwd_dq", (1, 2, 256, 256, 64)), ("flash_bwd_dkv", (1, 2, 256, 256, 64))]
    calls.clear()
    with kernels.plain_kernels(["flash_bwd_dq", "flash_bwd_dkv"]):
        torch.autograd.grad(tfa.flash_attention(q, k, v, 2, 0.125), (q, k, v), do)
    assert calls == []


def test_clamp_straddles_locate_a_flipped_mask(monkeypatch):
    """The smoke's reading of a score that lies on the clamp: one score set
    to exactly 75 (kept by the plain version, s <= 75) and a stand-in for a
    kernel whose sum lands above it (the plain version with the clamp at
    75 - 2^-10).  ``clamp_straddles`` finds that score alone;
    ``kernel_side`` moves its term, and only it, to the stand-in's side,
    after which dq and dk agree over every row (readings 1.6e-6 and 1.6e-4:
    the lowered clamp also scales the clamped p by exp(2^-10)), where as
    they are they differ by 1.7e-3 and 7.5e-2."""
    from leftrefill_torch import tools

    g = torch.Generator().manual_seed(3)
    b, h, n, d = 1, 2, 256, 64
    amp = torch.where(torch.arange(n)[None, :, None] % 8 == 0, 30.0, 1.0)
    q = torch.randn(b, n, h * d, generator=g) * amp
    k, v, do = (torch.randn(b, n, h * d, generator=g) for _ in range(3))
    k[0, 5, d:] = 0.0  # head 1: key 5 is (1, 0, ..., 0) and query 8 has q[0] = 600, so s = 600 / 8 = 75
    k[0, 5, d] = 1.0
    q[0, 8, d] = 600.0
    q, k, v, do = (a.to(torch.bfloat16) for a in (q, k, v, do))
    scale = d**-0.5
    o, lse = tfa.flash_forward_plain(q, k, v, h, scale)
    site = (q, k, v, do, lse, tfa.flash_delta(o, do, h), h, scale)
    dq, (dk, _) = tfa.flash_bwd_dq_plain(*site), tfa.flash_bwd_dkv_plain(*site)
    monkeypatch.setattr(tfa, "CLAMP", 75.0 - 2.0**-10)
    kdq, (kdk, _) = tfa.flash_bwd_dq_plain(*site), tfa.flash_bwd_dkv_plain(*site)
    monkeypatch.undo()
    idx, s = tools.clamp_straddles(q, k, h, scale)
    assert idx.tolist() == [[0, 1, 8, 5]] and s.tolist() == [75.0]
    assert tools.exact_scores(q, k, h, scale, idx).tolist() == [75.0]
    dq_term, dk_term, kept = tools.straddle_terms(*site, idx, s)
    assert kept.tolist() == [True]
    for got, ref, rows, terms, apart, after in ((kdq, dq, idx[:, 2], dq_term, 1e-3, 1e-5),
                                                 (kdk, dk, idx[:, 3], dk_term, 5e-2, 1e-3)):
        side, moved = tools.kernel_side(got, ref, idx[:, 0], rows, idx[:, 1], terms, kept)
        assert moved == [0] and rel_l2(got.float().numpy(), ref.float().numpy()) > apart
        assert rel_l2(got.float().numpy(), side.numpy()) < after
        assert tools.kernel_side(ref, ref, idx[:, 0], rows, idx[:, 1], terms, kept)[1] == []
