"""The port's kernel plain versions (K1 flash forward, K2 3x3 conv, K3 fused
GEGLU) against the JAX package's Pallas kernels in interpret mode, in bf16,
and the port's dispatchers against the JAX package's.  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against these
plain versions there.

Tolerance: 2e-2 * max|ref| (see test_torch_parity_utils): each side rounds
its bf16 output once and the intermediates at slightly different points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import BF16_REL, rel_err

from leftrefill_torch.ops import conv as tconv
from leftrefill_torch.ops import flash_attention as tfa
from leftrefill_torch.ops import mlp as tmlp


def _bf16_pair(a: np.ndarray):
    """The same bf16 values on both sides."""
    tb = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return tb, jnp.asarray(tb.to(torch.float32).numpy()).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n,amp", [(256, 1.0), (512, 1.0), (256, 30.0)])
def test_flash_plain_matches_pallas(n, amp):
    """amp 30 drives logits past the clamp at 75 (logit std ~30), which the
    exact softmax would not reproduce: it pins the clamp semantics."""
    from leftrefill_tpu.ops.flash_attention import _flash_forward

    rng = np.random.RandomState(n + int(amp))
    b, h, d = 2, 2, 64
    qt, qj = _bf16_pair(rng.standard_normal((b, h, n, d)) * amp)
    kt, kj = _bf16_pair(rng.standard_normal((b, h, n, d)))
    vt, vj = _bf16_pair(rng.standard_normal((b, h, n, d)))
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = _flash_forward(qj, kj, vj, scale)
    # the port's kernel takes the packed [B, N, H*D] projection layout
    pack = lambda a: a.transpose(1, 2).reshape(b, n, h * d)
    o, lse = tfa.flash_forward(pack(qt), pack(kt), pack(vt), h, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert rel_err(_np(o), _np(o_ref).transpose(0, 2, 1, 3).reshape(b, n, h * d)) < BF16_REL
    # lse is fp32 on both sides from the same fp32 exps: only the summation
    # order differs
    np.testing.assert_allclose(lse.numpy(), _np(lse_ref).reshape(b * h, n), atol=1e-4, rtol=0)
    if amp > 1:
        s = np.einsum("bhqd,bhkd->bhqk", _np(qt), _np(kt)) * scale
        assert s.max() > 75.0
    assert tfa.flash_forward.launches == 0


@pytest.mark.parametrize("ci", [128, 192])
def test_conv_plain_matches_pallas(ci):
    """16x16, Co = 128; Ci = 192 takes the Pallas kernel's zero-padded-Ci
    path, which the CUDA kernel replaces by reading the channels as they are."""
    from leftrefill_tpu.ops.conv import conv3x3_op

    rng = np.random.RandomState(ci)
    co = 128
    xt, xj = _bf16_pair(rng.standard_normal((2, 16, 16, ci)))
    wt, wj = _bf16_pair(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
    bias = rng.standard_normal(co).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = conv3x3_op(xj, wj, jnp.asarray(bias))
    # the port's kernel takes the weight as OHWI (channels-last OIHW)
    out = tconv.conv3x3_op(xt, wt.permute(3, 0, 1, 2).contiguous(), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 16, co)
    assert rel_err(_np(out), _np(ref)) < BF16_REL
    assert tconv.conv3x3_op.launches == 0


@pytest.mark.parametrize("din", [64, 128])
def test_geglu_plain_matches_pallas_and_exact_reference(din):
    from leftrefill_tpu.ops.mlp import geglu_fused, geglu_reference

    rng = np.random.RandomState(din)
    r, inner, dout = 128, 256, din
    xt, xj = _bf16_pair(rng.standard_normal((r, din)))
    w1t, w1j = _bf16_pair(rng.standard_normal((din, 2 * inner)) / np.sqrt(din))
    w2t, w2j = _bf16_pair(rng.standard_normal((inner, dout)) / np.sqrt(inner))
    b1 = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(dout)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = geglu_fused(xj, w1j, jnp.asarray(b1), w2j, jnp.asarray(b2))
    exact = geglu_reference(xj, w1j, jnp.asarray(b1), w2j, jnp.asarray(b2))
    # the port's kernel takes torch's Linear layout ([out, in])
    out = tmlp.geglu_fused(xt, w1t.t().contiguous(), torch.from_numpy(b1), w2t.t().contiguous(),
                           torch.from_numpy(b2))
    assert out.dtype == torch.bfloat16 and out.shape == (r, dout)
    assert rel_err(_np(out), _np(ref)) < BF16_REL
    assert rel_err(_np(out), _np(exact)) < BF16_REL
    assert tmlp.geglu_fused.launches == 0


def test_cpu_dispatch_takes_plain_paths():
    """On the CPU the dispatchers never choose a kernel: attention is the
    exact softmax, conv and GEGLU their plain fallbacks, and no counter moves."""
    from leftrefill_torch.ops.attention import _plain_attention, flash_qualifies, multi_head_attention

    q = torch.randn(1, 256, 128, dtype=torch.bfloat16)
    assert not flash_qualifies(q, q, 2)
    out = multi_head_attention(q, q, q, num_heads=2)
    qh = q.reshape(1, 256, 2, 64).transpose(1, 2)
    ref = _plain_attention(qh, qh, qh, 64**-0.5).transpose(1, 2).reshape(1, 256, 128)
    assert torch.equal(out, ref)
    x = torch.randn(1, 16, 16, 64, dtype=torch.bfloat16)
    assert not tconv.conv3x3_qualifies(x, 64)
    assert not tmlp.geglu_fused_qualifies(x.reshape(-1, 64), 64, 256, 64)
    assert tfa.flash_forward.launches == tconv.conv3x3_op.launches == tmlp.geglu_fused.launches == 0


@pytest.mark.parametrize(
    "dtype,d,nq,nk",
    [
        ("bfloat16", 64, 8192, 8192),  # ds1 self-attention
        ("bfloat16", 64, 2048, 2048),
        ("bfloat16", 64, 512, 512),
        ("bfloat16", 64, 128, 128),  # the 8x16 mid block
        ("bfloat16", 64, 8192, 77),  # cross-attention
        ("bfloat16", 128, 1024, 1024),
        ("bfloat16", 80, 1024, 1024),
        ("bfloat16", 64, 8256, 8256),  # NVS with sep tokens: not a multiple of 128
        ("float32", 64, 8192, 8192),  # the fp32 carve-out ...
        ("float32", 64, 4096, 4096),
        ("float32", 64, 2048, 2048),  # ... and either side of it
        ("float32", 64, 16384, 16384),
    ],
)
def test_flash_qualifies_mirrors_jax(monkeypatch, dtype, d, nq, nk):
    """The port's flash dispatcher decides as the JAX package's does on a
    TPU, the CUDA tensor standing in for the TPU."""
    import types

    import jax

    from leftrefill_tpu.ops.attention import _flash_qualifies
    from leftrefill_tpu.ops.flash_attention import KV_RESIDENT_MAX

    from leftrefill_torch import kernels
    from leftrefill_torch.ops import attention

    assert attention.KV_RESIDENT_MAX == KV_RESIDENT_MAX
    monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(platform="tpu")])
    monkeypatch.setattr(kernels, "uses_kernel", lambda t: True)
    heads = 2
    ref = _flash_qualifies(jax.ShapeDtypeStruct((1, heads, nq, d), jnp.dtype(dtype)),
                           jax.ShapeDtypeStruct((1, heads, nk, d), jnp.dtype(dtype)))
    q = torch.empty(1, nq, heads * d, dtype=getattr(torch, dtype), device="meta")
    k = torch.empty(1, nk, heads * d, dtype=getattr(torch, dtype), device="meta")
    assert attention.flash_qualifies(q, k, heads) == ref


def test_flash_backward_raises(monkeypatch):
    """The backward kernels' argument checks raise, rather than hand over to
    the plain version, where a kernel does not take its arguments: a
    non-CUDA tensor, and (the device check stood in for) a head dim outside
    (64, 128) or a length that is not a multiple of 64.  The gradients
    themselves: ``tests/test_torch_flash_bwd.py``."""
    from leftrefill_torch import kernels

    def args(n, heads, d):
        q = torch.zeros(1, n, heads * d, dtype=torch.bfloat16)
        stats = torch.zeros(heads, n)
        return q, q, q, q, stats, stats, heads

    with pytest.raises(ValueError, match="CUDA"):
        tfa._require_backward(*args(64, 1, 64))
    monkeypatch.setattr(kernels, "require", lambda *a, **k: None)
    assert tfa._require_backward(*args(128, 2, 64)) == (1, 128, 128, 64, 128)
    for n, heads, d in ((64, 2, 32), (96, 1, 64)):
        with pytest.raises(ValueError, match="D in"):
            tfa._require_backward(*args(n, heads, d))


def test_cuda_wrappers_reject_bad_arguments():
    """A wrapper given a tensor its kernel does not take raises before any
    build or launch (checked here on CPU tensors posing as the argument)."""
    from leftrefill_torch import kernels

    with pytest.raises(ValueError, match="CUDA"):
        kernels.require(torch.zeros(8), "x", torch.bfloat16)


def test_ctypes_signatures_match_the_c_entry_points():
    """The argtypes the loader sets equal the extern "C" prototypes in csrc/
    (a mismatch would pass wrong values to a kernel on the card)."""
    import ctypes
    import re

    from leftrefill_torch import kernels

    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    protos = {}
    for src in kernels.CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (lr_\w+)\(([^)]*)\)', src.read_text()):
            types = [re.sub(r"\s*\w+$", "", a.strip()).replace(" *", "*") for a in args.split(",")]
            protos[name] = [ctype[t] for t in types]
    assert protos == kernels._SIGNATURES
