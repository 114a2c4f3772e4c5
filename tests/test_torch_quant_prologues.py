"""The fused int8 prologues of JAX's default int8 configuration on the CPU:
the plain versions of K4 (GN affine + SiLU + per-tensor quantize), K7
(LayerNorm + per-row quantize) and K8 (GN affine + per-pixel quantize)
against the Pallas kernels they replace, run in interpret mode, and the
functions around them (``gn_affine_ab``, ``gn_silu_conv3x3_int8``,
``ln_quant_rowwise``, ``gn_quant_rowwise``) against JAX's.  The CUDA kernels
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions.

Bounds, and their reasons.  int8 values at most one step off, on at most
1e-3 of the elements: a rounding tie, or a value quantized that differs in
its last bit.  XLA on the CPU contracts x * a + b into an FMA, where the
plain versions round the multiply and the add apart (as the kernels do on
the card), and it sums a row in another order than PyTorch, so the fp32
values quantized may differ by an ulp or two: scales within 4 fp32 ulps, a
bf16 normalized output within 2 bf16 ulps; with the port's own GroupNorm
statistics (``gn_quant_rowwise`` end to end), whose sums over the image run
in another order too, scales within 16 ulps.  Measured: K4 equal to the
Pallas kernel; K7 no step moved, scales 3 ulps, output 1 ulp; K8 on JAX's
fold no step moved, scales 2 ulps, output 2 ulps; K8 end to end one step on
4.9e-5 of the elements, scales 11 ulps; the fold within 4 fp32 ulps of
max|a| (``gn_affine_ab``); the fused ResBlock conv within 3e-3 rel L2 of
JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import BF16_REL, rel_err, rel_l2

from leftrefill_tpu.ops import quant as jq
from leftrefill_torch.ops import quant as tq
from leftrefill_torch.tools import bf16_ulps


def _bf16_pair(a: np.ndarray):
    tb = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return tb, jnp.asarray(tb.to(torch.float32).numpy()).astype(jnp.bfloat16)


def _launches():
    return tq.affine_silu_quant_op.launches, tq.ln_quant_op.launches, tq.gn_quant_op.launches


def _steps_ok(got, ref) -> bool:
    """int8 values at most one step apart, on at most 1e-3 of the elements."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    return d.max() <= 1 and (d > 0).mean() <= 1e-3


SCALE_ULPS, SCALE_ULPS_OWN_STATS, NORM_ULPS = 4, 16, 2


def _ulps_f32(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float((np.abs(got - ref) / np.spacing(np.abs(ref))).max())


def _fold(rng, b, c):
    a = (1 + 0.3 * rng.standard_normal((b, c))).astype(np.float32)
    bb = (0.5 * rng.standard_normal((b, c))).astype(np.float32)
    return a, bb


@pytest.mark.parametrize("shape", [(2, 16, 32, 128), (1, 8, 16, 320), (2, 8, 8, 64)])
def test_affine_silu_quant_plain_matches_pallas(shape):
    """K4's plain version against ``_affine_silu_quant_kernel`` on the same
    fold and the same 1 / scale (JAX's amax of silu(y), as
    ``gn_silu_conv3x3_int8`` computes it)."""
    rng = np.random.RandomState(sum(shape))
    xt, xj = _bf16_pair(rng.standard_normal(shape))
    a, bb = _fold(rng, shape[0], shape[-1])
    y = xj.astype(jnp.float32) * a[:, None, None] + bb[:, None, None]
    inv_scale = 1.0 / (jnp.maximum(jnp.max(jnp.abs(y * jax.nn.sigmoid(y))), 1e-8) / 127.0)
    with pltpu.force_tpu_interpret_mode():
        ref = jq.affine_silu_quant(xj, jnp.asarray(a), jnp.asarray(bb), inv_scale)
    before = _launches()
    out = tq.affine_silu_quant_op(xt, torch.from_numpy(a), torch.from_numpy(bb),
                                  torch.tensor(float(inv_scale), dtype=torch.float32))
    assert out.dtype == torch.int8 and out.shape == shape
    assert _steps_ok(out.numpy(), ref)
    assert (np.abs(out.numpy()) == 127).any()  # the tensor's amax reached the end of the grid
    assert _launches() == before


@pytest.mark.parametrize("r,c,norm_out", [(256, 128, True), (256, 128, False), (512, 320, True), (256, 640, False)])
def test_ln_quant_plain_matches_pallas(r, c, norm_out):
    """K7's plain version against ``_ln_quant_kernel`` (``ln_quant_rowwise``)."""
    rng = np.random.RandomState(r + c)
    xt, xj = _bf16_pair(rng.standard_normal((r, c)) * 2 + 0.3)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jn, jxq, jsc = jq.ln_quant_rowwise(xj, jnp.asarray(g), jnp.asarray(b), norm_out=norm_out)
    before = _launches()
    xn, xq, sc = tq.ln_quant_op(xt, torch.from_numpy(g), torch.from_numpy(b), 1e-5, norm_out)
    assert _launches() == before
    assert xq.dtype == torch.int8 and sc.shape == (r, 1)
    assert _steps_ok(xq.numpy(), jxq)
    assert _ulps_f32(sc.numpy(), jsc) <= SCALE_ULPS
    assert (xn is None) == (jn is None) == (not norm_out)
    if norm_out:
        assert xn.dtype == torch.bfloat16
        assert bf16_ulps(xn, torch.from_numpy(np.asarray(jn, np.float32)).to(torch.bfloat16)) <= NORM_ULPS


@pytest.mark.parametrize("shape,norm_out", [((2, 16, 32, 128), True), ((2, 8, 16, 256), False),
                                            ((1, 8, 8, 320), True)])
def test_gn_quant_plain_matches_pallas(shape, norm_out):
    """K8's plain version against ``_gn_affine_quant_kernel`` on JAX's fold,
    and ``gn_quant_rowwise`` with the port's own statistics against JAX's."""
    rng = np.random.RandomState(sum(shape))
    xt, xj = _bf16_pair(rng.standard_normal(shape) * 2 + 0.5)
    c = shape[-1]
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    xf = xj.astype(jnp.float32)
    a, bb = jq._gn_affine_ab(jnp.mean(xf, axis=(1, 2)), jnp.mean(xf * xf, axis=(1, 2)), jnp.asarray(g),
                             jnp.asarray(b), 32, 1e-6, None, None)
    with pltpu.force_tpu_interpret_mode():
        jn, jxq, jsc = jq.gn_quant_rowwise(xj, jnp.asarray(g), jnp.asarray(b), norm_out=norm_out)
    before = _launches()
    for (xn, xq, sc), scale_ulps in (
            (tq.gn_quant_op(xt, torch.from_numpy(np.array(a)), torch.from_numpy(np.array(bb)), norm_out), SCALE_ULPS),
            (tq.gn_quant_rowwise(xt, torch.from_numpy(g), torch.from_numpy(b), norm_out=norm_out),
             SCALE_ULPS_OWN_STATS)):
        assert xq.dtype == torch.int8 and sc.shape == (*shape[:3], 1)
        assert _steps_ok(xq.numpy(), jxq)
        assert _ulps_f32(sc.numpy(), jsc) <= scale_ulps
        assert (xn is None) == (not norm_out)
        if norm_out:
            assert bf16_ulps(xn, torch.from_numpy(np.asarray(jn, np.float32)).to(torch.bfloat16)) <= NORM_ULPS
    assert _launches() == before


@pytest.mark.parametrize("mode", ["plain", "emb", "scale_shift"])
def test_gn_affine_ab_matches_jax(mode):
    """The GroupNorm fold with the emb-add or the scale-shift (JAX
    ``_gn_affine_ab``): fp32 within 4 ulps of the largest entry."""
    rng = np.random.RandomState(3)
    b, c, g = 2, 256, 32
    x = rng.standard_normal((b, 8, 16, c)).astype(np.float32) * 2 + 0.7
    m_c, q_c = x.mean(axis=(1, 2)), (x * x).mean(axis=(1, 2))
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    emb = rng.standard_normal((b, c)).astype(np.float32) if mode == "emb" else None
    ss = tuple(0.3 * rng.standard_normal((b, c)).astype(np.float32) for _ in range(2)) if mode == "scale_shift" else None
    j = lambda v: None if v is None else jnp.asarray(v)
    t = lambda v: None if v is None else torch.from_numpy(v)
    ja, jb = jq._gn_affine_ab(j(m_c), j(q_c), j(gamma), j(beta), g, 1e-5, j(emb), None if ss is None else tuple(map(j, ss)))
    ta, tb = tq.gn_affine_ab(t(m_c), t(q_c), t(gamma), t(beta), g, 1e-5, t(emb), None if ss is None else tuple(map(t, ss)))
    for got, ref in ((ta, ja), (tb, jb)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (b, c)
        assert np.abs(got.numpy() - ref).max() <= 4 * np.spacing(np.abs(ref).max())


@pytest.mark.parametrize("mode", ["emb", "scale_shift"])
def test_gn_silu_conv3x3_int8_matches_jax(monkeypatch, mode):
    """The fused ResBlock conv stack: the port's statistics and fold, K4's
    plain version and KI1's against JAX's ``gn_silu_conv3x3_int8`` with the
    TPU dispatch forced and K4 and K5 in interpret mode, 16x32, 128 -> 128."""
    import leftrefill_tpu.ops.conv as jconv

    monkeypatch.setattr(jconv, "on_tpu", lambda: True)
    rng = np.random.RandomState(11)
    b, h, w, ci, co = 2, 16, 32, 128, 128
    xt, xj = _bf16_pair(rng.standard_normal((b, h, w, ci)))
    gamma = (1 + 0.1 * rng.standard_normal(ci)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(ci)).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(rng.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.05))
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    extra = rng.standard_normal((2, b, ci)).astype(np.float32)
    jkw = {"emb": jnp.asarray(extra[0])} if mode == "emb" else {"scale_shift": tuple(map(jnp.asarray, 0.3 * extra))}
    tkw = {k: (torch.from_numpy(np.array(v)) if k == "emb" else tuple(torch.from_numpy(np.array(u)) for u in v))
           for k, v in jkw.items()}
    assert jq.gn_silu_conv3x3_int8_qualifies(h, w, ci, co) and tq.gn_silu_conv3x3_int8_qualifies(h, w, ci, co)
    with pltpu.force_tpu_interpret_mode():
        ref = jq.gn_silu_conv3x3_int8(xj, jnp.asarray(gamma), jnp.asarray(beta), wq, ws, jnp.asarray(bias), **jkw)
    before = _launches()
    out = tq.gn_silu_conv3x3_int8(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                                  torch.from_numpy(np.ascontiguousarray(np.asarray(wq).transpose(3, 0, 1, 2))),
                                  torch.from_numpy(np.asarray(ws)), torch.from_numpy(bias), **tkw)
    assert _launches() == before
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, w, co)
    ref = np.asarray(ref, np.float32)
    assert rel_err(out.float().numpy(), ref) < BF16_REL
    assert rel_l2(out.float().numpy(), ref) < 3e-3


def test_ln_quant_rowwise_keeps_leading_dims():
    """The site wrapper: [B, N, C] in, x_norm [B, N, C], xq [B, N, C],
    scales [B, N, 1], as JAX's ``ln_quant_rowwise`` returns them."""
    x = torch.randn(2, 64, 96, dtype=torch.bfloat16)
    g, b = torch.ones(96), torch.zeros(96)
    xn, xq, sc = tq.ln_quant_rowwise(x, g, b, norm_out=True)
    assert xn.shape == xq.shape == (2, 64, 96) and sc.shape == (2, 64, 1)
    _, xq2, _ = tq.ln_quant_rowwise(x, g, b, norm_out=False)
    assert torch.equal(xq, xq2)
