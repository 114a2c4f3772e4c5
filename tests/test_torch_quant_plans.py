"""The port's copies of the int8 TPU kernels' VMEM plans and dispatch rules
against the JAX package's originals (its TPU probe forced on), at every
full-width site shape of the int8 UNet forward and at the test shapes.
Exact equality: the rules decide which function a site computes."""

import pytest

import leftrefill_tpu.ops.conv as jconv
from leftrefill_tpu.ops import mlp as jmlp
from leftrefill_tpu.ops import quant as jquant

from leftrefill_torch.ops import mlp as tmlp
from leftrefill_torch.ops import quant as tquant

# (h, w, ci, co): the 47 int8 conv sites' shapes at full width, the tiny
# int8 UNet's, and shapes either rule must refuse
CONV_SHAPES = [
    (64, 128, 320, 320), (64, 128, 640, 320), (64, 128, 960, 320), (64, 128, 640, 640),
    (32, 64, 320, 640), (32, 64, 640, 640), (32, 64, 960, 640), (32, 64, 1280, 640),
    (32, 64, 1920, 640), (32, 64, 1280, 1280),
    (16, 32, 640, 1280), (16, 32, 1280, 1280), (16, 32, 1920, 1280), (16, 32, 2560, 1280),
    (8, 16, 1280, 1280), (8, 16, 2560, 1280),
    (16, 32, 128, 128), (16, 32, 256, 128), (16, 32, 256, 256), (16, 32, 384, 128),
    (8, 16, 128, 256), (8, 16, 256, 256), (8, 16, 384, 256), (8, 16, 512, 256),
    (16, 16, 192, 128), (8, 16, 160, 96),
    (64, 128, 9, 320), (4, 8, 1280, 1280), (8, 16, 320, 4),
]
# (b, rows per sample, k, n): the 16 proj_out sites at full width (ds1 fails
# k % 128), the tiny UNet's and the module test's
DENSE_SHAPES = [
    (2, 8192, 320, 320), (2, 2048, 640, 640), (2, 512, 1280, 1280), (2, 128, 1280, 1280),
    (2, 512, 128, 128), (2, 128, 256, 256), (1, 128, 128, 128), (2, 100, 128, 128),
]
# (r, din, inner, dout): the 16 feed-forwards at full width, then test shapes
GEGLU_SHAPES = [
    (16384, 320, 1280, 320), (4096, 640, 2560, 640), (1024, 1280, 5120, 1280),
    (256, 1280, 5120, 1280),
    (1024, 128, 512, 128), (256, 256, 1024, 256), (128, 128, 512, 128), (256, 128, 512, 128),
    (96, 128, 512, 128), (128, 32, 128, 32),
]


@pytest.fixture
def on_tpu(monkeypatch):
    monkeypatch.setattr(jconv, "on_tpu", lambda: True)


@pytest.mark.parametrize("h,w,ci,co", CONV_SHAPES)
def test_conv_int8_plans_and_rule_match_jax(on_tpu, h, w, ci, co):
    assert tquant.plan_int8(h, w, ci, co) == jquant._plan_int8(h, w, ci, co)
    assert tquant.plan_int8_single(h, w, ci, co) == jquant._plan_int8_single(h, w, ci, co)
    assert tquant.conv3x3_int8_qualifies(h, w, ci, co) == jquant.conv3x3_int8_qualifies(h, w, ci, co)


def test_every_full_width_conv_site_qualifies():
    assert all(tquant.conv3x3_int8_qualifies(*s) for s in CONV_SHAPES[:16])


@pytest.mark.parametrize("b,rows,k,n", DENSE_SHAPES)
def test_dense_res_plan_and_rule_match_jax(on_tpu, b, rows, k, n):
    assert tquant.plan_dense_rows(rows, k, n) == jquant._plan_dense_rows(rows, k, n)
    assert tquant.dense_int8_res_qualifies(b, rows, k, n) == jquant.dense_int8_res_mom_qualifies(b, rows, k, n)


@pytest.mark.parametrize("r,din,inner,dout", GEGLU_SHAPES)
def test_geglu_int8_plan_and_rule_match_jax(on_tpu, r, din, inner, dout):
    assert tmlp.geglu_int8_plan(r, din, inner, dout) == jmlp._plan(r, din, inner, dout, 1, 1)
    ok = jmlp.geglu_fused_qualifies(r, din, inner, dout, True)
    assert tmlp.geglu_int8_qualifies(r, din, inner, dout) == ok
    if ok:
        assert tmlp.geglu_int8_chunk(r, din, inner, dout) == jmlp._plan(r, din, inner, dout, 1, 1)[1]


# (r, c): the 48 prenorm sites' shapes at full width (CFG batch 2, the first
# transformer's norm1 at half batch), the multi-view V=4 ones, test shapes
LN_SHAPES = [(8192, 320), (16384, 320), (4096, 640), (1024, 1280), (256, 1280), (32768, 320), (8192, 640),
             (2048, 1280), (512, 1280), (1024, 128), (512, 128), (256, 256), (96, 128), (100, 64), (64, 20000)]


@pytest.mark.parametrize("r,c", LN_SHAPES)
def test_ln_quant_plan_and_rule_match_jax(on_tpu, r, c):
    assert tquant.plan_ln_rows(r, c) == jquant._plan_ln_rows(r, c)
    assert tquant.ln_quant_qualifies(r, c) == jquant.ln_quant_qualifies(r, c)


@pytest.mark.parametrize("h,w,c", [(64, 128, 320), (8, 16, 1280), (64, 64, 320), (16, 32, 128), (8, 12, 256),
                                   (8, 16, 100)])
def test_fused_conv_and_gn_rules_match_jax(on_tpu, h, w, c):
    assert tquant.gn_quant_qualifies(h, w, c) == jquant.gn_quant_qualifies(h, w, c)
    assert tquant.gn_silu_conv3x3_int8_qualifies(h, w, c, c) == jquant.gn_silu_conv3x3_int8_qualifies(h, w, c, c)


def test_full_width_geglu_chunk_widths():
    """The requant chunk is part of the function: 640 / 640 / 256 / 640."""
    assert [tmlp.geglu_int8_chunk(*s) for s in GEGLU_SHAPES[:4]] == [640, 640, 256, 640]
