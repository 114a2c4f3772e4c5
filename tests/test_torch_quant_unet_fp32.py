"""The tiny int8 UNet of test_torch_quant_unet.py computing in fp32 on both
sides.  JAX gates its int8 GEGLU and proj_out kernels on bf16, so here it
reaches K5 and K6 only (writing fp32, as KI1 then does) and the
transformers take the two-dense int8 fallbacks, which the port mirrors.
With fp32 around the int8 sites the teacher-forced block errors are those
of single int8 steps, which makes this the tight check of the convolutional
int8 wiring (per-tensor scales, the skip 1x1s, the Upsample conv), where the
bf16 twin cannot tell a sound block from its control.
Tolerances and their reasons: test_torch_quant_unet.py.  In a file of its
own: the interpreted JAX forward takes most of a minute."""

import numpy as np

from test_torch_quant_unet import check_blocks, run_tiny_int8_unets


def test_tiny_int8_unet_fp32_matches_jax(monkeypatch):
    r = run_tiny_int8_unets(monkeypatch, "float32")
    assert r["calls"] == {"conv3x3_int8_copy3_pre": 7, "conv3x3_int8_single_pre": 10}
    assert r["sites"] == {"conv3x3_int8": 17}  # KI1 writes fp32 too, as K5/K6 do
    assert max(r["block_errs"].values()) < 1e-2, r["block_errs"]
    check_blocks(r, ("ResBlock", "Upsample"), 1e-3)
    out, ref = r["out"], r["ref"]
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 6e-2
