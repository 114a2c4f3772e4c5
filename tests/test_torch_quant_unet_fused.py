"""The tiny int8 UNet of test_torch_quant_unet.py in JAX's default int8
configuration (``LEFTREFILL_FUSED_RES`` and ``LEFTREFILL_FUSED_LNQ`` on) on
the JAX side and the port's default ``fused=True`` UNet, bf16: every ResBlock
conv stack runs GN + SiLU + quantize through K4 into KI1, the transformer
prenorms through K7 and the SpatialTransformer GN into proj_in through K8.
The bounds are test_torch_quant_unet.py's, and the control (int8 activations
off, the prologues' fp32 values handed on unquantized) must fail the
block-wise ones.

One difference from the unfused arm.  The fused prologues quantize fp32
normalized values, where the unfused arm quantizes a bf16 GroupNorm or
LayerNorm output: the bf16 rounding there absorbs the last-bit differences
between the two sides (XLA on the CPU contracts x * a + b into an FMA, the
port rounds the multiply and the add apart, as its kernels do), here they
move int8 steps, and the attention inside a transformer spreads them.  So
the transformer blocks are held two ways, each with the control outside the
bound at every block:
- taken together, over all their elements, within 3e-3 (the unfused arm's
  per-block bound);
- each within 6.5e-3.
Two teacher-forced runs, measured (transformers together; the largest
block; the control 8.3e-3 together and 7.1e-3..1.2e-2 per block):
- with JAX's GroupNorm statistics and fold (``jax_gn_moments``,
  ``jax_gn_affine_ab``), which leaves the K4/K7/K8 paths' own differences:
  2.7e-3; 5.7e-3;
- with the port's own statistics and fold, as the model runs them: 3.5e-3
  (so only the per-block bound is asserted); 6.3e-3.
The ResBlocks keep the max-abs bound (measured at most 1.1e-2 in both runs;
the bf16 ResBlock does not separate from its control, as in the unfused
arm).  End to end: measured 4.7e-2 (the control 3.9e-2: this bound checks
scale only)."""

import numpy as np

from test_torch_parity_utils import BF16_REL
from test_torch_quant_unet import check_blocks, run_tiny_int8_unets

ST = ("SpatialTransformer",)
BLOCK_L2 = 6.5e-3  # every transformer block of the fused arm, JAX's statistics or the port's


def check_fused_blocks(r) -> None:
    """The fused arm's block-wise bounds, shared with the multi-view test."""
    for errs in ("block_errs", "own_block_errs"):
        assert max(r[errs].values()) < BF16_REL, r[errs]
    check_blocks(r, ST, 3e-3, aggregate=True)
    check_blocks(r, ST, BLOCK_L2)
    check_blocks(r, ST, BLOCK_L2, errs="own_block_l2")


def test_tiny_fused_int8_unet_matches_jax(monkeypatch):
    r = run_tiny_int8_unets(monkeypatch, "bfloat16", fused=True)
    # 8 ResBlocks x 2 fused conv stacks and the Upsample conv; 7 transformers
    assert r["calls"] == {"affine_silu_quant": 16, "conv3x3_int8_copy3_pre": 7, "conv3x3_int8_single_pre": 10,
                          "ln_quant_rowwise": 21, "gn_quant_rowwise": 7, "dense_int8_res_mom": 7,
                          "geglu_fused_int8": 7}
    assert r["sites"] == {"affine_silu_quant": 16, "conv3x3_int8": 17, "ln_quant": 21, "gn_quant": 7,
                          "dense_int8_res": 7, "geglu_int8": 7}
    check_fused_blocks(r)
    out, ref = r["out"], r["ref"]
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 6e-2
