"""The tiny multi-view UNet (V=2) in W8A8 int8, JAX's default configuration
(both fusion flags on, TPU dispatch forced, Pallas kernels in interpret
mode) against the port's ``fused=True`` multi-view UNet, bf16: the fused
LN + quant prenorms (K7) around the regrouped joint self-attention, the
per-view cross-attention and the int8 feed-forward, with K4, K8 and the KI
kernels around them.  One scene of two 16x32 views, through the harness of
test_torch_quant_unet.py: block by block, teacher-forced, with the bounds
of the fused single-view test (test_torch_quant_unet_fused.py) and the
control outside them at every transformer block.  Measured (transformers
together; the largest block): with JAX's GroupNorm statistics 2.7e-3;
4.5e-3, with the port's own 3.1e-3; 5.4e-3, the control 8.3e-3;
7.1e-3..1.2e-2; every block's max-abs at most 1.0e-2 of its max|ref|.  End
to end, free-running: 4.6e-2 (the control 3.8e-2: a scale check only).  In
a file of its own: the interpreted JAX forward takes most of a minute."""

from collections import Counter

import numpy as np

from test_torch_quant_unet import run_tiny_int8_unets
from test_torch_quant_unet_fused import check_fused_blocks


def test_tiny_multiview_int8_unet_matches_jax(monkeypatch):
    r = run_tiny_int8_unets(monkeypatch, "bfloat16", fused=True, views=2)
    assert r["out"].shape == (2, 16, 32, 4)
    # the same K7 sites as JAX's, rows for rows: each transformer's norm1 over
    # the two views' joint sequence, norm2 and norm3 per view
    jax_rows, port_rows = Counter(), Counter()
    for (name, shape), n in r["shapes"].items():
        if name == "ln_quant_rowwise":
            jax_rows[int(np.prod(shape[:-1]))] += n
    for (name, shape), n in r["site_shapes"].items():
        if name == "ln_quant":
            port_rows[shape[0]] += n
    assert port_rows == jax_rows
    assert sum(jax_rows.values()) == 21
    assert r["shapes"]["ln_quant_rowwise", (1, 1024, 128)] == 3  # ds-1 norm1: two 16x32 views jointly
    assert {"affine_silu_quant", "conv3x3_int8", "gn_quant"} <= set(r["sites"])
    check_fused_blocks(r)
    out, ref = r["out"], r["ref"]
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 6e-2
