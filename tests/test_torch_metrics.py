"""The port's validation metrics (``leftrefill_torch/eval/metrics.py``)
against the JAX package's on the same seeded NHWC images, fp32 on the CPU:
PSNR, the grey map, SSIM (scikit-image's uniform window and data range 2)
and the composited right-half protocol.  Tolerance 1e-5 relative (the same
fp32 sums in another order; SSIM's window means through a convolution)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import FP32_REL, rel_err, t

from leftrefill_tpu.eval import metrics as jm

from leftrefill_torch.eval import metrics as tm


def _images(seed: int, shape):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(shape), -1, 1).astype(np.float32)  # correlated, as a sample is
    return a, b


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 40, 24, 3)])
def test_psnr_and_grayscale_match_jax(shape):
    a, b = _images(0, shape)
    p01, o01 = (a + 1) / 2, (b + 1) / 2
    assert rel_err(tm.psnr(t(p01), t(o01)), jm.psnr(jnp.asarray(p01), jnp.asarray(o01))) < FP32_REL
    assert rel_err(tm.rgb_to_grayscale(t(p01)), jm.rgb_to_grayscale(jnp.asarray(p01))) < FP32_REL


@pytest.mark.parametrize("data_range,win", [(2.0, 7), (1.0, 7), (2.0, 5)])
def test_ssim_matches_jax(data_range, win):
    a, b = _images(1, (3, 30, 41, 1))
    got = tm.ssim(t(a[..., 0]), t(b[..., 0]), data_range=data_range, win_size=win)
    ref = jm.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]), data_range=data_range, win_size=win)
    assert got.shape == (3,) and 0 < float(got.min()) < 1
    assert rel_err(got, ref) < FP32_REL


@pytest.mark.parametrize("shape", [(2, 32, 64, 3), (2, 32, 32, 3)])
def test_composite_metrics_match_jax(shape):
    """A canvas wider than high keeps its right half; a square one is taken whole."""
    pred, origin = _images(2, shape)
    mask = np.zeros(shape[:3] + (1,), np.float32)
    mask[:, 8:24, shape[2] // 2 + 4:] = 1.0
    got = tm.composite_metrics(t(pred), t(origin), t(mask))
    ref = jm.composite_metrics(jnp.asarray(pred), jnp.asarray(origin), jnp.asarray(mask))
    assert got["composite"].shape == ref["composite"].shape
    for k in ("psnr", "ssim", "composite"):
        assert rel_err(got[k], ref[k]) < FP32_REL, k
    assert torch.isfinite(got["psnr"]).all()
