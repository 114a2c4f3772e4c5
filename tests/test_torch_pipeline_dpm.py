"""The port's pipeline with DPM-Solver++(2M) (4 steps, float UNet timesteps)
against JAX ``_generate`` on the CPU in fp32, with the same weights, x_T and
VAE noise, for an eps and a v schedule (and model).  Tolerance: the right
half within 1e-4 absolute (see test_torch_parity_utils); the left half is
the input exactly."""

import numpy as np
import pytest

from test_torch_parity_utils import CANVAS_ABS, run_both_pipelines


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_dpm_canvas_matches_jax(parameterization):
    out, ref, image = run_both_pipelines("dpm++2m", parameterization=parameterization)
    assert out.shape == ref.shape == image.shape == (1, 32, 64, 3)
    assert np.array_equal(out[:, :, :32], image[:, :, :32])
    assert np.abs(out[:, :, 32:] - ref[:, :, 32:]).max() < CANVAS_ABS
