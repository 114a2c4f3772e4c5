"""The port's 1-reference inpainting pipeline against JAX ``_generate`` on
the CPU in fp32: DDIM, 4 steps, eta 1, CFG 2.5, tiny bundle, the same
weights, x_T, per-step noise and VAE noise on both sides, for a schedule
(and model) of each parameterization the samplers know: eps (SD2
inpainting) and v.  Tolerance: the right half within 1e-4 absolute (see
test_torch_parity_utils); the left half is the input exactly."""

import numpy as np
import pytest

from test_torch_parity_utils import CANVAS_ABS, run_both_pipelines


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_ddim_canvas_matches_jax(parameterization):
    out, ref, image = run_both_pipelines("ddim", parameterization=parameterization)
    assert out.shape == ref.shape == image.shape == (1, 32, 64, 3)
    assert np.array_equal(out[:, :, :32], image[:, :, :32])
    assert np.abs(out[:, :, 32:] - ref[:, :, 32:]).max() < CANVAS_ABS
    assert not np.allclose(out[:, :, 32:], image[:, :, 32:])


def test_one_step_ddim_matches_jax():
    """A single DDIM step (the tables' reversed one-element views once kept
    their negative stride and were refused by torch)."""
    out, ref, image = run_both_pipelines("ddim", steps=1)
    assert np.abs(out[:, :, 32:] - ref[:, :, 32:]).max() < CANVAS_ABS
    assert np.array_equal(out[:, :, :32], image[:, :, :32])
