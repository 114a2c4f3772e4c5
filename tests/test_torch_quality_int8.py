"""The int8 quality study (``tools.quality.int8_study``) held to the steps
of ``scripts/tpu_r3_int8_quality.py`` on the CPU, at the tiny bundle, as
``test_torch_quality.py`` sets out (its helpers, draws and tolerances: fp32
numbers 1e-4 relative; int8 statistics 8 %; bf16 ones 15 %; a single
element and a trajectory's end 25 %)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quality import (B, MAX_REL, assert_eps_close, jax_eps_sweep, jax_generate, jax_modules, jax_params,
                                jax_request_draws, port_state, quantized, t)

from leftrefill_torch import tools
from leftrefill_torch.tools import quality


def test_int8_study_matches_jax():
    """Part (1): the eps sweep of the bf16 and fused int8 UNets against fp32
    at the five timesteps; part (2): bf16 against int8 through DDIM-20 at
    eta 1, CFG 2.5, both sides from JAX's x_T and step noise."""
    torch.set_num_threads(2)
    params = jax_params()
    jm32, jm16, jm8 = jax_modules(), jax_modules(jnp.bfloat16), jax_modules(jnp.bfloat16, quant=True)
    qparams = quantized(jm8, params)
    x = jax.random.normal(jax.random.PRNGKey(0), (B, 16, 32, 9), jnp.float32)
    ctx = jax.random.normal(jax.random.PRNGKey(1), (B, 77, 24), jnp.float32) * 0.5
    apply = lambda m, p: jax.jit(lambda xx, tt, cc: m.unet.apply({"params": p["unet"]}, xx, tt, cc))  # noqa: E731
    ref_eps = jax_eps_sweep({"fp32": apply(jm32, params), "bf16": apply(jm16, params), "int8": apply(jm8, qparams)},
                            x, ctx)

    image, mask = tools.request_canvas(side=quality.TINY.side)
    steps = 20  # the study's 50 cut to 20: the same loop, a shorter test
    x_T, draws = jax_request_draws((1, 16, 32, 4), steps)
    arch = quality.TINY
    pipe = quality.pipeline(arch, None, "cpu")
    key = jax.random.PRNGKey(quality.SEED)
    a = jax_generate(jm16, params, image, mask, pipe, key, x_T, steps, 1.0)
    b = jax_generate(jm8, qparams, image, mask, pipe, key, x_T, steps, 1.0)

    got = quality.int8_study("cpu", arch=arch, state=port_state(params), steps=steps,
                             draws={"x": t(x), "ctx": t(ctx), **draws})
    assert_eps_close(got["eps"], ref_eps)
    ab = got["pipeline_ab"]
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    assert ab["mse"] == pytest.approx(mse, rel=MAX_REL), (ab, mse)
    assert 10 * np.log10(4 / ab["mse"]) == pytest.approx(ab["psnr_bf16_vs_int8_db"])
    assert ab["maxdiff"] == pytest.approx(float(np.abs(a - b).max()), rel=MAX_REL)
