"""The solver study (``tools.quality.solver_study``) held to the steps of
``scripts/tpu_r5_solver_quality.py`` (with its CPU precursor
``scripts/cpu_dpm20_quality.py``'s bundle: the tiny one, fp32) on the CPU:
JAX's ``_generate`` for each run from one x_T (``normal(PRNGKey(7))``), the
eta-1 runs' step noise from ``PRNGKey(0)``, and the port's pipeline fed the
same draws, on the same weights (``test_torch_quality.py``'s helpers).

Every run is fp32 on both sides, so the PSNRs agree within 0.05 dB
(measured within 1e-3 dB): two fp32 trajectories of up to 200 steps differ
by their sums' order only.  Four of the seven runs: the gold DDIM-200 and
DPM++(2M)-15 at eta 0, DDIM-50 and -200 at eta 1 (each sampler, both eta
families and the eta-1 runs' shared noise; the other three differ from
these by their step counts only, and each run costs JAX a compile)."""

from __future__ import annotations

import jax
import pytest
import torch

from test_torch_quality import DB_FP32, jax_generate, jax_modules, jax_params, port_state, psnr_np, t

from leftrefill_tpu.models.autoencoder import DiagonalGaussian
from leftrefill_torch import tools
from leftrefill_torch.tools import quality

RUNS = {k: quality.SOLVER_RUNS[k] for k in ("gold_ddim200", "dpm15", "ddim50_eta1", "ddim200_eta1")}


def test_solver_study_matches_jax():
    torch.set_num_threads(2)
    params = jax_params()
    jm = jax_modules()
    arch = quality.TINY
    image, mask = tools.request_canvas(side=arch.side)
    pipe = quality.pipeline(arch, None, "cpu")
    shape = (1, 16, 32, 4)
    x_T = jax.random.normal(jax.random.PRNGKey(quality.SEED), shape)
    key = jax.random.PRNGKey(0)  # shared: the eta-1 runs draw their step noise here
    step_key = jax.random.split(key)[0]
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape) for i in range(200)]
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape)
    outs = {name: jax_generate(jm, params, image, mask, pipe, key, x_T, steps, eta, sampler)[:, :, arch.side:]
            for name, (sampler, steps, eta) in RUNS.items()}

    got = quality.solver_study("cpu", arch=arch, state=port_state(params), dtype=torch.float32, runs=RUNS,
                               draws={"x_T": t(x_T), "noise_fn": lambda i, s: t(noise[i]), "vae_noise": t(vae_noise)})
    assert got["dtype"] == "float32"
    gold = outs["gold_ddim200"]
    for name in RUNS:
        if name != "gold_ddim200":
            want = psnr_np(outs[name], gold)
            assert got[name]["psnr_vs_gold_db"] == pytest.approx(want, abs=DB_FP32), (name, got[name], want)
    spread = got["eta1_self_spread"]["psnr_ddim50eta1_vs_ddim200eta1_db"]
    assert spread == pytest.approx(psnr_np(outs["ddim50_eta1"], outs["ddim200_eta1"]), abs=DB_FP32)
    assert "dpm15_vs_ddim50eta0" not in got  # its run is not among RUNS
    # the study measures something: the eta-0 run converges on gold, the eta-1 ones do not
    assert got["dpm15"]["psnr_vs_gold_db"] > 30 > got["ddim50_eta1"]["psnr_vs_gold_db"]
