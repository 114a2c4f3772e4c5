"""DPM-Solver++(2M) (counterpart of
``leftrefill_tpu/diffusion/samplers_extra.py:dpm_solver_pp_2m_sample``):
time-uniform continuous grid over the discrete schedule, the model called at
float timesteps, a first-order first step, second-order multistep updates,
and a first-order last step below 15 steps.  Deterministic given x_T."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.diffusion.ddim import ApplyFn, _guided_eps
from leftrefill_torch.diffusion.schedules import DiffusionSchedule, eps_from_z_and_v


def dpm_solver_pp_2m_sample(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    cond: Conditioning,
    shape: tuple,
    num_steps: int,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """``schedule``: the model's training schedule (its alphas_cumprod make
    the grid; a "v" parameterization has each model output turned into eps,
    alpha v + sigma x, as JAX's ``x0_of_t``)."""
    predicts_v = schedule.predicts_v()
    uncond_ = uncond if (uncond is not None and guidance_scale != 1.0) else None
    b = shape[0]
    alphas_cumprod = schedule.alphas_cumprod
    n_train = len(alphas_cumprod)
    steps = num_steps
    x = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)

    # grid and schedule functions, host-side in float64
    log_ac = 0.5 * np.log(np.asarray(alphas_cumprod, np.float64))
    t_array = np.arange(1, n_train + 1, dtype=np.float64) / n_train
    ts = np.linspace(1.0, 1.0 / n_train, steps + 1)
    log_alpha = np.interp(ts, t_array, log_ac)
    alpha = np.exp(log_alpha)
    sigma = np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_alpha), 1e-20))
    lam = log_alpha - np.log(sigma)
    t_input = (ts - 1.0 / n_train) * 1000.0
    f32 = lambda v: float(np.float32(v))  # fp32-rounded coefficients, as JAX

    def x0_of(x, t, a, s):
        tvec = torch.full((b,), f32(t), dtype=torch.float32, device=x.device)
        out = _guided_eps(apply_fn, x, tvec, cond, uncond_, guidance_scale)
        if predicts_v:
            out = eps_from_z_and_v(x, out, f32(a), f32(s))
        return (x - f32(s) * out) / f32(a)

    m_prev = x0_of(x, t_input[0], alpha[0], sigma[0])
    h = lam[1] - lam[0]
    x = f32(sigma[1] / sigma[0]) * x - f32(alpha[1] * np.expm1(-h)) * m_prev
    last_first_order = steps < 15
    hi = steps - 1 if last_first_order else steps
    for i in range(2, hi + 1):
        h_i = lam[i] - lam[i - 1]
        c_m = f32(alpha[i] * np.expm1(-h_i))
        m_cur = x0_of(x, t_input[i - 1], alpha[i - 1], sigma[i - 1])
        d1 = (m_cur - m_prev) * f32(h_i / (lam[i - 1] - lam[i - 2]))
        x = f32(sigma[i] / sigma[i - 1]) * x - c_m * m_cur - f32(0.5 * np.float32(c_m)) * d1
        m_prev = m_cur
    if last_first_order and steps >= 2:
        m_cur = x0_of(x, t_input[steps - 1], alpha[steps - 1], sigma[steps - 1])
        h = lam[steps] - lam[steps - 1]
        x = f32(sigma[steps] / sigma[steps - 1]) * x - f32(alpha[steps] * np.expm1(-h)) * m_cur
    return x
