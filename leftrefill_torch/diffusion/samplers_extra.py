"""The samplers beside DDIM (counterpart of
``leftrefill_tpu/diffusion/samplers_extra.py``): the full-schedule DDPM
ancestral loop ``ddpm_sample``, PLMS ``plms_sample`` and DPM-Solver++(2M)
``dpm_solver_pp_2m_sample``.

DPM-Solver++(2M): time-uniform continuous grid over the discrete schedule,
the model called at float timesteps, a first-order first step, second-order
multistep updates, and a first-order last step below 15 steps.
Deterministic given x_T, as PLMS."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from leftrefill_torch import trace
from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.diffusion.ddim import ApplyFn, NoiseFn, _guided_eps, _step_tables, default_noise_fn
from leftrefill_torch.diffusion.schedules import DDIMTables, DiffusionSchedule, eps_from_z_and_v, start_from_z_and_v


def ddpm_sample(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    cond: Conditioning,
    shape: tuple,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
    temperature: float = 1.0,
    return_x0_every: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    device=None,
):
    """Ancestral sampling over every timestep of ``schedule``, largest
    first: x_{t-1} = posterior mean(x0, x_t) + exp(0.5 log var) * noise *
    ``temperature``, no noise at t = 0; x0 from eps (or from v), clipped to
    [-1, 1] with ``clip_denoised``.  ``noise_fn(t, shape)`` gives the noise
    at timestep t (JAX, with its key split first into (key, x_T's key):
    ``fold_in(key, t)``); by default it is drawn from ``generator``.

    ``return_x0_every=k`` (k divides the number of timesteps) also returns
    the x0 prediction at the end of each k-step chunk: ``(img, [n / k,
    *shape])``."""
    n = schedule.num_timesteps
    if return_x0_every is not None and n % return_x0_every:
        raise ValueError(f"return_x0_every={return_x0_every} must divide num_timesteps={n}")
    uncond_ = uncond if guidance_scale != 1.0 else None
    img = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)
    device = img.device
    noise_fn = noise_fn or default_noise_fn(generator, device)
    tabs = ddpm_tables(schedule, device)
    x0s = []
    for step, t in enumerate(range(n - 1, -1, -1)):
        noise = noise_fn(t, tuple(img.shape)) * temperature if t > 0 else None
        img, x0 = ddpm_step(apply_fn, tabs, img, t, cond, uncond_, guidance_scale, clip_denoised, noise)
        if return_x0_every is not None and (step + 1) % return_x0_every == 0:
            x0s.append(x0)
    if return_x0_every is None:
        return img
    return img, torch.stack(x0s)


def ddpm_tables(schedule: DiffusionSchedule, device) -> dict:
    """The schedule's per-timestep fp32 tables that a DDPM step reads, and
    whether its model predicts v."""
    col = lambda a: trace.to_device(np.asarray(a, np.float32), device=device)
    return {"sqrt_recip": col(schedule.sqrt_recip_alphas_cumprod),
            "sqrt_recipm1": col(schedule.sqrt_recipm1_alphas_cumprod),
            "c1": col(schedule.posterior_mean_coef1), "c2": col(schedule.posterior_mean_coef2),
            "std": torch.exp(0.5 * col(schedule.posterior_log_variance_clipped)),
            "sa": col(schedule.sqrt_alphas_cumprod), "s1m": col(schedule.sqrt_one_minus_alphas_cumprod),
            "v": schedule.predicts_v()}


def ddpm_step(apply_fn: ApplyFn, tabs: dict, img: torch.Tensor, t: int, cond: Conditioning,
              uncond: Optional[Conditioning], guidance_scale: float, clip_denoised: bool = False,
              noise: Optional[torch.Tensor] = None):
    """One ancestral step of ``ddpm_sample`` at timestep t (``tabs`` from
    ``ddpm_tables``; ``noise``, already scaled by the temperature, or None
    for none): (x_{t-1}, the x0 prediction)."""
    tt = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
    out = _guided_eps(apply_fn, img, tt, cond, uncond, guidance_scale)
    if tabs["v"]:
        x0 = start_from_z_and_v(img, out, tabs["sa"][t], tabs["s1m"][t])
    else:
        x0 = tabs["sqrt_recip"][t] * img - tabs["sqrt_recipm1"][t] * out
    if clip_denoised:
        x0 = torch.clamp(x0, -1.0, 1.0)
    mean = tabs["c1"][t] * x0 + tabs["c2"][t] * img
    return (mean if noise is None else mean + tabs["std"][t] * noise), x0


def _ddim_x_prev(x, e_t, a_t, a_prev):
    """The eta = 0 DDIM update PLMS steps with (a_t, a_prev: 0-d fp32)."""
    pred_x0 = (x - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * e_t


def plms_sample(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    tables: DDIMTables,
    cond: Conditioning,
    shape: tuple,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """PLMS: pseudo linear multistep on eps over the DDIM tables.  The first
    step is improved Euler (Heun: a second model call at the next timestep,
    or at 0 for a one-step table, and the mean of the two eps); step i >= 1
    combines its eps with the last ones (the history starts as three copies
    of the first eps) at order min(i, 3) + 1 (Adams-Bashforth 2, 3, 4), each
    step an eta = 0 DDIM update.  A v-predicting model is refused, as JAX
    asserts."""
    if schedule.predicts_v():
        raise ValueError("PLMS operates on eps predictions; this schedule's model predicts v")
    uncond_ = uncond if (uncond is not None and guidance_scale != 1.0) else None
    x = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)
    device = x.device
    t_steps, a_t, a_prev, _, _, _ = _step_tables(tables, schedule, device)
    n, b = tables.num_steps, shape[0]
    full = lambda t: torch.full((b,), int(t), dtype=torch.long, device=device)

    e_t = _guided_eps(apply_fn, x, full(t_steps[0]), cond, uncond_, guidance_scale)
    x_prev0 = _ddim_x_prev(x, e_t, a_t[0], a_prev[0])
    e_next = _guided_eps(apply_fn, x_prev0, full(t_steps[1] if n > 1 else 0), cond, uncond_, guidance_scale)
    x = _ddim_x_prev(x, (e_t + e_next) / 2, a_t[0], a_prev[0])
    hist = [e_t, e_t, e_t]  # most recent first
    for i in range(1, n):
        e_t = _guided_eps(apply_fn, x, full(t_steps[i]), cond, uncond_, guidance_scale)
        o1, o2, o3 = hist
        order = min(i, 3)
        if order == 1:
            e_prime = (3 * e_t - o1) / 2
        elif order == 2:
            e_prime = (23 * e_t - 16 * o1 + 5 * o2) / 12
        else:
            e_prime = (55 * e_t - 59 * o1 + 37 * o2 - 9 * o3) / 24
        x = _ddim_x_prev(x, e_prime, a_t[i], a_prev[i])
        hist = [e_t, o1, o2]
    return x


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
    with trace.span("sample"):
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

        with trace.span("sample.step", i=0):
            m_prev = x0_of(x, t_input[0], alpha[0], sigma[0])
            h = lam[1] - lam[0]
            x = f32(sigma[1] / sigma[0]) * x - f32(alpha[1] * np.expm1(-h)) * m_prev
        last_first_order = steps < 15
        hi = steps - 1 if last_first_order else steps
        for i in range(2, hi + 1):
            with trace.span("sample.step", i=i - 1):
                h_i = lam[i] - lam[i - 1]
                c_m = f32(alpha[i] * np.expm1(-h_i))
                m_cur = x0_of(x, t_input[i - 1], alpha[i - 1], sigma[i - 1])
                d1 = (m_cur - m_prev) * f32(h_i / (lam[i - 1] - lam[i - 2]))
                x = f32(sigma[i] / sigma[i - 1]) * x - c_m * m_cur - f32(0.5 * np.float32(c_m)) * d1
                m_prev = m_cur
        if last_first_order and steps >= 2:
            with trace.span("sample.step", i=steps - 1):
                m_cur = x0_of(x, t_input[steps - 1], alpha[steps - 1], sigma[steps - 1])
                h = lam[steps] - lam[steps - 1]
                x = f32(sigma[steps] / sigma[steps - 1]) * x - f32(alpha[steps] * np.expm1(-h)) * m_cur
        return x
