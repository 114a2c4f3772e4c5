"""DDIM sampling with batched classifier-free guidance (counterpart of
``leftrefill_tpu/diffusion/ddim.py``): ``ddim_sample`` (with the
known-region renoise, temperature, per-step guidance scales and the per-step
intermediates), the multi-cond ``ddim_multi_sample``, and DDIM inversion:
``ddim_stochastic_encode``, ``ddim_encode`` and ``ddim_decode``.  The step
loop is a Python loop; the initial latent and every random stream (the
per-step noise, the renoise, the multi-cond sampler's picks) are injectable
so a run can be held against the JAX sampler, whose ``jax.random`` streams
torch cannot reproduce."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from leftrefill_torch import trace
from leftrefill_torch.diffusion.schedules import DDIMTables, DiffusionSchedule, eps_from_z_and_v, start_from_z_and_v

from leftrefill_torch.diffusion.core import Conditioning

ApplyFn = Callable[[torch.Tensor, torch.Tensor, Conditioning], torch.Tensor]
# noise source: (step index, shape) -> standard normal fp32 tensor
NoiseFn = Callable[[int, tuple], torch.Tensor]
# multi-cond pick: (step index, number of latents) -> the latent whose right half is kept
PickFn = Callable[[int, int], int]


def _guided_eps(apply_fn: ApplyFn, x, t, cond: Conditioning, uncond: Optional[Conditioning], scale):
    """One CFG-doubled model call ([uncond; cond]) -> guided model output."""
    if uncond is None:
        return apply_fn(x, t, cond)
    out = apply_fn(torch.cat([x, x]), torch.cat([t, t]), cond.concat_batch(uncond))
    out_uncond, out_cond = out.chunk(2, dim=0)
    return out_uncond + scale * (out_cond - out_uncond)


def _ddim_update(x, out, a_t, a_prev, sqrt_one_minus_at, sigma, noise, v_coef=None, temperature: float = 1.0):
    """x_t -> (x_{t-1}, pred_x0); the table entries are 0-d fp32 tensors so
    the arithmetic stays in fp32.  With ``v_coef`` (the training schedule's
    sqrt(alphas_cumprod[t]) and sqrt(1 - alphas_cumprod[t])) the model output
    is v, turned into eps and x0 as JAX's ``predict_*_from_z_and_v``; else it
    is eps.  The noise term is ``sigma * noise * temperature``, JAX's order."""
    if v_coef is not None:
        e_t, pred_x0 = eps_from_z_and_v(x, out, *v_coef), start_from_z_and_v(x, out, *v_coef)
    else:
        e_t = out
        pred_x0 = (x - sqrt_one_minus_at * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e_t
    return torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise * temperature, pred_x0


def default_noise_fn(generator: Optional[torch.Generator], device) -> NoiseFn:
    """Per-step noise drawn from the caller's generator on the device."""
    return lambda i, shape: torch.randn(shape, generator=generator, device=device)


def _step_tables(tables: DDIMTables, schedule: DiffusionSchedule, device):
    """(t, a_t, a_prev, sqrt(1 - a_t), sigma, v) per step, largest t first;
    v is the training schedule's (sqrt(alphas_cumprod[t]), sqrt(1 -
    alphas_cumprod[t])) where its model predicts v, else None."""
    t = tables.timesteps[::-1].astype("int64")

    def col(a):  # a copy: a one-step table's reversed view keeps its negative stride through ascontiguousarray
        return trace.to_device(np.array(a), torch.float32, device)

    v = (col(schedule.sqrt_alphas_cumprod[t]), col(schedule.sqrt_one_minus_alphas_cumprod[t])
         ) if schedule.predicts_v() else None
    return (t, col(tables.alphas[::-1]), col(tables.alphas_prev[::-1]), col(tables.sqrt_one_minus_alphas[::-1]),
            col(tables.sigmas[::-1]), v)


def _step_v(v, i: int):
    """Step i's v coefficients (``_step_tables``), or None for an eps model."""
    return None if v is None else (v[0][i], v[1][i])


def ddim_sample(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    tables: DDIMTables,
    cond: Conditioning,
    shape: tuple,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    device=None,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    ucg_schedule: Optional[Sequence[float]] = None,
    return_intermediates: bool = False,
    renoise_fn: Optional[NoiseFn] = None,
):
    """The DDIM loop over the tables in descending t; returns the final
    latent.  ``schedule`` is the model's training schedule, whose
    parameterization says what the model predicts.

    ``mask``/``x0``: the latent known-region renoise: before each step the
    pixels where mask is 1 are replaced by q_sample(x0, t) with the noise of
    ``renoise_fn(i, shape)`` (JAX: ``fold_in(fold_in(key, 1), i)``).
    ``temperature`` scales the step noise (``noise_fn(i, shape)``; JAX:
    ``fold_in(fold_in(key, 2), i)``).  ``ucg_schedule``: one guidance scale
    per step, in step order (largest t first), instead of ``guidance_scale``.
    ``return_intermediates``: also returns {"x_inter": [S, *shape],
    "pred_x0": [S, *shape]}, each step's latent and its x0 prediction.  The
    random streams default to ``generator`` on the device."""
    use_cfg = uncond is not None and guidance_scale != 1.0
    uncond_ = uncond if use_cfg else None
    n = tables.num_steps
    if ucg_schedule is not None:
        if len(ucg_schedule) != n:
            raise ValueError(f"ucg_schedule has {len(ucg_schedule)} scales for {n} steps")
        scales = [float(np.float32(g)) for g in ucg_schedule]  # JAX's fp32 per-step table
    else:
        scales = [guidance_scale] * n
    if mask is not None and x0 is None:
        raise ValueError("the renoise needs x0 beside mask")
    with trace.span("sample"):
        img = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)
        device = img.device
        noise_fn = noise_fn or default_noise_fn(generator, device)
        renoise_fn = renoise_fn or default_noise_fn(generator, device)
        t_steps, a_t, a_prev, s1m, sig, v = _step_tables(tables, schedule, device)
        b = shape[0]
        inter = {"x_inter": [], "pred_x0": []}
        for i in range(n):
            with trace.span("sample.step", i=i):
                t = torch.full((b,), int(t_steps[i]), dtype=torch.long, device=device)
                if mask is not None:
                    img_orig = _q_sample(schedule, x0, int(t_steps[i]), renoise_fn(i, tuple(x0.shape)))
                    img = img_orig * mask + (1.0 - mask) * img
                out = _guided_eps(apply_fn, img, t, cond, uncond_, scales[i])
                img, pred_x0 = _ddim_update(img, out, a_t[i], a_prev[i], s1m[i], sig[i],
                                            noise_fn(i, tuple(img.shape)), _step_v(v, i), temperature)
                if return_intermediates:
                    inter["x_inter"].append(img)
                    inter["pred_x0"].append(pred_x0)
    if return_intermediates:
        return img, {k: torch.stack(vals) for k, vals in inter.items()}
    return img


def _q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t: int, noise: torch.Tensor) -> torch.Tensor:
    """The forward process at one timestep t for every row (JAX's
    ``LeftRefillModel.q_sample`` with a uniform t)."""
    col = lambda a: trace.to_device(a[t], torch.float32, x_start.device)
    return col(schedule.sqrt_alphas_cumprod) * x_start + col(schedule.sqrt_one_minus_alphas_cumprod) * noise


def ddim_multi_sample(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    tables: DDIMTables,
    conds: Conditioning,
    shape: tuple,
    unconds: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    pick_fn: Optional[PickFn] = None,
    device=None,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Multi-cond consistent sampling, the reference's test-time sampler
    for several reference pairs (JAX ``ddim_multi_sample``, ddim.py:157-225;
    tasks.py:353-372).  ``conds`` (and ``unconds``) stack K conditionings on
    a leading axis; one latent per conditioning, all K stepped together as
    one flat UNet batch, then after each step the right half of one latent,
    picked at random, is copied into every latent.  Returns latent 0
    [*shape].

    ``x_T`` [K, *shape], or one shared draw of ``shape`` for every latent (as
    the reference).  ``noise_fn(i, (K, *shape))`` gives step i's noise
    (JAX: ``fold_in(fold_in(key, 2), i)``), scaled by ``temperature``,
    ``pick_fn(i, K)`` its pick (JAX: ``randint(fold_in(fold_in(key, 3), i),
    (), 0, K)``); by default both come from ``generator``."""
    use_cfg = unconds is not None and guidance_scale != 1.0
    k = (conds.c_concat if conds.c_concat is not None else conds.c_crossattn).shape[0]
    with trace.span("sample"):
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=device).expand(k, *shape)
        imgs = x_T
        device = imgs.device
        noise_fn = noise_fn or default_noise_fn(generator, device)
        pick_fn = pick_fn or (lambda i, n: int(trace.to_host(torch.randint(n, (), generator=generator, device=device))))
        b, w_half = shape[0], shape[2] // 2  # NHWC latents: the right half is w // 2:
        flat_shape = (k * b, *shape[1:])

        def flatten(c: Optional[Conditioning]) -> Optional[Conditioning]:
            if c is None:
                return None
            fl = lambda a: None if a is None else a.reshape(k * b, *a.shape[2:])
            return Conditioning(fl(c.c_concat), fl(c.c_crossattn))

        conds_flat, unconds_flat = flatten(conds), flatten(unconds if use_cfg else None)
        t_steps, a_t, a_prev, s1m, sig, v = _step_tables(tables, schedule, device)
        for i in range(tables.num_steps):
            with trace.span("sample.step", i=i):
                noise = noise_fn(i, tuple(imgs.shape))
                t = torch.full((k * b,), int(t_steps[i]), dtype=torch.long, device=device)
                flat = imgs.reshape(flat_shape)
                out = _guided_eps(apply_fn, flat, t, conds_flat, unconds_flat, guidance_scale)
                flat, _ = _ddim_update(flat, out, a_t[i], a_prev[i], s1m[i], sig[i], noise.reshape(flat_shape),
                                       _step_v(v, i), temperature)
                imgs = flat.reshape(imgs.shape)
                right = imgs[pick_fn(i, k), :, :, w_half:]
                imgs = torch.cat([imgs[..., :w_half, :], right.expand(k, *right.shape)], dim=3)
    return imgs[0]


def _fp32(a, device) -> torch.Tensor:
    return trace.to_device(np.asarray(a, np.float32), device=device)


def sub_tables(tables: DDIMTables, lo: int, hi: int) -> DDIMTables:
    """Entries lo..hi-1 of the tables (ascending t)."""
    return dataclasses.replace(tables, **{f.name: getattr(tables, f.name)[lo:hi] for f in dataclasses.fields(tables)
                                          if f.name != "eta"})


def ddim_stochastic_encode(tables: DDIMTables, x0: torch.Tensor, t_index, noise: torch.Tensor) -> torch.Tensor:
    """q_sample on the DDIM sub-schedule (JAX ``ddim_stochastic_encode``):
    row j takes the alphas at DDIM step index ``t_index[j]`` (an int or [B]
    ints)."""
    idx = torch.as_tensor(t_index, dtype=torch.long, device=x0.device).expand(x0.shape[0])
    bshape = (x0.shape[0],) + (1,) * (x0.ndim - 1)
    sqrt_a = torch.sqrt(_fp32(tables.alphas, x0.device))[idx].reshape(bshape)
    sqrt_1ma = _fp32(tables.sqrt_one_minus_alphas, x0.device)[idx].reshape(bshape)
    return sqrt_a * x0 + sqrt_1ma * noise


def ddim_encode(
    apply_fn: ApplyFn,
    tables: DDIMTables,
    x0: torch.Tensor,
    cond: Conditioning,
    t_enc: int,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """Deterministic DDIM inversion over the first ``t_enc`` DDIM steps
    (JAX ``ddim_encode``).  As JAX, the model is called at t = i, the DDIM
    step index (not ``timesteps[i]``), and its output is taken as eps
    whatever the parameterization."""
    use_cfg = uncond is not None and guidance_scale != 1.0
    uncond_ = uncond if use_cfg else None
    dev = x0.device
    alphas_next, alphas = _fp32(tables.alphas[:t_enc], dev), _fp32(tables.alphas_prev[:t_enc], dev)
    x_next = x0
    for i in range(t_enc):
        t = torch.full((x0.shape[0],), i, dtype=torch.long, device=dev)
        eps = _guided_eps(apply_fn, x_next, t, cond, uncond_, guidance_scale)
        a_n, a = alphas_next[i], alphas[i]
        xt_weighted = torch.sqrt(a_n / a) * x_next
        weighted = torch.sqrt(a_n) * (torch.sqrt(1 / a_n - 1) - torch.sqrt(1 / a - 1)) * eps
        x_next = xt_weighted + weighted
    return x_next


def ddim_decode(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    tables: DDIMTables,
    x_latent: torch.Tensor,
    cond: Conditioning,
    t_start: int,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """Sample from DDIM index ``t_start`` down to 0 (JAX ``ddim_decode``):
    the first ``t_start`` entries of the tables in descending t, with zero
    noise and temperature 1 whatever the tables' eta."""
    return ddim_sample(apply_fn, schedule, sub_tables(tables, 0, t_start), cond, tuple(x_latent.shape), uncond=uncond,
                       guidance_scale=guidance_scale, x_T=x_latent,
                       noise_fn=lambda i, shape: torch.zeros(shape, device=x_latent.device))
