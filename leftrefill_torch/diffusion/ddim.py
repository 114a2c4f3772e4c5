"""DDIM sampling with batched classifier-free guidance (counterpart of
``leftrefill_tpu/diffusion/ddim.py``: ``ddim_sample`` and the multi-cond
``ddim_multi_sample``).  The step loop is a Python loop; the initial latent,
the per-step noise and the multi-cond sampler's random picks are injectable
so a run can be held against the JAX sampler, whose ``jax.random`` stream
torch cannot reproduce."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

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


def _ddim_update(x, out, a_t, a_prev, sqrt_one_minus_at, sigma, noise, v_coef=None):
    """x_t -> x_{t-1}; the table entries are 0-d fp32 tensors so the
    arithmetic stays in fp32.  With ``v_coef`` (the training schedule's
    sqrt(alphas_cumprod[t]) and sqrt(1 - alphas_cumprod[t])) the model output
    is v, turned into eps and x0 as JAX's ``predict_*_from_z_and_v``; else it
    is eps."""
    if v_coef is not None:
        e_t, pred_x0 = eps_from_z_and_v(x, out, *v_coef), start_from_z_and_v(x, out, *v_coef)
    else:
        e_t = out
        pred_x0 = (x - sqrt_one_minus_at * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e_t
    return torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise


def default_noise_fn(generator: Optional[torch.Generator], device) -> NoiseFn:
    """Per-step noise drawn from the caller's generator on the device."""
    return lambda i, shape: torch.randn(shape, generator=generator, device=device)


def _step_tables(tables: DDIMTables, schedule: DiffusionSchedule, device):
    """(t, a_t, a_prev, sqrt(1 - a_t), sigma, v) per step, largest t first;
    v is the training schedule's (sqrt(alphas_cumprod[t]), sqrt(1 -
    alphas_cumprod[t])) where its model predicts v, else None."""
    t = tables.timesteps[::-1].astype("int64")

    def col(a):  # a copy: a one-step table's reversed view keeps its negative stride through ascontiguousarray
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=device)

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
) -> torch.Tensor:
    """The DDIM loop over the tables in descending t; returns the final
    latent.  ``schedule`` is the model's training schedule, whose
    parameterization says what the model predicts."""
    use_cfg = uncond is not None and guidance_scale != 1.0
    uncond_ = uncond if use_cfg else None
    img = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)
    device = img.device
    noise_fn = noise_fn or default_noise_fn(generator, device)
    t_steps, a_t, a_prev, s1m, sig, v = _step_tables(tables, schedule, device)
    b = shape[0]
    for i in range(tables.num_steps):
        t = torch.full((b,), int(t_steps[i]), dtype=torch.long, device=device)
        out = _guided_eps(apply_fn, img, t, cond, uncond_, guidance_scale)
        img = _ddim_update(img, out, a_t[i], a_prev[i], s1m[i], sig[i], noise_fn(i, tuple(img.shape)),
                           _step_v(v, i))
    return img


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
    (JAX: ``fold_in(fold_in(key, 2), i)``), ``pick_fn(i, K)`` its pick (JAX:
    ``randint(fold_in(fold_in(key, 3), i), (), 0, K)``); by default both come
    from ``generator``."""
    use_cfg = unconds is not None and guidance_scale != 1.0
    k = (conds.c_concat if conds.c_concat is not None else conds.c_crossattn).shape[0]
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=device).expand(k, *shape)
    imgs = x_T
    device = imgs.device
    noise_fn = noise_fn or default_noise_fn(generator, device)
    pick_fn = pick_fn or (lambda i, n: int(torch.randint(n, (), generator=generator, device=device)))
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
        noise = noise_fn(i, tuple(imgs.shape))
        t = torch.full((k * b,), int(t_steps[i]), dtype=torch.long, device=device)
        flat = imgs.reshape(flat_shape)
        out = _guided_eps(apply_fn, flat, t, conds_flat, unconds_flat, guidance_scale)
        imgs = _ddim_update(flat, out, a_t[i], a_prev[i], s1m[i], sig[i], noise.reshape(flat_shape),
                            _step_v(v, i)).reshape(imgs.shape)
        right = imgs[pick_fn(i, k), :, :, w_half:]
        imgs = torch.cat([imgs[..., :w_half, :], right.expand(k, *right.shape)], dim=3)
    return imgs[0]
