"""DDIM sampling with batched classifier-free guidance (counterpart of
``leftrefill_tpu/diffusion/ddim.py:ddim_sample``).  The step loop is a
Python loop; the initial latent and the per-step noise are injectable so a
run can be held against the JAX sampler, whose ``jax.random`` stream torch
cannot reproduce."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from leftrefill_tpu.diffusion.schedules import DDIMTables

from leftrefill_torch.diffusion.core import Conditioning

ApplyFn = Callable[[torch.Tensor, torch.Tensor, Conditioning], torch.Tensor]
# noise source: (step index, shape) -> standard normal fp32 tensor
NoiseFn = Callable[[int, tuple], torch.Tensor]


def _guided_eps(apply_fn: ApplyFn, x, t, cond: Conditioning, uncond: Optional[Conditioning], scale):
    """One CFG-doubled model call ([uncond; cond]) -> guided model output."""
    if uncond is None:
        return apply_fn(x, t, cond)
    out = apply_fn(torch.cat([x, x]), torch.cat([t, t]), cond.concat_batch(uncond))
    out_uncond, out_cond = out.chunk(2, dim=0)
    return out_uncond + scale * (out_cond - out_uncond)


def _ddim_update(x, e_t, a_t, a_prev, sqrt_one_minus_at, sigma, noise):
    """x_t -> x_{t-1} for the eps parameterization; the table entries are
    0-d fp32 tensors so the arithmetic stays in fp32."""
    pred_x0 = (x - sqrt_one_minus_at * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e_t
    return torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise


def default_noise_fn(generator: Optional[torch.Generator], device) -> NoiseFn:
    """Per-step noise drawn from the caller's generator on the device."""
    return lambda i, shape: torch.randn(shape, generator=generator, device=device)


def ddim_sample(
    apply_fn: ApplyFn,
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
    """The DDIM loop over the tables in descending t; returns the final latent."""
    use_cfg = uncond is not None and guidance_scale != 1.0
    uncond_ = uncond if use_cfg else None
    img = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)
    device = img.device
    noise_fn = noise_fn or default_noise_fn(generator, device)

    def col(a):
        return torch.as_tensor(a[::-1].copy(), dtype=torch.float32, device=device)

    t_steps = tables.timesteps[::-1].astype("int64")
    a_t, a_prev = col(tables.alphas), col(tables.alphas_prev)
    s1m, sig = col(tables.sqrt_one_minus_alphas), col(tables.sigmas)
    b = shape[0]
    for i in range(tables.num_steps):
        t = torch.full((b,), int(t_steps[i]), dtype=torch.long, device=device)
        out = _guided_eps(apply_fn, img, t, cond, uncond_, guidance_scale)
        img = _ddim_update(img, out, a_t[i], a_prev[i], s1m[i], sig[i], noise_fn(i, tuple(img.shape)))
    return img
