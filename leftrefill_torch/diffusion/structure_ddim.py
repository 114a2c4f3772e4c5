"""Two-phase DDIM with 3-way structural guidance (counterpart of
``leftrefill_tpu/diffusion/structure_ddim.py``): for the DDIM indices at or
above ``Tm`` the model runs a tripled batch [uncond; cond; cond_simple] and
blends eps = e_uc + s ((w e_c + (1 - w) e_cs) - e_uc); below ``Tm`` it runs
cond_simple alone, without guidance."""

from __future__ import annotations

from typing import Optional

import torch

from leftrefill_torch.diffusion.core import Conditioning
from leftrefill_torch.diffusion.ddim import ApplyFn, NoiseFn, _ddim_update, _step_tables, _step_v, default_noise_fn
from leftrefill_torch.diffusion.schedules import DDIMTables, DiffusionSchedule


def structure_ddim_sample(
    apply_fn: ApplyFn,
    schedule: DiffusionSchedule,
    tables: DDIMTables,
    cond: Conditioning,
    cond_simple: Conditioning,
    shape: tuple,
    uncond: Optional[Conditioning] = None,
    guidance_scale: float = 1.0,
    cond_weight: float = 0.5,
    Tm: int = 0,
    x_T: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    device=None,
) -> torch.Tensor:
    """The DDIM loop over the tables in descending t, guided in its first
    ``num_steps - Tm`` steps (the indices >= Tm) where ``uncond`` is given
    and ``guidance_scale`` != 1, cond_simple alone after them.  Returns the
    final latent.  ``noise_fn(i, shape)`` gives step i's noise, i counted
    over the whole loop (JAX, with its key split first into (key, x_T's
    key): ``fold_in(fold_in(key, 2), i)`` in the guided phase,
    ``fold_in(fold_in(key, 3), i - (num_steps - Tm))`` after it); by
    default it is drawn from ``generator``."""
    img = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device)
    device = img.device
    noise_fn = noise_fn or default_noise_fn(generator, device)
    t_steps, a_t, a_prev, s1m, sig, v = _step_tables(tables, schedule, device)
    n, b = tables.num_steps, shape[0]
    guided = uncond is not None and guidance_scale != 1.0
    # [uncond; cond; cond_simple]: concat_batch stacks [other; self]
    tripled = cond_simple.concat_batch(cond).concat_batch(uncond) if guided else None
    for i in range(n):
        t = torch.full((b,), int(t_steps[i]), dtype=torch.long, device=device)
        if guided and i < n - Tm:
            out = apply_fn(torch.cat([img] * 3), torch.cat([t] * 3), tripled)
            e_uc, e_c, e_cs = out.chunk(3, dim=0)
            out = e_uc + guidance_scale * ((cond_weight * e_c + (1 - cond_weight) * e_cs) - e_uc)
        else:
            out = apply_fn(img, t, cond_simple)
        img, _ = _ddim_update(img, out, a_t[i], a_prev[i], s1m[i], sig[i], noise_fn(i, tuple(img.shape)),
                              _step_v(v, i), temperature)
    return img
