"""The port's DDPM and PLMS samplers against the JAX package's on the CPU in
fp32, with JAX's own draws fed through the port's hooks:

- ``ddpm_sample`` on an analytic model over the full 1000-step schedule
  (1e-5 relative to the largest value: only fp32 rounding differs) and on the
  tiny bundle of ``test_torch_parity_utils`` over a 40-step schedule built
  the same way on both sides (1e-4 absolute, ``CANVAS_ABS``), with and
  without ``return_x0_every`` and ``clip_denoised``, eps and v;
- ``plms_sample`` at 1, 2, 3 and 6 steps (the Heun first step alone, then
  each Adams-Bashforth order), and its refusal of a v model.

``_conds`` and the draw helpers are shared with ``test_torch_ddim_extra``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import CANVAS_ABS, j, rel_err, t, tiny_bundles

SHAPE = (1, 8, 16, 4)  # a tiny latent: 1 row of 8x16
STEPS = 4


def _conds(seed: int, k=None):
    """(JAX cond, JAX uncond, port cond, port uncond) of seeded c_concat and
    contexts; with ``k``, K conditionings stacked on a leading axis."""
    from leftrefill_tpu.diffusion.core import Conditioning as JCond

    from leftrefill_torch.diffusion.core import Conditioning

    rng = np.random.RandomState(seed)
    lead = () if k is None else (k,)
    c_concat = rng.standard_normal((*lead, 1, 8, 16, 5)).astype(np.float32)
    ctx, uctx = (rng.standard_normal((*lead, 1, 77, 24)).astype(np.float32) for _ in range(2))
    return (JCond(j(c_concat), j(ctx)), JCond(j(c_concat), j(uctx)), Conditioning(t(c_concat), t(ctx)),
            Conditioning(t(c_concat), t(uctx)))


def _step_draws(key, n: int, salt: int, shape=SHAPE):
    """JAX's per-step draws ``fold_in(fold_in(key', salt), i)``, key' the key
    after ``split(key)``; with x_T from the split's second key."""
    step_key, init_key = jax.random.split(key)
    draws = [t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, salt), i), shape)) for i in range(n)]
    return t(jax.random.normal(init_key, shape)), draws


# ---- DDPM -------------------------------------------------------------------

def _ddpm_draws(key, n: int, shape=SHAPE):
    """JAX's DDPM draws: x_T from the split's second key, the noise at t from
    ``fold_in(key', t)``."""
    step_key, init_key = jax.random.split(key)
    noise = np.asarray(jax.vmap(lambda tt: jax.random.normal(jax.random.fold_in(step_key, tt), shape))(jnp.arange(n)))
    return t(jax.random.normal(init_key, shape)), t(noise)


@pytest.mark.parametrize("parameterization", ["eps", "v"])
@pytest.mark.parametrize("clip,every,temperature", [(False, None, 1.0), (True, 200, 0.7), (False, 100, 1.0)])
def test_ddpm_analytic_full_schedule_matches_jax(parameterization, clip, every, temperature):
    """An analytic model (a smooth function of x, t and the conditioning)
    over all 1000 timesteps of the SD2 schedule, CFG 2.5."""
    from leftrefill_tpu.diffusion.core import Conditioning as JCond, LeftRefillModel as JM
    from leftrefill_tpu.diffusion.samplers_extra import ddpm_sample as jddpm
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule as JS

    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.diffusion.samplers_extra import ddpm_sample
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS

    sd2 = dict(timesteps=1000, linear_start=0.00085, linear_end=0.0120, parameterization=parameterization)
    jm = JM(unet=None, vae=None, cond_model=None, schedule=JS.create(**sd2), parameterization=parameterization)
    ts = TS.create(**sd2)
    rng = np.random.RandomState(6)
    cc, uc = (rng.standard_normal((1, 8, 16, 4)).astype(np.float32) for _ in range(2))
    jfn = lambda x, tt, c: jnp.tanh(0.8 * x + c.c_concat) * (0.5 + tt[:, None, None, None] / 2000.0)
    tfn = lambda x, tt, c: torch.tanh(0.8 * x + c.c_concat) * (0.5 + tt[:, None, None, None] / 2000.0)
    key = jax.random.PRNGKey(9)
    x_T, noise = _ddpm_draws(key, 1000)
    ref = jax.jit(lambda: jddpm(jm, jfn, JCond(j(cc)), key, SHAPE, uncond=JCond(j(uc)), guidance_scale=2.5,
                                clip_denoised=clip, temperature=temperature, return_x0_every=every))()
    out = ddpm_sample(tfn, ts, Conditioning(t(cc)), SHAPE, uncond=Conditioning(t(uc)), guidance_scale=2.5, x_T=x_T,
                      clip_denoised=clip, temperature=temperature, return_x0_every=every,
                      noise_fn=lambda tt, s: noise[tt])
    if every is None:
        out, ref = (out,), (ref,)
    else:
        assert out[1].shape == (1000 // every, *SHAPE)
    for got, want in zip(out, ref):
        assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
    if clip:
        assert float(out[1].abs().max()) <= 1.0


@pytest.fixture(scope="module", params=["eps", "v"])
def bundles(request):
    return tiny_bundles(parameterization=request.param)


@pytest.mark.parametrize("every", [None, 8])
def test_ddpm_tiny_bundle_matches_jax(bundles, every):
    """The tiny UNet over a 40-step schedule (the SD2 beta range, built the
    same way on both sides), CFG 2.5, with and without the x0 every 8
    steps."""
    from leftrefill_tpu.diffusion.samplers_extra import ddpm_sample as jddpm
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule as JS

    from leftrefill_torch.diffusion.samplers_extra import ddpm_sample
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS

    jm, params, tm, _, _ = bundles
    p = tm.schedule.parameterization
    short = dict(timesteps=40, linear_start=0.00085, linear_end=0.0120, parameterization=p)
    jm = dataclasses.replace(jm, schedule=JS.create(**short))
    jc, ju, c, u = _conds(10)
    key = jax.random.PRNGKey(11)
    x_T, noise = _ddpm_draws(key, 40)
    ref = jax.jit(lambda pp: jddpm(jm, lambda x, tt, cc: jm.apply_model(pp, x, tt, cc), jc, key, SHAPE, uncond=ju,
                                   guidance_scale=2.5, return_x0_every=every))(params)
    with torch.no_grad():
        out = ddpm_sample(tm.apply_model, TS.create(**short), c, SHAPE, uncond=u, guidance_scale=2.5, x_T=x_T,
                          return_x0_every=every, noise_fn=lambda tt, s: noise[tt])
    if every is None:
        out, ref = (out,), (ref,)
    for got, want in zip(out, ref):
        assert np.abs(got.numpy() - np.asarray(want)).max() < CANVAS_ABS
    with pytest.raises(ValueError):  # JAX asserts the same
        ddpm_sample(tm.apply_model, TS.create(**short), c, SHAPE, x_T=x_T, return_x0_every=7)


# ---- PLMS -------------------------------------------------------------------

@pytest.fixture(scope="module")
def eps_bundles():
    return tiny_bundles(parameterization="eps")


@pytest.mark.parametrize("steps", [1, 2, 3, 6])
def test_plms_every_order_matches_jax(eps_bundles, steps):
    """PLMS on the ``quad`` sub-schedule (``steps`` entries exactly), CFG
    2.5: one step is the Heun step alone (its second call at t = 0), two add
    order 2, three order 3, six every order through 4."""
    from leftrefill_tpu.diffusion.samplers_extra import plms_sample as jplms

    from leftrefill_torch.diffusion.samplers_extra import plms_sample

    jm, params, tm, _, _ = eps_bundles
    jc, ju, c, u = _conds(12)
    tables_j, tables_t = (m.ddim_tables(steps, method="quad") for m in (jm.schedule, tm.schedule))
    assert tables_t.num_steps == steps
    key = jax.random.PRNGKey(13)
    x_T = t(jax.random.normal(jax.random.split(key)[1], SHAPE))
    calls = []

    def apply_t(x, tt, cc):
        calls.append(int(tt[0]))
        return tm.apply_model(x, tt, cc)

    ref = jax.jit(lambda p: jplms(jm, lambda x, tt, cc: jm.apply_model(p, x, tt, cc), tables_j, jc, key, SHAPE,
                                  uncond=ju, guidance_scale=2.5))(params)
    with torch.no_grad():
        out = plms_sample(apply_t, tm.schedule, tables_t, c, SHAPE, uncond=u, guidance_scale=2.5, x_T=x_T)
    ts = [int(v) for v in tables_t.timesteps[::-1]]
    assert calls == [ts[0], ts[1] if steps > 1 else 0, *ts[1:]]  # steps + 1 model calls
    assert np.abs(out.numpy() - np.asarray(ref)).max() < CANVAS_ABS


def test_plms_refuses_v():
    """JAX asserts on a v model; the port raises."""
    from leftrefill_tpu.diffusion.samplers_extra import plms_sample as jplms

    from leftrefill_torch.diffusion.samplers_extra import plms_sample

    jm, params, tm, _, _ = tiny_bundles(parameterization="v")
    jc, ju, c, u = _conds(14)
    with pytest.raises(AssertionError):
        jplms(jm, lambda x, tt, cc: jm.apply_model(params, x, tt, cc), jm.schedule.ddim_tables(2), jc,
              jax.random.PRNGKey(0), SHAPE)
    with pytest.raises(ValueError, match="eps"):
        plms_sample(tm.apply_model, tm.schedule, tm.schedule.ddim_tables(2), c, SHAPE, x_T=torch.zeros(SHAPE))
