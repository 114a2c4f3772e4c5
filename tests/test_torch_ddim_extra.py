"""The rest of the port's DDIM against the JAX package's on the CPU in fp32,
with JAX's own draws fed through the port's hooks, each on the tiny bundle
of ``test_torch_parity_utils`` for eps and v, latents within 1e-4 absolute
(``CANVAS_ABS``): ``ddim_sample`` with the known-region renoise
(``mask``/``x0``), ``temperature``, a per-step ``ucg_schedule`` and the
per-step intermediates; ``ddim_multi_sample`` with ``temperature``;
``ddim_stochastic_encode``, ``ddim_encode`` (the model called at the DDIM
step index, pinned) and ``ddim_decode``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import CANVAS_ABS, j, t, tiny_bundles
from test_torch_samplers_extra import SHAPE, STEPS, _conds, _step_draws

@pytest.fixture(scope="module", params=["eps", "v"])
def bundles(request):
    return tiny_bundles(parameterization=request.param)


def test_ddim_renoise_temperature_schedule_intermediates_match_jax(bundles):
    """Four steps at eta 1 with CFG, the renoise of a seeded latent mask
    from x0, temperature 0.5, one guidance scale per step and the per-step
    (x_inter, pred_x0) stacks."""
    from leftrefill_tpu.diffusion.ddim import ddim_sample as jddim

    from leftrefill_torch.diffusion.ddim import ddim_sample

    jm, params, tm, _, _ = bundles
    jc, ju, c, u = _conds(1)
    rng = np.random.RandomState(2)
    mask = (rng.uniform(size=(1, 8, 16, 1)) > 0.5).astype(np.float32)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    ucg = [3.0, 2.5, 1.5, 4.0]
    key = jax.random.PRNGKey(7)
    x_T, noise = _step_draws(key, STEPS, 2)
    _, renoise = _step_draws(key, STEPS, 1)
    ref, ref_inter = jax.jit(lambda p: jddim(
        jm, lambda x, tt, cc: jm.apply_model(p, x, tt, cc), jm.schedule.ddim_tables(STEPS, eta=1.0), jc, key, SHAPE,
        uncond=ju, guidance_scale=2.5, mask=j(mask), x0=j(x0), temperature=0.5, ucg_schedule=np.asarray(ucg),
        return_intermediates=True))(params)
    with torch.no_grad():
        out, inter = ddim_sample(tm.apply_model, tm.schedule, tm.schedule.ddim_tables(STEPS, eta=1.0), c, SHAPE,
                                 uncond=u, guidance_scale=2.5, x_T=x_T, noise_fn=lambda i, s: noise[i],
                                 renoise_fn=lambda i, s: renoise[i], mask=t(mask), x0=t(x0), temperature=0.5,
                                 ucg_schedule=ucg, return_intermediates=True)
    assert out.shape == SHAPE and inter["x_inter"].shape == inter["pred_x0"].shape == (STEPS, *SHAPE)
    assert torch.equal(inter["x_inter"][-1], out)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < CANVAS_ABS
    for k in ("x_inter", "pred_x0"):
        assert np.abs(inter[k].numpy() - np.asarray(ref_inter[k])).max() < CANVAS_ABS, k
    with pytest.raises(ValueError):  # JAX asserts the same
        ddim_sample(tm.apply_model, tm.schedule, tm.schedule.ddim_tables(STEPS), c, SHAPE, uncond=u,
                    guidance_scale=2.5, x_T=x_T, ucg_schedule=ucg[:3])


def test_ddim_multi_sample_temperature_matches_jax(bundles):
    """K = 2 conditionings, eta 1, CFG 2.5, temperature 0.5."""
    from leftrefill_tpu.diffusion.ddim import ddim_multi_sample as jmulti

    from leftrefill_torch.diffusion.ddim import ddim_multi_sample

    jm, params, tm, _, _ = bundles
    k = 2
    jc, ju, c, u = _conds(3, k)
    key = jax.random.PRNGKey(8)
    _, noise = _step_draws(key, STEPS, 2, (k, *SHAPE))
    step_key, init_key = jax.random.split(key)
    picks = [int(jax.random.randint(jax.random.fold_in(jax.random.fold_in(step_key, 3), i), (), 0, k))
             for i in range(STEPS)]
    x_T = t(jax.random.normal(init_key, SHAPE))  # one shared draw, as JAX's
    ref = jax.jit(lambda p: jmulti(jm, lambda x, tt, cc: jm.apply_model(p, x, tt, cc),
                                   jm.schedule.ddim_tables(STEPS, eta=1.0), jc, key, SHAPE, unconds=ju,
                                   guidance_scale=2.5, temperature=0.5))(params)
    with torch.no_grad():
        out = ddim_multi_sample(tm.apply_model, tm.schedule, tm.schedule.ddim_tables(STEPS, eta=1.0), c, SHAPE,
                                unconds=u, guidance_scale=2.5, x_T=x_T.expand(k, *SHAPE),
                                noise_fn=lambda i, s: noise[i], pick_fn=lambda i, n: picks[i], temperature=0.5)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < CANVAS_ABS


def test_ddim_inversion_matches_jax(bundles):
    """``ddim_stochastic_encode`` at per-row DDIM indices, ``ddim_encode``
    over 3 of 4 steps with CFG (the model called at t = i, the DDIM step
    index, as JAX: pinned by recording the t it is given), then
    ``ddim_decode`` from index 3 at eta 1 (zero noise)."""
    from leftrefill_tpu.diffusion import ddim as jd

    from leftrefill_torch.diffusion import ddim as td

    jm, params, tm, _, _ = bundles
    jc, ju, c, u = _conds(4)
    rng = np.random.RandomState(5)
    x0 = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    tables_j, tables_t = jm.schedule.ddim_tables(STEPS, eta=1.0), tm.schedule.ddim_tables(STEPS, eta=1.0)
    ref = jd.ddim_stochastic_encode(jm, tables_j, j(x0), jnp.asarray([1, 3]), j(noise))
    got = td.ddim_stochastic_encode(tables_t, t(x0), [1, 3], t(noise))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < CANVAS_ABS

    seen = []

    def apply_t(x, tt, cc):
        seen.append(tt.tolist())
        return tm.apply_model(x, tt, cc)

    z0 = t(x0[:1])
    ref = jax.jit(lambda p: jd.ddim_encode(jm, lambda x, tt, cc: jm.apply_model(p, x, tt, cc), tables_j, j(x0[:1]),
                                           jc, 3, uncond=ju, guidance_scale=2.5))(params)
    with torch.no_grad():
        enc = td.ddim_encode(apply_t, tables_t, z0, c, 3, uncond=u, guidance_scale=2.5)
    assert seen == [[0, 0], [1, 1], [2, 2]]  # t = i in the CFG batch, not timesteps[i]
    assert np.abs(enc.numpy() - np.asarray(ref)).max() < CANVAS_ABS

    ref = jax.jit(lambda p: jd.ddim_decode(jm, lambda x, tt, cc: jm.apply_model(p, x, tt, cc), tables_j, j(enc),
                                           jc, 3, uncond=ju, guidance_scale=2.5))(params)
    with torch.no_grad():
        dec = td.ddim_decode(tm.apply_model, tm.schedule, tables_t, enc, c, 3, uncond=u, guidance_scale=2.5)
    assert np.abs(dec.numpy() - np.asarray(ref)).max() < CANVAS_ABS
