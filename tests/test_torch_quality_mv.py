"""The multi-view quality study (``tools.quality.mv_study``) held to the
steps of ``scripts/tpu_r4_mv_quality.py`` on the CPU, at the tiny bundle, as
``test_torch_quality.py`` holds the int8 study (its helpers, draws and
tolerances: fp32 numbers 1e-4 relative; int8 statistics 8 %; bf16 ones
15 %; a single element and a trajectory's end 25 %)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quality import MAX_REL, assert_eps_close, jax_eps_sweep, jax_modules, jax_params, port_state, quantized, t

from leftrefill_torch.tools import quality

V = 2


def jax_scene(jm, params: dict, ctx, steps: int, key):
    """The script's part (2): one V-view scene, zero c_concat, CFG 2.5 with
    a zero unconditional context, DDIM-``steps`` at eta 1 (x_T and each
    step's noise from ``key``'s split chain), the bf16 VAE decode."""
    tables = jm.schedule.ddim_tables(steps, eta=1.0)
    c_concat = jnp.zeros((V, 16, 32, 5), jnp.bfloat16)
    ctx_c, ctx_u = jnp.asarray(ctx, jnp.bfloat16), jnp.zeros((V, 77, 24), jnp.bfloat16)
    unet, vae = jm.unet, jm.vae

    @jax.jit
    def sample(up, vp, key):
        a, ap = jnp.asarray(tables.alphas), jnp.asarray(tables.alphas_prev)
        sig, ts = jnp.asarray(tables.sigmas), jnp.asarray(tables.timesteps)
        x = jax.random.normal(key, (V, 16, 32, 4), jnp.float32)
        kv = unet.apply({"params": up}, jnp.concatenate([ctx_u, ctx_c], 0), method="cross_kv")

        def step(carry, i):
            x, key = carry
            idx = tables.num_steps - 1 - i
            tt = jnp.full((2 * V,), ts[idx], jnp.int32)
            xin = jnp.concatenate([x, x], 0).astype(jnp.bfloat16)
            eps = unet.apply({"params": up}, jnp.concatenate([xin, jnp.concatenate([c_concat, c_concat], 0)], -1),
                             tt, jnp.concatenate([ctx_u, ctx_c], 0), cross_kv=kv).astype(jnp.float32)
            e = eps[:V] + quality.GUIDANCE * (eps[V:] - eps[:V])
            x0 = (x - jnp.sqrt(1 - a[idx]) * e) / jnp.sqrt(a[idx])
            key, nk = jax.random.split(key)
            noise = jax.random.normal(nk, x.shape, jnp.float32)
            x = jnp.sqrt(ap[idx]) * x0 + jnp.sqrt(1 - ap[idx] - sig[idx] ** 2) * e + sig[idx] * noise
            return (x, key), None

        (x, _), _ = jax.lax.scan(step, (x, key), jnp.arange(tables.num_steps))
        return vae.apply({"params": vp}, x.astype(jnp.bfloat16) / 0.18215, method=vae.decode)

    return np.asarray(sample(params["unet"], params["vae"], key), np.float32)


def test_mv_study_matches_jax():
    """Part (1) on the V=2 multi-view UNet (bf16 and fused int8 against
    fp32 at the five timesteps), part (2) the 2-view DDIM-20 scene in bf16 and
    int8, both sides from the script's x_T and split-chain step noise."""
    torch.set_num_threads(2)
    params = jax_params(view_num=V)
    jm32, jm16 = jax_modules(view_num=V), jax_modules(jnp.bfloat16, view_num=V)
    jm8 = jax_modules(jnp.bfloat16, quant=True, view_num=V)
    qparams = quantized(jm8, params)
    x = jax.random.normal(jax.random.PRNGKey(0), (V, 16, 32, 9), jnp.float32)
    ctx = jax.random.normal(jax.random.PRNGKey(1), (V, 77, 24), jnp.float32) * 0.5
    apply = lambda m, p: jax.jit(lambda xx, tt, cc: m.unet.apply({"params": p["unet"]}, xx, tt, cc))  # noqa: E731
    ref_eps = jax_eps_sweep({"fp32": apply(jm32, params), "bf16": apply(jm16, params), "int8": apply(jm8, qparams)},
                            x, ctx)
    steps, key = 20, jax.random.PRNGKey(quality.SEED)  # the study's 50 cut to 20
    a, b = jax_scene(jm16, params, ctx, steps, key), jax_scene(jm8, qparams, ctx, steps, key)
    x_T = jax.random.normal(key, (V, 16, 32, 4), jnp.float32)
    noise, k = [], key
    for _ in range(steps):
        k, nk = jax.random.split(k)
        noise.append(jax.random.normal(nk, (V, 16, 32, 4), jnp.float32))

    got = quality.mv_study("cpu", arch=quality.TINY, state=port_state(params), views=V, steps=steps,
                           draws={"x": t(x), "ctx": t(ctx), "x_T": t(x_T), "noise_fn": lambda i, s: t(noise[i])})
    assert_eps_close(got["eps"], ref_eps)
    ab = got["scene_ab"]
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    assert ab["mse"] == pytest.approx(mse, rel=MAX_REL), (ab, mse)  # a trajectory's end: one draw of the drift
    assert ab["psnr_bf16_vs_int8_db"] == pytest.approx(10 * np.log10(4.0 / ab["mse"]))
    assert ab["maxdiff"] == pytest.approx(float(np.abs(a - b).max()), rel=MAX_REL)
