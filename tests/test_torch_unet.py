"""The port's UNet against the JAX package's on the CPU, in fp32, at the tiny
configuration of tests/test_pipeline.py, with the cross-attention K/V cache
and the CFG shared prefix (cfg_dup).  Tolerance 1e-5 relative to max|ref|
(see test_torch_parity_utils)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import FP32_REL, init_flax, j, load_port, rel_err, t

CFG = dict(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1,
           attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=24)


@pytest.fixture(scope="module")
def unets():
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.unet import UNetModel as TU

    ju = JU(**CFG)
    p = init_flax(ju, 11, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    rng = np.random.RandomState(12)
    x = np.repeat(rng.standard_normal((1, 8, 16, 9)).astype(np.float32), 2, axis=0)  # CFG layout
    ts = np.array([621, 621])
    ctx = rng.standard_normal((2, 77, 24)).astype(np.float32)  # [uncond; cond] differ
    return ju, p, load_port(TU(**CFG), "unet", p), (x, ts, ctx)


@pytest.mark.parametrize("cross_kv,cfg_dup", [(False, False), (True, False), (True, True)])
def test_tiny_unet_matches_jax(unets, cross_kv, cfg_dup):
    ju, p, tu, (x, ts, ctx) = unets

    def jax_fwd(p, x, ts, ctx):
        kv = ju.apply({"params": p}, ctx, method="cross_kv") if cross_kv else None
        return ju.apply({"params": p}, x, ts, ctx, cross_kv=kv, cfg_dup=cfg_dup)

    ref = jax.jit(jax_fwd)(p, j(x), j(ts.astype(np.int32)), j(ctx))
    with torch.no_grad():
        kv = tu.cross_kv(t(ctx)) if cross_kv else None
        out = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=kv, cfg_dup=cfg_dup)
    assert out.shape == (2, 8, 16, 4)
    assert np.abs(np.asarray(ref)).max() > 0.1  # the zero-init layers were filled
    assert rel_err(out, ref) < FP32_REL


def test_cfg_dup_is_bit_exact(unets):
    """The shared prefix at half batch must give exactly the doubled run."""
    _, _, tu, (x, ts, ctx) = unets
    with torch.no_grad():
        kv = tu.cross_kv(t(ctx))
        off = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=kv, cfg_dup=False)
        on = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=kv, cfg_dup=True)
    assert torch.equal(on, off)


def test_float_timesteps_accepted(unets):
    """DPM-Solver++ calls the UNet at float t; int and float t of the same
    value give the same output."""
    _, _, tu, (x, ts, ctx) = unets
    with torch.no_grad():
        a = tu(t(x), torch.from_numpy(ts), t(ctx))
        b = tu(t(x), torch.from_numpy(ts.astype(np.float32)), t(ctx))
    assert torch.equal(a, b)
