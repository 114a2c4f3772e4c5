"""The 1-reference task's progressive row, the multi-view task's split of
the diagnostic rows and its ``multi_cond_sample``, each against the JAX
package's on the CPU in fp32 with JAX's draws fed to the port, on the tiny
bundles of ``test_torch_tasks`` (in a file of their own so each file stays
near a minute).  Tolerance: the tiny canvas 1e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np

from test_cli import MODEL_YAML
from test_cli_variants import MV_MODEL_YAML
from test_torch_parity_utils import CANVAS_ABS, t
from test_torch_tasks import ROW_SHAPES, STEPS, _batch, _bundles, _draws, _row_draws


def test_ref_task_progressive_row_matches_jax():
    """``plot_progressive_rows`` (the DDPM loop's x0 at the end of each
    fifth) on the tiny bundle with a 50-step schedule on both sides, so the
    loop is 50 UNet calls; with the other two rows."""
    jt, params, task = _bundles(MODEL_YAML.replace("timesteps: 1000", "timesteps: 50"))
    assert task.model.schedule.num_timesteps == 50
    batch, key = _batch(task, 2, seed=13), jax.random.PRNGKey(14)
    kw = dict(ddim_steps=5, ddim_eta=1.0, unconditional_guidance_scale=2.5, plot_diffusion_rows=True,
              plot_denoise_rows=True, plot_progressive_rows=True)
    ref = jt.log_images(params, batch, key=key, **kw)
    out = task.log_images(batch, **kw, **_draws(2, key, steps=5), **_row_draws(2, key, n_t=50))
    # t = 0 and 49 on the 50-step schedule; DDIM-5; the x0 every 10 DDPM steps
    assert [out[k].shape[0] for k in ("diffusion_row", "denoise_row", "progressive_row")] == [2, 5, 5]
    for k in ("pred", "diffusion_row", "denoise_row", "progressive_row"):
        assert tuple(out[k].shape) == np.shape(ref[k]), k
        assert np.abs(out[k].numpy() - np.asarray(ref[k])).max() < CANVAS_ABS, k


def _mv_batch(task, seed: int):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (2, 2, 32, 64, 3)).astype(np.float32)
    masks = np.zeros((2, 2, 32, 64, 1), np.float32)
    masks[:, 0, 6:26, 36:60] = 1.0
    toks = task.prompt_tokens([" ".join(task.bundle.special_tokens[:2]), " ".join(task.bundle.special_tokens[2:4])])
    return {"image": images, "mask": masks, "masked_image": images * (masks < 0.5), "tokens": np.stack([toks, toks])}


def test_multiview_task_splits_the_rows_on_their_batch_axis():
    """Two V=2 scenes: the port's rows are [S, B, V, ...], JAX's rows' data
    split the same way.  JAX reshapes every log entry on its leading axis
    (tasks.py:344), which for a row is the step axis: its 6-step diffusion
    row comes out (3, 2, B·V, ...), view 1 of JAX's step 0 being step 1 (a
    JAX fault the port does not copy)."""
    jt, params, task = _bundles(MV_MODEL_YAML)
    batch, key = _mv_batch(task, 15), jax.random.PRNGKey(16)
    kw = dict(N=2, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=2.5, plot_diffusion_rows=True,
              plot_denoise_rows=True)
    ref = jt.log_images(params, batch, key=key, **kw)
    out = task.log_images(batch, **kw, **_draws(4, key), **_row_draws(4, key))
    assert np.shape(ref["diffusion_row"]) == (3, 2, 4, 32, 64, 3)  # JAX: the steps split
    assert np.shape(ref["denoise_row"]) == (2, 2, 4, 32, 64, 3)
    for k in ("diffusion_row", "denoise_row"):
        s = ROW_SHAPES[k]
        assert tuple(out[k].shape) == (s, 2, 2, 32, 64, 3), k
        flat = np.asarray(ref[k]).reshape(s, 4, 32, 64, 3)  # JAX's data, its steps in order
        assert np.abs(out[k].numpy() - flat.reshape(s, 2, 2, 32, 64, 3)).max() < CANVAS_ABS, k
    # JAX's [0, 1] holds step 1 of every flat row, not step 0's
    assert np.abs(np.asarray(ref["diffusion_row"])[0, 1] - out["diffusion_row"][1].reshape(4, 32, 64, 3).numpy()).max() \
        < CANVAS_ABS
    assert np.abs(out["pred"].numpy() - np.asarray(ref["pred"])).max() < CANVAS_ABS


def test_multiview_multi_cond_sample_matches_jax():
    """K = 2 conditionings of one V=2 scene each (seeded c_concat and
    contexts), DDIM-4 at eta 1, CFG 2.5, JAX's shared x_T, noise and picks."""
    from leftrefill_tpu.diffusion.core import Conditioning as JCond

    from leftrefill_torch.diffusion.core import Conditioning

    jt, params, task = _bundles(MV_MODEL_YAML)
    k, shape = 2, (2, 16, 32, 4)
    rng = np.random.RandomState(17)
    c_concat = rng.standard_normal((k, 2, 16, 32, 5)).astype(np.float32)
    ctx, uctx = (rng.standard_normal((k, 2, 77, 24)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(18)
    step_key, init_key = jax.random.split(key)
    noise = [t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), (k, *shape)))
             for i in range(STEPS)]
    picks = [int(jax.random.randint(jax.random.fold_in(jax.random.fold_in(step_key, 3), i), (), 0, k))
             for i in range(STEPS)]
    ref = jt.multi_cond_sample(params, JCond(jnp.asarray(c_concat), jnp.asarray(ctx)),
                               JCond(jnp.asarray(c_concat), jnp.asarray(uctx)), shape, 2.5, ddim_steps=STEPS,
                               eta=1.0, key=key)
    out = task.multi_cond_sample(Conditioning(t(c_concat), t(ctx)), Conditioning(t(c_concat), t(uctx)), shape, 2.5,
                                 ddim_steps=STEPS, eta=1.0, x_T=t(jax.random.normal(init_key, shape)).expand(k, *shape),
                                 noise_fn=lambda i, s: noise[i], pick_fn=lambda i, n: picks[i])
    assert tuple(out.shape) == shape
    assert np.abs(out.numpy() - np.asarray(ref)).max() < CANVAS_ABS
