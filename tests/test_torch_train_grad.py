"""The prompt table's gradient in the port against ``jax.grad`` of the JAX
package's ``compute_loss`` on the tiny bundles (the TINY_YAML dimensions of
``tests/test_tasks.py``), fp32 on the CPU: the 1-reference bundle and the
V=2 multi-view bundle with the view-0 loss.  Every parameter comes from the
same seeded flax tree through ``state_dict_from_flax`` (``fill_tree`` fills
the zero-init layers too, so the gradient reaches the table through every
layer); t and the noise are JAX's own draws from ``split(key, 3)``, and the
VAE noise its fixed draw, handed to the port.  The port's UNet runs with
remat on, JAX's without.

Tolerances: the loss 1e-5 relative, the gradient rel L2 1e-4 (fp32 through
the whole stack, forward and backward, in two frameworks).  Readings in the
tests' docstrings."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_parity_utils import FP32_REL, TINY_CLIP, TINY_UNET, TINY_VAE, init_flax, rel_l2, t, tiny_bundles

GRAD_L2 = 1e-4


def _jax_draws(key, z_shape, rows):
    """compute_loss's t and noise (``split(key, 3)``) and the VAE's fixed noise."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian

    t_key, n_key, _ = jax.random.split(key, 3)
    tt = jax.random.randint(t_key, (rows,), 0, 1000)
    noise = jax.random.normal(n_key, z_shape, jnp.float32)
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), z_shape, jnp.float32)
    return np.asarray(tt).astype(np.int64), np.asarray(noise), np.asarray(vae_noise)


def _compare(jm, params, tm, batch, key, z_shape, **kw):
    """(loss rel difference, gradient rel L2, |grad|) of the two sides."""
    from leftrefill_tpu.train.trainer import compute_loss as jloss

    from leftrefill_torch.train import compute_loss, create_train_state

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(lambda p: jloss(jm, p, jb, key, **kw), has_aux=True))(params)
    ref = np.asarray(ref_grads["cond"]["special_embeddings"])
    tt, noise, vae_noise = _jax_draws(key, z_shape, batch["image"].shape[0])
    create_train_state(tm)
    loss, _ = compute_loss(tm, batch, t=torch.from_numpy(tt), noise=t(noise), vae_noise=t(vae_noise), **kw)
    loss.backward()
    got = tm.cond_stage_model.special_embeddings.weight.grad.numpy()
    return abs(float(loss.detach()) - float(ref_loss)) / abs(float(ref_loss)), rel_l2(got, ref), float(np.abs(ref).max())


def test_prompt_gradient_matches_jax_1ref():
    """Batch 2 of 32x64 canvases, right half masked, four prompt tokens.
    Readings: loss 1.8e-7, gradient 1.8e-6."""
    jm, params, tm, tok, sp = tiny_bundles(seed=4)
    tm.unet.remat = True
    rng = np.random.RandomState(4)
    image = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    mask = np.concatenate([np.zeros((2, 32, 32, 1)), np.ones((2, 32, 32, 1))], axis=2).astype(np.float32)
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": tok.tokenize([" ".join(sp)] * 2)}
    loss_err, grad_err, scale = _compare(jm, params, tm, batch, jax.random.PRNGKey(5), (2, 16, 32, 4))
    assert scale > 0 and loss_err < FP32_REL and grad_err < GRAD_L2


def test_prompt_gradient_matches_jax_multiview():
    """Two scenes of V=2 32x32 views (view 0 holed, view 1 whole), flattened
    to four rows, per-view prompts, the view-0 loss (``view_reduced``).
    Readings: loss equal, gradient 2.0e-6."""
    from leftrefill_tpu.data.loader import flatten_views as jflat
    from leftrefill_tpu.diffusion.core import LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder as JC
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.convert.from_jax import state_dict_from_flax
    from leftrefill_torch.data import flatten_views
    from leftrefill_torch.diffusion.core import LeftRefillModel as TM
    from leftrefill_torch.models.autoencoder import AutoencoderKL as TV, DDConfig as TD
    from leftrefill_torch.models.clip import PromptCLIPEmbedder as TC
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.pipeline import sd2_schedule

    _, _, _, tok, sp = tiny_bundles()
    sched = DiffusionSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120)
    jm = JM(unet=JMV(view_num=2, **TINY_UNET), vae=JV(ddconfig=JD(**TINY_VAE), embed_dim=4),
            cond_model=JC(**TINY_CLIP), schedule=sched)
    params = {
        "unet": init_flax(JU(**TINY_UNET), 6, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 77, 24))),
        "vae": init_flax(jm.vae, 7, jnp.zeros((1, 32, 64, 3))),
        "cond": init_flax(jm.cond_model, 8, jnp.zeros((1, 77), jnp.int32)),
    }
    tm = TM(MultiViewUnetModel(view_num=2, **TINY_UNET, remat=True), TV(TD(**TINY_VAE), embed_dim=4),
            TC(**TINY_CLIP), sd2_schedule())
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    rng = np.random.RandomState(6)
    images = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    masks = np.zeros((2, 2, 32, 32, 1), np.float32)
    masks[:, 0, 8:24, 4:28] = 1.0
    tokens = np.stack([tok.tokenize([" ".join(sp[:2]), " ".join(sp[2:])])] * 2)  # [scenes, V, 77]
    scene = {"image": images, "mask": masks, "masked_image": images * (masks < 0.5), "tokens": tokens}
    batch = flatten_views(scene)
    assert all(np.array_equal(batch[k], v) for k, v in jflat(scene).items())
    loss_err, grad_err, scale = _compare(jm, params, tm, batch, jax.random.PRNGKey(9), (4, 16, 16, 4),
                                         view_reduced=True, view_num=2)
    assert scale > 0 and loss_err < FP32_REL and grad_err < GRAD_L2
