"""Shared set-up of the PyTorch-port parity tests: seeded weights for a flax
parameter tree, and loading them into the port's modules through
``state_dict_from_flax``.  Both sides then run on the CPU on the same numpy
inputs.

Tolerances used across the port tests, with their reasons:
- fp32 module parity: 1e-5 relative to max|ref| (the same fp32 math in two
  frameworks; only summation order differs);
- the tiny end-to-end canvas: 1e-4 absolute (a few sampler steps compound
  the fp32 rounding differences through UNet, VAE and the update rule);
- bf16 kernel plain versions against the Pallas kernels: 2e-2 * max|ref|
  (one bf16 rounding of the output and of the intermediates each side
  rounds at slightly different points).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leftrefill_torch.convert.from_jax import state_dict_from_flax

torch.set_num_threads(2)

FP32_REL = 1e-5
CANVAS_ABS = 1e-4
BF16_REL = 2e-2


def fill_tree(struct, seed: int):
    """Seeded numpy values for every leaf of a flax param tree (from
    ``jax.eval_shape``): kernels get normals scaled by 1/sqrt(fan-in),
    embeddings 0.02-scaled normals, norm scales 1 + 0.1 * normal, biases
    0.1 * normal.  Zero-init layers are filled too, so a wrong UNet cannot
    pass with eps == 0."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        n = rng.standard_normal(s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif "embedding" in name:
            n = 0.02 * n
        elif name == "scale":
            n = 1.0 + 0.1 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, struct)


def init_flax(module, seed: int, *args):
    struct = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return fill_tree(struct, seed)


def load_port(module: torch.nn.Module, root: str, params) -> torch.nn.Module:
    """Load one flax tree ("unet" | "vae" | "cond") into a port module."""
    sd = state_dict_from_flax({root: params})
    prefix = {"unet": "model.diffusion_model.", "vae": "first_stage_model.", "cond": "cond_stage_model."}[root]
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@contextlib.contextmanager
def int8_activations_off():
    """The control of the int8 parity tests: inside, every int8 site of the
    port multiplies its unquantized activation (fp32 values, scale 1) by the
    dequantized weight, as an arm that quantized weights only would; the
    fused prologues (K4, K7, K8) hand on their fp32 values unquantized too.
    A bound that this control also meets cannot tell a sound int8 arm from
    that fault."""
    import torch.nn.functional as F

    from leftrefill_torch.ops import mlp, quant

    def matmul(a, b_t):
        return a.float() @ b_t.float().t()

    def ones(x):
        return torch.ones((*x.shape[:-1], 1), dtype=torch.float32)

    def silu_off(x, a, bb):
        y = quant._affine(x, a, bb)
        return y * quant.sigmoid(y), torch.ones((), dtype=torch.float32)

    def ln_off(x, gamma, beta, eps=1e-5, norm_out=True):
        y = F.layer_norm(x.float(), x.shape[-1:], gamma, beta, eps)
        return (y.to(x.dtype) if norm_out else None), y, ones(y)

    def gn_off(x, gamma, beta, *, num_groups=32, eps=1e-6, norm_out=True):
        a, bb = quant.gn_affine_ab(*quant.gn_moments(x), gamma, beta, num_groups, eps)
        y = quant._affine(x, a, bb)
        return (y.to(x.dtype) if norm_out else None), y, ones(y)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(quant, "quantize_activation", lambda x: (x.float(), torch.ones((), dtype=torch.float32)))
        m.setattr(quant, "quantize_activation_rowwise", lambda x: (x.float(), ones(x)))
        m.setattr(quant, "silu_quant", silu_off)
        m.setattr(quant, "ln_quant_rowwise", ln_off)
        m.setattr(quant, "gn_quant_rowwise", gn_off)
        m.setattr(quant, "int_mm", matmul)
        m.setattr(mlp, "int_mm", matmul)
        yield


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def j(x) -> jax.Array:
    return jnp.asarray(np.asarray(x))


def test_fill_tree_covers_zero_init_layers():
    from leftrefill_tpu.models.unet import UNetModel

    unet = UNetModel(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1,
                     attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8,
                     context_dim=24)
    p = init_flax(unet, 0, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    assert np.abs(p["out_2"]["kernel"]).min() > 0
    assert np.abs(p["input_blocks_1_0"]["out_layers_3"]["kernel"]).max() > 0
    assert np.abs(p["input_blocks_1_1"]["proj_out"]["kernel"]).max() > 0


TINY_UNET = dict(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=24)
TINY_VAE = dict(z_channels=4, resolution=64, ch=16, ch_mult=(1, 2), num_res_blocks=1)
TINY_CLIP = dict(vocab_size=49408, width=24, heads=2, layers=2, num_special_tokens=4)


def tiny_bundles(seed: int = 0, parameterization: str = "eps"):
    """The tiny bundle of tests/test_pipeline.py on both sides, with the same
    seeded weights and an SD2 schedule of ``parameterization``: (jax model,
    jax params, port model, tokenizer, tokens)."""
    import warnings

    from leftrefill_tpu.diffusion.core import LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder as JC
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.diffusion.core import LeftRefillModel as TM
    from leftrefill_torch.models.autoencoder import AutoencoderKL as TV, DDConfig as TD
    from leftrefill_torch.models.clip import PromptCLIPEmbedder as TC, build_prompt_tokenizer
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS
    from leftrefill_torch.models.unet import UNetModel as TU

    sd2 = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120,
               parameterization=parameterization)
    jm = JM(unet=JU(**TINY_UNET), vae=JV(ddconfig=JD(**TINY_VAE), embed_dim=4),
            cond_model=JC(**TINY_CLIP), schedule=DiffusionSchedule.create(**sd2),
            parameterization=parameterization)
    params = {
        "unet": init_flax(jm.unet, seed, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 77, 24))),
        "vae": init_flax(jm.vae, seed + 1, jnp.zeros((1, 32, 64, 3))),
        "cond": init_flax(jm.cond_model, seed + 2, jnp.zeros((1, 77), jnp.int32)),
    }
    tm = TM(TU(**TINY_UNET), TV(TD(**TINY_VAE), embed_dim=4), TC(**TINY_CLIP), TS.create(**sd2))
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok, sp, _ = build_prompt_tokenizer([f"<special-token{i}>" for i in range(4)])
    return jm, params, tm.eval(), tok, sp


def run_both_pipelines(sampler: str, steps: int = 4, seed: int = 3, parameterization: str = "eps"):
    """The tiny canvas through JAX ``_generate`` and the port's
    ``RefInpaintPipeline``, fp32 on the CPU, with JAX's x_T, per-step noise
    and VAE noise reproduced by ``jax.random`` and fed to the port; the
    bundles' schedule of ``parameterization``.  Returns (port canvas, jax
    canvas, image)."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian
    from leftrefill_tpu.pipeline import _generate

    from leftrefill_torch.pipeline import RefInpaintPipeline, stitch_canvas

    jm, params, tm, tok, sp = tiny_bundles(parameterization=parameterization)
    rng = np.random.RandomState(seed)
    image, mask = stitch_canvas(
        rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
        rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
        np.ones((1, 32, 32, 1), np.float32),
    )
    pipe = RefInpaintPipeline(model=tm, tokenizer=tok, special_tokens=sp, device="cpu", ddim_steps=steps,
                              guidance_scale=2.5, eta=1.0, sampler=sampler)
    shape = (1, 16, 32, 4)  # the tiny VAE downsamples by 2
    key = jax.random.PRNGKey(seed)
    step_key, init_key = jax.random.split(key)  # ddim_sample's own split
    x_T = jax.random.normal(init_key, shape)
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape)
             for i in range(steps)]
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), (1, 16, 32, 4))

    gen = jax.jit(lambda p, im, m, tk, ut, k, xt: _generate(
        p, im, m, tk, ut, k, xt, model=jm, ddim_steps=steps, eta=1.0,
        guidance_scale=2.5, sampler=sampler))
    ref = gen(params, j(image), j(mask), j(pipe.prompt_tokens(1)), j(pipe.uncond_tokens(1)), key, x_T)
    out = pipe(image, mask, x_T=t(x_T), noise_fn=lambda i, s: t(noise[i]), vae_noise=t(vae_noise))
    return out.numpy(), np.asarray(ref), image
