"""The port's quality studies (``leftrefill_torch.tools.quality``) and the
random-weight helpers they draw with (``tools.weights``), held to the JAX
package on the CPU at the tiny bundle of ``tests/test_pipeline.py``: each
study's numbers against the steps of its JAX script (the VAE study,
``scripts/cpu_vae8_quality.py``, here; the int8, multi-view and solver
studies in ``test_torch_quality_int8.py``, ``_mv.py`` and ``_solver.py``,
each a file of its own to stay near a minute) run through ``leftrefill_tpu``'s functions on
the same weights, carried across by ``convert.from_jax.state_dict_from_flax``,
and the same inputs and noise (JAX's draws fed to the port).

The JAX int8 forwards run without ``LEFTREFILL_INT8_XLA_CONV``: at the tiny
widths (16 and 32 channels) no conv qualifies for the int8 conv kernel
(``conv3x3_int8_qualifies``: 64 channels in and out), so the port, as JAX
on the TPU, runs them on the dequantized weight; the gate would quantize
their activations on the JAX side only (it reads 0.0294 against the
port's 0.0229 where both read 0.0232 without it).  The int8 dense sites
(the transformers' projections and GEGLUs) quantize their activations on
both sides.

Tolerances, with their reasons:
- fp32 numbers (the reference rms, a PSNR between fp32 runs): 1e-4
  relative, 0.05 dB (the same fp32 math; sums in another order);
- the int8 deviations from fp32 (``mean_rel``, an MSE, a PSNR as its MSE):
  8 % relative (measured 0.1 to 5.1 %: the int8 steps dominate, and both
  sides take them at the same points, but the int8 arm's bf16 roundings,
  about a quarter of its variance, carry the bf16 gap below);
- the bf16 deviations: 15 % relative.  The two bf16 forwards are as far
  from each other as each is from fp32 (mean 0.0138 against 0.0120 and
  0.0109 of the fp32 rms): XLA rounds its elementwise chains to bf16 at
  other points than PyTorch's eager ops (a bf16 SiLU is one rounding in
  PyTorch, a sigmoid and a product in XLA), so JAX's deviation reads 10 %
  above the port's.  An arm that did not round (fp32 for bf16) or that
  quantized nothing reads several times outside these bands;
- ``max_rel``, a single element, and the MSE between the bf16 and int8
  ends of a whole sampling trajectory: 25 % relative.  Along a trajectory
  one int8 step moved by a rounding difference moves later ones, so two
  implementations' int8 trajectories drift apart to the int8 noise level
  and the distance between bf16 and int8 ends is one draw of it (measured
  within 5 % for the 1-reference request, 15 % for the 2-view scene).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import TINY_CLIP, TINY_UNET, TINY_VAE

from leftrefill_torch.convert.from_jax import state_dict_from_flax
from leftrefill_torch.tools import quality, weights

FP32_REL, DB_FP32, STAT_REL, BF16_REL, MAX_REL = 1e-4, 0.05, 8e-2, 0.15, 0.25
B = 2


def mk_tree(struct, seed: int = 0):
    """The JAX scripts' "realistic" init (``tpu_r3_int8_quality.py`` ``mk``)."""
    rng = np.random.RandomState(seed)

    def mk(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape).astype(np.float32) / np.sqrt(max(fan_in, 1))).astype(np.float32)
        if name == "scale":
            return np.ones(s.shape, np.float32)
        return (rng.randn(*s.shape).astype(np.float32) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, struct)


def jax_modules(dtype=jnp.float32, quant: bool = False, view_num=None):
    """The tiny JAX bundle's modules in ``dtype`` (the fused int8 UNet with
    ``quant``, the multi-view UNet with ``view_num``)."""
    from leftrefill_tpu.diffusion.core import LeftRefillModel
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder
    from leftrefill_tpu.models.multiview import MultiViewUnetModel
    from leftrefill_tpu.models.unet import UNetModel

    unet = (UNetModel(**TINY_UNET, dtype=dtype, quant=quant) if view_num is None
            else MultiViewUnetModel(view_num=view_num, **TINY_UNET, dtype=dtype, quant=quant))
    return LeftRefillModel(
        unet=unet, vae=AutoencoderKL(ddconfig=DDConfig(**TINY_VAE), embed_dim=4, dtype=dtype),
        cond_model=PromptCLIPEmbedder(**TINY_CLIP, dtype=dtype),
        schedule=DiffusionSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                                          linear_end=0.0120))


def jax_params(view_num=None):
    """The tiny bundle's weights as the JAX scripts draw the UNet's, from
    their shape trees: ``mk`` over the UNet (seed 0), the VAE (1) and the
    text tower (2), then ``unzero_kernels`` over the UNet (a no-op after
    ``mk``, kept as the scripts run it)."""
    from test_tasks import unzero_kernels

    jm = jax_modules(view_num=view_num)
    key = jax.random.PRNGKey(2)
    unet = mk_tree(jax.eval_shape(jm.unet.init, key, jnp.zeros((B, 16, 32, 9)), jnp.zeros((B,), jnp.int32),
                                  jnp.zeros((B, 77, 24)))["params"])
    vae = mk_tree(jax.eval_shape(jm.vae.init, key, jnp.zeros((1, 32, 64, 3)))["params"], 1)
    cond = mk_tree(jax.eval_shape(jm.cond_model.init, key, jnp.zeros((1, 77), jnp.int32))["params"], 2)
    return {"unet": unzero_kernels(unet), "vae": vae, "cond": cond}


def quantized(jm, params: dict) -> dict:
    from leftrefill_tpu.ops.quant import quantize_params_like

    struct = jax.eval_shape(jm.unet.init, jax.random.PRNGKey(2), jnp.zeros((B, 16, 32, 9)),
                            jnp.zeros((B,), jnp.int32), jnp.zeros((B, 77, 24)))["params"]
    return {**params, "unet": quantize_params_like(struct, params["unet"])}


def port_state(params: dict) -> dict:
    return {k: v.float() for k, v in state_dict_from_flax(params).items()}


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def jax_eps_sweep(fns: dict, x, ctx, timesteps=quality.TIMESTEPS) -> list[dict]:
    """The scripts' part (1): fns = {"fp32": apply, name: apply, ...}."""
    lines = []
    for t_val in timesteps:
        tt = jnp.full((x.shape[0],), t_val, jnp.int32)
        ref = np.asarray(fns["fp32"](x, tt, ctx), np.float32)
        rms = float(np.sqrt((ref ** 2).mean()))
        line = {"t": t_val, "ref_rms": rms}
        for name, fn in fns.items():
            if name != "fp32":
                d = np.abs(np.asarray(fn(x, tt, ctx), np.float32) - ref)
                line[name] = {"max_rel": float(d.max() / rms), "mean_rel": float(d.mean() / rms)}
        lines.append(line)
    return lines


def jax_request_draws(shape, steps: int, key=jax.random.PRNGKey(quality.SEED)):
    """JAX ``_generate``'s draws under ``key``: x_T from the init half of
    its split, the DDIM step noise from fold_in(fold_in(step key, 2), i),
    the VAE posterior's fixed-seed noise."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian

    step_key, init_key = jax.random.split(key)
    x_T = jax.random.normal(init_key, shape)
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape) for i in range(steps)]
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape)
    return x_T, {"x_T": t(x_T), "noise_fn": lambda i, s: t(noise[i]), "vae_noise": t(vae_noise)}


def jax_generate(jm, params, image, mask, pipe, key, x_T, steps: int, eta: float, sampler: str = "ddim"):
    from leftrefill_tpu.pipeline import _generate

    gen = jax.jit(lambda p, im, m, tk, ut, k, xt: _generate(p, im, m, tk, ut, k, xt, model=jm, ddim_steps=steps,
                                                            eta=eta, guidance_scale=quality.GUIDANCE, sampler=sampler))
    return np.asarray(gen(params, jnp.asarray(image), jnp.asarray(mask), jnp.asarray(pipe.prompt_tokens(1)),
                          jnp.asarray(pipe.uncond_tokens(1)), key, x_T), np.float32)


def psnr_np(a, b) -> float:
    return float(10 * np.log10(4.0 / max(float(((a.astype(np.float64) - b) ** 2).mean()), 1e-12)))


def assert_eps_close(got: list[dict], ref: list[dict], arms=("bf16", "int8")) -> None:
    assert [g["t"] for g in got] == [r["t"] for r in ref]
    for g, r in zip(got, ref):
        assert g["ref_rms"] == pytest.approx(r["ref_rms"], rel=FP32_REL), (g["t"], g["ref_rms"], r["ref_rms"])
        for arm in arms:
            tol = BF16_REL if arm == "bf16" else STAT_REL
            assert g[arm]["mean_rel"] == pytest.approx(r[arm]["mean_rel"], rel=tol), (g["t"], arm, g[arm], r[arm])
            assert g[arm]["max_rel"] == pytest.approx(r[arm]["max_rel"], rel=MAX_REL), (g["t"], arm, g[arm], r[arm])


# ---------------------------------------------------------------------------
# the random-weight helpers


def test_realistic_init_matches_the_jax_scripts_mk_leaf_for_leaf():
    """The port's ``realistic_init_`` on the tiny UNet's state_dict, carried
    to the flax tree (``torch_to_flax.convert_state_dict``): the same leaves
    as the JAX scripts' ``mk`` tree, each of the same kind: the norm scales
    exactly 1, the weights normals of std 1/sqrt(fan-in), the biases of std
    0.02 (the two draws come from different generators)."""
    from leftrefill_tpu.convert.torch_to_flax import convert_state_dict

    from leftrefill_torch.models.unet import UNetModel

    unet = UNetModel(**TINY_UNET)
    state = weights.realistic_init_(dict(unet.state_dict()), torch.Generator().manual_seed(0))
    tree, skipped = convert_state_dict({"model.diffusion_model." + k: v.numpy() for k, v in state.items()})
    assert not skipped
    ref = mk_tree(jax.eval_shape(jax_modules().unet.init, jax.random.PRNGKey(2), jnp.zeros((B, 16, 32, 9)),
                                 jnp.zeros((B,), jnp.int32), jnp.zeros((B, 77, 24)))["params"])
    ours = jax.tree_util.tree_flatten_with_path(tree["unet"])[0]
    theirs = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert [p for p, _ in ours] == list(theirs)  # tree_flatten sorts the keys on both sides
    for path, got in ours:
        want = theirs[path]
        assert got.shape == want.shape, path
        if path[-1].key == "scale":
            assert np.array_equal(got, want), path
        elif got.size >= 256:  # a weight or bias: the draw's spread within 20 % of mk's
            assert np.std(got) == pytest.approx(np.std(want), rel=0.2), path


def test_unzero_fills_only_the_all_zero_weights():
    """``unzero_`` as ``unzero_kernels``: every all-zero tensor of two or more
    axes becomes 0.02-scaled normals, everything else is left bit for bit
    (1-D zeros, weights with a single non-zero value)."""
    g = torch.Generator().manual_seed(1)
    state = {"a.weight": torch.zeros(64, 32), "b.weight": torch.zeros(8, 4, 3, 3), "c.bias": torch.zeros(16),
             "d.weight": torch.zeros(4, 4), "e.weight": torch.randn(5, 5)}
    state["d.weight"][1, 2] = 3.0
    before = {k: v.clone() for k, v in state.items()}
    weights.unzero_(state, g)
    for k in ("c.bias", "d.weight", "e.weight"):
        assert torch.equal(state[k], before[k]), k
    for k in ("a.weight", "b.weight"):
        assert state[k].abs().min() > 0 and float(state[k].std()) == pytest.approx(0.02, rel=0.15), k


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("views", [None, 2])
def test_study_forwards_dispatch_counts(monkeypatch, views, quant):
    """The studies' forwards at full width, on ``meta``: the eps sweep's 2
    rows (no K/V cache, no cfg_dup) and, for the V=2 UNet, the scene's
    CFG-doubled 4 rows with the cache reach the kernels at
    ``tools.PER_FORWARD_BF16`` / ``_INT8`` and ``PER_FORWARD_MV4`` /
    ``_MV2_INT8`` sites (``chip_smoke.py`` phase 16q pins its launches with
    them); the V=2 joint sequences are 2 x 8192, 2048, 512 and 128 tokens."""
    from collections import Counter

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    with torch.device("meta"):
        unet = (UNetModel(dtype=torch.bfloat16, quant=quant) if views is None
                else MultiViewUnetModel(view_num=views, dtype=torch.bfloat16, quant=quant))
    per = {(None, False): tools.PER_FORWARD_BF16, (None, True): tools.PER_FORWARD_INT8,
           (2, False): tools.PER_FORWARD_MV4, (2, True): tools.PER_FORWARD_MV2_INT8}[views, quant]
    for rows, cache in ((2, False),) + (((4, True),) if views else ()):
        with torch.device("meta"):
            x, ts, ctx = torch.empty(rows, 64, 128, 9), torch.empty(rows, dtype=torch.long), torch.empty(rows, 77, 1024)
        with torch.no_grad(), kernels.record_sites() as sites:
            assert unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx) if cache else None).shape == (rows, 64, 128, 4)
        assert Counter(name for name, _ in sites) == Counter({k: v for k, v in per.items() if v}), (rows, cache)
        tokens = Counter(shape[2] for name, shape in sites if name == "flash_fwd")
        assert tokens == ({16384: 5, 4096: 5, 1024: 5, 256: 1} if views else {8192: 5, 2048: 5, 512: 5})


# ---------------------------------------------------------------------------
# vae8: scripts/cpu_vae8_quality.py


def test_vae8_study_matches_jax():
    """One latent through the fp32, bf16 and int8 decoders: the three PSNRs
    as the JAX script computes them (JAX's VAE init; at the tiny widths
    every int8 conv runs on its dequantized weight on both sides, as in
    the int8 study)."""
    from leftrefill_tpu.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_tpu.ops.quant import quantize_params_like

    vae = AutoencoderKL(ddconfig=DDConfig(**TINY_VAE), embed_dim=4, dtype=jnp.bfloat16)
    img = jnp.zeros((1, 32, 64, 3))
    params = jax.jit(vae.init)(jax.random.PRNGKey(0), img)["params"]
    q_vae = vae.clone(quant_decoder=True)
    qparams = quantize_params_like(jax.eval_shape(q_vae.init, jax.random.PRNGKey(0), img)["params"], params)
    z = jax.random.normal(jax.random.PRNGKey(7), (1, 16, 32, 4), jnp.float32) / 0.18215
    dec = {name: np.asarray(jax.jit(lambda p, zz, m=m: m.apply({"params": p}, zz, method="decode"))(p, z), np.float32)
           for name, m, p in (("fp32", vae.clone(dtype=jnp.float32), params), ("bf16", vae, params),
                              ("int8", q_vae, qparams))}
    state = {k[len("first_stage_model."):]: v.float() for k, v in state_dict_from_flax({"vae": params}).items()}
    got = quality.vae8_study("cpu", arch=quality.TINY, state=state, draws={"z": t(z)})
    assert got["shape"] == [1, 32, 64, 3]
    assert got["out_rms"] == pytest.approx(float(np.sqrt((dec["fp32"] ** 2).mean())), rel=FP32_REL)
    for key, (a, b) in (("psnr_fp32_vs_bf16_db", ("fp32", "bf16")), ("psnr_bf16_vs_int8_db", ("bf16", "int8")),
                        ("psnr_fp32_vs_int8_db", ("fp32", "int8"))):
        # a PSNR's MSE within BF16_REL, 10 log10(1.15) = 0.61 dB: every decoder computes in bf16, and at
        # the tiny widths the int8 one differs from the bf16 one by its weights' quantization alone, a
        # difference of the bf16 rounding's size (the two sides' bf16 gap shows in all three)
        assert got[key] == pytest.approx(psnr_np(dec[a], dec[b]), abs=10 * np.log10(1 + BF16_REL)), (key, got[key])
