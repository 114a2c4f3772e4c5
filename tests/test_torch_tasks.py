"""The port's task objects against the JAX package's on the CPU in fp32, each
bundle built on both sides from the tiny YAMLs of ``tests/test_cli.py`` and
``tests/test_cli_variants.py`` through the two config systems and loaded
with the same seeded flax tree: ``build_task``'s dispatch, the 1-reference
``log_images`` at each guidance branch (CFG above 1, the unconditional
branch alone at 0, the conditional one at 1) and ``validation_metrics`` (with LPIPS),
and the multi-view task's per-view split and its validation scores, on the same x_T, per-step noise
and VAE noise as JAX's; the diagnostic rows of ``log_images`` (the
diffusion and denoise rows here, the progressive row in
``test_torch_tasks_sampling``) on JAX's row draws too, and the split of a
6-step row at V = 4, where JAX's raises.  Tolerance: the tiny canvas 1e-4
absolute, the metrics 1e-4 relative (see test_torch_parity_utils)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_cli import MODEL_YAML
from test_cli_variants import MV_MODEL_YAML
from test_torch_parity_utils import CANVAS_ABS, fill_tree, t

from leftrefill_torch.convert.from_jax import state_dict_from_flax

STEPS = 4  # DDIM step counts divide the 1000 timesteps (the upstream quirk)


def _bundles(src: str):
    """(JAX task, its params, the port's task) of a tiny model YAML."""
    from leftrefill_tpu.config import build_model_from_config as jbuild
    from leftrefill_tpu.tasks import build_task as jtask

    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.tasks import build_task

    cfg = yaml.safe_load(src)
    jb = jbuild(copy.deepcopy(cfg), dtype=jnp.float32)
    m, key, v = jb.model, jax.random.PRNGKey(0), jb.view_num
    struct = {
        "unet": jax.eval_shape(m.unet.init, key, jnp.zeros((v, 8, 16, 9)), jnp.zeros((v,), jnp.int32),
                               jnp.zeros((v, 77, m.unet.context_dim)))["params"],
        "vae": jax.eval_shape(m.vae.init, key, jnp.zeros((1, 32, 64, 3)))["params"],
        "cond": jax.eval_shape(m.cond_model.init, key, jnp.zeros((1, 77), jnp.int32))["params"],
    }
    params = {k: fill_tree(s, seed + 5) for seed, (k, s) in enumerate(struct.items())}
    bundle = build_model_from_config(copy.deepcopy(cfg), dtype=torch.float32, device="cpu")
    bundle.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jtask(jb), jax.tree_util.tree_map(jnp.asarray, params), build_task(bundle, "cpu")


def _draws(rows: int, key, steps: int = STEPS):
    """JAX's x_T, per-step noise and the VAE's fixed noise for a tiny canvas."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian

    shape = (rows, 16, 32, 4)  # the tiny VAE downsamples by 2
    step_key, init_key = jax.random.split(key)  # ddim_sample's own split
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape) for i in range(steps)]
    return dict(x_T=t(jax.random.normal(init_key, shape)), noise_fn=lambda i, s: t(noise[i]),
                vae_noise=t(jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape)))


def _batch(task, rows: int, seed: int = 2):
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (rows, 32, 64, 3)).astype(np.float32)
    mask = np.zeros((rows, 32, 64, 1), np.float32)
    mask[:, 6:26, 36:60] = 1.0
    return {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
            "tokens": task.prompt_tokens([" ".join(task.bundle.special_tokens)] * rows)}


@pytest.fixture(scope="module")
def one_ref():
    return _bundles(MODEL_YAML)


@pytest.mark.parametrize("guidance", [2.5, 0.0, 1.0])
def test_ref_task_log_images_matches_jax(one_ref, guidance):
    from leftrefill_torch.tasks import RefInpaintTask

    jt, params, task = one_ref
    assert type(task) is RefInpaintTask and type(jt).__name__ == "RefInpaintTask"
    batch, key = _batch(task, 2), jax.random.PRNGKey(4)
    ref = jt.log_images(params, batch, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=guidance, key=key)
    out = task.log_images(batch, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=guidance,
                          **_draws(2, key))
    assert out.keys() == {"pred", "origin_image", "masked_image", "mask"} <= ref.keys()
    assert out["pred"].shape == (2, 32, 64, 3) and float(out["pred"].abs().max()) <= 1.0
    assert np.abs(out["pred"].numpy() - np.asarray(ref["pred"])).max() < CANVAS_ABS


def _lpips_pair(hw: int = 32):
    """JAX's LPIPS and the port's on the same seeded weights (the lin
    weights non-negative, as trained ones are): (JAX's function, the
    port's module)."""
    from leftrefill_tpu.eval.lpips import LPIPS as JL

    from leftrefill_torch.convert.from_jax import lpips_from_flax
    from leftrefill_torch.eval.lpips import LPIPS

    jl = JL()
    struct = jax.eval_shape(jl.init, jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), jnp.zeros((1, hw, hw, 3)))
    lp_params = {k: ({"kernel": np.abs(v["kernel"])} if k.startswith("lin") else v)
                 for k, v in fill_tree(struct["params"], 7).items()}
    lp = LPIPS().eval()
    lp.load_state_dict(lpips_from_flax(lp_params), strict=True)
    return (lambda a, b: jl.apply({"params": lp_params}, a, b)), lp


def test_ref_task_validation_metrics_match_jax(one_ref):
    """PSNR and SSIM of the composited right half, as JAX's validation step
    computes them (its sample at the same draws), and with an ``lpips_fn``
    LPIPS of that composite against the origin's right half (the same
    seeded LPIPS weights on both sides)."""
    jt, params, task = one_ref
    batch, key = _batch(task, 2, seed=3), jax.random.PRNGKey(6)
    ref = jt.validation_metrics(params, batch, cfg_scale=2.5, ddim_steps=STEPS, key=key)
    got = task.validation_metrics(batch, cfg_scale=2.5, ddim_steps=STEPS, **_draws(2, key))
    assert got.keys() == ref.keys() == {"val/psnr", "val/ssim"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), k
    jfn, lp = _lpips_pair()
    ref = jt.validation_metrics(params, batch, cfg_scale=2.5, lpips_fn=jfn, ddim_steps=STEPS, key=key)
    got = task.validation_metrics(batch, cfg_scale=2.5, lpips_fn=lp, ddim_steps=STEPS, **_draws(2, key))
    assert got.keys() == ref.keys() == {"val/psnr", "val/ssim", "val/lpips"} and ref["val/lpips"] > 0
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), k


def test_multiview_task_splits_views_as_jax():
    """A 5-D batch of two V=2 scenes: flattened, sampled and split back per
    view, "reference" holding the source views; the view-0 loss options."""
    from leftrefill_torch.tasks import MultiViewRefInpaintTask

    jt, params, task = _bundles(MV_MODEL_YAML)
    assert type(task) is MultiViewRefInpaintTask and (task.view_reduced, task.view_num) == (True, 2)
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (2, 2, 32, 64, 3)).astype(np.float32)
    masks = np.zeros((2, 2, 32, 64, 1), np.float32)
    masks[:, 0, 6:26, 36:60] = 1.0
    toks = task.prompt_tokens([" ".join(task.bundle.special_tokens[:2]), " ".join(task.bundle.special_tokens[2:4])])
    batch = {"image": images, "mask": masks, "masked_image": images * (masks < 0.5),
             "tokens": np.stack([toks, toks])}
    key = jax.random.PRNGKey(8)
    ref = jt.log_images(params, batch, N=2, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=2.5, key=key)
    out = task.log_images(batch, N=2, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=2.5,
                          **_draws(4, key))
    assert out.keys() == ref.keys()
    for k in ref:
        assert tuple(out[k].shape) == np.shape(ref[k]), k
    assert np.abs(out["pred"].numpy() - np.asarray(ref["pred"])).max() < CANVAS_ABS
    assert torch.equal(out["reference"], t(images[:, 1:]))


def test_multiview_task_validation_metrics():
    """JAX's multi-view validation hands its per-view [B, V, ...] log to the
    4-D metrics and raises; the port scores the views with a hole (view 0
    of each scene): equal to JAX's metrics and LPIPS computed on those rows
    of JAX's log at the same draws."""
    from leftrefill_tpu.eval.metrics import composite_metrics as jmetrics

    jt, params, task = _bundles(MV_MODEL_YAML)
    rng = np.random.RandomState(9)
    images = rng.uniform(-1, 1, (2, 2, 32, 64, 3)).astype(np.float32)
    masks = np.zeros((2, 2, 32, 64, 1), np.float32)
    masks[:, 0, 6:26, 36:60] = 1.0
    toks = task.prompt_tokens([" ".join(task.bundle.special_tokens[:2]), " ".join(task.bundle.special_tokens[2:4])])
    batch = {"image": images, "mask": masks, "masked_image": images * (masks < 0.5), "tokens": np.stack([toks, toks])}
    key = jax.random.PRNGKey(10)
    with pytest.raises(TypeError):
        jt.validation_metrics(params, batch, cfg_scale=2.5, ddim_steps=STEPS, key=key)
    jfn, lp = _lpips_pair()
    log = jt.log_images(params, batch, ddim_steps=STEPS, unconditional_guidance_scale=2.5, key=key)
    pred, origin, mask = (np.asarray(log[k])[:, 0] for k in ("pred", "origin_image", "mask"))
    m = jmetrics(pred, origin, mask)
    ref = {"val/psnr": float(np.mean(m["psnr"])), "val/ssim": float(np.mean(m["ssim"])),
           "val/lpips": float(np.mean(jfn(m["composite"], origin[:, :, 32:])))}
    got = task.validation_metrics(batch, cfg_scale=2.5, lpips_fn=lp, ddim_steps=STEPS, **_draws(4, key))
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), k


# ---- the diagnostic rows, the multi-view split, multi_cond_sample ----------

ROW_SHAPES = {"diffusion_row": 6, "denoise_row": STEPS, "progressive_row": 5}  # steps a row keeps


def _row_draws(rows: int, key, n_t: int = 1000) -> dict:
    """JAX's draws for the rows: the diffusion row's ``fold_in(key, 1000 +
    i)`` and the DDPM loop's ``fold_in(key', t)`` (key' after ``split``)."""
    shape = (rows, 16, 32, 4)
    step_key = jax.random.split(key)[0]
    diff = [t(jax.random.normal(jax.random.fold_in(key, 1000 + i), shape)) for i in range(len(range(0, n_t, 200)) + 1)]
    ddpm = t(jax.vmap(lambda tt: jax.random.normal(jax.random.fold_in(step_key, tt), shape))(jnp.arange(n_t)))
    return dict(diffusion_noise_fn=lambda i, s: diff[i], ddpm_noise_fn=lambda tt, s: ddpm[tt])


def _check_rows(out: dict, ref: dict, rows: tuple):
    for k in ("pred", *rows):
        assert tuple(out[k].shape) == np.shape(ref[k]), k
        assert np.abs(out[k].numpy() - np.asarray(ref[k])).max() < CANVAS_ABS, k
    for k in rows:
        assert tuple(out[k].shape) == (ROW_SHAPES[k], 2, 32, 64, 3) and float(out[k].abs().max()) <= 1.0


@pytest.mark.parametrize("guidance", [2.5, 0.0])
def test_ref_task_diffusion_and_denoise_rows_match_jax(one_ref, guidance):
    """``plot_diffusion_rows`` (the encoded image q-sampled at t = 0, 200,
    ..., 800, 999) and ``plot_denoise_rows`` (the DDIM loop's x0 at every
    step of 4) beside "pred".  At g = 0 "pred" samples the unconditional
    branch alone and the rows the conditional one, as JAX's."""
    jt, params, task = one_ref
    batch, key = _batch(task, 2, seed=11), jax.random.PRNGKey(12)
    kw = dict(ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=guidance, plot_diffusion_rows=True,
              plot_denoise_rows=True)
    ref = jt.log_images(params, batch, key=key, **kw)
    out = task.log_images(batch, **kw, **_draws(2, key), **_row_draws(2, key))
    _check_rows(out, ref, ("diffusion_row", "denoise_row"))
    if guidance == 0.0:  # the rows do not follow "pred"'s unconditional branch
        assert not torch.allclose(out["denoise_row"][-1], out["pred"], atol=1e-2)


def test_multiview_row_split_at_four_views(monkeypatch):
    """At V = 4 JAX's split of a 6-step row raises (6 steps do not divide
    into scenes of 4); the port's gives [6, B, 4, ...].  Both tasks' splits
    run on the same stand-in for the 1-reference log."""
    from types import SimpleNamespace

    from leftrefill_tpu import tasks as jtasks

    from leftrefill_torch import tasks as ttasks

    log = {"pred": np.zeros((8, 4, 4, 3), np.float32), "origin_image": np.zeros((8, 4, 4, 3), np.float32),
           "diffusion_row": np.arange(6 * 8, dtype=np.float32).reshape(6, 8, 1, 1, 1) * np.ones((1, 1, 4, 4, 3))}
    bundle = SimpleNamespace(view_num=4, concat_target=False)
    monkeypatch.setattr(jtasks.RefInpaintTask, "log_images", lambda self, params, flat, N=None, **kw: log)
    jt = object.__new__(jtasks.MultiViewRefInpaintTask)
    jt.bundle = bundle
    with pytest.raises(ValueError):
        jt.log_images(None, {"image": np.zeros((8, 4, 4, 3))})
    monkeypatch.setattr(ttasks.RefInpaintTask, "log_images",
                        lambda self, flat, N=None, **kw: {k: torch.from_numpy(v.copy()) for k, v in log.items()})
    tt = object.__new__(ttasks.MultiViewRefInpaintTask)
    tt.bundle = bundle
    out = tt.log_images({"image": np.zeros((8, 4, 4, 3))})
    assert tuple(out["diffusion_row"].shape) == (6, 2, 4, 4, 4, 3) and tuple(out["pred"].shape) == (2, 4, 4, 4, 3)
    # scene b, view v of step s is flat row b * 4 + v of step s
    assert float(out["diffusion_row"][5, 1, 2, 0, 0, 0]) == 5 * 8 + 1 * 4 + 2
