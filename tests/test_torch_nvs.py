"""The port's novel-view-synthesis modules against the JAX package's on the
CPU, in fp32, at the tiny configuration of tests/test_nvs.py: the relative
pose MLP, the pose-conditioned prompt embedder (pose slot, pos_strengthen,
CFG dropout with JAX's draws), the refinement CNN, the separator-column UNet
with its c_input residual (and the port's cfg_dup and K/V cache), the
conditioning modes, the structure sampler, ``NVSTask.log_images`` end to end
and the converter's NVS trees; then the full-width NVS forward's kernel
sites on ``meta``.  Tolerance: fp32 module parity 1e-5 relative to max|ref|,
the tiny canvas 1e-4 absolute (see test_torch_parity_utils)."""

import dataclasses
import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import CANVAS_ABS, FP32_REL, init_flax, j, rel_err, t

from leftrefill_torch.convert.from_jax import state_dict_from_flax

TINY_UNET = dict(in_channels=9, model_channels=32, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=16)
TINY_CLIP = dict(vocab_size=49408, width=16, heads=2, layers=2, num_special_tokens=4)
TINY_VAE8 = dict(z_channels=4, resolution=64, ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1)  # f8, as SD2's
SD2 = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120)


def _unet_pair(use_sep: bool, in_channels: int = 9, seed: int = 0, context_dim=16):
    """``context_dim`` None: no context, the cross-attentions attend to x
    (the ``concat`` conditioning)."""
    from leftrefill_tpu.models.nvs import NVSUnetModel as JN

    from leftrefill_torch.models.nvs import NVSUnetModel as TN

    cfg = {**TINY_UNET, "in_channels": in_channels, "context_dim": context_dim}
    ju = JN(use_sep=use_sep, **cfg)
    p = init_flax(ju, seed, jnp.zeros((1, 8, 16, in_channels)), jnp.zeros((1,), jnp.int32),
                  None if context_dim is None else jnp.zeros((1, 7, 16)))
    tu = TN(use_sep=use_sep, **cfg)
    sd = state_dict_from_flax({"unet": p})
    tu.load_state_dict({k[len("model.diffusion_model."):]: v for k, v in sd.items()}, strict=True)
    return ju, p, tu.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["sep_off", "sep_on"])
def nvs_unets(request):
    return request.param, _unet_pair(request.param)


def _inputs(seed: int = 5, rows: int = 2):
    rng = np.random.RandomState(seed)
    x = np.repeat(rng.standard_normal((1, 8, 16, 9)).astype(np.float32), rows, axis=0)  # CFG layout
    ts = np.full((rows,), 421)
    ctx = rng.standard_normal((rows, 7, 16)).astype(np.float32)
    c_full = np.repeat(rng.standard_normal((1, 8, 16, 32)).astype(np.float32), rows, axis=0)
    return x, ts, ctx, c_full


@pytest.mark.parametrize("c_input", ["none", "full", "right_half"])
def test_nvs_unet_matches_jax(nvs_unets, c_input):
    """Separator columns on and off, c_input over the full width and over
    the right half."""
    use_sep, (ju, p, tu) = nvs_unets
    x, ts, ctx, c_full = _inputs()
    ci = {"none": None, "full": c_full, "right_half": c_full[:, :, 8:]}[c_input]
    fn = jax.jit(lambda p, x, ts, ctx, ci: ju.apply({"params": p}, x, ts, ctx, c_input=ci))
    ref = fn(p, j(x), j(ts.astype(np.int32)), j(ctx), None if ci is None else j(ci))
    with torch.no_grad():
        out = tu(t(x), torch.from_numpy(ts), t(ctx), c_input=None if ci is None else t(ci))
    assert out.shape == (2, 8, 16, 4) and np.abs(np.asarray(ref)).max() > 0.1
    assert rel_err(out, ref) < FP32_REL
    assert {k for k, _ in tu.named_parameters() if k.startswith("sep_token")} == \
        ({f"sep_token.{c}" for c in (9, 32, 64, 96, 128)} if use_sep else set())


def test_nvs_unet_cfg_dup_and_kv_cache_with_c_input(nvs_unets):
    """The port's shared CFG prefix (half batch up to the first
    cross-attention, c_input halved with it) and K/V cache against JAX's
    plain forward, and bit-equal to the port's own plain forward."""
    _, (ju, p, tu) = nvs_unets
    x, ts, ctx, c_full = _inputs()
    ref = jax.jit(lambda p, x, ts, ctx, ci: ju.apply({"params": p}, x, ts, ctx, c_input=ci))(
        p, j(x), j(ts.astype(np.int32)), j(ctx), j(c_full))
    with torch.no_grad():
        plain = tu(t(x), torch.from_numpy(ts), t(ctx), c_input=t(c_full))
        dup = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=tu.cross_kv(t(ctx)), cfg_dup=True,
                 c_input=t(c_full))
    assert torch.equal(dup, plain)
    assert rel_err(dup, ref) < FP32_REL


@pytest.mark.parametrize("pos_strengthen", [False, True])
def test_rel_pos_model_matches_jax(pos_strengthen):
    from leftrefill_tpu.models.nvs import RelPosModel as JR

    from leftrefill_torch.models.nvs import RelPosModel as TR

    jr = JR(out_ch=32, pos_strengthen=pos_strengthen)
    pose = np.random.RandomState(1).standard_normal((3, 4)).astype(np.float32)
    p = init_flax(jr, 2, jnp.zeros((1, 4)))
    tr = TR(4, 32, pos_strengthen)
    sd = state_dict_from_flax({"cond": {"rel_pos_model": p}})
    tr.load_state_dict({k[len("cond_stage_model.rel_pos_model."):]: v for k, v in sd.items()}, strict=True)
    r1, r2 = jr.apply({"params": p}, j(pose))
    with torch.no_grad():
        o1, o2 = tr(t(pose))
    assert rel_err(o1, r1) < FP32_REL
    assert (o2 is None) == (r2 is None) == (not pos_strengthen)
    if pos_strengthen:
        assert rel_err(o2, r2) < FP32_REL


def _embedder_pair(pos_strengthen: bool, cfg_rate: float, num_special_tokens: int = 4, seed: int = 3):
    from leftrefill_tpu.models.nvs import NVSCLIPEmbedder as JE

    from leftrefill_torch.models.nvs import NVSCLIPEmbedder as TE

    kw = {**TINY_CLIP, "num_special_tokens": num_special_tokens}
    je = JE(pos_strengthen=pos_strengthen, cfg_rate=cfg_rate, **kw)
    p = init_flax(je, seed, jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 4)))
    te = TE(pos_strengthen=pos_strengthen, cfg_rate=cfg_rate, **kw)
    sd = state_dict_from_flax({"cond": p})
    te.load_state_dict({k[len("cond_stage_model."):]: v for k, v in sd.items()}, strict=True)
    return je, p, te.eval()


def _tiny_tokenizer(n: int):
    from leftrefill_torch.models.clip import build_prompt_tokenizer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_prompt_tokenizer([f"repeat_{n}_<special-token>"], None)


@pytest.mark.parametrize("pos_strengthen,cfg", [(False, False), (True, False), (False, True), (True, True)])
def test_nvs_embedder_matches_jax(pos_strengthen, cfg):
    """The pose token at slot num_special_tokens + 1, pos_strengthen's last
    token, and the CFG dropout with JAX's own uniform draws handed to the
    port (two of the four rows dropped)."""
    from leftrefill_torch.data.datasets import build_prompt

    je, p, te = _embedder_pair(pos_strengthen, 0.5)
    tok, _, _ = _tiny_tokenizer(4)
    tokens = np.repeat(tok.tokenize(build_prompt(4, "<special-token>")), 4, axis=0)
    pose = np.random.RandomState(4).standard_normal((4, 4)).astype(np.float32)
    null = tok.tokenize("")
    key = jax.random.PRNGKey(7)
    draws = np.asarray(jax.random.uniform(key, (4,)))
    if cfg:
        assert 0 < (draws < 0.5).sum() < 4
    kw = dict(null_tokens=j(null), cfg_key=key) if cfg else {}
    ref = je.apply({"params": p}, j(tokens), j(pose), **kw)
    with torch.no_grad():
        out = te(torch.from_numpy(tokens).long(), t(pose), null_tokens=torch.from_numpy(null).long() if cfg else None,
                 cfg_draws=t(draws) if cfg else None)
        no_pose = te(torch.from_numpy(tokens).long())
    assert rel_err(out, ref) < FP32_REL
    kept = ~(draws < 0.5) if cfg else np.ones(4, bool)
    assert not torch.allclose(out[kept], no_pose[kept])  # the pose reaches the context


def test_73_token_prompt_context_matches_jax():
    """The NVS prompt, ``build_prompt(73, "<special-token>")``, tokenized by
    both tokenizers and embedded with a pose: the pose takes slot 74, the
    prompt's end-of-text token."""
    from leftrefill_tpu.data.datasets import build_prompt as jbuild
    from leftrefill_tpu.models.clip import build_prompt_tokenizer as jtok

    from leftrefill_torch.data.datasets import build_prompt

    text = build_prompt(73, "<special-token>")
    assert text == jbuild(73, "<special-token>")
    tok, sp, _ = _tiny_tokenizer(73)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt, jsp, _ = jtok(["repeat_73_<special-token>"], None)
    assert sp == jsp
    tokens = tok.tokenize([text, text])
    assert np.array_equal(tokens, jt.tokenize([text, text]))
    assert tokens[0, 74] == tok.eot_token and (tokens[0, 1:74] >= 49408).all()
    je, p, te = _embedder_pair(False, 0.15, num_special_tokens=73)
    pose = np.random.RandomState(6).standard_normal((2, 4)).astype(np.float32)
    ref = je.apply({"params": p}, j(tokens), j(pose))
    with torch.no_grad():
        out = te(torch.from_numpy(tokens).long(), t(pose))
    assert rel_err(out, ref) < FP32_REL


def _tiny_nvs_bundles(refinement: bool = True, use_sep: bool = False, seed: int = 0):
    """The tiny NVS bundle on both sides (f8 VAE, so the refinement branch's
    1/8-resolution output meets the latent), the same seeded weights:
    (JAX task, JAX params, the port's bundle)."""
    from leftrefill_tpu.config import CondStageBundle, ModelBundle
    from leftrefill_tpu.diffusion.core import LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD
    from leftrefill_tpu.models.nvs import NVSCLIPEmbedder as JE, NVSUnetModel as JN
    from leftrefill_tpu.tasks import NVSTask as JT

    from leftrefill_torch.diffusion.core import LeftRefillModel as TM
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS
    from leftrefill_torch.models.autoencoder import AutoencoderKL as TV, DDConfig as TD
    from leftrefill_torch.models.nvs import NVSCLIPEmbedder as TE, NVSUnetModel as TN, RefinementCNN
    from leftrefill_torch.pipeline import NVSBundle

    tok, sp, _ = _tiny_tokenizer(4)
    ref_cfg = {"use_input_refinement": refinement, "only_masked_refine": False}
    jm = JM(unet=JN(use_sep=use_sep, **TINY_UNET), vae=JV(ddconfig=JD(**TINY_VAE8), embed_dim=4),
            cond_model=JE(cfg_rate=0.15, **TINY_CLIP), schedule=DiffusionSchedule.create(**SD2),
            conditioning_key="hybrid-refine")
    bundle = ModelBundle(model=jm, cond_bundle=CondStageBundle(jm.cond_model, tok, sp, None), data_config={},
                         save_prompt_only=False, task_target="inpainting_ldm.NVS_ldm.NVSLDM", raw_config={},
                         refinement_config=ref_cfg)
    task = JT(bundle)
    params = {
        "unet": init_flax(jm.unet, seed, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 77, 16))),
        "vae": init_flax(jm.vae, seed + 1, jnp.zeros((1, 64, 128, 3))),
        "cond": init_flax(jm.cond_model, seed + 2, jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 4))),
    }
    if refinement:
        params["refine"] = init_flax(task.refinement, seed + 3, jnp.zeros((1, 64, 128, 3)),
                                     jnp.zeros((1, 64, 128, 1)))
    tm = TM(TN(use_sep=use_sep, **TINY_UNET), TV(TD(**TINY_VAE8), embed_dim=4), TE(cfg_rate=0.15, **TINY_CLIP),
            TS.create(**SD2), conditioning_key="hybrid-refine",
            refinement=RefinementCNN(TINY_UNET["model_channels"]) if refinement else None)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return task, params, NVSBundle(tm.eval(), tok, sp, ref_cfg)


def _nvs_batch(tok, seed: int = 8, rows: int = 2):
    from leftrefill_torch.data.datasets import build_prompt, get_relative_pose

    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (rows, 64, 128, 3)).astype(np.float32)
    mask = np.zeros((rows, 64, 128, 1), np.float32)
    mask[:, :, 64:] = 1.0
    cams = [np.concatenate([np.linalg.qr(rng.standard_normal((3, 3)))[0], rng.standard_normal((3, 1))], 1)
            for _ in range(rows + 1)]
    return {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
            "tokens": tok.tokenize([build_prompt(4, "<special-token>")] * rows),
            "rel_pose": np.stack([get_relative_pose(c, cams[0]) for c in cams[1:]])}


def test_refinement_cnn_matches_jax():
    """The refinement residual at a non-zero alpha, through the bundle's
    ``refine`` (the converter's ``refine`` root)."""
    task, params, bundle = _tiny_nvs_bundles()
    batch = _nvs_batch(bundle.tokenizer)
    assert float(params["refine"]["refinement_alpha"]) != 0
    ref = task.refinement.apply({"params": params["refine"]}, j(batch["masked_image"]), j(batch["mask"]))
    with torch.no_grad():
        out = bundle.model.refine(t(batch["masked_image"]), t(batch["mask"]))
    assert out.shape == (2, 8, 16, 32)
    assert rel_err(out, ref) < FP32_REL


@pytest.mark.parametrize("guidance", [2.5, 1.0])
def test_nvs_task_log_images_matches_jax(guidance):
    """``NVSTask.log_images`` end to end (DDIM-4, eta 1, the refinement
    branch on) against JAX's on the same weights, x_T, per-step noise and
    VAE noise: CFG with the shared c_concat and c_input at g 2.5, none at g 1."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian

    from leftrefill_torch.tasks import NVSTask

    task, params, bundle = _tiny_nvs_bundles()
    batch = _nvs_batch(bundle.tokenizer)
    steps, shape, key = 4, (2, 8, 16, 4), jax.random.PRNGKey(11)
    step_key, init_key = jax.random.split(key)  # ddim_sample's own split
    x_T = jax.random.normal(init_key, shape)
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape) for i in range(steps)]
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape)
    ref = task.log_images(params, batch, ddim_steps=steps, ddim_eta=1.0, unconditional_guidance_scale=guidance,
                          key=key)["pred"]
    out = NVSTask(bundle, device="cpu").log_images(
        batch, ddim_steps=steps, ddim_eta=1.0, unconditional_guidance_scale=guidance, x_T=t(x_T),
        noise_fn=lambda i, s: t(noise[i]), vae_noise=t(vae_noise))["pred"]
    assert out.shape == (2, 64, 128, 3) and float(out.abs().max()) <= 1.0
    assert np.abs(out.numpy() - np.asarray(ref)).max() < CANVAS_ABS
    assert not torch.allclose(out[0], out[1])  # the two poses differ


@pytest.mark.parametrize("mode", ["concat", "crossattn", "hybrid", "hybrid-refine"])
def test_conditioning_modes_match_jax(mode):
    """``apply_model`` under each conditioning key against JAX's."""
    from leftrefill_tpu.diffusion.core import Conditioning as JC, LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule

    from leftrefill_torch.diffusion.core import Conditioning, LeftRefillModel
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS

    ju, p, tu = _unet_pair(False, in_channels=4 if mode == "crossattn" else 9, seed=4,
                           context_dim=None if mode == "concat" else 16)
    jm = JM(unet=ju, vae=None, cond_model=None, schedule=DiffusionSchedule.create(**SD2), conditioning_key=mode)
    tm = LeftRefillModel(tu, None, None, TS.create(**SD2), conditioning_key=mode)
    x, ts, ctx, c_full = _inputs(rows=2)
    z, c_cat = x[..., :4], x[..., 4:]
    ci = c_full if mode == "hybrid-refine" else None
    ref = jax.jit(lambda p, z, ts, cc, cx, ci: jm.apply_model({"unet": p}, z, ts, JC(cc, cx, ci)))(
        p, j(z), j(ts.astype(np.int32)), j(c_cat), j(ctx), None if ci is None else j(ci))
    with torch.no_grad():
        out = tm.apply_model(t(z), torch.from_numpy(ts), Conditioning(t(c_cat), t(ctx), None if ci is None else t(ci)))
    assert rel_err(out, ref) < FP32_REL
    assert (tm.cross_attention_kv(t(ctx)) is None) == (mode == "concat")


def test_hybrid_refine_without_c_input_is_hybrid():
    from leftrefill_torch.diffusion.core import Conditioning, LeftRefillModel
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS

    _, _, tu = _unet_pair(True, seed=6)
    x, ts, ctx, _ = _inputs()
    c = Conditioning(t(x[..., 4:]), t(ctx))
    with torch.no_grad():
        outs = [LeftRefillModel(tu, None, None, TS.create(**SD2), conditioning_key=k).apply_model(
            t(x[..., :4]), torch.from_numpy(ts), c) for k in ("hybrid", "hybrid-refine")]
    assert torch.equal(*outs)
    with pytest.raises(NotImplementedError):
        LeftRefillModel(tu, None, None, TS.create(**SD2), conditioning_key="adm")
    model = LeftRefillModel(tu, None, None, TS.create(**SD2))
    model.conditioning_key = "adm"
    with pytest.raises(NotImplementedError):
        model.apply_model(t(x[..., :4]), torch.from_numpy(ts), c)


def test_concat_batch_is_none_only_where_both_sides_are():
    """[other; self] per field, c_input carried; a field present on one side
    only is an error (JAX's concatenate), not a silent None."""
    from leftrefill_torch.diffusion.core import Conditioning

    a, b = torch.zeros(1, 2), torch.ones(1, 2)
    c = Conditioning(c_crossattn=b, c_input=b).concat_batch(Conditioning(c_crossattn=a, c_input=a))
    assert c.c_concat is None
    assert torch.equal(c.c_crossattn, torch.cat([a, b])) and torch.equal(c.c_input, torch.cat([a, b]))
    with pytest.raises(TypeError):
        Conditioning(c_concat=b).concat_batch(Conditioning())
    with pytest.raises(TypeError):
        Conditioning().concat_batch(Conditioning(c_concat=a))


@pytest.mark.parametrize("Tm", [0, 2, 5])
def test_structure_ddim_matches_jax(Tm):
    """Two phases (guided [uncond; cond; cond_simple] for the indices >= Tm,
    cond_simple alone below), eta 1, JAX's x_T and both phases' noise
    injected; a model whose output depends on the row's conditioning."""
    from leftrefill_tpu.diffusion.core import Conditioning as JC
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.diffusion.structure_ddim import structure_ddim_sample as jsample

    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TS
    from leftrefill_torch.diffusion.structure_ddim import structure_ddim_sample

    @dataclasses.dataclass(frozen=True)
    class FakeModel:
        schedule: DiffusionSchedule
        parameterization: str = "eps"

    n, shape = 5, (2, 4, 4, 3)  # DDIM step counts divide the 1000 training steps
    jsched = DiffusionSchedule.create(**SD2)
    tables = jsched.ddim_tables(n, eta=1.0)
    rng = np.random.RandomState(2)
    ctxs = [rng.standard_normal((2, 1, 3)).astype(np.float32) for _ in range(3)]  # uncond, cond, cond_simple
    key = jax.random.PRNGKey(9)
    step_key, _ = jax.random.split(key)  # the sampler's own split
    x_T = jax.random.normal(jax.random.PRNGKey(10), shape)

    def apply_j(x, ts, c):
        return 0.3 * x + c.c_crossattn[:, None] + 1e-4 * ts[:, None, None, None].astype(x.dtype)

    def apply_t(x, ts, c):
        return 0.3 * x + c.c_crossattn[:, None] + 1e-4 * ts[:, None, None, None].to(x.dtype)

    assert tables.num_steps == n
    ref = jax.jit(lambda: jsample(FakeModel(jsched), apply_j, tables, JC(c_crossattn=j(ctxs[1])),
                                  JC(c_crossattn=j(ctxs[2])), key, shape, uncond=JC(c_crossattn=j(ctxs[0])),
                                  guidance_scale=2.0, cond_weight=0.3, Tm=Tm, x_T=x_T))()

    def noise_fn(i, s):
        phase, k = (2, i) if i < n - Tm else (3, i - (n - Tm))
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, phase), k), s))

    out = structure_ddim_sample(apply_t, TS.create(**SD2), TS.create(**SD2).ddim_tables(n, eta=1.0),
                                Conditioning(c_crossattn=t(ctxs[1])), Conditioning(c_crossattn=t(ctxs[2])), shape,
                                uncond=Conditioning(c_crossattn=t(ctxs[0])), guidance_scale=2.0, cond_weight=0.3,
                                Tm=Tm, x_T=t(x_T), noise_fn=noise_fn)
    assert rel_err(out, ref) < FP32_REL


def test_converter_round_trip_with_nvs_trees():
    """sep_token, rel_pos_model and the refine root: the port's state_dict of
    the JAX trees converts back to them exactly, and every key loads."""
    from leftrefill_tpu.convert.torch_to_flax import convert_state_dict

    _, params, bundle = _tiny_nvs_bundles(use_sep=True)
    sd = state_dict_from_flax(params)
    assert {"model.diffusion_model.sep_token.9", "refinement_alpha", "refinement_model.17.weight",
            "cond_stage_model.rel_pos_model.mlp1.2.bias"} <= set(sd)
    back, skipped = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    assert not skipped
    flat = lambda tree: {"/".join(str(p.key) for p in path): np.asarray(v)  # noqa: E731
                         for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    for root in params:
        a, b = flat(back[root]), flat(params[root])
        assert a.keys() == b.keys(), root
        assert all(a[k].shape == b[k].shape and np.array_equal(a[k], b[k]) for k in a), root
    assert set(bundle.model.state_dict()) == set(sd)


# ---------------------------------------------------------------------------
# the full-width NVS forward's kernel sites, on meta


@pytest.mark.parametrize("use_sep,batch", [(False, 1), (True, 1), (False, 4)])
def test_full_width_nvs_dispatch_counts(monkeypatch, use_sep, batch):
    """One CFG-batch-2 forward of the 865M NVS UNet at the 256x512 canvas
    (32x64 latent, cfg_dup and the K/V cache on, c_input over the full
    width): K1 at 2048 and 512 tokens, K2 at the 32x64 and 16x32 levels, K3
    at 4096, 1024 and 256 rows (``tools.PER_FORWARD_NVS``).  With the
    separator columns the sequences (2080, 528, 136 tokens; 4160, 1056, 272
    rows) are no multiples of 128: K1 and K3 refuse them and run only in the
    two output blocks that end in an Upsample (no column there), and K2 takes
    the 32x65 and 16x33 levels (``tools.PER_FORWARD_NVS_SEP``).  Four poses
    in one request (CFG batch 8) give the middle block 256 rows, which K3
    takes too (``tools.PER_FORWARD_NVS_B4``)."""
    from leftrefill_torch import kernels, tools
    from leftrefill_torch.models.nvs import NVSUnetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    with torch.device("meta"):
        unet = NVSUnetModel(dtype=torch.bfloat16, use_sep=use_sep)
        rows = 2 * batch
        x, ts, ctx = torch.empty(rows, 32, 64, 9), torch.empty(rows, dtype=torch.long), torch.empty(rows, 77, 1024)
        ci = torch.empty(rows, 32, 64, 320)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=True, c_input=ci)
    assert out.shape == (rows, 32, 64, 4)
    expected = tools.PER_FORWARD_NVS_SEP if use_sep else tools.PER_FORWARD_NVS_B4 if batch == 4 else \
        tools.PER_FORWARD_NVS
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in expected.items() if v})
    assert set(expected) == set(tools.LAUNCH_COUNTERS)
    by_shape = Counter((name, shape) for name, shape in sites)
    if use_sep:
        assert {s[2] for (n, s) in by_shape if n == "conv3x3"} == {65, 64, 33, 32}
        assert {s for (n, s) in by_shape if n not in ("conv3x3", "group_norm")} == {
            (2, 10, 512, 512, 64), (1024, 640, 2560, 640), (256, 1280, 5120, 1280)}
        assert sorted(tu.shape for tu in unet.sep_token.values()) == [(c,) for c in (9, 320, 640, 960, 1280, 1920, 2560)]
    elif batch == 1:
        assert Counter(s[2] for (n, s) in sites if n == "flash_fwd") == {2048: 5, 512: 5}
        assert Counter(s[0] for (n, s) in sites if n == "geglu") == {4096: 5, 1024: 5, 256: 5}
    else:
        assert Counter(s[0] for (n, s) in sites if n == "geglu") == {16384: 5, 4096: 5, 1024: 5, 256: 1}
