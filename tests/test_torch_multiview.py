"""Multi-view inpainting in the port against the JAX package on the CPU: the
tiny multi-view UNet in its three fold modes (V=2 and V=4), the
multi-view prompt set-up, the converter on the multi-view trees, the
multi-view request, the multi-cond ``ddim_multi_sample``, and the flash
plain version against JAX's streaming-K/V kernel K11 (interpret mode).

On the CPU both UNets take the exact softmax, so the UNet tests hold the
folds and the modules; the K11 test holds the flash math.  Tolerances
(test_torch_parity_utils): fp32 1e-5 relative to max|ref| for the UNet, the
tiny canvas 1e-4 absolute, bf16 2e-2 relative to max|ref| for one flash
call and 3e-2 rel L2 for a whole bf16 UNet forward (``BF16_UNET_L2``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import (BF16_REL, CANVAS_ABS, FP32_REL, TINY_CLIP, TINY_UNET, TINY_VAE, init_flax, j,
                                     load_port, rel_err, rel_l2, t)

from leftrefill_torch.convert.from_jax import state_dict_from_flax

# a whole bf16 forward of the tiny UNet: its bf16 rounding alone moves it by
# 1.8e-2 rel L2 (JAX's bf16 forward against JAX's fp32 forward), and the
# 1-reference tiny UNet in bf16 differs from JAX's by 2.1e-2; the folds
# measure 2.1e-2 to 2.2e-2 (the fp32 runs hold the folds at 1e-5)
BF16_UNET_L2 = 3e-2
# (view_num, concat_target, no_rearrange_selfattn, rows): two scenes each
FOLDS = [(2, False, False, 4), (4, False, False, 8), (3, True, False, 4), (3, True, True, 4)]


@pytest.fixture(scope="module")
def tiny_tree():
    from leftrefill_tpu.models.unet import UNetModel as JU

    return init_flax(JU(**TINY_UNET), 41, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, 77, 24)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("view_num,concat_target,no_rearrange,rows", FOLDS)
def test_tiny_multiview_unet_matches_jax(tiny_tree, dtype, view_num, concat_target, no_rearrange, rows):
    """The joint self-attention folds (b·v, hw, c) -> (b, v·hw, c), the
    concat_target target-half scatter and the no-rearrange grouping, on
    8x16 latents (a [view | target] canvas of 8x8 halves), with and without
    the cross-attention K/V cache."""
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV

    from leftrefill_torch.models.multiview import MultiViewUnetModel

    kw = dict(view_num=view_num, concat_target=concat_target, no_rearrange_selfattn=no_rearrange)
    rng = np.random.RandomState(view_num + rows)
    x = rng.standard_normal((rows, 8, 16, 9)).astype(np.float32)
    ts = np.array([700] * rows)
    ctx = rng.standard_normal((rows, 77, 24)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt, ct = torch.from_numpy(x).to(tdt), torch.from_numpy(ctx).to(tdt)
    ju = JMV(**kw, **TINY_UNET, dtype=getattr(jnp, dtype))
    ref = jax.jit(lambda p, a, b, c: ju.apply({"params": p}, a, b, c))(
        tiny_tree, jnp.asarray(xt.float().numpy()).astype(dtype), j(ts.astype(np.int32)),
        jnp.asarray(ct.float().numpy()).astype(dtype))
    tu = load_port(MultiViewUnetModel(**kw, **TINY_UNET, dtype=tdt), "unet", tiny_tree)
    with torch.no_grad():
        out = tu(xt, torch.from_numpy(ts), ct)
        out_kv = tu(xt, torch.from_numpy(ts), ct, cross_kv=tu.cross_kv(ct))
    assert out.shape == (rows, 8, 16, 4) and out.dtype == tdt
    assert torch.equal(out, out_kv)
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 0.1
    if dtype == "float32":
        assert rel_err(out.float().numpy(), ref) < FP32_REL
    else:
        assert rel_l2(out.float().numpy(), ref) < BF16_UNET_L2
    if not concat_target:  # the views see each other: view 0 moves with view 1's content
        x2 = xt.clone()
        x2[1] += 1
        with torch.no_grad():
            assert not torch.equal(tu(x2, torch.from_numpy(ts), ct)[0], out[0])


def test_multiview_unet_refuses_cfg_dup(tiny_tree):
    """JAX's multi-view block drops ``dup_to_context`` and its multi-view
    sampling never passes ``cfg_dup``: the port raises where it is asked."""
    from leftrefill_torch.models.multiview import MultiViewUnetModel

    tu = load_port(MultiViewUnetModel(view_num=2, **TINY_UNET), "unet", tiny_tree)
    x = torch.zeros(4, 8, 16, 9)
    with torch.no_grad(), pytest.raises(ValueError, match="cfg_dup"):
        tu(x, torch.zeros(4, dtype=torch.long), torch.zeros(4, 77, 24), cfg_dup=True)


@pytest.mark.parametrize("view_num", [2, 4])
def test_multiview_prompts_match_jax(view_num):
    """The multi-view embedder's special tokens (``repeat_20_<special-token>``
    and 30 ``<view_direct-j-l`` tokens per view, without the closing ``>``)
    and each view's prompt (with it) tokenize to JAX's ids."""
    from leftrefill_tpu.config import build_prompt_clip
    from leftrefill_tpu.data.datasets import InpaintingMultiViewDataset

    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer

    with pytest.warns(UserWarning):
        tok, sp, prompts = build_multiview_prompt_tokenizer(view_num)
        bundle = build_prompt_clip(special_tokens=["repeat_20_<special-token>"], init_text=None,
                                   view_num=view_num, view_token_len=30, width=24, heads=2, layers=1)
    ds = object.__new__(InpaintingMultiViewDataset)
    ds.repeat_sp_token, ds.sp_token, ds.token_map, ds.mode = 20, "<special-token>", None, "test"
    ds.view_num, ds.view_token_len, ds.concat_target = view_num, 30, False
    assert sp == bundle.special_tokens and len(sp) == 20 + 30 * view_num
    assert prompts == ds.get_view_prompts()
    ids = tok.tokenize(prompts + [""])
    assert np.array_equal(ids, bundle.tokenizer.tokenize(prompts + [""]))
    assert (ids >= 49408 + 20).any()  # view tokens reached


def _multiview_trees(view_num: int):
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder as JC
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV

    n_special = 20 + 30 * view_num
    jm = dict(unet=JMV(view_num=view_num, **TINY_UNET), vae=JV(ddconfig=JD(**TINY_VAE), embed_dim=4),
              cond=JC(**{**TINY_CLIP, "num_special_tokens": n_special}))
    params = {
        "unet": init_flax(jm["unet"], 51, jnp.zeros((view_num, 8, 16, 9)), jnp.zeros((view_num,), jnp.int32),
                          jnp.zeros((view_num, 77, 24))),
        "vae": init_flax(jm["vae"], 52, jnp.zeros((1, 32, 32, 3))),
        "cond": init_flax(jm["cond"], 53, jnp.zeros((1, 77), jnp.int32)),
    }
    return jm, params, n_special


def test_multiview_trees_load_strict():
    """The JAX multi-view UNet's tree and the multi-view embedder's (a
    special-token table of 20 + 30·V rows) load into the port strictly."""
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.multiview import MultiViewUnetModel

    _, params, n_special = _multiview_trees(4)
    load_port(MultiViewUnetModel(view_num=4, **TINY_UNET), "unet", params["unet"])
    cond = load_port(PromptCLIPEmbedder(**{**TINY_CLIP, "num_special_tokens": n_special}), "cond", params["cond"])
    assert cond.special_embeddings.weight.shape == (140, 24)


def _tiny_multiview_model(view_num: int, params):
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.pipeline import sd2_schedule

    n_special = 20 + 30 * view_num
    tm = LeftRefillModel(MultiViewUnetModel(view_num=view_num, **TINY_UNET), AutoencoderKL(DDConfig(**TINY_VAE), embed_dim=4),
                         PromptCLIPEmbedder(**{**TINY_CLIP, "num_special_tokens": n_special}), sd2_schedule())
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return tm.eval()


def test_multiview_request_matches_jax(monkeypatch):
    """One scene of V=2 32x32 views (view 0 masked, view 1 unmasked) through
    the port's ``MultiViewInpaintPipeline`` and JAX's ``_generate`` over the
    flat views (the DDIM sampling of ``MultiViewRefInpaintTask.log_images``,
    no shared CFG prefix), fp32, 4 DDIM steps at eta 1, CFG 2.5, with JAX's
    x_T, step noise and VAE noise fed to the port."""
    import warnings

    from leftrefill_tpu.diffusion.core import LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian
    from leftrefill_tpu.pipeline import _generate

    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer
    from leftrefill_torch.pipeline import MultiViewInpaintPipeline

    monkeypatch.setenv("LEFTREFILL_CFG_DUP", "0")
    v, steps = 2, 4
    jmods, params, _ = _multiview_trees(v)
    sched = DiffusionSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120)
    jm = JM(unet=jmods["unet"], vae=jmods["vae"], cond_model=jmods["cond"], schedule=sched)
    tm = _tiny_multiview_model(v, params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok, _, prompts = build_multiview_prompt_tokenizer(v)
    rng = np.random.RandomState(9)
    images = rng.uniform(-1, 1, (1, v, 32, 32, 3)).astype(np.float32)
    masks = np.zeros((1, v, 32, 32, 1), np.float32)
    masks[0, 0, 8:24, 4:28] = 1.0
    pipe = MultiViewInpaintPipeline(model=tm, tokenizer=tok, view_prompts=prompts, device="cpu", ddim_steps=steps)
    shape = (v, 16, 16, 4)
    key = jax.random.PRNGKey(4)
    step_key, init_key = jax.random.split(key)
    x_T = jax.random.normal(init_key, shape)
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape) for i in range(steps)]
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape)
    flat = lambda a: a.reshape(v, *a.shape[2:])
    gen = jax.jit(lambda p, im, m, tk, ut, k, xt: _generate(p, im, m, tk, ut, k, xt, model=jm, ddim_steps=steps,
                                                            eta=1.0, guidance_scale=2.5))
    ref = gen(params, j(flat(images)), j(flat(masks)), j(pipe.prompt_tokens(1)), j(pipe.uncond_tokens(1)), key, x_T)
    out = pipe(images, masks, x_T=t(x_T), noise_fn=lambda i, s: t(noise[i]), vae_noise=t(vae_noise))
    assert out.shape == (1, v, 32, 32, 3) and out.dtype == torch.float32
    assert np.abs(out.numpy()[0] - np.asarray(ref)).max() < CANVAS_ABS
    assert torch.equal(out[0, 1], torch.from_numpy(images[0, 1]))  # the unmasked view comes back as it was
    assert not torch.equal(out[0, 0], torch.from_numpy(images[0, 0]))


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_ddim_multi_sample_matches_jax(parameterization):
    """Multi-cond consistent sampling with K=2 conditionings on the tiny
    1-reference model (its schedule of ``parameterization``), fp32, 4 steps
    at eta 1, CFG 2.5, with JAX's shared x_T, step noise and right-half
    picks fed to the port."""
    from leftrefill_tpu.diffusion.core import Conditioning as JCond
    from leftrefill_tpu.diffusion.ddim import ddim_multi_sample as jax_multi

    from test_torch_parity_utils import tiny_bundles

    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.diffusion.ddim import ddim_multi_sample

    jm, params, tm, _, _ = tiny_bundles(parameterization=parameterization)
    assert jm.parameterization == tm.schedule.parameterization == parameterization
    rng = np.random.RandomState(12)
    k, steps, shape = 2, 4, (1, 8, 16, 4)
    c_concat = rng.standard_normal((k, 1, 8, 16, 5)).astype(np.float32)
    ctx = rng.standard_normal((k, 1, 77, 24)).astype(np.float32)
    uctx = rng.standard_normal((k, 1, 77, 24)).astype(np.float32)
    tables = jm.schedule.ddim_tables(steps, eta=1.0)
    key = jax.random.PRNGKey(6)
    step_key, init_key = jax.random.split(key)
    x_T = jax.random.normal(init_key, shape)
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), (k, *shape)) for i in range(steps)]
    picks = [int(jax.random.randint(jax.random.fold_in(jax.random.fold_in(step_key, 3), i), (), 0, k))
             for i in range(steps)]
    ref = jax.jit(lambda p: jax_multi(
        jm, lambda x, tt, c: jm.apply_model(p, x, tt, c), tables, JCond(j(c_concat), j(ctx)), key, shape,
        unconds=JCond(j(c_concat), j(uctx)), guidance_scale=2.5))(params)
    with torch.no_grad():
        out = ddim_multi_sample(
            tm.apply_model, tm.schedule, tm.schedule.ddim_tables(steps, eta=1.0), Conditioning(t(c_concat), t(ctx)), shape,
            unconds=Conditioning(t(c_concat), t(uctx)), guidance_scale=2.5,
            x_T=t(x_T).expand(k, *shape), noise_fn=lambda i, s: t(noise[i]), pick_fn=lambda i, n: picks[i])
    assert out.shape == shape
    assert np.abs(out.numpy() - np.asarray(ref)).max() < CANVAS_ABS


@pytest.mark.parametrize("dtype,amp", [("bfloat16", 1.0), ("bfloat16", 30.0), ("float32", 1.0)])
def test_flash_plain_matches_pallas_kvchunk(monkeypatch, dtype, amp):
    """The port's flash plain version against JAX's K11
    (``_flash_kvchunk_kernel``): the resident budget shrunk so 1024 keys
    stream in four 256-key chunks, interpret mode, the clamp softmax (amp 30
    drives logits past 75).  bf16 2e-2 * max|ref|, fp32 1e-5 * max|ref|;
    lse 1e-4 absolute (fp32 exps on both sides, summed in another order)."""
    from leftrefill_tpu.ops import flash_attention as jfa

    from leftrefill_torch.ops import flash_attention as tfa

    monkeypatch.setattr(jfa, "KV_RESIDENT_MAX", 256)
    monkeypatch.setattr(jfa, "KV_CHUNK", 256)
    assert jfa._kv_chunk_for(1024) == 256
    rng = np.random.RandomState(int(amp) + len(dtype))
    b, h, nq, nk, d = 1, 2, 256, 1024, 64
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy((rng.standard_normal((b, h, n, d)) * s).astype(np.float32)).to(tdt)
                  for n, s in ((nq, amp), (nk, 1.0), (nk, 1.0)))
    jx = lambda a: jnp.asarray(a.float().numpy()).astype(dtype)
    calls = []
    monkeypatch.setattr(jfa, "_flash_forward_kvchunk",
                        lambda *a, _f=jfa._flash_forward_kvchunk: calls.append(1) or _f(*a))
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = jfa._flash_forward(jx(qt), jx(kt), jx(vt), d**-0.5)
    assert calls == [1]
    pack = lambda a: a.transpose(1, 2).reshape(b, a.shape[2], h * d)
    o, lse = tfa.flash_forward(pack(qt), pack(kt), pack(vt), h, d**-0.5)
    ref = np.asarray(o_ref, np.float32).transpose(0, 2, 1, 3).reshape(b, nq, h * d)
    assert rel_err(o.float().numpy(), ref) < (BF16_REL if dtype == "bfloat16" else FP32_REL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref).reshape(b * h, nq), atol=1e-4, rtol=0)
    if amp > 1:
        assert float(torch.einsum("bhqd,bhkd->bhqk", qt.float(), kt.float()).max()) * d**-0.5 > 75.0
    assert tfa.flash_forward.launches == 0


def test_flash_plain_query_chunks_equal_unchunked(monkeypatch):
    """Query rows share nothing: the plain version in chunks of 64 rows
    gives exactly the one-chunk result."""
    from leftrefill_torch.ops import flash_attention as tfa

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 512, 128, generator=g).to(torch.bfloat16) for _ in range(3))
    whole = tfa.flash_forward_plain(q, k, v, 2, 0.125)  # [4, 512, 512] fp32 scores: one chunk
    monkeypatch.setattr(tfa, "SCORE_CHUNK_BYTES", 4 * 64 * 512 * 4)  # 64 query rows a chunk
    for got, want in zip(tfa.flash_forward_plain(q, k, v, 2, 0.125), whole):
        assert torch.equal(got, want)
    monkeypatch.undo()
    assert tfa.SCORE_CHUNK_BYTES // (2 * 5 * 16384 * 4) >= 64  # V=4: [10, rows, 16384] fp32 in chunks
