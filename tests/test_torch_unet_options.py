"""The UNet, ResBlock, GroupNorm and embedder options that no shipped config
sets, against the JAX package on the CPU: ``num_heads`` (with
``num_head_channels=-1``), ``use_linear_in_transformer=False`` (1x1 conv
projections), ``conv_resample=False`` and ``use_scale_shift_norm`` on the
tiny UNet of ``tests/test_torch_unet.py``, and ``resblock_updown``, which
both packages take and ignore; the ResBlock's ``up`` / ``down`` arms; the
int8 ResBlock with scale-shift and with up/down, unfused and fused (K4's
scale-shift fold); GroupNorm's ``fast_affine``; and the embedders'
``layer="last"`` and the novel-view embedder's ``view_prompt`` through both
config builders.

Tolerances.  fp32 modules: 1e-5 relative to max|ref| (test_torch_parity_utils).
The int8 ResBlocks, JAX with the TPU dispatch forced and the Pallas kernels
in interpret mode, and a control (the port's int8 activations off) that
must fail each bound: fp32 1e-3 rel L2, as the int8 UNet's fp32 ResBlocks
(measured 5.1e-8 to 6.8e-5: the up arm's 32x64 map meets a few int8 ties;
control 1.3e-2 to 2.0e-2); the fused bf16 scale-shift block 1.2e-2 rel L2
(measured 7.8e-3, control 1.7e-2) and 2e-2 of max|ref| (BF16_REL).  In bf16
the unfused arm does not separate from its control (a bf16 ulp before the
quantization is up to half an int8 step, as in the int8 UNet); the fp32
twin holds it."""

import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from test_cli import MODEL_YAML
from test_cli_variants import NVS_MODEL_YAML
from test_torch_parity_utils import BF16_REL, FP32_REL, fill_tree, init_flax, int8_activations_off, j, load_port
from test_torch_parity_utils import rel_err, rel_l2, t
from test_torch_unet import CFG

import leftrefill_tpu.ops.conv as jconv
import leftrefill_tpu.ops.quant as jq
from leftrefill_torch import kernels
from leftrefill_torch.convert.from_jax import state_dict_from_flax

OPTIONS = {
    "num_heads": dict(num_heads=2, num_head_channels=-1),
    "conv_projections": dict(use_linear_in_transformer=False),
    "no_conv_resample": dict(conv_resample=False),
    "scale_shift_norm": dict(use_scale_shift_norm=True),
    "resblock_updown": dict(use_scale_shift_norm=True, resblock_updown=True),  # ignored: Down-/Upsamples
    "all": dict(num_heads=4, num_head_channels=-1, use_linear_in_transformer=False, conv_resample=False,
                use_scale_shift_norm=True),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_tiny_unet_option_matches_jax(option):
    """The CFG-batch-2 forward with the K/V cache and cfg_dup, and without
    them, fp32."""
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.unet import UNetModel as TU

    kw = {**CFG, **OPTIONS[option]}
    ju = JU(**kw)
    p = init_flax(ju, 19, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    tu = load_port(TU(**kw), "unet", p)
    rng = np.random.RandomState(20)
    x = np.repeat(rng.standard_normal((1, 8, 16, 9)).astype(np.float32), 2, axis=0)
    ts = np.array([777, 777])
    ctx = rng.standard_normal((2, 77, 24)).astype(np.float32)
    fwd = jax.jit(lambda p, x, ts, ctx: ju.apply({"params": p}, x, ts, ctx, cross_kv=ju.apply(
        {"params": p}, ctx, method="cross_kv"), cfg_dup=True))
    ref = fwd(p, j(x), j(ts.astype(np.int32)), j(ctx))
    with torch.no_grad():
        out = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=tu.cross_kv(t(ctx)), cfg_dup=True)
        plain = tu(t(x), torch.from_numpy(ts), t(ctx))
    assert out.shape == (2, 8, 16, 4) and np.abs(np.asarray(ref)).max() > 0.1
    assert rel_err(out, ref) < FP32_REL
    assert torch.equal(out, plain)
    if "num_heads" in OPTIONS[option]:
        assert {b.attn1.heads for st in tu.spatial_transformers() for b in st.transformer_blocks} == {kw["num_heads"]}


@pytest.mark.parametrize("scale_shift", [False, True])
@pytest.mark.parametrize("updown", ["up", "down"])
def test_updown_resblock_matches_jax(updown, scale_shift):
    """The ResBlock's resampling arms (after the first norm and SiLU, h and
    the skip input resampled before the first conv), fp32, 32 -> 32 and
    32 -> 48 channels (a skip 1x1 on the resampled input)."""
    from leftrefill_tpu.models.unet import ResBlock as JR

    from leftrefill_torch.models.unet import ResBlock as TR

    rng = np.random.RandomState(22)
    x = rng.standard_normal((2, 8, 16, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 64)).astype(np.float32)
    for cout in (32, 48):
        kw = dict(use_scale_shift_norm=scale_shift, **{updown: True})
        jr = JR(cout, **kw)
        p = init_flax(jr, 23, jnp.zeros(x.shape), jnp.zeros(emb.shape))
        ref = jr.apply({"params": p}, j(x), j(emb))
        tr = load_port(TR(32, cout, 64, **kw), "unet", p)
        with torch.no_grad():
            out = tr(t(x), t(emb))
        hw = (16, 32) if updown == "up" else (4, 8)
        assert out.shape == (2, *hw, cout) and rel_err(out, ref) < FP32_REL


def _int8_resblocks(monkeypatch, dtype: str, fused: bool, kw: dict):
    """JAX's and the port's int8 ResBlock (64 channels at 16x32, the
    sites KI1 takes) on the same quantized weights: (port output, JAX
    output, the control's output, JAX's K4 calls, the port's sites)."""
    from leftrefill_tpu.models.unet import ResBlock as JR

    from leftrefill_torch.models.unet import ResBlock as TR

    monkeypatch.setattr(jconv, "on_tpu", lambda: True)
    monkeypatch.setenv("LEFTREFILL_FUSED_RES", "1" if fused else "0")
    calls = Counter()

    def counted(*a, _f=jq.affine_silu_quant, **k):
        calls["affine_silu_quant"] += 1
        return _f(*a, **k)

    monkeypatch.setattr(jq, "affine_silu_quant", counted)
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 16, 32, 64)).astype(np.float32)
    emb = rng.standard_normal((2, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    shapes = (jnp.zeros(x.shape), jnp.zeros(emb.shape))
    fp = fill_tree(jax.eval_shape(JR(64, **kw).init, jax.random.PRNGKey(0), *shapes)["params"], 7)
    jr = JR(64, dtype=jdt, quant=True, **kw)
    q = jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(
        jax.eval_shape(jr.init, jax.random.PRNGKey(0), *shapes)["params"], fp))
    calls.clear()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jr.apply({"params": q}, jnp.asarray(x).astype(jdt), jnp.asarray(emb).astype(jdt)),
                         np.float32)
    tr = TR(64, 64, 128, dtype=tdt, quant=True, fused=fused, **kw)
    sd = state_dict_from_flax({"unet": q})
    tr.load_state_dict({k[len("model.diffusion_model."):]: v for k, v in sd.items()}, strict=True)
    xt, et = torch.from_numpy(x).to(tdt), torch.from_numpy(emb).to(tdt)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = tr(xt, et).float().numpy()
    with torch.no_grad(), int8_activations_off():
        control = tr(xt, et).float().numpy()
    return out, ref, control, calls, Counter(n for n, _ in sites)


@pytest.mark.parametrize("kw", [dict(use_scale_shift_norm=True), dict(use_scale_shift_norm=True, down=True),
                                dict(up=True)], ids=["scale_shift", "scale_shift_down", "up"])
def test_int8_resblock_options_match_jax_fp32(monkeypatch, kw):
    """The unfused int8 arm (the fp32 model takes no fused prologue; the
    up/down blocks never do), each conv on the int8 kernel's plain version."""
    out, ref, control, calls, sites = _int8_resblocks(monkeypatch, "float32", False, kw)
    assert calls == {} and sites == {"conv3x3_int8": 2}
    assert rel_l2(out, ref) < 1e-3 < rel_l2(control, ref)


def test_fused_int8_scale_shift_resblock_matches_jax(monkeypatch):
    """The fused bf16 int8 ResBlock with ``use_scale_shift_norm``: both conv
    stacks through K4 (the second with the scale-shift folded into its
    affine, ``quant.gn_affine_ab``) into KI1, as JAX's fused arm."""
    out, ref, control, calls, sites = _int8_resblocks(monkeypatch, "bfloat16", True,
                                                      dict(use_scale_shift_norm=True))
    assert calls == {"affine_silu_quant": 2} and sites == {"affine_silu_quant": 2, "conv3x3_int8": 2}
    assert rel_l2(out, ref) < 1.2e-2 < rel_l2(control, ref)
    assert rel_err(out, ref) < BF16_REL


@pytest.mark.parametrize("fast_affine", [True, False])
def test_group_norm32_module_fast_affine_matches_jax(fast_affine):
    """``group_norm32(fast_affine=...)`` on the weights of a ``GroupNorm32``
    in bf16 against JAX's module of that field, within one bf16 ulp of the
    output's largest value (XLA may contract the fp32 multiply-add PyTorch
    rounds twice); the module is the fast affine, JAX's default."""
    from leftrefill_tpu.ops.layers import GroupNorm32 as JG

    from leftrefill_torch.ops.layers import GroupNorm32, group_norm32

    rng = np.random.RandomState(26)
    x = rng.standard_normal((2, 4, 8, 64)).astype(np.float32) * 3 + 1
    jg = JG(32, eps=1e-6, fast_affine=fast_affine)
    p = init_flax(jg, 27, jnp.zeros(x.shape))
    ref = np.asarray(jg.apply({"params": p}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    g = GroupNorm32(64, eps=1e-6)
    g.load_state_dict({"weight": t(p["scale"]), "bias": t(p["bias"])})
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        out = group_norm32(xb, g.weight, g.bias, g.num_groups, g.eps, fast_affine=fast_affine)
        assert torch.equal(g(xb), out) == fast_affine
    assert out.dtype == torch.bfloat16
    assert float(np.abs(out.float().numpy() - ref).max()) <= float(np.abs(ref).max()) * 2.0**-8


def _both_builders(cfg: dict):
    """The JAX and the port bundle of one model YAML (the port's on the CPU, fp32)."""
    from leftrefill_tpu.config import build_model_from_config as jbuild

    from leftrefill_torch.config import build_model_from_config

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jbuild(cfg, dtype=jnp.float32), build_model_from_config(cfg, dtype=torch.float32, device="cpu")


def test_layer_last_through_config_matches_jax():
    """``layer: last`` runs every resblock of the text tower before ln_final
    (the penultimate layer skips the last one)."""
    cfg = yaml.safe_load(MODEL_YAML)
    cfg["model"]["params"]["cond_stage_config"]["params"]["layer"] = "last"
    jb, bundle = _both_builders(cfg)
    cm = bundle.model.cond_stage_model
    assert cm.layer == jb.model.cond_model.layer == "last" and cm.skip_last == 0
    p = init_flax(jb.model.cond_model, 28, jnp.zeros((1, 77), jnp.int32))
    load_port(cm, "cond", p)
    ids = np.asarray(bundle.tokenizer.tokenize([" ".join(bundle.special_tokens), "a photo"]))
    ref = jax.jit(lambda p, ids: jb.model.cond_model.apply({"params": p}, ids))(p, j(ids))
    with torch.no_grad():
        out = cm(torch.from_numpy(ids))
        cm.layer = "penultimate"
        penultimate = cm(torch.from_numpy(ids))
    assert rel_err(out, ref) < FP32_REL
    assert float((out - penultimate).abs().max()) > 1e-2


def test_nvs_view_prompt_through_config_matches_jax():
    """The novel-view embedder's ``view_prompt`` (2 views x 2 positions):
    the table gains ``<view_direct-j-l`` rows, the init text is not extended
    over them, the pose token's slot moves past them, and the forward with a
    relative pose matches JAX's."""
    cfg = yaml.safe_load(NVS_MODEL_YAML)
    cfg["model"]["params"]["cond_stage_config"]["params"].update(view_prompt=True, view_num=2, view_token_len=2)
    jb, bundle = _both_builders(cfg)
    sp = bundle.special_tokens
    assert sp == jb.cond_bundle.special_tokens and sp[-4:] == [f"<view_direct-{j_}-{k}" for j_ in (0, 1)
                                                               for k in (0, 1)]
    assert bundle.cond_bundle.init_text == jb.cond_bundle.init_text and len(bundle.cond_bundle.init_text) == 4
    cm = bundle.model.cond_stage_model
    assert cm.num_special_tokens == jb.model.cond_model.num_special_tokens == 8
    prompt = " ".join(sp[:4]) + "".join(f"<view_direct-1-{k}>" for k in (0, 1))
    ids = np.asarray(bundle.tokenizer.tokenize([prompt] * 2))
    np.testing.assert_array_equal(ids, np.asarray(jb.cond_bundle.tokenizer.tokenize([prompt] * 2)))
    assert (ids == 49408 + sp.index("<view_direct-1-0")).sum() == 2
    p = init_flax(jb.model.cond_model, 29, jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 4)))
    load_port(cm, "cond", p)
    pose = np.random.RandomState(30).standard_normal((2, 4)).astype(np.float32)
    ref = jax.jit(lambda p, ids, pose: jb.model.cond_model.apply({"params": p}, ids, pose))(p, j(ids), j(pose))
    with torch.no_grad():
        out = cm(torch.from_numpy(ids), rel_pose=t(pose))
    assert rel_err(out, ref) < FP32_REL


def test_option_checkpoint_loads_over_the_bundle():
    """A checkpoint in SD key layout with the options' leaves (JAX's tree
    through ``state_dict_from_flax``: conv proj_in/proj_out kernels
    [1, 1, ci, co] as OIHW [co, ci, 1, 1], the scale-shift ``emb_layers``
    at twice the width, a deep table of tokens x layers rows, the int8 VAE
    decoder's weights) loads over the port's bundle through
    ``load_over_base``: nothing missing, unexpected or of another shape,
    every value the checkpoint's (the int8 sites its fp weights quantized)."""
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder as JC
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.convert.checkpoint import load_over_base
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.ops.quant import quantize_params_like
    from leftrefill_torch.pipeline import sd2_schedule
    from test_torch_parity_utils import TINY_CLIP, TINY_VAE

    unet_kw = {**CFG, **OPTIONS["all"]}
    clip_kw = dict(TINY_CLIP, deep_prompt=True, cross_attn_layers=4)
    params = {"unet": init_flax(JU(**unet_kw), 33, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 77, 24))),
              "vae": init_flax(JV(ddconfig=JD(**TINY_VAE), embed_dim=4), 34, jnp.zeros((1, 32, 64, 3))),
              "cond": init_flax(JC(**clip_kw), 35, jnp.zeros((1, 4, 77), jnp.int32))}
    ckpt = state_dict_from_flax(params)
    assert tuple(ckpt["model.diffusion_model.input_blocks.1.1.proj_in.weight"].shape) == (16, 16, 1, 1)
    assert tuple(ckpt["model.diffusion_model.input_blocks.1.0.emb_layers.1.weight"].shape) == (32, 64)
    assert tuple(ckpt["cond_stage_model.special_embeddings.weight"].shape) == (16, 24)
    model = LeftRefillModel(UNetModel(**unet_kw), AutoencoderKL(DDConfig(**TINY_VAE), 4, quant_decoder=True),
                            PromptCLIPEmbedder(**clip_kw), sd2_schedule())
    report = load_over_base(model, ckpt)
    assert report == {"skipped": [], "missing": [], "shape_mismatch": [], "unexpected": []}
    vae_fp = {k[len("first_stage_model."):]: v for k, v in ckpt.items() if k.startswith("first_stage_model.")}
    want = {**ckpt, **{"first_stage_model." + k: v
                       for k, v in quantize_params_like(model.first_stage_model, vae_fp).items()}}
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k].to(v.dtype)), k
