"""The deep-prompt mode (one set of prompt tokens per cross-attention layer)
against the JAX package on the CPU in fp32: the tokenizer's per-layer
expansion and the embedder builder, the embedder's [B, n_layers, L, width]
output, the tiny UNet under a [B, n_layers, L, C] context (each
SpatialTransformer its own slice, in traversal order; with the K/V cache,
cfg_dup and the multi-view blocks), the task's token helpers and the deep
table's initialisation (the deep table's gradient and the training CLI:
``tests/test_torch_deep_prompt_train.py``).  Bundles come from the tiny YAML of ``tests/test_cli.py`` with
``deep_prompt`` on, built through both config systems and loaded with the
same seeded flax tree.

Tolerances (test_torch_parity_utils): fp32 module parity 1e-5 relative to
max|ref|; token ids and the initialised table exactly."""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_cli import MODEL_YAML
from test_torch_parity_utils import FP32_REL, fill_tree, init_flax, j, load_port, rel_err, t
from test_torch_unet import CFG

from leftrefill_torch.convert.from_jax import state_dict_from_flax

LAYERS = 4  # the tiny UNet's transformers: input level 0, middle, two at output level 0


def _deep_yaml(layers: int = LAYERS) -> dict:
    cfg = yaml.safe_load(MODEL_YAML)
    cfg["model"]["params"]["cond_stage_config"]["params"].update(deep_prompt=True, cross_attn_layers=layers)
    cfg["model"]["params"]["data_config"]["deep_prompt"] = True
    return cfg


@pytest.fixture(scope="module")
def deep():
    """(JAX bundle, JAX task, its params, the port's bundle, the port's task)."""
    from leftrefill_tpu.config import build_model_from_config as jbuild
    from leftrefill_tpu.tasks import build_task as jtask

    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.tasks import build_task

    cfg = _deep_yaml()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = jbuild(copy.deepcopy(cfg), dtype=jnp.float32)
        bundle = build_model_from_config(copy.deepcopy(cfg), dtype=torch.float32, device="cpu")
    m, key = jb.model, jax.random.PRNGKey(0)
    struct = {
        "unet": jax.eval_shape(m.unet.init, key, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, m.unet.context_dim)))["params"],
        "vae": jax.eval_shape(m.vae.init, key, jnp.zeros((1, 32, 64, 3)))["params"],
        "cond": jax.eval_shape(m.cond_model.init, key, jnp.zeros((1, LAYERS, 77), jnp.int32))["params"],
    }
    params = {k: fill_tree(s, seed + 21) for seed, (k, s) in enumerate(struct.items())}
    bundle.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jb, jtask(jb), jax.tree_util.tree_map(jnp.asarray, params), bundle, build_task(bundle, "cpu")


def test_deep_tokenizer_and_builder_match_jax(deep):
    """``repeat_4_<special-token>`` with deep_prompt over 4 layers: the
    expanded token list, the repeated init text, the embedder's table of
    4 x 4 rows, and the ids of the datasets' per-layer prompts, as JAX's."""
    from leftrefill_tpu.models.clip import build_prompt_tokenizer as jtok

    from leftrefill_torch.data.datasets import build_prompt
    from leftrefill_torch.models.clip import build_prompt_tokenizer

    jb, _, _, bundle, task = deep
    assert bundle.special_tokens == jb.cond_bundle.special_tokens and len(bundle.special_tokens) == 16
    assert bundle.special_tokens[5] == "<special-token1-layer1>"
    assert bundle.cond_bundle.init_text == jb.cond_bundle.init_text and len(bundle.cond_bundle.init_text) == 16
    cm = bundle.model.cond_stage_model
    assert (cm.deep_prompt, cm.cross_attn_layers, cm.num_special_tokens) == (True, LAYERS, 4)
    assert tuple(cm.special_embeddings.weight.shape) == (16, 24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok, sp, init = build_prompt_tokenizer(["<a>", "<b>"], ["x", "y"], deep_prompt=True, cross_attn_layers=3)
        jt, jsp, jinit = jtok(["<a>", "<b>"], ["x", "y"], deep_prompt=True, cross_attn_layers=3)
    assert (sp, init) == (jsp, jinit)
    txt = build_prompt(4, "<special-token>", deep_prompt=True, cross_attn_layers=LAYERS)
    assert len(txt) == LAYERS and txt[2].startswith("<special-token0-layer2> ")
    ids = task.prompt_tokens([txt, txt])
    assert ids.shape == (2, LAYERS, 77)
    np.testing.assert_array_equal(ids, np.asarray(jb.cond_bundle.tokenizer.tokenize(txt))[None].repeat(2, 0))
    assert (ids >= 49408).sum() == 2 * LAYERS * 4  # every per-layer prompt token is a table row


def test_deep_embedder_matches_jax(deep):
    """ids [2, 4, 77] -> contexts [2, 4, 77, 24], each layer's prompt tokens
    reading their own rows of the table."""
    jb, _, params, bundle, task = deep
    txt = task.bundle.special_tokens
    ids = np.stack([task.prompt_tokens([" ".join(txt[4 * i:4 * i + 4]) for i in range(LAYERS)])] * 2)
    ids[1, :, 10] = 320  # the two rows differ
    ref = jb.model.cond_model.apply({"params": params["cond"]}, j(ids))
    with torch.no_grad():
        out = bundle.model.cond_stage_model(torch.from_numpy(ids))
    assert out.shape == (2, LAYERS, 77, 24)
    assert rel_err(out, ref) < FP32_REL
    # each layer's slice differs: the rows of the table are the layer's own
    assert all(float((out[:, i] - out[:, 0]).abs().max()) > 1e-3 for i in range(1, LAYERS))


@pytest.fixture(scope="module")
def unets():
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.unet import UNetModel as TU

    ju = JU(**CFG)
    p = init_flax(ju, 13, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    rng = np.random.RandomState(14)
    x = np.repeat(rng.standard_normal((1, 8, 16, 9)).astype(np.float32), 2, axis=0)  # CFG layout
    ts = np.array([301, 301])
    ctx = rng.standard_normal((2, LAYERS, 77, 24)).astype(np.float32)  # every slice distinct
    return ju, p, load_port(TU(**CFG), "unet", p), (x, ts, ctx)


@pytest.mark.parametrize("cross_kv,cfg_dup", [(False, False), (True, False), (True, True)])
def test_deep_context_unet_matches_jax(unets, cross_kv, cfg_dup):
    ju, p, tu, (x, ts, ctx) = unets
    assert [st.ctx_slot for st in tu.spatial_transformers()] == list(range(LAYERS))

    def jax_fwd(p, x, ts, ctx):
        kv = ju.apply({"params": p}, ctx, method="cross_kv") if cross_kv else None
        return ju.apply({"params": p}, x, ts, ctx, cross_kv=kv, cfg_dup=cfg_dup)

    ref = jax.jit(jax_fwd)(p, j(x), j(ts.astype(np.int32)), j(ctx))
    with torch.no_grad():
        kv = tu.cross_kv(t(ctx)) if cross_kv else None
        out = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=kv, cfg_dup=cfg_dup)
    assert out.shape == (2, 8, 16, 4)
    assert rel_err(out, ref) < FP32_REL


def test_deep_context_slices_per_layer(unets):
    """The port's form of tests/test_unet.py:127-175: equal slices give the
    3-D context's output exactly, a perturbed slot changes it, and the K/V
    cache and cfg_dup agree with the plain forward under it."""
    _, _, tu, (x, ts, ctx) = unets
    flat = t(ctx[:, 0])
    same = flat[:, None].expand(2, LAYERS, 77, 24).contiguous()
    with torch.no_grad():
        ref = tu(t(x), torch.from_numpy(ts), flat)
        assert torch.equal(tu(t(x), torch.from_numpy(ts), same), ref)
        perturbed = same.clone()
        perturbed[:, 2] += 1.0
        out = tu(t(x), torch.from_numpy(ts), perturbed)
        assert float((out - ref).abs().max()) > 1e-3
        kv = tu.cross_kv(perturbed)
        assert torch.equal(tu(t(x), torch.from_numpy(ts), perturbed, cross_kv=kv), out)
        assert torch.equal(tu(t(x), torch.from_numpy(ts), perturbed, cross_kv=kv, cfg_dup=True), out)


def test_deep_context_multiview_unet_matches_jax():
    """The V=2 multi-view UNet (one scene, no cfg_dup) under a deep context,
    with the K/V cache: its transformers slice the context as the plain
    UNet's do."""
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.multiview import MultiViewUnetModel

    p = init_flax(JU(**CFG), 15, jnp.zeros((1, 8, 8, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    rng = np.random.RandomState(16)
    x = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    ts = np.array([640, 640])
    ctx = rng.standard_normal((2, LAYERS, 77, 24)).astype(np.float32)
    ju = JMV(view_num=2, **CFG)
    ref = jax.jit(lambda p, x, ts, ctx: ju.apply({"params": p}, x, ts, ctx, cross_kv=ju.apply(
        {"params": p}, ctx, method="cross_kv")))(p, j(x), j(ts.astype(np.int32)), j(ctx))
    tu = load_port(MultiViewUnetModel(view_num=2, **CFG), "unet", p)
    with torch.no_grad():
        out = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=tu.cross_kv(t(ctx)))
    assert rel_err(out, ref) < FP32_REL


def test_deep_task_tokens_and_table_init_match_jax(deep):
    """``uncond_tokens`` gives the empty prompt once per layer, [n, 4, 77];
    ``init_params`` fills the deep table per layer from the repeated init
    text (JAX's ``init_special_embeddings`` over the same frozen token
    embedding)."""
    from leftrefill_tpu.models.clip import init_special_embeddings

    jb, jt, _, _, task = deep
    u = task.uncond_tokens(3)
    assert u.shape == (3, LAYERS, 77)
    np.testing.assert_array_equal(u, jt.uncond_tokens(3))
    task = copy.deepcopy(task)  # init_params draws every weight anew: the fixture's stay JAX's
    task.init_params(torch.Generator().manual_seed(3))
    cm = task.model.cond_stage_model
    cb = jb.cond_bundle
    want = init_special_embeddings(cb.tokenizer, cb.special_tokens, cm.model.token_embedding.weight.detach().numpy(),
                                   cb.init_text, cb.tokenwise_init)
    np.testing.assert_array_equal(cm.special_embeddings.weight.detach().numpy(), want)


def test_deep_log_images_matches_jax(deep):
    """``log_images`` at CFG 2.5 with per-layer prompts: the conditional
    contexts and the empty prompt's, both [2, 4, 77, 24], through DDIM on
    JAX's x_T, step noise and VAE noise; the tiny canvas within 1e-4
    absolute (test_torch_parity_utils.CANVAS_ABS)."""
    from test_torch_parity_utils import CANVAS_ABS
    from test_torch_tasks import STEPS, _draws

    from leftrefill_torch.data.datasets import build_prompt

    _, jt, params, _, task = deep
    rng = np.random.RandomState(31)
    image = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 64, 1), np.float32)
    mask[:, 6:26, 36:60] = 1.0
    txt = build_prompt(4, "<special-token>", deep_prompt=True, cross_attn_layers=LAYERS)
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": task.prompt_tokens([txt, txt])}
    key = jax.random.PRNGKey(32)
    ref = jt.log_images(params, batch, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=2.5, key=key)
    out = task.log_images(batch, ddim_steps=STEPS, ddim_eta=1.0, unconditional_guidance_scale=2.5, **_draws(2, key))
    assert out["pred"].shape == (2, 32, 64, 3)
    assert np.abs(out["pred"].numpy() - np.asarray(ref["pred"])).max() < CANVAS_ABS
