"""The port's config system against the JAX package's: its own YAML reader
equals ``yaml.safe_load`` on every shipped config and on the YAML strings of
the CLI tests, and refuses what it does not read; ``build_model_from_config``
builds, on ``meta``, the modules whose state_dict names and shapes are the
JAX bundles' trees through the converter, for the three shipped model YAMLs,
and the novel-view YAML gives ``build_sd2_nvs_bundle``'s modules."""

import glob
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_cli import MODEL_YAML, TRAIN_YAML
from test_cli_variants import MV_MODEL_YAML, NVS_MODEL_YAML

from leftrefill_torch.config import YAMLError, build_model_from_config, load_yaml, parse_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
MODEL_CONFIGS = ["ref_inpainting.yaml", "multiview_ref_inpainting.yaml", "novel_view_synthesis.yaml"]
# the training YAMLs of tests/test_cli_variants.py (written inside its fixture)
VARIANT_TRAIN_YAML = textwrap.dedent(
    """
    model_config: '/r/nvs_model.yaml'
    resume_path: null
    datapath: '/r/objs'
    train_list: '/r/objs_train.txt'
    val_list: '/r/objs_val.txt'
    cross_view_inpainting: false
    train_mask_path: ['/r/irregular.txt', '/r/segment.txt']
    batch_size: 2
    logger_freq: 1000
    max_steps: 2
    val_batches: 1
    monitor: ssim
    optim_cfg: {learning_rate: 1.0e-3, weight_decay: 0.01, lr_scheduler: none}
    """
)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_yaml_equals_safe_load_on_every_shipped_config(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert load_yaml(path) == ref


@pytest.mark.parametrize("name", ["model", "train", "mv_model", "nvs_model", "variant_train"])
def test_load_yaml_equals_safe_load_on_the_cli_tests_yaml(name):
    src = {"model": MODEL_YAML, "train": TRAIN_YAML.format(model_cfg="/x/model.yaml", root="/r"),
           "mv_model": MV_MODEL_YAML, "nvs_model": NVS_MODEL_YAML, "variant_train": VARIANT_TRAIN_YAML}[name]
    assert parse_yaml(src) == yaml.safe_load(src)


@pytest.mark.parametrize("src", [
    "a: 1e-4\nb: 1.0e4\nc: .5\nd: -1.5e-3\ne: +4\nf: 1.",
    "x: [1, 'a b', {c: d, e: [1, 2]}]\ny: {}\nz: []",
    "- a\n- b\n-\n  c: 1",
    "a:\n- 1\n- [2, 3]\nb: 3",
    "a: 'it''s # not a comment'  # a comment\nb: \"x\\ty\"\nc: x#y",
    "k: null\nl: ~\nm:\nn: True\no: FALSE\np: http://x.y/z\nq: b c d",
])
def test_load_yaml_resolves_scalars_as_safe_load(src):
    """Floats need PyYAML's dot (1e-4 stays a string), quotes and comments,
    block lists, nulls and both capitalizations of the booleans."""
    assert parse_yaml(src) == yaml.safe_load(src)


@pytest.mark.parametrize("src", ["a: yes", "a: off", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  t", "---\na: 1",
                                 "a: 0o17", "a: 010", "a: 1_000", "a: 2001-12-14", "a: .inf", "a: [a: 1]",
                                 "a:\n b: 1\n  c: 2", "a: [1, 2"])
def test_load_yaml_refuses_what_it_does_not_read(src):
    with pytest.raises(YAMLError):
        parse_yaml(src)


def _jax_shapes(bundle) -> dict:
    """The JAX bundle's parameter trees (``jax.eval_shape``), through the
    port's converter on shape-only leaves: {checkpoint key: shape}."""
    from leftrefill_torch.convert.from_jax import torch_entries

    m = bundle.model
    b = bundle.view_num  # the multi-view UNet folds its views out of the batch
    trees = {
        "unet": jax.eval_shape(m.unet.init, jax.random.PRNGKey(0), jnp.zeros((b, 8, 16, m.unet.in_channels)),
                               jnp.zeros((b,), jnp.int32), jnp.zeros((b, 77, m.unet.context_dim)))["params"],
        "vae": jax.eval_shape(m.vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3)))["params"],
        "cond": jax.eval_shape(m.cond_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32),
                               *([jnp.zeros((1, 4))] if hasattr(m.cond_model, "cfg_rate") else []))["params"],
    }
    stand_in = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), trees)
    return {k: tuple(a.shape) for k, a in torch_entries(stand_in)}


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_model_configs_build_the_jax_bundles_parameters(name):
    """Every shipped model YAML: the port's state_dict (on ``meta``) has the
    JAX bundle's parameters, name for name and shape for shape, its tasks'
    settings and the same prompt tokens."""
    from leftrefill_tpu.config import build_model_from_config as jax_build

    path = os.path.join(REPO, "configs", name)
    ours = build_model_from_config(path, device="meta")
    ref = jax_build(path)
    got = {k: tuple(v.shape) for k, v in ours.model.state_dict().items()}
    assert got == _jax_shapes(ref)
    assert ours.special_tokens == ref.cond_bundle.special_tokens
    assert ours.cond_bundle.init_text == ref.cond_bundle.init_text
    for field in ("data_config", "save_prompt_only", "task_target", "lora_config", "refinement_config", "view_num",
                  "concat_target", "reduced_loss"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.model.conditioning_key == ref.model.conditioning_key
    assert ours.model.scale_factor == ref.model.scale_factor
    assert np.array_equal(ours.model.schedule.alphas_cumprod, ref.model.schedule.alphas_cumprod)


@pytest.mark.parametrize("refinement", [False, True])
def test_nvs_config_gives_the_nvs_bundle(monkeypatch, refinement):
    """``configs/novel_view_synthesis.yaml`` (the refinement branch as the
    YAML sets it) and ``build_sd2_nvs_bundle`` build the same modules: the
    same state_dict names, shapes and dtypes, prompt tokens, CFG rate and
    conditioning."""
    from leftrefill_torch import pipeline

    monkeypatch.setattr(pipeline, "init_prompt_table", lambda *a, **k: None)  # reads values: none on meta
    cfg = load_yaml(os.path.join(REPO, "configs", "novel_view_synthesis.yaml"))
    cfg["model"]["params"]["refinement_config"]["use_input_refinement"] = refinement
    ours = build_model_from_config(cfg, device="meta")
    ref = pipeline.build_sd2_nvs_bundle("meta", torch.bfloat16, refinement=refinement)
    a, b = ours.model.state_dict(), ref.model.state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in a.items()} == {k: (tuple(v.shape), v.dtype) for k, v in b.items()}
    assert ours.special_tokens == list(ref.special_tokens)
    assert ours.model.cond_stage_model.cfg_rate == ref.model.cond_stage_model.cfg_rate == 0.15
    assert ours.model.conditioning_key == ref.model.conditioning_key == "hybrid-refine"
    assert ours.refinement_config == {**ref.refinement_config, "use_input_refinement": refinement}


def test_config_refuses_what_the_port_does_not_build():
    """Unknown targets and model options the port has no modules for raise,
    and the builder, like every entry point, refuses a missing card."""
    from leftrefill_torch.config import instantiate_from_config

    with pytest.raises(KeyError, match="Unknown target"):
        instantiate_from_config({"target": "no.such.Model"})
    cfg = load_yaml(os.path.join(REPO, "configs", "novel_view_synthesis.yaml"))
    cfg["model"]["params"]["cond_stage_config"]["params"]["deep_prompt"] = True
    with pytest.raises(NotImplementedError, match="deep prompt"):  # JAX's NVS embedder has no deep forward
        build_model_from_config(cfg, device="meta")
    cfg = load_yaml(os.path.join(REPO, "configs", "multiview_ref_inpainting.yaml"))
    cfg["model"]["params"]["cond_stage_config"]["params"]["deep_prompt"] = True
    with pytest.raises(NotImplementedError, match="deep prompt with view tokens"):  # ids past the per-layer table
        build_model_from_config(cfg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model_from_config(os.path.join(REPO, "configs", "ref_inpainting.yaml"))
