"""The port stands alone: its copies of the JAX package's numpy-only schedule
tables, tokenizer, prompt text and relative camera pose equal the
originals on the same inputs, no module of
the port (nor ``chip_smoke.py``) brings in the JAX package or jax, and its
entry points run on the card unless the caller asks for the CPU."""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kw", [
    dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120),
    dict(timesteps=1000, beta_schedule="cosine"),
    dict(timesteps=500, beta_schedule="sqrt_linear", parameterization="v"),
    dict(timesteps=1000, beta_schedule="sqrt", parameterization="x0", v_posterior=0.1),
])
def test_schedule_copy_matches_jax(kw):
    """Every table of ``DiffusionSchedule`` and the DDIM sub-schedules, the
    step counts that do not divide the schedule included (``range(0, T,
    T // steps) + 1`` keeps more steps than asked, as upstream does)."""
    from leftrefill_tpu.diffusion import schedules as js

    from leftrefill_torch.diffusion import schedules as ts

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = js.DiffusionSchedule.create(**kw)
    ours = ts.DiffusionSchedule.create(**kw)
    for field, value in vars(ref).items():
        got = getattr(ours, field)
        assert np.array_equal(got, value) if isinstance(value, np.ndarray) else got == value, field
    for steps, eta in ((50, 1.0), (15, 0.0), (20, 0.5), (30, 1.0), (4, 1.0)):
        a, b = ref.ddim_tables(steps, eta=eta), ours.ddim_tables(steps, eta=eta)
        for field, value in vars(a).items():
            got = getattr(b, field)
            assert np.array_equal(got, value) if isinstance(value, np.ndarray) else got == value, (steps, field)
    n = ours.num_timesteps  # 30 steps do not divide it: range(0, n, n // 30) keeps more than 30
    assert ours.ddim_tables(30).num_steps == len(range(0, n, n // 30)) > 30


def test_tokenizer_copy_matches_jax():
    """Token ids of the synthetic vocab with special tokens (repeat_N
    expansion, deep-prompt duplication, the multi-view tokens without their
    closing '>'), plain text, non-ASCII text and a prompt cut at 77 tokens."""
    from leftrefill_tpu.models import tokenizer as jt

    from leftrefill_torch.models import tokenizer as tt

    for specials, init, deep in ((["repeat_20_<special-token>"], ["a b"], False), (["<left>", "<right>"], None, True)):
        ref = jt.expand_special_tokens(specials, init, deep_prompt=deep, cross_attn_layers=3)
        assert tt.expand_special_tokens(specials, init, deep_prompt=deep, cross_attn_layers=3) == ref
    sp, prompts = tt.multiview_prompts(3)
    texts = prompts + ["", "A photo of a Café, naïve!", " ".join(sp[:20]), "word " * 100, "<left>x<right>"]
    with pytest.warns(UserWarning, match="synthetic"):
        ours = tt.SimpleTokenizer(special_tokens=sp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jt.SimpleTokenizer(special_tokens=sp)
    assert np.array_equal(ours.tokenize(texts), ref.tokenize(texts))
    assert ours.decode(ours.encode("a photo")) == ref.decode(ref.encode("a photo"))
    assert ours.tokenize(texts).shape == (len(texts), 77)


def test_prompt_and_pose_copies_match_jax():
    """``build_prompt`` (the repeated-token prompt, its deep-prompt variants,
    the templates with a token map in both modes, the same random picks) and
    ``cartesian_to_spherical`` / ``get_relative_pose`` on seeded cameras."""
    import random

    from leftrefill_tpu.data import datasets as jd

    from leftrefill_torch.data import datasets as td

    assert td.PROMPT_TEMPLATES == jd.PROMPT_TEMPLATES
    tmap = {"left_token": "<l>", "right_token": "<r>", "task_token": "<t>", "real_token": "<s>"}
    cases = [dict(repeat_sp_token=73, sp_token="<special-token>"),
             dict(repeat_sp_token=3, sp_token="<x>", deep_prompt=True, cross_attn_layers=4),
             dict(repeat_sp_token=0, sp_token=None, token_map=tmap, mode="test"),
             dict(repeat_sp_token=0, sp_token="<x>", mode="test")]
    for kw in cases:
        assert td.build_prompt(**kw) == jd.build_prompt(**kw)
    picks = [td.build_prompt(0, None, tmap, rng=random.Random(s)) for s in range(20)]
    assert picks == [jd.build_prompt(0, None, tmap, rng=random.Random(s)) for s in range(20)] and len(set(picks)) > 3
    rng = np.random.RandomState(0)
    for _ in range(10):
        xyz = rng.standard_normal((5, 3))
        assert np.array_equal(td.cartesian_to_spherical(xyz), jd.cartesian_to_spherical(xyz))
        a, b = (np.concatenate([np.linalg.qr(rng.standard_normal((3, 3)))[0], rng.standard_normal((3, 1))], 1)
                for _ in range(2))
        pose = td.get_relative_pose(a, b)
        assert pose.dtype == np.float32 and np.array_equal(pose, jd.get_relative_pose(a, b))


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    """A fresh interpreter imports every module of the port and
    ``chip_smoke`` (without running it), builds the tiny bundle on the CPU
    and runs its text tower and one UNet step: no ``leftrefill_tpu`` and no
    ``jax`` module is loaded."""
    code = """
import importlib, pkgutil, sys, warnings
import torch
import leftrefill_torch
for mod in pkgutil.walk_packages(leftrefill_torch.__path__, "leftrefill_torch."):
    importlib.import_module(mod.name)
import chip_smoke
from leftrefill_torch.diffusion.core import Conditioning, LeftRefillModel
from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
from leftrefill_torch.models.clip import PromptCLIPEmbedder, build_multiview_prompt_tokenizer
from leftrefill_torch.models.multiview import MultiViewUnetModel
from leftrefill_torch.pipeline import fill_random_, sd2_schedule
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    tok, sp, prompts = build_multiview_prompt_tokenizer(2)
model = LeftRefillModel(
    MultiViewUnetModel(view_num=2, in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1,
                       attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=24),
    AutoencoderKL(DDConfig(z_channels=4, resolution=64, ch=16, ch_mult=(1, 2), num_res_blocks=1), embed_dim=4),
    PromptCLIPEmbedder(width=24, heads=2, layers=2, num_special_tokens=len(sp)), sd2_schedule())
fill_random_(model, torch.Generator().manual_seed(0))
with torch.no_grad():
    ctx = model.get_learned_conditioning(torch.as_tensor(tok.tokenize(prompts), dtype=torch.long))
    out = model.apply_model(torch.zeros(2, 8, 16, 4), torch.tensor([10, 10]), Conditioning(torch.zeros(2, 8, 16, 5), ctx))
assert out.shape == (2, 8, 16, 4) and torch.isfinite(out).all()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("leftrefill_tpu", "jax", "jaxlib", "flax"))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_entry_points_default_to_the_card():
    """``RefInpaintPipeline``, ``MultiViewInpaintPipeline`` and
    ``build_sd2_inpaint_bundle`` default to "cuda"; without a card a request
    raises rather than running on the CPU."""
    import inspect

    from leftrefill_torch.pipeline import MultiViewInpaintPipeline, RefInpaintPipeline, build_sd2_inpaint_bundle

    assert inspect.signature(build_sd2_inpaint_bundle).parameters["device"].default == "cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer

        tok, sp, prompts = build_multiview_prompt_tokenizer(2)
    pipes = (RefInpaintPipeline(model=None, tokenizer=tok, special_tokens=sp[:2]),
             MultiViewInpaintPipeline(model=None, tokenizer=tok, view_prompts=prompts))
    for pipe in pipes:
        assert pipe.device == "cuda"
    if not torch.cuda.is_available():
        image = np.zeros((1, 2, 32, 32, 3), np.float32)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipes[0](image[:, 0], image[:, 0, ..., :1])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipes[1](image, image[..., :1])


def test_nvs_entry_points_default_to_the_card():
    """``build_sd2_nvs_bundle``, ``NVSTask`` and ``LoraAdapterStore`` default
    to "cuda"; without a card they raise rather than run on the CPU."""
    import inspect

    from leftrefill_torch.pipeline import build_sd2_nvs_bundle
    from leftrefill_torch.runtime import LoraAdapterStore
    from leftrefill_torch.tasks import NVSTask

    for fn in (build_sd2_nvs_bundle, NVSTask, LoraAdapterStore):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_sd2_nvs_bundle()
        task = NVSTask(type("B", (), dict(model=None, tokenizer=None, special_tokens=[], refinement_config={}))())
        batch = {k: np.zeros((1, 16, 32, 3), np.float32) for k in ("image", "mask", "masked_image")}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            task.log_images({**batch, "tokens": np.zeros((1, 77), np.int64), "rel_pose": np.zeros((1, 4), np.float32)})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LoraAdapterStore(torch.nn.Linear(2, 2))
