"""The port stands alone: its copies of the JAX package's numpy-only schedule
tables, tokenizer, prompt text, relative camera pose, loader and sampler
equal the originals on the same inputs, no module of the port (nor
``chip_smoke.py``) brings in the JAX package or jax, its training CLI runs
without the JAX package, jax, OpenCV, PIL or PyYAML, and its entry points
run on the card unless the caller asks for the CPU."""

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

    from leftrefill_tpu.data import preprocess as jp

    from leftrefill_torch.data import preprocess as tp

    assert td.PROMPT_TEMPLATES == jd.PROMPT_TEMPLATES and tp.PROMPT == jp.PROMPT
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
    and runs its text tower and one UNet step, then writes a small MegaDepth
    tree through the port's preprocessors and reads a training item of each
    MegaDepth dataset (match masks on), and collects the cross-attention
    maps of a tiny 1-reference UNet (``eval.attn_vis``) and samples it with
    PLMS and DDPM: no ``leftrefill_tpu`` and no ``jax`` module is loaded."""
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
import tempfile
from leftrefill_torch import tools
from leftrefill_torch.data.datasets import InpaintingCrossViewDataset, InpaintingMultiViewDataset
with tempfile.TemporaryDirectory() as root:
    p = tools.write_megadepth_scenes(root, scenes=1, images_per_scene=4, seed=0, train_pairs_per_scene=6,
                                     other_pairs_per_scene=0, images=tools.MEGADEPTH_IMAGES[1:], mask_size=64)
    kw = dict(mode="train", img_size=32, seed=0, view_mask_rate=0.0, match_mask=True, match_mask_rate=1.0,
              match_path=p["match_path"])
    item = InpaintingCrossViewDataset(p["image_path"], p["train_pair"], p["train_mask_path"], **kw)[0]
    assert item["image"].shape == (32, 64, 3)
    assert InpaintingMultiViewDataset(p["image_path"], p["mv_train_pair"], p["train_mask_path"], view_num=2,
                                      **kw)[0]["image"].shape == (2, 32, 32, 3)
from leftrefill_torch.diffusion.samplers_extra import ddpm_sample, plms_sample
from leftrefill_torch.diffusion.schedules import DiffusionSchedule
from leftrefill_torch.eval.attn_vis import collect_attention_maps
from leftrefill_torch.models.unet import UNetModel
unet = UNetModel(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1, attention_resolutions=(1,),
                 channel_mult=(1, 2), num_head_channels=8, context_dim=24)
fill_random_(unet, torch.Generator().manual_seed(1))
cond = Conditioning(torch.zeros(1, 8, 16, 5), torch.randn(1, 77, 24, generator=torch.Generator().manual_seed(2)))
maps = collect_attention_maps(unet, torch.zeros(1, 8, 16, 9), torch.tensor([10]), cond.c_crossattn)
assert len(maps) == 4 and all(m.shape[-1] == 77 for m in maps.values())
apply = lambda x, t, c: unet(torch.cat([x, c.c_concat], -1), t, c.c_crossattn)
with torch.no_grad():
    x = plms_sample(apply, sd2_schedule(), sd2_schedule().ddim_tables(2), cond, (1, 8, 16, 4),
                    generator=torch.Generator().manual_seed(3))
    x = ddpm_sample(apply, DiffusionSchedule.create(timesteps=10), cond, (1, 8, 16, 4), x_T=x, return_x0_every=5,
                    generator=torch.Generator().manual_seed(4))[0]
assert torch.isfinite(x).all()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("leftrefill_tpu", "jax", "jaxlib", "flax"))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_lazy_public_names_resolve_to_their_modules():
    """``leftrefill_torch``'s public names (JAX's ``leftrefill_tpu/__init__.py``
    three): a bare import loads none of their modules, each name is the
    object of its module, and neither brings in jax or the JAX package; the
    parallel modules and the dry run import nothing of them either."""
    code = """
import sys
import leftrefill_torch
assert not any(m in sys.modules for m in ("leftrefill_torch.config", "leftrefill_torch.tasks",
                                           "leftrefill_torch.pipeline"))
from leftrefill_torch import config, pipeline, tasks
assert leftrefill_torch.build_model_from_config is config.build_model_from_config
assert leftrefill_torch.build_task is tasks.build_task
assert leftrefill_torch.RefInpaintPipeline is pipeline.RefInpaintPipeline
assert sorted(leftrefill_torch.__all__) == ["RefInpaintPipeline", "build_model_from_config", "build_task"]
try:
    leftrefill_torch.missing
    raise SystemExit("an unknown name resolved")
except AttributeError:
    pass
import leftrefill_torch.parallel.batch, leftrefill_torch.parallel.context, leftrefill_torch.parallel.mesh
import leftrefill_torch.tools.dryrun
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("leftrefill_tpu", "jax", "jaxlib", "flax"))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


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


def test_loader_and_sampler_copies_match_jax():
    """The loader's numpy copies (``tokenize_txt``, ``collate``,
    ``flatten_views``), ``BalancedRandomSampler`` and the logger's
    ``make_grid`` / ``to_uint8`` equal the JAX package's on the same
    inputs."""
    from leftrefill_tpu.data import datasets as jd, loader as jl

    from leftrefill_torch.data import datasets as td, loader as tl
    from leftrefill_torch.models.tokenizer import SimpleTokenizer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok = SimpleTokenizer(special_tokens=["<a0>", "<a1>"])
    for txt in ("<a0> <a1> a photo", ["<a0> x", "<a1> y", ""]):
        assert np.array_equal(tl.tokenize_txt(tok, txt), jl.tokenize_txt(tok, txt))
    rng = np.random.RandomState(0)
    items = [{"image": rng.rand(4, 8, 3).astype(np.float32), "rel_pose": rng.rand(4).astype(np.float32),
              "txt": f"<a0> item {i}", "index": i, "meta": {"i": i}} for i in range(3)]
    for t in (None, tok):
        a, b = tl.collate(items, t), jl.collate(items, t)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) if isinstance(b[k], np.ndarray) else a[k] == b[k] for k in b)
    scene = {"image": rng.rand(2, 3, 4, 4, 3), "tokens": rng.randint(0, 9, (2, 3, 77)), "txt": ["a", "b"]}
    a, b = tl.flatten_views(scene), jl.flatten_views(scene)
    assert all(np.array_equal(a[k], b[k]) for k in ("image", "tokens")) and a["txt"] == b["txt"]
    from leftrefill_tpu.train import logger as jlog

    from leftrefill_torch.train import logger as tlog

    grid = {"pred": rng.uniform(-1.2, 1.2, (3, 8, 8, 3)).astype(np.float32),
            "mask": (rng.rand(3, 8, 8, 1) > 0.5).astype(np.float32)}
    assert np.array_equal(tlog.make_grid(grid, 2), jlog.make_grid(grid, 2))
    assert np.array_equal(tlog.to_uint8(grid["pred"]), jlog.to_uint8(grid["pred"]))
    image_dict = {i: f"/d/s{i % 4}/imgs/{i}.jpg" for i in range(24)}
    pairs = [{"source": i, "target": (i + 1) % 24} for i in range(24)]
    for epoch in range(3):
        a = td.BalancedRandomSampler(image_dict, pairs, n_sample_per_scene=5, rank=1, num_replicas=2)
        b = jd.BalancedRandomSampler(image_dict, pairs, n_sample_per_scene=5, rank=1, num_replicas=2)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b) and len(a) == len(b)


def test_training_cli_loads_no_jax_opencv_pil_or_yaml(tmp_path):
    """A fresh interpreter runs the training CLI on the CPU (the tiny NVS
    bundle, LoRA and the refinement branch on, one step, one validation
    batch over synthetic renders) and reads a dataset item: no module of
    the JAX package, jax, OpenCV, PIL or PyYAML gets loaded."""
    import textwrap

    import yaml

    from test_cli_variants import NVS_MODEL_YAML

    from leftrefill_torch import tools

    root = str(tmp_path)
    paths = tools.write_nvs_renders(root, objects=4, views=3, size=32, seed=0, val_masks=4)
    cfg = yaml.safe_load(NVS_MODEL_YAML)
    p = cfg["model"]["params"]
    p["first_stage_config"]["params"]["ddconfig"]["ch_mult"] = [1, 1, 2, 2]
    p["refinement_config"]["use_input_refinement"] = True
    p["data_config"].update(mask_file_path=paths["mask_file_path"], nviews=3)
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "train.yaml").write_text(textwrap.dedent(f"""
        model_config: '{root}/model.yaml'
        resume_path: null
        datapath: '{paths["datapath"]}'
        train_list: '{paths["train_list"]}'
        val_list: '{paths["val_list"]}'
        batch_size: 2
        logger_freq: 1
        max_epochs: 1
        max_steps: 1
        log_ddim_steps: 1
        val_ddim_steps: 1
        val_batches: 1
        optim_cfg: {{learning_rate: 1.0e-3, weight_decay: 0.01, lr_scheduler: none}}
        """))
    code = f"""
import sys, warnings
warnings.simplefilter("ignore")
from leftrefill_torch.cli.train import main
from leftrefill_torch.data.datasets import NVS_OBJDataset
assert main(["--config_file", "{root}/train.yaml", "--exp_name", "x", "--save_path", "{root}/ck", "--no_restore",
             "--device", "cpu"]) == 0
item = NVS_OBJDataset("{paths['datapath']}", "{paths['train_list']}", img_size=32, nviews=3, seed=0)[0]
assert item["image"].shape == (32, 64, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("leftrefill_tpu", "jax", "jaxlib", "flax", "cv2", "PIL",
                                                           "yaml"))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_serving_and_eval_entry_points_load_no_jax_opencv_pil_yaml_or_gradio(tmp_path):
    """A fresh interpreter runs ``cli.sample`` and ``cli.test`` (1-reference
    and ``--multiview``, with LPIPS) with ``--device cpu`` at the tiny
    configs on JPEG pair directories, reads them through every test-mode
    dataset and serves a headless ``predict`` from ``initialize_model``: no
    module of the JAX package, jax, OpenCV, PIL, PyYAML or gradio gets
    loaded."""
    import torch

    from test_cli import MODEL_YAML
    from test_cli_variants import MV_MODEL_YAML
    from test_torch_cli_eval import write_pairs

    from leftrefill_torch.eval.lpips import ALEX

    root = str(tmp_path)
    pairs = write_pairs(root)
    for name, text in (("exp", MODEL_YAML), ("mv", MV_MODEL_YAML)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "model_config.yaml").write_text(text)
    g = torch.Generator().manual_seed(0)
    torch.save({f"lin{i}.weight": torch.rand((1, ch, 1, 1), generator=g) for i, (ch, _, _, _) in enumerate(ALEX)},
               tmp_path / "lp.pth")
    code = f"""
import sys, warnings
warnings.simplefilter("ignore")
import torch
torch.set_num_threads(2)
from leftrefill_torch.cli import sample, test
from leftrefill_torch.data import datasets as td
from leftrefill_torch.data.image_io import imread
from leftrefill_torch.serving.gradio_app import initialize_model, predict
common = ["--test_size", "64", "--ddim_steps", "2", "--device", "cpu", "--limit", "1",
          "--output_path", "{root}/out", "--metric_output", "{root}/metrics"]
assert test.main(["--model_path", "{root}/exp", "--test_path", "{pairs}", "--lpips_weights", "{root}/lp.pth"] + common) == 0
assert test.main(["--model_path", "{root}/mv", "--test_path", "{pairs}", "--multiview"] + common) == 0
assert sample.main(["--model_path", "{root}/exp", "--reference", "{pairs}/0000/source.jpg", "--source",
                    "{pairs}/0002/target.jpg", "--mask", "{pairs}/0001/mask.png", "--img_size", "32",
                    "--ddim_steps", "2", "--device", "cpu", "--out", "{root}/o.png"]) == 0
for ds in (td.TestInpaintingDataset("{pairs}", 32),
           td.InpaintingCrossViewDataset("{pairs}", None, None, mode="test", img_size=32),
           td.InpaintingMultiViewDataset("{pairs}", None, None, mode="test", img_size=32)):
    assert ds[0]["image"].shape[-3:] == (32, 64, 3) or ds[0]["image"].shape == (4, 32, 32, 3)
pipe = initialize_model("{root}/exp", device="cpu")
out = predict(pipe, imread("{pairs}/0000/source.jpg"), imread("{pairs}/0002/target.jpg"), imread("{pairs}/0001/mask.png", 0),
              ddim_steps=2, img_size=32)
assert out[0].shape == (32, 32, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("leftrefill_tpu", "jax", "jaxlib", "flax", "cv2", "PIL",
                                                           "yaml", "gradio"))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_serving_and_eval_entry_points_default_to_the_card(tmp_path):
    """``initialize_model`` and the two CLIs default to "cuda"; without a
    card they raise rather than run on the CPU."""
    import inspect

    from test_cli import MODEL_YAML

    from leftrefill_torch.cli import sample, test
    from leftrefill_torch.serving import gradio_app

    assert inspect.signature(gradio_app.initialize_model).parameters["device"].default == "cuda"
    assert test.parse_args(["--model_path", "x"]).device == "cuda"
    (tmp_path / "model_config.yaml").write_text(MODEL_YAML)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gradio_app.initialize_model(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            test.main(["--model_path", str(tmp_path)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sample.main(["--model_path", str(tmp_path), "--reference", "r.jpg", "--source", "s.jpg", "--mask", "m.png"])
