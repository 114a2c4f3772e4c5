"""The port's training CLI on MegaDepth-format data, against the JAX
package's, on the CPU at the tiny model YAMLs of ``tests/test_cli.py``
(1-reference) and ``tests/test_cli_variants.py`` (V=2 multi-view) over a
seeded synthetic tree (``tools.write_megadepth_scenes``, the 120x160 JPEG
fixtures, 32-pixel views, match masks on):

- the first batch each CLI hands its train step (the sampler's order, the
  items, the tokens) equal to JAX's, with both loaders on one worker so that
  the draws come in one order;
- the 1-reference and V=2 CLIs train with ``--device cpu``, save a
  checkpoint holding the prompt table alone and resume from it;
- one step's prompt-table gradient on that first batch within
  ``tests/test_torch_train_grad.py``'s 1e-4 relative L2 of ``jax.grad``
  (the loss 1e-5 relative), every parameter from the same seeded flax
  tree."""

import json
import os
import textwrap

import jax
import numpy as np
import pytest
import torch
import yaml

from test_cli import MODEL_YAML
from test_cli_variants import MV_MODEL_YAML
from test_torch_parity_utils import FP32_REL
from test_torch_tasks import _bundles
from test_torch_train_grad import GRAD_L2, _compare

from leftrefill_torch import tools

MODELS = {"ref": MODEL_YAML, "mv": MV_MODEL_YAML}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_megadepth"))
    paths = tools.write_megadepth_scenes(os.path.join(root, "md"), scenes=2, images_per_scene=4, seed=0,
                                         train_pairs_per_scene=8, other_pairs_per_scene=2,
                                         images=tools.MEGADEPTH_IMAGES[1:], mask_size=64)
    for name, src in MODELS.items():
        cfg = yaml.safe_load(src)
        cfg["model"]["params"]["data_config"].update(match_mask=True, match_mask_rate=0.5, seed=0,
                                                     match_path=paths["match_path"])
        with open(os.path.join(root, f"{name}_model.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
        with open(os.path.join(root, f"{name}_train.yaml"), "w") as f:
            f.write(textwrap.dedent(f"""
                model_config: '{root}/{name}_model.yaml'
                resume_path: null
                image_path: '{paths["image_path"]}'
                train_pair: '{paths["mv_train_pair" if name == "mv" else "train_pair"]}'
                val_image_path: '{paths["val_image_path"]}'
                train_mask_path: {json.dumps(paths["train_mask_path"])}
                val_mask_path: '{paths["val_mask_path"]}'
                cross_view_inpainting: true
                n_sample_per_scene: 4
                batch_size: {1 if name == "mv" else 2}
                logger_freq: 1
                check_val_every_n_epoch: 1
                max_epochs: 1
                max_steps: 2
                save_top_k: 1
                log_ddim_steps: 2
                val_ddim_steps: 2
                val_batches: 1
                monitor: ssim
                optim_cfg: {{learning_rate: 1.0e-3, weight_decay: 0.01, lr_scheduler: none}}
                """))
    return root


def _args(root, name, *extra):
    return ["--config_file", os.path.join(root, f"{name}_train.yaml"), "--exp_name", name,
            "--save_path", os.path.join(root, "ck"), *extra]


class _Stop(Exception):
    pass


def _first_batch(monkeypatch, loader_mod, trainer_mod, run) -> tuple[dict, list]:
    """(the first batch the CLI hands its train step, the first sampler
    indices), the loader on one worker; the CLI stops there."""
    seen, order = [], []

    class OneWorker(loader_mod.DataLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, num_workers=1))

        def _indices(self):
            idx = super()._indices()
            order.append(idx)
            return idx

    def recording(*a, **kw):
        def step(state, batch, key):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            raise _Stop
        return step

    monkeypatch.setattr(loader_mod, "DataLoader", OneWorker)
    monkeypatch.setattr(trainer_mod, "make_train_step", recording)
    with pytest.raises(_Stop):
        run()
    return seen[0], order[0]


_BATCHES = {}


def _port_batch(monkeypatch, root, name):
    """The port CLI's first batch and sampler order (computed once)."""
    if (root, name) not in _BATCHES:
        from leftrefill_torch.cli import train as cli
        from leftrefill_torch.data import loader
        from leftrefill_torch.train import trainer

        _BATCHES[root, name] = _first_batch(monkeypatch, loader, trainer, lambda: cli.main(
            _args(root, name, "--device", "cpu", "--no_restore")))
        monkeypatch.undo()
    return _BATCHES[root, name]


@pytest.mark.parametrize("name", ["ref", "mv"])
def test_first_batch_matches_jax(workdir, monkeypatch, name):
    from leftrefill_tpu.cli import train as jcli
    from leftrefill_tpu.data import loader as jloader
    from leftrefill_tpu.train import trainer as jtrainer

    got, got_order = _port_batch(monkeypatch, workdir, name)
    np.random.seed(0)  # the data config's seed: the match masks' numpy draws (the port's RandomState(0))
    args = _args(workdir, name, "--no_restore", "--nchip", "1")
    args[args.index("--exp_name") + 1] = name + "_jax"
    ref, ref_order = _first_batch(monkeypatch, jloader, jtrainer, lambda: jcli.main(args))
    assert got_order == ref_order and len(got_order) == 8
    assert set(got) == set(ref) and {"image", "mask", "masked_image", "tokens"} <= set(got)
    for k in ref:  # the pair index: int32 on JAX's devices (64-bit off), int64 in the port's numpy batch
        assert (got[k].dtype == ref[k].dtype or k == "idx") and np.array_equal(got[k], ref[k]), k
    rows = 2
    assert got["image"].shape == ((rows, 32, 32, 3) if name == "mv" else (rows, 32, 64, 3))
    assert got["mask"].sum() > 0


@pytest.mark.parametrize("name", ["ref", "mv"])
def test_cli_trains_saves_prompt_and_resumes(workdir, name):
    """Two steps, validation and a checkpoint holding the prompt table
    alone; ``--restore --max_steps 3`` starts from the saved table."""
    from leftrefill_torch.cli.train import main
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.train import trainer
    from leftrefill_torch.train.checkpoints import prompt_only_filter

    args = _args(workdir, name, "--device", "cpu")
    assert main(args + ["--no_restore"]) == 0
    exp = os.path.join(workdir, "ck", name)
    saved = torch.load(os.path.join(exp, "ckpts", "last.pt"), weights_only=True)
    bundle = build_model_from_config(os.path.join(exp, "model_config.yaml"), device="meta")
    want = {k for k in bundle.model.state_dict() if prompt_only_filter(tuple(k.split(".")))}
    assert set(saved) == want == {"cond_stage_model.special_embeddings.weight"}
    assert os.path.exists(os.path.join(exp, "samples", "gs-000000_e-000000_train.png"))
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert np.isfinite(records[0]["loss"]) and np.isfinite(records[-1]["val/psnr"])

    starts = []
    make_train_step = trainer.make_train_step

    def recording(model, tx, **kw):
        starts.append(model.cond_stage_model.special_embeddings.weight.detach().clone())
        return make_train_step(model, tx, **kw)

    trainer.make_train_step = recording
    try:
        assert main(args + ["--restore", "--max_steps", "3"]) == 0
    finally:
        trainer.make_train_step = make_train_step
    assert torch.equal(starts[0], saved["cond_stage_model.special_embeddings.weight"])
    manifest = json.load(open(os.path.join(exp, "ckpts", "manifest.json")))
    assert manifest["last"] == {"step": 3}
    again = torch.load(os.path.join(exp, "ckpts", "last.pt"), weights_only=True)
    assert again.keys() == saved.keys() and not torch.equal(again["cond_stage_model.special_embeddings.weight"],
                                                            saved["cond_stage_model.special_embeddings.weight"])


@pytest.mark.parametrize("name", ["ref", "mv"])
def test_cli_batch_prompt_gradient_matches_jax(workdir, monkeypatch, name):
    """The CLI's first batch through both ``compute_loss``es (the view-0
    loss on the V=2 scene's two rows).  Readings: loss 9.3e-8 / 4.5e-7,
    gradient 1.3e-6 / 1.1e-6 (1-reference / V=2)."""
    batch, _ = _port_batch(monkeypatch, workdir, name)
    batch = {k: batch[k] for k in ("image", "mask", "masked_image", "tokens")}
    with open(os.path.join(workdir, f"{name}_model.yaml")) as f:
        jt, params, task = _bundles(f.read())
    kw = dict(view_reduced=True, view_num=2) if name == "mv" else {}
    z_shape = (2, 16, 16, 4) if name == "mv" else (2, 16, 32, 4)
    loss_err, grad_err, scale = _compare(jt.model, params, task.model, batch, jax.random.PRNGKey(3), z_shape, **kw)
    assert scale > 0 and loss_err < FP32_REL and grad_err < GRAD_L2
