"""The port's training CLI (``python -m leftrefill_torch.cli.train``) end to
end on the CPU (``--device cpu``) at the tiny NVS bundle of
``tests/test_cli_variants.py`` with LoRA and the refinement branch on, over
synthetic renders: two steps, validation and a pruned checkpoint holding the
NVS filter's keys with the LoRA factors; ``--restore`` resumes at the saved
step from the saved weights; what it refuses: a missing card and ``--nchip
2`` outside torchrun's two processes; and the shipped MegaDepth configs taken to their data as JAX's
CLI takes them (``tests/test_torch_cli_megadepth.py`` trains on such
data)."""

import json
import os
import textwrap

import numpy as np
import pytest
import torch
import yaml

from test_cli_variants import NVS_MODEL_YAML

from leftrefill_torch import tools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_train"))
    paths = tools.write_nvs_renders(root, objects=6, views=4, size=48, seed=0, val_masks=4, img_size=32)
    cfg = yaml.safe_load(NVS_MODEL_YAML)
    p = cfg["model"]["params"]
    p["first_stage_config"]["params"]["ddconfig"]["ch_mult"] = [1, 1, 2, 2]  # f8: the refinement's 1/8
    p["refinement_config"]["use_input_refinement"] = True
    p["data_config"]["mask_file_path"] = paths["mask_file_path"]
    with open(os.path.join(root, "nvs_model.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(root, "nvs_train.yaml"), "w") as f:
        f.write(textwrap.dedent(f"""
            model_config: '{root}/nvs_model.yaml'
            resume_path: '{root}/no_such_checkpoint.ckpt'
            datapath: '{paths["datapath"]}'
            train_list: '{paths["train_list"]}'
            val_list: '{paths["val_list"]}'
            cross_view_inpainting: false
            batch_size: 2
            logger_freq: 1000
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


def _args(root, *extra):
    return ["--config_file", os.path.join(root, "nvs_train.yaml"), "--exp_name", "nvs",
            "--save_path", os.path.join(root, "ck"), "--device", "cpu", *extra]


def test_cli_trains_saves_and_resumes(workdir):
    from leftrefill_torch.cli.train import main
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    assert main(_args(workdir, "--no_restore")) == 0
    exp = os.path.join(workdir, "ck", "nvs")
    for name in ("training_config.yaml", "model_config.yaml", "metrics.jsonl", "samples/gs-000000_e-000000_train.png"):
        assert os.path.exists(os.path.join(exp, name)), name
    manifest = json.load(open(os.path.join(exp, "ckpts", "manifest.json")))
    assert manifest["last"] == {"step": 2} and [b["step"] for b in manifest["best"]] == [2]
    first = torch.load(os.path.join(exp, "ckpts", "last.pt"), weights_only=True)
    groups = {k.split(".")[1] if k.startswith("model.") else ".".join(k.split(".")[:2]) for k in first}
    assert groups == {"cond_stage_model", "refinement_model", "refinement_alpha", "lora.down", "lora.up"}
    assert all(nvs_prompt_filter(tuple(k.split("."))) for k in first)

    # every key the NVS filter selects in the LoRA-wrapped model, and no other
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.models.lora import default_target, init_lora
    from leftrefill_torch.train import wrap_lora_params

    bundle = build_model_from_config(os.path.join(exp, "model_config.yaml"), device="meta")
    with torch.device("meta"):
        wrapped = wrap_lora_params(bundle.model, init_lora(bundle.model.unet, rank=2, target=default_target))
    assert set(first) == {k for k in wrapped.state_dict() if nvs_prompt_filter(tuple(k.split(".")))}

    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert np.isfinite(records[0]["loss"]) and "val/psnr" in records[-1] and "val/ssim" in records[-1]

    # --restore: the configs read back from the experiment, two more steps
    # from the saved weights (the saved factors, not fresh ones)
    from leftrefill_torch.train import trainer

    starts = []
    make_train_step = trainer.make_train_step

    def recording(model, tx, **kw):
        starts.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        return make_train_step(model, tx, **kw)

    trainer.make_train_step = recording
    try:
        assert main(_args(workdir, "--restore", "--max_steps", "4")) == 0
    finally:
        trainer.make_train_step = make_train_step
    assert all(torch.equal(starts[0][k], v) for k, v in first.items())
    manifest = json.load(open(os.path.join(exp, "ckpts", "manifest.json")))
    assert manifest["last"] == {"step": 4}
    second = torch.load(os.path.join(exp, "ckpts", "last.pt"), weights_only=True)
    assert second.keys() == first.keys() and any(not torch.equal(second[k], first[k]) for k in first)


def test_cli_refuses_what_it_does_not_run(workdir, monkeypatch):
    from leftrefill_torch.cli.train import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)  # --nchip 2 needs torchrun's two processes
    with pytest.raises(RuntimeError, match="torchrun"):
        main(_args(workdir, "--no_restore", "--nchip", "2"))
    # the shipped 1-reference and multi-view configs reach their MegaDepth data (the full-width
    # model built on meta: no values on the CPU) and stop where JAX's datasets stop on the same
    # config: the image pickle, which is not in the repository
    from leftrefill_tpu.config import load_yaml as jload
    from leftrefill_tpu.data import datasets as jd

    from leftrefill_torch import config as tconfig, tasks

    build = tconfig.build_model_from_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "build_model_from_config", lambda path, dtype=None, device=None: build(path, dtype, "meta"))
        mp.setattr(tasks.RefInpaintTask, "init_params", lambda self, gen, sd_state_dict=None: {})
        mp.chdir(workdir)
        for name, cls in (("ref_inpainting", jd.InpaintingCrossViewDataset),
                          ("multiview_ref_inpainting", jd.InpaintingMultiViewDataset)):
            cfg_file = os.path.join(REPO, "configs", f"{name}_training_config.yaml")
            cfg = jload(cfg_file)
            with pytest.raises(FileNotFoundError) as ref:
                cls(image_path=cfg["image_path"], pair_path=cfg["train_pair"], mask_path=cfg["train_mask_path"],
                    mode="train")
            with pytest.raises(FileNotFoundError) as got:
                main(["--config_file", cfg_file, "--exp_name", name, "--save_path", os.path.join(workdir, "ck_md"),
                      "--device", "cpu"])
            assert got.value.filename == ref.value.filename == cfg["image_path"]
    if not torch.cuda.is_available():  # on the card by default: without one it raises, it does not fall back
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([a for a in _args(workdir, "--no_restore") if a not in ("--device", "cpu")])
