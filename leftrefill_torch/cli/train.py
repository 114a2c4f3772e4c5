"""The training CLI of the port (counterpart of ``leftrefill_tpu/cli/train.py``),
on the card unless given ``--device cpu``:

    python -m leftrefill_torch.cli.train --config_file configs/nvs_training_config.yaml --exp_name run1

The same flags and the same two-file config scheme as JAX's: the training
YAML names the model YAML (``model_config``), and both are copied into
``<save_path>/<exp_name>`` (``--restore`` reads them back from there and
resumes at the last checkpoint's step).  The loop is JAX's: the mask
curriculum, metrics every 50 steps, sample grids every ``logger_freq``
steps, validation each ``check_val_every_n_epoch`` epochs capped at
``val_batches`` batches, and a pruned checkpoint at each validation.

Novel-view synthesis trains completely: the prompt, the relative-pose MLP,
the separator columns, the refinement branch and, with ``lora.do_lora``, the
LoRA factors, from ``resume_path`` (an SD checkpoint, when the file exists
and ``--no_restore`` is not given) or random weights.  The 1-reference and
multi-view models train on MegaDepth pairs with the training masks (the
mask-file sampler and the match-based masks) and the MegaDepth datasets'
training modes, which the port does not have yet: they raise.  ``--nchip``
takes 0 or 1 (one card; data-parallel training is not ported).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_CONFIG = os.path.join(REPO_ROOT, "configs", "ref_inpainting_training_config.yaml")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Config")
    p.add_argument("--config_file", default=DEFAULT_CONFIG, type=str,
                   help="training config yaml (default: the shipped 1-ref config)")
    p.add_argument("--exp_name", default=None, type=str, required=True)
    p.add_argument("--save_path", default="./check_points", type=str)
    p.add_argument("--nchip", default=0, type=int, help="device count: 0 or 1 (one card)")
    p.add_argument("--restore", action="store_true", help="resume from last ckpt")
    p.add_argument("--no_restore", action="store_true", help="skip loading the SD checkpoint")
    p.add_argument("--bf16", action="store_true", default=True, help="bf16 compute (default)")
    p.add_argument("--max_steps", default=None, type=int, help="override max steps")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return p.parse_args(argv)


def _model_config_path(config: dict, config_file: str) -> str:
    """The training YAML's ``model_config``, relative to the working
    directory or, failing that, to the repository layout around the config
    file."""
    path = config["model_config"]
    if not os.path.isabs(path) and not os.path.exists(path):
        cand = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(config_file)), "..", path))
        if os.path.exists(cand):
            return cand
    return path


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from leftrefill_torch.config import NVS_TARGET, build_model_from_config, load_yaml
    from leftrefill_torch.pipeline import request_device

    dev = request_device(args.device)
    if args.nchip not in (0, 1):
        raise NotImplementedError(f"--nchip {args.nchip}: the port trains on one card (data-parallel training "
                                  "is not ported)")
    exp_dir = os.path.join(args.save_path, args.exp_name)
    if args.restore:
        config = load_yaml(os.path.join(exp_dir, "training_config.yaml"))
        model_config_path = os.path.join(exp_dir, "model_config.yaml")
    else:
        config = load_yaml(args.config_file)
        model_config_path = _model_config_path(config, args.config_file)
        os.makedirs(exp_dir, exist_ok=True)
        shutil.copy(args.config_file, os.path.join(exp_dir, "training_config.yaml"))
        shutil.copy(model_config_path, os.path.join(exp_dir, "model_config.yaml"))
    target = load_yaml(model_config_path)["model"]["target"]
    if target != NVS_TARGET:
        raise NotImplementedError(f"{target}: the 1-reference and multi-view training data need the training "
                                  "masks (FileMaskSampler, match_based_mask) and the MegaDepth datasets' training "
                                  "modes, which are not ported yet; the port trains novel-view synthesis "
                                  "(inpainting_ldm.NVS_ldm.NVSLDM)")

    from leftrefill_torch.data.datasets import NVS_OBJDataset
    from leftrefill_torch.data.loader import DataLoader
    from leftrefill_torch.models.lora import default_target, extended_target, init_lora
    from leftrefill_torch.tasks import build_task
    from leftrefill_torch.train.checkpoints import CheckpointManager, nvs_prompt_filter, restore_over_base, save_pruned
    from leftrefill_torch.train.logger import ImageLogger, MetricLogger, StepTimer, TokenDriftLogger
    from leftrefill_torch.train.trainer import (
        OptimizerConfig,
        base_model,
        create_train_state,
        current_lr,
        lora_predicate,
        make_train_step,
        with_lora,
        wrap_lora_params,
    )

    bundle = build_model_from_config(model_config_path, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                                     device=dev)
    task = build_task(bundle, dev)

    # ------------------------------------------------------------------
    # parameters: random values (+ the SD checkpoint), LoRA, then a resume
    gen = torch.Generator(dev).manual_seed(args.seed)
    sd_sd = None
    resume_path = config.get("resume_path")
    if resume_path and os.path.exists(resume_path) and not args.no_restore:
        from leftrefill_torch.convert.checkpoint import load_torch_state_dict

        print(f"Loading frozen weights from {resume_path}")
        sd_sd = load_torch_state_dict(resume_path)
    task.init_params(gen, sd_state_dict=sd_sd)
    model = bundle.model
    if bundle.lora_config.get("do_lora"):
        target_fn = extended_target if bundle.lora_config.get("lora_type") == "extended" else default_target
        lora = init_lora(model.unet, rank=bundle.lora_config.get("lora_rank", 16), target=target_fn, generator=gen)
        model = wrap_lora_params(model, lora, bundle.lora_config.get("lora_scale", 1.0))
        print(f"LoRA enabled over {len(lora)} weights")

    mgr = CheckpointManager(os.path.join(exp_dir, "ckpts"), monitor=f'val/{config.get("monitor", "lpips")}',
                            top_k=config.get("save_top_k", 2))
    start_step = 0
    if args.restore and mgr.manifest["last"] is not None:
        restore_over_base(model, mgr.restore("last"))
        start_step = mgr.manifest["last"]["step"]
        print(f"Restored the trained weights at step {start_step}")

    # ------------------------------------------------------------------
    # optimizer: AdamW over the trainable groups; every group shares the
    # YAML's learning_rate and weight_decay (JAX reads neither lr_lora nor
    # wd_lora), and eta_min is the cosine schedule's alpha, as in JAX
    oc = config.get("optim_cfg", {})
    opt_config = OptimizerConfig(
        lr=oc.get("learning_rate", 3e-5),
        weight_decay=oc.get("weight_decay", 0.01),
        use_cosine=oc.get("lr_scheduler") == "cosine",
        cosine_decay_steps=config.get("max_steps") or 10000,
        cosine_alpha=oc.get("eta_min", 0.0),
        accumulate_grad_batches=config.get("accumulate_grad_batches") or 1,
    )
    predicate = lora_predicate(nvs_prompt_filter) if model is not bundle.model else nvs_prompt_filter
    state, tx = create_train_state(model, opt_config, predicate)
    step_fn = make_train_step(model, tx, view_reduced=task.view_reduced, view_num=task.view_num,
                              cond_builder=task.cond_builder)

    # ------------------------------------------------------------------
    # data
    dc = dict(bundle.data_config)
    dc.pop("cfg", None)
    cfg_scale = bundle.data_config.get("cfg", 2.5)
    train_ds = NVS_OBJDataset(datapath=config["datapath"], listfile=config["train_list"], mode="train", **dc)
    val_ds = NVS_OBJDataset(datapath=config["datapath"], listfile=config["val_list"], mode="val", **dc)
    tok = bundle.tokenizer
    train_loader = DataLoader(train_ds, config.get("batch_size", 8), tokenizer=tok, shuffle=True)
    val_loader = DataLoader(val_ds, batch_size=4, tokenizer=tok, drop_last=True)

    # ------------------------------------------------------------------
    # loggers
    table = base_model(model).cond_stage_model.special_embeddings.weight
    mlog = MetricLogger(exp_dir)
    ilog = ImageLogger(os.path.join(exp_dir, "samples"), config.get("logger_freq", 200))
    drift = TokenDriftLogger(table)
    timer = StepTimer(trace_dir=os.path.join(exp_dir, "traces") if config.get("profile") else None)

    max_epochs = config.get("max_epochs", 10)
    max_steps = args.max_steps or config.get("max_steps") or float("inf")
    step = start_step
    for epoch in range(max_epochs):
        train_loader.set_epoch(epoch)
        task.update_mask_curriculum(train_ds, step)
        for batch in train_loader:
            timer.start(step)
            step_gen = torch.Generator(dev).manual_seed((args.seed << 32) + step)  # JAX: fold_in(key, step)
            state, metrics = step_fn(state, {k: v for k, v in batch.items() if k != "txt"}, step_gen)
            dt = timer.stop(step)
            if step % 50 == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = current_lr(opt_config, step)
                m["step_time_s"] = dt
                m.update(drift.drift(table))
                mlog.log(step, m)
            if ilog.should_log(step):
                with torch.no_grad():
                    log = with_lora(model, task.log_images, batch, N=min(2, batch["image"].shape[0]),
                                    ddim_steps=config.get("log_ddim_steps", 50),
                                    unconditional_guidance_scale=cfg_scale)
                ilog.log(step, epoch, log)
            step += 1
            if step >= max_steps:
                break

        if epoch % config.get("check_val_every_n_epoch", 1) == 0:
            vals = []
            # val_batches: the CLI's cap (null in the YAML validates the whole loader)
            val_cap = config.get("val_batches", 8)
            for i, vb in enumerate(val_loader):
                with torch.no_grad():
                    vals.append(with_lora(model, task.validation_metrics, vb, cfg_scale=cfg_scale,
                                          ddim_steps=config.get("val_ddim_steps", 50)))
                if val_cap is not None and i + 1 >= val_cap:
                    break
            vmean = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]} if vals else {}
            mlog.log(step, vmean)
            print(f"Epoch {epoch}: {vmean}")
            save_pruned(mgr, step, model, save_prompt_only=bundle.save_prompt_only, metrics=vmean,
                        filter_fn=nvs_prompt_filter)
        if step >= max_steps:
            break

    print("Training done at step", step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
