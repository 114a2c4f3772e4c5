"""Prompt tuning of the deep-prompt table against the JAX package on the
CPU in fp32: one step's loss and gradient against ``jax.grad`` on the tiny
deep bundle of ``tests/test_torch_deep_prompt.py``, and the training CLI on
a tiny MegaDepth-format tree with a deep prompt.  Tolerances: the loss
1e-5 relative and the gradient rel L2 1e-4, as
``tests/test_torch_train_grad.py``."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from test_torch_deep_prompt import LAYERS, _deep_yaml, deep  # noqa: F401 (the module fixture)
from test_torch_parity_utils import FP32_REL, rel_l2, t

from leftrefill_torch.convert.from_jax import state_dict_from_flax

GRAD_L2 = 1e-4


def test_deep_prompt_gradient_matches_jax(deep):
    """One prompt-tuning step's loss and deep-table gradient against
    ``jax.grad`` of JAX's ``compute_loss``: batch 2 of 32x64 canvases with
    the datasets' per-layer prompts; only the deep table is trainable (the
    trainer's ``special_embeddings`` filter) and each layer's rows get a
    gradient of their own.  Readings: loss 2.3e-7, gradient 2.0e-6."""
    from leftrefill_tpu.train.trainer import compute_loss as jloss

    from leftrefill_torch.data.datasets import build_prompt
    from leftrefill_torch.train import compute_loss, create_train_state
    from test_torch_train_grad import _jax_draws

    jb, _, params, bundle, task = deep
    tm = copy.deepcopy(bundle.model)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(17)
    image = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    mask = np.concatenate([np.zeros((2, 32, 32, 1)), np.ones((2, 32, 32, 1))], axis=2).astype(np.float32)
    txt = build_prompt(4, "<special-token>", deep_prompt=True, cross_attn_layers=LAYERS)
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": task.prompt_tokens([txt, txt])}
    key = jax.random.PRNGKey(18)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jb.model, p, jbatch, key), has_aux=True))(params)
    ref = np.asarray(ref_grads["cond"]["special_embeddings"])
    tt, noise, vae_noise = _jax_draws(key, (2, 16, 32, 4), 2)
    create_train_state(tm)
    assert sorted(n for n, p in tm.named_parameters() if p.requires_grad) == [
        "cond_stage_model.special_embeddings.weight"]
    loss, _ = compute_loss(tm, batch, t=torch.from_numpy(tt), noise=t(noise), vae_noise=t(vae_noise))
    loss.backward()
    got = tm.cond_stage_model.special_embeddings.weight.grad.numpy()
    assert got.shape == (16, 24)
    assert abs(float(loss.detach()) - float(ref_loss)) / abs(float(ref_loss)) < FP32_REL
    assert rel_l2(got, ref) < GRAD_L2
    assert all(np.abs(got[4 * i:4 * i + 4]).max() > 0 for i in range(LAYERS))


def test_cli_trains_the_deep_table(tmp_path):
    """The training CLI on a tiny MegaDepth-format tree with the deep YAML.
    The datasets write 16 per-layer prompts (SD2's count of cross-attention
    layers, fixed in the reference's dataset and in JAX's), so the YAML sets
    ``cross_attn_layers: 16``: the batches carry tokens [B, 16, 77], the
    tiny UNet's four transformers read slices 0-3, two steps train those
    layers' rows of the 64-row table (the others only decay: AdamW's weight
    decay), validation runs, and the checkpoint holds the table alone."""
    import json
    import textwrap

    from leftrefill_torch import tools
    from leftrefill_torch.cli.train import main
    from leftrefill_torch.train import trainer

    root = str(tmp_path)
    paths = tools.write_megadepth_scenes(os.path.join(root, "md"), scenes=2, images_per_scene=4, seed=0,
                                         train_pairs_per_scene=8, other_pairs_per_scene=2,
                                         images=tools.MEGADEPTH_IMAGES[1:], mask_size=64)
    cfg = _deep_yaml(16)
    cfg["model"]["params"]["data_config"].update(match_mask=True, match_mask_rate=0.5, seed=0,
                                                 match_path=paths["match_path"])
    with open(os.path.join(root, "model.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(root, "train.yaml"), "w") as f:
        f.write(textwrap.dedent(f"""
            model_config: '{root}/model.yaml'
            resume_path: null
            image_path: '{paths["image_path"]}'
            train_pair: '{paths["train_pair"]}'
            val_image_path: '{paths["val_image_path"]}'
            train_mask_path: {json.dumps(paths["train_mask_path"])}
            val_mask_path: '{paths["val_mask_path"]}'
            cross_view_inpainting: true
            n_sample_per_scene: 4
            batch_size: 2
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
    seen, tables = [], []
    make_train_step = trainer.make_train_step

    def recording(model, tx, **kw):
        step = make_train_step(model, tx, **kw)
        tables.append(model.cond_stage_model.special_embeddings.weight.detach().clone())

        def wrapped(state, batch, generator):
            seen.append(np.asarray(batch["tokens"]))
            return step(state, batch, generator)

        return wrapped

    trainer.make_train_step = recording
    try:
        assert main(["--config_file", os.path.join(root, "train.yaml"), "--exp_name", "deep", "--save_path",
                     os.path.join(root, "ck"), "--device", "cpu", "--no_restore"]) == 0
    finally:
        trainer.make_train_step = make_train_step
    assert len(seen) == 2 and all(s.shape == (2, 16, 77) for s in seen)
    exp = os.path.join(root, "ck", "deep")
    saved = torch.load(os.path.join(exp, "ckpts", "last.pt"), weights_only=True)
    table = saved["cond_stage_model.special_embeddings.weight"]
    assert set(saved) == {"cond_stage_model.special_embeddings.weight"} and tuple(table.shape) == (64, 24)
    moved = (table - tables[0]).abs().amax(dim=1).reshape(16, 4).amax(dim=1)
    assert float(moved[:LAYERS].min()) > 10 * float(moved[LAYERS:].max())
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert np.isfinite(records[0]["loss"]) and np.isfinite(records[-1]["val/psnr"])
