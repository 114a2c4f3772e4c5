"""Rank bodies of the ``tests/test_torch_parallel_*.py`` tests: each runs in
one gloo CPU process of ``leftrefill_torch.tools.dryrun.run_ranks``, reads
what the test process saved with ``torch.save`` under ``inputs`` and returns
its result as numpy arrays.  This module imports nothing of JAX: the ranks
run the port alone, and the test process holds them to JAX."""

from __future__ import annotations

import numpy as np
import torch

from leftrefill_torch.parallel.mesh import shard_rows


def _load(path: str) -> dict:
    return torch.load(path, weights_only=False)


def apply_body(ranks, work, inputs: str) -> dict:
    """``batch_parallel_apply`` with the K/V cache on the test's batch; a
    batch of world - 1 rows must raise."""
    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.parallel.batch import batch_parallel_apply

    d = _load(inputs)
    model = d["model"]
    cond = Conditioning(d["c_concat"], d["ctx"])
    with torch.no_grad():
        out = batch_parallel_apply(model, ranks.group, cross_kv=model.cross_attention_kv(d["ctx"]))(d["x"], d["t"], cond)
        n = ranks.world - 1
        try:
            batch_parallel_apply(model, ranks.group)(d["x"][:n], d["t"][:n], Conditioning(d["c_concat"][:n], d["ctx"][:n]))
            raised = 0
        except ValueError as e:
            raised = int("divisible" in str(e))
    return {"out": out.numpy(), "raised": np.int32(raised)}


def pipeline_body(ranks, work, inputs: str) -> dict:
    """The 1-reference pipeline with the CFG batch split over the ranks, on
    the test's x_T, step noise and VAE noise."""
    from leftrefill_torch.pipeline import RefInpaintPipeline

    d = _load(inputs)
    pipe = RefInpaintPipeline(model=d["model"], tokenizer=d["tokenizer"], special_tokens=d["special_tokens"],
                              device="cpu", ddim_steps=d["steps"], guidance_scale=2.5, eta=1.0, group=ranks.group)
    out = pipe(d["image"], d["mask"], x_T=d["x_T"], noise_fn=lambda i, s: d["noise"][i], vae_noise=d["vae_noise"])
    return {"out": out.numpy()}


def predict_body(ranks, work, exp_dir: str, inputs: str) -> dict:
    """``initialize_model(dp_devices=world)``; rank 0 serves the test's two
    requests through ``predict`` then stops the others, which serve them in
    ``serve_followers``."""
    from leftrefill_torch.serving import gradio_app as ga

    d = _load(inputs)
    pipe = ga.initialize_model(exp_dir, dp_devices=ranks.world, device="cpu")
    if ranks.rank:
        return {"served": np.int32(ga.serve_followers(pipe))}
    outs = [np.stack(ga.predict(pipe, *req, ddim_steps=2, img_size=32, seed=seed)) for req, seed in d["requests"]]
    ga.stop_followers(pipe)
    return {f"out{i}": o for i, o in enumerate(outs)}


def joint_attention_body(ranks, work, inputs: str) -> dict:
    """``context_parallel_joint_attention`` on this rank's views of q, k, v
    [B, V, HW, inner]."""
    from leftrefill_torch.parallel.context import context_parallel_joint_attention

    d = _load(inputs)
    v_loc = d["q"].shape[1] // ranks.world
    mine = slice(ranks.rank * v_loc, (ranks.rank + 1) * v_loc)
    with torch.no_grad():
        out = context_parallel_joint_attention(ranks.group, *(d[k][:, mine] for k in "qkv"), d["heads"])
    return {"out": out.numpy()}


def multiview_body(ranks, work, inputs: str) -> dict:
    """The multi-view block or UNet of the test, rebuilt with its views split
    over a (data, view) layout of the ranks, on this rank's rows; the
    context-parallel attention refusing a gradient."""
    from leftrefill_torch.parallel.context import local_views
    from leftrefill_torch.parallel.mesh import make_groups

    d = _load(inputs)
    data_group, view_group = make_groups(d["n_data"], ranks.world // d["n_data"])
    module = d["build"](view_group=view_group)
    module.load_state_dict(d["state"])
    args = [local_views(a, d["view_num"], view_group, data_group) for a in d["args"]]
    with torch.no_grad():
        out = module(*args)
    x = args[0].clone().requires_grad_(True)
    try:
        module(x, *args[1:])
        refused = 0
    except RuntimeError as e:
        refused = int("no gradient" in str(e))
    return {"out": out.numpy(), "refused": np.int32(refused)}


def train_step_body(ranks, work, inputs: str) -> dict:
    """One data-parallel step of the test's model on this rank's rows: with
    ``draws`` (the JAX step's t, noise, CFG draws and VAE noise for the
    global batch) the loss takes this rank's rows of them, else the step
    draws from a generator seeded 3.  Returns the trainable parameters after
    the step and the averaged gradient, the metrics averaged over the ranks
    and the rank's own."""
    from leftrefill_torch.parallel.mesh import all_reduce_mean, shard_batch
    from leftrefill_torch.train import OptimizerConfig, compute_loss, create_train_state, make_train_step
    from leftrefill_torch.train.trainer import reduce_metrics_across_hosts

    from leftrefill_torch.train import lora_predicate, prompt_only_predicate
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    d = _load(inputs)
    model, kw = d["model"], d["kw"]
    predicate = {"prompt": prompt_only_predicate, "nvs": lora_predicate(nvs_prompt_filter)}[d["predicate"]]
    state, tx = create_train_state(model, OptimizerConfig(lr=1e-3), predicate=predicate)
    batch = shard_batch(d["batch"], ranks.rank, ranks.world)
    grads = {}
    step = tx.step

    def keep_grads():  # the gradients tx applies, after the average
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad})
        return step()

    tx.step = keep_grads
    if d.get("draws") is None:
        _, metrics = make_train_step(model, tx, group=ranks.group, **kw)(state, batch, torch.Generator().manual_seed(3))
    else:
        rows = {k: shard_rows(v, ranks.rank, ranks.world) for k, v in d["draws"].items()}
        loss, metrics = compute_loss(model, batch, t=rows["t"], noise=rows["noise"], vae_noise=rows["vae_noise"],
                                     cfg_draws=rows.get("cfg_draws"), **kw)
        loss.backward()
        all_reduce_mean([p.grad for p in tx.params], ranks.group)
        tx.step()
    mean = reduce_metrics_across_hosts({k: float(v) for k, v in metrics.items()}, ranks.group)
    out = {f"param/{n}": p.detach().numpy() for n, p in model.named_parameters() if p.requires_grad}
    out.update({f"grad/{n}": g.numpy() for n, g in grads.items()})
    out.update({f"mean/{k}": np.float64(v) for k, v in mean.items()})
    out.update({f"own/{k}": np.float64(float(v)) for k, v in metrics.items()})
    return out


def cli_body(ranks, work, argv: list, table_key: str) -> dict:
    """The training CLI on this rank (its loader on one worker, as the
    single-process comparison needs): the first batch it hands its step,
    the prompt table after each step, and the checkpoints and sample grids
    this rank wrote."""
    from leftrefill_torch.cli import train as cli
    from leftrefill_torch.data import loader
    from leftrefill_torch.train import checkpoints, logger, trainer

    seen, tables, saves, grids = [], [], [], []
    make_step, save, log = trainer.make_train_step, checkpoints.save_pruned, logger.ImageLogger.log

    class OneWorker(loader.DataLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, num_workers=1))

    def recording(model, tx, **kw):
        step = make_step(model, tx, **kw)

        def run(state, batch, gen):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            out = step(state, batch, gen)
            tables.append(dict(model.named_parameters())[table_key].detach().numpy().copy())
            return out

        return run

    loader.DataLoader, trainer.make_train_step = OneWorker, recording
    checkpoints.save_pruned = lambda *a, **kw: (saves.append(1), save(*a, **kw))[1]
    logger.ImageLogger.log = lambda self, *a, **kw: (grids.append(1), log(self, *a, **kw))[1]
    assert cli.main(argv) == 0
    out = {f"batch/{k}": v for k, v in seen[0].items()}
    out.update({f"table{i}": t for i, t in enumerate(tables)})
    out.update(saves=np.int32(len(saves)), grids=np.int32(len(grids)))
    return out
