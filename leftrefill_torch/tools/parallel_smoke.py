"""The rank bodies of ``chip_smoke.py`` phase 14: the port's parallel paths at
full width on the card, each rank one process (``tools.dryrun.run_ranks``,
or torchrun for the CLI), all ranks on one card over gloo where the machine
has one.  They live in the package so that the ranks import neither
``chip_smoke.py`` nor anything of JAX.  Each body returns numpy arrays:
its kernel launches (``tools.LAUNCH_COUNTERS`` order) in the window the
smoke gates, its readings and its seconds.

- ``cfg_request`` (14b): a CFG-parallel request, the bf16 bundle at DDIM-50
  then the fused int8 UNet at DPM++(2M)-15, the UNet's rows at two steps
  rerun alone, the one-rank request beside it on rank 0;
- ``view_forward`` (14v): the V=4 forward with the views split over
  (data, view) layouts, held to the one-rank forward's rows;
- ``train_step`` (14t): one data-parallel prompt-tuning step (phase 7's),
  or the one-rank reference and the same step through a group of one;
- ``python -m leftrefill_torch.tools.parallel_smoke cli OUT -- ARGS`` (14c):
  ``cli.train.main(ARGS)`` on a rank torchrun started, recording each step
  and what the rank wrote, saved to ``OUT/rank<r>.npz``."""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time

import numpy as np
import torch

from leftrefill_torch import kernels, tools

BF16 = torch.bfloat16


def _launches() -> np.ndarray:
    counts = tools.launches()
    return np.asarray([counts[n] for n in tools.LAUNCH_COUNTERS], np.int64)


def cfg_request(ranks, work) -> dict:
    """14b: for each arm, a warm-up request and a counted one with the CFG
    batch split over the ranks, at steps ``probe`` the UNet's gathered output
    against each row run alone at batch 1 in this process (and against the
    other row: what a swap would read), then on rank 0 the one-rank request
    of the same seed."""
    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.parallel import batch as pb
    from leftrefill_torch.parallel.batch import take_rows
    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

    image, mask = tools.request_canvas()
    out = {}
    for arm, quant, sampler, steps, probe in (("bf16", False, "ddim", 50, (0, 25)),
                                              ("int8", True, "dpm++2m", 15, (0, 7))):
        model = build_sd2_inpaint_bundle("cuda", BF16, torch.Generator("cuda").manual_seed(0), quant=quant)
        one = tools.serving_pipeline(model, sampler=sampler, steps=steps)
        split = dataclasses.replace(one, group=ranks.group)
        calls, real = [], pb.batch_parallel_apply

        def recording(model_, group, cross_kv=None):
            fn = real(model_, group, cross_kv=cross_kv)

            def run(x, t, c):
                o = fn(x, t, c)
                calls.append((x.clone(), t.clone(), c, cross_kv, o.clone()) if len(calls) in probe else None)
                return o

            return run

        pb.batch_parallel_apply = recording
        try:
            split(image, mask, torch.Generator("cuda").manual_seed(99))  # warm-up
            calls.clear()
            torch.cuda.synchronize()
            tools.reset_launches()
            t0 = time.perf_counter()
            got = split(image, mask, torch.Generator("cuda").manual_seed(1))
            torch.cuda.synchronize()
            out[f"{arm}/s_split"] = np.float64(time.perf_counter() - t0)
            out[f"{arm}/launches"] = _launches()
        finally:
            pb.batch_parallel_apply = real
        errs, swapped = [], []
        with torch.inference_mode():
            for x, t, c, kv, o in (call for call in calls if call is not None):
                for r in range(2):
                    cond = Conditioning(c.c_concat[r:r + 1], c.c_crossattn[r:r + 1])
                    row = model.apply_model(x[r:r + 1], t[r:r + 1], cond, cross_kv=take_rows(kv, slice(r, r + 1)),
                                            cfg_dup=False)
                    errs.append(tools.rel_l2(o[r:r + 1], row))
                    swapped.append(tools.rel_l2(o[1 - r:2 - r], row))
        out[f"{arm}/calls"] = np.int64(len(calls))
        out[f"{arm}/row_rel_l2"], out[f"{arm}/swapped_rel_l2"] = np.asarray(errs), np.asarray(swapped)
        out[f"{arm}/image"] = got.float().cpu().numpy()
        if ranks.rank == 0:
            t0 = time.perf_counter()
            whole = one(image, mask, torch.Generator("cuda").manual_seed(1))
            torch.cuda.synchronize()
            out[f"{arm}/s_one_rank"] = np.float64(time.perf_counter() - t0)
            out[f"{arm}/vs_one_rank_rel_l2"] = np.float64(tools.rel_l2(got, whole))
        out[f"{arm}/peak_gib"] = np.float64(torch.cuda.max_memory_allocated() / 2**30)
        del model, one, split, calls, got
        torch.cuda.empty_cache()
    return out


def view_forward(ranks, work, layouts: list) -> dict:
    """14v: the full-width V=4 UNet forward (8 rows of 64x64 views: one
    scene's CFG pair) on this rank's views for each (n_data, n_view) layout,
    against the one-rank forward's rows in this process (and against those
    rows reversed: what views out of place would read); its launches and K1
    sites, and its CUDA-event ms (the ranks share the card)."""
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.parallel.context import local_views
    from leftrefill_torch.parallel.mesh import make_groups
    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

    unet = build_sd2_inpaint_bundle("cuda", BF16, torch.Generator("cuda").manual_seed(0), view_num=4).unet
    x, t, ctx = tools.unet_inputs(torch.Generator("cuda").manual_seed(1), rows=8, hw=(64, 64))
    with torch.inference_mode():
        full = unet(x, t, ctx, cross_kv=unet.cross_kv(ctx))
    out = {}
    for n_data, n_view in layouts:
        key = f"{n_data}x{n_view}"
        data_group, view_group = make_groups(n_data, n_view)
        with torch.device("meta"):
            cp = MultiViewUnetModel(view_num=4, view_group=view_group, dtype=BF16)
        cp = cp.to_empty(device=ranks.device).eval()
        cp.load_state_dict(unet.state_dict())
        mine = functools.partial(local_views, view_num=4, view_group=view_group, data_group=data_group)
        xl, tl, cl = map(mine, (x, t, ctx))
        with torch.inference_mode():
            kv = cp.cross_kv(cl)
            torch.cuda.synchronize()
            tools.reset_launches()
            with kernels.record_sites() as sites:
                got = cp(xl, tl, cl, cross_kv=kv)
            torch.cuda.synchronize()
            out[f"{key}/launches"] = _launches()
            ref = mine(full)
            out[f"{key}/rel_l2"] = np.float64(tools.rel_l2(got, ref))
            out[f"{key}/reversed_rel_l2"] = np.float64(tools.rel_l2(got, ref.flip(0)))
            out[f"{key}/ms"] = np.float64(tools.cuda_ms(lambda: cp(xl, tl, cl, cross_kv=kv), 3))
        out[f"{key}/k1_sites"] = np.asarray([(*shape, 1) for name, shape in sites if name == "flash_fwd"], np.int64)
        out[f"{key}/rows"] = np.int64(xl.shape[0])
        del cp, kv, got
        torch.cuda.empty_cache()
    out["peak_gib"] = np.float64(torch.cuda.max_memory_allocated() / 2**30)
    return out


def train_step(ranks, work, reference: bool) -> dict:
    """14t: phase 7's prompt-tuning step (the remat bundle, the prompt table
    from its init text, AdamW 3e-5, wd 0.01, ``tools.training_batch(8)``,
    t and the noise from a card generator seeded 0), this rank's rows of the
    batch of 8 through ``make_train_step(group=)``.  ``reference``: first the
    one-rank step (no group) on the whole batch, then, from the same table,
    the step through this run's group.  Returns each step's averaged
    gradient, table after, launches, seconds and loss."""
    from leftrefill_torch.models.clip import init_prompt_table
    from leftrefill_torch.parallel.mesh import group_rank, group_size, shard_batch
    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle
    from leftrefill_torch.train import OptimizerConfig, create_train_state, make_train_step

    model = build_sd2_inpaint_bundle("cuda", BF16, torch.Generator("cuda").manual_seed(0), remat=True)
    tok, sp, init = tools.prompt_tokenizer()
    init_prompt_table(model.cond_stage_model, tok, sp, init)
    table = model.cond_stage_model.special_embeddings.weight
    start = table.detach().clone()
    batch = tools.training_batch(8)
    out = {}
    for name, group in ((("one_rank", None),) if reference else ()) + ((_group_name(ranks), ranks.group),):
        with torch.no_grad():
            table.copy_(start)
        state, tx = create_train_state(model, OptimizerConfig())
        step, apply = make_train_step(model, tx, group=group), tx.step
        grads = []
        tx.step = lambda: (grads.append(table.grad.detach().float().clone()), apply())[1]
        local = shard_batch(batch, group_rank(group), group_size(group))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tools.reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(state, local, torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        out[f"{name}/s"] = np.float64(time.perf_counter() - t0)
        out[f"{name}/launches"] = _launches()
        out[f"{name}/grad"] = grads[0].cpu().numpy()
        out[f"{name}/table"] = table.detach().float().cpu().numpy()
        out[f"{name}/loss"] = np.float64(float(metrics["loss"]))
        out[f"{name}/peak_gib"] = np.float64(torch.cuda.max_memory_allocated() / 2**30)
    return out


def _group_name(ranks) -> str:
    import torch.distributed as dist

    return f"group_{dist.get_backend(ranks.group)}_{ranks.world}"


def cli_rank(out_dir: str, argv: list) -> int:
    """14c: ``cli.train.main(argv)`` on this torchrun rank, each step timed
    with its launches and the table after it, the seconds between steps (the
    data's pace), and the checkpoints and sample grids this rank wrote."""
    from leftrefill_torch.cli import train as cli
    from leftrefill_torch.train import checkpoints, logger, trainer

    steps, tables, writes = [], [], {"saves": 0, "grids": 0}
    make_step, save, log = trainer.make_train_step, checkpoints.save_pruned, logger.ImageLogger.log

    def recording(model, tx, **kw):
        step = make_step(model, tx, **kw)
        table = dict(model.named_parameters())["cond_stage_model.special_embeddings.weight"]

        def run(state, batch, gen):
            torch.cuda.synchronize()
            tools.reset_launches()
            t0 = time.perf_counter()
            res = step(state, batch, gen)
            torch.cuda.synchronize()
            steps.append((t0, time.perf_counter() - t0, _launches()))
            tables.append(table.detach().float().cpu().numpy())
            return res

        return run

    def counted(key, fn):
        def run(*a, **kw):
            writes[key] += 1
            return fn(*a, **kw)

        return run

    trainer.make_train_step = recording
    checkpoints.save_pruned = counted("saves", save)
    logger.ImageLogger.log = counted("grids", log)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    np.savez(os.path.join(out_dir, f"rank{os.environ['RANK']}.npz"), rc=np.int64(rc),
             cli_s=np.float64(time.perf_counter() - t0), start=np.asarray([s[0] for s in steps]),
             step_s=np.asarray([s[1] for s in steps]), launches=np.stack([s[2] for s in steps]),
             tables=np.stack(tables), peak_gib=np.float64(torch.cuda.max_memory_allocated() / 2**30),
             **{k: np.int64(v) for k, v in writes.items()})
    return rc


if __name__ == "__main__":
    if len(sys.argv) < 4 or sys.argv[1] != "cli" or sys.argv[3] != "--":
        raise SystemExit("usage: python -m leftrefill_torch.tools.parallel_smoke cli OUT_DIR -- CLI_ARGS...")
    sys.exit(cli_rank(sys.argv[2], sys.argv[4:]))
