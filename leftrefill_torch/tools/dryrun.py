"""Multi-rank runs on the CPU: the rank launcher the tests and the chip
smoke share, and the data-parallel dry run of the three task families
(counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``).

    python -m leftrefill_torch.tools.dryrun 4            # every family, 4 gloo ranks each
    python -m leftrefill_torch.tools.dryrun 2 cfgpar     # one family

``run_ranks`` starts ``world`` processes of this module, each one rank of a
gloo (CPU) or card process group rendezvousing through a file, calls a rank
body ``"module:function"`` with the rank's ``parallel.mesh.Ranks``, its
work directory and keyword arguments, and returns what each rank's body
returned (a dict of arrays, saved with ``np.savez``).  A rank that raises
fails the run, and a run that outlasts its time limit is killed.

The families, tiny bundles with seeded random weights on every rank:
``ref``, ``mv`` and ``nvs`` take one data-parallel train step each (the
trainable groups move, the frozen UNet does not, every rank ends with the
same table); ``mv`` also holds the (data, view) context-parallel forward to
the one-rank forward; ``cfgpar`` samples DDIM-2 with the CFG batch split
over the ranks and holds it to the one-rank pipeline.  JAX's ``full``
family (the 865M sharded gradient, lowered) has its counterpart on the card:
``chip_smoke.py`` phase 14t, the full-width data-parallel step."""

from __future__ import annotations

import datetime
import functools
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
FAMILIES = ("ref", "mv", "nvs", "cfgpar")


def run_ranks(target: str, world: int, workdir: str, kwargs: dict | None = None, device: str = "cpu",
              timeout: float = 60.0, pythonpath: tuple = ()) -> list[dict]:
    """Run the rank body ``target`` ("module:function", importable with the
    repository root and ``pythonpath`` on the path) on ``world`` ranks, one
    process each, and return each rank's result.  ``timeout`` bounds the
    whole run and the process group's collectives."""
    work = Path(tempfile.mkdtemp(prefix="ranks-", dir=workdir))
    (work / "kwargs.json").write_text(json.dumps(kwargs or {}))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), *map(str, pythonpath), env.get("PYTHONPATH", "")])
    procs, logs = [], []
    for rank in range(world):
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        log = open(work / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "leftrefill_torch.tools.dryrun", "--rank-body", target, str(work), device,
             str(timeout)], env=dict(env), stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO)))
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails leaves the others waiting on it: stop at the first
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target} on {world} ranks outlasted {timeout} s:\n{_tails(work, world)}")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            raise RuntimeError(f"{target}: ranks {failed} failed or were stopped:\n{_tails(work, world)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(world)]


def _tails(work: Path, world: int) -> str:
    return "\n".join(f"--- rank {r} ---\n" + (work / f"rank{r}.log").read_text()[-3000:] for r in range(world))


def _rank_main(target: str, work: str, device: str, timeout: float) -> None:
    """One rank: join the group, run the body, save its result."""
    import torch.distributed as dist

    from leftrefill_torch.parallel.mesh import init_from_env

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    ranks = init_from_env(device, init_method="file://" + os.path.join(work, "rendezvous"),
                          timeout=datetime.timedelta(seconds=timeout))
    module, name = target.split(":")
    kwargs = json.loads(Path(work, "kwargs.json").read_text())
    try:
        result = getattr(importlib.import_module(module), name)(ranks, work, **kwargs) or {}
        np.savez(os.path.join(work, f"rank{ranks.rank}.npz"), **result)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry run

TINY_UNET = dict(in_channels=9, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=(1,),
                 channel_mult=(1, 2), num_head_channels=8, context_dim=32)


def _tiny_bundle(multiview: bool = False, view_group=None, seed: int = 0):
    """A tiny complete bundle (9-channel UNet, 2x VAE, 2-layer text tower
    with 8 prompt tokens), every parameter from a generator seeded ``seed``;
    with ``multiview`` the V=2 multi-view UNet (its views split over
    ``view_group`` where given)."""
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.pipeline import fill_random_, sd2_schedule

    unet = MultiViewUnetModel(view_num=2, view_group=view_group, **TINY_UNET) if multiview else UNetModel(**TINY_UNET)
    model = LeftRefillModel(unet, AutoencoderKL(DDConfig(z_channels=4, resolution=64, ch=32, ch_mult=(1, 2),
                                                         num_res_blocks=1), embed_dim=4),
                            PromptCLIPEmbedder(vocab_size=1024, width=32, heads=2, layers=2, num_special_tokens=8),
                            sd2_schedule())
    fill_random_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def _tokens(rows: int) -> np.ndarray:
    tokens = np.zeros((rows, 77), np.int64)
    tokens[:, 0] = 1022
    tokens[:, 1:6] = 1024 + np.arange(5)  # prompt-token ids past the vocabulary
    tokens[:, 6] = 1023
    return tokens


def _canvas_batch(rows: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (rows, 32, 64, 3)).astype(np.float32)
    mask = np.concatenate([np.zeros((rows, 32, 32, 1)), np.ones((rows, 32, 32, 1))], axis=2).astype(np.float32)
    return {"image": image, "mask": mask, "masked_image": image * (1 - mask), "tokens": _tokens(rows)}


def _step_and_check(ranks, model, batch: dict, moved: dict, frozen: dict, predicate=None, **step_kw) -> float:
    """One data-parallel step on this rank's rows of ``batch``, training what
    ``predicate`` selects (default the prompt table): finite loss, each
    ``moved`` parameter changed and equal on every rank, each ``frozen`` one
    unchanged."""
    from leftrefill_torch.parallel.mesh import all_gather_cat, shard_batch
    from leftrefill_torch.train import OptimizerConfig, create_train_state, make_train_step, prompt_only_predicate

    state, tx = create_train_state(model, OptimizerConfig(lr=3e-5, weight_decay=0.0),
                                   predicate or prompt_only_predicate)
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in (*moved.values(), *frozen.values())}
    step = make_train_step(model, tx, group=ranks.group, **step_kw)
    _, metrics = step(state, shard_batch(batch, ranks.rank, ranks.world), torch.Generator().manual_seed(1))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    for label, n in moved.items():
        p = params[n].detach()
        if torch.equal(p, before[n]):
            raise AssertionError(f"{label} did not update")
        if not torch.equal(all_gather_cat(p[None], ranks.group, 0), p[None].expand(ranks.world, *p.shape)):
            raise AssertionError(f"{label} differs between the ranks")
    for label, n in frozen.items():
        if not torch.equal(params[n].detach(), before[n]):
            raise AssertionError(f"frozen {label} moved")
    return loss


TABLE = {"special_embeddings": "cond_stage_model.special_embeddings.weight"}
OUT_CONV = {"unet out conv": "model.diffusion_model.out.2.weight"}


def family_ref(ranks, work) -> dict:
    """1-reference prompt tuning: two canvases a rank."""
    model = _tiny_bundle()
    loss = _step_and_check(ranks, model, _canvas_batch(2 * ranks.world, 0), TABLE, OUT_CONV)
    return {"loss": np.float32(loss)}


def family_mv(ranks, work) -> dict:
    """Multi-view (V=2, the view-0 loss): one scene a rank; then, where the
    ranks form (data, view 2), the view-sharded UNet forward against the
    one-rank forward of the same rows."""
    from leftrefill_torch.data import flatten_views
    from leftrefill_torch.parallel.context import local_views
    from leftrefill_torch.parallel.mesh import make_groups

    model = _tiny_bundle(multiview=True)
    rng = np.random.RandomState(1)
    scenes = ranks.world
    image = rng.uniform(-1, 1, (scenes, 2, 32, 64, 3)).astype(np.float32)
    mask = np.zeros((scenes, 2, 32, 64, 1), np.float32)
    mask[:, 0, :, 32:] = 1.0  # the target view only
    batch = flatten_views({"image": image, "mask": mask, "masked_image": image * (1 - mask),
                           "tokens": np.repeat(_tokens(scenes)[:, None], 2, axis=1)})
    out = {"loss": np.float32(_step_and_check(ranks, model, batch, TABLE, OUT_CONV, view_reduced=True,
                                              view_num=2))}
    if ranks.world % 2 == 0:
        data_group, view_group = make_groups(ranks.world // 2, 2)
        cp = _tiny_bundle(multiview=True, view_group=view_group)
        cp.load_state_dict(model.state_dict())
        x = torch.from_numpy(rng.uniform(-1, 1, (2 * scenes, 8, 16, 9)).astype(np.float32))
        t = torch.full((2 * scenes,), 7)
        ctx = torch.from_numpy(rng.uniform(-1, 1, (2 * scenes, 77, 32)).astype(np.float32))
        mine = functools.partial(local_views, view_num=2, view_group=view_group, data_group=data_group)
        with torch.no_grad():
            ref = mine(model.unet(x, t, ctx))
            got = cp.unet(*map(mine, (x, t, ctx)))
        err = float((got - ref).abs().max())
        if not err < 1e-4:
            raise AssertionError(f"context-parallel forward mismatch: {err}")
        out["cp_max_abs"] = np.float32(err)
    return out


NVS_CONFIG = {"model": {"target": "inpainting_ldm.NVS_ldm.NVSLDM", "params": {
    "linear_start": 0.00085, "linear_end": 0.0120, "timesteps": 1000, "conditioning_key": "hybrid-refine",
    "scale_factor": 0.18215,
    "unet_config": {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModel", "params": {
        **TINY_UNET, "attention_resolutions": [1], "channel_mult": [1, 2], "use_sep": True}},
    "first_stage_config": {"target": "ldm.models.autoencoder.AutoencoderKL", "params": {
        "embed_dim": 4, "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 32, "in_channels": 3,
                                     "out_ch": 3, "ch": 16, "ch_mult": [1, 1, 1, 1], "num_res_blocks": 1,
                                     "attn_resolutions": [], "dropout": 0.0}}},
    "cond_stage_config": {"target": "ldm.modules.encoders.NVS_modules.NVSCLIPEmbedder", "params": {
        "layer": "penultimate", "special_tokens": ["repeat_8_<special-token>"], "init_text": ["pose"],
        "cfg_rate": 0.15, "width": 32, "heads": 2, "layers": 2}},
    "lora": {"do_lora": True, "lora_type": "default", "lora_rank": 4, "lora_scale": 1.0},
    "data_config": {"img_size": 32, "cfg": 2.5},
    "refinement_config": {"use_input_refinement": True, "only_masked_refine": False},
    "save_prompt_only": True}}}


def family_nvs(ranks, work) -> dict:
    """Novel-view synthesis: the pose token with the CFG dropout, the
    refinement branch, the separator columns and LoRA; one canvas a rank."""
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.models.lora import default_target, init_lora
    from leftrefill_torch.tasks import build_task
    from leftrefill_torch.train import lora_predicate, wrap_lora_params
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    bundle = build_model_from_config(NVS_CONFIG, dtype=torch.float32, device="cpu")
    task = build_task(bundle, "cpu")
    gen = torch.Generator().manual_seed(0)
    task.init_params(gen)
    with torch.no_grad():  # its initializer's 0 would hide the branch's gradient
        bundle.model.refinement_alpha.fill_(0.1)
    model = wrap_lora_params(bundle.model, init_lora(bundle.model.unet, rank=4, target=default_target,
                                                     generator=gen))
    batch = _canvas_batch(ranks.world, 2)
    batch["rel_pose"] = np.random.RandomState(2).uniform(-1, 1, (ranks.world, 4)).astype(np.float32)
    batch["tokens"] = np.asarray(bundle.tokenizer.tokenize([" ".join(bundle.special_tokens)] * ranks.world))
    names = [n for n, _ in model.named_parameters()]
    moved = {"special_embeddings": "model." + TABLE["special_embeddings"],
             "refinement_alpha": "model.refinement_alpha",
             "lora up": next(n for n in names if n.startswith("lora.up."))}
    moved["rel_pos mlp"] = next(n for n in names if "rel_pos_model" in n and n.endswith("weight"))
    loss = _step_and_check(ranks, model, batch, moved, {"unet out conv": "model." + OUT_CONV["unet out conv"]},
                           predicate=lora_predicate(nvs_prompt_filter), cond_builder=task.cond_builder)
    return {"loss": np.float32(loss)}


def family_cfgpar(ranks, work) -> dict:
    """CFG-parallel DDIM-2: the CFG-doubled UNet batch split over the ranks
    against the one-rank sampling on the same seed."""
    from leftrefill_torch.pipeline import _generate

    model = _tiny_bundle()
    b = max(1, ranks.world // 2)  # CFG doubles: 2b rows over the ranks
    batch = _canvas_batch(b, 0)
    image, mask, tokens = (torch.from_numpy(batch[k]) for k in ("image", "mask", "tokens"))
    outs = {}
    with torch.no_grad():
        for name, group in (("split", ranks.group), ("one_rank", None)):
            outs[name] = _generate(model, image, mask, tokens, torch.zeros_like(tokens), ddim_steps=2, eta=1.0,
                                   guidance_scale=2.5, generator=torch.Generator().manual_seed(0),
                                   group=group).numpy()
    err = float(np.abs(outs["split"] - outs["one_rank"]).max())
    if not (np.isfinite(outs["split"]).all() and err < 1e-5):
        raise AssertionError(f"cfg-parallel DDIM differs from the one-rank run by {err}")
    return {"max_abs": np.float32(err)}


def dryrun_multichip(n_ranks: int, family: str | None = None, timeout: float = 120.0) -> None:
    """Each family (or ``family`` alone) on ``n_ranks`` gloo CPU ranks, the
    families one after another; a failing family raises with its name."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    with tempfile.TemporaryDirectory() as work:
        for fam in (family,) if family else FAMILIES:
            if fam == "cfgpar" and (2 * max(1, n_ranks // 2)) % n_ranks:
                raise ValueError(f"the cfg-parallel dry run needs an even rank count, got {n_ranks}")
            try:
                res = run_ranks(f"leftrefill_torch.tools.dryrun:family_{fam}", n_ranks, work, timeout=timeout)
            except (RuntimeError, TimeoutError) as e:
                raise RuntimeError(f"dryrun_multichip: family {fam} failed") from e
            print(f"  {fam}: ok {({k: float(v) for k, v in res[0].items()})} ({n_ranks} ranks)", flush=True)
    print(f"dryrun_multichip({n_ranks}): ok ({', '.join((family,) if family else FAMILIES)})")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank-body":
        try:
            _rank_main(sys.argv[2], sys.argv[3], sys.argv[4], float(sys.argv[5]))
        except BaseException:
            traceback.print_exc()
            sys.exit(1)
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2, sys.argv[2] if len(sys.argv) > 2 else None)
