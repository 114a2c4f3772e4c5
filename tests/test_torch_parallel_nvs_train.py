"""The data-parallel novel-view-synthesis step of the port on 2 gloo CPU
ranks (``tools.dryrun.run_ranks``, rank bodies in
``tests/torch_parallel_ranks.py``), fp32 on the tiny NVS bundle of
``tests/test_torch_nvs_train.py`` (refinement branch on, f8 VAE, LoRA rank
2), every trainable group (prompt table, relative-pose MLP, refinement
branch, LoRA factors).  2 ranks x batch 2 against:

- 1 rank x batch 4 with the same generator (t, noise and CFG draws for the
  global batch): each group's averaged gradient within 1e-5 relative L2
  (``FP32_REL``), the prompt table after the step within 1e-6 absolute, the
  ranks' parameters bit-equal;
- JAX's step on a 2-device mesh, the ranks on JAX's draws (one row's
  prompt dropped by the CFG draws): each group's averaged gradient within
  ``tests/test_torch_nvs_train.py``'s 1e-4 relative L2 of ``jax.grad`` over
  the global batch, the prompt table after the step within 1e-6 of the JAX
  step's.

The parameters after the step are held for the prompt table only: AdamW's
first step divides each gradient by its own size plus 1e-8, so a parameter
whose gradient is ~1e-9 (the refinement branch's last bias: at most
2.3e-9) moves by a share of the lr that rounding decides (1.1e-4 apart
here); the gradients are held instead."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nvs_train import GRAD_L2, GROUPS, _config, _port_names
from test_torch_parity_utils import FP32_REL, fill_tree, rel_l2, t

from leftrefill_torch.convert.from_jax import lora_from_flax, state_dict_from_flax
from leftrefill_torch.tools.dryrun import run_ranks

HERE = __file__.rsplit("/", 1)[0]
B, H, W = 4, 32, 64
TABLE_ABS = 1e-6
TABLE = "model.cond_stage_model.special_embeddings.weight"
TIMEOUT = 90


@pytest.fixture(scope="module")
def setup():
    """(JAX model, task, wrapped params, the port's wrapped model and task,
    the batch of 4)."""
    from leftrefill_tpu.config import build_model_from_config as jbuild
    from leftrefill_tpu.models.lora import default_target, init_lora
    from leftrefill_tpu.tasks import NVSTask as JTask
    from leftrefill_tpu.train.trainer import wrap_lora_params as jwrap

    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.tasks import NVSTask
    from leftrefill_torch.train import wrap_lora_params

    cfg = _config()
    jb = jbuild(copy.deepcopy(cfg), dtype=jnp.float32)
    jtask = JTask(jb)
    m = jb.model
    key = jax.random.PRNGKey(0)
    struct = {
        "unet": jax.eval_shape(m.unet.init, key, jnp.zeros((1, 4, 8, 9)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, m.unet.context_dim)))["params"],
        "vae": jax.eval_shape(m.vae.init, key, jnp.zeros((1, H, W, 3)))["params"],
        "cond": jax.eval_shape(m.cond_model.init, key, jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 4)))["params"],
        "refine": jax.eval_shape(jtask.refinement.init, key, jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 1)))["params"],
    }
    params = {k: fill_tree(v, seed) for seed, (k, v) in enumerate(struct.items())}
    lora = init_lora(params["unet"], rank=2, target=default_target, key=jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    lora = {k: {"down": np.asarray(v["down"]), "up": 0.1 * rng.standard_normal(np.shape(v["up"])).astype(np.float32)}
            for k, v in lora.items()}
    jparams = jwrap(jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, lora))
    bundle = build_model_from_config(copy.deepcopy(cfg), dtype=torch.float32, device="cpu")
    bundle.model.load_state_dict(state_dict_from_flax(params), strict=True)
    task = NVSTask(bundle, device="cpu")
    model = wrap_lora_params(bundle.model, lora_from_flax(lora), bundle.lora_config["lora_scale"])
    rng = np.random.RandomState(3)
    image = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    mask = np.zeros((B, H, W, 1), np.float32)
    mask[:, 4:28, W // 2 + 2:W - 3] = 1.0
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": np.asarray(bundle.tokenizer.tokenize([" ".join(bundle.special_tokens)] * B)),
             "rel_pose": rng.standard_normal((B, 4)).astype(np.float32)}
    return m, jtask, jparams, model, task, batch


def _ranks(tmp_path, model, task, batch, draws=None):
    path = str(tmp_path / "inputs.pt")
    torch.save({"model": model, "kw": {"cond_builder": task.cond_builder}, "predicate": "nvs", "batch": batch,
                "draws": draws}, path)
    return run_ranks("torch_parallel_ranks:train_step_body", 2, str(tmp_path), {"inputs": path}, timeout=TIMEOUT,
                     pythonpath=(HERE,))


def _groups(values: dict) -> dict:
    """Each trainable group's values, flattened and concatenated by name."""
    return {g: np.concatenate([np.asarray(values[n]).ravel() for n in sorted(values) if k in n])
            for g, k in GROUPS.items()}


def test_two_ranks_take_the_one_rank_step(setup, tmp_path):
    """Readings: gradients 1.6e-6 to 2.7e-6, the table 9.3e-10 after the
    step."""
    from leftrefill_torch.train import OptimizerConfig, create_train_state, lora_predicate, make_train_step
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    _, _, _, model, task, batch = setup
    outs = _ranks(tmp_path, model, task, batch)
    ours = copy.deepcopy({"m": model, "t": task})
    one, one_task = ours["m"], ours["t"]
    state, tx = create_train_state(one, OptimizerConfig(lr=1e-3), predicate=lora_predicate(nvs_prompt_filter))
    grads = {}
    step = tx.step

    def keep_grads():
        grads.update({n: p.grad.detach().numpy().copy() for n, p in one.named_parameters() if p.requires_grad})
        return step()

    tx.step = keep_grads
    make_train_step(one, tx, cond_builder=one_task.cond_builder)(state, batch, torch.Generator().manual_seed(3))
    after = {n: p.detach().numpy() for n, p in one.named_parameters() if p.requires_grad}
    got = [{k[len(p):]: v for k, v in o.items() if k.startswith(p)} for o in outs for p in ("param/", "grad/")]
    assert all(np.array_equal(got[0][n], got[2][n]) for n in after)
    want = _groups(grads)
    for g, ours_g in _groups(got[1]).items():
        assert np.abs(want[g]).max() > 0 and rel_l2(ours_g, want[g]) < FP32_REL, g
    assert np.abs(got[0][TABLE] - after[TABLE]).max() <= TABLE_ABS


def test_two_ranks_take_jaxs_mesh_step(setup, tmp_path):
    """Readings: gradients 1.5e-6 to 3.2e-6 of jax.grad, the table 9.3e-9
    from the JAX step's."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian
    from leftrefill_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from leftrefill_tpu.train.checkpoints import nvs_prompt_filter as jfilter
    from leftrefill_tpu.train.trainer import OptimizerConfig as JO, compute_loss as jloss
    from leftrefill_tpu.train.trainer import create_train_state as jcreate, lora_predicate as jpred
    from leftrefill_tpu.train.trainer import make_train_step as jstep

    m, jtask, jparams, model, task, batch = setup
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if (np.asarray(jax.random.uniform(jax.random.split(k, 3)[2], (B,))) < 0.15).sum() == 1)
    t_key, n_key, c_key = jax.random.split(key, 3)
    z_shape = (B, H // 8, W // 8, 4)
    draws = {"t": torch.from_numpy(np.asarray(jax.random.randint(t_key, (B,), 0, 1000)).astype(np.int64)),
             "noise": t(jax.random.normal(n_key, z_shape, jnp.float32)),
             "cfg_draws": t(jax.random.uniform(c_key, (B,))),
             "vae_noise": t(jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), z_shape))}
    outs = _ranks(tmp_path, model, task, batch, draws)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def cond_builder(p, b, k):
        return jtask.build_cond(p, b, train=True, cfg_key=k)

    grads = jax.jit(jax.grad(lambda p: jloss(m, p, jb, key, cond_builder=cond_builder)[0]))(jparams)
    state, tx = jcreate(jparams, JO(lr=1e-3), jpred(jfilter))
    mesh = make_mesh(2)
    with mesh:
        new, _ = jstep(m, tx, donate=False, cond_builder=cond_builder)(replicate(mesh, state),
                                                                        shard_batch(mesh, jb), key)
    want_grads, want_params = _port_names(grads), _port_names(new.params)
    got = {p: {k[len(p):]: v for k, v in outs[0].items() if k.startswith(p)} for p in ("param/", "grad/")}
    want = _groups({n: want_grads[n] for n in got["grad/"]})
    for g, ours_g in _groups(got["grad/"]).items():
        assert np.abs(want[g]).max() > 0 and rel_l2(ours_g, want[g]) < GRAD_L2, g
    assert np.abs(got["param/"][TABLE] - np.asarray(want_params[TABLE])).max() <= TABLE_ABS
