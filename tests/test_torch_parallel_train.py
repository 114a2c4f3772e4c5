"""The data-parallel prompt-tuning step of the port (``make_train_step(...,
group=)``, ``reduce_metrics_across_hosts``) on gloo CPU ranks
(``tools.dryrun.run_ranks``, rank bodies in ``tests/torch_parallel_ranks.py``),
fp32 on the tiny bundles of ``tests/test_torch_train_grad.py``: the
1-reference bundle and the V=2 multi-view bundle with the view-0 loss, one
scene a rank.  2 ranks x batch 2 against:

- 1 rank x batch 4 with the same generator: the averaged gradient within
  1e-5 relative L2 (``FP32_REL``: fp32 sums over other row counts, forward
  and backward) and the prompt table after the AdamW step within 1e-6
  absolute, the two ranks' tables bit-equal,
  and the mean of the ranks' losses the one-rank loss within 1e-5;
- JAX's step on a 2-device mesh, the ranks on JAX's draws: the averaged
  gradient within ``tests/test_torch_train_grad.py``'s 1e-4 relative L2 of
  ``jax.grad`` over the global batch, the table after the step within 1e-6
  of the JAX step's (an Adam step is blind to the gradient's scale: the
  gradient bound is the one that sees a missing average);

and the loader splitting a global batch over the ranks of a node."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity_utils import FP32_REL, TINY_CLIP, TINY_UNET, TINY_VAE, init_flax, rel_l2, t, tiny_bundles
from test_torch_train_grad import GRAD_L2, _jax_draws

from leftrefill_torch.tools.dryrun import run_ranks

HERE = __file__.rsplit("/", 1)[0]
TABLE_ABS = 1e-6
TABLE = "cond_stage_model.special_embeddings.weight"
TIMEOUT = 90


def _ranks(tmp_path, **inputs):
    path = str(tmp_path / "inputs.pt")
    torch.save(inputs, path)
    return run_ranks("torch_parallel_ranks:train_step_body", 2, str(tmp_path), {"inputs": path}, timeout=TIMEOUT,
                     pythonpath=(HERE,))


def _ref_family():
    jm, params, tm, tok, sp = tiny_bundles(seed=4)
    rng = np.random.RandomState(4)
    image = rng.uniform(-1, 1, (4, 32, 64, 3)).astype(np.float32)
    mask = np.concatenate([np.zeros((4, 32, 32, 1)), np.ones((4, 32, 32, 1))], axis=2).astype(np.float32)
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": np.asarray(tok.tokenize([" ".join(sp)] * 4))}
    return jm, params, tm, batch, {}, (4, 16, 32, 4)


def _mv_family():
    from leftrefill_tpu.diffusion.core import LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder as JC
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.convert.from_jax import state_dict_from_flax
    from leftrefill_torch.data import flatten_views
    from leftrefill_torch.diffusion.core import LeftRefillModel as TM
    from leftrefill_torch.models.autoencoder import AutoencoderKL as TV, DDConfig as TD
    from leftrefill_torch.models.clip import PromptCLIPEmbedder as TC
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.pipeline import sd2_schedule

    _, _, _, tok, sp = tiny_bundles()
    sched = DiffusionSchedule.create(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120)
    jm = JM(unet=JMV(view_num=2, **TINY_UNET), vae=JV(ddconfig=JD(**TINY_VAE), embed_dim=4),
            cond_model=JC(**TINY_CLIP), schedule=sched)
    params = {
        "unet": init_flax(JU(**TINY_UNET), 6, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 77, 24))),
        "vae": init_flax(jm.vae, 7, jnp.zeros((1, 32, 64, 3))),
        "cond": init_flax(jm.cond_model, 8, jnp.zeros((1, 77), jnp.int32)),
    }
    tm = TM(MultiViewUnetModel(view_num=2, **TINY_UNET), TV(TD(**TINY_VAE), embed_dim=4), TC(**TINY_CLIP),
            sd2_schedule())
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    rng = np.random.RandomState(6)
    images = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    masks = np.zeros((2, 2, 32, 32, 1), np.float32)
    masks[:, 0, 8:24, 4:28] = 1.0
    tokens = np.stack([tok.tokenize([" ".join(sp[:2]), " ".join(sp[2:])])] * 2)
    batch = flatten_views({"image": images, "mask": masks, "masked_image": images * (masks < 0.5), "tokens": tokens})
    return jm, params, tm.eval(), batch, {"view_reduced": True, "view_num": 2}, (4, 16, 16, 4)


FAMILIES = {"ref": _ref_family, "mv": _mv_family}


def _one_rank_step(tm, batch, kw):
    """1 rank x the whole batch through the same step, generator seeded 3:
    (table after, its gradient, loss)."""
    from leftrefill_torch.train import OptimizerConfig, create_train_state, make_train_step

    state, tx = create_train_state(tm, OptimizerConfig(lr=1e-3))
    grads = {}
    step = tx.step

    def keep_grads():
        grads["table"] = tx.params[0].grad.detach().clone()
        return step()

    tx.step = keep_grads
    _, metrics = make_train_step(tm, tx, **kw)(state, batch, torch.Generator().manual_seed(3))
    return tx.params[0].detach().numpy(), grads["table"].numpy(), float(metrics["loss"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_ranks_take_the_one_rank_step(tmp_path, family):
    """Readings (ref / mv): gradient 9.5e-7 / 1.1e-6, table 9.3e-10 /
    1.9e-9, loss 0 / 8.6e-8 relative."""
    import copy

    jm, params, tm, batch, kw, _ = FAMILIES[family]()
    outs = _ranks(tmp_path, model=tm, kw=kw, predicate="prompt", batch=batch)
    table, grad, loss = _one_rank_step(copy.deepcopy(tm), batch, kw)
    assert np.array_equal(outs[0][f"param/{TABLE}"], outs[1][f"param/{TABLE}"])
    assert rel_l2(outs[0][f"grad/{TABLE}"], grad) < FP32_REL
    assert np.abs(outs[0][f"param/{TABLE}"] - table).max() <= TABLE_ABS
    own = [float(o["own/loss"]) for o in outs]
    assert own[0] != own[1] and float(outs[0]["mean/loss"]) == pytest.approx(sum(own) / 2, rel=1e-12)
    assert abs(float(outs[0]["mean/loss"]) - loss) <= FP32_REL * abs(loss)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_ranks_take_jaxs_mesh_step(tmp_path, family):
    """Readings (ref / mv): gradient 1.3e-6 / 1.6e-6 of jax.grad, table
    9.3e-9 / 7.5e-9 from the JAX step's."""
    from leftrefill_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from leftrefill_tpu.train.trainer import OptimizerConfig as JO, compute_loss as jloss
    from leftrefill_tpu.train.trainer import create_train_state as jcreate, make_train_step as jstep

    jm, params, tm, batch, kw, z_shape = FAMILIES[family]()
    key = jax.random.PRNGKey(5)
    tt, noise, vae_noise = _jax_draws(key, z_shape, 4)
    draws = {"t": torch.from_numpy(tt), "noise": t(noise), "vae_noise": t(vae_noise)}
    outs = _ranks(tmp_path, model=tm, kw=kw, predicate="prompt", batch=batch, draws=draws)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: jloss(jm, p, jb, key, **kw)[0]))(params)
    want = np.asarray(grads["cond"]["special_embeddings"])
    state, tx = jcreate(params, JO(lr=1e-3))
    mesh = make_mesh(2)
    with mesh:
        new, _ = jstep(jm, tx, donate=False, **kw)(replicate(mesh, state), shard_batch(mesh, jb), key)
    assert np.array_equal(outs[0][f"param/{TABLE}"], outs[1][f"param/{TABLE}"])
    assert np.abs(want).max() > 0 and rel_l2(outs[0][f"grad/{TABLE}"], want) < GRAD_L2
    ref_table = np.asarray(new.params["cond"]["special_embeddings"])
    assert np.abs(outs[0][f"param/{TABLE}"] - ref_table).max() <= TABLE_ABS


def test_loader_splits_the_global_batch_over_the_ranks():
    """Each rank's batches are its contiguous rows of the one-rank loader's
    batches of world x batch_size, the dataset reading every item on every
    rank in the one order."""
    from leftrefill_torch.data.loader import DataLoader

    class Items:
        def __init__(self):
            self.read = []

        def __len__(self):
            return 13

        def __getitem__(self, i):
            self.read.append(i)
            return {"x": np.full((2,), i, np.float32), "txt": f"item {i}"}

    whole = list(DataLoader(Items(), 4, shuffle=True, num_workers=1, seed=3))
    for rank in range(2):
        items = Items()
        loader = DataLoader(items, 2, shuffle=True, num_workers=1, seed=3, shard=(rank, 2))
        got = list(loader)
        assert len(loader) == len(got) == len(whole) == 3
        for g, w in zip(got, whole):
            assert np.array_equal(g["x"], w["x"][2 * rank: 2 * rank + 2])
            assert g["txt"] == w["txt"][2 * rank: 2 * rank + 2]
        assert items.read == [int(i) for w in whole for i in w["x"][:, 0]]
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(Items(), 2, drop_last=False, shard=(0, 2))
