"""Novel-view-synthesis training in the port against the JAX package's, on
the CPU in fp32: the tiny NVS bundle of ``tests/test_cli_variants.py`` (its
``NVS_MODEL_YAML``, LoRA rank 2 on the default targets) with the refinement
branch on and an f8 VAE (the refinement residual is at 1/8 of the canvas),
built on both sides from the same YAML (``leftrefill_torch.config`` and the
JAX package's) and loaded with the same seeded flax tree; LoRA factors with
seeded non-zero ups, the same in both.

- the loss and the gradient of every trainable group (prompt table,
  relative-pose MLP, refinement branch and its scale, LoRA down and up)
  against ``jax.grad`` of JAX's ``compute_loss`` over ``wrap_lora_params``
  with the NVS ``cond_builder``: t, the noise and the CFG draws are JAX's
  own (``split(key, 3)``), one row's prompt dropped by them, the VAE noise
  its fixed draw.  Tolerances as ``tests/test_torch_train_grad.py``: the
  loss 1e-5 relative, each group's gradient rel L2 1e-4;
- one AdamW update of the pack from the same gradients equal to optax's
  (1e-6 relative to each leaf's largest value);
- ``lora_predicate`` over the NVS filter selecting JAX's leaves;
- the step drawing t, the noise, then the CFG draws from its generator."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_cli_variants import NVS_MODEL_YAML
from test_torch_parity_utils import FP32_REL, fill_tree, rel_l2, t

from leftrefill_torch.convert.from_jax import lora_from_flax, state_dict_from_flax

GRAD_L2 = 1e-4
ADAM_REL = 1e-6
B, H, W = 2, 32, 64  # batch and canvas (two 32 x 32 views)


def _config() -> dict:
    cfg = yaml.safe_load(NVS_MODEL_YAML)
    p = cfg["model"]["params"]
    p["first_stage_config"]["params"]["ddconfig"]["ch_mult"] = [1, 1, 2, 2]  # f8, as SD2's
    p["refinement_config"]["use_input_refinement"] = True
    return cfg


@pytest.fixture(scope="module")
def setup():
    """(JAX model, task, wrapped params, the port's LoRA-wrapped model and
    task, the batch, JAX's step: its loss, gradients and draws)."""
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
    tokens = np.asarray(bundle.tokenizer.tokenize([" ".join(bundle.special_tokens)] * B))
    assert np.array_equal(tokens, np.asarray(jtask.tokenizer.tokenize([" ".join(bundle.special_tokens)] * B)))
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5), "tokens": tokens,
             "rel_pose": rng.standard_normal((B, 4)).astype(np.float32)}
    return m, jtask, jparams, model, task, batch, _jax_step(m, jtask, jparams, batch, _key_with_one_drop(0.15))


def _key_with_one_drop(rate: float) -> jax.Array:
    """The first PRNGKey(s) whose CFG draws drop one row's prompt and keep the other's."""
    for s in range(100):
        key = jax.random.PRNGKey(s)
        draws = np.asarray(jax.random.uniform(jax.random.split(key, 3)[2], (B,)))
        if (draws < rate).sum() == 1:
            return key
    raise AssertionError("no key drops exactly one row")


def _jax_step(m, jtask, jparams, batch, key):
    """JAX's loss and gradients, and the draws compute_loss takes from ``key``."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian
    from leftrefill_tpu.train.trainer import compute_loss as jloss

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def cond_builder(p, b, c_key):
        return jtask.build_cond(p, b, train=True, cfg_key=c_key)

    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(m, p, jb, key, cond_builder=cond_builder), has_aux=True))(jparams)
    t_key, n_key, c_key = jax.random.split(key, 3)
    z_shape = (B, H // 8, W // 8, 4)
    draws = {"t": np.asarray(jax.random.randint(t_key, (B,), 0, 1000)).astype(np.int64),
             "noise": np.asarray(jax.random.normal(n_key, z_shape, jnp.float32)),
             "cfg_draws": np.asarray(jax.random.uniform(c_key, (B,))),
             "vae_noise": np.asarray(jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), z_shape))}
    return float(loss), grads, draws


def _port_names(grads) -> dict:
    """JAX's gradient pack keyed by the port's parameter names."""
    out = {"model." + k: v for k, v in state_dict_from_flax(
        {r: grads["model"][r] for r in ("unet", "vae", "cond", "refine")}).items()}
    for k, v in lora_from_flax(grads["lora"]).items():
        for f in ("down", "up"):
            out[f"lora.{f}.{k.replace('.', '/')}"] = v[f]
    return out


GROUPS = {"prompt table": "special_embeddings", "relative-pose MLP": "rel_pos_model", "refinement": "refine",
          "LoRA down": "lora.down", "LoRA up": "lora.up"}


def test_nvs_train_step_matches_jax_grad(setup):
    """Readings: loss 1.6e-7 relative; gradients rel L2 2.2e-6 (prompt
    table), 2.0e-6 (relative-pose MLP), 3.1e-6 (refinement), 2.3e-6 (LoRA
    down), 2.7e-6 (LoRA up)."""
    from leftrefill_torch.train import compute_loss, create_train_state, lora_predicate
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    m, jtask, jparams, model, task, batch, (ref_loss, grads, d) = setup
    assert m.cond_model.cfg_rate == 0.15 and (d["cfg_draws"] < 0.15).sum() == 1
    ref = _port_names(grads)
    create_train_state(model, predicate=lora_predicate(nvs_prompt_filter))
    model.zero_grad(set_to_none=True)
    loss, _ = compute_loss(model, batch, t=torch.from_numpy(d["t"]), noise=t(d["noise"]), vae_noise=t(d["vae_noise"]),
                           cond_builder=task.cond_builder, cfg_draws=t(d["cfg_draws"]))
    loss.backward()
    assert abs(float(loss.detach()) - ref_loss) / abs(ref_loss) < FP32_REL
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert {n for n in trainable if any(k in n for k in GROUPS.values())} == set(trainable)
    for group, k in GROUPS.items():
        names = sorted(n for n in trainable if k in n)
        got = np.concatenate([trainable[n].grad.numpy().ravel() for n in names])
        want = np.concatenate([np.asarray(ref[n]).ravel() for n in names])
        assert np.abs(want).max() > 0 and rel_l2(got, want) < GRAD_L2, group
    frozen = [p for p in model.parameters() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)


def test_adamw_update_of_the_pack_matches_optax(setup):
    """From the same gradients (JAX's), one update of every trainable leaf
    with the NVS training YAML's optimizer (AdamW 1e-4, weight decay 0.01)."""
    from leftrefill_tpu.train.checkpoints import nvs_prompt_filter as jfilter
    from leftrefill_tpu.train.trainer import (OptimizerConfig as JConfig, create_train_state as jstate,
                                              lora_predicate as jpred)

    from leftrefill_torch.train import OptimizerConfig, create_train_state, lora_predicate
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    m, jtask, jparams, model, task, batch, (_, grads, _) = setup
    state, tx = jstate(jparams, JConfig(lr=1e-4, weight_decay=0.01), jpred(jfilter))
    updates, _ = jax.jit(tx.update)(grads, state.opt_state, jparams)
    new = _port_names(jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates))
    ours = copy.deepcopy(model)
    _, opt = create_train_state(ours, OptimizerConfig(lr=1e-4, weight_decay=0.01),
                                lora_predicate(nvs_prompt_filter))
    ref_grads = _port_names(grads)
    for n, p in ours.named_parameters():
        p.grad = torch.as_tensor(np.asarray(ref_grads[n])).clone() if p.requires_grad else None
    assert opt.step()
    before = dict(model.named_parameters())
    for n, p in ours.named_parameters():
        want = np.asarray(new[n])
        assert np.abs(p.detach().numpy() - want).max() <= ADAM_REL * max(np.abs(want).max(), 1e-30), n
        assert torch.equal(p, before[n]) != p.requires_grad, n  # the trainable leaves moved, no other


def test_lora_predicate_selects_jaxs_leaves(setup):
    from leftrefill_tpu.train.checkpoints import nvs_prompt_filter as jfilter
    from leftrefill_tpu.train.trainer import lora_predicate as jpred, trainable_mask as jmask

    from leftrefill_torch.train.checkpoints import nvs_prompt_filter
    from leftrefill_torch.train.trainer import lora_predicate, trainable_mask

    m, jtask, jparams, model, task, batch, _ = setup
    mask = _port_names(jax.tree_util.tree_map(lambda b, p: np.full(np.shape(p), float(b), np.float32),
                                              jmask(jparams, jpred(jfilter)), jparams))
    ours = trainable_mask(model, lora_predicate(nvs_prompt_filter))
    assert ours.keys() == mask.keys()
    assert {n for n, v in ours.items() if v} == {n for n, v in mask.items() if v.flatten()[0]}
    assert sum(ours.values()) > 2 * len(model.lora.down)


def test_step_draws_t_noise_then_cfg(setup, monkeypatch):
    """``make_train_step`` draws t, then the noise, then the CFG draws from
    its generator: the same step with the three injected, drawn in that
    order from the same seed, gives the same loss; the factors train and the
    base UNet weights stay as they were."""
    from leftrefill_torch.train import OptimizerConfig, compute_loss, create_train_state, lora_predicate, \
        make_train_step
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter

    _, _, _, model, task, batch, _ = setup
    ours = copy.deepcopy(model)
    state, tx = create_train_state(ours, OptimizerConfig(lr=1e-3), lora_predicate(nvs_prompt_filter))
    gen = torch.Generator().manual_seed(5)
    tt = torch.randint(0, 1000, (B,), generator=gen)
    noise = torch.randn((B, H // 8, W // 8, 4), generator=gen)
    draws = torch.rand((B,), generator=gen)
    with torch.no_grad():
        want, _ = compute_loss(ours, batch, t=tt, noise=noise, cond_builder=task.cond_builder, cfg_draws=draws)
    unet_before = {k: v.clone() for k, v in ours.model.unet.state_dict().items()}
    up_before = {k: v.detach().clone() for k, v in ours.lora.up.items()}
    state, metrics = make_train_step(ours, tx, cond_builder=task.cond_builder)(state, batch,
                                                                              torch.Generator().manual_seed(5))
    assert state.step == 1 and float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
    assert all(torch.equal(v, unet_before[k]) for k, v in ours.model.unet.state_dict().items())
    assert all(not torch.equal(p, up_before[k]) for k, p in ours.lora.up.items())
