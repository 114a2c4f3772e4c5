"""The port's training layer on the CPU: the K2/K3 autograd wrappers, remat,
the loss, the optimizer, EMA, checkpoints, logging and the multi-view batch
layout, each against the JAX package where it has a counterpart.

Tolerances: fp32 loss and loss maps 1e-5 relative (the same fp32 math;
summation orders differ); the optimizer's table 1e-6 relative after each
micro-step (AdamW's fp32 moments in two frameworks); bf16 gradients of the
kernel wrappers against JAX's VJPs 2e-2 * max|ref| (test_torch_parity_utils:
each side rounds its bf16 products at other points; readings in the tests'
docstrings)."""

import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import BF16_REL, FP32_REL, TINY_CLIP, TINY_UNET, TINY_VAE, rel_err

from leftrefill_torch import kernels
from leftrefill_torch.ops import conv as tconv
from leftrefill_torch.ops import mlp as tmlp


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)


def _raw_kernel(plain, calls):
    """A stand-in for a raw-pointer kernel: the plain result with no
    ``grad_fn``, as a kernel that fills ``torch.empty`` returns it."""

    def run(*args):
        calls.append(1)
        with torch.no_grad():
            return plain(*args)

    return run


# ---------------------------------------------------------------------------
# Part 0: gradients through the K2 and K3 sites where the kernels launch


@pytest.mark.parametrize("train_weight", [False, True])
def test_conv_kernel_site_passes_gradients(monkeypatch, train_weight):
    """``conv3x3_apply`` on the kernel route (CUDA stood in for by the
    patched ``uses_kernel``, the kernel by its no-grad plain result): the
    gradient to x equals autograd's through the plain version, and a frozen
    weight gets no weight gradient computed.  Readings: 7.6e-4 (dx) and
    6.5e-4 (dw) of max|ref| (the backward convolves in bf16, the plain
    version in fp32)."""
    monkeypatch.setattr(kernels, "uses_kernel", lambda t: True)
    calls, wgrads = [], []
    monkeypatch.setattr(tconv, "conv3x3_op", _raw_kernel(tconv.conv3x3_plain, calls))
    conv2d_weight = torch.nn.grad.conv2d_weight
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", lambda *a, **k: wgrads.append(1) or conv2d_weight(*a, **k))
    rng = np.random.RandomState(1)
    x = _bf16(rng, 2, 16, 16, 64).requires_grad_()
    weight = _bf16(rng, 96, 64, 3, 3, scale=(9 * 64) ** -0.5).requires_grad_(train_weight)
    bias = torch.from_numpy(rng.standard_normal(96).astype(np.float32) * 0.1)
    g = _bf16(rng, 2, 16, 16, 96)
    y = tconv.conv3x3_apply(x, weight, bias)
    assert calls == [1] and y.dtype == torch.bfloat16
    inputs = (x, weight) if train_weight else (x,)
    got = torch.autograd.grad(y, inputs, g)
    with kernels.plain_kernels(["conv3x3"]):
        want = torch.autograd.grad(tconv.conv3x3_apply(x, weight, bias), inputs, g)
    assert wgrads == ([1] if train_weight else [])
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert rel_err(a.float().numpy(), b.float().numpy()) < BF16_REL


def test_geglu_kernel_site_passes_gradients(monkeypatch):
    """The UNet's GEGLU site on the kernel route (as above): the gradient to
    x is autograd's through ``geglu_vjp_math`` (JAX's VJP function, bf16
    products), bit for bit, since the backward recomputes it; it is within
    BF16_REL of the gradient through the plain version (fp32 products), and
    the frozen weights get none."""
    from leftrefill_torch.models.unet import GEGLUFeedForward
    from leftrefill_torch.pipeline import fill_random_

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: True)
    calls = []
    monkeypatch.setattr(tmlp, "geglu_fused", _raw_kernel(tmlp.geglu_plain, calls))
    ff = GEGLUFeedForward(64, dtype=torch.bfloat16)
    fill_random_(ff, torch.Generator().manual_seed(2))
    ff.requires_grad_(False)
    rng = np.random.RandomState(2)
    x = _bf16(rng, 2, 64, 64).requires_grad_()
    g = _bf16(rng, 2, 64, 64)
    (got,) = torch.autograd.grad(ff(x), x, g)
    assert calls == [1]
    with kernels.plain_kernels(["geglu"]):
        (plain,) = torch.autograd.grad(ff(x), x, g)
        monkeypatch.setattr(tmlp, "geglu_plain", tmlp.geglu_vjp_math)
        (want,) = torch.autograd.grad(ff(x), x, g)
    assert torch.equal(got, want)
    assert rel_err(got.float().numpy(), plain.float().numpy()) < BF16_REL
    assert all(p.grad is None for p in ff.parameters())


def test_conv_wrapper_backward_matches_jax_vjp():
    """The K2 wrapper's gradients to x and the weight against ``jax.vjp`` of
    JAX's ``conv3x3_op`` (Pallas forward in interpret mode, XLA-conv VJP in
    bf16): readings 3.7e-3 and 1.2e-3 of max|ref|, both sides 3.1e-3 and
    2.4e-3 from the fp32 VJP.  The bias gradient is the fp32 sum of the
    output gradient, exactly; JAX's sums in bf16 and is 6.2e-2 of max|ref|
    from that sum, so it is held to the exact sum instead (the bias is
    frozen in prompt tuning)."""
    from leftrefill_tpu.ops.conv import conv3x3_op

    rng = np.random.RandomState(3)
    x, w = _bf16(rng, 2, 16, 16, 128), _bf16(rng, 128, 3, 3, 128, scale=(9 * 128) ** -0.5)  # OHWI
    bias = torch.from_numpy(rng.standard_normal(128).astype(np.float32) * 0.1)
    g = _bf16(rng, 2, 16, 16, 128)
    xt, wt, bt = (a.clone().requires_grad_() for a in (x, w, bias))
    got = torch.autograd.grad(tconv._Conv3x3.apply(xt, wt, bt), (xt, wt, bt), g)
    jx = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(conv3x3_op, jx(x), jx(w.permute(1, 2, 3, 0)), jnp.asarray(bias.numpy()))
        dx, dw, db = vjp(jx(g))
    want = (dx, np.asarray(dw, np.float32).transpose(3, 0, 1, 2))
    for a, b in zip(got, want):
        assert rel_err(a.float().numpy(), np.asarray(b, np.float32)) < BF16_REL
    assert torch.equal(got[2], g.float().sum(dim=(0, 1, 2)))
    assert rel_err(np.asarray(db), got[2].numpy()) < 0.1  # JAX's bf16 sum


def test_geglu_wrapper_backward_matches_jax_vjp():
    """The K3 wrapper's gradients (x, both weights, both biases) against
    ``jax.vjp`` of JAX's ``geglu_fused`` (Pallas forward in interpret mode,
    VJP through ``_geglu_xla_math``; the port's differentiates its copy,
    ``geglu_vjp_math``: bf16 products on both sides).  Readings: 5.8e-3 to
    8.4e-3 of max|ref| (XLA's CPU bf16 products round at other points)."""
    from leftrefill_tpu.ops.mlp import geglu_fused

    rng = np.random.RandomState(4)
    r, din, inner, dout = 128, 64, 256, 64
    x, w1, w2 = _bf16(rng, r, din), _bf16(rng, 2 * inner, din, scale=din**-0.5), _bf16(rng, dout, inner, scale=inner**-0.5)
    b1, b2 = (torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1) for n in (2 * inner, dout))
    g = _bf16(rng, r, dout)
    args = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2)]
    got = torch.autograd.grad(tmlp._GEGLU.apply(*args), args, g)
    jx = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(geglu_fused, jx(x), jx(w1.t()), jnp.asarray(b1.numpy()), jx(w2.t()), jnp.asarray(b2.numpy()))
        dx, dw1, db1, dw2, db2 = vjp(jx(g))
    want = (dx, np.asarray(dw1, np.float32).T, db1, np.asarray(dw2, np.float32).T, db2)
    for a, b in zip(got, want):
        assert rel_err(a.float().numpy(), np.asarray(b, np.float32)) < BF16_REL


# ---------------------------------------------------------------------------
# remat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_remat_same_outputs_and_gradients(dtype):
    """``UNetModel(remat=True)``: the same output and the same gradients to x
    and to the context as without remat, bit for bit (the recomputed
    forward is the same computation); without autograd no checkpoint runs."""
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.pipeline import fill_random_

    tdt = getattr(torch, dtype)
    nets = [UNetModel(**TINY_UNET, dtype=tdt, remat=r) for r in (False, True)]
    for net in nets:
        fill_random_(net, torch.Generator().manual_seed(5))
        net.requires_grad_(False)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16, 9)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 24)).astype(np.float32))
    ts = torch.tensor([10, 700])
    g = torch.from_numpy(rng.standard_normal((2, 8, 16, 4)).astype(np.float32)).to(tdt)
    outs, grads = [], []
    for net in nets:
        xi, ci = x.clone().requires_grad_(), ctx.clone().requires_grad_()
        out = net(xi, ts, ci)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (xi, ci), g))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(nets[1](x, ts, ctx), outs[0])


# ---------------------------------------------------------------------------
# the loss


def _stub_models(parameterization: str):
    """JAX's and the port's ``LeftRefillModel`` with a stand-in UNet output
    (0.5 x_noisy + c, the same on both sides), so the loss math is held
    apart from the UNet, which the gradient tests cover.  Each side's
    schedule carries the parameterization (JAX's model field is set from the
    same key, as its ``config.py`` sets both)."""
    from leftrefill_tpu.diffusion.core import LeftRefillModel as JM
    from leftrefill_tpu.diffusion.schedules import DiffusionSchedule

    from leftrefill_torch.diffusion.core import LeftRefillModel as TM
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule as TSchedule
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.unet import UNetModel

    @dataclasses.dataclass(frozen=True)
    class JStub(JM):
        def apply_model(self, params, x_noisy, t, cond, **kwargs):
            return 0.5 * x_noisy + cond.c_concat[..., :4]

    class TStub(TM):
        def apply_model(self, x_noisy, t, cond, **kwargs):
            return 0.5 * x_noisy + cond.c_concat[..., :4]

    sd2 = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120,
               parameterization=parameterization)
    jm = JStub(unet=None, vae=None, cond_model=None, schedule=DiffusionSchedule.create(**sd2),
               parameterization=parameterization)
    with torch.device("meta"):
        tm = TStub(UNetModel(**TINY_UNET), AutoencoderKL(DDConfig(**TINY_VAE), embed_dim=4),
                   PromptCLIPEmbedder(**TINY_CLIP), TSchedule.create(**sd2))
    return jm, tm


@pytest.mark.parametrize("parameterization", ["eps", "v", "x0"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_matches_jax(parameterization, loss_type):
    """``p_losses`` (q_sample, the eps/v/x0 targets, l1/l2, the lvlb weights
    with a non-zero ``original_elbo_weight``) and its ``per_element`` map
    against JAX's on the same z, conditioning, t and noise (fp32)."""
    from leftrefill_tpu.diffusion.core import Conditioning as JC

    from leftrefill_torch.diffusion.core import Conditioning as TC

    jm, tm = _stub_models(parameterization)
    rng = np.random.RandomState(6)
    z, noise = (rng.standard_normal((3, 8, 16, 4)).astype(np.float32) for _ in range(2))
    c_concat = rng.standard_normal((3, 8, 16, 5)).astype(np.float32)
    t = np.array([0, 450, 999], np.int32)
    kw = dict(loss_type=loss_type, l_simple_weight=0.7, original_elbo_weight=0.3)
    ref_loss, ref_metrics = jm.p_losses(None, jnp.asarray(z), JC(c_concat=jnp.asarray(c_concat)), jnp.asarray(t),
                                        jnp.asarray(noise), **kw)
    ref_map = jm.p_losses(None, jnp.asarray(z), JC(c_concat=jnp.asarray(c_concat)), jnp.asarray(t),
                          jnp.asarray(noise), loss_type=loss_type, per_element=True)
    tz, tn, tt = torch.from_numpy(z), torch.from_numpy(noise), torch.from_numpy(t.astype(np.int64))
    loss, metrics = tm.p_losses(tz, TC(c_concat=torch.from_numpy(c_concat)), tt, tn, **kw)
    err_map = tm.p_losses(tz, TC(c_concat=torch.from_numpy(c_concat)), tt, tn, loss_type=loss_type, per_element=True)
    assert abs(float(loss) - float(ref_loss)) <= FP32_REL * abs(float(ref_loss))
    for k in ("loss_simple", "loss_vlb", "loss"):
        assert abs(float(metrics[k]) - float(ref_metrics[k])) <= FP32_REL * abs(float(ref_metrics[k])), k
    assert rel_err(err_map.numpy(), np.asarray(ref_map)) < FP32_REL


def test_parameterization_helpers_match_jax():
    """``get_v``, ``predict_eps_from_z_and_v`` and
    ``predict_start_from_z_and_v`` against JAX's (fp32)."""
    jm, tm = _stub_models("v")
    rng = np.random.RandomState(7)
    x, v = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([3, 800])
    tx, tv, tt = torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(t)
    pairs = ((tm.get_v(tx, tv, tt), jm.get_v(x, v, t)),
             (tm.predict_eps_from_z_and_v(tx, tt, tv), jm.predict_eps_from_z_and_v(x, t, v)),
             (tm.predict_start_from_z_and_v(tx, tt, tv), jm.predict_start_from_z_and_v(x, t, v)))
    for got, want in pairs:
        assert rel_err(got.numpy(), np.asarray(want)) < FP32_REL


# ---------------------------------------------------------------------------
# the optimizer


def _table_module(rows: int = 4, width: int = 8):
    """The prompt table and one frozen tensor under the checkpoint names."""
    from torch import nn

    m = nn.Module()
    m.cond_stage_model = nn.Module()
    m.cond_stage_model.special_embeddings = nn.Embedding(rows, width)
    m.cond_stage_model.model = nn.Module()
    m.cond_stage_model.model.token_embedding = nn.Embedding(6, width)
    return m


@pytest.mark.parametrize("use_cosine,accumulate", [(True, 2), (False, 1)])
def test_optimizer_updates_match_optax(use_cosine, accumulate):
    """Three optimizer updates on the same gradients as optax's masked adamw
    (with the cosine schedule at alpha 0.2 and 2-step ``MultiSteps``
    accumulation, and without either): the table after every micro-step
    (1e-6 relative) and ``current_lr`` at every step equal JAX's; the frozen
    tensor never moves.  Readings: 9.9e-8 (cosine, accumulated) and 3.0e-7
    relative."""
    from leftrefill_tpu.train import trainer as jt

    from leftrefill_torch.train import trainer as tt

    kw = dict(lr=1e-2, weight_decay=0.1, use_cosine=use_cosine, cosine_decay_steps=4, cosine_alpha=0.2,
              accumulate_grad_batches=accumulate)
    rng = np.random.RandomState(8)
    table0 = rng.standard_normal((4, 8)).astype(np.float32)
    frozen0 = rng.standard_normal((6, 8)).astype(np.float32)
    params = {"cond": {"special_embeddings": jnp.asarray(table0), "token_embedding": jnp.asarray(frozen0)}}
    state, tx = jt.create_train_state(params, jt.OptimizerConfig(**kw))
    m = _table_module()
    with torch.no_grad():
        m.cond_stage_model.special_embeddings.weight.copy_(torch.from_numpy(table0))
        m.cond_stage_model.model.token_embedding.weight.copy_(torch.from_numpy(frozen0))
    _, ttx = tt.create_train_state(m, tt.OptimizerConfig(**kw))
    table = m.cond_stage_model.special_embeddings.weight
    assert not m.cond_stage_model.model.token_embedding.weight.requires_grad
    p, opt_state = params, state.opt_state
    for step in range(3 * accumulate):
        g = rng.standard_normal((4, 8)).astype(np.float32)
        grads = {"cond": {"special_embeddings": jnp.asarray(g), "token_embedding": jnp.ones((6, 8))}}
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        (table * torch.from_numpy(g)).sum().backward()  # adds g to the table's .grad
        assert ttx.step() == ((step + 1) % accumulate == 0)
        want = np.asarray(p["cond"]["special_embeddings"])
        assert rel_err(table.detach().numpy(), want) < 1e-6, step
        assert tt.current_lr(tt.OptimizerConfig(**kw), step) == pytest.approx(
            jt.current_lr(jt.OptimizerConfig(**kw), step), rel=1e-6)
    assert not np.array_equal(table.detach().numpy(), table0)
    assert np.array_equal(m.cond_stage_model.model.token_embedding.weight.detach().numpy(), frozen0)


def test_create_train_state_refuses_int8_and_freezes_the_rest():
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.pipeline import sd2_schedule
    from leftrefill_torch.train import create_train_state

    def bundle(quant):
        return LeftRefillModel(UNetModel(**TINY_UNET, quant=quant), AutoencoderKL(DDConfig(**TINY_VAE), embed_dim=4),
                               PromptCLIPEmbedder(**TINY_CLIP), sd2_schedule())

    with pytest.raises(ValueError, match="int8"):
        create_train_state(bundle(True))
    model = bundle(False)
    state, tx = create_train_state(model)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert trainable == ["cond_stage_model.special_embeddings.weight"] and state.step == 0
    assert tx.params == [model.cond_stage_model.special_embeddings.weight]


# ---------------------------------------------------------------------------
# the prompt table's first values


def test_init_special_embeddings_matches_jax():
    """Both arms (the mean embedding of each token's init sentence or of its
    own name; token-wise from the first sentence) equal JAX's, and
    ``init_prompt_table`` writes them into the embedder (not for
    "<random>")."""
    from leftrefill_tpu.models import clip as jc
    from leftrefill_tpu.models import tokenizer as jtok

    from leftrefill_torch.models import clip as tc
    from leftrefill_torch.models import tokenizer as ttok

    specials, init = ["repeat_4_<special-token>"], ["two views of one scene"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sp, init_full = ttok.expand_special_tokens(specials, init)
        ours, ref = ttok.SimpleTokenizer(special_tokens=sp), jtok.SimpleTokenizer(special_tokens=sp)
    table = np.random.RandomState(9).standard_normal((49408, 24)).astype(np.float32)
    sentences = ["a photo of", "left view", "right", "the scene"]
    for text, tokenwise in ((init_full, False), (None, False), (sentences, True)):
        got = tc.init_special_embeddings(ours, sp, table, text, tokenwise)
        want = jc.init_special_embeddings(ref, sp, table, text, tokenwise)
        assert got.dtype == np.float32 and np.array_equal(got, want), (text, tokenwise)
    emb = tc.PromptCLIPEmbedder(**TINY_CLIP)
    with torch.no_grad():
        emb.model.token_embedding.weight.copy_(torch.from_numpy(table))
    before = emb.special_embeddings.weight.detach().clone()
    tc.init_prompt_table(emb, ours, sp, ["<random>"])
    assert torch.equal(emb.special_embeddings.weight, before)
    tc.init_prompt_table(emb, ours, sp, init_full)
    assert emb.special_embeddings.weight.dtype == torch.float32
    assert np.array_equal(emb.special_embeddings.weight.detach().numpy(),
                          jc.init_special_embeddings(ref, sp, table, init_full))


# ---------------------------------------------------------------------------
# EMA, checkpoints, logging, multi-view batches


def test_ema_matches_jax():
    """Three EMA steps with the warm-up decay equal JAX's ``update_ema``."""
    from leftrefill_tpu.train import ema as je

    from leftrefill_torch.train import ema as te

    rng = np.random.RandomState(10)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    js, ts = je.init_ema({k: jnp.asarray(v) for k, v in p0.items()}, decay=0.99), \
        te.init_ema({k: torch.from_numpy(v) for k, v in p0.items()}, decay=0.99)
    for _ in range(3):
        p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        js = je.update_ema(js, {k: jnp.asarray(v) for k, v in p.items()})
        ts = te.update_ema(ts, {k: torch.from_numpy(v) for k, v in p.items()})
        assert ts.num_updates == int(js.num_updates)
        for k in p0:
            np.testing.assert_allclose(ts.ema_params[k].numpy(), np.asarray(js.ema_params[k]), rtol=1e-6, atol=1e-7)
    assert ts.swap(p0)[0] is ts.ema_params


def test_checkpoint_manager_matches_jax_and_round_trips_the_prompt(tmp_path):
    """The same save sequence gives JAX's manifest (``last`` and the top 2 by
    val/lpips) and prunes the dropped checkpoint; a prompt-only checkpoint
    holds the table alone and ``restore_over_base`` loads it over a fresh
    model, reporting every other name as missing."""
    from leftrefill_tpu.train import checkpoints as jck

    from leftrefill_torch.train import checkpoints as tck

    m = _table_module()
    jtree = {"cond": {"special_embeddings": np.ones((4, 8), np.float32)}}
    mans = {"jax": jck.CheckpointManager(str(tmp_path / "jax"), top_k=2),
            "port": tck.CheckpointManager(str(tmp_path / "port"), top_k=2)}
    for step, lpips in ((1, 0.5), (2, 0.3), (3, 0.4)):
        jck.save_pruned(mans["jax"], step, jtree, True, {"val/lpips": lpips})
        tck.save_pruned(mans["port"], step, m, True, {"val/lpips": lpips})
    tck.save_pruned(mans["port"], 4, m, True, {"val/psnr": 20.0})
    jck.save_pruned(mans["jax"], 4, jtree, True, {"val/psnr": 20.0})
    read = lambda d: json.load(open(tmp_path / d / "manifest.json"))  # noqa: E731
    assert read("port") == read("jax") == mans["port"].manifest
    assert mans["port"].best_name() == "step_2"
    assert sorted(os.listdir(tmp_path / "port")) == ["last.pt", "manifest.json", "step_2.pt", "step_3.pt"]

    saved = mans["port"].restore("last")
    assert list(saved) == ["cond_stage_model.special_embeddings.weight"]
    fresh = _table_module()
    _, missing, unexpected = tck.restore_over_base(fresh, {**saved, "extra.weight": torch.zeros(1)})
    assert torch.equal(fresh.cond_stage_model.special_embeddings.weight, m.cond_stage_model.special_embeddings.weight)
    assert missing == ["cond_stage_model.model.token_embedding.weight"] and unexpected == ["extra.weight"]
    _, missing, _ = tck.restore_over_base(fresh, {"cond_stage_model.special_embeddings.weight": torch.zeros(2, 8)})
    assert missing[0].startswith("cond_stage_model.special_embeddings.weight (shape (2, 8) != (4, 8))")
    assert tck.nvs_prompt_filter(("unet", "lora", "up")) and not tck.prompt_only_filter(("unet", "lora", "up"))


def test_metric_and_drift_loggers(tmp_path):
    """``TokenDriftLogger`` equals JAX's; ``MetricLogger`` writes one JSON
    line a call with tensors as floats."""
    from leftrefill_tpu.train import logger as jl

    from leftrefill_torch.train import logger as tl

    rng = np.random.RandomState(11)
    t0, t1 = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    got = tl.TokenDriftLogger(torch.from_numpy(t0)).drift(torch.from_numpy(t1))
    want = jl.TokenDriftLogger(t0).drift(t1)
    assert got.keys() == want.keys() and all(got[k] == pytest.approx(want[k], rel=1e-6) for k in want)
    log = tl.MetricLogger(str(tmp_path), echo_every=100)
    log.log(3, {"loss": torch.tensor(0.25), "lr": 3e-5})
    rec = json.loads(open(log.path).read())
    assert rec["step"] == 3 and rec["loss"] == 0.25 and rec["lr"] == 3e-5
    timer = tl.StepTimer()
    timer.start(0)
    timer.stop(0)
    assert timer.mean_step_s() >= 0 and np.isnan(timer.mean_step_s())


def test_flatten_views_matches_jax():
    """A multi-view batch (B, V, ...) -> (B*V, ...), tokens included, other
    entries kept, as JAX's ``flatten_views``."""
    from leftrefill_tpu.data.loader import flatten_views as jflat

    from leftrefill_torch.data import flatten_views

    rng = np.random.RandomState(12)
    batch = {"image": rng.standard_normal((2, 3, 4, 4, 3)), "tokens": rng.randint(0, 9, (2, 3, 77)),
             "mask": rng.standard_normal((2, 3, 4, 4, 1)), "txt": ["a", "b"], "idx": np.arange(2)}
    got, want = flatten_views(batch), jflat(batch)
    assert got.keys() == want.keys()
    for k in batch:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert got["tokens"].shape == (6, 77)
    assert flatten_views({"image": torch.zeros(2, 3, 4, 4, 3)})["image"].shape == (6, 4, 4, 3)
