"""The port's tiny int8 UNet forward against the JAX package's, as a whole:
model_channels 128, channel_mult (1, 2), one res block, transformers at ds 1
and 2 (head channels 32, context 96), a CFG-batch-2 16x32 latent with the
cross-attention K/V cache and cfg_dup on.  JAX runs its unfused int8
configuration (``LEFTREFILL_FUSED_RES=0 LEFTREFILL_FUSED_LNQ=0``) with the
TPU dispatch forced and the Pallas kernels in interpret mode: in bf16 it
reaches all four kernels the port replaces (K5 7 times, K6 10, K9 7, K10 7).
The parameters come from numpy (``fill_tree`` on the ``eval_shape`` tree,
then ``quantize_params_like``); no ``init`` is run.  In a file of its own:
the interpreted JAX forward takes most of a minute.

Two comparisons.  Block by block, teacher-forced (each of the port's 18
top-level blocks is fed JAX's input to it, so its error is its own), and
beside it the control: the same blocks with the port's int8 activations off
(``int8_activations_off``: unquantized activations against dequantized
weights).  Per-block rel L2 separates the two where one int8 step is larger
than the rounding around it:
- bf16, the SpatialTransformer blocks: bound 3e-3, measured at most 8.4e-4,
  control at least 7.2e-3 (a test holds the control above the bound).  The
  bf16 ResBlocks do not separate: a bf16 ulp of a pre-quantization value is
  up to half an int8 step, so sound (5e-3..1.1e-2) and control
  (6e-3..1.3e-2) overlap; the fp32 twin holds them instead.
- fp32, the ResBlocks and the Upsample conv: bound 1e-3, measured at most
  1.3e-4, control at least 5.4e-3.
The max-abs check over all blocks stays beside it: bf16 2e-2 * max|ref|
(test_torch_parity_utils.BF16_REL; measured at most 1.1e-2), fp32 1e-2
(measured at most 7.1e-3: a per-row int8 step inside a transformer).

Free-running, end to end: rel L2 6e-2.  There each side's one-ulp
differences (bf16, or fp32 in the fp32 twin) move a few int8 values one
step, a moved step is ~1/127 of its site's range, and the next quantized
stage turns that into more moved steps, so the two forwards drift apart
until they differ by about the int8 noise itself: measured 4.8e-2 (bf16)
and 3.9e-2 (fp32), against 4.9e-2 between JAX's own int8 and bf16 forwards
of these weights, and the 0.08 JAX's test allows between its fused and
unfused int8 arms for the same reason (tests/test_quant.py).  This bound
cannot tell a sound int8 arm from the control: the port's free-running bf16
forward under ``int8_activations_off`` is 4.1e-2 from JAX's, inside it.  It
checks the output's scale; the block-wise bounds check parity.
"""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import BF16_REL, fill_tree, int8_activations_off, rel_err, rel_l2

import leftrefill_tpu.ops.conv as jconv
import leftrefill_tpu.ops.mlp as jmlp
import leftrefill_tpu.ops.quant as jq
from leftrefill_torch import kernels
from leftrefill_torch.convert.from_jax import _unet_module, state_dict_from_flax
from leftrefill_torch.ops import quant as tq

CFG = dict(in_channels=9, model_channels=128, out_channels=4, num_res_blocks=1,
           attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=32, context_dim=96)
JAX_KERNELS = ("conv3x3_int8_copy3_pre", "conv3x3_int8_single_pre", "dense_int8_res_mom", "geglu_fused_int8",
               "affine_silu_quant", "ln_quant_rowwise", "gn_quant_rowwise")


def run_tiny_int8_unets(monkeypatch, dtype: str, fused: bool = False, views: int = 0):
    """The same int8 weights and inputs through JAX (TPU dispatch, interpret
    mode) and the port, both computing in ``dtype``, in the unfused
    configuration (both fusion flags 0, the port's ``fused=False``) or with
    ``fused`` in JAX's default one (both flags on, the port's default).
    With ``views`` the UNets are the multi-view ones and the batch is one
    scene of that many views (no cfg_dup, as in multi-view sampling).
    Returns the port's and JAX's outputs, JAX's kernel calls (and their
    first operand's shapes), the port's kernel sites, and each top-level
    block's class, its teacher-forced error (max-abs relative and rel L2),
    and its rel L2 with the int8 activations off (the control).  With
    ``fused`` the teacher-forced blocks take the GroupNorm statistics and
    fold from JAX (see below); ``own_*`` are the same blocks with the port's
    own."""
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.multiview import MultiViewUnetModel as TMV
    from leftrefill_torch.models.unet import UNetModel as TU

    monkeypatch.setattr(jconv, "on_tpu", lambda: True)
    monkeypatch.setenv("LEFTREFILL_FUSED_RES", "1" if fused else "0")
    monkeypatch.setenv("LEFTREFILL_FUSED_LNQ", "1" if fused else "0")
    calls, shapes = Counter(), Counter()
    for name in JAX_KERNELS:
        mod = jmlp if name == "geglu_fused_int8" else jq

        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] += 1
            shapes[_n, a[0].shape] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    rng = np.random.RandomState(31)
    x = np.repeat(rng.standard_normal((1, 16, 32, 9)).astype(np.float32), 2, axis=0)  # CFG layout
    if views:  # one scene: views that differ
        x = np.concatenate([x[:1], rng.standard_normal((views - 1, 16, 32, 9)).astype(np.float32)])
    ts = np.array([412, 412])
    ctx = rng.standard_normal((2, 77, 96)).astype(np.float32)  # [uncond; cond] differ
    tdt = getattr(torch, dtype)
    xt, ct = torch.from_numpy(x).to(tdt), torch.from_numpy(ctx).to(tdt)
    xj, cj = (jnp.asarray(a.to(torch.float32).numpy()).astype(dtype) for a in (xt, ct))
    args = (xj, jnp.asarray(ts, jnp.int32), cj)

    fp = fill_tree(jax.eval_shape(JU(**CFG).init, jax.random.PRNGKey(0), *args)["params"], 32)
    jcls = functools.partial(JMV, view_num=views) if views else JU
    ju = jcls(**CFG, dtype=getattr(jnp, dtype), quant=True)
    qstruct = jax.eval_shape(ju.init, jax.random.PRNGKey(0), *args)["params"]
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(qstruct, fp))
    calls.clear()  # the fused prenorms also run while eval_shape traces init
    shapes.clear()
    cfg_dup = not views
    with pltpu.force_tpu_interpret_mode():
        kv = ju.apply({"params": qtree}, cj, method="cross_kv")
        ref, state = ju.apply({"params": qtree}, *args, cross_kv=kv, cfg_dup=cfg_dup,
                              capture_intermediates=True, mutable=["intermediates"])
    ref = np.asarray(ref, np.float32)
    block_refs = {name: np.array(v["__call__"][0], np.float32) for name, v in state["intermediates"].items()
                  if name.startswith(("input_blocks", "middle_block", "output_blocks"))}

    sd = state_dict_from_flax({"unet": qtree})
    tcls = functools.partial(TMV, view_num=views) if views else TU
    tu = tcls(**CFG, dtype=tdt, quant=True, fused=fused)
    tu.load_state_dict({k[len("model.diffusion_model."):]: v for k, v in sd.items()}, strict=True)
    fwd = lambda: tu(xt, torch.from_numpy(ts), ct, cross_kv=kv_t, cfg_dup=cfg_dup)
    with torch.no_grad(), kernels.record_sites() as sites:
        kv_t = tu.eval().cross_kv(ct)
        out = fwd()
    if cfg_dup:
        with torch.no_grad():  # the shared CFG prefix is exact in int8 too
            assert torch.equal(out, tu(xt, torch.from_numpy(ts), ct, cross_kv=kv_t, cfg_dup=False))
    assert out.shape == (x.shape[0], 16, 32, 4) and out.dtype == tdt
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1

    # teacher forcing: every block of the port gets JAX's input to it (each
    # block's output is replaced by JAX's), so each block's error is its own
    def forced_block_errors():
        errs, hooks = {}, []
        for key, want in block_refs.items():
            def hook(mod, inputs, output, key=key, want=want):
                got = output.float().numpy()
                errs[key] = (rel_err(got, want), rel_l2(got, want))
                return torch.from_numpy(want).to(output.dtype)

            hooks.append(tu.get_submodule(_unet_module(key)).register_forward_hook(hook))
        with torch.no_grad():
            fwd()
        for h in hooks:
            h.remove()
        assert errs.keys() == block_refs.keys() and len(errs) == 18
        return errs

    own = {}
    if fused:
        own = forced_block_errors()
        # the fused prologues quantize fp32 GroupNorm output, where a
        # last-bit difference in the fold (a, bb) moves int8 steps that the
        # unfused arm's bf16 GroupNorm would absorb; the block comparison
        # takes the statistics from JAX too (test_torch_quant_prologues.py
        # holds the port's own to JAX's), the free-running output above not
        monkeypatch.setattr(tq, "gn_moments", jax_gn_moments)
        monkeypatch.setattr(tq, "gn_affine_ab", jax_gn_affine_ab)
    errs = forced_block_errors()
    with int8_activations_off():
        control = forced_block_errors()
    return dict(out=out.float().numpy(), ref=ref, calls=calls, shapes=shapes, sites=Counter(n for n, _ in sites),
                site_shapes=Counter(sites),
                kinds={k: type(tu.get_submodule(_unet_module(k))).__name__ for k in block_refs},
                block_errs={k: e[0] for k, e in errs.items()}, block_l2={k: e[1] for k, e in errs.items()},
                own_block_errs={k: e[0] for k, e in own.items()}, own_block_l2={k: e[1] for k, e in own.items()},
                control_l2={k: e[1] for k, e in control.items()},
                block_norm={k: float(np.linalg.norm(v)) for k, v in block_refs.items()})


def jax_gn_moments(x: torch.Tensor):
    """JAX's per-channel moments (quant.py:916-918) of a port tensor."""
    xf = jnp.asarray(x.float().numpy())
    return (torch.from_numpy(np.array(jnp.mean(xf, axis=(1, 2)))),
            torch.from_numpy(np.array(jnp.mean(xf * xf, axis=(1, 2)))))


def jax_gn_affine_ab(m_c, q_c, gamma, beta, num_groups, eps, emb=None, scale_shift=None):
    """JAX's ``_gn_affine_ab`` on port tensors."""
    j = lambda t: None if t is None else jnp.asarray(t.float().numpy())
    ss = None if scale_shift is None else tuple(j(t) for t in scale_shift)
    a, bb = jq._gn_affine_ab(j(m_c), j(q_c), j(gamma), j(beta), num_groups, eps, j(emb), ss)
    return torch.from_numpy(np.array(a)), torch.from_numpy(np.array(bb))


def check_blocks(r, kinds: tuple, bound: float, aggregate: bool = False, errs: str = "block_l2") -> None:
    """Every block of the classes ``kinds`` within ``bound`` rel L2 (with
    ``aggregate``: their rel L2 taken together, over all their elements;
    ``errs``: the run's key of the errors to read), and the control outside
    it at each of them."""
    blocks = [k for k, kind in r["kinds"].items() if kind in kinds]
    assert blocks
    if aggregate:
        sq = sum((r[errs][k] * r["block_norm"][k]) ** 2 for k in blocks)
        err = (sq / sum(r["block_norm"][k] ** 2 for k in blocks)) ** 0.5
    else:
        err = max(r[errs][k] for k in blocks)
    assert err < bound, r[errs]
    assert min(r["control_l2"][k] for k in blocks) > bound, r["control_l2"]


def test_tiny_int8_unet_matches_jax(monkeypatch):
    r = run_tiny_int8_unets(monkeypatch, "bfloat16")
    assert r["calls"] == {"conv3x3_int8_copy3_pre": 7, "conv3x3_int8_single_pre": 10,
                          "dense_int8_res_mom": 7, "geglu_fused_int8": 7}
    assert r["sites"] == {"conv3x3_int8": 17, "dense_int8_res": 7, "geglu_int8": 7}
    assert max(r["block_errs"].values()) < BF16_REL, r["block_errs"]
    check_blocks(r, ("SpatialTransformer",), 3e-3)
    out, ref = r["out"], r["ref"]
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 6e-2
