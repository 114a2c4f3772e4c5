"""The port's int8 ResBlock and SpatialTransformer against the JAX package's
in its unfused int8 configuration (``LEFTREFILL_FUSED_RES=0
LEFTREFILL_FUSED_LNQ=0``) with the TPU dispatch forced on and the Pallas
kernels in interpret mode, on the same int8 weights from
``quantize_params_like``.  The port runs on the CPU through the kernels'
plain versions at the same sites.

Tolerances.  Every module is held to 2e-2 * max|ref|
(test_torch_parity_utils.BF16_REL): both sides quantize the same way, but
the bf16 elementwise ops around the int8 sites round at different points
(XLA on the CPU rounds SiLU's exp, add and divide to bf16 one by one,
PyTorch once), and where that moves an activation across an int8 rounding
boundary the int8 value moves one step.  Measured: 1.2e-2 for the bf16
ResBlock (two per-tensor quantized convs), 1.0e-2 for the transformer.
That bound alone cannot tell a sound module from its control (the int8
activations off, ``int8_activations_off``: 1.3e-2 and 1.5e-2), so each
test that can also holds rel L2 between the sound reading and the
control's, and checks that the control fails it:
- the bf16 transformer: 6e-3, measured 3.0e-3; control 1.3e-2, and a GEGLU
  requant chunk of half JAX's width 9.8e-3;
- the fp32 ResBlock: 1e-3, measured 9.7e-5 (fp32 rounding moves an int8
  step only at a near-tie); control 1.3e-2.  The bf16 ResBlock does not separate (sound
  1.15e-2, control 1.43e-2: a bf16 ulp before the quantization is up to
  half an int8 step), so it keeps the max-abs bound alone."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import BF16_REL, fill_tree, int8_activations_off, rel_err, rel_l2

import leftrefill_tpu.ops.conv as jconv
from leftrefill_tpu.ops import quant as jq
from leftrefill_torch import kernels
from leftrefill_torch.convert.from_jax import state_dict_from_flax


@pytest.fixture
def unfused_int8_tpu_dispatch(monkeypatch):
    """JAX's int8 modules as they run on a TPU with both fusion flags off."""
    monkeypatch.setattr(jconv, "on_tpu", lambda: True)
    monkeypatch.setenv("LEFTREFILL_FUSED_RES", "0")
    monkeypatch.setenv("LEFTREFILL_FUSED_LNQ", "0")


def _int8_params(fp_module, q_module, seed, *args):
    fp = fill_tree(jax.eval_shape(fp_module.init, jax.random.PRNGKey(0), *args)["params"], seed)
    qstruct = jax.eval_shape(q_module.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(qstruct, fp))


def _load(module, qtree):
    sd = state_dict_from_flax({"unet": qtree})
    cut = len("model.diffusion_model.")
    module.load_state_dict({k[cut:]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _bf16(rng, shape, scale=1.0, dtype="bfloat16"):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(getattr(torch, dtype))
    return x, jnp.asarray(x.to(torch.float32).numpy()).astype(dtype)


def _resblocks(dtype: str):
    """128 -> 256 channels at 16x32 in ``dtype``: both 3x3 convs on KI1 (K5
    in JAX), the skip 1x1 an int8 dense.  Returns (port output, JAX output,
    port output with the int8 activations off)."""
    from leftrefill_tpu.models.unet import ResBlock as JR

    from leftrefill_torch.models.unet import ResBlock as TR

    rng = np.random.RandomState(21)
    xt, xj = _bf16(rng, (2, 16, 32, 128), dtype=dtype)
    et, ej = _bf16(rng, (2, 512), dtype=dtype)
    jr = lambda quant: JR(out_channels=256, dtype=getattr(jnp, dtype), quant=quant)
    qtree = _int8_params(jr(False), jr(True), 22, xj, ej)
    with pltpu.force_tpu_interpret_mode():
        ref = jr(True).apply({"params": qtree}, xj, ej)
    tr = _load(TR(128, 256, 512, dtype=getattr(torch, dtype), quant=True, fused=False), qtree)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = tr(xt, et)
    with torch.no_grad(), int8_activations_off():
        control = tr(xt, et)
    assert Counter(n for n, _ in sites) == {"conv3x3_int8": 2}
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 16, 32, 256)
    return out.float().numpy(), np.asarray(ref, np.float32), control.float().numpy()


def test_int8_resblock_matches_jax(unfused_int8_tpu_dispatch):
    out, ref, _ = _resblocks("bfloat16")
    assert rel_err(out, ref) < BF16_REL


def test_int8_resblock_fp32_matches_jax(unfused_int8_tpu_dispatch):
    """The fp32 ResBlock: KI1 writes fp32 (JAX's K5 does too), and the error
    is that of single int8 steps, which the control's is not."""
    out, ref, control = _resblocks("float32")
    assert rel_err(out, ref) < BF16_REL
    assert rel_l2(out, ref) < 1e-3 < rel_l2(control, ref)


def test_int8_spatial_transformer_matches_jax(unfused_int8_tpu_dispatch):
    """128 channels at 16x32, 4 heads x 32, context 77 x 96: the feed-forward
    on KI3 (K10) and proj_out + residual on KI2 (K9); self- and
    cross-attention through the same int8 projections on both sides."""
    from leftrefill_tpu.models.unet import SpatialTransformer as JS

    from leftrefill_torch.models.unet import SpatialTransformer as TS

    rng = np.random.RandomState(23)
    xt, xj = _bf16(rng, (2, 16, 32, 128))
    ct, cj = _bf16(rng, (2, 77, 96))
    js = lambda quant: JS(in_channels=128, n_heads=4, d_head=32, depth=1, context_dim=96,
                          dtype=jnp.bfloat16, quant=quant)
    qtree = _int8_params(js(False), js(True), 24, xj, cj)
    with pltpu.force_tpu_interpret_mode():
        ref = js(True).apply({"params": qtree}, xj, cj)
    ts = _load(TS(128, 4, 32, 1, 96, dtype=torch.bfloat16, quant=True, fused=False), qtree)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = ts(xt, ct)
        kv_out = ts(xt, ct, cross_kv=ts.cross_kv(ct))
    with torch.no_grad(), int8_activations_off():
        control = ts(xt, ct).float().numpy()
    assert Counter(n for n, _ in sites) == {"dense_int8_res": 2, "geglu_int8": 2}
    assert ("geglu_int8", (1024, 128, 512, 128, 512)) in sites
    assert torch.equal(out, kv_out)  # the K/V cache quantizes the context as attn2 does
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 32, 128)
    ref = np.asarray(ref, np.float32)
    assert rel_err(out.float().numpy(), ref) < BF16_REL
    assert rel_l2(out.float().numpy(), ref) < 6e-3 < rel_l2(control, ref)
