"""The int8 UNet's cross-attention maps against the JAX package's on the
CPU: the tiny UNet in bf16, unfused and fused (attn2's q from the LN + quant
prenorm's ``pre_quant``), from one quantized tree, map by map within 1e-5
absolute, teacher-forced, with a control that the bound fails.  In a file of
its own: each arm runs one interpreted JAX forward of ~30 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attn_vis import MAP_ABS, _collect, _inputs, _port_key
from test_torch_parity_utils import TINY_UNET, j, t


def _module(flax_path: str) -> str:
    from leftrefill_torch.convert.from_jax import _unet_module

    return ".".join(_unet_module(p) for p in flax_path.split("/"))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_pre_quant"])
def test_int8_unet_hands_over_one_map_per_cross_attention(monkeypatch, fused):
    """The tiny int8 UNet in bf16 against JAX's, from the same quantized
    tree (``fill_tree`` then JAX's ``quantize_params_like``; JAX in its TPU
    dispatch with the Pallas kernels interpreted, as
    test_torch_quant_unet.py): unfused (both fusion flags 0), and fused,
    where attn2's int8 q comes from the LN + quant prenorm's ``pre_quant``
    (JAX's ``ln_quant_rowwise`` runs, and so does the port's).  JAX's maps
    are the ones its ``return_attn`` sows; the port's come from
    ``collect_attention_maps`` with the K/V cache and cfg_dup on.

    Teacher-forced: each top-level block of the port, and each attn1 inside
    it, returns JAX's output, so attn2 sees JAX's input.  Free-running, a
    last-bit difference of a bf16 value (the self-attention's output into
    attn1's to_out quantization) moves an int8 step and q with it: the maps
    then differ by up to 8e-3.  Forced, every map is within MAP_ABS
    (measured at most 6e-8); the control, the same forced run with the
    int8 activations off (``int8_activations_off``), reads at least 1.1e-3
    at every map, and the test holds it outside MAP_ABS."""
    from jax.experimental.pallas import tpu as pltpu
    from test_torch_parity_utils import fill_tree, int8_activations_off

    import leftrefill_tpu.ops.conv as jconv
    import leftrefill_tpu.ops.quant as jq
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.convert.from_jax import state_dict_from_flax
    from leftrefill_torch.eval.attn_vis import collect_attention_maps
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.ops import quant as tq

    monkeypatch.setattr(jconv, "on_tpu", lambda: True)
    monkeypatch.setenv("LEFTREFILL_FUSED_RES", "1" if fused else "0")
    monkeypatch.setenv("LEFTREFILL_FUSED_LNQ", "1" if fused else "0")
    prenorms = {"jax": 0, "port": 0}

    def counted(side, fn):
        def run(*a, **k):
            prenorms[side] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(jq, "ln_quant_rowwise", counted("jax", jq.ln_quant_rowwise))
    monkeypatch.setattr(tq, "ln_quant_rowwise", counted("port", tq.ln_quant_rowwise))

    x, ts, ctx = _inputs(7)
    args = (j(x).astype(jnp.bfloat16), j(ts), j(ctx).astype(jnp.bfloat16))
    fp = fill_tree(jax.eval_shape(JU(**TINY_UNET).init, jax.random.PRNGKey(0), *args)["params"], 32)
    ju = JU(**TINY_UNET, dtype=jnp.bfloat16, quant=True)
    qstruct = jax.eval_shape(ju.init, jax.random.PRNGKey(0), *args)["params"]
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(qstruct, fp))
    prenorms["jax"] = 0  # eval_shape traced init
    with pltpu.force_tpu_interpret_mode():
        _, state = ju.apply({"params": qtree}, *args, return_attn=True, capture_intermediates=True,
                            mutable=["intermediates"])
    inter = state["intermediates"]
    ref, forced = {}, {}

    def walk(node, path):
        for k, v in node.items():
            if k == "attn_score":
                ref["/".join((*path, k))] = np.asarray(v[0])
            elif path and k == "attn1" or not path and k.startswith(("input_blocks", "middle_block", "output_blocks")):
                forced["/".join((*path, k))] = np.array(v["__call__"][0], np.float32)
            if isinstance(v, dict) and k != "__call__":
                walk(v, (*path, k))

    walk(inter, ())
    assert len(ref) == 4 and len(forced) == 15 + 4  # the UNet's top-level blocks, its 4 self-attentions

    qu = UNetModel(**TINY_UNET, dtype=torch.bfloat16, quant=True, fused=fused)
    sd = state_dict_from_flax({"unet": qtree})
    qu.load_state_dict({k[len("model.diffusion_model."):]: v for k, v in sd.items()}, strict=True)
    qu.eval()
    xt, ct = t(x).bfloat16(), t(ctx).bfloat16()
    tt = torch.from_numpy(ts.astype(np.int64))

    def collect():
        # under cfg_dup the blocks before the first context consumer run on
        # one CFG half (JAX's two halves are equal there)
        hooks = [qu.get_submodule(_module(k)).register_forward_hook(
            lambda m, i, o, w=w: torch.from_numpy(w[:o.shape[0]]).to(o.dtype)) for k, w in forced.items()]
        try:
            return _collect(qu, xt, tt, ct, cross_kv=qu.cross_kv(ct), cfg_dup=True)
        finally:
            for h in hooks:
                h.remove()

    maps, out, plain = collect()
    # 3 per transformer and forward (the port's: the collected one and the plain one)
    assert prenorms == ({"jax": 12, "port": 24} if fused else {"jax": 0, "port": 0})
    assert sorted(maps) == sorted(_port_key(k) for k in ref)
    for k, want in ref.items():
        got = maps[_port_key(k)]
        assert got.shape == want.shape and torch.allclose(got.sum(-1), torch.ones(got.shape[:2]), atol=1e-5)
        assert np.abs(got.numpy() - want).max() < MAP_ABS, k
    assert torch.equal(out, plain)
    with int8_activations_off():
        control, _, _ = collect()
    for k, want in ref.items():
        assert np.abs(control[_port_key(k)].numpy() - want).max() > 1e-3, k
