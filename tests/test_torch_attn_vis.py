"""The port's cross-attention maps against the JAX package's on the CPU in
fp32: ``ops.attention.attention_probs`` against JAX's, and
``eval.attn_vis.collect_attention_maps`` on the tiny UNet against JAX's
``collect_attention_maps`` map by map (the port's module names mapped
one-to-one onto JAX's flax paths ``.../attn2/attn_score``), plain and with
the cross-attention K/V cache and the shared CFG prefix, within 1e-5
absolute; the NVS UNet passes the collection through as JAX's does; a
multi-view UNet yields none, as JAX's; the collector leaves every forward's
output bit-equal.  The int8 UNets' maps are in test_torch_attn_vis_int8.py.  Also the step average
and the heatmap against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import TINY_UNET, init_flax, j, load_port, t

MAP_ABS = 1e-5


def _port_key(flax_path: str) -> str:
    """``input_blocks_1_1/transformer_blocks_0/attn2/attn_score`` ->
    ``input_blocks.1.1.transformer_blocks.0.attn2``."""
    from leftrefill_torch.convert.from_jax import _unet_module

    return ".".join(_unet_module(p) for p in flax_path.split("/")[:-1])


def _inputs(seed: int = 3, context_dim: int = 24):
    rng = np.random.RandomState(seed)
    x = np.repeat(rng.standard_normal((1, 8, 16, 9)).astype(np.float32), 2, axis=0)  # the CFG layout
    ts = np.array([531, 531], np.int32)
    ctx = rng.standard_normal((2, 77, context_dim)).astype(np.float32)
    return x, ts, ctx


@pytest.fixture(scope="module")
def unets():
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.unet import UNetModel

    ju = JU(**TINY_UNET)
    params = init_flax(ju, 0, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    return ju, params, load_port(UNetModel(**TINY_UNET), "unet", params)


def _collect(unet, *args, **kwargs):
    """(maps, the forward's output inside the collection, the same forward
    without a collector)."""
    from leftrefill_torch.eval.attn_vis import collect_attention_maps

    outs = []
    hook = unet.register_forward_hook(lambda m, i, o: outs.append(o))
    try:
        maps = collect_attention_maps(unet, *args, **kwargs)
    finally:
        hook.remove()
    with torch.no_grad():
        plain = unet(*args, **kwargs)
    return maps, outs[0], plain


def test_attention_probs_matches_jax():
    from leftrefill_tpu.ops.attention import attention_probs as jprobs

    from leftrefill_torch.ops.attention import attention_probs

    rng = np.random.RandomState(0)
    q = rng.standard_normal((2, 48, 32)).astype(np.float32)
    k = rng.standard_normal((2, 77, 32)).astype(np.float32)
    got = attention_probs(t(q), t(k), 4)
    assert got.shape == (2, 48, 77) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(jprobs(j(q), j(k), 4))).max() < MAP_ABS
    assert torch.allclose(got.sum(-1), torch.ones(2, 48), atol=1e-6)
    got_bf16 = attention_probs(t(q).bfloat16(), t(k).bfloat16(), 4)  # fp32 scores from bf16 q and k
    assert got_bf16.dtype == torch.float32


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "kv_cache_cfg_dup"])
def test_collect_attention_maps_matches_jax(unets, cached):
    from leftrefill_tpu.eval.attn_vis import collect_attention_maps as jcollect

    ju, params, tu = unets
    x, ts, ctx = _inputs()
    ref = jcollect(ju, params, j(x), j(ts), j(ctx))
    kwargs = dict(cross_kv=tu.cross_kv(t(ctx)), cfg_dup=True) if cached else {}
    maps, out, plain = _collect(tu, t(x), torch.from_numpy(ts.astype(np.int64)), t(ctx), **kwargs)
    assert len(ref) == 4 and all(k.endswith("/attn2/attn_score") for k in ref)  # the 4 transformers
    assert sorted(maps) == sorted(_port_key(k) for k in ref)
    assert set(maps) == {n for n, _ in tu.named_modules() if n.endswith("attn2")}
    for k, want in ref.items():
        got = maps[_port_key(k)]
        assert got.shape == want.shape and got.shape[-1] == 77
        assert np.abs(got.numpy() - want).max() < MAP_ABS, k
    assert torch.equal(out, plain)
    assert all(a.probs_sink is None for n, a in tu.named_modules() if n.endswith("attn2"))


def test_nvs_unet_passes_the_collection_through():
    """The NVS UNet (separator columns off) against JAX's NVS UNet, whose
    ``**kwargs`` carry ``return_attn``; with ``c_input`` the maps exist and
    the output is unchanged."""
    from leftrefill_tpu.eval.attn_vis import collect_attention_maps as jcollect
    from leftrefill_tpu.models.nvs import NVSUnetModel as JN

    from leftrefill_torch.models.nvs import NVSUnetModel

    cfg = {**TINY_UNET, "model_channels": 32, "context_dim": 16}
    ju = JN(use_sep=False, **cfg)
    p = init_flax(ju, 1, jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 16)))
    tu = load_port(NVSUnetModel(use_sep=False, **cfg), "unet", p)
    x, ts, ctx = _inputs(4, context_dim=16)
    ctx = ctx[:, :7]
    ref = jcollect(ju, p, j(x), j(ts), j(ctx))
    maps, out, plain = _collect(tu, t(x), torch.from_numpy(ts.astype(np.int64)), t(ctx))
    assert sorted(maps) == sorted(_port_key(k) for k in ref) and len(maps) == 4
    for k, want in ref.items():
        assert np.abs(maps[_port_key(k)].numpy() - want).max() < MAP_ABS, k
    c_input = t(np.random.RandomState(5).standard_normal((2, 8, 16, 32)).astype(np.float32))
    maps, out, plain = _collect(tu, t(x), torch.from_numpy(ts.astype(np.int64)), t(ctx), c_input=c_input)
    assert len(maps) == 4 and torch.equal(out, plain)


def test_multiview_unet_yields_no_maps():
    """JAX's multi-view block calls attn2 without ``return_attn``
    (multiview.py:130, :142): its collection is empty, and so is the
    port's."""
    from leftrefill_tpu.eval.attn_vis import collect_attention_maps as jcollect
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV

    from leftrefill_torch.models.multiview import MultiViewUnetModel

    ju = JMV(view_num=2, **TINY_UNET)
    p = init_flax(ju, 2, jnp.zeros((2, 8, 16, 9)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 77, 24)))
    tu = load_port(MultiViewUnetModel(view_num=2, **TINY_UNET), "unet", p)
    x, ts, ctx = _inputs(6)
    assert jcollect(ju, p, j(x), j(ts), j(ctx)) == {}
    maps, out, plain = _collect(tu, t(x), torch.from_numpy(ts.astype(np.int64)), t(ctx))
    assert maps == {} and torch.equal(out, plain)


def test_step_average_and_heatmap_match_jax():
    from leftrefill_tpu.eval import attn_vis as jv

    from leftrefill_torch.eval import attn_vis as tv

    rng = np.random.RandomState(8)
    steps = [{"a": rng.uniform(size=(2, 32, 7)).astype(np.float32),
              "b": rng.uniform(size=(2, 8, 7)).astype(np.float32)} for _ in range(3)]
    ref = jv.average_attention_over_steps(steps)
    got = tv.average_attention_over_steps([{k: t(v) for k, v in s.items()} for s in steps])
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.abs(got[k].numpy() - ref[k]).max() < 1e-6
    heat = tv.attention_heatmap(got["a"][0], (4, 8), 3)
    want = jv.attention_heatmap(ref["a"][0], (4, 8), 3)
    assert heat.shape == (4, 8) and np.abs(heat.numpy() - want).max() < 1e-6
    assert float(heat.min()) == 0.0 and float(heat.max()) == 1.0
