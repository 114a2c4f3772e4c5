"""The port's LoRA algebra and serving adapter store against the JAX
package's (``models/lora.py``, ``runtime.LoraAdapterStore``) on the CPU, in
fp32, at the tiny UNet of tests/test_nvs.py: the merge at Dense and conv
sites under the default and extended targets, the extraction, the
initial factors' statistics, the store's LRU and base restore, and its int8
requantization equal to JAX's ``quantize_params_like`` on the merged tree;
the number of LoRA sites at full width, on shapes only; and the bf16 merge
bit-equal to JAX's.  Tolerance: the fp32 merged weights within 1e-6
relative to max|ref| (the same fp32 products, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import fill_tree, init_flax, rel_err

from leftrefill_torch.convert.from_jax import lora_from_flax, state_dict_from_flax

TINY_UNET = dict(in_channels=9, model_channels=32, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=16)
MERGE_REL = 1e-6
PREFIX = "model.diffusion_model."
ARGS = (jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 16)))


def _port_state(params) -> dict:
    return {k[len(PREFIX):]: v for k, v in state_dict_from_flax({"unet": params}).items()}


def _jax_lora(params, target, seed: int = 1, rank: int = 4):
    """JAX's factors for ``params`` with seeded non-zero ups (init's ups are
    zero, which would make every merge the identity)."""
    from leftrefill_tpu.models.lora import init_lora

    lora = init_lora(params, rank=rank, target=target, key=jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    return {k: {"down": np.asarray(v["down"]), "up": 0.1 * rng.standard_normal(np.shape(v["up"])).astype(np.float32)}
            for k, v in lora.items()}


@pytest.fixture(scope="module")
def tiny_params():
    from leftrefill_tpu.models.unet import UNetModel

    return init_flax(UNetModel(**TINY_UNET), 0, *ARGS)


@pytest.mark.parametrize("target", ["default", "extended"])
def test_merge_lora_matches_jax(tiny_params, target):
    """W + scale up . down at every targeted site (Dense: attention
    projections and the GEGLU input; extended also the ResBlocks' 3x3 and
    1x1 convs) equals JAX's merge under the converter's name and layout
    map; every other weight is the same tensor."""
    from leftrefill_tpu.models import lora as jl

    from leftrefill_torch.models import lora as tl

    jt, tt = {"default": (jl.default_target, tl.default_target),
              "extended": (jl.extended_target, tl.extended_target)}[target]
    lora = _jax_lora(tiny_params, jt)
    ours = lora_from_flax(lora)
    state = _port_state(tiny_params)
    assert set(ours) == {k for k, v in state.items() if tt(k) and v.ndim in (2, 4)}
    kinds = {state[k].ndim for k in ours}
    assert kinds == ({2} if target == "default" else {2, 4})
    ref = _port_state(jl.merge_lora(tiny_params, {k: {f: jnp.asarray(a) for f, a in v.items()}
                                                  for k, v in lora.items()}, scale=0.7))
    merged = tl.merge_lora(state, ours, scale=0.7)
    assert merged.keys() == ref.keys()
    for k in merged:
        if k in ours:
            assert rel_err(merged[k], ref[k]) < MERGE_REL, k
            assert not torch.equal(merged[k], state[k])
        else:
            assert merged[k] is state[k]
    assert tl.num_lora_params(ours) == jl.num_lora_params(lora)


def test_extract_lora_matches_jax(tiny_params):
    from leftrefill_tpu.models import lora as jl

    from leftrefill_torch.models import lora as tl

    lora = _jax_lora(tiny_params, jl.extended_target)
    ours = lora_from_flax(lora)
    ref = jl.extract_lora({k: {f: jnp.asarray(a) for f, a in v.items()} for k, v in lora.items()}, scale=2.0)
    got = tl.extract_lora(ours, scale=2.0)
    assert len(got) == len(ref) == len(lora)
    for (up, down), (rup, rdown), key in zip(got, ref, ours):
        conv = down.ndim == 4
        assert torch.equal(up, torch.from_numpy(np.asarray(rup).T[..., None, None] if conv else np.asarray(rup).T))
        assert torch.equal(down, torch.from_numpy(np.asarray(rdown).transpose(3, 2, 0, 1) if conv
                                                  else np.asarray(rdown).T)), key


def test_init_lora_statistics_match_jax(tiny_params):
    """Down ~ N(0, 1) / rank in the reference's layouts, up zero, on the
    same sites and shapes as JAX's factors; the draws' mean and std as
    JAX's (the two streams cannot agree bit for bit)."""
    from leftrefill_tpu.models import lora as jl

    from leftrefill_torch.models import lora as tl
    from leftrefill_torch.models.unet import UNetModel

    unet = UNetModel(**TINY_UNET)
    unet.load_state_dict(_port_state(tiny_params), strict=True)
    ours = tl.init_lora(unet, rank=8, target=tl.extended_target, generator=torch.Generator().manual_seed(0))
    ref = lora_from_flax({k: {f: np.asarray(a) for f, a in v.items()} for k, v in
                          jl.init_lora(tiny_params, rank=8, target=jl.extended_target,
                                       key=jax.random.PRNGKey(0)).items()})
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k]["down"].shape == ref[k]["down"].shape and ours[k]["up"].shape == ref[k]["up"].shape, k
        assert not ours[k]["up"].any() and not ref[k]["up"].any()
    d, rd = (torch.cat([v["down"].flatten() for v in lora.values()]) for lora in (ours, ref))
    assert d.numel() > 20000
    assert abs(float(d.std()) - float(rd.std())) < 0.01 / 8 and abs(float(d.std()) - 1 / 8) < 0.01 / 8
    assert abs(float(d.mean())) < 3 / 8 / d.numel() ** 0.5 and abs(float(rd.mean())) < 3 / 8 / d.numel() ** 0.5


def test_adapter_store_swaps_in_place_with_lru(tiny_params):
    """The store loads the merged weights into the UNet itself, keeps the
    last ``keep`` merges (a hit returns the same dict), evicts the oldest,
    restores the base bit for bit from its copy, refuses an unknown name, and
    runs on the card unless asked for the CPU."""
    from leftrefill_tpu.models import lora as jl

    from leftrefill_torch.models import lora as tl
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.runtime import LoraAdapterStore

    unet = UNetModel(**TINY_UNET)
    base = _port_state(tiny_params)
    unet.load_state_dict(base, strict=True)
    packs = {n: lora_from_flax(_jax_lora(tiny_params, jl.default_target, seed=s)) for n, s in (("a", 1), ("b", 2))}
    store = LoraAdapterStore(unet, keep=1, device="cpu")
    for name, pack in packs.items():
        store.add(name, pack)
    assert store.names() == ["a", "b"]
    key = next(iter(packs["a"]))
    live = dict(unet.named_parameters())[key]
    assert store.use("a") is unet
    assert torch.equal(live, tl.merge_lora(base, packs["a"])[key])
    sa = store.state_for("a")
    assert store.state_for("a") is sa  # a hit: no merge
    store.use("b")
    assert torch.equal(live, tl.merge_lora(base, packs["b"])[key])
    assert store.state_for("a") is not sa and torch.equal(store.state_for("a")[key], sa[key])  # evicted, merged again
    store.use(None)
    assert all(torch.equal(v, base[k]) for k, v in unet.state_dict().items())
    with pytest.raises(KeyError):
        store.use("nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LoraAdapterStore(unet)


def test_adapter_store_int8_requant_matches_jax():
    """With the fp master of an int8 UNet the store merges into the master
    and requantizes to the int8 structure: equal to JAX's
    ``quantize_params_like`` of JAX's merged tree: the int8 weights exactly,
    the scales within 1e-6 relative (the merged fp32 weights agree to their
    last bits, so a channel's max |w| and its scale may differ by an ulp),
    and the int8 UNet serves it."""
    from leftrefill_tpu.models import lora as jl
    from leftrefill_tpu.models.unet import UNetModel as JU
    from leftrefill_tpu.ops import quant as jq

    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.runtime import LoraAdapterStore

    fp = fill_tree(jax.eval_shape(JU(**TINY_UNET).init, jax.random.PRNGKey(0), *ARGS)["params"], 3)
    qstruct = jax.eval_shape(JU(**TINY_UNET, quant=True).init, jax.random.PRNGKey(0), *ARGS)["params"]
    lora = _jax_lora(fp, jl.extended_target, seed=4)
    expect = _port_state(jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(
        qstruct, jl.merge_lora(fp, {k: {f: jnp.asarray(a) for f, a in v.items()} for k, v in lora.items()}, 1.0))))
    qunet = UNetModel(**TINY_UNET, quant=True)
    qunet.load_state_dict(_port_state(jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(qstruct, fp))),
                          strict=True)
    store = LoraAdapterStore(qunet, master_unet=_port_state(fp), device="cpu")
    store.add("a", lora_from_flax(lora))
    store.use("a")
    got = qunet.state_dict()
    n_int8 = 0
    for k, v in expect.items():
        if v.dtype == torch.int8:
            n_int8 += 1
            assert got[k].dtype == torch.int8 and torch.equal(got[k], v), k
            torch.testing.assert_close(got[k + "_scale"], expect[k + "_scale"], rtol=1e-6, atol=0)
    assert n_int8 > 10
    x = torch.from_numpy(np.random.RandomState(0).standard_normal((2, 8, 16, 9)).astype(np.float32))
    with torch.no_grad():
        out = qunet(x, torch.tensor([300, 300]), torch.zeros(2, 7, 16))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("target", ["default", "extended"])
def test_full_width_lora_site_count_matches_jax(target):
    """At SD2 width, on shapes only (``meta`` and ``jax.eval_shape``): the
    port's targeted weights are JAX's, site for site."""
    from leftrefill_tpu.models import lora as jl
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.convert.from_jax import _unet_module
    from leftrefill_torch.models import lora as tl
    from leftrefill_torch.models.nvs import NVSUnetModel

    jt, tt = {"default": (jl.default_target, tl.default_target),
              "extended": (jl.extended_target, tl.extended_target)}[target]
    struct = jax.eval_shape(JU().init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, 1024)))["params"]
    ref = {".".join(_unet_module(m) for m in path[:-1]) + ".weight"
           for path, leaf in jl._iter_kernels(struct) if jt(path) and len(leaf.shape) in (2, 4)}
    with torch.device("meta"):
        ours = {k for k, v in NVSUnetModel().state_dict().items() if tt(k) and v.ndim in (2, 4)}
    assert ours == ref
    assert len(ours) == {"default": 16 * 9, "extended": 16 * 9 + 22 * 2 + 14}[target]


@pytest.mark.parametrize("target", ["default", "extended"])
def test_bf16_merge_bit_equal_to_jax(tiny_params, target):
    """On a bf16 tree at scale 0.7, the merge rounds as JAX's ``leaf + scale *
    delta.astype(leaf.dtype)`` does (the delta to bf16, the weakly typed
    scale to bf16, the product and the sum in bf16): bit-equal at every
    site, on the bf16 UNet's own state_dict, whose channels-last conv
    weights stay channels-last.  A sum in fp32 rounded once differs by one
    bf16 step on a few per cent of the elements."""
    from leftrefill_tpu.models import lora as jl

    from leftrefill_torch.models import lora as tl
    from leftrefill_torch.models.unet import UNetModel

    jt, tt = {"default": (jl.default_target, tl.default_target),
              "extended": (jl.extended_target, tl.extended_target)}[target]
    lora = _jax_lora(tiny_params, jt)
    jbf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tiny_params)
    merged_ref = jl.merge_lora(jbf, {k: {f: jnp.asarray(a) for f, a in v.items()} for k, v in lora.items()}, scale=0.7)
    ref = _port_state(jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), merged_ref))
    unet = UNetModel(**TINY_UNET, dtype=torch.bfloat16)
    unet.load_state_dict(_port_state(tiny_params), strict=True)
    state = unet.state_dict()
    ours = lora_from_flax(lora)
    merged = tl.merge_lora(state, ours, scale=0.7)
    once = {}
    for k, v in ours.items():
        w = state[k]
        assert w.dtype == torch.bfloat16 and merged[k].dtype == torch.bfloat16
        assert torch.equal(merged[k].float(), ref[k]), k
        if w.ndim == 4:
            assert merged[k].is_contiguous(memory_format=torch.channels_last) == w.is_contiguous(
                memory_format=torch.channels_last), k
        delta = (v["up"].reshape(v["up"].shape[0], -1) @ v["down"].reshape(v["down"].shape[0], -1)).reshape(w.shape)
        once[k] = (w.float() + 0.7 * delta).to(torch.bfloat16)
    assert any(w.ndim == 4 and w.is_contiguous(memory_format=torch.channels_last) for k, w in state.items() if k in ours) \
        == (target == "extended")
    # the rule this replaced (an fp32 sum rounded once) is not bit-equal: the test tells them apart
    assert sum(int((once[k] != merged[k]).sum()) for k in ours) > 0
