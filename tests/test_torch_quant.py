"""The port's W8A8 int8 ops against the JAX package's on the CPU: the
quantization helpers and ``dense_int8`` bit for bit, the plain versions of
KI1 (int8 3x3 conv), KI2 (int8 proj_out GEMM + residual) and KI3 (int8
GEGLU) against the Pallas kernels they replace in interpret mode, the
converter's int8 round trip, and the int8 UNet's full-width key set and
kernel dispatch on torch's ``meta`` device.  The CUDA kernels run only on the
card, where ``chip_smoke.py`` holds them to these plain versions.

Tolerances: the helpers and ``dense_int8`` exactly; the conv and the dense +
residual 1 bf16 ulp per element plus one fp32 rounding at the output's
scale (exact int32 sums on both sides and the same fp32 epilogue, but XLA on
the CPU contracts its multiply-add into an FMA, which moves a result that
cancels to near zero by more than its own ulp); the GEGLU rel L2 1e-3
beside 2e-2 * max|ref| (the TPU kernel's erf is the A&S polynomial, exact
erf here, and where the two differ the requant of h may move one int8 step:
measured 2.7e-5 and 1.6e-5, at most 1 bf16 ulp), which a requant chunk of
another width fails (measured 1.4e-2 to 2.1e-2 at 128, 256 and the whole
row; the max-abs bound alone passes 256)."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import BF16_REL, fill_tree, rel_err, rel_l2

from leftrefill_tpu.ops import quant as jq
from leftrefill_torch import kernels
from leftrefill_torch.convert.from_jax import _unet_module, state_dict_from_flax
from leftrefill_torch.ops import mlp as tmlp
from leftrefill_torch.ops import quant as tq

TINY_Q = dict(in_channels=9, model_channels=128, out_channels=4, num_res_blocks=1,
              attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=32, context_dim=96)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _epilogue_close(out, ref, mantissa_bits: int = 7) -> bool:
    """|out - ref| <= 1 ulp of ref (bf16, or fp32 with 23 bits) +
    2^-22 * max|ref| everywhere."""
    o, r = (np.asarray(_np(x), np.float64) for x in (out, ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - mantissa_bits)
    return bool((np.abs(o - r) <= ulp + 2.0**-22 * np.abs(r).max()).all())


def _launch_counts():
    return (tq.conv3x3_int8_op.launches, tq.dense_int8_res_op.launches, tmlp.geglu_int8_fused.launches)


def _with_ties(rng, shape, amax=127.0):
    """Normal values with exact half-way points of the int8 grid mixed in:
    each row's abs-max is ``amax``, so scale = 1 and x / scale = k + 0.5."""
    x = rng.standard_normal(shape).astype(np.float32) * 20
    flat = x.reshape(-1, shape[-1])
    flat[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -126.5, 0.0]
    flat[:, 0] = amax
    return np.clip(x, -amax, amax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_helpers_bit_equal_to_jax(dtype):
    rng = np.random.RandomState(0)
    for x in (_with_ties(rng, (6, 40)), rng.standard_normal((3, 5, 48)).astype(np.float32) * 3):
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jx = jnp.asarray(tx.to(torch.float32).numpy()).astype(dtype)
        for tf, jf in ((tq.quantize_activation, jq.quantize_activation),
                       (tq.quantize_activation_rowwise, jq.quantize_activation_rowwise)):
            (q, s), (jqv, js) = tf(tx), jf(jx)
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert np.array_equal(q.numpy(), np.asarray(jqv)) and np.array_equal(s.numpy(), np.asarray(js))
    w = _with_ties(rng, (24, 3, 3, 40)).transpose(0, 3, 1, 2)  # OIHW, the tie rows per output channel
    q, s = tq.quantize_weight(torch.from_numpy(np.ascontiguousarray(w)))
    jqv, js = jq.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)), axis=-1)  # HWIO
    assert np.array_equal(q.numpy(), np.asarray(jqv).transpose(3, 2, 0, 1))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert (np.abs(q.numpy()) == 127).any() and (q.numpy() == 2).any()  # the ties were reached


@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_dense_int8_bit_equal_to_jax(rowwise, out_dtype):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 40, 96)).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(rng.standard_normal((96, 48)).astype(np.float32) * 0.1))
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    quantize = jq.quantize_activation_rowwise if rowwise else jq.quantize_activation
    xq, sx = quantize(jnp.asarray(x))
    ref = jq.dense_int8(xq, sx, wq, ws, jnp.asarray(bias), out_dtype=getattr(jnp, out_dtype))
    out = tq.dense_int8(torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(sx)),
                        torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.array(ws)),
                        torch.from_numpy(bias), out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype) and out.shape == (2, 40, 48)
    assert np.array_equal(_np(out), np.asarray(ref, np.float32))


def _conv_case(shape, seed):
    b, h, w, ci, co = shape
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.standard_normal((b, h, w, ci)).astype(np.float32)).astype(jnp.bfloat16)
    wq, ws = jq.quantize_weight(jnp.asarray(rng.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.05))
    bias = jnp.asarray(rng.standard_normal(co).astype(np.float32)).astype(jnp.bfloat16)
    xq, sx = jq.quantize_activation(x)
    port = (torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(sx * ws)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(wq).transpose(3, 0, 1, 2))),  # OHWI
            torch.from_numpy(np.asarray(bias, np.float32)))
    return (xq, sx, wq, ws, bias), port


@pytest.mark.parametrize(
    "kernel,shape",
    [
        ("copy3", (2, 16, 32, 128, 128)),
        ("copy3", (1, 16, 32, 320, 128)),  # Ci not a multiple of 128
        ("single", (2, 8, 16, 128, 256)),
        ("single", (1, 8, 16, 320, 320)),  # K6 pads Ci and Co to 384 and slices back
    ],
)
def test_conv_int8_plain_matches_pallas(kernel, shape):
    """KI1's plain version against K5 (three shifted copies) and K6 (one
    padded slab), each at a shape where it has a plan."""
    b, h, w, ci, co = shape
    plan = jq._plan_int8(h, w, ci, co) if kernel == "copy3" else jq._plan_int8_single(h, w, ci, co)
    assert plan is not None
    jargs, targs = _conv_case(shape, sum(shape))
    fn = jq.conv3x3_int8_copy3_pre if kernel == "copy3" else jq.conv3x3_int8_single_pre
    with pltpu.force_tpu_interpret_mode():
        ref = fn(*jargs, out_dtype=jnp.bfloat16)
    before = _launch_counts()
    out = tq.conv3x3_int8_op(*targs)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, w, co)
    assert _epilogue_close(out, ref)
    assert _launch_counts() == before


def test_conv_int8_plain_fp32_matches_pallas():
    """KI1's fp32 output arm (an fp32 int8 model) against K5 writing fp32."""
    shape = (2, 16, 32, 128, 128)
    jargs, targs = _conv_case(shape, 7)
    with pltpu.force_tpu_interpret_mode():
        ref = jq.conv3x3_int8_copy3_pre(*jargs, out_dtype=jnp.float32)
    before = _launch_counts()
    out = tq.conv3x3_int8_op(*targs, torch.float32)
    assert out.dtype == torch.float32 and out.shape == shape[:4]
    assert _epilogue_close(out, ref, mantissa_bits=23)
    assert _launch_counts() == before


def test_dense_int8_res_plain_matches_pallas():
    """KI2's plain version against K9 (the shapes of tests/test_quant.py)."""
    b, r, k, n = 2, 256, 128, 128
    rng = np.random.RandomState(44)
    x = jnp.asarray(rng.standard_normal((b * r, k)).astype(np.float32))
    wq, ws = jq.quantize_weight(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.05))
    bias = jnp.asarray(0.1 * rng.standard_normal(n).astype(np.float32))
    res = jnp.asarray(rng.standard_normal((b, r, n)).astype(np.float32)).astype(jnp.bfloat16)
    xq, sx = jq.quantize_activation_rowwise(x)
    with pltpu.force_tpu_interpret_mode():
        ref, _ = jq.dense_int8_res_mom(xq.reshape(b, r, k), sx.reshape(b, r, 1), wq, ws, bias, res)
    before = _launch_counts()
    out = tq.dense_int8_res_op(torch.from_numpy(np.asarray(xq)), torch.from_numpy(np.asarray(sx)),
                               torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.asarray(ws)),
                               torch.from_numpy(np.asarray(bias)),
                               torch.from_numpy(np.asarray(res, np.float32)).to(torch.bfloat16).reshape(b * r, n))
    assert out.dtype == torch.bfloat16
    assert _epilogue_close(out.reshape(b, r, n), ref)
    assert _launch_counts() == before


@pytest.mark.parametrize("r,din,inner,dout", [(256, 128, 1536, 128), (256, 128, 512, 128)])
def test_geglu_int8_plain_matches_pallas(r, din, inner, dout):
    """KI3's plain version against K10 at the chunk width of JAX's plan
    (512: three chunks, then one), and at half that width, which the
    bound must refuse."""
    from leftrefill_tpu.ops.mlp import _plan, geglu_fused_int8

    chunk = tmlp.geglu_int8_chunk(r, din, inner, dout)
    assert chunk == _plan(r, din, inner, dout, 1, 1)[1] == 512
    rng = np.random.RandomState(r + inner)
    x = jnp.asarray(rng.standard_normal((r, din)).astype(np.float32)).astype(jnp.bfloat16)
    w1q, s1 = jq.quantize_weight(jnp.asarray(rng.standard_normal((din, 2 * inner)).astype(np.float32) * 0.05))
    w2q, s2 = jq.quantize_weight(jnp.asarray(rng.standard_normal((inner, dout)).astype(np.float32) * 0.05))
    b1 = jnp.asarray(0.1 * rng.standard_normal(2 * inner).astype(np.float32))
    b2 = jnp.asarray(0.1 * rng.standard_normal(dout).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = geglu_fused_int8(x, w1q, s1, b1, w2q, s2, b2, out_dtype=jnp.bfloat16)
    xq, sx = jq.quantize_activation_rowwise(x)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    before = _launch_counts()
    out = tmlp.geglu_int8_fused(t(xq), t(sx), t(np.asarray(w1q).T), t(s1), t(b1), t(np.asarray(w2q).T),
                                t(s2), t(b2), chunk)
    half = tmlp.geglu_int8_plain(t(xq), t(sx), t(np.asarray(w1q).T), t(s1), t(b1), t(np.asarray(w2q).T),
                                 t(s2), t(b2), chunk // 2)
    assert out.dtype == torch.bfloat16 and out.shape == (r, dout)
    ref = np.asarray(ref, np.float32)
    assert rel_err(_np(out), ref) < BF16_REL
    assert rel_l2(_np(out), ref) < 1e-3 < rel_l2(_np(half), ref)
    assert _launch_counts() == before


def _jax_int8_tree(seed=0):
    from leftrefill_tpu.models.unet import UNetModel

    args = (jnp.zeros((1, 16, 32, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 96)))
    fp = fill_tree(jax.eval_shape(UNetModel(**TINY_Q).init, jax.random.PRNGKey(0), *args)["params"], seed)
    qstruct = jax.eval_shape(UNetModel(**TINY_Q, quant=True).init, jax.random.PRNGKey(0), *args)["params"]
    return fp, jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(qstruct, fp))


def test_converter_carries_int8_tree_and_port_quantization_matches():
    """A JAX int8 tree loads into the port's int8 UNet with int8 intact, and
    the port's own quantization of the converted fp weights is that tree."""
    from leftrefill_torch.models.unet import UNetModel

    fp, qtree = _jax_int8_tree()
    sd = {k[len("model.diffusion_model."):]: v for k, v in state_dict_from_flax({"unet": qtree}).items()}
    port = UNetModel(**TINY_Q, dtype=torch.bfloat16, quant=True)
    port.load_state_dict(sd, strict=True)
    n_int8 = sum(v.dtype == torch.int8 for v in port.state_dict().values())
    assert n_int8 == sum(leaf.dtype == np.int8 for leaf in jax.tree_util.tree_leaves(qtree)) > 20
    assert port.input_blocks[1][0].in_layers[2].weight.dtype == torch.int8
    assert port.input_blocks[1][0].in_layers[2].weight.is_contiguous(memory_format=torch.channels_last)
    fp_sd = {k[len("model.diffusion_model."):]: v for k, v in state_dict_from_flax({"unet": fp}).items()}
    ours = tq.quantize_params_like(port, fp_sd)
    assert ours.keys() == sd.keys()
    for k in sd:
        assert ours[k].dtype == sd[k].dtype and torch.equal(ours[k], sd[k]), k


def test_full_width_int8_key_set_matches_jax():
    """The int8 UNet at full width, on ``meta``: its int8 weights and their
    scales are exactly JAX's int8 kernels and kernel scales (stem, out conv,
    time_embed and emb_layers stay fp in both)."""
    from leftrefill_tpu.models.unet import UNetModel as JU

    from leftrefill_torch.models.unet import UNetModel

    args = (jnp.zeros((1, 8, 16, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 1024)))
    struct = jax.eval_shape(JU(quant=True).init, jax.random.PRNGKey(0), *args)["params"]
    qstruct = jax.eval_shape(lambda p: jq.quantize_params_like(struct, p), struct)

    def keys(leaf_name, want):
        out = set()
        for path, v in jax.tree_util.tree_leaves_with_path(qstruct):
            names = [p.key for p in path]
            if names[-1] == leaf_name and (want is None or v.dtype == want):
                out.add(".".join(_unet_module(m) for m in names[:-1]))
        return out

    with torch.device("meta"):
        port = UNetModel(quant=True).state_dict()
    ours_int8 = {k[: -len(".weight")] for k, v in port.items() if v.dtype == torch.int8}
    ours_scale = {k[: -len(".weight_scale")] for k in port if k.endswith(".weight_scale")}
    assert ours_int8 == ours_scale == keys("kernel", jnp.int8) == keys("kernel_scale", None)
    assert len(ours_int8) == 47 + 3 + 16 * 12 + 14  # 3x3 convs, Downsamples, 12 per transformer, skip 1x1s
    assert "input_blocks.0.0" not in ours_int8 and "out.2" not in ours_int8


@pytest.mark.parametrize("cfg_dup", [True, False])
def test_full_width_int8_dispatch_counts(monkeypatch, cfg_dup):
    """One full-width CFG-batch-2 int8 forward of the unfused arm
    (``fused=False``; 64x128 latent, cross-attention K/V cache) reaches 47 int8 convs, 11 int8 proj_out GEMMs, 16 int8
    GEGLUs, 15 flash attentions and neither bf16 kernel: JAX's Pallas counts
    in its unfused int8 configuration (K5 + K6, K9, K10, K1).  The K/V cache
    and the forward together make JAX's 163 ``dense_int8`` calls, each on an
    int8 activation: 32 context K/V projections, then 131 (each
    transformer's proj_in, q, k, v, second q and two output projections,
    the five ds-1 proj_outs, the 14 skip 1x1s)."""
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    dense = Counter()

    def counted_dense(xq, *a, _f=tq.dense_int8, **k):
        dense[xq.dtype] += 1
        return _f(xq, *a, **k)

    monkeypatch.setattr(tq, "dense_int8", counted_dense)
    with torch.device("meta"):
        unet = UNetModel(dtype=torch.bfloat16, quant=True, fused=False)
        x = torch.empty(2, 64, 128, 9)
        ts = torch.empty(2, dtype=torch.long)
        ctx = torch.empty(2, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=cfg_dup)
    assert out.shape == (2, 64, 128, 4)
    assert dense == {torch.int8: 163}
    assert Counter(name for name, _ in sites) == {"conv3x3_int8": 47, "dense_int8_res": 11,
                                                 "geglu_int8": 16, "flash_fwd": 15}
    convs = Counter(shape for name, shape in sites if name == "conv3x3_int8")
    assert sum(n for s, n in convs.items() if s[1:3] == (8, 16)) == 14  # K6's sites in JAX
    assert sum(n for s, n in convs.items() if s[0] == 1) == (2 if cfg_dup else 0)  # the shared prefix
    chunks = {shape[0]: shape[4] for name, shape in sites if name == "geglu_int8"}
    assert chunks == {16384: 640, 4096: 640, 1024: 256, 256: 640}


@pytest.mark.parametrize("cfg_dup", [True, False])
def test_full_width_fused_int8_dispatch_counts(monkeypatch, cfg_dup):
    """The int8 UNet in JAX's default configuration (``fused=True``), one
    full-width CFG-batch-2 forward with the cross-attention K/V cache: JAX's
    pinned Pallas counts (tests/test_dispatch_structure.py): 44 fused
    ResBlock conv stacks through K4 into KI1 plus the 3 Upsample convs on
    KI1, 48 K7 prenorms, 16 K8 GroupNorms into proj_in, 11 KI2, 16 KI3, 15
    K1, no bf16 kernel, and 163 ``dense_int8`` calls on int8 activations."""
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    dense = Counter()

    def counted_dense(xq, *a, _f=tq.dense_int8, **k):
        dense[xq.dtype] += 1
        return _f(xq, *a, **k)

    monkeypatch.setattr(tq, "dense_int8", counted_dense)
    with torch.device("meta"):
        unet = UNetModel(dtype=torch.bfloat16, quant=True)
        x = torch.empty(2, 64, 128, 9)
        ts = torch.empty(2, dtype=torch.long)
        ctx = torch.empty(2, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=cfg_dup)
    assert out.shape == (2, 64, 128, 4)
    assert dense == {torch.int8: 163}
    assert Counter(name for name, _ in sites) == {"affine_silu_quant": 44, "conv3x3_int8": 47, "ln_quant": 48,
                                                 "gn_quant": 16, "dense_int8_res": 11, "geglu_int8": 16,
                                                 "flash_fwd": 15}
    # no prenorm writes its bf16 output: every consumer reads the int8 side
    assert {shape[-1] for name, shape in sites if name in ("ln_quant", "gn_quant")} == {False}


def test_full_width_int8_vae_decode_dispatch_counts(monkeypatch):
    """One decode of the int8 VAE decoder (``quant_vae``) at the 512x1024
    canvas (a 64x128 latent), on ``meta``: ``tools.PER_DECODE_VAE8``, KI1 at
    the 64x128 and 128x256 levels (where ``quant.conv3x3_int8_qualifies``
    takes the shape), K2 on the dequantized weight at the 256x512 and
    512x1024 levels, the two nin_shortcuts through ``dense_int8``."""
    from leftrefill_torch import tools
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    dense = Counter()

    def counted_dense(xq, *a, _f=tq.dense_int8, **k):
        dense[xq.dtype] += 1
        return _f(xq, *a, **k)

    monkeypatch.setattr(tq, "dense_int8", counted_dense)
    with torch.device("meta"):
        vae = AutoencoderKL(DDConfig(), 4, dtype=torch.bfloat16, quant_decoder=True)
        z = torch.empty(1, 64, 128, 4)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = vae.decode(z)
    assert out.shape == (1, 512, 1024, 3) and dense == {torch.int8: 2}
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in tools.PER_DECODE_VAE8.items() if v})
    assert Counter(sites) == {("conv3x3_int8", (1, 64, 128, 512, 512)): 10,
                              ("conv3x3_int8", (1, 128, 256, 512, 512)): 7,
                              ("conv3x3", (1, 256, 512, 512, 512)): 1, ("conv3x3", (1, 256, 512, 512, 256)): 1,
                              ("conv3x3", (1, 256, 512, 256, 256)): 5, ("conv3x3", (1, 512, 1024, 256, 256)): 1,
                              ("conv3x3", (1, 512, 1024, 256, 128)): 1, ("conv3x3", (1, 512, 1024, 128, 128)): 5}


@pytest.mark.parametrize("path", ["a_bf16", "a_int8", "b_bf16"])
def test_full_width_option_unet_dispatch_counts(monkeypatch, path):
    """The two option UNets of ``chip_smoke.py`` phase 15u at full width
    (one CFG-batch-2 forward, the K/V cache and cfg_dup on), on ``meta``:
    (A) ``tools.UNET_A`` (scale-shift norms), bf16 and fused int8, every fused K4 site folding the scale-shift; (B)
    ``tools.UNET_B`` (five heads, conv projections, no resample convs), K1
    at head dims 64 and 128."""
    from leftrefill_torch import tools
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    folds = Counter()

    def counted_fold(m_c, q_c, gamma, beta, num_groups, eps, emb=None, scale_shift=None, _f=tq.gn_affine_ab):
        folds["scale_shift" if scale_shift is not None else "emb" if emb is not None else "none"] += 1
        return _f(m_c, q_c, gamma, beta, num_groups, eps, emb, scale_shift)

    monkeypatch.setattr(tq, "gn_affine_ab", counted_fold)
    options = tools.UNET_B if path == "b_bf16" else tools.UNET_A
    with torch.device("meta"):
        unet = UNetModel(dtype=torch.bfloat16, quant=path == "a_int8", **options)
        x, ts, ctx = torch.empty(2, 64, 128, 9), torch.empty(2, dtype=torch.long), torch.empty(2, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        assert unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=True).shape == (2, 64, 128, 4)
    expected = {"a_bf16": tools.PER_FORWARD_UNET_A, "a_int8": tools.PER_FORWARD_UNET_A_INT8,
                "b_bf16": tools.PER_FORWARD_UNET_B}[path]
    assert Counter(name for name, _ in sites) == Counter({k: v for k, v in expected.items() if v})
    if path == "a_int8":  # each fused block's second stack folds the scale-shift; the first folds nothing
        assert folds == {"scale_shift": 22, "none": 22 + 16}  # and the 16 K8 GroupNorms
    flash_d = Counter(shape[4] for name, shape in sites if name == "flash_fwd")
    assert flash_d == ({64: 5, 128: 5} if path == "b_bf16" else {64: 15})


def test_tiny_int8_bundle_serves_a_canvas():
    """The pipeline over an int8 UNet (quantized from the tiny bundle's fp
    weights): the tiny widths qualify for no int8 kernel, so this drives the
    fallbacks (dequantized-weight convs, two-dense GEGLU, proj_out dense +
    add) end to end with DPM++(2M).  The canvas is finite, keeps its left
    half, and stays near the fp canvas (max 0.25 on a [-1, 1] image, measured
    0.074: four solver steps of W8A8 noise)."""
    from test_torch_parity_utils import TINY_UNET, tiny_bundles

    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.pipeline import RefInpaintPipeline, stitch_canvas

    _, _, tm, tok, sp = tiny_bundles()
    rng = np.random.RandomState(5)
    image, mask = stitch_canvas(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
                                rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
                                np.ones((1, 32, 32, 1), np.float32))
    x_t = torch.from_numpy(rng.standard_normal((1, 16, 32, 4)).astype(np.float32))
    pipe = RefInpaintPipeline(model=tm, tokenizer=tok, special_tokens=sp, device="cpu", ddim_steps=4,
                              sampler="dpm++2m")
    fp_canvas = pipe(image, mask, x_T=x_t)
    qunet = UNetModel(**TINY_UNET, quant=True)
    qunet.load_state_dict(tq.quantize_params_like(qunet, tm.unet.state_dict()), strict=True)
    tm.model.diffusion_model = qunet.eval()
    before = _launch_counts()
    canvas = pipe(image, mask, x_T=x_t)
    assert _launch_counts() == before
    assert canvas.shape == (1, 32, 64, 3) and torch.isfinite(canvas).all()
    assert torch.equal(canvas[:, :, :32], torch.from_numpy(image[:, :, :32]))
    assert not torch.equal(canvas, fp_canvas) and float((canvas - fp_canvas).abs().max()) < 0.25


def test_fp32_int8_unet_keeps_the_unfused_arm():
    """JAX gates its fused prologues on bf16, so an fp32 int8 UNet computes
    the unfused arm whatever ``fused`` says: the same sites (no K4, K7 or
    K8) and the same output, on the tiny int8 UNet of the CPU tests."""
    from leftrefill_torch.models.unet import UNetModel

    _, qtree = _jax_int8_tree()
    sd = {k[len("model.diffusion_model."):]: v for k, v in state_dict_from_flax({"unet": qtree}).items()}
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32, 9)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 96)).astype(np.float32))
    outs, sites = [], []
    for fused in (True, False):
        unet = UNetModel(**TINY_Q, dtype=torch.float32, quant=True, fused=fused)
        unet.load_state_dict(sd, strict=True)
        with torch.no_grad(), kernels.record_sites() as s:
            outs.append(unet.eval()(x, torch.tensor([500, 500]), ctx))
        sites.append(Counter(name for name, _ in s))
    assert sites[0] == sites[1] == {"conv3x3_int8": 17}
    assert torch.equal(outs[0], outs[1])


def test_geglu_int8_yardstick_is_the_two_products():
    """KI3's yardstick (``tools.library_fn("geglu_int8")``) is its two int8
    products alone at the site's shapes, [R, din] x [din, 2I] and
    [R, I] x [I, dout], in int32: a floor for its tensor work."""
    from leftrefill_torch import tools

    r, din, inner, dout = 128, 64, 256, 64
    gen = torch.Generator().manual_seed(0)
    xq, sx = tq.quantize_activation_rowwise(torch.randn(r, din, generator=gen).to(torch.bfloat16))
    w1q, s1 = tq.quantize_weight(torch.randn(2 * inner, din, generator=gen))
    w2q, s2 = tq.quantize_weight(torch.randn(dout, inner, generator=gen))
    args = (xq, sx, w1q, s1, torch.zeros(2 * inner), w2q, s2, torch.zeros(dout), 128)
    up, down = tools.library_fn("geglu_int8", args)()
    assert up.dtype == down.dtype == torch.int32
    assert up.shape == (r, 2 * inner) and down.shape == (r, dout)
    assert torch.equal(up, xq.to(torch.int32) @ w1q.to(torch.int32).t())
