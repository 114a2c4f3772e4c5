"""The int8 VAE decoder (``AutoencoderKL(quant_decoder=True)``, the serving
path's ``quant_vae``) against the JAX package's on the CPU, and its entry
points.

The tiny decoder: ch 32, ch_mult (1, 2), one res block, an 8x16 latent.
JAX runs with the TPU dispatch forced and the Pallas kernels in interpret
mode.  Its 64-channel sites (the middle blocks, up level 1 and its upsample
conv at 16x32) take the int8 conv kernel (K5/K6 in JAX, KI1 in the port:
nine sites); the 32-channel level falls back to the dequantized weight
through ``conv3x3_apply`` (four sites) and the level's ``nin_shortcut`` is
an int8 dense.  The same seeded numpy weights (``fill_tree``, then JAX's
``quantize_params_like``) go to both sides through ``state_dict_from_flax``.

Tolerances.  fp32: the decode and each block fed JAX's input to it
(teacher-forced) within 1e-5 rel L2 (measured 5.2e-7 end to end, at most
2.4e-7 a block), and the control, the port's int8 activations off
(``int8_activations_off``), outside it at every block with an int8 site
(measured 5.2e-3 to 1.1e-2) and end to end (2.5e-2).  bf16: a bf16 ulp of a
value before its quantization is up to half an int8 step, so, as for the
int8 UNet, the bf16 blocks do not separate from the control; they are held
to 2e-2 of max|ref| (test_torch_parity_utils.BF16_REL, measured at most
1.0e-2) and the free-running decode to 6e-2 rel L2 (measured 3.4e-2: the
int8 noise level, a check of scale).  The entry points: weights exactly."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_cli import MODEL_YAML
from test_torch_parity_utils import BF16_REL, fill_tree, int8_activations_off, rel_err, rel_l2

import leftrefill_tpu.ops.conv as jconv
import leftrefill_tpu.ops.quant as jq
from leftrefill_torch import kernels
from leftrefill_torch.convert.from_jax import _vae_module, state_dict_from_flax
from leftrefill_torch.ops import quant as tq

DD = dict(z_channels=4, resolution=64, ch=32, ch_mult=(1, 2), num_res_blocks=1)
FP32_L2 = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_int8_vae_decoder_matches_jax(monkeypatch, dtype):
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD

    from leftrefill_torch.models.autoencoder import AutoencoderKL as TV, DDConfig as TD

    monkeypatch.setattr(jconv, "on_tpu", lambda: True)
    calls = Counter()
    for mod, name in ((jq, "conv3x3_int8"), (jconv, "conv3x3_apply"), (jq, "dense_int8")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    z = np.random.RandomState(3).standard_normal((1, 8, 16, 4)).astype(np.float32)
    image = jnp.zeros((1, 16, 32, 3))
    fp = fill_tree(jax.eval_shape(JV(ddconfig=JD(**DD), embed_dim=4).init, jax.random.PRNGKey(0), image)["params"], 41)
    jv = JV(ddconfig=JD(**DD), embed_dim=4, dtype=jdt, quant_decoder=True)
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params_like(
        jax.eval_shape(jv.init, jax.random.PRNGKey(0), image)["params"], fp))
    calls.clear()
    with pltpu.force_tpu_interpret_mode():
        ref, state = jv.apply({"params": qtree}, jnp.asarray(z).astype(jdt), method="decode",
                              capture_intermediates=True, mutable=["intermediates"])
    ref = np.asarray(ref, np.float32)
    blocks = {k: np.asarray(v["__call__"][0], np.float32) for k, v in state["intermediates"]["decoder"].items()
              if k.startswith(("mid_block", "up_"))}
    assert calls == {"conv3x3_int8": 9, "conv3x3_apply": 4, "dense_int8": 1}

    tv = TV(TD(**DD), 4, dtype=tdt, quant_decoder=True)
    sd = state_dict_from_flax({"vae": qtree})
    tv.load_state_dict({k[len("first_stage_model."):]: v for k, v in sd.items()}, strict=True)
    zt = torch.from_numpy(z).to(tdt)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = tv.decode(zt).float().numpy()
    assert Counter(n for n, _ in sites) == {"conv3x3_int8": 9}
    assert out.shape == (1, 16, 32, 3) and np.abs(ref).max() > 0.5

    def forced():
        """Each block fed JAX's input to it: {block: (rel L2, max abs / max|ref|)}."""
        errs, hooks = {}, []
        for key, want in blocks.items():
            def hook(mod, inputs, output, key=key, want=want):
                got = output.float().numpy()
                errs[key] = (rel_l2(got, want), rel_err(got, want))
                return torch.from_numpy(want).to(output.dtype)

            hooks.append(tv.decoder.get_submodule(_vae_module(key)).register_forward_hook(hook))
        with torch.no_grad():
            tv.decode(zt)
        for h in hooks:
            h.remove()
        assert errs.keys() == blocks.keys() and len(errs) == 7
        return errs

    errs = forced()
    with int8_activations_off():
        control = forced()
        with torch.no_grad():
            control_out = tv.decode(zt).float().numpy()
    int8_blocks = [k for k in blocks if k != "up_0_block_1"]  # its two convs are 32 -> 32: both fall back
    if dtype == "float32":
        assert rel_l2(out, ref) < FP32_L2 < rel_l2(control_out, ref)
        assert max(e[0] for e in errs.values()) < FP32_L2, errs
        assert min(control[k][0] for k in int8_blocks) > FP32_L2, control
    else:
        assert max(e[1] for e in errs.values()) < BF16_REL, errs
        assert rel_l2(out, ref) < 6e-2


def test_full_width_int8_decoder_keys_match_jax():
    """At full width, on ``meta``: the int8 decoder's int8 weights and their
    scales are exactly JAX's int8 kernels and kernel scales (the res-block
    convs, the upsample convs and the two nin_shortcuts; conv_in, conv_out,
    the attention block and the encoder stay fp in both), under the SD key
    names."""
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD

    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig

    struct = jax.eval_shape(JV(ddconfig=JD(), embed_dim=4, quant_decoder=True).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    qstruct = jax.eval_shape(lambda p: jq.quantize_params_like(struct, p), struct)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), qstruct)
    want = {k[len("first_stage_model."): -len(".weight")] for k, v in state_dict_from_flax({"vae": zeros}).items()
            if v.dtype == torch.int8}
    with torch.device("meta"):
        ours = AutoencoderKL(DDConfig(), 4, dtype=torch.bfloat16, quant_decoder=True).state_dict()
    int8 = {k[: -len(".weight")] for k, v in ours.items() if v.dtype == torch.int8}
    scales = {k[: -len(".weight_scale")] for k in ours if k.endswith(".weight_scale")}
    assert int8 == scales == want
    assert len(int8) == 4 + 4 * 3 * 2 + 3 + 2  # middle, up-level res convs, upsample convs, nin_shortcuts
    assert {"decoder.conv_in", "decoder.conv_out"}.isdisjoint(int8) and "decoder.up.0.block.0.nin_shortcut" in int8


def _exp_dir(tmp_path):
    (tmp_path / "model_config.yaml").write_text(MODEL_YAML)
    return str(tmp_path)


def test_initialize_model_quant_vae(tmp_path):
    """``initialize_model(quant_vae=True)`` on the CPU: the decoder's int8
    sites hold the fp pipeline's weights quantized per output channel
    (``quantize_params_like``), every other weight equal; with
    ``quantized`` too, the UNet is int8 as well.  A short request through
    each is a finite canvas; the int8 decoder's canvas differs from the fp
    one, and stays near it."""
    from leftrefill_torch.serving import gradio_app as ts
    from test_torch_serving import _inputs

    exp = _exp_dir(tmp_path)
    pipe = ts.initialize_model(exp, device="cpu")
    q = ts.initialize_model(exp, quant_vae=True, device="cpu")
    both = ts.initialize_model(exp, quantized=True, quant_vae=True, sampler="dpm++2m", device="cpu")
    assert q.model.first_stage_model.quant_decoder and not pipe.model.first_stage_model.quant_decoder
    fp_sd, q_sd = pipe.model.state_dict(), q.model.state_dict()
    fp_vae = {k[len("first_stage_model."):]: v for k, v in fp_sd.items() if k.startswith("first_stage_model.")}
    want = tq.quantize_params_like(q.model.first_stage_model, fp_vae)
    assert sum(v.dtype == torch.int8 for v in want.values()) == 4 + 2 * 2 * 2 + 1 + 1  # as at full width
    for k, v in q_sd.items():
        ref = want[k[len("first_stage_model."):]] if k.startswith("first_stage_model.") else fp_sd[k]
        assert v.dtype == ref.dtype and torch.equal(v, ref), k
    assert any(v.dtype == torch.int8 for k, v in both.model.state_dict().items() if k.startswith("model."))
    assert all(torch.equal(v, q_sd[k]) for k, v in both.model.state_dict().items()
               if k.startswith("first_stage_model."))
    reference, source, sketch = _inputs(4, ((32, 32), (32, 32)), False)
    outs = [ts.predict(p, reference, source, sketch, ddim_steps=2, img_size=32, seed=1)[0] for p in (pipe, q, both)]
    assert all(o.shape == (32, 32, 3) and o.dtype == np.uint8 for o in outs)
    diff = np.abs(outs[0].astype(int) - outs[1].astype(int))
    assert 0 < diff.max() and diff.mean() < 8


def test_load_over_base_quantizes_the_decoder(tmp_path):
    """An SD-layout state dict of fp weights loads over the int8-decoder
    bundle through ``load_over_base`` with nothing missing or unexpected;
    the decoder's int8 sites take the checkpoint's weights quantized per
    output channel, as the bundle is built."""
    from leftrefill_torch.convert.checkpoint import load_over_base
    from leftrefill_torch.pipeline import fill_random_
    from leftrefill_torch.serving import gradio_app as ts

    exp = _exp_dir(tmp_path)
    fp = ts.initialize_model(exp, device="cpu").model
    fill_random_(fp, torch.Generator().manual_seed(9))
    ckpt = {k: v.clone() for k, v in fp.state_dict().items()}
    q = ts.initialize_model(exp, quant_vae=True, device="cpu").model
    report = load_over_base(q, ckpt)
    assert report["missing"] == [] and report["unexpected"] == [] and report["shape_mismatch"] == []
    fp_vae = {k[len("first_stage_model."):]: v for k, v in ckpt.items() if k.startswith("first_stage_model.")}
    want = tq.quantize_params_like(q.first_stage_model, fp_vae)
    for k, v in q.first_stage_model.state_dict().items():
        assert torch.equal(v, want[k].to(v.dtype)), k


def test_build_sd2_bundle_quant_vae_on_meta():
    """``build_sd2_inpaint_bundle(quant_vae=True)``: the full-width bundle's
    decoder is the int8 one, its UNet fp unless ``quant`` too."""
    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

    model = build_sd2_inpaint_bundle("meta", torch.bfloat16, None, quant_vae=True)
    sd = model.state_dict()
    assert sum(v.dtype == torch.int8 for k, v in sd.items() if k.startswith("first_stage_model.decoder.")) == 33
    assert not any(v.dtype == torch.int8 for k, v in sd.items() if not k.startswith("first_stage_model."))
    both = build_sd2_inpaint_bundle("meta", torch.bfloat16, None, quant=True, quant_vae=True).state_dict()
    assert any(v.dtype == torch.int8 for k, v in both.items() if k.startswith("model.diffusion_model."))
