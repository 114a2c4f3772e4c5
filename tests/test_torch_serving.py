"""The port's serving entry points (``leftrefill_torch/serving/gradio_app.py``
and the pipeline's ``tokens=`` / ``inpaint_right_half``) against the JAX
package's on the CPU:

- ``pad_to_multiple`` equal to JAX's;
- ``predict``'s canvas and mask (resize, binarisation, padding, stitching,
  the repeat over samples) bit-equal to what JAX's ``predict`` hands to
  ``inpaint_right_half``, for enlarged and shrunk inputs, grey and colour
  masks;
- ``predict`` end to end at the tiny fp32 bundle of
  ``test_torch_parity_utils.tiny_bundles`` (the tiny config of
  ``tests/test_serving.py``), both sides on JAX's start code, step noise and
  VAE noise: the right halves within 1e-4 absolute before the uint8 step
  (test_torch_parity_utils' canvas bound), at most one level apart after;
- the prompt override ``tokens=``, ``pipeline_variant``'s cache, and
  ``initialize_model`` on an experiment directory (the restore of its
  prompt checkpoint, the int8 UNet, the int8 VAE decoder that is not ported
  and ``dp_devices=2`` without a process group of two ranks);
- the gradio UI raising without gradio."""

import jax
import numpy as np
import pytest
import torch
from test_cli import MODEL_YAML
from test_torch_parity_utils import CANVAS_ABS, t, tiny_bundles

from leftrefill_torch.serving import gradio_app as ts

STEPS = 4


def _inputs(seed: int, sizes, colour_mask: bool):
    rng = np.random.RandomState(seed)
    (rh, rw), (sh, sw) = sizes
    reference = rng.randint(0, 256, (rh, rw, 3)).astype(np.uint8)
    source = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
    sketch = np.zeros((sh, sw, 3) if colour_mask else (sh, sw), np.uint8)
    sketch[sh // 4: 3 * sh // 4, sw // 5: 4 * sw // 5] = 255
    sketch[0, 0] = 1  # a faint stroke is a hole too
    return reference, source, sketch


@pytest.fixture(scope="module")
def bundles():
    from leftrefill_tpu.pipeline import RefInpaintPipeline as JP

    from leftrefill_torch.pipeline import RefInpaintPipeline

    jm, params, tm, tok, sp = tiny_bundles()
    jpipe = JP(model=jm, params=params, tokenizer=tok, special_tokens=sp, ddim_steps=STEPS, eta=1.0)
    pipe = RefInpaintPipeline(model=tm, tokenizer=tok, special_tokens=sp, device="cpu", ddim_steps=STEPS, eta=1.0)
    return jpipe, pipe


def test_pad_to_multiple_matches_jax():
    from leftrefill_tpu.serving.gradio_app import pad_to_multiple

    rng = np.random.RandomState(0)
    for shape in ((40, 50, 3), (64, 64, 3), (65, 1), (7, 130)):
        x = rng.rand(*shape).astype(np.float32)
        got = ts.pad_to_multiple(x)
        assert np.array_equal(got, pad_to_multiple(x)) and got.shape[0] % 64 == got.shape[1] % 64 == 0


@pytest.mark.parametrize("img_size, sizes, colour_mask", [
    (32, ((40, 50), (48, 44)), False),   # both shrink
    (64, ((40, 50), (48, 44)), True),    # both enlarge (OpenCV's area-coefficient bilinear)
    (40, ((33, 90), (41, 17)), False),   # one axis each way, padded to 64
])
def test_predict_canvas_matches_jax(bundles, monkeypatch, img_size, sizes, colour_mask):
    """What each ``predict`` hands to ``inpaint_right_half``: the canvas and
    mask bit-equal, the start code's shape equal."""
    from leftrefill_tpu.pipeline import RefInpaintPipeline as JP
    from leftrefill_tpu.serving.gradio_app import predict

    from leftrefill_torch.pipeline import RefInpaintPipeline

    jpipe, pipe = bundles
    seen = {}

    def capture(side):
        def fn(self, image, mask, key, **kw):
            seen[side] = (np.asarray(image), np.asarray(mask), tuple(kw["x_T"].shape))
            pad = image.shape[1]
            return np.zeros((image.shape[0], pad, pad, 3), np.float32)
        return fn

    monkeypatch.setattr(JP, "inpaint_right_half", capture("jax"))
    monkeypatch.setattr(RefInpaintPipeline, "inpaint_right_half", capture("port"))
    reference, source, sketch = _inputs(img_size, sizes, colour_mask)
    kw = dict(ddim_steps=STEPS, num_samples=2, scale=2.5, seed=7, img_size=img_size)
    ref = predict(jpipe, reference, source, sketch, **kw)
    got = ts.predict(pipe, reference, source, sketch, **kw)
    (ji, jmask, jshape), (pi, pmask, pshape) = seen["jax"], seen["port"]
    assert ji.dtype == pi.dtype == np.float32 and np.array_equal(ji, pi)
    assert np.array_equal(jmask, pmask) and jshape == pshape
    assert 0 < pmask.sum() < pmask.size / 2 and not pmask[:, :, : pmask.shape[2] // 2].any()
    assert len(got) == len(ref) == 2 and all(g.shape == (img_size, img_size, 3) and g.dtype == np.uint8 for g in got)


def _jax_draws(seed: int, shape):
    """JAX ``predict``'s start code and, from its key, the DDIM step noise
    and the VAE's fixed noise."""
    from leftrefill_tpu.models.autoencoder import DiagonalGaussian

    key = jax.random.PRNGKey(seed)
    x_T = jax.random.normal(key, shape)
    step_key, _ = jax.random.split(key)
    noise = [jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape) for i in range(STEPS)]
    vae_noise = jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape)
    return t(x_T), (lambda i, s: t(noise[i])), t(vae_noise)


def test_predict_end_to_end_matches_jax(bundles, monkeypatch):
    """Both ``predict``s at img_size 32, two samples; the port's
    ``inpaint_right_half`` is given JAX's draws in place of its own, and
    each side's fp32 right halves are kept for the comparison before
    uint8."""
    from leftrefill_tpu.pipeline import RefInpaintPipeline as JP
    from leftrefill_tpu.serving.gradio_app import predict

    from leftrefill_torch.pipeline import RefInpaintPipeline

    jpipe, pipe = bundles
    floats = {}
    j_orig, p_orig = JP.inpaint_right_half, RefInpaintPipeline.inpaint_right_half

    def jax_side(self, image, mask, key, **kw):
        floats["jax"] = j_orig(self, image, mask, key, **kw)
        return floats["jax"]

    def port_side(self, image, mask, generator, x_T):
        x_T, noise_fn, vae_noise = _jax_draws(7, tuple(x_T.shape))
        floats["port"] = p_orig(self, image, mask, generator, x_T=x_T, noise_fn=noise_fn, vae_noise=vae_noise)
        return floats["port"]

    monkeypatch.setattr(JP, "inpaint_right_half", jax_side)
    monkeypatch.setattr(RefInpaintPipeline, "inpaint_right_half", port_side)
    reference, source, sketch = _inputs(1, ((40, 50), (48, 44)), False)
    kw = dict(ddim_steps=STEPS, num_samples=2, scale=2.5, seed=7, img_size=32)
    ref = predict(jpipe, reference, source, sketch, **kw)
    got = ts.predict(pipe, reference, source, sketch, **kw)
    assert floats["port"].shape == floats["jax"].shape == (2, 64, 64, 3)  # 32 padded to 64 by edge repetition
    assert np.abs(floats["port"] - np.asarray(floats["jax"])).max() < CANVAS_ABS
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8 and np.abs(g.astype(int) - r.astype(int)).max() <= 1


def test_predict_is_seeded(bundles):
    """The port's own draws: the same seed twice gives the same samples, two
    seeds differ (``torch.Generator`` draws: other images than JAX's)."""
    _, pipe = bundles
    reference, source, sketch = _inputs(2, ((32, 32), (32, 32)), False)
    kw = dict(ddim_steps=STEPS, num_samples=1, scale=2.5, img_size=32)
    a = ts.predict(pipe, reference, source, sketch, seed=7, **kw)[0]
    assert np.array_equal(a, ts.predict(pipe, reference, source, sketch, seed=7, **kw)[0])
    assert not np.array_equal(a, ts.predict(pipe, reference, source, sketch, seed=8, **kw)[0])


def test_tokens_override(bundles):
    """``tokens=`` equal to the prompt's gives the same canvas; other tokens
    another one (the same draws each time)."""
    _, pipe = bundles
    rng = np.random.RandomState(3)
    image = rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)
    mask = np.zeros((1, 32, 64, 1), np.float32)
    mask[:, 4:28, 36:60] = 1

    def run(**kw):
        x_T, noise_fn, vae_noise = _jax_draws(1, (1, 16, 32, 4))
        return pipe(image, mask, x_T=x_T, noise_fn=noise_fn, vae_noise=vae_noise, **kw)

    base = run()
    assert torch.equal(base, run(tokens=pipe.prompt_tokens(1)))
    assert not torch.allclose(base, run(tokens=pipe.uncond_tokens(1)))
    x_T, noise_fn, vae_noise = _jax_draws(1, (1, 16, 32, 4))
    right = pipe.inpaint_right_half(image, mask, x_T=x_T, noise_fn=noise_fn, vae_noise=vae_noise)
    assert isinstance(right, np.ndarray) and np.array_equal(right, base[:, :, 32:].numpy())


def test_pipeline_variant_cache(bundles):
    _, pipe = bundles
    assert ts.pipeline_variant(pipe, pipe.ddim_steps, pipe.guidance_scale) is pipe
    v = ts.pipeline_variant(pipe, 10, 3.0, "dpm++2m")
    assert (v.ddim_steps, v.guidance_scale, v.sampler, v.eta) == (10, 3.0, "dpm++2m", pipe.eta)
    assert v is ts.pipeline_variant(pipe, 10, 3.0, "dpm++2m") and v.model is pipe.model
    assert ts.pipeline_variant(pipe, 10, 3.0) is not v and (pipe.ddim_steps, pipe.sampler) == (STEPS, "ddim")


def _exp_dir(tmp_path, table=None):
    from leftrefill_torch.train.checkpoints import CheckpointManager

    (tmp_path / "model_config.yaml").write_text(MODEL_YAML)
    if table is not None:
        CheckpointManager(str(tmp_path / "ckpts")).save_last(3, {"cond_stage_model.special_embeddings.weight": table})
    return str(tmp_path)


def test_initialize_model_restores_and_quantizes(tmp_path):
    """The tiny experiment directory on the CPU: random weights (seed 42),
    the prompt checkpoint restored over them, and ``quantized=True``'s int8
    UNet with the other weights equal; a short request through each."""
    from leftrefill_torch.models.unet import UNetModel

    table = torch.randn((4, 24), generator=torch.Generator().manual_seed(0))
    exp = _exp_dir(tmp_path, table)
    pipe = ts.initialize_model(exp, device="cpu")
    assert torch.equal(pipe.model.cond_stage_model.special_embeddings.weight, table)
    assert (pipe.eta, pipe.sampler, str(pipe.device), pipe.model.unet.dtype) == (1.0, "ddim", "cpu", torch.float32)
    q = ts.initialize_model(exp, quantized=True, sampler="dpm++2m", device="cpu")
    assert isinstance(q.model.unet, UNetModel) and any(p.dtype == torch.int8 for p in q.model.unet.state_dict().values())
    assert torch.equal(q.model.cond_stage_model.special_embeddings.weight, table)
    vae = {k: v for k, v in pipe.model.state_dict().items() if k.startswith("first_stage_model.")}
    assert all(torch.equal(v, q.model.state_dict()[k]) for k, v in vae.items())
    reference, source, sketch = _inputs(4, ((32, 32), (32, 32)), False)
    for p in (pipe, q):
        out = ts.predict(p, reference, source, sketch, ddim_steps=2, img_size=32, seed=1)
        assert out[0].shape == (32, 32, 3) and out[0].dtype == np.uint8


def test_initialize_model_refuses_what_is_not_ported(tmp_path):
    exp = _exp_dir(tmp_path)
    with pytest.raises(NotImplementedError, match="int8 VAE decoder"):
        ts.initialize_model(exp, quant_vae=True, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):  # dp_devices=2 needs a process group of two ranks
        ts.initialize_model(exp, dp_devices=2, device="cpu")


def test_gradio_ui_needs_gradio(bundles, tmp_path):
    """gradio is on neither machine: the UI and ``main`` raise ImportError
    (the latter before building a model); the headless API serves (above)."""
    with pytest.raises(ImportError, match="gradio"):
        ts.build_ui(bundles[1])
    with pytest.raises(ImportError, match="gradio"):
        ts.main(["--model_path", str(tmp_path / "missing"), "--device", "cpu"])
