"""The CFG-parallel serving path of the port (``parallel.batch``,
``RefInpaintPipeline(group=...)``, ``predict`` with ``dp_devices``) on gloo
CPU ranks (``tools.dryrun.run_ranks``, rank bodies in
``tests/torch_parallel_ranks.py``), against the port on one rank and the
JAX package's ``parallel/batch.py`` on this process's CPU devices, fp32 at
the tiny bundle of ``test_torch_parity_utils.tiny_bundles``:

- ``batch_parallel_apply`` with the K/V cache at 2 and 4 ranks: within 1e-6
  absolute of the port's one-rank ``apply_model`` on each rank's rows, within
  1e-5 of the largest value (``FP32_REL``) of its whole-batch
  ``apply_model`` (fp32 GEMMs over 4 rows and over 2 round differently:
  2.3e-6 of values up to ~2.6), and within ``tests/test_batch_parallel.py``'s
  atol 2e-4 / rtol 1e-4 of JAX's on a 2- and 4-device mesh; a batch that
  does not divide raises;
- the pipeline at 2 ranks, DDIM-4, on JAX's start code and noise: within
  1e-4 (``CANVAS_ABS``: a few sampler steps through UNet and VAE) of the
  port's one-rank pipeline and of JAX's ``RefInpaintPipeline`` on a
  2-device mesh;
- ``predict`` with ``dp_devices=2`` and ``serve_followers``: within one
  uint8 level of the one-rank ``predict`` (``tests/test_serving.py``'s
  bound), the follower serving each request and stopping on the stop
  message."""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_parity_utils import CANVAS_ABS, FP32_REL, j, t, tiny_bundles

from leftrefill_torch.tools.dryrun import run_ranks

HERE = __file__.rsplit("/", 1)[0]
APPLY_ABS = 1e-6
TIMEOUT = 60


def _ranks(body: str, world: int, tmp_path, **kwargs):
    return run_ranks(f"torch_parallel_ranks:{body}", world, str(tmp_path), kwargs, timeout=TIMEOUT,
                     pythonpath=(HERE,))


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


def _mesh(n):
    import jax

    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


@pytest.mark.parametrize("world", [2, 4])
def test_batch_parallel_apply_matches_one_rank_and_jax(bundles, tmp_path, world):
    """Readings (2 / 4 ranks): 0 against the one-rank port's rows, 2.3e-6 /
    2.0e-6 against its whole batch, 2.9e-6 / 2.9e-6 against JAX."""
    import jax

    from leftrefill_tpu.diffusion.core import Conditioning as JC
    from leftrefill_tpu.parallel.batch import batch_parallel_apply

    from leftrefill_torch.diffusion.core import Conditioning

    jm, params, tm, _, _ = bundles
    rng = np.random.RandomState(world)
    x = rng.standard_normal((4, 8, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 77, 24)).astype(np.float32)
    cc = rng.standard_normal((4, 8, 16, 5)).astype(np.float32)
    ts = np.array([3, 14, 159, 265], np.int64)
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"model": tm, "x": t(x), "t": torch.from_numpy(ts), "c_concat": t(cc), "ctx": t(ctx)}, inputs)
    outs = _ranks("apply_body", world, tmp_path, inputs=inputs)

    def one_rank(rows):
        with torch.no_grad():
            return tm.apply_model(t(x[rows]), torch.from_numpy(ts[rows]), Conditioning(t(cc[rows]), t(ctx[rows])),
                                  cross_kv=tm.cross_attention_kv(t(ctx[rows]))).numpy()

    n = 4 // world
    blocks = np.concatenate([one_rank(slice(r * n, (r + 1) * n)) for r in range(world)])
    whole = one_rank(slice(None))

    def jax_apply(p, x, ts, cc, ctx):
        kv = jm.cross_attention_kv(p, ctx)
        return batch_parallel_apply(jm, p, _mesh(world), cross_kv=kv)(x, ts, JC(cc, ctx))

    ref = np.asarray(jax.jit(jax_apply)(params, j(x), j(ts), j(cc), j(ctx)))
    for o in outs:
        assert o["raised"] == 1
        assert np.array_equal(o["out"], outs[0]["out"])
        assert np.abs(o["out"] - blocks).max() <= APPLY_ABS
        assert np.abs(o["out"] - whole).max() <= FP32_REL * np.abs(whole).max()
        np.testing.assert_allclose(o["out"], ref, atol=2e-4, rtol=1e-4)


def test_cfg_parallel_pipeline_matches_one_rank_and_jax(bundles, tmp_path):
    """Readings: 3.6e-6 against the one-rank port (which shares the CFG
    prefix), 3.2e-6 against JAX's mesh pipeline."""
    import jax

    from leftrefill_tpu.models.autoencoder import DiagonalGaussian
    from leftrefill_tpu.pipeline import RefInpaintPipeline as JP

    from leftrefill_torch.pipeline import RefInpaintPipeline, stitch_canvas

    jm, params, tm, tok, sp = bundles
    steps, seed = 4, 3
    rng = np.random.RandomState(seed)
    image, mask = stitch_canvas(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
                                rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
                                np.ones((1, 32, 32, 1), np.float32))
    shape = (1, 16, 32, 4)
    key = jax.random.PRNGKey(seed)
    step_key, init_key = jax.random.split(key)  # ddim_sample's own split
    x_T = jax.random.normal(init_key, shape)
    noise = [t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(step_key, 2), i), shape))
             for i in range(steps)]
    vae_noise = t(jax.random.normal(jax.random.PRNGKey(DiagonalGaussian.FIXED_SEED), shape))
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"model": tm, "tokenizer": tok, "special_tokens": sp, "steps": steps, "image": image, "mask": mask,
                "x_T": t(x_T), "noise": noise, "vae_noise": vae_noise}, inputs)
    outs = _ranks("pipeline_body", 2, tmp_path, inputs=inputs)
    one = RefInpaintPipeline(model=tm, tokenizer=tok, special_tokens=sp, device="cpu", ddim_steps=steps,
                             guidance_scale=2.5, eta=1.0)(image, mask, x_T=t(x_T), noise_fn=lambda i, s: noise[i],
                                                           vae_noise=vae_noise).numpy()
    jpipe = JP(model=jm, params=params, tokenizer=tok, special_tokens=sp, ddim_steps=steps, guidance_scale=2.5,
               eta=1.0, mesh=_mesh(2))
    ref = np.asarray(jpipe(image, mask, key, x_T=x_T))
    assert np.array_equal(outs[0]["out"], outs[1]["out"])
    got = outs[0]["out"]
    assert np.array_equal(got[:, :, :32], image[:, :, :32]) and not np.allclose(got[:, :, 32:], image[:, :, 32:])
    assert np.abs(got - one).max() < CANVAS_ABS
    assert np.abs(got - ref).max() < CANVAS_ABS


def test_predict_over_two_ranks_matches_one_rank(tmp_path):
    """Two requests from rank 0, the follower serving both then stopping.
    Readings: every pixel equal to the one-rank ``predict``."""
    from test_torch_serving import _exp_dir, _inputs

    from leftrefill_torch.serving import gradio_app as ga

    table = torch.randn((4, 24), generator=torch.Generator().manual_seed(0))
    exp = _exp_dir(tmp_path, table)
    requests = [(_inputs(4, ((32, 32), (32, 32)), False), 1), (_inputs(5, ((40, 30), (36, 44)), True), 2)]
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"requests": requests}, inputs)
    outs = _ranks("predict_body", 2, tmp_path, exp_dir=exp, inputs=inputs)
    assert outs[1]["served"] == 2
    pipe = ga.initialize_model(exp, device="cpu")
    for i, (req, seed) in enumerate(requests):
        one = np.stack(ga.predict(pipe, *req, ddim_steps=2, img_size=32, seed=seed))
        got = outs[0][f"out{i}"]
        assert got.shape == one.shape == (1, 32, 32, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - one.astype(int)).max() <= 1

