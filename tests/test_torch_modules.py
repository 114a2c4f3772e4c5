"""The port's layers, transformer block, VAE and prompt embedder against the
JAX package on the CPU, in fp32, with the same seeded weights and inputs.
Tolerance 1e-5 relative to max|ref| (see test_torch_parity_utils)."""

import jax
import numpy as np
import pytest
import torch

from test_torch_parity_utils import FP32_REL, init_flax, j, load_port, rel_err, t

from leftrefill_torch.convert.from_jax import state_dict_from_flax
from leftrefill_torch.ops import layers as tl


def _load_sub(module, params, root="unet"):
    """Load a flax sub-tree (keys relative to ``module``) into a port module."""
    sd = state_dict_from_flax({root: params})
    cut = len({"unet": "model.diffusion_model.", "vae": "first_stage_model."}[root])
    module.load_state_dict({k[cut:]: v for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("c,eps", [(64, 1e-5), (24, 1e-6)])
def test_group_norm32_matches_jax(c, eps):
    from leftrefill_tpu.ops.layers import group_norm32

    rng = np.random.RandomState(c)
    x = rng.standard_normal((2, 4, 6, c)).astype(np.float32) * 3 + 1
    s = 1 + 0.1 * rng.standard_normal(c).astype(np.float32)
    b = 0.1 * rng.standard_normal(c).astype(np.float32)
    ref = group_norm32(j(x), j(s), j(b), num_groups=32, eps=eps)
    out = tl.group_norm32(t(x), t(s), t(b), num_groups=32, eps=eps)
    assert rel_err(out, ref) < FP32_REL


@pytest.mark.parametrize("dim", [320, 7])
def test_timestep_embedding_int_and_float_t(dim):
    from leftrefill_tpu.ops.layers import timestep_embedding

    ti = np.array([0, 1, 500, 999], np.int32)
    tf = np.array([998.999, 450.25, 0.5, 13.0], np.float32)
    for ts, tt in ((ti, torch.from_numpy(ti.astype(np.int64))), (tf, t(tf))):
        ref = timestep_embedding(j(ts), dim)
        out = tl.timestep_embedding(tt, dim)
        assert out.shape == ref.shape
        # fp32 cos/sin at arguments up to ~1000, where one ulp of the argument
        # is 6e-5: the two libraries' trig and exp may each differ by an ulp
        assert np.abs(out.numpy() - np.asarray(ref)).max() < 2e-4


@pytest.mark.parametrize("out_hw", [(8, 16), (10, 12)])
def test_nearest_resize_matches_jax(out_hw):
    from leftrefill_tpu.ops.layers import nearest_resize

    x = np.random.RandomState(0).standard_normal((2, 32, 64, 1)).astype(np.float32)
    assert np.array_equal(tl.nearest_resize(t(x), out_hw).numpy(), np.asarray(nearest_resize(j(x), out_hw)))


def test_sd2_width_transformer_block_matches_jax():
    """dim 320, 5 heads x 64, 256 tokens, context 1024 x 77: the ds1 block."""
    from leftrefill_tpu.models.unet import BasicTransformerBlock as JB

    from leftrefill_torch.models.unet import BasicTransformerBlock as TB

    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 256, 320)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 1024)).astype(np.float32)
    jb = JB(dim=320, n_heads=5, d_head=64, context_dim=1024)
    p = init_flax(jb, 4, j(x), j(ctx))
    ref = jax.jit(lambda p, a, c: jb.apply({"params": p}, a, c))(p, j(x), j(ctx))
    tb = _load_sub(TB(320, 5, 64, 1024), p)
    with torch.no_grad():
        out = tb(t(x), t(ctx))
    assert rel_err(out, ref) < FP32_REL


def test_tiny_vae_encode_decode_matches_jax():
    """Encode with the JAX package's fixed-key posterior noise injected, then
    decode the sample."""
    from leftrefill_tpu.models.autoencoder import AutoencoderKL as JV, DDConfig as JD, DiagonalGaussian as JG

    from leftrefill_torch.models.autoencoder import AutoencoderKL as TV, DDConfig as TD, DiagonalGaussian as TG

    cfg = dict(z_channels=4, resolution=64, ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(32,))
    jv = JV(ddconfig=JD(**cfg), embed_dim=4)
    x = np.random.RandomState(5).uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)
    p = init_flax(jv, 6, j(x))
    mom = jax.jit(lambda p, a: jv.apply({"params": p}, a, method=jv.encode_moments))(p, j(x))
    z_ref = JG(mom).sample()
    dec_ref = jax.jit(lambda p, z: jv.apply({"params": p}, z, method=jv.decode))(p, z_ref)
    noise = jax.random.normal(jax.random.PRNGKey(JG.FIXED_SEED), z_ref.shape)

    tv = _load_sub(TV(TD(**cfg), embed_dim=4), p, root="vae")
    with torch.no_grad():
        z = TG(tv.encode_moments(t(x))).sample(t(noise))
        dec = tv.decode(t(z_ref))
    assert rel_err(z, z_ref) < FP32_REL
    assert rel_err(dec, dec_ref) < FP32_REL


def test_tiny_prompt_clip_embedder_matches_jax():
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder as JC, build_prompt_tokenizer as jtok

    from leftrefill_torch.models.clip import PromptCLIPEmbedder as TC, build_prompt_tokenizer

    cfg = dict(vocab_size=49408, width=24, heads=2, layers=3, num_special_tokens=4)
    jc = JC(**cfg)
    with pytest.warns(UserWarning):
        tok, sp, _ = build_prompt_tokenizer([f"<special-token{i}>" for i in range(4)])
    jt, jsp, _ = jtok([f"<special-token{i}>" for i in range(4)], None)
    assert sp == jsp
    ids = np.concatenate([tok.tokenize(" ".join(sp)), tok.tokenize("a photo")])
    assert np.array_equal(ids, np.concatenate([jt.tokenize(" ".join(jsp)), jt.tokenize("a photo")]))
    assert (ids >= 49408).any()
    p = init_flax(jc, 7, j(ids))
    ref = jax.jit(lambda p, i: jc.apply({"params": p}, i))(p, j(ids))
    tc = load_port(TC(**cfg), "cond", p)
    with torch.no_grad():
        out = tc(torch.from_numpy(ids.astype(np.int64)))
    assert out.dtype == torch.float32
    assert rel_err(out, ref) < FP32_REL


def test_q_sample_matches_jax():
    """The forward-diffusion draw at the schedule's ends and middle."""
    from test_torch_parity_utils import tiny_bundles

    jm, _, tm, _, _ = tiny_bundles()
    rng = np.random.RandomState(8)
    x, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = np.array([0, 500, 999])
    ref = jm.q_sample(j(x), j(ts.astype(np.int32)), j(noise))
    out = tm.q_sample(t(x), torch.from_numpy(ts), t(noise))
    assert out.dtype == torch.float32
    assert rel_err(out, ref) < FP32_REL
