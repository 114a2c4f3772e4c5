"""The port's parameter converter, its full-width key inventories, its
kernel dispatch at full width (all on torch's ``meta`` device: nothing is
executed), and the port's independence from jax/flax."""

import ast
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import init_flax, load_port

from leftrefill_tpu.convert.torch_to_flax import (
    _leaf_transform,
    convert_state_dict,
    map_clip_key,
    map_unet_key,
    map_vae_key,
)
from leftrefill_torch import kernels
from leftrefill_torch.convert.from_jax import state_dict_from_flax

REPO = Path(__file__).resolve().parent.parent
TINY_UNET = dict(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=24)
TINY_VAE = dict(z_channels=4, resolution=64, ch=16, ch_mult=(1, 2), num_res_blocks=1)
TINY_CLIP = dict(vocab_size=49408, width=24, heads=2, layers=2, num_special_tokens=4)
PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.", "cond": "cond_stage_model."}
MAPS = {"unet": map_unet_key, "vae": map_vae_key, "cond": map_clip_key}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _jax_modules(full: bool):
    from leftrefill_tpu.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_tpu.models.clip import PromptCLIPEmbedder
    from leftrefill_tpu.models.unet import UNetModel

    if full:
        return UNetModel(), AutoencoderKL(ddconfig=DDConfig(), embed_dim=4), PromptCLIPEmbedder()
    return (UNetModel(**TINY_UNET), AutoencoderKL(ddconfig=DDConfig(**TINY_VAE), embed_dim=4),
            PromptCLIPEmbedder(**TINY_CLIP))


def _port_modules(full: bool):
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.unet import UNetModel

    if full:
        return {"unet": UNetModel(), "vae": AutoencoderKL(DDConfig(), embed_dim=4),
                "cond": PromptCLIPEmbedder()}
    return {"unet": UNetModel(**TINY_UNET), "vae": AutoencoderKL(DDConfig(**TINY_VAE), embed_dim=4),
            "cond": PromptCLIPEmbedder(**TINY_CLIP)}


def _init_args(root, unet_ctx):
    h, w = 8, 16  # spatial size does not change the param trees
    if root == "unet":
        return jnp.zeros((1, h, w, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, unet_ctx))
    if root == "vae":
        return (jnp.zeros((1, 8 * h, 8 * w, 3)),)
    return (jnp.zeros((1, 77), jnp.int32),)


def test_converter_is_the_exact_inverse_of_torch_to_flax():
    ju, jv, jc = _jax_modules(full=False)
    params = {
        root: init_flax(m, seed, *_init_args(root, 24))
        for seed, (root, m) in enumerate((("unet", ju), ("vae", jv), ("cond", jc)))
    }
    sd = state_dict_from_flax(params)
    back, skipped = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    assert not skipped
    for root in ("unet", "vae", "cond"):
        a, b = _flat(back[root]), _flat(jax.tree_util.tree_map(np.asarray, params[root]))
        assert a.keys() == b.keys(), root
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (root, k)
    # and the port's modules take the converted keys exactly
    for root, module in _port_modules(full=False).items():
        load_port(module, root, params[root])


@pytest.mark.parametrize("root", ["unet", "vae", "cond"])
def test_full_width_key_inventory_matches_flax(root):
    """The port's full-width state_dict (SD2 UNet 686 keys, f8 VAE, ViT-H text
    tower), mapped through torch_to_flax's key maps on shapes only, equals
    the flax eval_shape tree."""
    with torch.device("meta"):
        module = _port_modules(full=True)[root]
    ours = {}
    for k, v in module.state_dict().items():
        path = MAPS[root](k)
        assert path is not None, k
        path, arr = _leaf_transform(path, np.broadcast_to(np.float32(0), tuple(v.shape)))
        ours[tuple(path)] = tuple(arr.shape)
    if root == "unet":
        assert len(ours) == 686
    jm = dict(zip(("unet", "vae", "cond"), _jax_modules(full=True)))[root]
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *_init_args(root, 1024))["params"]
    ref = {k: tuple(v.shape) for k, v in _flat(struct).items()}
    assert ours == ref


@pytest.mark.parametrize(
    "dtype,cfg_dup,expected",
    [
        (torch.bfloat16, True, {"conv3x3": 33, "flash_fwd": 15, "geglu": 16, "group_norm": 60}),
        (torch.bfloat16, False, {"conv3x3": 33, "flash_fwd": 15, "geglu": 16, "group_norm": 60}),
        # conv and GEGLU kernels are bf16-only, as in JAX, and so are K1 and
        # the GroupNorm kernel
        (torch.float32, True, {}),
    ],
)
def test_full_width_dispatch_counts(monkeypatch, dtype, cfg_dup, expected):
    """One full-width CFG-batch-2 forward (64x128 latent, context 77x1024,
    cross-attention K/V cache on) reaches the kernels at 33 conv, 15 flash
    and 16 GEGLU sites in bf16 (the JAX package's Pallas counts), and the
    GroupNorm kernel at the 44 ResBlock and 16 SpatialTransformer norms (the
    output norm runs on the fp32 latent's dtype, on its plain version)."""
    from leftrefill_torch.models.unet import UNetModel

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    with torch.device("meta"):
        unet = UNetModel(dtype=dtype)
        x = torch.empty(2, 64, 128, 9)
        ts = torch.empty(2, dtype=torch.long)
        ctx = torch.empty(2, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx), cfg_dup=cfg_dup)
    assert out.shape == (2, 64, 128, 4)
    counts = Counter(name for name, _ in sites)
    assert counts == expected
    flash_n = Counter(shape[2] for name, shape in sites if name == "flash_fwd")
    assert flash_n == ({8192: 5, 2048: 5, 512: 5} if expected else {})


def test_port_imports_no_jax_or_flax():
    """Statically: no module of the port imports jax, flax or the JAX
    package (it keeps its own copies of the schedule tables and the
    tokenizer).  At run time: a fresh interpreter importing the pipeline
    loads neither jax, jaxlib, flax nor the JAX package."""
    for path in (REPO / "leftrefill_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "leftrefill_tpu"), f"{path}: imports {n}"
    code = (
        "import sys; before = set(sys.modules)\n"
        "import leftrefill_torch.pipeline, leftrefill_torch.kernels\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "assert not new & {'jax', 'flax', 'jaxlib', 'leftrefill_tpu'}, new\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
