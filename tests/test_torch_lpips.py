"""The port's LPIPS (``leftrefill_torch/eval/lpips.py``) against the JAX
package's on the CPU in fp32: seeded random weights carried across
(``convert.from_jax.lpips_from_flax``), and both loaders on files the test
writes under the lpips checkpoint's and torchvision AlexNet's key names.
Tolerance: 1e-5 relative (test_torch_parity_utils' fp32 module bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import FP32_REL, fill_tree, t

from leftrefill_torch.convert.from_jax import lpips_from_flax
from leftrefill_torch.eval.lpips import ALEX, ALEX_FEATURE_IDS, LPIPS, load_lpips_weights


def _images(seed: int, b: int = 2, hw: int = 64):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    return x, y


def _jax_lpips():
    from leftrefill_tpu.eval.lpips import LPIPS as JL

    return JL()


@pytest.mark.parametrize("hw", [64, 96])
def test_lpips_matches_jax(hw):
    """Seeded weights (the lin weights made non-negative, as trained ones
    are) on both sides, two image pairs; one pair identical (distance 0)."""
    jl = _jax_lpips()
    x, y = _images(hw, hw=hw)
    struct = jax.eval_shape(jl.init, jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), jnp.zeros((1, hw, hw, 3)))
    params = fill_tree(struct["params"], 7)
    params = {k: ({"kernel": np.abs(v["kernel"])} if k.startswith("lin") else v) for k, v in params.items()}
    ref = np.asarray(jl.apply({"params": params}, x, y))
    lp = LPIPS().eval()
    lp.load_state_dict(lpips_from_flax(params), strict=True)
    with torch.no_grad():
        got = lp(t(x), t(y)).numpy()
        same = lp(t(x), t(x)).numpy()
    assert got.shape == (2,) and (ref > 0).all()
    assert np.abs(got - ref).max() <= FP32_REL * np.abs(ref).max()
    assert np.abs(same).max() == 0.0


def test_load_lpips_weights_matches_jax(tmp_path):
    """``load_lpips_weights`` on an lpips checkpoint (``lin{i}.model.1.weight``)
    and a torchvision AlexNet state_dict the test writes: the same distances
    as JAX's loader on the same files; the ``lin{i}.weight`` spelling too,
    and the seeded fallback without AlexNet weights runs."""
    from leftrefill_tpu.eval.lpips import load_lpips_weights as jload

    g = torch.Generator().manual_seed(3)
    lin = {f"lin{i}.model.1.weight": torch.rand((1, ch, 1, 1), generator=g) for i, (ch, _, _, _) in enumerate(ALEX)}
    alex, cin = {}, 3
    for fi, (ch, k, _, _) in zip(ALEX_FEATURE_IDS, ALEX):
        alex[f"features.{fi}.weight"] = torch.randn((ch, cin, k, k), generator=g) / (cin * k * k) ** 0.5
        alex[f"features.{fi}.bias"] = 0.1 * torch.randn((ch,), generator=g)
        cin = ch
    torch.save(lin, tmp_path / "alex.pth")
    torch.save(alex, tmp_path / "alexnet.pth")
    x, y = _images(5)
    ref = np.asarray(_jax_lpips().apply({"params": jload(str(tmp_path / "alex.pth"), str(tmp_path / "alexnet.pth"))},
                                        x, y))
    lp = LPIPS().eval()
    lp.load_state_dict(load_lpips_weights(str(tmp_path / "alex.pth"), str(tmp_path / "alexnet.pth")), strict=True)
    with torch.no_grad():
        got = lp(t(x), t(y)).numpy()
    assert np.abs(got - ref).max() <= FP32_REL * np.abs(ref).max()
    torch.save({k.replace(".model.1", ""): v for k, v in lin.items()}, tmp_path / "plain.pth")
    assert torch.equal(load_lpips_weights(str(tmp_path / "plain.pth"), str(tmp_path / "alexnet.pth"))["lin3.weight"],
                       lin["lin3.model.1.weight"])
    fallback = LPIPS().eval()
    fallback.load_state_dict(load_lpips_weights(str(tmp_path / "alex.pth")), strict=True)
    with torch.no_grad():
        d = fallback(t(x), t(y))
    assert d.shape == (2,) and torch.isfinite(d).all() and (d > 0).all()
