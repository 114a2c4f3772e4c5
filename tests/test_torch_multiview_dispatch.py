"""The full-width multi-view UNet's flash dispatch (64x64 latents per view,
the 512x512 views of ``configs/multiview_ref_inpainting.yaml``, CFG batch
2·V rows, bf16, cross-attention K/V cache) against the JAX package's own
dispatch, read with ``jax.eval_shape`` under a forced TPU dispatch as
tests/test_dispatch_structure.py reads it: nothing is executed on either
side (the port runs on torch's ``meta`` device)."""

from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from leftrefill_torch import kernels


def _jax_flash_calls(monkeypatch, view_num: int) -> Counter:
    """Nk of every flash forward JAX's multi-view UNet launches, and which
    kernel: K1 (resident K/V) or K11 (streamed)."""
    import leftrefill_tpu.ops.attention as attn_mod
    import leftrefill_tpu.ops.conv as conv_mod
    import leftrefill_tpu.ops.flash_attention as fa

    from leftrefill_tpu.models.multiview import MultiViewUnetModel

    class _FakeJax:  # attention._flash_qualifies reads jax.devices() inline
        def __getattr__(self, n):
            return getattr(jax, n)

        def devices(self):
            return [SimpleNamespace(platform="tpu")]

    monkeypatch.setattr(conv_mod, "on_tpu", lambda: True)
    monkeypatch.setattr(attn_mod, "jax", _FakeJax())
    calls = Counter()

    def flash(q, k, v, scale, blk_cap=None, _f=fa._flash_forward):
        calls["K11" if fa._kv_chunk_for(k.shape[2]) is not None else "K1", k.shape[2]] += 1
        return _f(q, k, v, scale, blk_cap)

    m = MultiViewUnetModel(view_num=view_num, dtype=jnp.bfloat16)
    rows = 2 * view_num
    x = jax.ShapeDtypeStruct((rows, 64, 64, 9), jnp.bfloat16)
    t = jax.ShapeDtypeStruct((rows,), jnp.int32)
    ctx = jax.ShapeDtypeStruct((rows, 77, 1024), jnp.bfloat16)
    struct = jax.eval_shape(m.init, jax.random.PRNGKey(0), x, t, ctx)["params"]
    monkeypatch.setattr(fa, "_flash_forward", flash)
    out = jax.eval_shape(lambda p, a, b, c: m.apply({"params": p}, a, b, c), struct, x, t, ctx)
    assert out.shape == (rows, 64, 64, 4)
    return calls


@pytest.mark.parametrize("view_num,expected", [
    (4, {("K11", 16384): 5, ("K1", 4096): 5, ("K1", 1024): 5, ("K1", 256): 1}),
    (2, {("K1", 8192): 5, ("K1", 2048): 5, ("K1", 512): 5}),
])
def test_full_width_multiview_flash_counts_match_jax(monkeypatch, view_num, expected):
    """V=4: 16 flash forwards, the five ds-1 joint attentions at 16384
    tokens on K11's path and the 256-token mid block among them; V=2: 15,
    the 128-token mid block below the rule.  The port's counts per Nk equal
    JAX's, and its K1 covers K11's sites."""
    from leftrefill_torch.models.multiview import MultiViewUnetModel

    ref = _jax_flash_calls(monkeypatch, view_num)
    assert ref == expected
    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    rows = 2 * view_num
    with torch.device("meta"):
        unet = MultiViewUnetModel(view_num=view_num, dtype=torch.bfloat16)
        x = torch.empty(rows, 64, 64, 9)
        ts = torch.empty(rows, dtype=torch.long)
        ctx = torch.empty(rows, 77, 1024)
    with torch.no_grad(), kernels.record_sites() as sites:
        out = unet(x, ts, ctx, cross_kv=unet.cross_kv(ctx))
    assert out.shape == (rows, 64, 64, 4)
    flash = Counter(shape[3] for name, shape in sites if name == "flash_fwd")
    assert flash == Counter({nk: n for (_, nk), n in ref.items()})
    # the ds-1 joint attention: each CFG half's V views folded into one row
    assert {shape[:4] for name, shape in sites if name == "flash_fwd" and shape[3] == 4096 * view_num} == {
        (2, 5, 4096 * view_num, 4096 * view_num)}
