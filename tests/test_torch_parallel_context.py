"""Context-parallel multi-view attention in the port (``parallel.context``,
``MultiViewUnetModel(view_group=...)``) on gloo CPU ranks
(``tools.dryrun.run_ranks``, rank bodies in ``tests/torch_parallel_ranks.py``)
against the one-rank port and the JAX package's ``parallel/context.py``, fp32:

- the 4-D joint attention at 4 ranks (B 2, V 4, HW 64, H 2, D 8) within
  1e-5 absolute of the one-rank joint attention and of JAX's
  ``context_parallel_joint_attention`` on a 4-device view mesh;
- the multi-view block (``tests/test_context_parallel.py``'s) at 2 ranks
  within 1e-5 of the one-rank block;
- the tiny V=2 multi-view UNet on a (data 2, view 2) layout of 4 ranks
  within 1e-4 of JAX's one-device UNet (``__graft_entry__.py``'s and
  ``tests/test_context_parallel.py``'s bound), on the same seeded weights;
- the attention refusing a gradient, and ``concat_target`` /
  ``no_rearrange_selfattn`` refusing a view group."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity_utils import init_flax, load_port, t

from leftrefill_torch.tools.dryrun import run_ranks

HERE = __file__.rsplit("/", 1)[0]
ATTN_ABS = 1e-5
UNET_ABS = 1e-4
TIMEOUT = 60


def _ranks(body: str, world: int, tmp_path, **kwargs):
    return run_ranks(f"torch_parallel_ranks:{body}", world, str(tmp_path), kwargs, timeout=TIMEOUT,
                     pythonpath=(HERE,))


def test_joint_attention_over_four_ranks_matches_one_rank_and_jax(tmp_path):
    """Readings: 0 against the one-rank attention, 3.3e-7 against JAX."""
    from leftrefill_tpu.parallel.context import context_parallel_joint_attention as jax_joint
    from leftrefill_tpu.parallel.context import make_view_mesh

    from leftrefill_torch.ops.attention import multi_head_attention

    b, v, hw, heads, d = 2, 4, 64, 2, 8
    rng = np.random.RandomState(0)
    q, k, vv = (rng.standard_normal((b, v, hw, heads * d)).astype(np.float32) for _ in range(3))
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"q": t(q), "k": t(k), "v": t(vv), "heads": heads}, inputs)
    outs = _ranks("joint_attention_body", 4, tmp_path, inputs=inputs)
    got = np.concatenate([o["out"] for o in outs], axis=1)
    one = multi_head_attention(*(t(a).reshape(b, v * hw, heads * d) for a in (q, k, vv)), heads)
    ref = np.asarray(jax_joint(make_view_mesh(4), jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv), heads))
    assert got.shape == (b, v, hw, heads * d)
    assert np.abs(got - one.numpy().reshape(got.shape)).max() < ATTN_ABS
    assert np.abs(got - ref).max() < ATTN_ABS


def _mv_run(tmp_path, world: int, n_data: int, build, state, args, view_num: int = 2):
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"build": build, "state": state, "args": args, "n_data": n_data, "view_num": view_num}, inputs)
    outs = _ranks("multiview_body", world, tmp_path, inputs=inputs)
    assert all(o["refused"] == 1 for o in outs)
    return [o["out"] for o in outs]


def _scene_major(parts: list, n_data: int, view_num: int) -> np.ndarray:
    """The ranks' rows of a (data, view) layout back in the batch's order:
    rank d * n_view + v holds views of block v of the scenes of block d."""
    n_view = len(parts) // n_data
    scenes = [np.stack(np.split(p, p.shape[0] // (view_num // n_view)), 0) for p in parts]  # [s, v_loc, ...]
    rows = [np.concatenate(scenes[d * n_view:(d + 1) * n_view], axis=1) for d in range(n_data)]
    full = np.concatenate(rows, axis=0)
    return full.reshape(-1, *full.shape[2:])


def test_multiview_block_over_two_ranks_matches_one_rank(tmp_path):
    """Readings: 0."""
    from leftrefill_torch.models.multiview import MultiViewBasicTransformerBlock
    from leftrefill_torch.pipeline import fill_random_

    build = functools.partial(MultiViewBasicTransformerBlock, 32, 2, 16, 24, view_num=2)
    blk = build()
    fill_random_(blk, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(1)
    x = t(rng.standard_normal((4, 64, 32)))  # (b=2)*(v=2) rows
    ctx = t(rng.standard_normal((4, 7, 24)))
    parts = _mv_run(tmp_path, 2, 1, build, blk.state_dict(), [x, ctx])
    with torch.no_grad():
        one = blk(x, ctx).numpy()
    assert np.abs(_scene_major(parts, 1, 2) - one).max() < ATTN_ABS


def test_multiview_unet_over_data_and_view_ranks_matches_jax(tmp_path):
    """Two scenes of V=2 views, 2 data x 2 view ranks.  Readings: 3.0e-6."""
    from leftrefill_tpu.models.multiview import MultiViewUnetModel as JMV

    from leftrefill_torch.models.multiview import MultiViewUnetModel

    kw = dict(in_channels=9, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=(1, 2),
              channel_mult=(1, 2), num_head_channels=8, context_dim=32)
    rng = np.random.RandomState(0)
    x = rng.standard_normal((4, 8, 16, 9)).astype(np.float32)
    ts = np.array([5, 5, 9, 9], np.int64)
    ctx = rng.standard_normal((4, 7, 32)).astype(np.float32)
    jm = JMV(view_num=2, **kw)
    params = init_flax(jm, 3, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x, ts, ctx))
    build = functools.partial(MultiViewUnetModel, view_num=2, **kw)
    state = load_port(build(), "unet", params).state_dict()
    parts = _mv_run(tmp_path, 4, 2, build, state, [t(x), torch.from_numpy(ts), t(ctx)])
    assert np.abs(_scene_major(parts, 2, 2) - ref).max() < UNET_ABS


@pytest.mark.parametrize("mode", ["concat_target", "no_rearrange_selfattn"])
def test_view_group_refuses_the_sequences_that_need_every_view(mode):
    from leftrefill_torch.models.multiview import MultiViewBasicTransformerBlock

    kw = dict(concat_target=True, no_rearrange_selfattn=mode == "no_rearrange_selfattn")
    with pytest.raises(ValueError, match="another rank holds"):
        MultiViewBasicTransformerBlock(32, 2, 16, 24, view_num=3, view_group=object(), **kw)
