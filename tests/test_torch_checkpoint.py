"""The port's checkpoint loader (``leftrefill_torch.convert.checkpoint``)
against the JAX package's (``convert/torch_to_flax.py``) on files the tests
write: ``.ckpt``/``.pt`` and ``.safetensors`` (F32, F16 and BF16) read to the
same fp32 values, the same keys skipped by design, the same missing,
shape-mismatched and unexpected keys as JAX's ``merge_params`` under the
name map and the same merged weights, an int8 UNet loaded with its sites
quantized, and ``make_it_fit`` / ``zero_extend_input_conv`` as JAX's numpy
functions.  No checkpoint file is in the repo; none is downloaded."""

import json
import struct

import jax
import numpy as np
import pytest
import torch

from test_torch_nvs import _tiny_nvs_bundles

from leftrefill_torch.convert import checkpoint as ck
from leftrefill_torch.convert.from_jax import state_dict_from_flax

_ST_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int8: "I8"}


def write_safetensors(path, tensors: dict) -> None:
    """The safetensors layout: u64 header length, the JSON header, the raw
    little-endian buffer."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).contiguous().numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {"model.diffusion_model.out.2.weight": torch.randn(4, 8, 3, 3, generator=g),
            "first_stage_model.decoder.conv_out.bias": torch.randn(3, generator=g).half(),
            "cond_stage_model.special_embeddings.weight": torch.randn(5, 16, generator=g).bfloat16(),
            "betas": torch.linspace(0, 1, 7)}


@pytest.mark.parametrize("fmt", ["ckpt", "pt", "safetensors"])
def test_files_read_as_jax_reads_them(tmp_path, fmt):
    """Every tensor read as fp32, equal to JAX's reading of the same file and
    to the written values (BF16 and F16 exactly widened)."""
    from leftrefill_tpu.convert.torch_to_flax import load_torch_state_dict as jload

    tensors = _sample_tensors()
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "safetensors":
        write_safetensors(path, tensors)
    else:
        torch.save({"state_dict": tensors, "global_step": 3} if fmt == "ckpt" else tensors, path)
    ours, ref = ck.load_torch_state_dict(path), jload(path)
    assert ours.keys() == ref.keys() == tensors.keys()
    for k, v in ours.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), np.asarray(ref[k], np.float32)), k
        assert torch.equal(v, tensors[k].float()), k


def test_skipped_keys_match_jax():
    """The schedule buffers, ``model_ema.*``, keys outside the four roots and
    the text tower's unused entries are skipped, as JAX's converter skips
    them; the model's own keys are not."""
    from leftrefill_tpu.convert.torch_to_flax import convert_state_dict

    keys = ["betas", "alphas_cumprod", "logvar", "cond_ids", "model_ema.decay",
            "model_ema.diffusion_modelinput_blocks00weight", "global_step_buffer",
            "cond_stage_model.model.text_projection", "cond_stage_model.model.logit_scale",
            "cond_stage_model.model.attn_mask", "model.diffusion_model.out.2.bias",
            "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight",
            "cond_stage_model.rel_pos_model.mlp1.0.weight", "refinement_alpha", "refinement_model.3.bias",
            "first_stage_model.encoder.conv_in.weight", "cond_stage_model.special_embeddings.weight"]
    sd = {k: np.zeros((2, 2), np.float32) for k in keys}
    sd["refinement_alpha"] = np.zeros((), np.float32)
    _, skipped = convert_state_dict(sd)
    assert {k for k in keys if ck.skipped(k)} == set(skipped)
    assert len(skipped) == 10


def _jax_name(key: str, shape) -> str:
    """A checkpoint key as JAX's ``merge_params`` names it ("/unet/a/b")."""
    from leftrefill_tpu.convert.torch_to_flax import convert_state_dict

    tree, skipped = convert_state_dict({key: np.zeros(shape, np.float32)})
    assert not skipped, key
    (path, _), = jax.tree_util.tree_leaves_with_path(tree)
    return "/" + "/".join(str(p.key) for p in path)


def test_load_report_and_weights_match_jax_merge_params():
    """A checkpoint of another seed with keys removed (one of each root),
    one at another shape, an unexpected one and skipped ones, loaded over
    the tiny NVS bundle: the port's missing, shape-mismatched and unexpected
    keys are JAX's under the name map, and the loaded bundle is JAX's merged
    tree."""
    from leftrefill_tpu.convert.torch_to_flax import convert_state_dict, merge_params

    _, base_params, bundle = _tiny_nvs_bundles(seed=0)
    _, other, _ = _tiny_nvs_bundles(seed=20)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(other).items()}
    for k in ("model.diffusion_model.input_blocks.1.0.in_layers.2.weight", "first_stage_model.decoder.conv_out.bias",
              "cond_stage_model.special_embeddings.weight", "refinement_model.17.weight"):
        del sd[k]
    sd["model.diffusion_model.out.2.bias"] = np.zeros(5, np.float32)
    sd["model.diffusion_model.input_blocks.0.0.extra"] = np.ones(3, np.float32)
    sd["betas"], sd["model_ema.num_updates"] = np.ones(1000, np.float32), np.ones((), np.float32)
    loaded, _ = convert_state_dict(sd)
    merged, missing, unexpected = merge_params(base_params, loaded)
    report = ck.load_over_base(bundle.model, {k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    own = bundle.model.state_dict()
    assert sorted(report["skipped"]) == ["betas", "model_ema.num_updates"]
    assert {_jax_name(k, own[k].shape) for k in report["missing"]} | \
        {_jax_name(s.split(" (shape")[0], own[s.split(" (shape")[0]].shape) for s in report["shape_mismatch"]} == \
        {m.split(" (shape")[0] for m in missing}
    assert len(report["missing"]) == 4 and len(report["shape_mismatch"]) == 1
    assert {_jax_name(k, sd[k].shape) for k in report["unexpected"]} == set(unexpected) and len(unexpected) == 1
    expect = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, merged))
    assert expect.keys() == own.keys()
    for k, v in own.items():
        assert torch.equal(v, expect[k]), k


def test_int8_unet_loads_quantized():
    """Over an int8 UNet the checkpoint's fp weights are quantized per output
    channel at its int8 sites (``quantize_params_like``, as the int8 bundle
    is built), the fp sites take them as they are, and a site the checkpoint
    lacks keeps its int8 weight and scale."""
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.ops.quant import quantize_params_like
    from leftrefill_torch.pipeline import fill_random_

    from test_torch_nvs import SD2, TINY_UNET

    schedule = DiffusionSchedule.create(**SD2)
    fp = LeftRefillModel(UNetModel(**TINY_UNET), None, None, schedule)
    fill_random_(fp, torch.Generator().manual_seed(1))
    q = LeftRefillModel(UNetModel(**TINY_UNET, quant=True), None, None, schedule)
    fill_random_(q, torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in q.state_dict().items()}
    sd = fp.state_dict()
    gone = "model.diffusion_model.input_blocks.1.0.in_layers.2.weight"
    del sd[gone]
    report = ck.load_over_base(q, sd)
    assert report["missing"] == [gone] and not report["unexpected"] and not report["shape_mismatch"]
    want = quantize_params_like(q.unet, {k[len("model.diffusion_model."):]: v for k, v in fp.state_dict().items()})
    got = q.state_dict()
    n_int8 = 0
    for k, v in got.items():
        if k in (gone, gone + "_scale"):
            assert torch.equal(v, before[k])
        elif k.startswith("model.diffusion_model."):
            n_int8 += v.dtype == torch.int8
            assert torch.equal(v, want[k[len("model.diffusion_model."):]].to(v.dtype)), k
    assert n_int8 > 10


def test_make_it_fit_and_zero_extend_match_jax():
    from leftrefill_tpu.convert.torch_to_flax import make_it_fit as jfit, zero_extend_input_conv as jzero

    rng = np.random.RandomState(0)
    for old, new in (((4, 6, 3, 3), (6, 9, 3, 3)), ((5, 3), (7, 8)), ((4,), (6,)), ((3, 2, 1, 1), (3, 2, 1, 1))):
        w = rng.standard_normal(old).astype(np.float32)
        np.testing.assert_allclose(ck.make_it_fit(torch.from_numpy(w), new).numpy(), jfit(w, new), rtol=1e-6)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)  # OIHW; JAX's takes HWIO
    grown = ck.zero_extend_input_conv(torch.from_numpy(w), 9)
    assert np.array_equal(grown.numpy(), jzero(w.transpose(2, 3, 1, 0), 9).transpose(3, 2, 0, 1))
    assert ck.zero_extend_input_conv(grown, 9) is grown
