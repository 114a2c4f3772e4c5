"""Loading an SD2 / LeftRefill checkpoint file over the port's bundle (the
loading half of ``leftrefill_tpu/convert/torch_to_flax.py``).

The port's modules carry the checkpoint's key names, so no key mapping is
needed: a state_dict is read (``.ckpt`` / ``.pt`` through ``torch.load``,
``.safetensors`` through a numpy reader of the format), the keys the model
does not hold by design are skipped (the schedule buffers it recomputes,
``model_ema.*``, anything outside the UNet, VAE, text tower and
refinement branch, and the text tower's unused heads), and the rest is
loaded over the model non-strictly, reporting what is missing, what has
another shape and what is unexpected, as JAX's ``merge_params`` does."""

from __future__ import annotations

import json
import re
import struct
from typing import Mapping

import numpy as np
import torch

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
    "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}

# buffers the schedule recomputes: skipped on load
_SKIP_PATTERNS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights", "logvar",
    "cond_ids",
)
_ROOTS = ("model.diffusion_model.", "first_stage_model.", "cond_stage_model.", "refinement_model.")
# the text tower's keys the prompt embedder reads (text_projection,
# logit_scale and attn_mask are not)
_COND_USED = re.compile(
    r"special_embeddings\.weight|rel_pos_model\.mlp\d\.\d\.(weight|bias)|model\.token_embedding\.weight|"
    r"model\.positional_embedding|model\.ln_final\.\w+|"
    r"model\.transformer\.resblocks\.\d+\.(attn\.(in_proj_weight|in_proj_bias|out_proj\.\w+)|mlp\.\w+\.\w+|ln_[12]\.\w+)")


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays (u64 header length, the JSON
    header with each tensor's dtype, shape and byte range, then the raw
    little-endian buffer); BF16 becomes fp32 exactly."""
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = data[start:end]
        if meta["dtype"] == "BF16":
            arr = (np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=_SAFETENSORS_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.ckpt`` / ``.pt`` (its ``state_dict`` entry, or the whole object)
    or ``.safetensors`` file as fp32 CPU tensors, as JAX reads it."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v.astype(np.float32)) for k, v in load_safetensors(path).items()}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.detach().to(torch.float32) for k, v in sd.items() if hasattr(v, "detach")}


def skipped(key: str) -> bool:
    """Whether ``key`` is one the model does not hold by design."""
    if key in _SKIP_PATTERNS or key.startswith("model_ema."):
        return True
    if key == "refinement_alpha":
        return False
    if not key.startswith(_ROOTS):
        return True
    return key.startswith("cond_stage_model.") and not _COND_USED.fullmatch(key[len("cond_stage_model."):])


def make_it_fit(old_param: torch.Tensor, new_shape: tuple[int, ...]) -> torch.Tensor:
    """A weight of another shape fitted to ``new_shape`` (the reference's
    ``make_it_fit``): the first two axes (torch's out, in) tiled
    cyclically, each input channel divided by the times its source is used."""
    old_shape = tuple(old_param.shape)
    assert len(old_shape) == len(new_shape)
    if len(new_shape) > 2:
        assert tuple(new_shape[2:]) == old_shape[2:]
    if tuple(new_shape) == old_shape:
        return old_param
    rows = torch.arange(new_shape[0]) % old_shape[0]
    if len(new_shape) == 1:
        return old_param[rows].clone()
    cols = torch.arange(new_shape[1]) % old_shape[1]
    new_param = old_param[rows][:, cols]
    used = 1 + torch.bincount(cols, minlength=old_shape[1]).to(old_param.dtype)
    return new_param / used[cols].reshape(1, -1, *([1] * (len(new_shape) - 2)))


def zero_extend_input_conv(weight: torch.Tensor, new_in: int) -> torch.Tensor:
    """An OIHW conv weight grown to ``new_in`` input channels, the new ones
    zero (a 4-channel SD stem restored into the 9-channel inpainting UNet)."""
    out, old_in = weight.shape[:2]
    if old_in == new_in:
        return weight
    grown = weight.new_zeros((out, new_in, *weight.shape[2:]))
    grown[:, :old_in] = weight
    return grown


def load_over_base(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> dict[str, list[str]]:
    """Load ``state_dict`` (checkpoint keys) over ``model`` non-strictly:
    entries whose key and shape match replace the model's, cast to its
    dtype; the rest of the model keeps its values.  An int8 UNet's
    quantized sites take the checkpoint's fp weights quantized per output
    channel (``ops.quant.quantize_params_like``, as the int8 bundle is
    built).  Returns {"skipped", "missing", "shape_mismatch",
    "unexpected"}: keys skipped by design, model keys the checkpoint lacks
    (an int8 site's ``weight_scale`` is not one: it comes with its weight),
    "key (shape [..] != [..])" for those it has at another shape, and
    checkpoint keys the model lacks."""
    from leftrefill_torch.ops.quant import quantize_params_like

    own = model.state_dict()
    scales = {k[: -len("_scale")] for k in own if k.endswith(".weight_scale")}
    report = {"skipped": [], "missing": [], "shape_mismatch": [], "unexpected": []}
    new = dict(own)
    fitted = set()
    for key, value in state_dict.items():
        if skipped(key):
            report["skipped"].append(key)
        elif key not in own or key.endswith(".weight_scale"):
            report["unexpected"].append(key)
        elif tuple(value.shape) != tuple(own[key].shape):
            report["shape_mismatch"].append(f"{key} (shape {list(value.shape)} != {list(own[key].shape)})")
        else:
            new[key] = value if key in scales else value.to(own[key].dtype)
            fitted.add(key)
    report["missing"] = [k for k in own if k not in state_dict and not (k.endswith(".weight_scale")
                                                                      and k[: -len("_scale")] in scales)]
    quant = [k for k in scales if k in fitted]
    if quant:  # fp weights at int8 sites: quantized as the int8 bundle's are
        prefix = "model.diffusion_model."
        unet = model.model.diffusion_model
        fp = {k[len(prefix):]: v for k, v in new.items() if k.startswith(prefix)}
        for k in scales:
            if k not in fitted:  # keeps its int8 values: a stand-in the result is not taken from
                fp[k[len(prefix):]] = own[k].to(torch.float32)
        q = quantize_params_like(unet, fp)
        for k in quant:
            new[k], new[k + "_scale"] = q[k[len(prefix):]], q[k[len(prefix):] + "_scale"]
    with torch.no_grad():
        model.load_state_dict(new, strict=True)
    return report
