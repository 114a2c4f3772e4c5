"""The JAX package's parameter tree -> the port's ``state_dict``.

``state_dict_from_flax({"unet": ..., "vae": ..., "cond": ..., "refine": ...})``
is the exact inverse of ``leftrefill_tpu/convert/torch_to_flax.py:convert_state_dict``:
flax module names unfold back into the checkpoint's dotted keys
(``input_blocks_1_0/in_layers_2`` -> ``input_blocks.1.0.in_layers.2``), and
the layout swaps are undone (HWIO -> OIHW for convs, [in, out] -> [out, in]
for linears, ``scale`` -> ``weight`` for norms; embeddings stay as they are).
The novel-view trees carry across too: the UNet's ``sep_token_<width>``
(``sep_token.<width>``), the embedder's ``rel_pos_model`` and the ``refine``
root (``refinement_model.<index>.*`` and ``refinement_alpha``, no prefix).
An int8 tree (``quantize_params_like``) carries across as it is: int8
kernels stay int8 through the swaps and ``kernel_scale`` becomes
``weight_scale`` (fp32); every other leaf becomes fp32.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.", "cond": "cond_stage_model.",
           "refine": ""}


def _unet_module(name: str) -> str:
    # input_blocks_1_0 -> input_blocks.1.0 ; net_0_proj -> net.0.proj
    name = re.sub(r"_(\d+)(?=_|$)", r".\1", name)
    return re.sub(r"(\.\d+)_", r"\1.", name)


def _vae_module(name: str) -> str:
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", name)
    if m:
        return "{}.{}.{}.{}".format(*m.groups())
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", name)
    if m:
        return "{}.{}.{}".format(*m.groups())
    m = re.fullmatch(r"mid_((?:block|attn)_\d+)", name)
    if m:
        return "mid." + m.group(1)
    return name


def _refine_key(path: list[str]) -> str:
    # conv_5/kernel -> refinement_model.5.weight ; refinement_alpha stays
    if path == ["refinement_alpha"]:
        return "refinement_alpha"
    return "refinement_model.{}.{}".format(path[0].split("_")[1], path[1])


def _cond_key(path: list[str]) -> str:
    if path[0] == "rel_pos_model":  # rel_pos_model/mlp1_0/weight -> rel_pos_model.mlp1.0.weight
        return "rel_pos_model.{}.{}".format(path[1].replace("_", "."), path[2])
    if path == ["token_embedding"]:
        return "model.token_embedding.weight"
    if path == ["special_embeddings"]:
        return "special_embeddings.weight"
    if path == ["model", "positional_embedding"]:
        return "model.positional_embedding"
    mods, leaf = path[:-1], path[-1]
    if mods[:2] == ["model", "ln_final"]:
        return "model.ln_final." + leaf
    blk = re.fullmatch(r"resblocks_(\d+)", mods[1]).group(1)
    sub = mods[2]
    base = f"model.transformer.resblocks.{blk}."
    if sub == "attn_in_proj":
        return base + ("attn.in_proj_weight" if leaf == "weight" else "attn.in_proj_bias")
    if sub == "attn_out_proj":
        return base + "attn.out_proj." + leaf
    if sub.startswith("mlp_"):
        return base + "mlp." + sub[len("mlp_"):] + "." + leaf
    return base + sub + "." + leaf


def _leaf(leaf: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """flax leaf -> (torch leaf, array in torch layout)."""
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        return "weight", arr.T
    if leaf == "scale":
        return "weight", arr
    if leaf == "kernel_scale":
        return "weight_scale", arr
    return leaf, arr


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield list(prefix + (k,)), v


def torch_entries(params: Mapping[str, Any]):
    """(full-checkpoint key, array in torch layout) for every leaf of the
    {"unet", "vae", "cond", "refine"} trees, the layout swaps as views (the
    leaves may be shape-only stand-ins)."""
    for root, tree in params.items():
        for path, arr in _flatten(tree):
            if root in ("cond", "refine"):
                if path[-1] in ("kernel", "scale"):
                    leaf, arr = _leaf(path[-1], arr)
                    path = path[:-1] + [leaf]
                key = _cond_key(path) if root == "cond" else _refine_key(path)
            elif root == "unet" and len(path) == 1 and path[0].startswith("sep_token_"):
                key = "sep_token." + path[0][len("sep_token_"):]
            else:
                fold = _unet_module if root == "unet" else _vae_module
                leaf, arr = _leaf(path[-1], arr)
                key = ".".join([fold(m) for m in path[:-1]] + [leaf])
            yield _PREFIX[root] + key, arr


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """{"unet", "vae", "cond", "refine"} trees of arrays -> full-checkpoint-key state_dict."""
    out: dict[str, torch.Tensor] = {}
    for key, arr in torch_entries(params):
        arr = np.asarray(arr)
        dtype = np.int8 if arr.dtype == np.int8 else np.float32
        out[key] = torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
    return out


def lora_from_flax(lora: Mapping[str, Mapping[str, Any]]) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's LoRA factors (``models/lora.py``: {"a/b/kernel":
    {"down", "up"}} on the UNet tree) -> the port's ({"a.b.weight": {"down",
    "up"}} on the UNet's state_dict keys, ``leftrefill_torch.models.lora``):
    a linear's down [in, r] -> [r, in] and up [r, out] -> [out, r]; a conv's
    down [kh, kw, in, r] -> [r, in, kh, kw] and up [r, out] -> [out, r, 1, 1]."""
    out = {}
    for path, pack in lora.items():
        mods = path.split("/")[:-1]
        down, up = np.asarray(pack["down"], np.float32), np.asarray(pack["up"], np.float32)
        if down.ndim == 2:
            down_t, up_t = down.T, up.T
        else:
            down_t, up_t = down.transpose(3, 2, 0, 1), up.T[:, :, None, None]
        out[".".join(_unet_module(m) for m in mods) + ".weight"] = {
            "down": torch.from_numpy(np.ascontiguousarray(down_t)), "up": torch.from_numpy(np.ascontiguousarray(up_t))}
    return out
