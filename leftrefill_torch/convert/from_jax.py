"""The JAX package's parameter tree -> the port's ``state_dict``.

``state_dict_from_flax({"unet": ..., "vae": ..., "cond": ...})`` is the exact
inverse of ``leftrefill_tpu/convert/torch_to_flax.py:convert_state_dict``:
flax module names unfold back into the checkpoint's dotted keys
(``input_blocks_1_0/in_layers_2`` -> ``input_blocks.1.0.in_layers.2``), and
the layout swaps are undone (HWIO -> OIHW for convs, [in, out] -> [out, in]
for linears, ``scale`` -> ``weight`` for norms; embeddings stay as they are).
An int8 tree (``quantize_params_like``) carries across as it is: int8
kernels stay int8 through the swaps and ``kernel_scale`` becomes
``weight_scale`` (fp32); every other leaf becomes fp32.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.", "cond": "cond_stage_model."}


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


def _cond_key(path: list[str]) -> str:
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


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """{"unet", "vae", "cond"} trees of arrays -> full-checkpoint-key state_dict."""
    out: dict[str, torch.Tensor] = {}
    for root, tree in params.items():
        for path, arr in _flatten(tree):
            arr = np.asarray(arr)
            if root == "cond":
                if path[-1] in ("kernel", "scale"):
                    leaf, arr = _leaf(path[-1], arr)
                    path = path[:-1] + [leaf]
                key = _cond_key(path)
            else:
                fold = _unet_module if root == "unet" else _vae_module
                leaf, arr = _leaf(path[-1], arr)
                key = ".".join([fold(m) for m in path[:-1]] + [leaf])
            dtype = np.int8 if arr.dtype == np.int8 else np.float32
            out[_PREFIX[root] + key] = torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
    return out
