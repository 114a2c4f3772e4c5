"""The serving-side LoRA adapter store (counterpart of
``leftrefill_tpu/runtime.py:LoraAdapterStore``): named adapters over one
frozen UNet, swapped into it in place.  Merged weights have the base's
shapes and dtypes, so the pipeline and its kernels see the same model with
other values."""

from __future__ import annotations

import collections
from typing import Mapping, Optional

import torch

from leftrefill_torch.models.lora import merge_lora
from leftrefill_torch.ops.quant import quantize_params_like
from leftrefill_torch.pipeline import request_device


class LoraAdapterStore:
    """Named LoRA adapters over ``unet`` (a UNet of the port, on the card
    unless the caller built it on the CPU).

    ``add(name, lora)`` registers an adapter ({key: {"down", "up"}},
    ``models.lora``); ``use(name, scale)`` loads the merged weights into
    ``unet`` in place and returns it; ``use(None)`` loads a kept copy of the
    base weights back, so the base model comes back bit for bit (no delta
    is subtracted).  The merged state_dicts of the last ``keep`` (name,
    scale) pairs are kept, so a repeated request pays no merge.

    ``master_unet``, the int8 UNet's case: the fp state_dict (or fp UNet)
    that the int8 weights were quantized from.  An adapter is then merged
    into the master and the result requantized to ``unet``'s int8 structure
    (``ops.quant.quantize_params_like``), as JAX does.  Every merge runs on
    ``device``, the UNet's: the card unless the caller asks for the CPU
    (without a card, an error)."""

    def __init__(self, unet: torch.nn.Module, keep: int = 2,
                 master_unet: Optional[torch.nn.Module | Mapping[str, torch.Tensor]] = None,
                 device="cuda"):
        self.unet, self.keep = unet, keep
        self.device = request_device(device)
        if next(unet.parameters()).device.type != self.device.type:
            raise ValueError(f"the UNet is on {next(unet.parameters()).device}, the store on {self.device}")
        self.base = {k: v.detach().clone() for k, v in unet.state_dict().items()}
        if isinstance(master_unet, torch.nn.Module):
            master_unet = master_unet.state_dict()
        self.master = None if master_unet is None else {k: v.to(self.device) for k, v in master_unet.items()}
        self._adapters: dict[str, dict] = {}
        self._merged: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()

    def add(self, name: str, lora: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        self._adapters[name] = {k: {f: t.to(self.device) for f, t in v.items()} for k, v in lora.items()}
        for key in [k for k in self._merged if k[0] == name]:  # a re-registered name merges again
            del self._merged[key]

    def names(self) -> list[str]:
        return sorted(self._adapters)

    def state_for(self, name: Optional[str] = None, scale: float = 1.0) -> dict[str, torch.Tensor]:
        """The UNet's state_dict with adapter ``name`` merged at ``scale``
        (LRU-kept); the base copy for None."""
        if name is None:
            return self.base
        if name not in self._adapters:
            raise KeyError(f"unknown adapter {name!r}; have {self.names()}")
        key = (name, float(scale))
        if key in self._merged:
            self._merged.move_to_end(key)
            return self._merged[key]
        with torch.no_grad():
            if self.master is None:
                merged = merge_lora(self.base, self._adapters[name], scale)
            else:
                merged = quantize_params_like(self.unet, merge_lora(self.master, self._adapters[name], scale))
        self._merged[key] = merged
        while len(self._merged) > self.keep:
            self._merged.popitem(last=False)
        return merged

    def use(self, name: Optional[str] = None, scale: float = 1.0) -> torch.nn.Module:
        """Load adapter ``name`` (None: the base) into the UNet in place."""
        state = self.state_for(name, scale)
        with torch.no_grad():
            self.unet.load_state_dict(state, strict=True)
        return self.unet
