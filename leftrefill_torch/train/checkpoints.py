"""Checkpoints of a training run (counterpart of
``leftrefill_tpu/train/checkpoints.py``): ``last`` plus the best k by a
monitored metric, each a ``torch.save`` of a name -> tensor mapping under the
SD checkpoint's key names (``cond_stage_model.special_embeddings.weight``),
with JAX's ``manifest.json``.  Prompt-only training saves only the prompt
table (the reference's ~720 KB artifacts) and restores it over freshly
loaded frozen weights."""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import torch
from torch import nn

Predicate = Callable[[tuple], bool]


def filter_tree(state_dict: dict, predicate: Predicate) -> dict:
    """The entries whose key path (the name split at dots) matches."""
    return {name: t for name, t in state_dict.items() if predicate(tuple(name.split(".")))}


def prompt_only_filter(keys: tuple) -> bool:
    """Only the trainable prompt table."""
    return "special_embeddings" in keys


def nvs_prompt_filter(keys: tuple) -> bool:
    """The NVS trainables: prompt, relative pose, LoRA, sep token, refinement."""
    joined = "/".join(keys)
    return any(s in joined for s in ("special_embeddings", "rel_pos_model", "lora", "sep_token", "refine"))


class CheckpointManager:
    """``save_last`` / ``save_best``: keeps ``last`` plus the ``top_k`` best
    by ``monitor`` (lower is better by default: val/lpips) in ``directory``
    as ``<name>.pt``, listed in ``manifest.json`` as JAX's manager lists them."""

    def __init__(self, directory: str, monitor: str = "val/lpips", top_k: int = 2, lower_is_better: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor, self.top_k, self.lower_is_better = monitor, top_k, lower_is_better
        self._manifest_path = os.path.join(self.directory, "manifest.json")
        self.manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                return json.load(f)
        return {"best": [], "last": None}

    def _write_manifest(self):
        with open(self._manifest_path, "w") as f:
            json.dump(self.manifest, f, indent=2)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def _save_tree(self, name: str, tree: dict):
        torch.save({k: v.detach().cpu() for k, v in tree.items()}, self.path(name))

    def save_last(self, step: int, tree: dict):
        self._save_tree("last", tree)
        self.manifest["last"] = {"step": int(step)}
        self._write_manifest()

    def save_best(self, step: int, tree: dict, metrics: dict):
        value = float(metrics[self.monitor])
        name = f"step_{int(step)}"
        self._save_tree(name, tree)
        self.manifest["best"].append({"name": name, "step": int(step), "value": value})
        self.manifest["best"].sort(key=lambda e: e["value"], reverse=not self.lower_is_better)
        while len(self.manifest["best"]) > self.top_k:
            drop = self.manifest["best"].pop()
            if os.path.exists(self.path(drop["name"])):
                os.remove(self.path(drop["name"]))
        self._write_manifest()

    def restore(self, name: str) -> dict:
        return torch.load(self.path(name), map_location="cpu", weights_only=True)

    def best_name(self) -> Optional[str]:
        return self.manifest["best"][0]["name"] if self.manifest["best"] else None


def save_pruned(manager: CheckpointManager, step: int, model: nn.Module, save_prompt_only: bool,
                metrics: Optional[dict] = None, filter_fn: Predicate = prompt_only_filter):
    """Save ``last`` (and a best-k entry where ``metrics`` has the monitored
    metric), pruned to the trainable entries when ``save_prompt_only``."""
    state = model.state_dict()
    tree = filter_tree(state, filter_fn) if save_prompt_only else state
    manager.save_last(step, tree)
    if metrics is not None and manager.monitor in metrics:
        manager.save_best(step, tree, metrics)


def restore_over_base(model: nn.Module, restored: dict) -> tuple[nn.Module, list[str], list[str]]:
    """Load a (pruned) checkpoint over the model's frozen weights, non-strict:
    entries whose name and shape match are loaded; returns (model, the
    model's names not loaded (a shape mismatch noted), the checkpoint's names
    the model lacks), as JAX's ``merge_params`` reports them."""
    own = model.state_dict()
    fits = {k: v for k, v in restored.items() if k in own and tuple(v.shape) == tuple(own[k].shape)}
    res = model.load_state_dict(fits, strict=False)
    missing = [k if k not in restored else f"{k} (shape {tuple(restored[k].shape)} != {tuple(own[k].shape)})"
               for k in res.missing_keys]
    return model, missing, [k for k in restored if k not in own]
