"""Cross-attention maps for visualization (counterpart of
``leftrefill_tpu/eval/attn_vis.py``): one UNet forward with every
cross-attention (``attn2``) handing its head-averaged probabilities to a
collector, their average over sampling steps, and the heatmap of one
context token."""

from __future__ import annotations

import torch

from leftrefill_torch.models.unet import BasicTransformerBlock


def collect_attention_maps(unet, x, t, context, **forward_kwargs) -> dict[str, torch.Tensor]:
    """One forward of ``unet`` under ``torch.inference_mode()`` (``forward_kwargs``:
    ``cross_kv``, ``cfg_dup``, the NVS UNet's ``c_input``); returns {module
    name of each cross-attention: [B, Nq, Nk] fp32}, keyed as
    ``named_modules()`` names them (``input_blocks.1.1.transformer_blocks.0.attn2``).
    The forward's output is not changed.  A multi-view UNet's blocks do not
    collect (as JAX's), so it yields none."""
    attns = {f"{name}.attn2": m.attn2 for name, m in unet.named_modules()
             if isinstance(m, BasicTransformerBlock) and m.collects_attention}
    maps: dict[str, torch.Tensor] = {}

    def sink(name):
        def put(probs):
            if name in maps:
                raise RuntimeError(f"{name} handed over attention maps twice in one forward")
            maps[name] = probs
        return put

    try:
        for name, attn in attns.items():
            attn.probs_sink = sink(name)
        with torch.inference_mode():
            unet(x, t, context, **forward_kwargs)
    finally:
        for attn in attns.values():
            attn.probs_sink = None
    return maps


def average_attention_over_steps(step_maps: list[dict]) -> dict:
    """Each layer's maps summed over the steps and divided by the step count
    (JAX: attn_vis.py:44-50)."""
    acc: dict = {}
    for m in step_maps:
        for k, v in m.items():
            acc[k] = acc.get(k, 0) + v
    return {k: v / len(step_maps) for k, v in acc.items()}


def attention_heatmap(attn: torch.Tensor, query_hw: tuple[int, int], token_index: int) -> torch.Tensor:
    """[Nq, Nk] map -> [h, w] attention onto one context token, min-max
    normalized to [0, 1] (JAX: attn_vis.py:53-59)."""
    h, w = query_hw
    m = attn[:, token_index].reshape(h, w)
    lo, hi = m.min(), m.max()
    return (m - lo) / torch.clamp(hi - lo, min=1e-8)
