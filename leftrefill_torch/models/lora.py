"""LoRA as algebra on the UNet's state_dict (counterpart of
``leftrefill_tpu/models/lora.py``).

An injected layer computes W x + scale * up(down(x)) at dropout 0
(LeftRefill never enables LoRA dropout), so merging it into the weight,
W' = W + scale * up . down, is exact.  The factors are held in the
reference's layouts, keyed by the targeted weight's state_dict key
(``input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight``): a Linear's
down is [r, in] and its up [out, r]; a conv's down is [r, in, kh, kw] (a conv
of the weight's geometry to r channels) and its up [out, r, 1, 1] (a 1x1
conv)."""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

_ATTN = ("to_q", "to_k", "to_v", "to_out.0")
_RES = ("in_layers.2", "out_layers.3", "skip_connection")


def default_target(key: str) -> bool:
    """The Linears inside the attention blocks and the GEGLU: attn1/attn2's
    to_q, to_k, to_v, to_out.0 and ff.net.0.proj."""
    if not key.endswith(".weight"):
        return False
    mod = key[: -len(".weight")]
    return any(mod.endswith(f".{a}") for a in _ATTN) or mod.endswith(".ff.net.0.proj")


def extended_target(key: str) -> bool:
    """``default_target`` plus the ResBlocks' convs: in_layers.2,
    out_layers.3 and skip_connection."""
    if default_target(key):
        return True
    return key.endswith(".weight") and any(key[: -len(".weight")].endswith(f".{m}") for m in _RES)


def init_lora(
    model: torch.nn.Module,
    rank: int = 16,
    target: Callable[[str], bool] = default_target,
    generator: Optional[torch.Generator] = None,
) -> dict[str, dict[str, torch.Tensor]]:
    """Factors for every targeted weight of ``model`` (the UNet, or any
    module with its state_dict keys): down ~ N(0, 1) / rank, up = 0, fp32,
    on the weights' device.  Returns {key: {"down", "up"}}."""
    out = {}
    for key, w in model.state_dict().items():
        if not target(key) or w.ndim not in (2, 4):
            continue
        dout, din = w.shape[:2]
        down = torch.randn((rank, din, *w.shape[2:]), generator=generator, device=w.device) / rank
        up = torch.zeros((dout, rank) if w.ndim == 2 else (dout, rank, 1, 1), device=w.device)
        out[key] = {"down": down, "up": up}
    return out


def merge_lora(state: Mapping[str, torch.Tensor], lora: Mapping[str, Mapping[str, torch.Tensor]],
               scale: float = 1.0) -> dict[str, torch.Tensor]:
    """``state`` with every LoRA site's weight replaced by W + scale * up .
    down in JAX's order of operations (``leftrefill_tpu/models/lora.py``:
    ``leaf + scale * delta.astype(leaf.dtype)``): the delta summed in fp32,
    rounded to the weight's dtype, multiplied by the scale rounded to that
    dtype (JAX's Python scalar is weakly typed) and added in that dtype, so a
    bf16 merge rounds the product and the sum each in bf16, bit-equal to
    JAX's.  A channels-last conv weight stays channels-last.  Every other
    entry is the same tensor as in ``state``.  Differentiable in the
    factors."""
    out = dict(state)
    for key, pack in lora.items():
        w = state[key]
        down, up = (pack[f].to(w.device, torch.float32) for f in ("down", "up"))
        delta = (up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)).reshape(w.shape).to(w.dtype)
        if w.ndim == 4 and w.is_contiguous(memory_format=torch.channels_last):
            delta = delta.contiguous(memory_format=torch.channels_last)
        out[key] = w + torch.tensor(scale, dtype=w.dtype, device=w.device) * delta
    return out


def extract_lora(lora: Mapping[str, Mapping[str, torch.Tensor]], scale: float = 1.0) -> list:
    """[(up * scale, down)] per site, in the pack's order (the reference's
    ``extract_lora_ups_down``)."""
    return [(v["up"] * scale, v["down"]) for v in lora.values()]


def num_lora_params(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    return sum(v["down"].numel() + v["up"].numel() for v in lora.values())
