"""Prompt-tuning training (counterpart of ``leftrefill_tpu/train/trainer.py``):
only the prompt table (``cond_stage_model.special_embeddings.weight``, ~50 x
1024, fp32) trains, through the frozen UNet, text tower and VAE.

    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle
    from leftrefill_torch.train import create_train_state, make_train_step

    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, gen, remat=True)
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    state, metrics = step(state, batch, torch.Generator("cuda").manual_seed(0))

The step runs on the model's device (the card unless the caller built the
model on the CPU).  A batch holds ``image`` [B, H, W, 3] in [-1, 1],
``mask`` [B, H, W, 1] (1 = hole), ``masked_image`` and ``tokens`` [B, 77]
(numpy or tensors); a multi-view batch is flattened to (B*V) rows first
(``data.flatten_views``).

The optimizer is torch's AdamW over the trainable parameters only, which is
optax's masked ``adamw`` (decoupled weight decay scaled by the lr, eps added
to the square root of the bias-corrected second moment, nothing for frozen
leaves), with optax's ``cosine_decay_schedule`` and ``MultiSteps`` gradient
accumulation written out.  JAX draws t and the noise from ``split(key, 3)``;
torch cannot reproduce that stream, so :func:`compute_loss` takes them
injected and the step draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from leftrefill_torch.diffusion.core import LeftRefillModel

Predicate = Callable[[tuple], bool]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    use_cosine: bool = False
    cosine_decay_steps: int = 10000
    # the final lr as a fraction of ``lr`` (optax's ``alpha``); the JAX CLI
    # passes the training YAML's ``eta_min`` here, as a fraction, not an lr
    cosine_alpha: float = 0.0
    accumulate_grad_batches: int = 1


def prompt_only_predicate(keys: tuple) -> bool:
    """Train only the prompt table (the reference's prompt-only AdamW)."""
    return "special_embeddings" in keys


def trainable_mask(model: nn.Module, predicate: Predicate) -> dict[str, bool]:
    """Parameter name -> whether ``predicate`` holds for its keys (the
    checkpoint name split at its dots)."""
    return {name: bool(predicate(tuple(name.split(".")))) for name, _ in model.named_parameters()}


def _cosine_lr(config: OptimizerConfig, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, decay_steps, alpha)`` at ``count``."""
    frac = min(count, config.cosine_decay_steps) / config.cosine_decay_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return config.lr * ((1.0 - config.cosine_alpha) * cosine + config.cosine_alpha)


def current_lr(config: OptimizerConfig, step: int) -> float:
    """The lr applied at trainer (micro-)step ``step``: the schedule advances
    once per optimizer update, i.e. every ``accumulate_grad_batches`` steps."""
    if not config.use_cosine:
        return config.lr
    return _cosine_lr(config, step // max(config.accumulate_grad_batches, 1))


class PromptOptimizer:
    """JAX's ``make_optimizer``: AdamW over ``params`` with the schedule and
    accumulation of ``config``.  Call :meth:`step` after each micro-batch's
    backward: the
    gradients of ``accumulate_grad_batches`` micro-batches add up in
    ``.grad`` and their mean is applied at the last of them (optax's
    ``MultiSteps``); returns whether an update was applied."""

    def __init__(self, config: OptimizerConfig, params: list[nn.Parameter]):
        self.config, self.params = config, params
        self.adamw = torch.optim.AdamW(params, lr=config.lr, betas=(config.b1, config.b2), eps=config.eps,
                                       weight_decay=config.weight_decay)
        self.micro_steps = 0
        self.updates = 0

    def step(self) -> bool:
        k = max(self.config.accumulate_grad_batches, 1)
        self.micro_steps += 1
        if self.micro_steps % k:
            return False
        with torch.no_grad():
            for p in self.params:
                if p.grad is not None and k > 1:
                    p.grad.div_(k)
        lr = _cosine_lr(self.config, self.updates) if self.config.use_cosine else self.config.lr
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.updates += 1
        return True


@dataclasses.dataclass
class TrainState:
    """The trained model (its parameters change in place) and the count of
    micro-steps taken (JAX's ``state.step``)."""

    model: nn.Module
    step: int = 0


def create_train_state(
    model: nn.Module,
    config: OptimizerConfig = OptimizerConfig(),
    predicate: Predicate = prompt_only_predicate,
) -> tuple[TrainState, PromptOptimizer]:
    """Freeze every parameter but those ``predicate`` selects and build the
    optimizer over those.  A W8A8 (int8) bundle is refused, as in JAX: its
    rounding has zero gradient and its int8 weights are not parameters that
    train, so it would train on meaningless gradients."""
    bad = [name for name, p in model.named_parameters() if p.dtype == torch.int8]
    if bad:
        raise ValueError(
            "params contain int8 (W8A8-quantized) leaves — the quantized tree "
            f"is inference-only and must not be trained: {bad[:3]}..."
        )
    mask = trainable_mask(model, predicate)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    if not params:
        raise ValueError("no parameter matches the trainable predicate")
    return TrainState(model), PromptOptimizer(config, params)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def compute_loss(
    model: LeftRefillModel,
    batch: dict,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[torch.Tensor] = None,
    view_reduced: bool = False,
    view_num: int = 1,
):
    """One forward loss: encode the image, build the inpainting conditioning
    through the prompt text tower, then ``p_losses`` at timesteps ``t`` with
    ``noise`` (drawn from ``generator`` where not given: t first, then the
    noise).  ``vae_noise``: the VAE posterior sample's noise (default: the
    fixed draw).  ``view_reduced``: the multi-view loss, each scene's V
    consecutive rows, only view 0 (the target) kept.  Returns (loss,
    metrics)."""
    dev = _device(model)
    image, mask, masked_image = (torch.as_tensor(batch[k], device=dev, dtype=torch.float32)
                                 for k in ("image", "mask", "masked_image"))
    tokens = torch.as_tensor(batch["tokens"], device=dev, dtype=torch.long)
    z = model.encode_first_stage(image, vae_noise)
    cond = model.build_inpaint_cond(tokens, mask, masked_image, vae_noise)
    b = z.shape[0]
    if t is None:
        t = torch.randint(0, model.schedule.num_timesteps, (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=dev, dtype=torch.float32).to(z.dtype)
    t, noise = torch.as_tensor(t, device=dev, dtype=torch.long), torch.as_tensor(noise, device=dev, dtype=z.dtype)
    if not view_reduced:
        return model.p_losses(z, cond, t, noise)
    err = model.p_losses(z, cond, t, noise, per_element=True)
    err = err.reshape(b // view_num, view_num, *err.shape[1:])
    loss = err[:, 0].mean(dim=(1, 2, 3)).mean()  # the target view only
    return loss, {"loss_simple": loss, "loss": loss}


def view_options(model: LeftRefillModel) -> tuple[bool, int]:
    """(view_reduced, view_num) of a bundle, as the JAX tasks give them: the
    multi-view bundle (``configs/multiview_ref_inpainting.yaml``,
    ``reduced_loss: True``) keeps view 0 of each scene, the 1-reference
    bundle its whole loss."""
    from leftrefill_torch.models.multiview import MultiViewBasicTransformerBlock

    block = next(model.unet.spatial_transformers()).transformer_blocks[0]
    if isinstance(block, MultiViewBasicTransformerBlock):
        return True, block.view_num
    return False, 1


def make_train_step(model: LeftRefillModel, tx: PromptOptimizer, view_reduced: bool = False, view_num: int = 1):
    """The train step: ``step(state, batch, generator) -> (state, metrics)``
    draws t and the noise from ``generator`` on the model's device, runs the
    loss and its backward, and hands the gradients to ``tx``."""

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        loss, metrics = compute_loss(model, batch, generator=generator, view_reduced=view_reduced,
                                     view_num=view_num)
        loss.backward()
        tx.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def reduce_metrics_across_hosts(metrics: dict) -> dict:
    """The mean of scalar metrics over hosts: with one process (the port has
    no multi-process training yet), the metrics as they are."""
    return metrics
