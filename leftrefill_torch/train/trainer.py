"""Training (counterpart of ``leftrefill_tpu/train/trainer.py``): prompt
tuning, where only the prompt table (``cond_stage_model.special_embeddings.weight``,
~50 x 1024, fp32) trains through the frozen UNet, text tower and VAE, and
novel-view-synthesis training, where the prompt, the relative-pose MLP, the
separator columns, the refinement branch and LoRA factors train.

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

LoRA (JAX's ``wrap_lora_params``): ``wrap_lora_params(model, lora)`` holds
the factors as parameters beside the model (``LoraModel``: ``model.*`` and
``lora.{down,up}.*``); the loss runs the model through
``torch.func.functional_call`` on the UNet weights merged with them
(``models.lora.merge_lora``), so the gradient reaches the factors and the
base weights stay frozen.  ``lora_predicate`` selects the factors and
whatever its base predicate selects in the model.  A ``cond_builder``
(``tasks.NVSTask.build_cond``) builds the conditioning in place of the
inpainting one: the pose token, the CFG prompt dropout (its draws taken from
the step's generator after t and the noise, or injected) and c_input.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from leftrefill_torch import trace
from leftrefill_torch.diffusion.core import LeftRefillModel, fixed_vae_noise
from leftrefill_torch.models.lora import merge_lora
from leftrefill_torch.parallel.mesh import all_reduce_mean, collective_device, group_rank, group_size, shard_rows

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


class LoraPack(nn.Module):
    """LoRA factors ({key: {"down", "up"}}, ``models.lora.init_lora``'s
    pack over the UNet's state_dict keys) as fp32 parameters: ``down`` and
    ``up`` ParameterDicts keyed by the weight's key with '/' for '.'."""

    def __init__(self, lora: dict):
        super().__init__()
        self.down = nn.ParameterDict({k.replace(".", "/"): nn.Parameter(v["down"].detach().to(torch.float32).clone())
                                      for k, v in lora.items()})
        self.up = nn.ParameterDict({k.replace(".", "/"): nn.Parameter(v["up"].detach().to(torch.float32).clone())
                                    for k, v in lora.items()})

    def factors(self) -> dict:
        """{UNet state_dict key: {"down", "up"}} of the parameters themselves."""
        return {k.replace("/", "."): {"down": self.down[k], "up": self.up[k]} for k in self.down}


class LoraModel(nn.Module):
    """JAX's {"model": params, "lora": factors} pack: ``model`` (the
    ``LeftRefillModel``) and ``lora`` (a ``LoraPack``), applied at ``scale``
    through :func:`with_lora`.  ``forward(fn, *args)`` calls ``fn`` (it
    exists for ``functional_call``)."""

    def __init__(self, model: nn.Module, lora: dict, scale: float = 1.0):
        super().__init__()
        self.model, self.lora, self.scale = model, LoraPack(lora), scale

    def merged_weights(self) -> dict[str, torch.Tensor]:
        """The LoRA sites' UNet weights merged with the factors, keyed by
        this module's parameter names (differentiable in the factors)."""
        unet = dict(self.model.model.diffusion_model.named_parameters())
        factors = self.lora.factors()
        merged = merge_lora({k: unet[k] for k in factors}, factors, self.scale)
        return {f"model.model.diffusion_model.{k}": merged[k] for k in factors}

    def forward(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


def wrap_lora_params(model: nn.Module, lora: dict, scale: float = 1.0) -> LoraModel:
    """The model with LoRA factors beside it (JAX's ``wrap_lora_params``)."""
    return LoraModel(model, lora, scale)


def lora_predicate(base_predicate: Predicate) -> Predicate:
    """Trainable: every LoRA factor and what ``base_predicate`` selects in
    the model (JAX's ``lora_predicate``: the NVS optimizer groups)."""

    def pred(keys: tuple) -> bool:
        if keys and keys[0] == "lora":
            return True
        return base_predicate(keys[1:] if keys and keys[0] == "model" else keys)

    return pred


def base_model(model: nn.Module) -> nn.Module:
    """The ``LeftRefillModel`` of a LoRA pack, or the model itself."""
    return model.model if isinstance(model, LoraModel) else model


def with_lora(model: nn.Module, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with a LoRA pack's merged weights in place of
    the UNet's (``torch.func.functional_call``; the UNet's own parameters
    are untouched), or as it is for a plain model (JAX's
    ``_effective_params``)."""
    if isinstance(model, LoraModel):
        return torch.func.functional_call(model, model.merged_weights(), (fn, *args), kwargs)
    return fn(*args, **kwargs)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def compute_loss(
    model: nn.Module,
    batch: dict,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[torch.Tensor] = None,
    view_reduced: bool = False,
    view_num: int = 1,
    cond_builder=None,
    cfg_draws: Optional[torch.Tensor] = None,
    shard: tuple[int, int] = (0, 1),
):
    """One forward loss: encode the image (no graph: the VAE is frozen),
    build the conditioning (the inpainting one through the prompt text
    tower, or ``cond_builder(batch, cfg_draws=, vae_noise=)``'s), then
    ``p_losses`` at timesteps ``t`` with ``noise``.  Where not given, t, the
    noise and (with a ``cond_builder``) the CFG draws [B] come from
    ``generator`` in that order.  ``model`` may be a LoRA pack
    (:func:`wrap_lora_params`): its merged weights are used.  ``vae_noise``:
    the VAE posterior sample's noise (default: the fixed draw).
    ``view_reduced``: the multi-view loss, each scene's V consecutive rows,
    only view 0 (the target) kept.  ``shard`` (rank, world): the batch is
    the rank-th of world contiguous row blocks of a global batch, and t, the
    noise, the CFG draws and the VAE's default noise are drawn for the
    global batch and cut to the block, so the ranks' losses are those of
    the global batch's rows.  Returns (loss, metrics)."""
    return with_lora(model, _loss, base_model(model), batch, t, noise, generator, vae_noise, view_reduced, view_num,
                     cond_builder, cfg_draws, shard)


def _loss(model: LeftRefillModel, batch, t, noise, generator, vae_noise, view_reduced, view_num, cond_builder,
          cfg_draws, shard):
    dev = _device(model)
    rank, world = shard
    image = trace.to_device(batch["image"], torch.float32, dev)
    b = image.shape[0]

    def drawn(draw, *shape):  # the global batch's draw, this block's rows
        return shard_rows(draw((b * world, *shape)), rank, world)

    if vae_noise is None and world > 1:
        vae_noise = drawn(lambda shape: fixed_vae_noise(shape, dev), *model.latent_shape(image.shape)[1:])
    with torch.no_grad():
        z = model.encode_first_stage(image, vae_noise)
    if t is None:
        t = drawn(lambda shape: torch.randint(0, model.schedule.num_timesteps, shape, generator=generator,
                                              device=dev))
    if noise is None:
        noise = drawn(lambda shape: torch.randn(shape, generator=generator, device=dev, dtype=torch.float32),
                      *z.shape[1:]).to(z.dtype)
    t, noise = trace.to_device(t, torch.long, dev), trace.to_device(noise, z.dtype, dev)
    if cond_builder is not None:
        if cfg_draws is None:
            cfg_draws = drawn(lambda shape: torch.rand(shape, generator=generator, device=dev))
        cond = cond_builder(batch, cfg_draws=cfg_draws, vae_noise=vae_noise)
    else:
        mask, masked_image = (trace.to_device(batch[k], torch.float32, dev) for k in ("mask", "masked_image"))
        tokens = trace.to_device(batch["tokens"], torch.long, dev)
        cond = model.build_inpaint_cond(tokens, mask, masked_image, vae_noise)
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

    block = next(base_model(model).unet.spatial_transformers()).transformer_blocks[0]
    if isinstance(block, MultiViewBasicTransformerBlock):
        return True, block.view_num
    return False, 1


def make_train_step(model: nn.Module, tx: PromptOptimizer, view_reduced: bool = False, view_num: int = 1,
                    cond_builder=None, group=None):
    """The train step: ``step(state, batch, generator) -> (state, metrics)``
    draws t, the noise and (with a ``cond_builder``) the CFG draws from
    ``generator`` on the model's device, runs the loss and its backward, and
    hands the gradients to ``tx``.  ``model`` may be a LoRA pack.

    ``group`` (data parallelism, JAX's step on a mesh): the batch is this
    rank's contiguous block of the global batch (the group's ranks in
    order), every rank's generator is seeded alike, the draws are the
    global batch's (``compute_loss``'s ``shard``), and the trainable
    gradients are averaged over the group before ``tx`` applies them, so
    every rank takes the global batch's step.  The metrics are the rank's
    (:func:`reduce_metrics_across_hosts` averages them)."""
    shard = (group_rank(group), group_size(group))

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        with trace.span("train.step"):
            with trace.span("train.forward"):
                loss, metrics = compute_loss(model, batch, generator=generator, view_reduced=view_reduced,
                                             view_num=view_num, cond_builder=cond_builder, shard=shard)
            with trace.span("train.backward"):
                loss.backward()
            with trace.span("train.optimizer"):
                if group is not None:
                    all_reduce_mean([p.grad for p in tx.params if p.grad is not None], group)
                tx.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

    return step


def reduce_metrics_across_hosts(metrics: dict, group=None) -> dict:
    """The mean of scalar metrics over the group's ranks (JAX's mean over
    hosts, the reference's ``sync_dist``), as floats; without a group the
    metrics as they are."""
    if group is None or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = trace.to_device([float(metrics[k]) for k in keys], torch.float64, collective_device(group))
    all_reduce_mean([vals], group)
    return {k: float(trace.to_host(v)) for k, v in zip(keys, vals)}
