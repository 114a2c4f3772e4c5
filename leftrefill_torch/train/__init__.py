"""Training on the card: ``create_train_state`` and ``make_train_step``
(``train.trainer``) for prompt tuning on a ``build_sd2_inpaint_bundle(...,
remat=True)`` model and for novel-view synthesis with LoRA factors
(``wrap_lora_params``, ``lora_predicate``) and the task's conditioning;
EMA, checkpoints and logging beside them.  The training CLI is
``leftrefill_torch.cli.train``."""

from leftrefill_torch.train.trainer import (  # noqa: F401
    LoraModel,
    OptimizerConfig,
    TrainState,
    base_model,
    compute_loss,
    create_train_state,
    current_lr,
    lora_predicate,
    make_train_step,
    prompt_only_predicate,
    view_options,
    with_lora,
    wrap_lora_params,
)
