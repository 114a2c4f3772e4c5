"""Prompt-tuning training on the card: ``create_train_state`` and
``make_train_step`` on a ``build_sd2_inpaint_bundle(..., remat=True)`` model
(``train.trainer``); EMA, checkpoints and logging beside them."""

from leftrefill_torch.train.trainer import (  # noqa: F401
    OptimizerConfig,
    TrainState,
    compute_loss,
    create_train_state,
    current_lr,
    make_train_step,
    prompt_only_predicate,
    view_options,
)
