"""Training of the port: schedules, Adam, the train steps and loops, checkpoints, vis and hooks."""

from .apis import (
    FusedTrainStep,
    create_stats,
    eval_one_epoch,
    make_step_draws,
    make_train_step,
    make_train_step_fused,
    prepare_batch,
    step_generator,
    train_one_epoch,
)
from .checkpoints import (
    PreemptionGuard,
    checkpoint_params_tree,
    ckpt_name,
    find_best_checkpoint,
    find_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .hooks import HOOKS
from .optim import TrainState, apply_learning_rates, create_optimizer, learning_rates, set_learning_rates
from .schedules import cosine_schedule, create_lr_schedule, exponential_schedule, with_warmup
from .vis import AsyncVisWriter, RunType, vis_batch_img

__all__ = [
    "AsyncVisWriter",
    "FusedTrainStep",
    "HOOKS",
    "PreemptionGuard",
    "RunType",
    "TrainState",
    "apply_learning_rates",
    "checkpoint_params_tree",
    "ckpt_name",
    "cosine_schedule",
    "create_lr_schedule",
    "create_optimizer",
    "create_stats",
    "eval_one_epoch",
    "exponential_schedule",
    "find_best_checkpoint",
    "find_latest_checkpoint",
    "learning_rates",
    "load_checkpoint",
    "make_step_draws",
    "make_train_step",
    "make_train_step_fused",
    "prepare_batch",
    "save_checkpoint",
    "set_learning_rates",
    "step_generator",
    "train_one_epoch",
    "vis_batch_img",
    "with_warmup",
]
