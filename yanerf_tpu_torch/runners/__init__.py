"""Training of the port: schedules, Adam, the train step and loops, checkpoints."""

from .apis import create_stats, eval_one_epoch, make_train_step, prepare_batch, step_generator, train_one_epoch
from .checkpoints import checkpoint_params_tree, ckpt_name, find_best_checkpoint, load_checkpoint, save_checkpoint
from .optim import TrainState, create_optimizer, set_learning_rates
from .schedules import cosine_schedule, create_lr_schedule, exponential_schedule, with_warmup

__all__ = [
    "TrainState",
    "checkpoint_params_tree",
    "ckpt_name",
    "cosine_schedule",
    "create_lr_schedule",
    "create_optimizer",
    "create_stats",
    "eval_one_epoch",
    "exponential_schedule",
    "find_best_checkpoint",
    "load_checkpoint",
    "make_train_step",
    "prepare_batch",
    "save_checkpoint",
    "set_learning_rates",
    "step_generator",
    "train_one_epoch",
    "with_warmup",
]
