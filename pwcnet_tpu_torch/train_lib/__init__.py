"""Training: schedule, train/eval steps and checkpoints."""

from pwcnet_tpu_torch.train_lib.checkpoint import restore_checkpoint, save_checkpoint
from pwcnet_tpu_torch.train_lib.schedule import DEFAULT_BOUNDARIES, make_lr, piecewise_halving
from pwcnet_tpu_torch.train_lib.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "DEFAULT_BOUNDARIES", "TrainState", "create_train_state", "make_eval_step", "make_loss_fn",
    "make_lr", "make_train_step", "piecewise_halving", "restore_checkpoint", "save_checkpoint",
]
