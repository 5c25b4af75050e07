"""Training: schedule, train/eval steps, checkpoints, metrics and the Trainer
(``trainer.Trainer`` is imported from its module: it pulls in the data package)."""

from pwcnet_tpu_torch.train_lib.checkpoint import (
    latest_checkpoint,
    load_params,
    restore_checkpoint,
    restore_checkpoint_auto,
    restore_checkpoint_orbax,
    save_checkpoint,
    save_checkpoint_orbax,
    save_params,
    wait_for_orbax_saves,
)
from pwcnet_tpu_torch.train_lib.metrics import MetricsLogger
from pwcnet_tpu_torch.train_lib.schedule import DEFAULT_BOUNDARIES, make_lr, piecewise_halving
from pwcnet_tpu_torch.train_lib.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_forward,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "DEFAULT_BOUNDARIES", "MetricsLogger", "TrainState", "create_train_state", "latest_checkpoint",
    "load_params", "make_eval_step", "make_forward", "make_loss_fn", "make_lr", "make_train_step",
    "piecewise_halving", "restore_checkpoint", "restore_checkpoint_auto", "restore_checkpoint_orbax",
    "save_checkpoint", "save_checkpoint_orbax", "save_params", "wait_for_orbax_saves",
]
