"""Train and eval steps (counterpart of ``pwcnet_tpu/train_lib/step.py``).

- loss = pyramid loss (multiscale or robust) + gamma * sum ||v||^2 / 2;
- Adam with TF defaults (b1=0.9, b2=0.999, eps=1e-8, eps outside the
  square root, bias correction) under the piecewise-halving schedule, as
  ``optax.adam``: the learning rate of step ``n`` (0-based) is ``lr(n)``;
- float32 master parameters; the model computes in its ``compute_dtype``
  and the loss is taken in float32.

PyTorch's idiom replaces the functional one: the state owns the model
(its parameters are the master copy) and the Adam moments, and a step
updates them in place instead of returning new arrays.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Union

import torch

from pwcnet_tpu_torch import losses
from pwcnet_tpu_torch.inference import resolve_device
from pwcnet_tpu_torch.models.conv import glorot_init_
from pwcnet_tpu_torch.train_lib.schedule import make_lr

__all__ = ["TrainState", "create_train_state", "make_loss_fn", "make_train_step", "make_eval_step"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    """Parameters (the model's, float32), Adam moments by parameter name,
    the step count and the learning rate (a float or a schedule)."""

    model: torch.nn.Module
    mu: dict
    nu: dict
    step: int = 0
    learning_rate: Union[float, Callable[[int], float]] = 1e-4

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.learning_rate(self.step) if callable(self.learning_rate) else self.learning_rate


def create_train_state(
    model: torch.nn.Module,
    generator: Optional[torch.Generator] = None,
    learning_rate: float = 1e-4,
    lr_scheduling: bool = True,
    device=None,
) -> TrainState:
    """A fresh state: parameters drawn anew from ``generator`` (flax's
    default init; left as they are when it is None), float32, on
    ``device`` (CUDA unless the caller asks for the CPU), zero moments."""
    if generator is not None:
        glorot_init_(model, generator)
    model.to(device=resolve_device(device), dtype=torch.float32)
    params = dict(model.named_parameters())
    return TrainState(
        model=model,
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        step=0,
        learning_rate=make_lr(learning_rate, lr_scheduling),
    )


def make_loss_fn(
    model: torch.nn.Module,
    loss_name: str = "multiscale",
    weights: Sequence[float] = losses.DEFAULT_WEIGHTS,
    gamma: float = 4e-4,
    epsilon: float = 0.02,
    q: float = 0.4,
    decoupled_wd: bool = False,
) -> Callable:
    """(images (B, 2, H, W, 3), flows_gt (B, H, W, 2)) -> (loss, metrics)
    on ``model``'s current parameters.

    ``decoupled_wd``: report the weight-decay term in the loss value but
    keep it out of the gradient (the train step adds the identical
    ``gamma * p`` per tensor instead)."""
    if loss_name == "multiscale":
        criterion = functools.partial(losses.multiscale_loss, weights=weights)
    elif loss_name == "robust":
        criterion = functools.partial(losses.multirobust_loss, weights=weights, epsilon=epsilon, q=q)
    else:
        raise ValueError(f"loss must be 'multiscale' or 'robust': {loss_name!r}")

    def loss_fn(images: torch.Tensor, flows_gt: torch.Tensor):
        flows_final, pyramid = model(images[:, 0], images[:, 1])
        # losses in float32 whatever the compute dtype
        flows_final = flows_final.float()
        pyramid = [f.float() for f in pyramid]
        flows_gt = flows_gt.float()
        data_loss = criterion(flows_gt, pyramid)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not decoupled_wd):
            decay = losses.weight_decay(model.parameters())
        total = data_loss + gamma * decay
        metrics = {
            "loss": total.detach(),
            "data_loss": data_loss.detach(),
            "epe": losses.epe(flows_gt, flows_final.detach()),
        }
        return total, metrics

    return loss_fn


def make_train_step(model: torch.nn.Module, **loss_kwargs) -> Callable:
    """(state, images, flows_gt) -> (state, metrics); ``state`` is updated
    in place and returned.

    The weight-decay gradient is added analytically (``gamma * p`` per
    tensor) instead of differentiating the 110 per-tensor reductions; the
    reported loss still includes the term. The metrics stay on the device."""
    gamma = loss_kwargs.get("gamma", 4e-4)
    loss_fn = make_loss_fn(model, decoupled_wd=True, **loss_kwargs)

    def train_step(state: TrainState, images: torch.Tensor, flows_gt: torch.Tensor):
        named = dict(state.model.named_parameters())
        params = list(named.values())
        total, metrics = loss_fn(images, flows_gt)
        grads = list(torch.autograd.grad(total, params))
        with torch.no_grad():
            grads = torch._foreach_add(grads, params, alpha=gamma)
            mus = [state.mu[k] for k in named]
            nus = [state.nu[k] for k in named]
            lr = state.lr()
            count = state.step + 1
            torch._foreach_mul_(mus, ADAM_B1)
            torch._foreach_add_(mus, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nus, ADAM_B2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - ADAM_B2)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, 1.0 - ADAM_B2**count))
            torch._foreach_add_(denom, ADAM_EPS)
            torch._foreach_addcdiv_(params, mus, denom, value=-lr / (1.0 - ADAM_B1**count))
            state.step = count
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, **loss_kwargs) -> Callable:
    """(state, images, flows_gt) -> metrics, with no update."""
    loss_fn = make_loss_fn(model, **loss_kwargs)

    def eval_step(state: TrainState, images: torch.Tensor, flows_gt: torch.Tensor):
        with torch.no_grad():
            return loss_fn(images, flows_gt)[1]

    return eval_step
