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

Across a (data, spatial) mesh (``mesh=``, ``parallel.make_mesh``) each rank
holds its slice of the global batch and, under H-sharding, its stripe of
the rows. Its loss is its partial sum: every loss row and every batch
element is counted by exactly one rank (``losses.scored_rows``), divided by
the global batch. The robust loss is not a sum, ``sum_l w_l (L1_l + eps)^q``:
each level's L1 is summed over the ranks in the forward, and each rank then
differentiates its partial L1 times the global factor ``w_l q (L1_l +
eps)^(q-1)``. The parameter gradients are summed over all ranks with one
all-reduce of the flattened gradients (not DistributedDataParallel: its
buckets would reduce during the backward, while the halo exchanges of the
sharded model run in it), the decay gradient ``gamma * p`` is added once,
after the reduce, and Adam runs the same update on every rank. The metrics
are the global ones.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence, Union

import torch

from pwcnet_tpu_torch import losses
from pwcnet_tpu_torch.ops.resize import device_table
from pwcnet_tpu_torch.train_lib.schedule import make_lr
from pwcnet_tpu_torch.utils.device import resolve_device
from pwcnet_tpu_torch.utils.profiling import span
from pwcnet_tpu_torch.weights import init_params

__all__ = ["TrainState", "create_train_state", "make_loss_fn", "make_train_step", "make_eval_step", "make_forward"]

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
    key=None,
    learning_rate: float = 1e-4,
    lr_scheduling: bool = True,
    device=None,
) -> TrainState:
    """A fresh state: parameters drawn anew from ``key`` (a
    ``prng.PRNGKey``: the JAX ``create_train_state(model, key, ...)``'s
    parameters, bit for bit; left as they are when it is None), float32, on
    ``device`` (CUDA unless the caller asks for the CPU), zero moments."""
    if key is not None:
        init_params(model, key)
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
    mesh=None,
) -> Callable:
    """(images (B, 2, H, W, 3), flows_gt (B, H, W, 2)) -> (loss, metrics)
    on ``model``'s current parameters.

    ``decoupled_wd``: report the weight-decay term in the loss value but
    keep it out of the gradient (the train step adds the identical
    ``gamma * p`` per tensor instead). With ``mesh`` the inputs are this
    rank's part of the batch, the returned loss is this rank's share of the
    objective (the sum over the ranks is the loss) and the metrics are the
    global ones."""
    if mesh is not None:
        return _mesh_loss_fn(model, mesh, loss_name, weights, gamma, epsilon, q, decoupled_wd)
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


def _mesh_loss_fn(model, mesh, loss_name, weights, gamma, epsilon, q, decoupled_wd):
    from pwcnet_tpu_torch.parallel import global_sum

    if loss_name not in ("multiscale", "robust"):
        raise ValueError(f"loss must be 'multiscale' or 'robust': {loss_name!r}")
    n, index = mesh.spatial, mesh.spatial_index
    world = mesh.data * mesh.spatial

    def loss_fn(images: torch.Tensor, flows_gt: torch.Tensor):
        flows_final, pyramid = model(images[:, 0], images[:, 1])
        frame_rows = images.shape[2] * n
        sharded = model.sharded_levels(frame_rows)
        gt = flows_gt.float()
        ws = list(weights)[: len(pyramid)]
        norm = "l2" if loss_name == "multiscale" else "l1"
        sums = losses.level_sums(gt / 20.0, [f.float() for f in pyramid[: len(ws)]], frame_rows, index, n,
                                 sharded, norm)
        g, p = losses.scored_rows(gt, flows_final.float(), frame_rows, index, n, sharded[-1])
        epe_sum = ((g - p) ** 2).sum(3).sqrt().sum()
        # one reduction: the per-level sums (the robust loss needs them in
        # the forward) and the EPE sum
        total = global_sum(torch.cat([sums.detach(), epe_sum.detach()[None]]))
        batch = images.shape[0] * mesh.data
        level = total[:-1] / batch
        w = device_table(("loss_weights", tuple(ws)), level.device,
                         lambda dev: torch.tensor(ws, dtype=torch.float32, device=dev))
        if loss_name == "multiscale":
            data_loss = (w * level).sum()
            objective = (w * sums).sum() / batch
        else:
            data_loss = (w * (level + epsilon) ** q).sum()
            objective = (w * q * (level + epsilon) ** (q - 1) * sums).sum() / batch
        with torch.set_grad_enabled(torch.is_grad_enabled() and not decoupled_wd):
            decay = losses.weight_decay(model.parameters())
        if decay.requires_grad:
            objective = objective + gamma * decay / world  # counted once over the ranks
        metrics = {
            "loss": data_loss + gamma * decay.detach(),
            "data_loss": data_loss,
            "epe": total[-1] / (batch * frame_rows * flows_gt.shape[2]),
        }
        return objective, metrics

    return loss_fn


def make_train_step(model: torch.nn.Module, mesh=None, **loss_kwargs) -> Callable:
    """(state, images, flows_gt) -> (state, metrics); ``state`` is updated
    in place and returned.

    The weight-decay gradient is added analytically (``gamma * p`` per
    tensor) instead of differentiating the 110 per-tensor reductions; the
    reported loss still includes the term. The metrics stay on the device.
    A step gives the same bits from the same state and batch in every run
    on the card, as the JAX step does under XLA: the port's kernels and
    plain ops sum in a fixed order, and cuDNN runs its deterministic
    algorithms for the step's forward and backward.
    With ``mesh`` the images and flows are this rank's part of the batch and
    the gradients are summed over all ranks before the decay is added.
    The step is a span (``utils.profiling``), ``step``, with ``step.forward``
    (the loss, model included), ``step.backward``, ``step.allreduce`` (mesh
    only) and ``step.adam`` (the decay and the update) inside it."""
    gamma = loss_kwargs.get("gamma", 4e-4)
    loss_fn = make_loss_fn(model, decoupled_wd=True, mesh=mesh, **loss_kwargs)

    def train_step(state: TrainState, images: torch.Tensor, flows_gt: torch.Tensor):
        with span("step", images.shape[0]):
            return _step(state, images, flows_gt)

    def _step(state: TrainState, images: torch.Tensor, flows_gt: torch.Tensor):
        named = dict(state.model.named_parameters())
        params = list(named.values())
        # cuDNN's deterministic algorithms for the forward and the backward
        # (remat's recompute runs inside the grad call): its default float32
        # weight and data gradients add their terms in an order that varies
        # between runs. Only this flag is touched; the caller's comes back.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with span("step.forward"):
                total, metrics = loss_fn(images, flows_gt)
            with span("step.backward"):
                grads = list(torch.autograd.grad(total, params))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if mesh is not None:
            with span("step.allreduce"):
                grads = _sum_over_ranks(grads)
        with span("step.adam"), torch.no_grad():
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


def _sum_over_ranks(grads: list) -> list:
    """Every gradient summed over all ranks, in one flattened all-reduce."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    from pwcnet_tpu_torch.parallel import global_sum

    flat = global_sum(_flatten_dense_tensors(grads))
    return list(_unflatten_dense_tensors(flat, grads))


def make_eval_step(model: torch.nn.Module, mesh=None, **loss_kwargs) -> Callable:
    """(state, images, flows_gt) -> metrics, with no update (global metrics
    with ``mesh``)."""
    loss_fn = make_loss_fn(model, mesh=mesh, **loss_kwargs)

    def eval_step(state: TrainState, images: torch.Tensor, flows_gt: torch.Tensor):
        with torch.no_grad():
            return loss_fn(images, flows_gt)[1]

    return eval_step


def make_forward(model: torch.nn.Module, with_pyramid: bool = True) -> Callable:
    """Inference: (images_0, images_1) -> whatever ``model`` returns
    (``PWCDCNet``: final flow and pyramid; ``PWCNet``: also frame 0's
    features; ``RAFT``, ``GMA`` (RAFT's forward with its attention and
    aggregation) and ``GMFlow``: the final flow and the flow at 1/8
    resolution), under ``torch.inference_mode`` on the model's own
    parameters. ``with_pyramid`` is accepted and unused, as in the JAX
    package; unlike it, the function takes no parameters argument (the
    model owns them, as ``TrainState`` does)."""

    def forward(images_0: torch.Tensor, images_1: torch.Tensor):
        with torch.inference_mode():
            return model(images_0, images_1)

    return forward
