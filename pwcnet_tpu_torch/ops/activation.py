"""LeakyReLU whose gradient at exactly zero is 1, as in the JAX package.

``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``: at ``x == 0`` the
gradient is 1. ``F.leaky_relu`` differentiates as ``x > 0 ? 1 : slope`` and
gives the slope there. Exact zeros are real in this model: with zero
biases every conv over a black image region is exactly zero, and the two
conventions then disagree on the bias gradient by a factor of ten. The
forward values are identical.

The sign is read from the output (LeakyReLU preserves it), so the input is
not kept for the backward; the kernels' backward (K4, K6) read it from
their saved outputs the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["leaky_relu", "leaky_mask"]


def leaky_mask(y: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """d leaky_relu / dx from the activation's output (or input): 1 where
    ``y >= 0``, else ``slope``, in float32."""
    one = torch.ones((), dtype=torch.float32, device=y.device)
    return torch.where(y >= 0, one, one * slope)


class _LeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        y = F.leaky_relu(x, slope)
        ctx.save_for_backward(y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, g, g * ctx.slope), None


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)`` with gradient 1 at ``x == 0``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, slope)
    return F.leaky_relu(x, slope)
