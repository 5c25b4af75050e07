"""Learning-rate schedules (counterpart of ``pwcnet_tpu/train_lib/schedule.py``).

The reference trains with Adam at lr=1e-4 under a piecewise-constant
halving schedule with boundaries [200k, 250k, 300k, 350k, 400k]. A
schedule is a function of the 0-based step count *before* the update, as
optax reads it: step ``n`` uses ``lr(n)``, and the rate halves at
``n == boundary``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

DEFAULT_BOUNDARIES = (200_000, 250_000, 300_000, 350_000, 400_000)

__all__ = ["piecewise_halving", "make_lr", "DEFAULT_BOUNDARIES"]


def piecewise_halving(
    base_lr: float, boundaries: Sequence[int] = DEFAULT_BOUNDARIES
) -> Callable[[int], float]:
    """lr / 2**i from the i-th boundary step on."""
    bounds = sorted(int(b) for b in boundaries)

    def lr(count: int) -> float:
        return base_lr * 0.5 ** sum(count >= b for b in bounds)

    return lr


def make_lr(base_lr: float, scheduling: bool = True) -> Union[float, Callable[[int], float]]:
    if scheduling:
        return piecewise_halving(base_lr)
    return base_lr
