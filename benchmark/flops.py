"""The analytic model FLOPs of one frame pair, worked out from a
configuration's shapes alone, whatever implements the work.

- a 3x3 conv: ``2 * 9 * Cin * Cout`` a output pixel, plus its bias add;
- a LeakyReLU: 1 an element;
- a cost volume: ``2 * C`` a tap and pixel (the products and their mean),
  plus its LeakyReLU;
- a bilinear warp: 7 a channel and pixel (four products, three sums) and
  10 a pixel for the corners and weights;
- TF1's integer upscale by ``f``: 3 an output element of each axis pass
  (one lerp), and the scale after it;
- a train step: three forwards (the forward, and the backward's data and
  weight gradients).

``conv_flops`` is the convolutions' part alone, as
``torch.utils.flop_counter`` counts them.
"""

from __future__ import annotations

__all__ = ["conv_flops", "pair_flops"]

PYRAMID_FILTERS = (16, 32, 64, 96, 128, 192)
EST_FILTERS = (128, 128, 96, 64, 32)
CONTEXT_FILTERS = (128, 128, 128, 96, 64, 32, 2)


def _convs(config: dict, h: int, w: int):
    """(Cin, Cout, output pixels) of every conv of one pair's forward."""
    n, taps = config["num_levels"], (2 * config["search_range"] + 1) ** 2
    per_level = 2 if config["model"] == "PWCNet" else 3
    out = []
    for _frame in range(2):
        cin, hh, ww = 3, h, w
        for level in range(n):
            hh, ww = -(-hh // 2), -(-ww // 2)
            for _ in range(per_level):
                out.append((cin, PYRAMID_FILTERS[level], hh * ww))
                cin = PYRAMID_FILTERS[level]
    for l in range(config["output_level"] + 1):
        k = n - l
        px = (h >> k) * (w >> k)
        if config["model"] == "PWCNet":
            cin = taps + PYRAMID_FILTERS[k - 1] + 2
        else:
            cin = taps + PYRAMID_FILTERS[k - 1] + (0 if l == 0 else 2 + EST_FILTERS[-1])
        for cout in EST_FILTERS + (2,):
            out.append((cin, cout, px))
            cin = cout
    k = n - config["output_level"]
    cin = 2 + EST_FILTERS[-1]
    for cout in CONTEXT_FILTERS:
        out.append((cin, cout, (h >> k) * (w >> k)))
        cin = cout
    return out


def conv_flops(config: dict, h: int, w: int) -> int:
    """The convolutions' multiply-adds of one pair's forward, times 2."""
    return sum(2 * 9 * cin * cout * px for cin, cout, px in _convs(config, h, w))


def _upscale(c: int, hh: int, ww: int, f: int) -> int:
    return 3 * c * (f * hh * ww) + 3 * c * (f * hh * f * ww) + c * f * f * hh * ww


def pair_flops(config: dict, h: int, w: int, train: bool = False) -> int:
    """FLOPs of one pair's forward on (h, w) frames; three forwards with ``train``."""
    n, taps = config["num_levels"], (2 * config["search_range"] + 1) ** 2
    total = conv_flops(config, h, w)
    total += sum(2 * cout * px for _, cout, px in _convs(config, h, w))  # bias and LeakyReLU
    legacy = config["model"] == "PWCNet"
    for l in range(config["output_level"] + 1):
        k = n - l
        hh, ww, c = h >> k, w >> k, PYRAMID_FILTERS[k - 1]
        px = hh * ww
        total += px * taps * (2 * c + 1)
        if l > 0 or legacy:
            total += px * (7 * c + 10)
        if l < config["output_level"]:
            total += _upscale(2 if legacy else 2 + EST_FILTERS[-1], hh, ww, 2)
    k = n - config["output_level"]
    total += _upscale(2, h >> k, w >> k, 2 ** k)
    return 3 * total if train else total
