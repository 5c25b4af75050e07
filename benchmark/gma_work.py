"""Frozen work counts of GMA's forward, worked out from a configuration's
shapes alone, whatever implements the work: RAFT's (``raft_work``) and
GMA's own terms.

FLOPs of one pair (``pair_flops``), the rules of ``raft_work.py`` and
``gmflow_work.py`` where they apply:

- RAFT's forward at the configuration's sizes (``raft_work.pair_flops``);
- the GRU's six convs read 128 more input channels (the global motion
  features): ``2 kh kw 128 Cout`` more an output pixel, each update;
- the attention, once: ``to_qk`` (``2 Cin Cout`` a pixel, no bias), the
  scores ``2 N C`` a query over N keys, the softmax 4 a score (the scale,
  exp, sum, divide);
- the aggregation, each update: ``to_v`` (``2 C C`` a pixel), the product
  ``2 N C`` a query, and ``mf + gamma out``, 2 an element.

``conv_flops`` and ``matmul_flops`` are the convolutions' part and the
products' part (the all-pairs correlation, the scores and the
aggregations), as ``torch.utils.flop_counter`` counts them on the
reference.

Least time, for the roofline (``kernels.bound`` at the bf16 peak, 989
TFLOP/s, or 3.35 TB/s): ``aggregate_work``, the attention's score product
once and the ``iters`` value products, against the least bytes whatever
implements them: q and k read once, and at each update v read and the
output written, in bf16. It holds no stored probabilities: a design that
keeps them reads them again at every update, one that recomputes them
does the product again, and the bound counts neither.
"""

from __future__ import annotations

from benchmark import kernels, raft_work

__all__ = ["conv_flops", "matmul_flops", "pair_flops", "aggregate_work", "aggregate_bound"]

BF16 = 2
GRU_KERNEL = 5  # each GRU conv is (1, 5) or (5, 1)


def _grid(config: dict, h: int, w: int) -> tuple:
    """(pixels of the 1/8 grid, the attention's channels)."""
    return (h // 8) * (w // 8), config["context_dim"]


def _own_convs(config: dict, h: int, w: int) -> int:
    """GMA's conv FLOPs beyond RAFT's: the GRU's wider input, ``to_qk`` and ``to_v``."""
    n, c = _grid(config, h, w)
    hid = config["hidden_dim"]
    gru = 6 * 2 * GRU_KERNEL * 128 * hid * n
    return 2 * c * 2 * c * n + config["iters"] * (gru + 2 * 128 * c * n)


def _products(config: dict, h: int, w: int) -> int:
    """The score product once and the ``iters`` value products, times 2."""
    n, c = _grid(config, h, w)
    return (1 + config["iters"]) * 2 * n * n * c


def conv_flops(config: dict, h: int, w: int) -> int:
    """The convolutions' multiply-adds of one pair's forward, times 2."""
    return raft_work.conv_flops(config, h, w) + _own_convs(config, h, w)


def matmul_flops(config: dict, h: int, w: int) -> int:
    """The all-pairs correlation's, the scores' and the aggregations' multiply-adds, times 2."""
    return raft_work.corr_flops(config, h, w) + _products(config, h, w)


def pair_flops(config: dict, h: int, w: int) -> int:
    """FLOPs of one pair's forward on (h, w) frames."""
    n, c = _grid(config, h, w)
    softmax = 4 * n * n
    epilogue = config["iters"] * 2 * n * 128
    return raft_work.pair_flops(config, h, w) + _own_convs(config, h, w) + _products(config, h, w) + softmax + epilogue


def aggregate_work(config: dict, h: int, w: int) -> tuple:
    """(bytes, FLOPs) of one pair's attention products."""
    n, c = _grid(config, h, w)
    return (2 * n * c + config["iters"] * 2 * n * c) * BF16, _products(config, h, w)


def aggregate_bound(config: dict, h: int, w: int) -> float:
    """Least seconds of one pair's score product and value products."""
    return kernels.bound("bfloat16", *aggregate_work(config, h, w))
