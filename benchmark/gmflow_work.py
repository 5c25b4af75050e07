"""Frozen work counts of GMFlow's forward, worked out from a
configuration's shapes alone, whatever implements the work.

FLOPs of one pair (``pair_flops``), the rules of ``raft_work.py`` where
they apply:

- a conv: ``2 kh kw Cin Cout`` an output pixel, plus its bias add where it
  has a bias (the encoder's shortcuts and output conv, the upsampler's);
  an instance norm 5 an element, a ReLU 1, a residual add and its ReLU 2;
  the frames' normalisation 2 an input element;
- a Linear: ``2 Cin Cout`` a token, plus its bias add where it has one;
- an attention of a token over ``L`` keys: ``2 L C`` for the scores,
  ``2 L Cv`` for the weighted sum of the values, the softmax 4 a score
  (the scale, exp, sum, divide) and the shifted mask 1 a score;
- a LayerNorm 7 an element (5 as the instance norm, the scale and the
  shift), an exact GELU 5, a residual add 1; the positions' add 1 an
  element; the matching's grid subtracted 2 a pixel;
- the convex upsample as RAFT's: a softmax of 9, 3 an element; the
  weighted sum, 2 a tap and output channel; ``8 flow``, 2 a pixel.

``conv_flops`` and ``matmul_flops`` are the convolutions' and the
products' parts alone (Linears, every attention's two products), as
``torch.utils.flop_counter`` counts them.

Least times, for the rooflines (``kernels.bound`` at the bf16 peak,
989 TFLOP/s, or 3.35 TB/s): one entry a unit of work that no
implementation need split, every intermediate kept on the chip, scores
included, whatever implements it:

- ``transformer_work``, the 12 layers of the 6 blocks of one pair (both
  frames' tokens): each layer's FLOPs (projections, window attention,
  ``merge``, the norms, the FFN, the residual add), and its bytes: its
  source and (cross-attention) target read once and its output written
  once in bf16, its weights read once;
- ``match_work``, the global matching (f0 and f1 read in bf16, the flow
  written in float32) and the propagation (f0 and the flow read, the two
  Linears' weights, the flow written).
"""

from __future__ import annotations

from benchmark import kernels
from benchmark.raft_work import _block_outputs, _encoder

__all__ = ["conv_flops", "matmul_flops", "pair_flops", "layer_flops", "transformer_work", "match_work",
           "transformer_bound", "match_bound"]

BF16, F32 = 2, 4


def _grid(config: dict, h: int, w: int) -> tuple:
    """(tokens of one frame, channels, tokens of a window)."""
    n = (h // 8) * (w // 8)
    return n, config["feature_channels"], n // config["attn_splits"] ** 2


def _upsampler(config: dict, px: int):
    c, f = config["feature_channels"], config["upsample_factor"]
    return [(3, 3, 2 + c, 256, px), (1, 1, 256, f * f * 9, px)]


def conv_flops(config: dict, h: int, w: int) -> int:
    """The convolutions' multiply-adds of one pair's forward, times 2."""
    convs = [c[:5] for c in _encoder(config["feature_channels"], h, w)] * 2
    convs += _upsampler(config, (h // 8) * (w // 8))
    return sum(2 * kh * kw * cin * cout * px for kh, kw, cin, cout, px in convs)


def _layer_products(config: dict, h: int, w: int, ffn: bool) -> int:
    n, c, win = _grid(config, h, w)
    t, wide = 2 * n, 2 * c * config["ffn_dim_expansion"]
    flops = 4 * 2 * t * c * c + 2 * 2 * t * win * c
    return flops + (2 * t * 2 * c * wide + 2 * t * wide * c if ffn else 0)


def _global_products(config: dict, h: int, w: int) -> tuple:
    """(the matching's, the propagation's) products of one pair."""
    n, c, _ = _grid(config, h, w)
    attention = 2 * n * n * c + 2 * n * n * 2
    return attention, attention + 2 * 2 * n * c * c


def matmul_flops(config: dict, h: int, w: int) -> int:
    """The Linears' and the attentions' multiply-adds of one pair, times 2."""
    blocks = config["num_transformer_layers"]
    layers = blocks * (_layer_products(config, h, w, False) + _layer_products(config, h, w, True))
    return layers + sum(_global_products(config, h, w))


def layer_flops(config: dict, h: int, w: int, ffn: bool, shifted: bool) -> int:
    """FLOPs of one transformer layer of one pair."""
    n, c, win = _grid(config, h, w)
    t, wide = 2 * n, 2 * c * config["ffn_dim_expansion"]
    flops = _layer_products(config, h, w, ffn) + t * win * (4 + shifted) + t * c * (7 + 1)
    return flops + (t * wide * 5 + t * c * 7 if ffn else 0)


def _layers(config: dict, h: int, w: int):
    """(ffn, shifted) of each layer, in order."""
    return [(ffn, b % 2 == 1) for b in range(config["num_transformer_layers"]) for ffn in (False, True)]


def _match_flops(config: dict, h: int, w: int) -> tuple:
    n, c, _ = _grid(config, h, w)
    match, prop = _global_products(config, h, w)
    return match + 4 * n * n + 2 * n, prop + 4 * n * n + 2 * n * c


def pair_flops(config: dict, h: int, w: int) -> int:
    """FLOPs of one pair's forward on (h, w) frames."""
    n, c, _ = _grid(config, h, w)
    total = conv_flops(config, h, w) + 2 * 3 * h * w * 2  # the convs, both frames' normalisation
    for _, _, _, cout, px, post in _encoder(c, h, w):
        biased = post in ("norm", "")  # the shortcuts' 1x1 convs and the output conv
        total += 2 * cout * px * (5 * ("norm" in post) + ("relu" in post) + biased)
    total += 2 * 2 * _block_outputs(h, w)  # each frame's residual adds and their ReLUs
    total += 2 * n * c  # the positions
    total += sum(layer_flops(config, h, w, ffn, shifted) for ffn, shifted in _layers(config, h, w))
    total += sum(_match_flops(config, h, w))
    f = config["upsample_factor"]
    total += n * (256 + f * f * 9 + 256 + 2)  # the upsampler's biases, its ReLU, 8 flow
    total += n * f * f * (9 * 3 + 2 * 9 * 2)  # the convex upsample's softmax and weighted sum
    return total


def transformer_work(config: dict, h: int, w: int) -> list:
    """[(bytes, FLOPs)] of each of the 12 layers of one pair."""
    n, c, _ = _grid(config, h, w)
    t, wide = 2 * n, 2 * c * config["ffn_dim_expansion"]
    out = []
    for ffn, shifted in _layers(config, h, w):
        weights = 4 * c * c + 2 * c + (2 * c * wide + wide * c + 2 * c if ffn else 0)
        out.append(((t * c * (3 if ffn else 2) + weights) * BF16, layer_flops(config, h, w, ffn, shifted)))
    return out


def match_work(config: dict, h: int, w: int) -> list:
    """[(bytes, FLOPs)] of the matching and of the propagation of one pair."""
    n, c, _ = _grid(config, h, w)
    match, prop = _match_flops(config, h, w)
    return [(2 * n * c * BF16 + n * 2 * F32, match),
            (n * c * BF16 + 2 * (c * c + c) * BF16 + 2 * n * 2 * F32, prop)]


def transformer_bound(config: dict, h: int, w: int) -> float:
    """Least seconds of one pair's 12 transformer layers."""
    return sum(kernels.bound("bfloat16", *work) for work in transformer_work(config, h, w))


def match_bound(config: dict, h: int, w: int) -> float:
    """Least seconds of one pair's global matching and propagation."""
    return sum(kernels.bound("bfloat16", *work) for work in match_work(config, h, w))
