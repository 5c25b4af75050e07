"""Frozen work counts of RAFT's forward, worked out from a configuration's
shapes alone, whatever implements the work.

FLOPs of one pair (``pair_flops``), the rules of ``flops.py`` where they
apply:

- a conv: ``2 kh kw Cin Cout`` an output pixel, plus its bias add;
- ReLU, sigmoid, tanh, a residual add, a scale: 1 an element; an instance
  norm 5 (sum, square, sum, subtract, scale), an eval BatchNorm 2;
- a GRU pass: 5 an element of the hidden state (``r h``, ``1 - z``, two
  products, the sum) besides its convs and gates;
- the all-pairs correlation: ``2 C`` a pair of pixels (the products and
  their sum); ``f1``'s scale by ``1 / sqrt(C)``: 1 an element; a 2x2
  average pool: 4 an output (three adds, one scale);
- a lookup tap: 7 (four products, three sums of the bilinear blend);
  the coordinates: 4 an update and pixel (the flow, the delta's add);
- the convex upsample: a softmax of 9, 3 an element (exp, sum, divide);
  the weighted sum, 2 a tap and output channel; ``8 flow``, 1 an element;
- the mask head and the upsample once a forward, after the last update.

``conv_flops`` and ``corr_flops`` are the convolutions' and the all-pairs
product's parts alone, as ``torch.utils.flop_counter`` counts them.

Least bytes and float32 operations, for the rooflines (``kernels.bound``):

- ``lookup_work``, one lookup of one pair: per query pixel and level, the
  ``(2r + 2)**2`` float32 window that the bilinear taps read, the ``(2r +
  1)**2`` float32 outputs written, and per query pixel its two float32
  coordinates read;
- ``corr_volume_work``, the all-pairs product and the pooled levels of
  one pair, each read once and written once by its own step: the product
  reads ``f1`` and ``f2`` and writes level 0; each pool reads the level
  above and writes its own.
"""

from __future__ import annotations

from benchmark import kernels

__all__ = ["conv_flops", "corr_flops", "pair_flops", "lookup_work", "corr_volume_work", "lookup_bound",
           "corr_volume_bound"]

F32 = 4
ENCODER_LAYERS = ((64, 1), (96, 2), (128, 2))


def _encoder(out: int, h: int, w: int):
    """(kh, kw, Cin, Cout, output pixels, what follows) of every conv of one
    encoder pass on an (h, w) frame: ``"norm relu"``, ``"norm"`` (a
    shortcut's 1x1 conv) or ``""`` (the output conv)."""
    hh, ww = -(-h // 2), -(-w // 2)
    convs = [(7, 7, 3, 64, hh * ww, "norm relu")]
    cin = 64
    for c, stride in ENCODER_LAYERS:
        if stride == 2:
            hh, ww = -(-hh // 2), -(-ww // 2)
            convs.append((1, 1, cin, c, hh * ww, "norm"))
        convs += [(3, 3, cin, c, hh * ww, "norm relu")] + [(3, 3, c, c, hh * ww, "norm relu")] * 3
        cin = c
    convs.append((1, 1, 128, out, hh * ww, ""))
    return convs


def _block_outputs(h: int, w: int) -> int:
    """Elements of the residual blocks' outputs, ``relu(x + y)``, of one encoder pass."""
    hh, ww, total = -(-h // 2), -(-w // 2), 0
    for c, stride in ENCODER_LAYERS:
        if stride == 2:
            hh, ww = -(-hh // 2), -(-ww // 2)
        total += 2 * c * hh * ww
    return total


def _update(config: dict, px: int):
    """(kh, kw, Cin, Cout, pixels) of the convs of one update at 1/8 resolution."""
    taps = config["corr_levels"] * (2 * config["corr_radius"] + 1) ** 2
    hid = config["hidden_dim"]
    gru_in = hid + config["context_dim"] + 128
    return [
        (1, 1, taps, 256, px), (3, 3, 256, 192, px), (7, 7, 2, 128, px), (3, 3, 128, 64, px),
        (3, 3, 192 + 64, 128 - 2, px),
        *[(1, 5, gru_in, hid, px)] * 3, *[(5, 1, gru_in, hid, px)] * 3,
        (3, 3, hid, 256, px), (3, 3, 256, 2, px),
    ]


def _mask(config: dict, px: int):
    return [(3, 3, config["hidden_dim"], 256, px), (1, 1, 256, 64 * 9, px)]


def _all_convs(config: dict, h: int, w: int):
    px = (h // 8) * (w // 8)
    enc = [c[:5] for c in _encoder(config["feature_dim"], h, w)] * 2
    enc += [c[:5] for c in _encoder(config["hidden_dim"] + config["context_dim"], h, w)]
    return enc + _update(config, px) * config["iters"] + _mask(config, px)


def conv_flops(config: dict, h: int, w: int) -> int:
    """The convolutions' multiply-adds of one pair's forward, times 2."""
    return sum(2 * kh * kw * cin * cout * px for kh, kw, cin, cout, px in _all_convs(config, h, w))


def corr_flops(config: dict, h: int, w: int) -> int:
    """The all-pairs product's multiply-adds of one pair, times 2."""
    px = (h // 8) * (w // 8)
    return 2 * px * px * config["feature_dim"]


def _pool_levels(config: dict, h: int, w: int):
    """(h_k, w_k) of the correlation pyramid's levels, finest first."""
    hh, ww = h // 8, w // 8
    out = [(hh, ww)]
    for _ in range(config["corr_levels"] - 1):
        hh, ww = hh // 2, ww // 2
        out.append((hh, ww))
    return out


def pair_flops(config: dict, h: int, w: int) -> int:
    """FLOPs of one pair's forward on (h, w) frames."""
    px = (h // 8) * (w // 8)
    hid, c = config["hidden_dim"], config["feature_dim"]
    taps = config["corr_levels"] * (2 * config["corr_radius"] + 1) ** 2
    total = conv_flops(config, h, w) + corr_flops(config, h, w)
    total += sum(cout * p for _, _, _, cout, p in _all_convs(config, h, w))  # bias adds
    for enc_out, norm_cost in ((c, 5), (c, 5), (hid + config["context_dim"], 2)):
        for _, _, _, cout, p, post in _encoder(enc_out, h, w):
            total += cout * p * (norm_cost * ("norm" in post) + ("relu" in post))
        total += 2 * _block_outputs(h, w)  # the residual add and its ReLU
    total += px * (hid + config["context_dim"])  # tanh, relu
    total += px * c + sum(4 * hh * ww * px for hh, ww in _pool_levels(config, h, w)[1:])
    per_update = 7 * taps + 4  # the lookup's blend, the coordinates
    per_update += 256 + 192 + 128 + 64 + 126  # the motion encoder's ReLUs
    per_update += 2 * (3 * hid + 5 * hid)  # two GRU passes: gates and their arithmetic
    per_update += 256  # the flow head's ReLU
    total += config["iters"] * px * per_update
    total += px * (256 + 576 + 2)  # the mask head's ReLU, its 0.25, 8 flow
    total += px * 64 * (9 * 3 + 2 * 9 * 2)  # softmax, weighted sum
    return total


def lookup_work(config: dict, h: int, w: int) -> tuple:
    """(bytes, float32 operations) of one lookup of one pair."""
    px, r = (h // 8) * (w // 8), config["corr_radius"]
    levels = config["corr_levels"]
    n_bytes = px * (levels * ((2 * r + 2) ** 2 + (2 * r + 1) ** 2) + 2) * F32
    return n_bytes, px * levels * 7 * (2 * r + 1) ** 2


def corr_volume_work(config: dict, h: int, w: int) -> list:
    """[(bytes, float32 operations)] of the product and of each pool, one pair."""
    px, c = (h // 8) * (w // 8), config["feature_dim"]
    levels = _pool_levels(config, h, w)
    out = [((2 * px * c + px * px) * F32, corr_flops(config, h, w) + px * c)]
    for (ha, wa), (hb, wb) in zip(levels, levels[1:]):
        out.append((px * (ha * wa + hb * wb) * F32, 4 * px * hb * wb))
    return out


def lookup_bound(config: dict, h: int, w: int) -> float:
    """Least seconds of one pair's lookups, all ``iters`` of them."""
    return config["iters"] * kernels.bound("float32", *lookup_work(config, h, w))


def corr_volume_bound(config: dict, h: int, w: int) -> float:
    """Least seconds of one pair's correlation product and pyramid."""
    return sum(kernels.bound("float32", *work) for work in corr_volume_work(config, h, w))
