"""The launch plan of the cost-volume backward (K4, and K8b with a row pad
of d), on the CPU.

The kernel (``csrc/cost_volume_bwd.cu``) needs an NVIDIA card
(tests/test_torch_kernels.py, ``cuda`` marker); what decides its coverage
and its summation order is Python or mirrors Python, and is held here:

- ``_common.cv_bwd_plan`` / ``cv_bwd_blocks``: the tile rows at the training
  shapes, at least two blocks an SM where the frame allows it, and the
  constants the plan shares with the source;
- a model of the one-launch grid (``_grid``, mirroring ``cv_bwd_tile``'s
  block and thread decomposition): df1's tiles over the h + 2 pad rows, then
  df0's, cover every output pixel and channel of both halves exactly once;
- a model of the gt staging (``_gt_source``): each tile stages exactly the
  (pixel, tap) pairs its outputs read, each once;
- a model of the tap loop (``_taps``): each accumulator takes its 81 taps
  v ascending, then u ascending (df0) or descending (df1), the order of
  the plain version and of the first body, from the window and gt slots
  that hold them.
"""

import re

import numpy as np
import pytest

from pwcnet_tpu_torch.ops.cuda import _build, _common

TW, CC = _common.CV_BWD_TILE_W, _common.CV_BWD_CHUNK
CPT, PX = 4, 4  # a thread's channels and tile columns (kCvbCPT, kCvbPX)
GROUPS = CC // CPT

# (B, H, W, C) of the five calls of the 384x448 training step, deep to fine
TRAIN = [(8, 6, 7, 192), (8, 12, 14, 128), (8, 24, 28, 96), (8, 48, 56, 64), (8, 96, 112, 32)]
# frames no tile divides, channel counts off the chunk and the 16-byte vector
EDGE = [(1, 5, 6, 3), (2, 9, 37, 40), (1, 9, 13, 5), (1, 17, 33, 40), (1, 3, 16, 192), (2, 1, 1, 8)]


def _threads(th):
    return th * (TW // PX) * GROUPS


def _grid(b, h, w, c, pad, th):
    """The blocks of one launch as ``cv_bwd_kernel`` reads its index: yields
    ``(df1, batch, y0, x0, c0)``, df1's blocks first; y0 is in the half's
    row coordinates (df1 from -pad)."""
    tiles_x, chunks = -(-w // TW), -(-c // CC)
    blocks1 = b * -(-(h + 2 * pad) // th) * tiles_x * chunks
    blocks0 = b * -(-h // th) * tiles_x * chunks
    for bid in range(blocks1 + blocks0):
        df1 = bid < blocks1
        local = bid if df1 else bid - blocks1
        res_pad = pad if df1 else 0
        tiles_y = -(-(h + 2 * res_pad) // th)
        c0 = local % chunks * CC
        t = local // chunks
        x0 = t % tiles_x * TW
        t //= tiles_x
        yield df1, t // tiles_y, t % tiles_y * th - res_pad, x0, c0


def _owned(th):
    """Per thread of a tile: the (row, column, channel) offsets it stores,
    from its (r, hx, cg) as the kernel splits threadIdx.x."""
    tid = np.arange(_threads(th))
    cg, hx, r = tid % GROUPS, tid // GROUPS % (TW // PX), tid // (GROUPS * (TW // PX))
    i, k = np.meshgrid(np.arange(PX), np.arange(CPT), indexing="ij")
    rows = np.repeat(r, PX * CPT)
    cols = (hx[:, None] * PX + i.ravel()[None]).ravel()
    chans = (cg[:, None] * CPT + k.ravel()[None]).ravel()
    return rows, cols, chans


def _coverage(b, h, w, c, pad, th):
    """How often each output (batch, row, column, channel) of df0 and df1 is stored."""
    cover = {False: np.zeros((b, h, w, c), np.int64), True: np.zeros((b, h + 2 * pad, w, c), np.int64)}
    rows, cols, chans = _owned(th)
    for df1, z, y0, x0, c0 in _grid(b, h, w, c, pad, th):
        res_pad = pad if df1 else 0
        y, x, ch = y0 + rows, x0 + cols, c0 + chans
        keep = (y < h + res_pad) & (x < w) & (ch < c)
        np.add.at(cover[df1], (z, y[keep] + res_pad, x[keep], ch[keep]), 1)
    return cover


def _gt_source(e, y0, x0, h, w, d, df1):
    """Mirror of ``gt_source``: slot e's (pixel row, column, tap), or None
    outside the frame."""
    n = 2 * d + 1
    if df1:
        q, m = divmod(e, TW * n)
        v, u = q % n, m % n
        py, px, t = y0 + q // n + d - v, x0 + m // n + d - u, v * n + u
    else:
        m = e % (TW * n * n)
        py, px, t = y0 + e // (TW * n * n), x0 + m // (n * n), m % (n * n)
    return (py, px, t) if 0 <= py < h and 0 <= px < w else None


def _taps(th, d, df1, r, hx):
    """Mirror of the tap loop for thread (r, hx): per accumulator i, the
    sequence of (v, u, window slot, gt slot) it takes."""
    n, ww = 2 * d + 1, TW + 2 * d
    seq = [[] for _ in range(PX)]
    for v in range(n):
        wrow = r + 2 * d - v if df1 else r + v
        gbase = ((r * n + v) * TW + hx * PX) * n if df1 else (r * TW + hx * PX) * n * n + v * n
        for x in range(PX + 2 * d):
            for u in range(n):
                i = x - 2 * d + u if df1 else x - u
                if 0 <= i < PX:
                    seq[i].append((v, u, wrow * ww + hx * PX + x, gbase + i * (n if df1 else n * n) + u))
    return seq


class TestCostVolumeBwdPlan:
    def test_constants_match_the_source(self):
        src = (_build.CSRC / "cost_volume_bwd.cu").read_text()
        consts = dict(re.findall(r"constexpr int (kCvb\w+) = (\d+);", src))
        assert {k: int(v) for k, v in consts.items() if k != "kCvbBatch"} == {
            "kCvbTW": TW, "kCvbCC": CC, "kCvbCPT": CPT, "kCvbPX": PX}
        for th in _common.CV_BWD_TILE_ROWS:
            assert f"case {th}: return run_plan" in src

    def test_training_plans(self):
        """The coarse calls take short tiles; the three finer ones 8 rows."""
        assert [_common.cv_bwd_plan(*s) for s in TRAIN] == [2, 4, 8, 8, 8]
        assert _common.cv_bwd_blocks(8, 6, 7, 192, 0, 8) == 96  # the single tile a frame of old
        assert _common.cv_bwd_blocks(8, 6, 7, 192, 0, 2) == 288 >= 264  # two blocks an SM

    @pytest.mark.parametrize("b,h,w,c", TRAIN)
    @pytest.mark.parametrize("pad", [0, 4])
    def test_two_blocks_an_sm(self, b, h, w, c, pad):
        th = _common.cv_bwd_plan(b, h, w, c, pad)
        n = _common.cv_bwd_blocks(b, h, w, c, pad, th)
        assert n >= _common.CV_BWD_MIN_BLOCKS
        assert n == sum(1 for _ in _grid(b, h, w, c, pad, th))
        if th != _common.CV_BWD_TILE_ROWS[0]:  # a taller tile would not have held the target
            taller = _common.CV_BWD_TILE_ROWS[_common.CV_BWD_TILE_ROWS.index(th) - 1]
            assert _common.cv_bwd_blocks(b, h, w, c, pad, taller) < _common.CV_BWD_MIN_BLOCKS

    @pytest.mark.parametrize("b,h,w,c", TRAIN)
    def test_each_output_once_at_the_training_shapes(self, b, h, w, c):
        cover = _coverage(b, h, w, c, 0, _common.cv_bwd_plan(b, h, w, c))
        assert (cover[False] == 1).all() and (cover[True] == 1).all()

    @pytest.mark.parametrize("b,h,w,c", [(8, 3, 7, 192), (8, 6, 14, 128), (8, 24, 56, 64), (8, 48, 112, 32)])
    @pytest.mark.parametrize("d", [4])
    def test_each_output_once_on_shards(self, b, h, w, c, d):
        """K8b: df1_ext's h + 2d rows (halo rows wider than a 3-row shard)."""
        cover = _coverage(b, h, w, c, d, _common.cv_bwd_plan(b, h, w, c, d))
        assert cover[True].shape[1] == h + 2 * d
        assert (cover[False] == 1).all() and (cover[True] == 1).all()

    @pytest.mark.parametrize("b,h,w,c", EDGE)
    @pytest.mark.parametrize("th", _common.CV_BWD_TILE_ROWS)
    @pytest.mark.parametrize("d", [1, 2, 3, 4])
    def test_each_output_once_at_edge_shapes(self, b, h, w, c, th, d):
        for pad in (0, d):
            cover = _coverage(b, h, w, c, pad, th)
            assert (cover[False] == 1).all() and (cover[True] == 1).all()

    @pytest.mark.parametrize("d", [1, 2, 3, 4])
    @pytest.mark.parametrize("th", _common.CV_BWD_TILE_ROWS)
    @pytest.mark.parametrize("df1", [False, True])
    def test_gt_staged_once_per_pair_the_tile_reads(self, d, th, df1):
        """On a frame that holds the whole window, tile (y0, x0) stages each
        (pixel, tap) pair that one of its outputs reads exactly once: df0 its
        own pixels' taps, df1 the pixels q - off_t at tap t."""
        n, h, w, y0, x0 = 2 * d + 1, 40, 40, 16, 16
        slots = [_gt_source(e, y0, x0, h, w, d, df1) for e in range(th * TW * n * n)]
        want = []
        for yy in range(y0, y0 + th):
            for xx in range(x0, x0 + TW):
                for v in range(n):
                    for u in range(n):
                        p = (yy + d - v, xx + d - u) if df1 else (yy, xx)
                        want.append((*p, v * n + u))
        assert None not in slots and len(set(slots)) == len(slots)
        assert sorted(slots) == sorted(want)

    @pytest.mark.parametrize("d", [1, 4])
    @pytest.mark.parametrize("th", _common.CV_BWD_TILE_ROWS)
    @pytest.mark.parametrize("df1", [False, True])
    def test_tap_order_and_slots(self, d, th, df1):
        """Every accumulator takes all (2d+1)^2 taps once, v ascending and u
        ascending (df0) or descending (df1), from the window position
        pixel + off_t (df0) or pixel - off_t (df1) and from the gt slot
        that staged that pair."""
        n, ww = 2 * d + 1, TW + 2 * d
        y0, x0, h, w = 16, 16, 40, 40
        for r in range(th):
            for hx in range(TW // PX):
                for i, seq in enumerate(_taps(th, d, df1, r, hx)):
                    col = hx * PX + i
                    vu = [(v, u) for v, u, _, _ in seq]
                    assert vu == [(v, u) for v in range(n) for u in (reversed(range(n)) if df1 else range(n))]
                    for v, u, wslot, gslot in seq:
                        sign = -1 if df1 else 1
                        assert divmod(wslot, ww) == (r + d + sign * (v - d), col + d + sign * (u - d))
                        src = (y0 + r - (v - d), x0 + col - (u - d)) if df1 else (y0 + r, x0 + col)
                        assert _gt_source(gslot, y0, x0, h, w, d, df1) == (*src, v * n + u)
