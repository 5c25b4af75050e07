"""The bf16 backward of the estimator chain (K7b) as its wgmma kernel
computes it, on the CPU.

K7b's bf16 stages run on the forward's wgmma + TMA kernel
(``csrc/conv3x3_wgmma.cuh``, ``conv3x3_wgmma_kernel<N, true>``), which needs
an NVIDIA card (tests/test_torch_kernels.py, ``cuda`` marker). What decides
its arithmetic and its coverage is held here with a PyTorch model of the
kernel:

- one block's GEMM as the kernel runs it: an 8 x 30 tile of positions
  staged with its 1-pixel halo at a row pitch of 32 (zero outside the frame,
  the TMA pad), the A operand of tap (dy, dx) the staged plane shifted by
  ``dy * 32 + dx``, the plane's overreach past the 10 staged rows holding
  garbage (NaN here) that only the two dropped columns read, 16 channels a
  K step, each N tile of ``_common.wgmma_tiles`` from its own packed
  weights (``_common.transposed_tiles``: the forward's kernel transposed,
  taps mirrored);
- the chain through it: g_flow padded to 8 channels (the TMA stride), gz5
  = (conv6^T + g_feat) * mask(s5), gz_i = conv_{i+1}^T * mask(s_i), dxin
  from N tiles of 96 or 128, equals ``estimator_chain_bwd_plain`` and, at
  the odd widths, the JAX kernel's gradient (interpret mode);
- the N tiles cover every output channel exactly once; the scratch buffer
  holds every stage's packed weights on 16 bytes; the source's constants
  are the model's.

Tolerances. float32: rtol=1e-5, atol=1e-5 at O(1) values against the plain
version (the same float32 products summed in another order; the masks read
the saved activations, so no slope can flip); 1e-4 against the JAX
gradients, as tests/test_torch_estimator_fused.py holds the plain chain to
them. bfloat16 (each result rounded once, after the add and the mask): 2
ulps of the result's scale, the card's bound for K7b.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pwcnet_tpu.ops.pallas.estimator_conv import estimator_chain_fused as jax_chain_fused
from pwcnet_tpu_torch.ops.activation import leaky_mask
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda.estimator_conv import bwd_scratch_numel
from pwcnet_tpu_torch.ops.estimator_conv import (
    NCONV,
    chain_weight_grads,
    estimator_chain_bwd_plain,
    estimator_chain_plain,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "pwcnet_tpu_torch" / "csrc"
# the kernel's block (conv3x3_wgmma.cuh): 8 x 30 outputs, staged at a pitch
# of 32 positions over 10 rows, a plane of 328 positions
TH, TW, PITCH, ROWS, PLANE = 8, 30, 32, 10, 328
REAL = (128, 128, 96, 64, 32, 2)
ODD = (24, 16, 8, 8, 40, 3)
# (Cin, outputs): the real widths at the chain's inputs, as they arrive and
# padded to 8 by the model's NHWC copy, and the odd chain of the card tests
CHAINS = [(147, REAL), (179, REAL), (273, REAL), (152, REAL), (184, REAL), (37, ODD)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _wgmma_conv(x, tiles, cout):
    """x (B, H, W, Cin) through the blocks of conv3x3_wgmma_kernel with the
    packed N tiles ``tiles`` (tiles, K/16, 9, 2, n, 8): the float32 sums of
    the first ``cout`` channels (the epilogue is the caller's)."""
    b, h, w, cin = x.shape
    ntiles, ksteps, _, _, n, _ = tiles.shape
    kp = 16 * ksteps
    xp = F.pad(x, (0, kp - cin))  # the second box of a K step past Cin reads zeros
    out = torch.full((b, h, w, ntiles * n), float("nan"))
    for ty0 in range(0, h, TH):
        for tx0 in range(0, w, TW):
            plane = torch.zeros((b, ROWS, PITCH, kp))  # zero outside the frame: the SAME pad
            y0, y1, x0, x1 = max(ty0 - 1, 0), min(ty0 + TH + 1, h), max(tx0 - 1, 0), min(tx0 + PITCH - 1, w)
            plane[:, y0 - ty0 + 1 : y1 - ty0 + 1, x0 - tx0 + 1 : x1 - tx0 + 1] = xp[:, y0:y1, x0:x1]
            flat = torch.cat([plane.reshape(b, ROWS * PITCH, kp), torch.full((b, PLANE - ROWS * PITCH, kp), float("nan"))], 1)
            for j in range(ntiles):
                acc = torch.zeros((b, TH * PITCH, n))
                for ks in range(ksteps):
                    for tap in range(9):
                        shift = (tap // 3) * PITCH + tap % 3
                        a = flat[:, shift : shift + TH * PITCH, 16 * ks : 16 * ks + 16]
                        acc += a @ tiles[j, ks, tap].permute(0, 2, 1).reshape(16, n)
                acc = acc.reshape(b, TH, PITCH, n)[:, :, :TW]  # the two columns past the 30 are dropped
                ry, rx = min(TH, h - ty0), min(TW, w - tx0)
                out[:, ty0 : ty0 + ry, tx0 : tx0 + rx, j * n : (j + 1) * n] = acc[:, :ry, :rx]
    return out[..., :cout]


def _chain_bwd_model(ks, acts, g_flow, g_feat, need_dx=True):
    """``([gz1, .., gz5], dxin)`` as K7b's bf16 launches compute them, each
    stage reading the rounded result of the one before, in ``g_flow``'s
    dtype (sums float32)."""
    dt = g_flow.dtype
    chans = [ks[0].shape[1]] + [k.shape[0] for k in ks]
    src = F.pad(g_flow, (0, -chans[-1] % 8))  # the flow cotangent with a 16-byte pixel stride
    gzs = []
    for i in range(NCONV - 1, -1 if need_dx else 0, -1):
        v = _wgmma_conv(src.float(), _common.transposed_tiles(ks[i].float()), chans[i])
        if i == NCONV - 1:
            v = v + g_feat.float()
        if i > 0:
            v = v * leaky_mask(acts[i - 1])
        src = v.to(dt)  # the one rounding, after the add and the mask
        gzs.append(src)
    dxin = gzs.pop() if need_dx else None
    return gzs[::-1], dxin


def _chain(rng, cin, couts, shape=(2, 9, 33)):
    ks, ci = [], cin
    for c in couts:
        ks.append(_t(rng, (c, ci, 3, 3), 1.0 / np.sqrt(9.0 * ci)))
        ci = c
    acts = [_t(rng, shape + (c,)) for c in couts[:-1]]
    return ks, acts, _t(rng, shape + (couts[-1],)), _t(rng, shape + (couts[-2],))


class TestModelOfTheKernel:
    @pytest.mark.parametrize("cin,couts", CHAINS, ids=lambda v: str(v if isinstance(v, int) else v[0]))
    def test_chain_equals_the_plain_backward(self, rng, cin, couts):
        """Every gz_i and dxin (dxin in two or three N tiles at the real widths)."""
        ks, acts, g_flow, g_feat = _chain(rng, cin, couts)
        got_gz, got_dx = _chain_bwd_model(ks, acts, g_flow, g_feat)
        want_gz, want_dx = estimator_chain_bwd_plain(ks, acts, g_flow, g_feat)
        for a, b in zip(got_gz + [got_dx], want_gz + [want_dx]):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    def test_without_dxin(self, rng):
        ks, acts, g_flow, g_feat = _chain(rng, 37, ODD, (1, 5, 7))
        gz, dx = _chain_bwd_model(ks, acts, g_flow, g_feat, need_dx=False)
        want, _ = estimator_chain_bwd_plain(ks, acts, g_flow, g_feat)
        assert dx is None and len(gz) == NCONV - 1
        for a, b in zip(gz, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape", [(1, 8, 30), (1, 16, 60), (1, 1, 1), (1, 9, 31), (2, 17, 29)])
    def test_frames_on_and_off_the_tile(self, rng, shape):
        """Frames a whole number of 8 x 30 tiles, one pixel, and one past a tile."""
        x = _t(rng, shape + (40,))
        k = _t(rng, (40, 24, 3, 3), 1.0 / np.sqrt(360.0))
        got = _wgmma_conv(x, _common.transposed_tiles(k), 24)
        want = torch.nn.grad.conv2d_input((shape[0], 24) + shape[1:], k, x.permute(0, 3, 1, 2), padding=1)
        torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)

    def test_bfloat16_rounds_once_after_the_add_and_the_mask(self, rng):
        ks, acts, g_flow, g_feat = _chain(rng, 147, REAL, (1, 6, 7))
        bf = [[t.to(torch.bfloat16) for t in ts] for ts in (ks, acts)]
        g = [t.to(torch.bfloat16) for t in (g_flow, g_feat)]
        got_gz, got_dx = _chain_bwd_model(*bf, *g)
        want_gz, want_dx = estimator_chain_bwd_plain(*bf, *g)
        for a, b in zip(got_gz + [got_dx], want_gz + [want_dx]):
            assert a.dtype == torch.bfloat16
            ulp = 2.0 ** (torch.floor(torch.log2(b.float().abs().max())) - 7)
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2 * ulp.item())


class TestAgainstJax:
    def test_model_gradients_equal_the_jax_kernel(self, rng):
        """dxin and the twelve weight and bias gradients from the model's
        cotangents, against jax.grad of the interpret-mode kernel, the odd
        widths (a 3-channel flow, a 37-channel input)."""
        shape, cin = (1, 9, 13), 37
        x = rng.standard_normal(shape + (cin,)).astype(np.float32)
        kbs, ci = [], cin
        for c in ODD:
            kbs += [(rng.standard_normal((3, 3, ci, c)) / np.sqrt(9.0 * ci)).astype(np.float32),
                    (rng.standard_normal((c,)) * 0.1).astype(np.float32)]
            ci = c
        gf = rng.standard_normal(shape + (ODD[-1],)).astype(np.float32)
        gt = rng.standard_normal(shape + (ODD[-2],)).astype(np.float32)

        def loss(x, *p):
            flow, feat = jax_chain_fused(x, *p, interpret=True)
            return jnp.sum(flow * gf) + jnp.sum(feat * gt)

        want = jax.grad(loss, argnums=tuple(range(1 + len(kbs))))(jnp.asarray(x), *[jnp.asarray(p) for p in kbs])
        tk = [torch.from_numpy(np.ascontiguousarray(p.transpose(3, 2, 0, 1) if p.ndim == 4 else p)) for p in kbs]
        tx = torch.from_numpy(x)
        _, feat, acts = estimator_chain_plain(tx, *tk, return_acts=True)
        saved = [*acts, feat]
        gzs, dxin = _chain_bwd_model(tk[0::2], saved, torch.from_numpy(gf), torch.from_numpy(gt))
        got = [dxin] + chain_weight_grads(tx, saved, gzs, torch.from_numpy(gf), [k.shape for k in tk[0::2]])
        for i, (a, b) in enumerate(zip(got, want)):
            a = a.numpy()
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 and a.shape[-2:] == (3, 3) else a
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=f"gradient {i}")


class TestNTiles:
    @pytest.mark.parametrize("lo", [1, 100, 200, 300])
    def test_each_channel_once(self, lo):
        for cout in range(lo, lo + 100):
            tiles, n = _common.wgmma_tiles(cout)
            assert n in _common.WGMMA_WIDTHS and tiles == -(-cout // 128)
            cover = np.zeros(cout, int)
            for j in range(tiles):
                live = range(j * n, min((j + 1) * n, cout))
                assert len(live) > 0, f"tile {j} of {cout} has no channel"
                cover[list(live)] += 1
            assert (cover == 1).all(), cout

    def test_the_model_widths(self):
        plan = {c: _common.wgmma_tiles(c) for c in (2, 32, 64, 96, 128, 147, 152, 179, 184, 211, 243, 273, 280)}
        assert plan == {2: (1, 8), 32: (1, 32), 64: (1, 64), 96: (1, 96), 128: (1, 128), 147: (2, 96),
                        152: (2, 96), 179: (2, 96), 184: (2, 96), 211: (2, 128), 243: (2, 128), 273: (3, 96),
                        280: (3, 96)}

    @pytest.mark.parametrize("cout,cin", [(128, 152), (128, 273), (32, 2), (40, 3), (24, 37), (64, 32)])
    def test_transposed_tiles_layout(self, rng, cout, cin):
        """Tile j is the transpose of the forward kernel's input channels
        [j n, (j + 1) n), taps mirrored, zero past them; a single tile is
        K6's ``pack_wgmma_transposed``."""
        k = _t(rng, (cout, cin, 3, 3))
        tiles = _common.transposed_tiles(k)
        ntiles, n = _common.wgmma_tiles(cin)
        assert tiles.shape == (ntiles, -(-cout // 16), 9, 2, n, 8)
        assert tiles.numel() == _common.packed_numel(cout, cin)
        full = tiles.permute(0, 2, 1, 3, 5, 4).reshape(ntiles, 9, -(-cout // 16) * 16, n)
        kt = F.pad(k.reshape(cout, cin, 9).flip(2).permute(2, 0, 1), (0, ntiles * n - cin, 0, -cout % 16))
        for j in range(ntiles):
            torch.testing.assert_close(full[j], kt[..., j * n : (j + 1) * n], rtol=0, atol=0)
        if ntiles == 1:
            torch.testing.assert_close(tiles[0], _common.pack_wgmma_transposed(k), rtol=0, atol=0)

    @pytest.mark.parametrize("cin,couts,need_dx", [(152, REAL, True), (280, REAL, True), (147, REAL, False),
                                                   (37, ODD, True), (40, ODD, False)])
    def test_scratch_holds_every_stage(self, cin, couts, need_dx):
        """The wrapper's scratch: each stage's tiles, each starting on 16
        bytes."""
        chans = [cin, *couts]
        sizes = [_common.transposed_tiles(torch.zeros((chans[i + 1], chans[i], 3, 3))).numel()
                 for i in range(0 if need_dx else 1, NCONV)]
        assert all(n * 2 % 16 == 0 for n in sizes)
        assert bwd_scratch_numel(chans, need_dx) == sum(sizes)


class TestSourceConstants:
    def test_widths_and_tiles(self):
        src = (CSRC / "hopper.cuh").read_text()
        widths = re.search(r"kWidths\[\] = \{([\d, ]+)\}", src).group(1)
        assert tuple(int(v) for v in widths.split(",")) == _common.WGMMA_WIDTHS
        assert "(cout + 127) / 128" in src

    def test_block(self):
        src = (CSRC / "conv3x3_wgmma.cuh").read_text()
        consts = {k: int(v) for k, v in re.findall(r"constexpr int (kEw\w+) = (\d+);", src)}
        assert (consts["kEwTH"], consts["kEwTW"], consts["kEwPlane"]) == (TH, TW, PLANE)
        assert "kEwPitch = kEwTW + 2" in src and "kEwRows = kEwTH + 2" in src
        assert PLANE >= TH * PITCH - 1 + 2 * PITCH + 2 + 1  # the last tap of the last row
