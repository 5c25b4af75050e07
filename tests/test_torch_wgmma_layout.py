"""The host-side layouts of the bf16 wgmma kernels (K3, K7), on the CPU.

The kernels themselves need an NVIDIA card (tests/test_torch_kernels.py,
``cuda`` marker); what surrounds them is Python and is held here:

- ``_common.pack_wgmma``: a conv computed the way the kernels compute it,
  one 16-deep K step of every tap at a time from the packed weights (the
  input's channels zero-padded to the K steps), equals ``F.conv2d``, at the
  widths of both kernels, stride 1 and K3's stride 2;
- K3's weights in the layout its kernel packs them in on the card (level
  0's conv1 tap-major, the rest for wgmma; the card tests hold the on-card
  packer to ``pack_wgmma``), and K7's channel-padded chain input with its
  zero weight rows, against the JAX package's XLA references on one small
  case;
- ``models.conv.to_nhwc(x, 8)``: the zero channel tail written in the NHWC
  copy, and the wrappers' handling of such an input (same result, zero
  gradient for the tail, k1's gradient of k1's shape).

Tolerances: float32 with the sums taken in another order, rtol=1e-5 and
atol=1e-5 at O(1) activations (1e-4 for the six-conv chain against XLA,
as tests/test_torch_estimator_fused.py holds it).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.models.conv import to_nhwc
from pwcnet_tpu_torch.ops.activation import leaky_relu
from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_fused, estimator_chain_residuals
from pwcnet_tpu_torch.ops.cuda.pyramid_conv import same_pad_stride2
from pwcnet_tpu_torch.ops.estimator_conv import estimator_chain_plain

torch.set_num_threads(1)


def _packed_conv(x, wpk, cout, stride=1):
    """NHWC float32 3x3 SAME conv from wgmma-packed weights
    ``[K/16][tap][2][N][8]``, summed K step by K step and tap by tap as the
    kernels' implicit GEMMs do."""
    b, h, w, cin = x.shape
    ksteps, _, _, n, _ = wpk.shape
    xp = F.pad(x, (0, 16 * ksteps - cin))
    if stride == 1:
        xp, ho, wo = F.pad(xp, (0, 0, 1, 1, 1, 1)), h, w
    else:
        left, right, top, bottom = same_pad_stride2(h, w)
        xp, ho, wo = F.pad(xp, (0, 0, left, right, top, bottom)), -(-h // 2), -(-w // 2)
    out = torch.zeros((b, ho, wo, n))
    for ks in range(ksteps):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            a = xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride,
                   16 * ks : 16 * ks + 16]
            out += a @ wpk[ks, tap].permute(0, 2, 1).reshape(16, n)
    return out[..., :cout]


def _pack_level(k1, k2, k3):
    """K3's bf16 weights as its kernel packs them on the card: level 0's
    conv1 (3 input channels, run as FMAs) tap-major [ky][kx][ci][co], every
    other conv for wgmma."""
    w1 = k1.permute(2, 3, 1, 0).contiguous() if k1.shape[1] == 3 else _common.pack_wgmma(k1)
    return w1, _common.pack_wgmma(k2), _common.pack_wgmma(k3)


def _conv(x, k, stride=1):
    """F.conv2d on NHWC with TF SAME padding."""
    y = x.permute(0, 3, 1, 2)
    if stride == 1:
        return F.conv2d(y, k, padding=1).permute(0, 2, 3, 1)
    y = F.pad(y, same_pad_stride2(y.shape[2], y.shape[3]))
    return F.conv2d(y, k, stride=2).permute(0, 2, 3, 1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


class TestPackWgmma:
    @pytest.mark.parametrize(
        "cin,cout,stride",
        [(16, 32, 1), (32, 32, 1), (16, 16, 1), (147, 128, 1), (273, 128, 1), (128, 96, 1),
         (96, 64, 1), (64, 32, 1), (32, 2, 1), (37, 24, 1), (8, 3, 1), (16, 32, 2)],
    )
    def test_packed_gemm_equals_conv2d(self, rng, cin, cout, stride):
        x = _t(rng, (2, 7, 9, cin))
        k = _t(rng, (cout, cin, 3, 3), 1.0 / np.sqrt(9.0 * cin))
        wpk = _common.pack_wgmma(k)
        n = _common.wgmma_n(cout)
        assert wpk.shape == (-(-cin // 16), 9, 2, n, 8) and wpk.is_contiguous()
        # the padding is zero: rows past Cin, columns past Cout
        full = wpk.permute(1, 0, 2, 4, 3).reshape(9, -1, n)
        assert not full[:, cin:].any() and not full[:, :, cout:].any()
        torch.testing.assert_close(_packed_conv(x, wpk, cout, stride), _conv(x, k, stride), rtol=1e-5, atol=1e-5)

    def test_wgmma_widths(self):
        assert [_common.wgmma_n(c) for c in (2, 8, 9, 24, 32, 40, 96, 97, 128)] == [8, 8, 16, 32, 32, 64, 96, 128, 128]
        with pytest.raises(ValueError, match="at most 128"):
            _common.wgmma_n(129)

    @pytest.mark.parametrize("cin,c", [(3, 16), (16, 32)])
    def test_pyramid_level_packing(self, rng, cin, c):
        """K3's bf16 weights: level 0's conv1 tap-major [ky][kx][ci][co] (it
        runs as FMAs), every other conv packed for wgmma; the scratch the
        wrapper hands the kernel holds the three."""
        x = _t(rng, (1, 10, 14, cin))
        ks = [_t(rng, (c, ci, 3, 3), 1.0 / np.sqrt(9.0 * ci)) for ci in (cin, c, c)]
        w1, w2, w3 = _pack_level(*ks)
        if cin == 3:
            assert w1.shape == (3, 3, 3, c) and w1.is_contiguous()
            torch.testing.assert_close(w1, ks[0].permute(2, 3, 1, 0))
        else:
            torch.testing.assert_close(_packed_conv(x, w1, c, 2), _conv(x, ks[0], 2), rtol=1e-5, atol=1e-5)
        n1 = 9 * cin * c if cin == 3 else _common.packed_numel(cin, c)
        assert w1.numel() == n1 and w2.numel() == w3.numel() == _common.packed_numel(c, c)
        s = _t(rng, (1, 5, 7, c))
        for w, k in ((w2, ks[1]), (w3, ks[2])):
            torch.testing.assert_close(_packed_conv(s, w, c), _conv(s, k), rtol=1e-5, atol=1e-5)


class TestAgainstJax:
    def test_pyramid_level_from_packed_weights(self, rng):
        """Level 1 of K3 computed from its packed weights (stride-2 conv1
        included) equals the JAX package's XLA level."""
        import jax.numpy as jnp

        from pwcnet_tpu.ops.pallas.pyramid_conv import _xla_level

        x = _t(rng, (1, 12, 18, 16))
        ks = [_t(rng, (32, ci, 3, 3), 1.0 / np.sqrt(9.0 * ci)) for ci in (16, 32, 32)]
        bs = [_t(rng, (32,), 0.1) for _ in range(3)]
        w1, w2, w3 = _pack_level(*ks)
        s1 = leaky_relu(_packed_conv(x, w1, 32, 2) + bs[0], 0.1)
        s2 = leaky_relu(_packed_conv(s1, w2, 32) + bs[1], 0.1)
        got = leaky_relu(_packed_conv(s2, w3, 32) + bs[2], 0.1)
        params = []
        for k, b in zip(ks, bs):
            params += [jnp.asarray(k.permute(2, 3, 1, 0).numpy()), jnp.asarray(b.numpy())]
        want = np.asarray(_xla_level(jnp.asarray(x.numpy()), *params))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_chain_from_padded_input_and_packed_weights(self, rng):
        """K7's chain as the bf16 kernels see it, the 37-channel input padded
        to 40 in the NHWC copy and k1 with zero rows, equals the JAX
        package's XLA chain on the unpadded input."""
        import jax.numpy as jnp

        from pwcnet_tpu.ops.pallas.estimator_conv import _xla_chain

        couts = (24, 16, 8, 8, 40, 2)
        feats = _t(rng, (1, 37, 6, 9))  # NCHW, as the estimator concatenates it
        xin = to_nhwc(feats, 8)
        assert xin.shape == (1, 6, 9, 40) and not xin[..., 37:].any()
        kbs, cin = [], 37
        for c in couts:
            kbs += [_t(rng, (c, cin, 3, 3), 1.0 / np.sqrt(9.0 * cin)), _t(rng, (c,), 0.1)]
            cin = c
        y, acts = xin, []
        for i, c in enumerate(couts):
            k = kbs[2 * i]
            if i == 0:
                k = F.pad(k, (0, 0, 0, 0, 0, 3))  # the zero weight rows of the padded tail
            y = _packed_conv(y, _common.pack_wgmma(k), c) + kbs[2 * i + 1]
            y = leaky_relu(y, 0.1) if i < 5 else y
            acts.append(y)
        jkbs = [jnp.asarray(p.permute(2, 3, 1, 0).numpy() if p.dim() == 4 else p.numpy()) for p in kbs]
        want_flow, want_feat = _xla_chain(jnp.asarray(to_nhwc(feats).numpy()), *jkbs)
        np.testing.assert_allclose(acts[-1].numpy(), np.asarray(want_flow), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(acts[-2].numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-4)


class TestChannelPadding:
    def test_to_nhwc_pads_in_the_copy(self, rng):
        x = _t(rng, (2, 147, 3, 5)).requires_grad_()
        y = to_nhwc(x, 8)
        assert y.shape == (2, 3, 5, 152) and y.is_contiguous()
        assert torch.equal(y[..., :147], x.permute(0, 2, 3, 1)) and not y[..., 147:].any()
        g = _t(rng, tuple(y.shape))
        (gx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(gx, g[..., :147].permute(0, 3, 1, 2))
        assert torch.equal(to_nhwc(x.detach(), 1), x.detach().permute(0, 2, 3, 1))
        assert to_nhwc(_t(rng, (1, 16, 2, 2)), 8).shape == (1, 2, 2, 16)

    def test_wrapper_takes_the_padded_input(self, rng):
        """A padded input gives the unpadded chain's result; the tail gets a
        zero gradient and k1 a gradient of k1's shape."""
        couts, cin = (24, 16, 8, 8, 40, 2), 37
        x = _t(rng, (1, 5, 6, cin))
        kbs = []
        for c in couts:
            kbs += [_t(rng, (c, cin, 3, 3), 1.0 / np.sqrt(9.0 * cin)).requires_grad_(), _t(rng, (c,), 0.1)]
            cin = c
        xp = F.pad(x, (0, 3)).requires_grad_()
        flow, feat = estimator_chain_fused(xp, *kbs)
        want_flow, want_feat = estimator_chain_plain(x, *kbs)
        torch.testing.assert_close(flow, want_flow, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(feat, want_feat, rtol=1e-5, atol=1e-5)
        res = estimator_chain_residuals(xp, *kbs)
        torch.testing.assert_close(res[0], want_flow, rtol=1e-5, atol=1e-5)
        gx, gk1 = torch.autograd.grad(flow.sum() + feat.sum(), [xp, kbs[0]])
        assert not gx[..., 37:].any() and gk1.shape == kbs[0].shape
        x2 = x.clone().requires_grad_()
        gx2, gk2 = torch.autograd.grad(sum(t.sum() for t in estimator_chain_plain(x2, *kbs)), [x2, kbs[0]])
        torch.testing.assert_close(gx[..., :37], gx2, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gk1, gk2, rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="k1 takes 37"):
            estimator_chain_fused(F.pad(x, (0, 11)), *kbs)
