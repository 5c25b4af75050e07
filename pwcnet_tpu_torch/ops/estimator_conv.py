"""The estimator's six-conv chain in plain PyTorch: the plain version of K7.

``xin`` (B, H, W, Cin) NHWC -> five 3x3 SAME convs with bias and
LeakyReLU(0.1) -> a linear 3x3 SAME conv; returns ``(flow_raw, features)``,
the last conv's output and the fifth activation, as
``pwcnet_tpu/ops/pallas/estimator_conv.py::estimator_chain_fused`` (the
caller adds the upsampled flow). Rounding as the JAX kernel: products
accumulate in float32, every activation is rounded to the model dtype
between the convs.

``kbs`` is ``k1, b1, ..., k6, b6`` with OIHW kernels (the port's parameter
layout). The backward of ``estimator_chain_plain`` is ordinary autograd
through ``ops/activation.py`` (gradient 1 at exactly zero);
``estimator_chain_bwd_plain`` is the same cotangent chain written out as
``conv2d_input`` calls, the plain version K7's backward kernel is held
against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.activation import leaky_mask, leaky_relu

__all__ = ["NCONV", "estimator_chain_plain", "estimator_chain_bwd_plain", "chain_weight_grads"]

NCONV = 6  # 5 hidden convs + the linear flow conv


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def estimator_chain_plain(xin: torch.Tensor, *kbs: torch.Tensor, return_acts: bool = False):
    """``(flow_raw (B, H, W, 2), features (B, H, W, C5))``; with
    ``return_acts`` also the list ``[s1, .., s4]`` (NHWC, model dtype)."""
    if len(kbs) != 2 * NCONV:
        raise ValueError(f"estimator_chain: want {2 * NCONV} kernels and biases, got {len(kbs)}")
    dt = xin.dtype
    y = _nchw(xin)
    acts = []
    for i in range(NCONV):
        k, b = kbs[2 * i], kbs[2 * i + 1]
        y = F.conv2d(y.float(), k.float(), b.float(), padding=1)
        if i < NCONV - 1:
            y = leaky_relu(y, 0.1)
        y = y.to(dt)
        acts.append(y)
    flow, feat = _nhwc(acts[-1]), _nhwc(acts[-2])
    if return_acts:
        return flow, feat, [_nhwc(a) for a in acts[: NCONV - 2]]
    return flow, feat


def estimator_chain_bwd_plain(ks, acts, g_flow, g_feat, need_dx: bool = True):
    """``([gz1, .., gz5], dxin)`` for the cotangents of ``flow_raw`` and
    ``features``: the plain version of K7's backward.

    ``ks``: the six OIHW kernels; ``acts``: ``[s1, .., s5]`` NHWC (s5 is the
    features). ``gz5 = (conv6^T(g_flow) + g_feat) * mask(s5)``, ``gz_i =
    conv_{i+1}^T(gz_{i+1}) * mask(s_i)``, ``dxin = conv1^T(gz1)``; ``mask`` is
    1 where the saved activation is ``>= 0``, else 0.1. float32 sums; each
    result is rounded to the model dtype and the next stage reads the rounded
    value. ``dxin`` is None when ``need_dx`` is false."""
    dt = g_flow.dtype
    b, h, w, _ = g_flow.shape

    def conv_t(gz, k):
        return torch.nn.grad.conv2d_input((b, k.shape[1], h, w), k.float(), gz.float(), padding=1)

    gz = _nchw(g_flow)
    gzs = []
    for i in range(NCONV - 1, 0, -1):
        ds = conv_t(gz, ks[i])
        if i == NCONV - 1:
            ds = ds + _nchw(g_feat).float()
        gz = (ds * leaky_mask(_nchw(acts[i - 1]))).to(dt)
        gzs.append(gz)
    dxin = _nhwc(conv_t(gz, ks[0]).to(dt)) if need_dx else None
    return [_nhwc(g) for g in reversed(gzs)], dxin


def chain_weight_grads(xin, acts, gzs, g_flow, shapes):
    """``[dk1, db1, .., dk6, db6]`` from the chain's inputs ``xin, s1..s5``
    and the pre-activation cotangents ``gz1..gz5, g_flow`` (all NHWC): plain
    conv weight gradients in the model dtype and float32 sums for the biases,
    as the JAX package takes them outside its kernel."""
    inputs = [xin, *acts]
    cots = [*gzs, g_flow]
    grads = []
    for inp, gz, shape in zip(inputs, cots, shapes):
        grads.append(torch.nn.grad.conv2d_weight(_nchw(inp), shape, _nchw(gz), padding=1))
        grads.append(gz.sum((0, 1, 2), dtype=torch.float32).to(gz.dtype))
    return grads
