"""R1: RAFT's correlation lookup as one CUDA kernel (``csrc/corr_lookup.cu``).

Replaces no TPU kernel: the JAX package has no RAFT. The plain version is
``pwcnet_tpu_torch.ops.corr_lookup.lookup_plain``; ``ops.corr_lookup.lookup``
sends a CPU tensor there and a CUDA tensor here. The kernel computes the
forward only: under grad mode with a pyramid level or the coordinates that
require grad it raises (RAFT serves under ``torch.inference_mode``).
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.cuda import _common
from pwcnet_tpu_torch.ops.cuda._common import I, P

__all__ = ["corr_lookup_cuda"]

LEVELS = 4  # RAFT's pyramid levels and window radius, which the kernel is built for
RADIUS = 4
_ARGTYPES = [P] * LEVELS + [I] * (2 * LEVELS) + [P, P, I, P]


def corr_lookup_cuda(pyramid: list, coords: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """``pyramid`` from ``corr_pyramid`` (four float32 levels (N, 1, h_k,
    w_k), contiguous, on one CUDA device), ``coords`` (B, h, w, 2) float32
    with ``B h w = N`` -> (B, 324, h, w) float32 in ``channels_last``
    memory, as ``lookup_plain``. One launch a call; raises on what the
    kernel does not take."""
    name = "corr_lookup_cuda"
    if len(pyramid) != LEVELS or int(radius) != RADIUS:
        raise ValueError(f"{name}: the kernel takes {LEVELS} levels of radius {RADIUS}, got "
                         f"{len(pyramid)} levels of radius {radius}")
    if coords.dim() != 4 or coords.shape[3] != 2:
        raise ValueError(f"{name}: coords must be (B, h, w, 2), got {tuple(coords.shape)}")
    b, h, w, _ = coords.shape
    n = b * h * w
    for k, m in enumerate(pyramid):
        if m.dim() != 4 or m.shape[:2] != (n, 1) or min(m.shape[2:]) < 2:
            raise ValueError(f"{name}: level {k} must be ({n}, 1, h_k, w_k) with sides of at least 2, "
                             f"got {tuple(m.shape)}")
    tensors = (*pyramid, coords)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the pyramid and coords must be float32")
    if _common.wants_grad(*tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it without grad (torch.no_grad or "
                           "torch.inference_mode) or on tensors that do not require grad")
    coords = coords.contiguous()
    _common.check_tensors(name, *pyramid, coords)
    out = torch.empty((b, h, w, LEVELS * (2 * RADIUS + 1) ** 2), dtype=torch.float32, device=coords.device)
    if n:
        _common.launch(
            "corr_lookup", "pwc_corr_lookup", _ARGTYPES, coords.device,
            *[m.data_ptr() for m in pyramid], *[s for m in pyramid for s in m.shape[2:]],
            coords.data_ptr(), out.data_ptr(), n,
        )
        corr_lookup_cuda.launches += 1
    return out.permute(0, 3, 1, 2)


corr_lookup_cuda.launches = 0
