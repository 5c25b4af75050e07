"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- ``cost_volume.cost_volume_cuda``: K2, the 81-tap correlation;
- ``warped_cv.warped_cost_volume``: K1, bilinear warp + correlation;
- ``pyramid_conv.pyramid_level_fused``: K3, one 3-conv pyramid level.

Each wrapper sends a CPU tensor to its plain PyTorch version and a CUDA
tensor to its kernel (or raises): nothing falls back. Each keeps a count
of the kernel launches it made in ``<wrapper>.launches``.
"""

from __future__ import annotations

__all__ = ["launch_counts", "reset_launch_counts", "wrappers"]


def wrappers() -> dict:
    """Kernel id -> wrapper function."""
    from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_fused
    from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

    return {
        "K1": warped_cost_volume,
        "K2": cost_volume_cuda,
        "K3": pyramid_level_fused,
    }


def launch_counts() -> dict:
    """Kernel id -> launches since the last reset."""
    return {k: fn.launches for k, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
