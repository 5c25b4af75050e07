"""The device the port runs on when the caller names none."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pwcnet_tpu_torch runs on the GPU by default; pass "
                "device='cpu' (--device cpu) to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
