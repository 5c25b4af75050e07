"""Host-side data loading for pwcnet_tpu_torch (numpy; torch only in ``device_prefetch``)."""

from pwcnet_tpu_torch.data.datasets import (
    FlowDataset,
    FlyingChairs,
    SintelClean,
    SintelFinal,
    SyntheticFlow,
    get_dataset,
)
from pwcnet_tpu_torch.data.pipeline import DataLoader, device_prefetch

__all__ = [
    "FlowDataset",
    "FlyingChairs",
    "SintelClean",
    "SintelFinal",
    "SyntheticFlow",
    "get_dataset",
    "DataLoader",
    "device_prefetch",
]
