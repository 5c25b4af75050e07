"""Utilities (numpy only). ``flo_io`` is a copy of the JAX package's."""

from pwcnet_tpu_torch.utils.flo_io import FLO_MAGIC, load_flow, save_flow

__all__ = ["FLO_MAGIC", "load_flow", "save_flow"]
