"""Multi-GPU runs: the (data, spatial) mesh over ``torch.distributed`` and
the H-sharded model (counterpart of ``pwcnet_tpu/parallel``)."""

from pwcnet_tpu_torch.parallel.mesh import Mesh, global_sum, make_mesh, mesh_from_args, replicate, shard_batch
from pwcnet_tpu_torch.parallel.spatial import (
    MIN_ROWS_PER_SHARD,
    SpatialGuard,
    make_spatial_cost_volume,
    make_spatial_guard,
    make_spatial_pyramid_level,
    make_spatial_warped_cv,
)

__all__ = [
    "MIN_ROWS_PER_SHARD",
    "Mesh",
    "SpatialGuard",
    "global_sum",
    "make_mesh",
    "mesh_from_args",
    "make_spatial_cost_volume",
    "make_spatial_guard",
    "make_spatial_pyramid_level",
    "make_spatial_warped_cv",
    "replicate",
    "shard_batch",
]
