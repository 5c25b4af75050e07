"""A (data, spatial) mesh of processes over ``torch.distributed``
(counterpart of ``pwcnet_tpu/parallel/mesh.py``).

One process per device. Ranks are laid out as the JAX package's
``make_mesh`` lays out devices (``reshape(data, spatial)``): rank r has data
index ``r // spatial`` and spatial index ``r % spatial``. Each spatial row (the
shards of one frame) and each data column has its own process group.

The process group comes from the environment ``torchrun`` sets
(``init_method='env://'``) or from an explicit ``init_method`` such as
``tcp://host:port`` with a rank and a world size (``--coordinator``). Its
backend is NCCL for CUDA devices and gloo for the CPU unless the caller
names one; gloo with CUDA tensors copies them through the host
(``_comm.py``), which is how two ranks share one card in a test.

The device is explicit: ``cuda:LOCAL_RANK`` by default, which must exist.
Two ranks share a GPU only when the caller passes that device itself.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from pwcnet_tpu_torch.parallel._comm import RowGroup, all_reduce_sum

__all__ = ["Mesh", "global_sum", "make_mesh", "mesh_from_args", "replicate", "shard_batch"]


@dataclasses.dataclass
class Mesh:
    """This process's place in a (data, spatial) mesh."""

    data: int
    spatial: int
    rank: int
    device: torch.device
    rows: RowGroup  # the shards of this rank's frames (its spatial row)
    column: RowGroup  # the ranks of this rank's data column, in data order

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def shape(self) -> dict:
        return {"data": self.data, "spatial": self.spatial}


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (--device cpu) to run the mesh on the CPU"
        )
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} has no GPU of its own ({torch.cuda.device_count()} visible); "
            "one process per GPU"
        )
    return torch.device("cuda", local)


def make_mesh(
    data: Optional[int] = None,
    spatial: int = 1,
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    backend: Optional[str] = None,
) -> Mesh:
    """Join (or start) the process group and build this rank's mesh.

    ``data`` defaults to world size // spatial; data * spatial must equal the
    world size. Without ``init_method`` an uninitialised process group is
    set up from torchrun's environment (``env://``)."""
    device = _device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method or "env://",
            rank=rank if rank is not None else -1,
            world_size=world_size if world_size is not None else -1,
        )
    world = dist.get_world_size()
    if data is None:
        data = world // spatial
    if data * spatial != world:
        raise ValueError(f"data({data}) * spatial({spatial}) != world size ({world})")
    me = dist.get_rank()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rows = column = None
    # every rank creates every group, in the same order
    for d in range(data):
        ranks = tuple(range(d * spatial, (d + 1) * spatial))
        group = dist.new_group(list(ranks))
        if me in ranks:
            rows = RowGroup(group, ranks, ranks.index(me))
    for s in range(spatial):
        ranks = tuple(range(s, world, spatial))
        group = dist.new_group(list(ranks))
        if me in ranks:
            column = RowGroup(group, ranks, ranks.index(me))
    return Mesh(data=data, spatial=spatial, rank=me, device=device, rows=rows, column=column)


def mesh_from_args(args, device=None):
    """The (data, spatial) mesh the arguments ask for, or None for one
    process: ``--spatial`` above 1, ``--coordinator host:port`` with
    ``--num_processes`` and ``--process_id`` (as the JAX package maps them
    to ``jax.distributed.initialize``), or a process group that torchrun's
    environment (or the caller) has set up."""
    spatial = int(getattr(args, "spatial", 1) or 1)
    coordinator = getattr(args, "coordinator", None)
    launched = "WORLD_SIZE" in os.environ or dist.is_initialized()
    if spatial == 1 and not coordinator and not launched:
        return None
    kwargs = {}
    if coordinator:
        if getattr(args, "num_processes", None) is None or getattr(args, "process_id", None) is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        kwargs = dict(init_method=f"tcp://{coordinator}", rank=args.process_id, world_size=args.num_processes)
    elif not launched:
        raise ValueError(
            f"--spatial {spatial} shards each frame over {spatial} processes: launch them with torchrun "
            "(torchrun --nproc_per_node N -m ...) or give each --coordinator, --num_processes and --process_id"
        )
    return make_mesh(spatial=spatial, device=device, **kwargs)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (in place)."""
    if dist.get_world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            wire = t.detach().cpu() if (t.is_cuda and dist.get_backend() == dist.Backend.GLOO) else t.data
            dist.broadcast(wire, src=0)
            if wire is not t.data:
                t.copy_(wire)
    return module


def shard_batch(x: torch.Tensor, mesh: Mesh, row_dim: int, split_batch: bool = True) -> torch.Tensor:
    """This rank's part of a global batch: its data index's slice of the
    batch (when ``split_batch`` and the batch divides) and its spatial
    index's stripe of rows along ``row_dim``."""
    if split_batch and mesh.data > 1 and x.shape[0] % mesh.data == 0:
        b = x.shape[0] // mesh.data
        x = x[mesh.data_index * b : (mesh.data_index + 1) * b]
    if mesh.spatial > 1:
        if x.shape[row_dim] % mesh.spatial:
            raise ValueError(f"{x.shape[row_dim]} rows do not divide over {mesh.spatial} shards")
        h = x.shape[row_dim] // mesh.spatial
        x = x.narrow(row_dim, mesh.spatial_index * h, h)
    return x


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank of the world (not differentiated)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    return all_reduce_sum(t)
