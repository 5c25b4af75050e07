"""Collectives that autograd differentiates, for row-sharded activations.

The JAX package gets these from ``jax.lax.ppermute`` and ``all_gather``,
whose transposes JAX derives itself; here each is a
``torch.autograd.Function`` with its transpose written out:

- ``halo_exchange``: the rows above and below a shard from its neighbours,
  zeros at the global edges (as ``ppermute`` gives them); backward sends the
  halo rows' cotangents back and adds them onto the rows they came from. A
  halo wider than a neighbour's stripe is cut from the all-gathered frame
  instead (``spatial.py:168-180`` of the JAX package);
- ``all_gather_rows``: the whole frame on every shard; backward is a
  reduce-scatter (sum), the transpose of ``all_gather``;
- ``split_rows``: from a replicated tensor to this shard's rows; backward
  zero-fills the other rows.

Rows lie along ``dim`` (2 for NCHW, 1 for NHWC). A ``RowGroup`` names the
shards of one row of the mesh. The transport follows the group's backend:
NCCL takes device tensors as they are; a gloo group takes host tensors, and
a CUDA tensor on a gloo group is copied to the host and back explicitly
(two ranks sharing one card). The choice is made by the backend, never on a
failure. Both directions of an exchange go in one ``batch_isend_irecv`` so
that neighbours cannot wait on each other.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = ["RowGroup", "all_gather_rows", "all_reduce_sum", "halo_exchange", "split_rows"]

_TAG_DOWN, _TAG_UP = 11, 12


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The shards of one mesh row: the process group, the global ranks in
    row order (shard i holds the i-th stripe of rows), and this rank's shard."""

    group: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if _staged(group, t) else t


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (all ranks when None) in a new
    tensor, not differentiated."""
    w = t.detach().cpu() if _staged(group, t) else t.detach().clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device)


def _gather(x: torch.Tensor, rg: RowGroup, dim: int) -> torch.Tensor:
    w = _wire(rg.group, x)
    parts = [torch.empty_like(w) for _ in range(rg.size)]
    dist.all_gather(parts, w, group=rg.group)
    return torch.cat(parts, dim).to(x.device)


def _reduce_scatter(g: torch.Tensor, rg: RowGroup, dim: int) -> torch.Tensor:
    """This shard's stripe of the sum of ``g`` over the group."""
    h = g.shape[dim] // rg.size
    if dist.get_backend(rg.group) == dist.Backend.NCCL:
        parts = [p.contiguous() for p in g.split(h, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=rg.group)
        return out
    # gloo has no reduce-scatter of its own: the sum, then this stripe
    return all_reduce_sum(g, rg.group).narrow(dim, rg.index * h, h).contiguous()


def _exchange(rg: RowGroup, send_up, send_down):
    """Send ``send_up`` to the previous shard and ``send_down`` to the next;
    return what the previous and the next shard sent (zeros where there is
    none). Either may be None (nothing goes that way)."""
    prev = rg.ranks[rg.index - 1] if rg.index > 0 else None
    nxt = rg.ranks[rg.index + 1] if rg.index + 1 < rg.size else None
    # by symmetry the previous shard sends down what this one sends down
    from_up = torch.zeros_like(send_down) if send_down is not None else None
    from_down = torch.zeros_like(send_up) if send_up is not None else None
    ops, recvs = [], []
    for peer, send, recv, tag_send, tag_recv in (
        (prev, send_up, from_up, _TAG_UP, _TAG_DOWN),
        (nxt, send_down, from_down, _TAG_DOWN, _TAG_UP),
    ):
        if peer is None:
            continue
        if send is not None:
            ops.append(dist.P2POp(dist.isend, _wire(rg.group, send), peer, rg.group, tag_send))
        if recv is not None:
            buf = _wire(rg.group, recv)
            ops.append(dist.P2POp(dist.irecv, buf, peer, rg.group, tag_recv))
            recvs.append((recv, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for recv, buf in recvs:
        if buf is not recv:
            recv.copy_(buf)
    return from_up, from_down


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, rg, dim):
        ctx.above, ctx.below, ctx.rg, ctx.dim = above, below, rg, dim
        h = x.shape[dim]
        send_up = x.narrow(dim, 0, below) if below else None
        send_down = x.narrow(dim, h - above, above) if above else None
        halo_above, halo_below = _exchange(rg, send_up, send_down)
        parts = [p for p in (halo_above, x, halo_below) if p is not None]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        above, below, rg, dim = ctx.above, ctx.below, ctx.rg, ctx.dim
        h = g.shape[dim] - above - below
        # the halo rows' cotangents go back to the shards they came from
        g_above = g.narrow(dim, 0, above) if above else None
        g_below = g.narrow(dim, above + h, below) if below else None
        from_up, from_down = _exchange(rg, g_above, g_below)
        gx = g.narrow(dim, above, h).clone()
        if below:
            gx.narrow(dim, 0, below).add_(from_up)
        if above:
            gx.narrow(dim, h - above, above).add_(from_down)
        return gx, None, None, None, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rg, dim):
        ctx.rg, ctx.dim = rg, dim
        return _gather(x, rg, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.rg, ctx.dim), None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rg, dim):
        ctx.rg, ctx.dim, ctx.rows = rg, dim, x.shape[dim]
        h = x.shape[dim] // rg.size
        return x.narrow(dim, rg.index * h, h).clone()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.rows
        gx = g.new_zeros(shape)
        gx.narrow(ctx.dim, ctx.rg.index * g.shape[ctx.dim], g.shape[ctx.dim]).copy_(g)
        return gx, None, None


def all_gather_rows(x: torch.Tensor, rg: RowGroup, dim: int) -> torch.Tensor:
    """The whole frame from every shard's stripe (rows along ``dim``)."""
    if rg.size == 1:
        return x
    return _AllGatherRows.apply(x, rg, dim)


def split_rows(x: torch.Tensor, rg: RowGroup, dim: int) -> torch.Tensor:
    """This shard's stripe of a replicated tensor."""
    if rg.size == 1:
        return x
    if x.shape[dim] % rg.size:
        raise ValueError(f"split_rows: {x.shape[dim]} rows do not divide over {rg.size} shards")
    return _SplitRows.apply(x, rg, dim)


def _zero_pad(x: torch.Tensor, above: int, below: int, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = above
    top = x.new_zeros(shape)
    shape[dim] = below
    return torch.cat([top, x, x.new_zeros(shape)], dim)


def halo_exchange(x: torch.Tensor, above: int, below: int, rg: RowGroup, dim: int) -> torch.Tensor:
    """``x`` with ``above`` rows of the previous shard before it and
    ``below`` rows of the next shard after it; zeros beyond the global
    frame. A halo wider than the stripe is cut from the gathered frame."""
    h = x.shape[dim]
    if rg.size == 1:
        return _zero_pad(x, above, below, dim)
    if above <= h and below <= h:
        return _HaloExchange.apply(x, above, below, rg, dim)
    padded = _zero_pad(all_gather_rows(x, rg, dim), above, below, dim)
    return padded.narrow(dim, rg.index * h, h + above + below)
