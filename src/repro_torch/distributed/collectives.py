"""Collectives over a mesh axis or tuple of axes: the port's counterpart of
``shard_map``'s ``psum``, ``pmax``, ``pmean``, ``ppermute`` and
``axis_index``, on a ``launch.mesh.ProcessMesh``.

Each collective hands its tensor to the group as it is, unless the
backend cannot take a CUDA tensor for that collective: then it copies the
tensor through pinned host memory and back, and counts the copy in
``HOST_COPIES[collective]``. Which is which is the table
``DEVICE_TENSORS[(backend, collective)]``, read before the call; nothing
is decided by catching an exception. NCCL takes device tensors for all of
them. gloo (torch 2.11, probed on an H100 with two ranks sharing cuda:0)
reduces and gathers CUDA tensors itself, staging them in host memory
inside the call, but its ``send`` and ``recv`` read the tensor's address
as host memory (``writev ... Bad address``), so ``ppermute`` stages them
here.

A group of one rank (an axis of size 1) makes no call. ``reduce_out``,
``copy_in`` and ``mean_out`` are the differentiable forms a model uses
around a computation split over ranks whose result every rank holds:
``psum`` forward and the identity backward, the identity forward and
``psum`` backward, ``pmean`` forward and the gradient over the group's
size backward.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# (backend, collective) -> the backend takes a CUDA tensor as it is
DEVICE_TENSORS = {
    ("nccl", "all_reduce"): True,
    ("nccl", "all_gather"): True,
    ("nccl", "send"): True,
    ("nccl", "recv"): True,
    ("gloo", "all_reduce"): True,
    ("gloo", "all_gather"): True,
    ("gloo", "send"): False,
    ("gloo", "recv"): False,
}

# host round trips made because the table said so, by collective
HOST_COPIES: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(mesh, collective: str, t: torch.Tensor) -> bool:
    """Whether ``t`` must go through host memory for ``collective``."""
    if t.device.type != "cuda":
        return False
    return not DEVICE_TENSORS[(mesh.backend, collective)]


def _to_host(t: torch.Tensor, collective: str) -> torch.Tensor:
    HOST_COPIES[collective] += 1
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(x: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` in place over ``axes`` (``op`` "sum" or "max")."""
    group, _ = mesh.group(axes)
    if group is None:
        return x
    if _staged(mesh, "all_reduce", x):
        h = _to_host(x, "all_reduce")
        dist.all_reduce(h, op=_OPS[op], group=group)
        return x.copy_(h)
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return all_reduce_(x.clone(), axes, mesh, "sum")


def pmax(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return all_reduce_(x.clone(), axes, mesh, "max")


def pmean(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return psum(x, axes, mesh) / mesh.axis_size(axes)


def axis_index(axes, mesh) -> int:
    """This rank's coordinate along ``axes``, a tuple's coordinates
    combined row-major in the mesh's axis order."""
    _, ranks = mesh.group(axes)
    return ranks.index(mesh.rank)


def all_gather(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` of every rank along ``axes``, concatenated along
    ``dim`` in the group's rank order."""
    group, ranks = mesh.group(axes)
    if group is None:
        return x
    staged = _staged(mesh, "all_gather", x)
    src = _to_host(x, "all_gather") if staged else x.contiguous()
    outs = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(outs, src, group=group)
    out = torch.cat(outs, dim=dim)
    return out.to(x.device) if staged else out


def ppermute(x: torch.Tensor, axis: str, perm, mesh) -> torch.Tensor:
    """``jax.lax.ppermute``: each pair ``(i, j)`` of ``perm`` sends rank
    i's ``x`` (coordinates along ``axis``) to rank j; a rank that no pair
    sends to gets zeros."""
    _, ranks = mesh.group(axis)
    me = ranks.index(mesh.rank)
    out = torch.zeros_like(x)
    if len(ranks) == 1:
        return x.clone() if (0, 0) in perm else out
    send = [j for i, j in perm if i == me]
    recv = [i for i, j in perm if j == me]
    src = (_to_host(x, "send") if _staged(mesh, "send", x) and send
           else x.contiguous())
    buf = (torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
           if _staged(mesh, "recv", x) and recv else out)
    if buf is not out:
        HOST_COPIES["recv"] += 1
    works = [dist.isend(src, ranks[j]) for j in send]
    works += [dist.irecv(buf, ranks[i]) for i in recv]
    for w in works:
        w.wait()
    if buf is not out:
        out.copy_(buf)
    return out


def barrier(mesh) -> None:
    if mesh.size > 1:
        dist.barrier()


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return psum(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axes, ctx.mesh), None, None


class _MeanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.n = mesh.axis_size(axes)
        return pmean(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def reduce_out(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``psum`` of the ranks' partial ``x``, which every rank then uses
    alike: the gradient of each partial is the result's (identity)."""
    if not axes:
        return x
    return _ReduceOut.apply(x, axes, mesh)


def copy_in(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``x``, held alike on every rank of ``axes``, entering a computation
    whose parts the ranks split: its gradient is the sum of the ranks'."""
    if not axes:
        return x
    return _CopyIn.apply(x, axes, mesh)


def mean_out(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``pmean`` of the ranks' ``x``, which every rank then uses alike:
    each rank's share of the gradient is the result's over the group's
    size."""
    if not axes:
        return x
    return _MeanOut.apply(x, axes, mesh)
