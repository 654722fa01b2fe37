"""Collectives over a mesh axis or tuple of axes: the port's counterpart of
``shard_map``'s ``psum``, ``pmax``, ``pmean``, ``ppermute`` and
``axis_index``, on a ``launch.mesh.ProcessMesh``.

Each collective hands its tensor to the group as it is, unless the
backend cannot take a CUDA tensor for that collective: then it copies the
tensor through pinned host memory and back, and counts the copy in
``HOST_COPIES[collective]``. Which is which is the table
``DEVICE_TENSORS[(backend, collective)]``, read before the call; nothing
is decided by catching an exception. NCCL takes device tensors for all of
them. gloo (torch 2.11, probed on an H100 with two ranks sharing cuda:0,
``scripts/gloo_probe.py``) reduces, gathers and reduce-scatters CUDA
tensors itself, staging them in host memory inside the call, but its
``send`` and ``recv`` read the tensor's address as host memory
(``writev ... Bad address``), so ``ppermute`` stages them here.

A group of one rank (an axis of size 1) makes no call. The blocks of a
gather or a reduce-scatter over a tuple of axes are in the row-major order
of the tuple as given (its first axis major), as ``Runtime.index`` numbers
a rank's block. ``reduce_out``, ``copy_in`` and ``mean_out`` are the
differentiable forms a model uses around a computation split over ranks
whose result every rank holds: ``psum`` forward and the identity backward
(a row-parallel product), the identity forward and ``psum`` backward (a
column-parallel one), ``pmean`` forward and the gradient over the group's
size backward. ``gather_in`` is FSDP's: the whole tensor from the ranks'
blocks forward, the gradient summed over the ranks and cut back to this
rank's block (a reduce-scatter) backward.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# (backend, collective) -> the backend takes a CUDA tensor as it is
DEVICE_TENSORS = {
    ("nccl", "all_reduce"): True,
    ("nccl", "all_gather"): True,
    ("nccl", "reduce_scatter"): True,
    ("nccl", "send"): True,
    ("nccl", "recv"): True,
    ("gloo", "all_reduce"): True,
    ("gloo", "all_gather"): True,
    ("gloo", "reduce_scatter"): True,
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
    """Reduce ``x`` in place over ``axes`` (``op`` "sum" or "max"); no axes:
    ``x`` as it is."""
    if not axes:
        return x
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


def _positions(axes, mesh, ranks) -> list[int]:
    """Each of the group's ``ranks``' block index along ``axes``: its
    coordinates combined row-major in the order ``axes`` names them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    out = []
    for r in ranks:
        c = dict(zip(mesh.axis_names, mesh.coords_of(r)))
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + c[a]
        out.append(i)
    return out


def all_gather(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` of every rank along ``axes``, concatenated along
    ``dim`` in block order."""
    if not axes:
        return x
    group, ranks = mesh.group(axes)
    if group is None:
        return x
    staged = _staged(mesh, "all_gather", x)
    src = _to_host(x, "all_gather") if staged else x.contiguous()
    outs = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(outs, src, group=group)
    order = [None] * len(ranks)
    for j, i in enumerate(_positions(axes, mesh, ranks)):
        order[i] = outs[j]
    out = torch.cat(order, dim=dim)
    return out.to(x.device) if staged else out


def reduce_scatter(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``axes``, of which this rank keeps
    its block along ``dim`` (block order as in ``all_gather``)."""
    if not axes:
        return x
    group, ranks = mesh.group(axes)
    if group is None:
        return x
    if x.shape[dim] % len(ranks):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{len(ranks)} ways")
    blocks = x.movedim(dim, 0).chunk(len(ranks))
    pos = _positions(axes, mesh, ranks)
    staged = _staged(mesh, "reduce_scatter", x)
    parts = [(_to_host(blocks[i], "reduce_scatter") if staged
              else blocks[i].contiguous()) for i in pos]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return (out.to(x.device) if staged else out).movedim(0, dim)


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


class _GatherIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axes, ctx.mesh, ctx.dim), None, None, None


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


def gather_in(x: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """The whole tensor from the ranks' blocks of it along ``dim`` (FSDP's
    gather of a layer's weights, or a projection split on its output):
    every rank then uses it for its own part, so the gradient of this
    rank's block is the ranks' gradients summed and cut to the block."""
    if not axes:
        return x
    return _GatherIn.apply(x, axes, mesh, dim)
