"""The port's mesh over a ``torch.distributed`` process group, and a
launcher that runs one function on every rank of a small mesh.

``make_host_mesh(n_data, n_model)`` (the reference's, ``launch/mesh.py``)
gives a ``ProcessMesh`` of axes ``("data", "model")`` over the ranks of the
default process group; ``make_mesh(shape, axis_names)`` any other, such as
a ``("stage",)`` axis for the pipeline. Ranks are laid out row-major over
the axes (the first axis major), as ``jax.make_mesh`` lays out devices.

A ``ProcessMesh`` has what ``sharding.Runtime`` reads (``axis_names``, a
``shape`` mapping) plus this rank's ``coords`` and one process group for
each axis and each tuple of axes: ``group(axes)`` is the group of the
ranks that share this rank's coordinates on every other axis. The groups
are made when the mesh is, by every rank in the same order (``new_group``
is collective over the whole world); a group of one rank is None.

``run_ranks(fn, n_data, n_model, ...)`` spawns one process a rank
(``torch.multiprocessing``, ``spawn``), joins them at a ``file://``
rendezvous under the caller's directory, builds the (data, model) mesh
and returns each rank's ``fn(mesh, *args)``. A rank that raises or a run
past ``timeout_s`` ends every rank and raises with the failing rank's
traceback. The backend is explicit: ``nccl`` when each rank has its own
card, ``gloo`` on the CPU; more ranks than cards raises unless the caller
asks for ``gloo``, which then carries the ranks' CUDA tensors through host
memory (``distributed.collectives``).

The reference's ``make_production_mesh`` and its TPU constants are not
ported: they belong to the dry-run.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import queue
import time
import traceback
import uuid
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class ProcessMesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        if dist.is_initialized():
            self.rank, world = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, world, self.backend = 0, 1, None
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the "
                             f"process group has {world}")
        self.coords = dict(zip(self.axis_names, self.coords_of(self.rank)))
        self._groups: dict[tuple, tuple] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                self._make_groups(axes)

    def coords_of(self, rank: int) -> tuple[int, ...]:
        """``rank``'s coordinate on each axis, in the mesh's axis order."""
        out = []
        for a in reversed(self.axis_names):
            rank, c = divmod(rank, self.shape[a])
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _make_groups(self, axes: tuple[str, ...]) -> None:
        """Every group along ``axes`` (one for each coordinate of the other
        axes), made in the same order on each rank; this rank's kept."""
        rest = [a for a in self.axis_names if a not in axes]
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            ranks = [self.rank_of({**dict(zip(rest, fixed)),
                                   **dict(zip(axes, inner))})
                     for inner in itertools.product(
                         *(range(self.shape[a]) for a in axes))]
            if len(ranks) == 1:
                group = None
            elif len(ranks) == self.size:
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[axes] = (group, ranks)

    def _key(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in mesh {self.shape}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes) -> tuple[Any, list[int]]:
        """(process group or None for one rank, its global ranks in order)
        of this rank along ``axes`` (an axis or a tuple of them, taken in
        the mesh's axis order)."""
        return self._groups[self._key(axes)]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> ProcessMesh:
    return ProcessMesh(tuple(shape), tuple(axis_names))


def make_host_mesh(n_data: int = 1, n_model: int = 1) -> ProcessMesh:
    """A (data, model) mesh over the ranks of the process group (one rank
    needs none)."""
    return make_mesh((n_data, n_model), ("data", "model"))


def choose_backend(world: int, device: str, backend: str | None) -> str:
    """The backend for ``world`` ranks on ``device``: ``nccl`` when every
    rank has its own card, ``gloo`` on the CPU. More ranks than cards
    raises unless ``backend="gloo"`` is asked for; NCCL refuses two ranks
    on one card, and gloo then stages device tensors through the host."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: cpu or cuda")
    cards = torch.cuda.device_count()
    if backend is None:
        if world > cards:
            raise ValueError(
                f"{world} ranks on {cards} card(s): NCCL takes one rank a "
                f"card; pass backend='gloo' to share a card through host "
                f"memory")
        return "nccl"
    if backend == "nccl" and world > cards:
        raise ValueError(f"nccl with {world} ranks on {cards} card(s)")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return backend


def _rank_main(rank, world, n_data, n_model, device, backend, init,
               timeout_s, fn, args, results):
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:  # the ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_host_mesh(n_data, n_model), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


class RankError(RuntimeError):
    """A rank of ``run_ranks`` failed; the message holds its traceback."""


def run_ranks(fn: Callable, n_data: int, n_model: int = 1, *, device: str,
              rdv_dir: str | Path, backend: str | None = None,
              args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of ``make_host_mesh(n_data,
    n_model)``, one spawned process a rank (one CPU thread each on the
    CPU); return the ranks' results in rank order. ``fn`` must be
    importable by name (a module-level function) and its arguments and
    result picklable and on the CPU; another mesh over the same ranks
    (``make_mesh``) can be made inside it. Raises ``RankError`` with the
    traceback of the first rank that failed or died, and ``TimeoutError``
    when the ranks are not all done within ``timeout_s``; every rank still
    running is ended first."""
    world = n_data * n_model
    backend = choose_backend(world, device, backend)
    rdv = Path(rdv_dir) / f"rdv-{uuid.uuid4().hex}"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world, n_data, n_model, device, backend, f"file://{rdv}",
              timeout_s, fn, tuple(args), results))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: dict[int, Any] = {}
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:  # give a late report a moment to arrive
                    try:
                        rank, ok, out = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RankError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode} and no report")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(got))} of "
                        f"{world} not done within {timeout_s:.0f}s")
                else:
                    continue
            if not ok:
                raise RankError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        try:
            os.unlink(rdv)
        except OSError:
            pass
    return [got[r] for r in range(world)]
