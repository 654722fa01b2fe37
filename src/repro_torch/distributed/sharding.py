"""Logical-axis sharding: parameter definitions, mesh rules, seeded init.

``ParamDef`` (shape, logical axes, init rule) declares every parameter, and
``init_params`` fills a nested dict of ParamDefs with tensors drawn from
one ``torch.Generator``. The mesh half is ``repro.distributed.sharding``'s
rule table and ``Runtime``: a logical axis maps to mesh axes (``batch`` to
``(pod, data)``, ``experts`` and the Megatron axes to ``model``, ``embed``
to ``data`` under ``FSDP_RULES``), ``pspec`` gives the reference's
``PartitionSpec`` entries as a plain tuple, and ``axis_for``, ``dp_axes``,
``axis_size`` and ``dp_size`` answer as the reference's do. A mesh is any
object with ``axis_names`` and a ``shape`` mapping (``launch.mesh``'s
``ProcessMesh``; its ``coords`` for ``local``).

The port's layout is ``Runtime.placement``, the rule table's ``pspec`` on
every leaf: heads, kv_heads (head_dim where kv_heads does not divide), mlp,
vocab, conv_inner and experts over ``model``, ``embed`` over ``data`` under
``FSDP_RULES``, a cache's ``batch`` over the data axes. A rank holds its
block of each split dim (``block``, ``local``); a leaf whose last dim is
``runs`` equal runs side by side (mamba's ``in_proj``, x then z) holds its
block of each run. ``init_params(..., rt)`` keeps this rank's block of the
one-rank draw, and ``gather`` puts the whole leaf back together.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.distributed import collectives as C

DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int8": torch.int8,
}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis per dim
    init: str = "normal"  # normal | zeros | ones | small | fan_in
    dtype: str | None = None  # override model param dtype
    scale: float | None = None  # stddev override for normal init
    # the last dim is this many equal runs side by side (mamba's in_proj:
    # x, then z); a rank's block of it is its block of each run
    runs: int = 1

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")
        if self.runs > 1 and self.shape[-1] % self.runs:
            raise ValueError(f"last dim {self.shape[-1]} is not {self.runs} "
                             f"equal runs")


def iter_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in sorted-key order, the order
    ``jax.tree.flatten`` visits a dict pytree. Paths join keys with '/'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


# float32 elements of one init draw (2.1 GB). A larger leaf is drawn in
# slices: a whole float32 draw of qwen3-moe's 9.7 G-element expert leaf
# would take 38.7 GB beside the leaves already drawn.
MAX_DRAW = 2 ** 29


def _init_leaf(gen: torch.Generator, d: ParamDef, default_dtype,
               pieces: list | None = None) -> torch.Tensor:
    """One leaf, following the reference's ``_init_leaf`` rule for rule.

    The reference takes ``fan_in = shape[0]`` of the leaf as stored, so for
    a per-layer weight stacked to (layers, ...) the fan-in is the layer
    count, not the input width. That behaviour is kept on purpose: the
    port must draw from the same distribution as the reference.

    A leaf of at most ``MAX_DRAW`` elements is one ``torch.randn`` call. A
    larger one is allocated once in its dtype and filled one index of its
    leading axis at a time (recursing while a slice is still larger), each
    slice scaled with the whole leaf's scale.

    ``pieces``, per dim the ``(start, size)`` runs a rank holds
    (``Runtime.pieces``), keeps only that block of the leaf: the draws are
    the whole leaf's, in the same order and slices, and a slice outside the
    block is drawn and dropped, so the generator ends where the whole draw
    leaves it and the block is the whole draw's, bit for bit. Nothing
    larger than one draw is ever allocated beside it."""
    dtype = torch_dtype(d.dtype or default_dtype)
    dev = gen.device
    shape = (tuple(sum(n for _, n in ps) for ps in pieces) if pieces
             else d.shape)
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    fan_in = d.shape[0] if len(d.shape) >= 1 else 1
    if d.scale is not None:
        scale = d.scale
    elif d.init == "normal":
        scale = 0.02
    elif d.init == "small":
        scale = 0.01
    else:  # fan_in
        scale = 1.0 / max(fan_in, 1) ** 0.5
    if pieces is None and math.prod(d.shape) <= MAX_DRAW:
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        # scaled in place: one float32 copy of the leaf at a time
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    _fill_bounded(out, gen, scale, d.shape, pieces)
    return out


def take_pieces(x, pieces: list):
    """The block of ``x`` (a tensor, or a numpy array read from a
    checkpoint) that ``pieces`` names: per dim, its ``(start, size)`` runs
    concatenated in order. A dim of ``x`` of size 1 where the runs say
    otherwise (an int8 moment's scales on the row axis) is kept whole."""
    for dim, ps in enumerate(pieces):
        if len(ps) == 1 and ps[0] == (0, x.shape[dim]):
            continue
        if x.shape[dim] == 1:
            continue
        lead = (slice(None),) * dim
        parts = [x[(*lead, slice(a, a + n))] for a, n in ps]
        if len(parts) == 1:
            x = parts[0]
        elif isinstance(x, torch.Tensor):
            x = torch.cat(parts, dim)
        else:
            import numpy as np

            x = np.concatenate(parts, dim)
    return x


def _fill_bounded(out: torch.Tensor | None, gen: torch.Generator, scale: float,
                  shape: tuple | None = None, pieces: list | None = None) -> None:
    """Fill ``out`` with N(0, scale^2) draws of at most ``MAX_DRAW``
    float32 elements each, in index order of the leading axes of
    ``shape`` (``out``'s own when None); ``out`` holds the ``pieces`` of
    them (see ``_init_leaf``), or nothing when None: the draws are made and
    dropped."""
    shape = tuple(out.shape) if shape is None else tuple(shape)
    if math.prod(shape) <= max(MAX_DRAW, 1):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        if out is not None:
            if pieces:
                x = take_pieces(x, pieces)
            out.copy_(x.mul_(scale))
        return
    where = {}  # leading index -> its row of ``out``
    at = 0
    for a, n in (pieces[0] if pieces else ((0, shape[0]),)):
        where.update({a + j: at + j for j in range(n)})
        at += n
    for i in range(shape[0]):
        row = where.get(i) if out is not None else None
        _fill_bounded(None if row is None else out[row], gen, scale,
                      shape[1:], pieces[1:] if pieces else None)


def init_params(defs: Any, gen: torch.Generator, default_dtype,
                rt: "Runtime | None" = None) -> Any:
    """Concrete seeded init of a ParamDef tree, on ``gen``'s device. Leaves
    draw in sorted-path order from the one generator, each in draws of at
    most ``MAX_DRAW`` float32 elements (``_init_leaf``). With ``rt`` on a
    mesh, each leaf is this rank's block by ``rt.placement``: the same
    block of the one-rank draw, with no broadcast."""
    out: dict = {}
    for path, d in iter_leaves(defs):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        pieces = rt.pieces(d) if rt is not None else None
        node[name] = _init_leaf(gen, d, default_dtype, pieces)
    return out


def abstract_params(defs: Any, default_dtype) -> Any:
    """The tree of ``defs`` as meta-device tensors of each leaf's shape and
    dtype: no allocation (the reference's ``ShapeDtypeStruct`` tree)."""
    return map_tree(
        lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype or default_dtype),
                              device="meta"),
        defs,
    )


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "heads_flat": "model",  # rwkv (B, L, H*K) projections
    "kv_heads": "model",
    # fallback TP axis: shards head_dim when heads %% mesh != 0 (MQA gemma);
    # pspec() priority gives `heads`/`kv_heads` first claim on `model`.
    "head_dim": "model",
    "mlp": "model",
    "experts": "model",
    "conv_inner": "model",
    "embed": None,
    "layers": None,
    "stack": None,
    "seq": None,
    "kv_seq": None,
    "state": None,
}

FSDP_RULES = dict(DEFAULT_RULES, embed="data")

# pspec's priority: these claim their mesh axis ahead of the others
_HEAD_LIKE = ("heads", "kv_heads", "experts", "mlp", "vocab", "conv_inner",
              "heads_flat")


def _mesh_axis_size(mesh, axis) -> int:
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(_mesh_axis_size(mesh, a) for a in axis)
    return mesh.shape.get(axis, 1)


def mesh_axes(entry) -> tuple[str, ...]:
    """A pspec entry as a tuple of mesh axes (empty for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass
class Runtime:
    """Execution context threaded through the models.

    mesh=None: one rank; ``placement`` holds every leaf whole."""

    mesh: Any = None
    rules: dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def _present(self, axis):
        """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on the
        single-pod mesh)."""
        if self.mesh is None or axis is None:
            return None
        names = self.mesh.axis_names
        if isinstance(axis, tuple):
            t = tuple(a for a in axis if a in names)
            return t if t else None
        return axis if axis in names else None

    def axis_for(self, logical: str | None, dim_size: int):
        """Mesh axis for a logical axis, dropped if indivisible/absent."""
        if logical is None or self.mesh is None:
            return None
        mesh_axis = self._present(self.rules.get(logical))
        if mesh_axis is None:
            return None
        if dim_size % _mesh_axis_size(self.mesh, mesh_axis) != 0:
            return None  # e.g. kv_heads=1 under model=16 -> replicate
        return mesh_axis

    def dp_axes(self) -> tuple[str, ...]:
        return mesh_axes(self._present(self.rules.get("batch")))

    def pspec(self, axes: tuple[str | None, ...], shape: tuple[int, ...]) -> tuple:
        """Per-dim logical->mesh mapping, the reference's ``PartitionSpec``
        entries as a tuple; a mesh axis is used at most once (priority:
        head-like axes first, then left to right)."""
        order = sorted(range(len(axes)),
                       key=lambda i: 0 if axes[i] in _HEAD_LIKE else 1)
        used: set = set()
        out: list = [None] * len(axes)
        for i in order:
            mesh_axis = self._present(self.rules.get(axes[i])) if axes[i] else None
            if mesh_axis is None:
                continue
            # keep whatever part of the (possibly tuple) mapping is unclaimed
            avail = tuple(a for a in mesh_axes(mesh_axis) if a not in used)
            if not avail:
                continue
            if shape[i] % _mesh_axis_size(self.mesh, avail) != 0:
                continue
            used.update(avail)
            out[i] = avail if len(avail) > 1 else avail[0]
        return tuple(out)

    def placement(self, d: ParamDef) -> tuple:
        """The layout the port holds ``d`` in: the rule table's ``pspec``,
        one entry per dim (None: whole). A ``runs`` leaf splits each of its
        runs alike (``pieces``)."""
        if self.mesh is None:
            return (None,) * len(d.shape)
        return self.pspec(d.axes, d.shape)

    def split_axes(self, d: ParamDef, dims=None) -> tuple[str, ...]:
        """The mesh axes of more than one rank that split ``d`` (on
        ``dims`` only, when given), in the mesh's axis order."""
        if self.mesh is None:
            return ()
        used = {a for i, e in enumerate(self.placement(d))
                if dims is None or i in dims for a in mesh_axes(e)
                if self.mesh.shape[a] > 1}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def block(self, d: ParamDef) -> tuple | None:
        """This rank's block of ``d`` as one ``(start, size)`` per dim, or
        None when the rank holds ``d`` whole. On a ``runs`` leaf's last dim
        the pair is within each run (``pieces`` has the leaf's own)."""
        spec = self.placement(d) if self.mesh is not None else ()
        if not any(_mesh_axis_size(self.mesh, e) > 1 for e in spec):
            return None
        out = []
        for dim, (n, entry) in enumerate(zip(d.shape, spec)):
            if dim == len(d.shape) - 1:
                n //= d.runs
            k = _mesh_axis_size(self.mesh, entry)
            if n % k:
                raise ValueError(f"{d}: a run of {n} does not split {k} ways")
            out.append((self.index(entry) * (n // k), n // k))
        return tuple(out)

    def pieces(self, d: ParamDef) -> list | None:
        """Per dim, the ``(start, size)`` runs of ``d`` this rank holds, in
        the order it holds them; None when it holds ``d`` whole."""
        blk = self.block(d)
        if blk is None:
            return None
        out = [((a, n),) for a, n in blk]
        m = d.shape[-1] // d.runs
        if d.runs > 1 and blk[-1][1] < m:
            a, n = blk[-1]
            out[-1] = tuple((j * m + a, n) for j in range(d.runs))
        return out

    def block_shape(self, d: ParamDef) -> tuple[int, ...]:
        """The shape of this rank's block of ``d``."""
        ps = self.pieces(d)
        return d.shape if ps is None else tuple(sum(n for _, n in p) for p in ps)

    def index(self, axes) -> int:
        """This rank's coordinate along a mesh axis or tuple of axes, the
        tuple's coordinates combined row-major (the first axis major)."""
        i = 0
        for a in mesh_axes(axes):
            i = i * self.mesh.shape[a] + self.mesh.coords[a]
        return i

    def local(self, leaf: torch.Tensor, d: ParamDef) -> torch.Tensor:
        """This rank's block of the whole tensor ``leaf`` (shaped as ``d``
        on each split dim; an int8 moment's scales, of last dim 1, take
        their row block), a copy; ``leaf`` itself when the rank holds it
        whole."""
        ps = self.pieces(d)
        if ps is None:
            return leaf
        for dim, whole in enumerate(d.shape):
            if leaf.shape[dim] not in (whole, 1):
                raise ValueError(f"leaf {tuple(leaf.shape)} is not {d.shape} "
                                 f"on dim {dim}")
        return take_pieces(leaf, ps).clone()

    def gather(self, t: torch.Tensor, d: ParamDef) -> torch.Tensor:
        """The whole leaf from every rank's block ``t``: an all-gather over
        each split dim's mesh axes (a ``runs`` dim run by run; an int8
        moment's scale dim of 1 as it is). Collective over the mesh."""
        held = self.block_shape(d)
        for dim, entry in enumerate(self.placement(d)):
            if _mesh_axis_size(self.mesh, entry) == 1 or (
                    t.shape[dim] == 1 != held[dim]):  # a moment's scales
                continue
            if dim == len(d.shape) - 1 and d.runs > 1:
                t = C.all_gather(t.unflatten(dim, (d.runs, -1)), entry,
                                 self.mesh, dim=dim + 1).flatten(dim, dim + 1)
            else:
                t = C.all_gather(t, entry, self.mesh, dim=dim)
        return t

    def constrain(self, x: torch.Tensor, *axes: str | None) -> torch.Tensor:
        """The identity. The reference constrains an activation's layout
        for GSPMD; here every collective is explicit, and the code that
        runs on each rank fixes each activation's layout itself."""
        return x

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        return _mesh_axis_size(self.mesh, self._present(self.rules.get(logical)))

    @property
    def dp_size(self) -> int:
        return self.axis_size("batch")
