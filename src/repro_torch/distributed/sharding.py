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

The port's layout is ``Runtime.placement``: only the ``experts`` axis of a
parameter (and the ``batch`` axis of activations and caches) is split over
the mesh; every other leaf is held whole on each rank, where the rule table
would shard it over ``model`` or ``data``. ``init_params(..., rt)`` keeps
this rank's block of the one-rank draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

DTYPES = {
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

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


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
               block: tuple | None = None) -> torch.Tensor:
    """One leaf, following the reference's ``_init_leaf`` rule for rule.

    The reference takes ``fan_in = shape[0]`` of the leaf as stored, so for
    a per-layer weight stacked to (layers, ...) the fan-in is the layer
    count, not the input width. That behaviour is kept on purpose: the
    port must draw from the same distribution as the reference.

    A leaf of at most ``MAX_DRAW`` elements is one ``torch.randn`` call. A
    larger one is allocated once in its dtype and filled one index of its
    leading axis at a time (recursing while a slice is still larger), each
    slice scaled with the whole leaf's scale.

    ``block``, one ``(start, size)`` per dim, keeps only that block of the
    leaf: the draws are the whole leaf's, in the same order and slices, and
    a slice outside the block is drawn and dropped, so the generator ends
    where the whole draw leaves it and the block is the whole draw's, bit
    for bit. Nothing larger than one draw is ever allocated beside it."""
    dtype = torch_dtype(d.dtype or default_dtype)
    dev = gen.device
    shape = tuple(n for _, n in block) if block else d.shape
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
    if block is None and math.prod(d.shape) <= MAX_DRAW:
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        # scaled in place: one float32 copy of the leaf at a time
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    _fill_bounded(out, gen, scale, d.shape, block)
    return out


def _fill_bounded(out: torch.Tensor | None, gen: torch.Generator, scale: float,
                  shape: tuple | None = None, block: tuple | None = None) -> None:
    """Fill ``out`` with N(0, scale^2) draws of at most ``MAX_DRAW``
    float32 elements each, in index order of the leading axes of
    ``shape`` (``out``'s own when None); ``out`` holds the ``block`` of
    them (see ``_init_leaf``), or nothing when None: the draws are made and
    dropped."""
    shape = tuple(out.shape) if shape is None else tuple(shape)
    if math.prod(shape) <= max(MAX_DRAW, 1):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        if out is not None:
            if block:
                x = x[tuple(slice(a, a + n) for a, n in block)]
            out.copy_(x.mul_(scale))
        return
    start, size = block[0] if block else (0, shape[0])
    for i in range(shape[0]):
        inside = out is not None and start <= i < start + size
        _fill_bounded(out[i - start] if inside else None, gen, scale,
                      shape[1:], block[1:] if block else None)


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
        block = rt.block(d) if rt is not None else None
        node[name] = _init_leaf(gen, d, default_dtype, block)
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

# the logical axes that the port's layout splits over the mesh
PLACED = ("experts", "batch")
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
        """The layout the port holds ``d`` in: ``pspec``'s entry on an
        ``experts`` or ``batch`` dim, None (whole) on every other. A leaf
        that the rules would shard over ``model`` or ``data`` on another
        axis (heads, kv_heads, head_dim, mlp, vocab, conv_inner, FSDP's
        embed) is held whole on each rank; Megatron tensor parallelism and
        FSDP placements are not ported yet."""
        spec = self.pspec(d.axes, d.shape)
        return tuple(e if a in PLACED else None for a, e in zip(d.axes, spec))

    def block(self, d: ParamDef) -> tuple | None:
        """This rank's block of ``d`` as one ``(start, size)`` per dim, or
        None when the rank holds ``d`` whole."""
        spec = self.placement(d) if self.mesh is not None else ()
        if not any(spec):
            return None
        out = []
        for n, entry in zip(d.shape, spec):
            k = _mesh_axis_size(self.mesh, entry)
            out.append((self.index(entry) * (n // k), n // k))
        return tuple(out)

    def index(self, axes) -> int:
        """This rank's coordinate along a mesh axis or tuple of axes, the
        tuple's coordinates combined row-major (the first axis major)."""
        i = 0
        for a in mesh_axes(axes):
            i = i * self.mesh.shape[a] + self.mesh.coords[a]
        return i

    def local(self, leaf: torch.Tensor, d: ParamDef) -> torch.Tensor:
        """This rank's block of the whole tensor ``leaf`` (shaped as ``d`` on
        each split dim; an int8 moment's scales, of last dim 1, too), a
        copy; ``leaf`` itself when the rank holds it whole."""
        blk = self.block(d)
        if blk is None:
            return leaf
        for dim, ((a, n), whole) in enumerate(zip(blk, d.shape)):
            if n == whole:
                continue
            if leaf.shape[dim] != whole:
                raise ValueError(f"leaf {tuple(leaf.shape)} is not {d.shape} "
                                 f"on dim {dim}")
            leaf = leaf.narrow(dim, a, n)
        return leaf.clone()

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
