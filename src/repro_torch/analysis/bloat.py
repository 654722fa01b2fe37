"""Memory-bloat lint of the plain rungs and the dequant count of the int8
chains (counterpart of ``repro.analysis.bloat``).

Two passes over the port's plain PyTorch rungs (the CUDA kernels are held
by :mod:`repro_torch.analysis.contracts`: their working set is the launch,
not a graph):

  * **bloat**: trace each registered rung at a representative shape with
    ``torch.fx.experimental.proxy_tensor.make_fx`` under ``FakeTensorMode``
    (nothing is computed or allocated) and flag any node that makes a
    tensor larger than α × the rung's natural size, max(its largest input,
    its output); α is ``BLOAT_ALPHA`` (2.0; the CLI's ``--alpha`` sets
    another). Views (slices, strides, expansions, permutations, contiguous
    reshapes) materialize nothing, as a fusion body does not in the
    reference's HLO walk. This is the im2col detector: the sliding and library rungs make
    only input- or output-sized tensors, the im2col rungs the K-fold
    column. The self-test is inverted: the im2col baselines are registered
    as known-bloated, and a miss there is itself a violation.
  * **chains**: for every chain of ``quant.apply.CHAINS``, run a small
    quantized conv stack wired with the chain's out_scales on the CPU and
    count the ``calibrate.note_dequant`` sites: exactly one, the tail. The
    CHAINS graph is checked too (no cycles).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.analysis.contracts import Violation

BLOAT_ALPHA = 2.0

#: nodes whose result shares its input's storage
VIEW_OPS = {
    "aten.view.default", "aten._unsafe_view.default", "aten.slice.Tensor",
    "aten.as_strided.default", "aten.expand.default", "aten.permute.default",
    "aten.transpose.int", "aten.t.default", "aten.unsqueeze.default",
    "aten.squeeze.dim", "aten.squeeze.default", "aten.select.int",
    "aten.alias.default", "aten.unfold.default", "aten.detach.default",
    "aten._reshape_alias.default", "aten.diagonal.default",
    "aten.narrow.default", "aten.split.Tensor", "aten.unbind.int",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def materialized(fn: Callable, shapes: tuple) -> tuple[list, int]:
    """Trace ``fn`` on fake float32 tensors of ``shapes``: ([(bytes, op)]
    of every node that makes a tensor of its own, the rung's natural size
    max(largest input, output))."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    with FakeTensorMode():
        args = [torch.empty(s) for s in shapes]
    gm = make_fx(fn, tracing_mode="fake")(*args)
    made, natural = [], max(_nbytes(a) for a in args)
    for node in gm.graph.nodes:
        val = node.meta.get("val")
        if node.op == "output":
            outs = node.args[0]
            outs = outs if isinstance(outs, (tuple, list)) else [outs]
            natural = max([natural] + [
                _nbytes(o.meta["val"]) for o in outs
                if isinstance(o.meta.get("val"), torch.Tensor)])
        elif (node.op == "call_function" and isinstance(val, torch.Tensor)
              and str(node.target) not in VIEW_OPS):
            made.append((_nbytes(val), str(node.target)))
    return made, natural


def check_fn(fn: Callable, shapes: tuple, *, family: str, key: str,
             alpha: float | None = None) -> Violation | None:
    """One ``bloat`` violation (the worst node) where a node makes more
    than α × the rung's natural size."""
    alpha = BLOAT_ALPHA if alpha is None else alpha
    made, natural = materialized(fn, shapes)
    over = [(nb, op) for nb, op in made if nb > alpha * natural]
    if not over:
        return None
    nb, op = max(over)
    return Violation(
        "bloat", family, key,
        f"{op} makes {nb} B, {nb / natural:.1f}x the rung's natural size "
        f"{natural} B (> alpha={alpha:g}); {len(over)} oversized node(s)")


def _rung(fn, **kw):
    def run(x, w):
        return fn(x, w, **kw)
    return run


def _conv1d(backend: str):
    from repro_torch.core import conv as C

    return (_rung(C.conv1d, backend=backend), ((1, 512, 8), (31, 8, 8)))


def _conv2d(backend: str):
    from repro_torch.core import conv as C

    return (_rung(C.conv2d, backend=backend),
            ((1, 48, 48, 8), (9, 9, 8, 8)))


def _conv1d_q():
    from repro_torch.quant import qconv

    def run(x, w):
        qw = qconv.quantize_weight(w)
        return qconv.conv1d_q(x, qw, None, mode="w8a8", accumulate="fast")
    return run, ((1, 512, 8), (31, 8, 8))


#: the rungs ops ships: they must be clean
GATE_RUNGS: dict[str, Callable[[], tuple]] = {
    "conv1d.sliding": lambda: _conv1d("sliding"),
    "conv1d.xla": lambda: _conv1d("xla"),
    "conv2d.sliding": lambda: _conv2d("sliding"),
    "conv2d.xla": lambda: _conv2d("xla"),
    "conv1d_q.w8a8": _conv1d_q,
}

#: the paper's im2col baselines: the lint must flag them
KNOWN_BLOATED: dict[str, Callable[[], tuple]] = {
    "conv1d.im2col_gemm": lambda: _conv1d("im2col_gemm"),
    "conv2d.im2col_gemm": lambda: _conv2d("im2col_gemm"),
}


def check_bloat(*, alpha: float | None = None
                ) -> tuple[list[Violation], dict]:
    """α-check every gate rung (clean required) and every known-bloated
    baseline (a miss there is a violation: the rule lost its teeth)."""
    violations: list[Violation] = []
    for name, make in GATE_RUNGS.items():
        fn, shapes = make()
        v = check_fn(fn, shapes, family="bloat", key=name, alpha=alpha)
        if v is not None:
            violations.append(v)
    for name, make in KNOWN_BLOATED.items():
        fn, shapes = make()
        if check_fn(fn, shapes, family="bloat", key=name,
                    alpha=alpha) is None:
            violations.append(Violation(
                "bloat", "bloat", name,
                "known-bloated im2col baseline was NOT flagged: the "
                "alpha-rule lost its teeth (threshold too high or the "
                "trace walk regressed)"))
    return violations, {"rungs": [*GATE_RUNGS, *KNOWN_BLOATED]}


def chain_paths(chains: dict[str, str]) -> tuple[list[list[str]], list[str]]:
    """Maximal producer -> ... -> tail paths of a CHAINS dict, and the
    structural errors (cycles)."""
    errors: list[str] = []
    heads = [s for s in chains if s not in chains.values()]
    paths: list[list[str]] = []
    for head in sorted(heads):
        path, site = [head], head
        while site in chains:
            site = chains[site]
            if site in path:
                errors.append(f"cycle through {site!r}: {' -> '.join(path)}")
                break
            path.append(site)
        else:
            paths.append(path)
    if not heads and chains:
        errors.append(f"no chain heads: every site is a consumer ({chains})")
    return paths, errors


def check_chains(chains: dict[str, str] | None = None
                 ) -> tuple[list[Violation], dict]:
    """Run a quantized conv stack for every chain and count its dequant
    sites: exactly one, the tail."""
    from repro_torch.models import layers
    from repro_torch.quant import apply as qapply
    from repro_torch.quant import calibrate, qconv

    chains = qapply.CHAINS if chains is None else chains
    violations: list[Violation] = []
    paths, errors = chain_paths(chains)
    for err in errors:
        violations.append(Violation("chain_dequant", "chains", "CHAINS", err))
    C, K, L = 4, 3, 32
    x = torch.linspace(-1.0, 1.0, L * C).reshape(1, L, C)
    wbase = torch.linspace(-1.0, 1.0, K * C * C).reshape(K, C, C)
    for path in paths:
        key = " -> ".join(path)
        # wired as quantize_params wires it: each interior site requantizes
        # onto its consumer's x_scale, the tail dequantizes
        scales = {s: torch.tensor(0.05 * (i + 1)) for i, s in enumerate(path)}
        weights = [qconv.quantize_weight(
            wbase, x_scale=scales[s],
            out_scale=scales[path[i + 1]] if i + 1 < len(path) else None)
            for i, s in enumerate(path)]
        with calibrate.counting_dequants() as deq:
            y = x
            for site, qw in zip(path, weights):
                y = layers.conv1d_bias_act(y, qw, None, padding="SAME",
                                           backend="sliding",
                                           precision="w8a8", site=site)
        if deq != [path[-1]]:
            violations.append(Violation(
                "chain_dequant", "chains", key,
                f"expected exactly one dequant at the tail [{path[-1]!r}], "
                f"counted {deq!r}: an interior site makes float32 inside "
                f"the int8 chain"))
    return violations, {"chains": [" -> ".join(p) for p in paths]}


def check_all(*, alpha: float | None = None) -> tuple[list[Violation], dict]:
    """Both passes: the α-rule and the dequant chains."""
    v1, s1 = check_bloat(alpha=alpha)
    v2, s2 = check_chains()
    return v1 + v2, {**s1, **s2,
                     "alpha": BLOAT_ALPHA if alpha is None else alpha}
