"""Convention lint: an AST pass over ``src/repro_torch`` for its frozen
registries (counterpart of ``repro.analysis.lint``).

Each rule is backed by a registry that already exists at run time; the
lint moves the failure from the first hit in production to the check:

  * **lint_reason**: the ``reason`` of ``HEALTH.record`` is a member of the
    frozen ``health.Reason`` vocabulary where written as a literal, and
    never an f-string (non-literal reasons are checked at run time).
  * **lint_site**: a literal ``site=`` (and ``HEALTH.record``'s site) names
    a site the system knows: a dispatch-ladder site, a calibration site of
    ``quant.apply`` (``CHAINS`` / ``SITE_FOR_KEY``), a static subsystem
    site, or the shape-derived ``calibrate.conv_site`` pattern.
  * **lint_obs_name**: literal metric names at ``.counter(`` / ``.gauge(``
    / ``.histogram(`` / ``.facts(`` come from ``obs.names.METRICS``, span
    names at ``span`` / ``instant`` / ``traced`` from ``obs.names.SPANS``,
    and neither is an f-string.
  * **lint_ladder_key**: every ``_ladder(...)`` call passes ``key=``, the
    dispatch key by which the runtime catch layer maps a kernel's failure
    back to its (site, rung).
  * **lint_walltime**: no ``time.time()`` (nor ``from time import time``)
    in the package: durations use the monotonic ``time.perf_counter()``;
    the few wall-clock timestamps are allowed per file
    (``WALLCLOCK_ALLOWED``).

The reference's rule against raw ``pl.load`` / ``pl.store`` indexing has
no counterpart: the port's kernels are CUDA sources, whose launches the
contract checker declares instead.
"""
from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analysis.contracts import Violation
from repro_torch.health import Reason
from repro_torch.obs import names as obs_names

#: subsystem sites with no registry of their own
STATIC_SITES = {
    "autotune", "ckpt", "serve/generate", "serve/decode", "serve/slot",
    "serve/admission", "train",
}

#: the dispatch ladder's sites (``ops._ladder`` callers); faults match
#: sites hierarchically, so the bare family names are valid too
DISPATCH_SITES = {
    "conv1d", "conv2d", "conv1d_depthwise", "attention_decode", "pool1d",
    "conv1d.w8a8", "conv1d.w8a16",
    "conv2d.w8a8", "conv2d.w8a16",
    "conv1d_depthwise.w8a8", "conv1d_depthwise.w8a16",
}

#: shape-derived default sites (``calibrate.conv_site``)
CONV_SITE_RE = re.compile(r"^[a-z0-9_]+\|Cin\d+\|Cout\d+\|K[\dx]+$")

_REASON_VALUES = {r.value for r in Reason}
_METRIC_METHODS = {"counter", "gauge", "histogram", "facts"}
_SPAN_FUNCS = {"span", "instant", "traced"}

#: files (package-relative, posix) allowed to call ``time.time()``: they
#: write timestamps (points in calendar time compared across processes or
#: shown to operators), not durations
WALLCLOCK_ALLOWED: dict[str, str] = {
    "repro_torch/distributed/ft.py":
        "heartbeat files carry wall-clock timestamps whose staleness is "
        "compared across processes",
    "repro_torch/checkpoint/manager.py":
        "the checkpoint manifest records an operator-facing save timestamp",
}


def known_sites() -> set[str]:
    """Every literal site the system knows: static, dispatch and
    calibration sites."""
    from repro_torch.quant import apply as qapply

    return (STATIC_SITES | DISPATCH_SITES | set(qapply.CHAINS)
            | set(qapply.CHAINS.values()) | set(qapply.SITE_FOR_KEY.values()))


def _is_health_record(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "record"
            and ((isinstance(f.value, ast.Name) and f.value.id == "HEALTH")
                 or (isinstance(f.value, ast.Attribute)
                     and f.value.attr == "HEALTH")))


def _str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _walltime_allowed(rel: str) -> bool:
    posix = rel.replace("\\", "/")
    return any(posix.endswith(k) for k in WALLCLOCK_ALLOWED)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, *, sites: set[str],
                 walltime_ok: bool = False):
        self.rel, self.sites, self.walltime_ok = rel, sites, walltime_ok
        self.violations: list[Violation] = []

    def _flag(self, kind: str, node: ast.AST, detail: str) -> None:
        self.violations.append(Violation(kind, "lint",
                                         f"{self.rel}:{node.lineno}", detail))

    def _check_site_literal(self, node: ast.AST, site: str) -> None:
        if site in self.sites or CONV_SITE_RE.match(site):
            return
        self._flag("lint_site", node,
                   f"site {site!r} is not in the site registry (dispatch "
                   f"sites, quant.apply calibration sites, static subsystem "
                   f"sites, or the calibrate.conv_site pattern): a typo'd "
                   f"site forks the health and calibration namespace")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if (not self.walltime_ok and node.module == "time"
                and any(a.name == "time" for a in node.names)):
            self._flag("lint_walltime", node,
                       "`from time import time` hides the wall-clock call "
                       "from the lint: import the module and use "
                       "time.perf_counter() for durations")
        self.generic_visit(node)

    def visit_Call(self, call: ast.Call) -> None:
        self._lint_record(call)
        self._lint_obs_name(call)
        self._lint_walltime(call)
        self._lint_ladder_key(call)
        for kw in call.keywords:
            if kw.arg == "site":
                s = _str_const(kw.value)
                if s is not None:
                    self._check_site_literal(kw.value, s)
        self.generic_visit(call)

    def _lint_walltime(self, call: ast.Call) -> None:
        f = call.func
        if (not self.walltime_ok and isinstance(f, ast.Attribute)
                and f.attr == "time" and isinstance(f.value, ast.Name)
                and f.value.id == "time"):
            self._flag("lint_walltime", call,
                       "time.time() in the package: durations use the "
                       "monotonic time.perf_counter() (the wall clock jumps "
                       "under NTP slew); a genuine timestamp belongs in "
                       "lint.WALLCLOCK_ALLOWED with a reason")

    def _lint_ladder_key(self, call: ast.Call) -> None:
        f = call.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if name == "_ladder" and not any(kw.arg == "key"
                                         for kw in call.keywords):
            self._flag("lint_ladder_key", call,
                       "_ladder(...) without key=: the dispatch key maps a "
                       "kernel's failure back to its (site, rung); without "
                       "it the family opts out of runtime demotion")

    def _lint_obs_name(self, call: ast.Call) -> None:
        f = call.func
        vocab = kind = None
        if isinstance(f, ast.Attribute) and f.attr in _METRIC_METHODS:
            vocab, kind = obs_names.METRICS, "metric"
        elif ((isinstance(f, ast.Name) and f.id in _SPAN_FUNCS)
              or (isinstance(f, ast.Attribute) and f.attr in _SPAN_FUNCS)):
            vocab, kind = obs_names.SPANS, "span"
        if vocab is None or not call.args:
            return
        node = call.args[0]
        if isinstance(node, ast.JoinedStr):
            self._flag("lint_obs_name", node,
                       f"f-string {kind} name: dynamic names fork the "
                       f"telemetry namespace; use a name from obs.names and "
                       f"put the dynamic part in a label")
            return
        s = _str_const(node)
        if s is not None and s not in vocab:
            self._flag("lint_obs_name", node,
                       f"{kind} name {s!r} is not in the frozen obs.names "
                       f"vocabulary (the registry rejects it at run time "
                       f"too)")

    def _lint_record(self, call: ast.Call) -> None:
        if not _is_health_record(call):
            return
        site_node = call.args[0] if call.args else None
        reason_node = call.args[1] if len(call.args) > 1 else None
        for kw in call.keywords:
            if kw.arg == "site":
                site_node = kw.value
            elif kw.arg == "reason":
                reason_node = kw.value
        if site_node is not None and _str_const(site_node) is not None:
            self._check_site_literal(site_node, _str_const(site_node))
        if reason_node is None:
            return
        if isinstance(reason_node, ast.JoinedStr):
            self._flag("lint_reason", reason_node,
                       "f-string reason at HEALTH.record: open-ended reasons "
                       "defeat the frozen health.Reason vocabulary; keep the "
                       "dynamic part in detail=")
            return
        r = _str_const(reason_node)
        if r is not None and r not in _REASON_VALUES:
            self._flag("lint_reason", reason_node,
                       f"reason {r!r} is not in the frozen health.Reason "
                       f"vocabulary")


def lint_file(path: pathlib.Path, *, rel: str | None = None,
              sites: set[str] | None = None) -> list[Violation]:
    rel = rel or str(path)
    sites = known_sites() if sites is None else sites
    try:
        tree = ast.parse(path.read_text(), filename=rel)
    except SyntaxError as e:
        return [Violation("lint_syntax", "lint", rel, str(e))]
    linter = _Linter(rel, sites=sites, walltime_ok=_walltime_allowed(rel))
    linter.visit(tree)
    return linter.violations


def check_all(root: str | None = None) -> tuple[list[Violation], dict]:
    """Lint every ``.py`` under ``root`` (default: the ``repro_torch``
    package)."""
    base = (pathlib.Path(__file__).resolve().parent.parent if root is None
            else pathlib.Path(root))
    sites = known_sites()
    violations: list[Violation] = []
    n = 0
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        n += 1
        violations.extend(lint_file(
            path, rel=str(path.relative_to(base.parent)), sites=sites))
    return violations, {"files": n, "sites": len(sites)}
