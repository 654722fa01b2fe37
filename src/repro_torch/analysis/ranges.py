"""Interval proofs over the port's int8 chains (counterpart of
``repro.analysis.ranges``).

The int8 path moves values through three regimes, int8 codes, an integer
accumulator and the float32 dequant / requant epilogue, and each has a
silent failure this pass checks:

  * **acc_overflow**: an int8×int8 sum of products of magnitude ≤ 127²
    over ``taps × Cin`` terms; ``127² · taps · Cin`` must stay inside
    int32. Checked for every shipped chain stage and every int8×int8
    launch of the contract key space (rows 13, 14 and 15), each split's
    int32 partial and the second pass's sum of them included.
  * **requant_clip**: a chained producer requantizes onto its consumer's
    grid, ``q = clip(round(y / out_scale), -127, 127)``; an ``out_scale``
    below the consumer's ``x_scale`` pushes calibrated values past ±127.
  * **scale_fold**: the int8 KV read (row 2b) folds the scale out of the
    dot products, ``(q·k_q)·s_k``, which holds only for a scale constant
    along head_dim, as ``models.common.kv_scale_defs`` lays it out.

A zero or non-finite scale is **unreachable**, never safe: ``quant.apply``
screens scales (``scale_reason``) and ``ops._guard_quant_scales`` falls the
call back to float or raises, so no int8 claim is made, and none proved.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable

from repro_torch.analysis.contracts import (
    FAMILIES,
    Violation,
    default_space,
)
from repro_torch.kernels import gemm_plan

INT32_MAX = 2 ** 31 - 1
CODE_MAX = 127  # the quantizers clip to ±127

#: sum length (taps × contracted channels) from which the int32 bound
#: 127²·n overflows: 127² · 133145 > 2³¹ − 1
OVERFLOW_REDUCE_LEN = INT32_MAX // (CODE_MAX * CODE_MAX) + 1

#: tolerated relative mismatch of out_scale and the consumer's grid
SCALE_RTOL = 1e-4


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed real interval: the abstract value domain."""

    lo: float
    hi: float

    @classmethod
    def codes(cls) -> "Interval":
        return cls(-CODE_MAX, CODE_MAX)

    @classmethod
    def for_scale(cls, scale: float) -> "Interval":
        """The dequantized interval a calibration scale claims, [-127·s,
        127·s]: the observed range under absmax calibration; under
        percentile calibration the values past the percentile saturate to
        its ends (intended clipping)."""
        return cls(-CODE_MAX * scale, CODE_MAX * scale)

    def scaled(self, s: float) -> "Interval":
        lo, hi = self.lo * s, self.hi * s
        return Interval(min(lo, hi), max(lo, hi))

    def contains(self, other: "Interval") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def width(self) -> float:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class Stage:
    """One int8×int8 sum and its epilogue: ``taps`` the filter's footprint
    (K, kh·kw, 1 for a product), ``cin`` the contracted channels (1 for a
    depthwise conv), ``pools`` the max pools its codes pass through on the
    way to the chain's consumer (monotone and on one grid: the code
    interval passes unchanged)."""

    site: str
    taps: int
    cin: int
    pools: tuple[int, ...] = ()

    def reduce_len(self) -> int:
        return self.taps * self.cin

    def acc_bound(self) -> int:
        return CODE_MAX * CODE_MAX * self.reduce_len()


#: the shipped chain sites' geometry, from the model code the sites live
#: in (models/whisper.py's frontend, examples/edge_cnn_torch.py,
#: models/llava.py's patch embedding and the projector); a chain site
#: missing here fails check_all
SITE_GEOM: dict[str, Stage] = {
    "whisper/conv1": Stage("whisper/conv1", taps=3, cin=80),
    "whisper/conv2": Stage("whisper/conv2", taps=3, cin=1024),
    "edge/c1": Stage("edge/c1", taps=25, cin=1, pools=(2,)),
    "edge/c2": Stage("edge/c2", taps=9, cin=16, pools=(2,)),
    "edge/c3": Stage("edge/c3", taps=9, cin=32),
    "llava/patch_embed": Stage("llava/patch_embed", taps=196, cin=3),
    "llava/projector": Stage("llava/projector", taps=1, cin=1152),
}


def shipped_chains() -> list[tuple[str, ...]]:
    """The requant chains as site paths, from ``quant.apply.CHAINS``
    (producer -> consumer): heads are producers no site feeds."""
    from repro_torch.quant.apply import CHAINS

    heads = [s for s in CHAINS if s not in set(CHAINS.values())]
    paths = []
    for head in sorted(heads):
        path = [head]
        while path[-1] in CHAINS:
            path.append(CHAINS[path[-1]])
        paths.append(tuple(path))
    return paths


def check_stage(stage: Stage) -> list[Violation]:
    """The accumulator proof of one int8×int8 stage."""
    bound = stage.acc_bound()
    if bound > INT32_MAX:
        return [Violation(
            "acc_overflow", "ranges", stage.site,
            f"int8×int8 accumulator bound 127²·{stage.taps}·{stage.cin} = "
            f"{bound} exceeds int32 max {INT32_MAX} (reduce_len "
            f"{stage.reduce_len()} >= {OVERFLOW_REDUCE_LEN})")]
    return []


def check_requant(site: str, out_scale: float,
                  consumer_scale: float) -> list[Violation]:
    """The requant proof with concrete scales: the consumer's calibrated
    interval ``[-127·s, 127·s]`` over ``out_scale`` lands inside the
    code range."""
    code_hi = CODE_MAX * consumer_scale / out_scale
    if code_hi > CODE_MAX * (1.0 + SCALE_RTOL):
        return [Violation(
            "requant_clip", "ranges", site,
            f"requant maps the consumer's calibrated interval to codes "
            f"±{code_hi:.1f} (out_scale {out_scale:.3g} < consumer grid "
            f"{consumer_scale:.3g}): calibrated values saturate")]
    return []


def check_kv_fold(scale_shape: tuple[int, ...] | None = None, *,
                  head_dim: int = 8) -> list[Violation]:
    """The fold proof of the int8 KV read: the scale paired with a
    (…, kv_seq, kv_heads, head_dim) cache leaf must be constant along
    head_dim. Default: the layout of ``models.common.kv_scale_defs``."""
    if scale_shape is None:
        from repro_torch.models.common import ParamDef, kv_scale_defs

        kv = ParamDef((1, 2, 4, 2, head_dim),
                      ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                      init="zeros", dtype="int8")
        scale_shape = kv_scale_defs({"k": kv})["k_scale"].shape
    if scale_shape[-1] != 1:
        return [Violation(
            "scale_fold", "ranges", "kv_cache",
            f"KV scale granularity {tuple(scale_shape)} varies along the "
            f"contracted head_dim axis (last dim {scale_shape[-1]} != 1): "
            f"folding the scale out of the decode dot ((q·k_q)·s_k) holds "
            f"only for a scale constant over the sum")]
    return []


def _scale_reason(s) -> str | None:
    from repro_torch.quant.apply import scale_reason

    return scale_reason(s)


def _quant_space_stages(quick: bool = False) -> Iterable[Stage]:
    """Every int8×int8 launch of the contract key space as a stage (rows
    13, 14, 15), and each split's int32 partial of it."""
    seen = set()
    for family, shape, cand in default_space(quick=quick):
        if shape.get("precision") != "w8a8":
            continue
        if family == "conv1d":
            taps, cin = shape["K"], shape["Cin"]
        elif family == "conv2d":
            taps, cin = shape["kh"] * shape["kw"], shape["Cin"]
        elif family == "conv1d_depthwise":
            taps, cin = shape["K"], 1
        else:
            continue
        inst = FAMILIES[family](**shape, **cand)
        part = 0
        if inst.splits > 1:
            # a split walks `per` of the int8 tile's chunks of the sum
            bk = gemm_plan.TILES["int8"].bk
            chunks = -(-taps * cin // bk)
            part = min(taps * cin, -(-chunks // inst.splits) * bk)
        key = (family, taps, cin, part)
        if key in seen:
            continue
        seen.add(key)
        yield Stage(f"{family}|taps{taps}|Cin{cin}", taps=taps, cin=cin)
        if part:
            yield Stage(f"{family}|taps{taps}|Cin{cin}|split", taps=1,
                        cin=part)


def check_chain(path: tuple[str, ...],
                spec: dict[str, dict[str, Any]] | None = None
                ) -> tuple[str, list[Violation], dict[str, Any]]:
    """Prove one requant chain: (status, violations, detail). Status is
    ``"safe"``, ``"unreachable"`` (a zero or non-finite scale in ``spec``:
    the guards serve the chain in float) or ``"violated"``. Without a
    ``spec`` the requant edges hold by construction
    (``calibrate.Calibration.spec`` sets ``out_scale`` to the consumer's
    ``x_scale``); with one, they are checked numerically."""
    violations: list[Violation] = []
    acc_bits = 0.0
    for site in path:
        stage = SITE_GEOM.get(site)
        if stage is None:
            violations.append(Violation(
                "acc_overflow", "ranges", site,
                "chain site has no geometry in ranges.SITE_GEOM: the "
                "accumulator cannot be bounded; register the stage"))
            continue
        violations.extend(check_stage(stage))
        acc_bits = max(acc_bits, math.log2(stage.acc_bound()))
    mode = "symbolic"
    if spec is not None:
        mode = "concrete"
        for prod, cons in zip(path, path[1:]):
            out_scale = (spec.get(prod) or {}).get("out_scale")
            cons_scale = (spec.get(cons) or {}).get("x_scale")
            for s in (out_scale, cons_scale):
                reason = _scale_reason(s)
                if reason:
                    return "unreachable", [], {"mode": mode,
                                               "edge": f"{prod}->{cons}",
                                               "reason": reason}
            if out_scale is None or cons_scale is None:
                continue  # an uncalibrated edge dequantizes: no requant
            violations.extend(check_requant(prod, float(out_scale),
                                            float(cons_scale)))
    detail = {
        "mode": mode, "acc_bits": round(acc_bits, 1),
        "headroom_bits": round(31 - acc_bits, 1),
        "pools": {s: list(SITE_GEOM[s].pools) for s in path
                  if s in SITE_GEOM and SITE_GEOM[s].pools},
    }
    return ("violated" if violations else "safe"), violations, detail


def check_all(*, spec: dict[str, dict[str, Any]] | None = None,
              quick: bool = False) -> tuple[list[Violation], dict[str, Any]]:
    """Prove every shipped chain, every int8×int8 launch of the contract
    key space and the KV fold: (violations, stats)."""
    violations: list[Violation] = []
    chains: dict[str, Any] = {}
    for path in shipped_chains():
        status, v, detail = check_chain(path, spec)
        violations.extend(v)
        chains["->".join(path)] = {"status": status, **detail}
    n = worst = 0
    for stage in _quant_space_stages(quick=quick):
        n += 1
        violations.extend(check_stage(stage))
        worst = max(worst, stage.acc_bound())
    violations.extend(check_kv_fold())
    return violations, {
        "chains": chains, "kernel_stages": n,
        "acc_bits_max": round(math.log2(worst), 1) if worst else 0.0,
        "overflow_reduce_len": OVERFLOW_REDUCE_LEN,
    }
