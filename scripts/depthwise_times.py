"""Card times of the depthwise convs alone, for one tree of this
repository: the float conv (row 3) at mamba's prefill shape in
jamba-1.5-large ((4, 259, 16384) bf16, bias + silu) and at its training
shape ((2, 515, 16384), silu, z written and not), the int8 conv (row 15)
at the prefill shape in w8a8 with a bf16 output, w8a8 requantized to int8
and w8a16 on bf16 x with a bf16 output, and the weight gradient (row 11)
at the training shape in bf16 and f32 with db:

    python3 scripts/depthwise_times.py [tree] [3] [15] [11] [3_plans] [11_plans]

(tree: a directory holding a checkout of this repository, by default this
one; the rows to time, by default 3, 15 and 11), so that two trees time
in turns in one call on one card:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 scripts/depthwise_times.py $r; done

``3_plans`` times row 3 at the prefill shape with its plan's rows and
stages and with each forced to its neighbours (rows 8, 16, 32, 64;
stages 2, 3, 4), then with the plan's and each other activation (none,
relu, gelu: what the epilogue's silu costs), on a tree whose rows 3 and
15 take their plan from ``gemm_plan.depthwise_plan``. ``11_plans`` times
row 11 in bf16 at the training shape with its plan and with the rows (16,
32), stages (2, 3) and split (half and twice the plan's) forced, on a
tree whose row 11 takes its plan from ``gemm_plan.depthwise_dw_plan``.

Imports the kernels, their wrappers and ``chip_smoke``'s input makers,
shapes and timer from the tree (its depthwise kernels built there, into its
``build/kernels``).
Each kernel is first held to its plain version at phase 16's and 20's
tolerances (``chip_smoke.dw_check``, ``check_dw_quant``; row 11 within
TOL of its largest value). Row 11 also prints a SHA-256 of its dw and db
at the training shape from seeded inputs, so that two trees' sums can be
compared bit for bit. Card time per call from CUDA events, queue filled,
inputs cycled past the L2 (``chip_smoke.card_ms``), beside the plain
version, one library call and the bound. Prints a line a shape and, last,
``TIMES <tree> {json}``. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

ROWS = ("3", "15", "11", "3_plans", "11_plans")
ARGS = sys.argv[1:]
ROOT = ARGS.pop(0) if ARGS and ARGS[0] not in ROWS else "."
for p in (ROOT, ROOT + "/src"):
    sys.path.insert(0, p)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import sliding_conv1d as sc  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402
from repro_torch.kernels.timing import card_ms  # noqa: E402


def row3_sets(s, n):
    """``n`` seeded input sets of shape ``s`` (> 50 MB in all), each with
    the library's layouts, x (B, C, L) and w (C, 1, K), made ahead."""
    sets = []
    for i in range(n):
        x, w, b = cs.depthwise_inputs(50 + i, s["B"], s["L"], s["C"],
                                      s["K"], torch.bfloat16)
        sets.append((x, w, b, x.transpose(1, 2).contiguous(),
                     w.t().contiguous()[:, None, :]))
    return sets


def row3(s, z: bool) -> dict:
    """Row 3 at shape ``s``, bf16, bias + silu, z written or not, beside
    its plain version, ``F.conv1d(groups=C)`` + silu and the bound."""
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    lout = L - K + 1
    sets = row3_sets(s, 4 if B * L * C * 2 < 50e6 else 2)
    args = dict(activation="silu", save_preact=z)

    def library(x, w, b, x_lib, w_lib):
        return F.silu(F.conv1d(x_lib, w_lib, b.to(x_lib.dtype), groups=C))

    x, w, b = sets[0][:3]
    got, want = sc.conv1d_depthwise(x, w, b, **args), \
        sc.conv1d_depthwise_plain(x, w, b, **args)
    if z:
        err = max(cs.dw_check(got[0], want[0], f"depthwise {s} y"),
                  cs.dw_check(got[1], want[1], f"depthwise {s} z"))
    else:
        err = cs.dw_check(got, want, f"depthwise {s}")
    nbytes = 2 * (B * L * C + K * C + (2 if z else 1) * B * lout * C) + 4 * C
    bms, by = cs.bound_ms(nbytes, 2 * K * B * lout * C, torch.bfloat16)
    t = {key: card_ms(cs.cycling(fn, sets)) for key, fn in (
        ("ms", lambda x, w, b, *_: sc.conv1d_depthwise(x, w, b, **args)),
        ("plain_ms", lambda x, w, b, *_: sc.conv1d_depthwise_plain(
            x, w, b, **args)),
        ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                plan=plan_of(s, 2))


def plan_of(s, elem) -> str | None:
    """The tree's plan at shape ``s`` (None where it has none)."""
    if not hasattr(gemm_plan, "depthwise_plan"):
        return None
    return repr(gemm_plan.depthwise_plan(
        s["B"], s["L"] - s["K"] + 1, s["C"], elem, s["K"], 1,
        build.sm_count(torch.device(cs.DEV))))


def row15(s, mode, requant) -> dict:
    """Row 15 at shape ``s``: w8a8 (bf16 out, or requantized to int8) or
    w8a16 on bf16 x (bf16 out), silu; beside its plain version, the codes
    widened ahead through ``F.conv1d(groups=C)`` + the epilogue in torch,
    and the bound."""
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    lout = L - K + 1
    xdt = torch.bfloat16
    sets = []
    for i in range(6 if mode == "w8a8" else 3):  # > 50 MB in all
        x, w, ws, b, xs = cs.dw_quant_inputs(60 + i, B, L, C, K, mode, xdt)
        s_lib = (ws * xs if xs is not None else ws).reshape(C, 1)
        sets.append((x, w, ws, b, xs, x.transpose(1, 2).to(xdt).contiguous(),
                     w.t().to(xdt).contiguous()[:, None, :], s_lib))
    x, w, ws, b, xs = sets[0][:5]
    err = cs.check_dw_quant(sq, x, w, ws, b, xs, mode=mode, stride=1,
                            act="silu", out_dtype=torch.bfloat16,
                            requant=requant,
                            what=f"int8 depthwise {s} {mode}")
    y = sq.conv1d_depthwise_quant_plain(x, w, ws, b, x_scale=xs, mode=mode,
                                        activation="silu")
    os_ = (y.abs().max() * 0.8 / 127).reshape(()) if requant else None
    odt = torch.bfloat16

    def kernel(x, w, ws, b, xs, *_):
        return sq.conv1d_depthwise_quant(x, w, ws, b, x_scale=xs, mode=mode,
                                         out_scale=os_, activation="silu",
                                         out_dtype=odt)

    def plain(x, w, ws, b, xs, *_):
        return sq.conv1d_depthwise_quant_plain(
            x, w, ws, b, x_scale=xs, mode=mode, out_scale=os_,
            activation="silu", out_dtype=odt)

    def library(x, w, ws, b, xs, x_lib, w_lib, s_lib):
        acc = F.conv1d(x_lib, w_lib, groups=C)
        v = F.silu(acc.float() * s_lib + b[:, None])
        if os_ is not None:
            return torch.clamp(torch.round(v / os_), -127, 127).to(torch.int8)
        return v.to(odt)

    x_bytes = x.element_size() * B * L * C
    y_bytes = (1 if requant else 2) * B * lout * C
    nbytes = x_bytes + K * C + 4 * C + 4 * C + y_bytes
    ops = 2 * K * B * lout * C
    bms, by = cs.bound_ms(nbytes, ops, torch.int8 if mode == "w8a8"
                          else torch.bfloat16)
    t = {key: card_ms(cs.cycling(fn, sets)) for key, fn in (
        ("ms", kernel), ("plain_ms", plain), ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                plan=plan_of(s, x.element_size()))


def row11_sets(s, dtype):
    """Seeded (x, dz) sets at shape ``s`` (> 50 MB in all), each with the
    library's layouts, (B, C, L), made ahead."""
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    sets = []
    for i in range(2):  # 2 inputs of 67 MB (bf16) or 135 MB (f32)
        x, dz = cs.dw_inputs(83 + i, B, L, C, C, K, 1, dtype)
        sets.append((x, dz, x.transpose(1, 2).contiguous(),
                     dz.transpose(1, 2).contiguous()))
    return sets


def row11(s, dtype) -> dict:
    """Row 11 at the training shape in ``dtype`` with db, beside its plain
    version, ``torch.nn.grad.conv1d_weight(groups=C)`` and the bound; the
    SHA-256 of dw and db from seed 80's inputs."""
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    lout = L - K + 1
    sets = row11_sets(s, dtype)
    x, dz = cs.dw_inputs(80, B, L, C, C, K, 1, dtype)
    dw, db = sb.conv1d_depthwise_bwd_dw(x, dz, K, has_bias=True)
    want = sb.conv1d_depthwise_bwd_dw_plain(x, dz, K, has_bias=True)
    err = max(cs.close(dw, want[0], cs.TOL, "depthwise dw", scaled=True),
              cs.close(db, want[1], cs.TOL, "depthwise db", scaled=True))
    digest = hashlib.sha256(dw.cpu().numpy().tobytes()
                            + db.cpu().numpy().tobytes()).hexdigest()
    del x, dz, dw, db, want

    def library(x, dz, x_lib, dz_lib):
        return torch.nn.grad.conv1d_weight(x_lib, (C, 1, K), dz_lib, groups=C)

    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = el * (B * L * C + B * lout * C) + 4 * (K * C + C)
    bms, by = cs.bound_ms(nbytes, 2 * K * B * lout * C + B * lout * C, dtype)
    t = {key: card_ms(cs.cycling(fn, sets)) for key, fn in (
        ("ms", lambda x, dz, *_: sb.conv1d_depthwise_bwd_dw(
            x, dz, K, has_bias=True)),
        ("plain_ms", lambda x, dz, *_: sb.conv1d_depthwise_bwd_dw_plain(
            x, dz, K, has_bias=True)),
        ("library_ms", library))}
    plan = None
    if hasattr(gemm_plan, "depthwise_dw_plan"):
        plan = repr(gemm_plan.depthwise_dw_plan(
            B, lout, C, el, K, 1, build.sm_count(torch.device(cs.DEV))))
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                sha256=digest, plan=plan)


def row11_plans(s) -> dict:
    """Row 11 at shape ``s`` (bf16, db) with its plan, then with the rows
    (16, 32), stages (2, 3) and split (half and twice the plan's) forced;
    each held to the plain version first; ms by variant."""
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    lout = L - K + 1
    real = gemm_plan.depthwise_dw_plan
    plan = real(B, lout, C, 2, K, 1, build.sm_count(torch.device(cs.DEV)))
    sets = row11_sets(s, torch.bfloat16)
    out = {"plan": repr(plan)}
    try:
        for force in ({}, dict(rows=16), dict(rows=32), dict(stages=2),
                      dict(stages=3), dict(splits=max(1, plan.splits // 2)),
                      dict(splits=2 * plan.splits)):
            key = "_".join(f"{k}_{v}" for k, v in force.items()) or "plan"

            def forced(*a, force=force, **k):
                return real(*a, **{**k, **force})

            gemm_plan.depthwise_dw_plan = forced
            x, dz = sets[0][:2]
            got = sb.conv1d_depthwise_bwd_dw(x, dz, K, has_bias=True)
            want = sb.conv1d_depthwise_bwd_dw_plain(x, dz, K, has_bias=True)
            cs.close(got[0], want[0], cs.TOL, f"dw {key}", scaled=True)
            cs.close(got[1], want[1], cs.TOL, f"db {key}", scaled=True)
            out[key] = card_ms(cs.cycling(
                lambda x, dz, *_: sb.conv1d_depthwise_bwd_dw(
                    x, dz, K, has_bias=True), sets))
    finally:
        gemm_plan.depthwise_dw_plan = real
    return out


def row3_plans(s) -> dict:
    """Row 3 at shape ``s`` (bf16, bias + silu) with the plan's rows and
    stages, then each forced to its neighbours, then with the plan and the
    other activations; each held to the plain version first; ms by
    variant."""
    real = gemm_plan.depthwise_plan
    sets = row3_sets(s, 4)
    out = {"plan": plan_of(s, 2)}
    try:
        for rows, stages, act in (
                (None, None, "silu"), (8, None, "silu"), (16, None, "silu"),
                (32, None, "silu"), (64, None, "silu"), (None, 2, "silu"),
                (None, 3, "silu"), (None, 4, "silu"), (None, None, "none"),
                (None, None, "relu"), (None, None, "gelu")):
            key = f"rows_{rows}_stages_{stages}_{act}"

            def forced(*a, rows=rows, stages=stages, **k):
                return real(*a, rows=rows, stages=stages, **k)

            gemm_plan.depthwise_plan = forced
            x, w, b = sets[0][:3]
            cs.dw_check(sc.conv1d_depthwise(x, w, b, activation=act),
                        sc.conv1d_depthwise_plain(x, w, b, activation=act),
                        f"depthwise {s} {key}")
            out[key] = card_ms(cs.cycling(
                lambda x, w, b, *_, act=act: sc.conv1d_depthwise(
                    x, w, b, activation=act), sets))
    finally:
        gemm_plan.depthwise_plan = real
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("depthwise_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    libs = ("conv1d_depthwise", "conv1d_depthwise_quant",
            "conv1d_depthwise_bwd")
    every = build.sources
    build.sources = lambda: {n: src for n, src in every().items()
                             if n in libs}  # build the depthwise ones only
    build.build_all()
    rows = ARGS or ["3", "15", "11"]
    for lib in libs:
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    out = {"device": smi}

    def record(key, shape, r):
        out.setdefault(key, {})[shape] = r
        print(f"{key} {shape}: {json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()

    serve, train = cs.DEPTHWISE_MAIN, cs.DEPTHWISE_TRAIN
    if "3" in rows:
        record("conv1d_depthwise", "serve", row3(serve, False))
        record("conv1d_depthwise", "train_no_z", row3(train, False))
        record("conv1d_depthwise", "train_z", row3(train, True))
    if "15" in rows:
        record("conv1d_depthwise_quant", "w8a8_bf16", row15(serve, "w8a8",
                                                            False))
        record("conv1d_depthwise_quant", "w8a8_requant",
               row15(serve, "w8a8", True))
        record("conv1d_depthwise_quant", "w8a16_bf16",
               row15(serve, "w8a16", False))
    if "11" in rows:
        record("conv1d_depthwise_bwd_dw", "train", row11(train,
                                                         torch.bfloat16))
        record("conv1d_depthwise_bwd_dw", "train_f32",
               row11(train, torch.float32))
    if "11_plans" in rows:
        if hasattr(gemm_plan, "depthwise_dw_plan"):
            record("conv1d_depthwise_bwd_dw_plans", "train",
                   row11_plans(train))
        else:
            print("row 11 takes no plan from gemm_plan in this tree: no "
                  "plan probe", flush=True)
    if "3_plans" in rows:
        if hasattr(gemm_plan, "depthwise_plan"):
            record("conv1d_depthwise_plans", "serve", row3_plans(serve))
        else:
            print("rows 3 and 15 take no plan from gemm_plan in this tree: "
                  "no plan probe", flush=True)
    print(f"TIMES {ROOT} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
