"""Card times of the 1-D convs on ``csrc/gemm_mma.cuh``'s loop, alone: the
sliding conv (row 1) at whisper's frontend in float32 and in bfloat16, the
fused 1-D im2col conv (row 6) at ``chip_smoke.py`` phase 35's 1-D shapes
beside row 1 on the same inputs, the int8 conv (row 13, w8a8) at phase
15's shapes and the weight gradient (row 10) at phase 10's in float32 and
bfloat16, for one tree of this repository:

    python3 scripts/conv1d_times.py [tree] [1] [6] [13] [10] [10_splits] \
        [13_probe]

(tree: a directory holding a checkout of this repository, by default this
one; the rows to time, by default 1, 6, 13 and 10), so that two trees time
in turns in one call on one card:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 scripts/conv1d_times.py $r; done

``10_splits`` times row 10 in float32 and bfloat16 at both shapes with its
plan's split and with the split forced to 1, 2, 3 and 4
(``gemm_plan.gemm_plan`` patched, as the card tests' ``forced_splits``
fixture does), on a tree whose row 10 takes its plan from ``gemm_plan``.
``13_probe`` times row 13 the same way (splits forced to 1, 2 and 4),
then without its activation and with its other output type, on a tree
whose row 13 takes its plan from ``gemm_plan``.

Imports the kernels, their wrappers and ``chip_smoke``'s input makers,
shapes and timer from the tree (built there, into its ``build/kernels``).
Row 1 as phase 6 times it: bias + gelu, beside its plain version,
``F.conv1d`` + gelu in the same type (cuDNN, TF32 off) and the bound.
Row 6 as phase 35 times it (no epilogue), beside row 1 (``sliding_ms``),
``F.conv1d`` and the bound. Row 13 as phase 15 times it (gelu; conv1
requantized to int8, conv2 float32 out) beside ``torch._int_mm`` on the
input unfolded ahead + the epilogue; row 10 as phase 10 times it (with
db) beside ``torch.nn.grad.conv1d_weight`` in the same type. Each kernel
is first held to its plain version (float32 within TOL, bfloat16 within
BTOL; row 13's float output within TIGHT, its codes one apart at most;
row 10 within TOL of its largest value). Card time per call from CUDA
events, queue filled, inputs cycled past the L2 (``chip_smoke.card_ms``).
Prints a line a shape and, last, ``TIMES <tree> {json}``. Needs one card
and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys

ROWS = ("1", "6", "13", "10", "10_splits", "13_probe")
ARGS = sys.argv[1:]
ROOT = ARGS.pop(0) if ARGS and ARGS[0] not in ROWS else "."
for p in (ROOT, ROOT + "/src"):
    sys.path.insert(0, p)

import contextlib  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import im2col_gemm as ig  # noqa: E402
from repro_torch.kernels import sliding_conv1d as sc  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402
from repro_torch.kernels.timing import card_ms  # noqa: E402


def row1(name, s, dtype) -> dict:
    """Row 1 at one of ``CONV_MAIN``'s shapes, bias + gelu."""
    args = dict(stride=s["stride"], activation="gelu")
    n_sets = 8 if s["Cin"] < 512 else 4  # > 50 MB of inputs in all (f32)
    sets = []
    for i in range(n_sets):
        x, w, b = cs.conv_inputs(3 + i, s["B"], s["L"], s["Cin"], s["Cout"],
                                 s["K"], dtype)
        sets.append((x, w, b, x.transpose(1, 2),
                     w.permute(2, 1, 0).contiguous(), b.to(dtype)))

    def library(x, w, b, x_lib, w_lib, b_lib):
        y = F.conv1d(x_lib, w_lib, b_lib, stride=s["stride"])
        return F.gelu(y, approximate="tanh").transpose(1, 2)

    x, w, b = sets[0][:3]
    tol = cs.TOL if dtype == torch.float32 else cs.BTOL
    want = sc.conv1d_sliding_plain(x, w, b, **args)
    err = cs.close(sc.conv1d_sliding(x, w, b, **args), want, tol,
                   f"conv {name} {dtype}")
    cs.close(library(*sets[0]), want, cs.BTOL if dtype == torch.bfloat16
             else cs.TOL, f"library conv {name} {dtype}")
    lout = (s["L"] - s["K"]) // s["stride"] + 1
    el = x.element_size()
    nbytes = (el * (x.numel() + w.numel() + s["B"] * lout * s["Cout"])
              + 4 * b.numel())
    ops = 2 * s["B"] * lout * s["Cout"] * s["Cin"] * s["K"]
    bms, by = cs.bound_ms(nbytes, ops, dtype)
    t = {key: card_ms(cs.cycling(fn, sets))
         for key, fn in (
             ("ms", lambda x, w, b, *_: sc.conv1d_sliding(x, w, b, **args)),
             ("plain_ms", lambda x, w, b, *_: sc.conv1d_sliding_plain(
                 x, w, b, **args)),
             ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err)


def row6(c) -> dict:
    """Row 6 at one of phase 35's 1-D cases, beside row 1 (no epilogue)."""
    sets = []
    for i in range(c["sets"]):
        x, w, st = cs.case_inputs(c, 360 + 40 * i)
        sets.append((x, w, x.transpose(1, 2), w.permute(2, 1, 0).contiguous()))
    x, w = sets[0][:2]
    want = ig.conv1d_im2col_fused_plain(x.float(), w.float(), stride=st)
    err = cs.im2col_close(ig.conv1d_im2col_fused(x, w, stride=st), want,
                          f"im2col_conv1d {c['name']}")
    cs.im2col_close(sc.conv1d_sliding(x, w, None, stride=st), want,
                    f"conv {c['name']}")
    el = x.element_size()
    lout = (x.shape[1] - w.shape[0]) // st + 1
    M, cout = x.shape[0] * lout, w.shape[-1]
    ops = 2 * M * cout * w.shape[0] * w.shape[1]
    bms, by = cs.bound_ms(el * (x.numel() + w.numel() + M * cout), ops,
                          x.dtype)
    t = {key: card_ms(cs.cycling(fn, sets), batches=10, inner=5)
         for key, fn in (
             ("ms", lambda x, w, *_: ig.conv1d_im2col_fused(x, w, stride=st)),
             ("sliding_ms", lambda x, w, *_: sc.conv1d_sliding(x, w, None,
                                                               stride=st)),
             ("plain_ms", lambda x, w, *_: ig.conv1d_im2col_fused_plain(
                 x, w, stride=st)),
             ("library_ms", lambda x, w, xl, wl: F.conv1d(xl, wl, stride=st)))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err)


def row13_sets(s, requant) -> list:
    """``QCONV_MAIN`` shape ``s``'s w8a8 inputs, > 50 MB in all, each with
    its requant scale (None for a float32 output) and the library's
    operands, the input unfolded to (B·Lout, K·Cin) and the weights to
    (K·Cin, Cout), made ahead."""
    K, stride, Cin, Cout = s["K"], s["stride"], s["Cin"], s["Cout"]
    n_sets = min(256, int(64e6 // (s["B"] * s["L"] * Cin + K * Cin * Cout))
                 + 1)
    lout = (s["L"] - K) // stride + 1
    span = (lout - 1) * stride + 1
    sets = []
    for i in range(n_sets):
        x, w, ws, b, xs = cs.quant_inputs(20 + i, s["B"], s["L"], Cin, Cout,
                                          K, "w8a8")
        os = torch.tensor(0.05, device=cs.DEV) if requant else None
        cols = torch.cat([x[:, k : k + span : stride] for k in range(K)],
                         dim=-1).reshape(-1, K * Cin)
        sets.append((x, w, ws, b, xs, os, cols, w.reshape(K * Cin, Cout)))
    return sets


def row13_fns(s, act="gelu"):
    """Row 13's kernel and plain version on a set of ``row13_sets``."""
    args = dict(stride=s["stride"], activation=act)

    def kernel(x, w, ws, b, xs, os, *_):
        return sq.conv1d_quant(x, w, ws, b, x_scale=xs, out_scale=os, **args)

    def plain(x, w, ws, b, xs, os, *_):
        return sq.conv1d_quant_plain(x, w, ws, b, x_scale=xs, out_scale=os,
                                     **args)
    return kernel, plain


def row13_check(got, want, what) -> float:
    """Codes one apart at most, float outputs within TIGHT; max |err|."""
    if want.dtype == torch.int8:
        if (got.int() - want.int()).abs().max().item() > 1:
            raise AssertionError(f"{what}: codes off")
    else:
        cs.close(got, want, cs.TIGHT, what)
    return (got.float() - want.float()).abs().max().item()


def row13(name, s) -> dict:
    """Row 13 in w8a8 at one of ``QCONV_MAIN``'s shapes, gelu, as phase 15
    times it."""
    K, stride, Cin, Cout = s["K"], s["stride"], s["Cin"], s["Cout"]
    lout = (s["L"] - K) // stride + 1
    sets = row13_sets(s, s["requant"])
    kernel, plain = row13_fns(s)

    def library(x, w, ws, b, xs, os, cols, w2):
        acc = torch._int_mm(cols, w2).reshape(s["B"], -1, Cout)
        y = F.gelu(acc.float() * (ws * xs) + b, approximate="tanh")
        if os is None:
            return y
        return torch.clamp(torch.round(y / os), -127, 127).to(torch.int8)

    want = plain(*sets[0])
    err = row13_check(kernel(*sets[0]), want, f"conv w8a8 {name}")
    row13_check(library(*sets[0]), want, f"library conv w8a8 {name}")
    out_bytes = 1 if s["requant"] else 4
    nbytes = (s["B"] * s["L"] * Cin + K * Cin * Cout + 4 * 2 * Cout
              + out_bytes * s["B"] * lout * Cout)
    ops = 2 * s["B"] * lout * Cout * Cin * K
    bms, by = cs.bound_ms(nbytes, ops, torch.int8)
    t = {key: card_ms(cs.cycling(fn, sets))
         for key, fn in (("ms", kernel), ("plain_ms", plain),
                         ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err)


def row10_sets(s, dtype):
    n_sets = 8 if s["Cin"] < 512 else 4  # > 50 MB of inputs in all (f32)
    sets = []
    for i in range(n_sets):
        x, dz = cs.dw_inputs(9 + i, s["B"], s["L"], s["Cin"], s["Cout"],
                             s["K"], s["stride"], dtype)
        sets.append((x, dz, x.transpose(1, 2).contiguous(),
                     dz.transpose(1, 2).contiguous()))
    return sets


def row10_kernel(s):
    return lambda x, dz, *_: sb.conv1d_bwd_dw(x, dz, s["K"],
                                              stride=s["stride"],
                                              has_bias=True)


def row10_check(s, sets, what) -> tuple[float, torch.Tensor]:
    """Row 10 on the first set against its plain version within TOL of
    the largest value (phase 7's check); returns the max |err| of dw and
    the plain dw."""
    x, dz = sets[0][:2]
    want = sb.conv1d_bwd_dw_plain(x, dz, s["K"], stride=s["stride"],
                                  has_bias=True)
    got = row10_kernel(s)(*sets[0])
    cs.close(got[1], want[1], cs.TOL, what + " db", scaled=True)
    return cs.close(got[0], want[0], cs.TOL, what, scaled=True), want[0]


def row10(name, s, dtype) -> dict:
    """Row 10 at one of ``DW_MAIN``'s shapes with db, as phase 10 times it,
    in ``dtype``."""
    K, stride = s["K"], s["stride"]
    sets = row10_sets(s, dtype)

    def library(x, dz, x_lib, dz_lib):
        return torch.nn.grad.conv1d_weight(
            x_lib, (s["Cout"], s["Cin"], K), dz_lib, stride=stride)

    err, want = row10_check(s, sets, f"dw {name} {dtype}")
    x, dz = sets[0][:2]
    cs.close(library(*sets[0]).permute(2, 1, 0), want,
             cs.TOL if dtype == torch.float32 else cs.BTOL,
             f"library dw {name} {dtype}", scaled=True)
    el = x.element_size()
    lout = dz.shape[1]
    nbytes = (el * (x.numel() + dz.numel())
              + 4 * (K * s["Cin"] * s["Cout"] + s["Cout"]))
    ops = 2 * s["B"] * lout * K * s["Cin"] * s["Cout"]
    bms, by = cs.bound_ms(nbytes, ops, dtype)
    t = {key: card_ms(cs.cycling(fn, sets))
         for key, fn in (
             ("ms", row10_kernel(s)),
             ("plain_ms", lambda x, dz, *_: sb.conv1d_bwd_dw_plain(
                 x, dz, K, stride=stride, has_bias=True)),
             ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err)


@contextlib.contextmanager
def forced_splits(n):
    """Every plan made in the block splits its reduction n ways (as far
    as its chunks allow); n None leaves the plans as they are."""
    real = gemm_plan.gemm_plan

    def forced(M, N, K, dtype, sms=build.DEFAULT_SMS, tile=None,
               splits=None):
        return real(M, N, K, dtype, sms, tile=tile, splits=n)

    if n is not None:
        gemm_plan.gemm_plan = forced
    try:
        yield
    finally:
        gemm_plan.gemm_plan = real


def row10_splits(name, s, dtype) -> dict:
    """Row 10 in ``dtype`` with the plan's split and forced to 1, 2, 3 and
    4 splits, each held to the plain version first; ms by split count."""
    sets = row10_sets(s, dtype)
    plan = gemm_plan.gemm_plan(
        s["K"] * s["Cin"], s["Cout"], sets[0][1].numel() // s["Cout"], dtype,
        build.sm_count(sets[0][0].device))
    out = {"plan_splits": plan.splits}
    for n in (None, 1, 2, 3, 4):
        with forced_splits(n):
            row10_check(s, sets, f"dw {name} {dtype} splits {n}")
            out["plan" if n is None else f"splits_{n}"] = card_ms(
                cs.cycling(row10_kernel(s), sets))
    return out


def row13_probe(name, s) -> dict:
    """Row 13 in w8a8 as ``row13`` times it, with its plan's split and
    forced to 1, 2 and 4 splits; then, with the plan's split, without the
    activation (``act_none``) and with the other output (``other_out``: a
    float32 output where phase 15 requantizes, int8 codes where it does
    not). Each held to the plain version first; ms by variant."""
    out = {}
    for key, n, act, requant in (
            ("plan", None, "gelu", s["requant"]),
            ("splits_1", 1, "gelu", s["requant"]),
            ("splits_2", 2, "gelu", s["requant"]),
            ("splits_4", 4, "gelu", s["requant"]),
            ("act_none", None, "none", s["requant"]),
            ("other_out", None, "gelu", not s["requant"])):
        sets = row13_sets(s, requant)
        kernel, plain = row13_fns(s, act)
        with forced_splits(n):
            row13_check(kernel(*sets[0]), plain(*sets[0]),
                        f"conv w8a8 {name} {key}")
            out[key] = card_ms(cs.cycling(kernel, sets))
        del sets
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("conv1d_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    build.build_all()
    rows = ARGS or ["1", "6", "13", "10"]
    for lib in ("sliding_conv1d", "im2col_gemm", "sliding_conv_quant",
                "sliding_conv_bwd"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    out = {"device": smi}

    def record(key, shape, what, r):
        out.setdefault(key, {})[shape] = r
        print(f"{key} {shape} {what}: {json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        for name, s in cs.CONV_MAIN.items():
            if "1" in rows:
                key = name if dtype == torch.float32 else f"{name}_bf16"
                record("sliding_conv1d", key, s, row1(name, s, dtype))
    if "6" in rows:
        for c in [c for c in cs.comparison_cases() if c["dims"] == 1]:
            record("im2col_conv1d", c["name"], c["s"], row6(c))
    if "13" in rows:
        for name, s in cs.QCONV_MAIN.items():
            record("sliding_conv_quant", name, s, row13(name, s))
    if "10" in rows:
        for dtype in (torch.float32, torch.bfloat16):
            for name, s in cs.DW_MAIN.items():
                key = name if dtype == torch.float32 else f"{name}_bf16"
                record("conv1d_bwd_dw", key, s, row10(name, s, dtype))
    if "13_probe" in rows:
        for name, s in cs.QCONV_MAIN.items():
            record("sliding_conv_quant_probe", name, s, row13_probe(name, s))
    if "10_splits" in rows:
        if hasattr(sb, "dw_launch"):
            for dtype in (torch.float32, torch.bfloat16):
                for name, s in cs.DW_MAIN.items():
                    key = name if dtype == torch.float32 else f"{name}_bf16"
                    record("conv1d_bwd_dw_splits", key, s,
                           row10_splits(name, s, dtype))
        else:
            print("row 10 takes no plan from gemm_plan in this tree: no "
                  "split probe", flush=True)
    print(f"TIMES {ROOT} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
