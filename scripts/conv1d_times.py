"""Card times of the 1-D convs on ``csrc/gemm_mma.cuh``'s loop, alone: the
sliding conv (row 1) at whisper's frontend in float32 and in bfloat16, and
the fused 1-D im2col conv (row 6) at ``chip_smoke.py`` phase 35's 1-D
shapes beside row 1 on the same inputs, for one tree of this repository:

    python3 scripts/conv1d_times.py [tree]

(tree: a directory holding a checkout of this repository, by default this
one), so that two trees time in turns in one call on one card:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 scripts/conv1d_times.py $r; done

Imports the kernels, their wrappers and ``chip_smoke``'s input makers,
shapes and timer from the tree (built there, into its ``build/kernels``).
Row 1 as phase 6 times it: bias + gelu, beside its plain version,
``F.conv1d`` + gelu in the same type (cuDNN, TF32 off) and the bound.
Row 6 as phase 35 times it (no epilogue), beside row 1 (``sliding_ms``),
``F.conv1d`` and the bound. Each kernel is first held to its plain version
(float32 within TOL, bfloat16 within BTOL). Card time per call from CUDA
events, queue filled, inputs cycled past the L2 (``chip_smoke.card_ms``).
Prints a line a shape and, last, ``TIMES <tree> {json}``. Needs one card
and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys

ROOT = sys.argv[1] if len(sys.argv) > 1 else "."
for p in (ROOT, ROOT + "/src"):
    sys.path.insert(0, p)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, im2col_gemm as ig  # noqa: E402
from repro_torch.kernels import sliding_conv1d as sc  # noqa: E402


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
    t = {key: cs.card_ms(cs.cycling(fn, sets))
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
    t = {key: cs.card_ms(cs.cycling(fn, sets), batches=10, inner=5)
         for key, fn in (
             ("ms", lambda x, w, *_: ig.conv1d_im2col_fused(x, w, stride=st)),
             ("sliding_ms", lambda x, w, *_: sc.conv1d_sliding(x, w, None,
                                                               stride=st)),
             ("plain_ms", lambda x, w, *_: ig.conv1d_im2col_fused_plain(
                 x, w, stride=st)),
             ("library_ms", lambda x, w, xl, wl: F.conv1d(xl, wl, stride=st)))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err)


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
    for lib in ("sliding_conv1d", "im2col_gemm"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    out = {"device": smi, "sliding_conv1d": {}, "im2col_conv1d": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for name, s in cs.CONV_MAIN.items():
            key = name if dtype == torch.float32 else f"{name}_bf16"
            out["sliding_conv1d"][key] = r = row1(name, s, dtype)
            print(f"sliding_conv1d {key} {s}: {json.dumps(r)}", flush=True)
            torch.cuda.empty_cache()
    for c in [c for c in cs.comparison_cases() if c["dims"] == 1]:
        out["im2col_conv1d"][c["name"]] = r = row6(c)
        print(f"im2col_conv1d {c['name']} {c['s']}: {json.dumps(r)}",
              flush=True)
        torch.cuda.empty_cache()
    print(f"TIMES {ROOT} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
