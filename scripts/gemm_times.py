"""The tiled GEMM (row 5) and the 2-D weight gradient (row 12) on one card,
alone: each held to its plain version, then timed beside its plain
version, one PyTorch call and the bound, at the shapes PERF.md §6 times
them at.

    python3 scripts/gemm_times.py

Row 5 on random operands of the hbm columns' shapes (fig1 k=31, fig1 k=3,
the 1-D table's K=65, f32; llava's patch column, bf16 and f32) against
``torch.matmul`` (TF32 off); row 12 at llava's patch embedding (bf16 and
f32), fig1 k=3 and k=31 and fig2 k=17 (f32) against
``torch.nn.grad.conv2d_weight`` plus the bias sum (cuDNN, TF32 off), as
``chip_smoke.py`` phases 32 and 35 time them (``chip_smoke.card_ms``:
CUDA events, queue filled, inputs cycled past the L2). Prints the
``ptxas`` lines of both libraries, a line a shape and, last, one JSON
object with every reading. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import im2col_gemm as ig  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
# row 5: (name, M, K, N, dtype, input sets)
MATMUL = [("fig1_k31", 9604, 30752, 32, F32, 1),
          ("fig1_k3", 15876, 288, 32, F32, 8),
          ("conv1d_K65", 16320, 2080, 32, F32, 2),
          ("patch_embed_bf16", 11520, 588, 1152, BF16, 4),
          ("patch_embed_f32", 11520, 588, 1152, F32, 3)]
# row 12: (name, shape, dtype, input sets)
DW = [("patch_embed", cs.PATCH_MAIN, BF16, 3),
      ("patch_embed_f32", cs.PATCH_MAIN, F32, 2),
      ("fig1_k3_f32", dict(cs.fig_shape("fig1", 3), stride=1), F32, 26),
      ("fig1_k31_f32", dict(cs.fig_shape("fig1", 31), stride=1), F32, 26),
      ("fig2_k17_f32", dict(cs.fig_shape("fig2", 17), stride=1), F32, 26)]


def matmul_row(name, M, K, N, dtype, n_sets) -> dict:
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    sets = [(torch.randn((M, K), generator=g, device="cuda").to(dtype),
             (torch.randn((K, N), generator=g, device="cuda")
              * K ** -0.5).to(dtype)) for _ in range(n_sets)]
    a, b = sets[0]
    want = ig.matmul_plain(a.float(), b.float())
    err = cs.im2col_close(ig.matmul(a, b), want, f"matmul {name}")
    if not torch.equal(ig.matmul(*sets[0]), ig.matmul(*sets[0])):
        raise AssertionError(f"matmul {name}: two calls differ")
    el = dtype.itemsize
    bms, by = cs.bound_ms(el * (M * K + K * N + M * N), 2 * M * N * K, dtype)
    plan = gemm_plan.gemm_plan(M, N, K, dtype, build.sm_count(a.device))
    t = {key: cs.card_ms(cs.cycling(fn, sets), batches=10, inner=5)
         for key, fn in (("ms", ig.matmul), ("plain_ms", ig.matmul_plain),
                         ("library_ms", torch.matmul))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                splits=plan.splits, tile=plan.tile.id)


def dw_row(name, s, dtype, n_sets) -> dict:
    k, stride = s["k"], s["stride"]
    sets = []
    for i in range(n_sets):
        x, dz = cs.conv2d_dw_inputs(500 + i, s["B"], s["H"], s["W"], s["Cin"],
                                    s["Cout"], k, stride, dtype)
        sets.append((x, dz, x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)))
    args = dict(stride=(stride, stride), has_bias=True)

    def library(x, dz, x_lib, dz_lib):
        dw = torch.nn.grad.conv2d_weight(
            x_lib, (s["Cout"], s["Cin"], k, k), dz_lib, stride=stride)
        return dw.permute(2, 3, 1, 0), dz.sum(dim=(0, 1, 2))

    x, dz = sets[0][:2]
    got = sb.conv2d_bwd_dw(x, dz, (k, k), **args)
    want = sb.conv2d_bwd_dw_plain(x, dz, (k, k), **args)
    err = max(cs.close(got[0], want[0], cs.TOL, f"dw {name}", scaled=True),
              cs.close(got[1], want[1], cs.TOL, f"db {name}", scaled=True))
    again = sb.conv2d_bwd_dw(x, dz, (k, k), **args)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"dw {name}: two calls differ")
    el = x.element_size()
    nbytes = el * (x.numel() + dz.numel()) + 4 * (k * k * s["Cin"] * s["Cout"]
                                                  + s["Cout"])
    bms, by = cs.bound_ms(nbytes, 2 * dz.numel() * k * k * s["Cin"], dtype)
    plan = gemm_plan.gemm_plan(k * k * s["Cin"], s["Cout"],
                               dz.numel() // s["Cout"], dtype,
                               build.sm_count(x.device))
    t = {key: cs.card_ms(cs.cycling(fn, sets))
         for key, fn in (
             ("ms", lambda x, dz, *_: sb.conv2d_bwd_dw(x, dz, (k, k), **args)),
             ("plain_ms", lambda x, dz, *_: sb.conv2d_bwd_dw_plain(
                 x, dz, (k, k), **args)),
             ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                splits=plan.splits, tile=plan.tile.id)


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    import repro_torch

    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    build.build_all()
    for lib in ("im2col_gemm", "sliding_conv2d_bwd"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    out = {"device": smi, "matmul": {}, "conv2d_bwd_dw": {}}
    for name, M, K, N, dtype, n_sets in MATMUL:
        out["matmul"][name] = r = matmul_row(name, M, K, N, dtype, n_sets)
        print(f"matmul {name} ({M}, {K}) @ ({K}, {N}) {dtype}: "
              f"{json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
    for name, s, dtype, n_sets in DW:
        out["conv2d_bwd_dw"][name] = r = dw_row(name, s, dtype, n_sets)
        print(f"conv2d_bwd_dw {name} {s} {dtype}: {json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
