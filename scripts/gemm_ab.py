"""Card times of the kernels on ``csrc/gemm_mma.cuh`` (rows 4, 5, 12 and 14)
for one tree of this repository, so that two trees can be compared in one
call on one card, in turns:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 scripts/gemm_ab.py $r; done

Imports the kernels, their wrappers and ``chip_smoke``'s input makers and
timer from the tree at argv[1] (built there, into its ``build/kernels``),
and the shapes from this script: ``gemm_times.py``'s, kernel calls only
(``chip_smoke.card_ms``: CUDA events, queue filled, inputs cycled past the
L2). Rows 4 and 14 go through their wrappers' public calls, the same in
trees whose kernels differ, so earlier kernels time on the same footing.
Prints one line, ``AB <tree> {json}``. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import sys
import time

ROOT = sys.argv[1] if len(sys.argv) > 1 else "."
for p in (ROOT, ROOT + "/src"):
    sys.path.insert(0, p)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, im2col_gemm as ig  # noqa: E402
from repro_torch.kernels import sliding_conv2d as s2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
# row 5: (name, M, K, N, dtype, input sets)
MATMUL = [("fig1_k31", 9604, 30752, 32, F32, 1),
          ("fig1_k3", 15876, 288, 32, F32, 8),
          ("conv1d_K65", 16320, 2080, 32, F32, 2),
          ("patch_embed_bf16", 11520, 588, 1152, BF16, 4),
          ("patch_embed_f32", 11520, 588, 1152, F32, 3)]
FIG1_K3 = dict(B=1, H=128, W=128, Cin=32, Cout=32, k=3, stride=1)
FIG1_K31 = dict(FIG1_K3, k=31)
FIG2_K17 = dict(B=1, H=96, W=96, Cin=32, Cout=32, k=17, stride=1)
PATCH = dict(B=20, H=336, W=336, Cin=3, Cout=1152, k=14, stride=14)
# row 12: (name, shape, dtype, input sets)
DW = [("patch_embed", PATCH, BF16, 3), ("patch_embed_f32", PATCH, F32, 2),
      ("fig1_k3_f32", FIG1_K3, F32, 26), ("fig1_k31_f32", FIG1_K31, F32, 26),
      ("fig2_k17_f32", FIG2_K17, F32, 26)]
# row 4: (name, shape, dtype, activation, bias, input sets)
CONV = [("patch_embed", PATCH, BF16, "none", False, 4),
        ("patch_embed_f32", PATCH, F32, "none", False, 3),
        ("fig1_k3_f32", FIG1_K3, F32, "gelu", True, 26),
        ("fig1_k31_f32", FIG1_K31, F32, "gelu", True, 26),
        ("fig2_k17_f32", FIG2_K17, F32, "gelu", True, 26)]
# row 14: (name, shape, mode, output dtype, activation, bias, input sets)
QUANT = [("patch_embed", PATCH, "w8a8", BF16, "none", False, 4),
         ("patch_embed_w8a16", PATCH, "w8a16", BF16, "none", False, 3),
         ("fig1_k31", FIG1_K31, "w8a8", F32, "gelu", True, 100),
         ("fig2_k17", FIG2_K17, "w8a8", F32, "gelu", True, 100)]


def time_sets(fn, sets) -> float:
    t = cs.card_ms(cs.cycling(fn, sets))
    del sets
    torch.cuda.empty_cache()
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    t0 = time.perf_counter()
    build.build_all()
    out = {"build_s": round(time.perf_counter() - t0, 1)}
    for name, M, K, N, dtype, n in MATMUL:
        g = torch.Generator(device="cuda").manual_seed(M + K + N)
        sets = [(torch.randn((M, K), generator=g, device="cuda").to(dtype),
                 (torch.randn((K, N), generator=g, device="cuda")
                  * K ** -0.5).to(dtype)) for _ in range(n)]
        out[f"matmul {name}"] = time_sets(ig.matmul, sets)
    for name, s, dtype, n in DW:
        k, st = s["k"], s["stride"]
        sets = [cs.conv2d_dw_inputs(500 + i, s["B"], s["H"], s["W"],
                                    s["Cin"], s["Cout"], k, st, dtype)
                for i in range(n)]
        out[f"conv2d_bwd_dw {name}"] = time_sets(
            lambda x, dz: sb.conv2d_bwd_dw(x, dz, (k, k), stride=(st, st),
                                           has_bias=True), sets)
    for name, s, dtype, act, with_bias, n in CONV:
        st = (s["stride"],) * 2
        sets = [cs.conv2d_inputs(610 + i, s["B"], s["H"], s["W"], s["Cin"],
                                 s["Cout"], s["k"], dtype, with_bias)
                for i in range(n)]
        out[f"conv2d {name}"] = time_sets(
            lambda x, w, b: s2.conv2d_sliding(x, w, b, stride=st,
                                              activation=act), sets)
    for name, s, mode, odt, act, with_bias, n in QUANT:
        st = (s["stride"],) * 2
        sets = [cs.conv2d_quant_inputs(630 + i, s["B"], s["H"], s["W"],
                                       s["Cin"], s["Cout"], s["k"], mode,
                                       BF16, with_bias) for i in range(n)]
        out[f"conv2d_quant {name}"] = time_sets(
            lambda x, w, ws, b, xs: sq.conv2d_quant(
                x, w, ws, b, x_scale=xs, mode=mode, stride=st,
                activation=act, out_dtype=odt), sets)
    print("AB", ROOT, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
