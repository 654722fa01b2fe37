"""The products on ``csrc/gemm_mma.cuh`` on one card, alone: the tiled GEMM
(row 5), the 2-D weight gradient (row 12), the 2-D sliding conv, fp (row
4) and int8 (row 14), and the fused 2-D im2col conv (row 7). Each is held
to its plain version (and two calls to each other, bitwise), then timed
beside its plain version, one PyTorch call and the bound, at the shapes
PERF.md §6 times it at.

    python3 scripts/gemm_times.py [matmul] [conv2d_bwd_dw] [conv2d] \
        [conv2d_quant] [im2col_conv2d]

(no names: all five).

Row 5 on random operands of the hbm columns' shapes (fig1 k=31, fig1 k=3,
the 1-D table's K=65, f32; llava's patch column, bf16 and f32) against
``torch.matmul`` (TF32 off); row 12 at llava's patch embedding (bf16 and
f32), fig1 k=3 and k=31 and fig2 k=17 (f32) against
``torch.nn.grad.conv2d_weight`` plus the bias sum (cuDNN, TF32 off), as
``chip_smoke.py`` phases 32 and 35 time them (``chip_smoke.card_ms``:
CUDA events, queue filled, inputs cycled past the L2). Row 4 at the patch
embedding (bf16, f32), fig1 k=3, 5, 17, 31 and fig2 k=3, 17 (f32, bias +
gelu) against ``F.conv2d`` (``chip_smoke.conv2d_times``, phase 27's
timing); row 14 at the patch embedding (w8a8 to bf16 and to int8, w8a16
on bf16), fig1 k=3, 31 and fig2 k=3, 17 (w8a8, f32 out, bias + gelu)
against ``torch._int_mm`` or ``F.conv2d`` plus the epilogue
(``chip_smoke.conv2d_quant_times``, phase 32's); row 7 at phase 35's
2-D shapes (fig1 and fig2 f32, the patch embedding bf16 and f32, no
epilogue) beside row 4 on the same inputs (``sliding_ms``) and
``F.conv2d`` on channels_last, as phase 35 times them. Prints the ``ptxas``
lines of the libraries, a line a shape and, last, one JSON object with
every reading. Needs one card and ``nvcc``.
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
from repro_torch.kernels import sliding_conv2d as s2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402
from repro_torch.kernels.timing import card_ms  # noqa: E402

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
# row 4: (name, shape, dtype, activation, bias, input sets)
CONV = [("patch_embed", cs.PATCH_MAIN, BF16, "none", False, 4),
        ("patch_embed_f32", cs.PATCH_MAIN, F32, "none", False, 3),
        *[(f"{fig}_k{s['k']}_f32", s, F32, "gelu", True, 26)
          for fig, figs in (("fig1", cs.FIG1), ("fig2", cs.FIG2))
          for s in figs]]
# row 14: (name, shape, mode, output, activation, bias, input sets)
QUANT = [("patch_embed", cs.PATCH_MAIN, "w8a8", "bf16", "none", False, 4),
         ("patch_embed_chained", cs.PATCH_MAIN, "w8a8", "int8", "none", False,
          4),
         ("patch_embed_w8a16", cs.PATCH_MAIN, "w8a16", "bf16", "none", False,
          3),
         *[(f"{fig}_k{s['k']}", s, "w8a8", "f32", "gelu", True, 100)
           for fig, s in (("fig1", cs.FIG1[0]), ("fig1", cs.FIG1[-1]),
                          ("fig2", cs.FIG2[0]), ("fig2", cs.FIG2[1]))]]


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
    t = {key: card_ms(cs.cycling(fn, sets), batches=10, inner=5)
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
    t = {key: card_ms(cs.cycling(fn, sets))
         for key, fn in (
             ("ms", lambda x, dz, *_: sb.conv2d_bwd_dw(x, dz, (k, k), **args)),
             ("plain_ms", lambda x, dz, *_: sb.conv2d_bwd_dw_plain(
                 x, dz, (k, k), **args)),
             ("library_ms", library))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                splits=plan.splits, tile=plan.tile.id)


def _conv_plan(s, dtype) -> dict:
    oh = (s["H"] - s["k"]) // s["stride"] + 1
    ow = (s["W"] - s["k"]) // s["stride"] + 1
    plan = gemm_plan.gemm_plan(s["B"] * oh * ow, s["Cout"],
                               s["k"] ** 2 * s["Cin"], dtype,
                               build.sm_count(torch.device("cuda")))
    return dict(splits=plan.splits, tile=plan.tile.id)


def conv_row(name, s, dtype, act, with_bias, n_sets) -> dict:
    st = (s["stride"],) * 2
    x, w, b = cs.conv2d_inputs(600, s["B"], s["H"], s["W"], s["Cin"],
                               s["Cout"], s["k"], dtype, with_bias,
                               uniform=s is cs.PATCH_MAIN)
    args = dict(stride=st, activation=act)
    err = cs.conv2d_check(s2, x, w, b, f"conv2d {name}", **args)
    if not torch.equal(s2.conv2d_sliding(x, w, b, **args),
                       s2.conv2d_sliding(x, w, b, **args)):
        raise AssertionError(f"conv2d {name}: two calls differ")
    t = cs.conv2d_times(s2, s, dtype, act, with_bias, 610, n_sets)
    return dict(t, max_abs_err=err, **_conv_plan(s, dtype))


def quant_row(name, s, mode, out, act, with_bias, n_sets) -> dict:
    st = (s["stride"],) * 2
    x, w, ws, b, xs = cs.conv2d_quant_inputs(
        620, s["B"], s["H"], s["W"], s["Cin"], s["Cout"], s["k"], mode,
        BF16, with_bias)
    odt = BF16 if out == "bf16" else F32
    err = cs.check_conv2d_quant(sq, x, w, ws, b, xs, mode=mode, stride=st,
                                act=act, out_dtype=odt, requant=True,
                                what=f"conv2d_quant {name}")
    args = dict(x_scale=xs, mode=mode, stride=st, activation=act,
                out_dtype=odt)
    if not torch.equal(sq.conv2d_quant(x, w, ws, b, **args),
                       sq.conv2d_quant(x, w, ws, b, **args)):
        raise AssertionError(f"conv2d_quant {name}: two calls differ")
    t = cs.conv2d_quant_times(sq, name, s, mode, out, act, with_bias, 630,
                              n_sets)
    return dict(t, max_abs_err=err,
                **_conv_plan(s, torch.int8 if mode == "w8a8" else BF16))


def im2col_row(c) -> dict:
    """Row 7 at one of phase 35's 2-D cases: held to its plain version on
    the operands widened to float32, two calls bitwise equal, then timed
    beside row 4 (no epilogue), the plain version, ``F.conv2d`` and the
    bound, with the plan and x's copy width."""
    sets = []
    for i in range(c["sets"]):
        x, w, st = cs.case_inputs(c, 360 + 40 * i)
        sets.append((x, w, x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last)))
    x, w = sets[0][:2]
    got = ig.conv2d_im2col_fused(x, w, stride=st)
    err = cs.im2col_close(got, ig.conv2d_im2col_fused_plain(
        x.float(), w.float(), stride=st), f"im2col_conv2d {c['name']}")
    if not torch.equal(got, ig.conv2d_im2col_fused(x, w, stride=st)):
        raise AssertionError(f"im2col_conv2d {c['name']}: two calls differ")
    oh, ow = got.shape[1:3]
    plan, va, _, _ = ig.conv2d_launch(x, w, st, oh, ow)
    el = x.element_size()
    M, cout = got.numel() // got.shape[-1], got.shape[-1]
    ops_n = 2 * M * cout * w.shape[0] * w.shape[1] * w.shape[2]
    bms, by = cs.bound_ms(el * (x.numel() + w.numel() + got.numel()), ops_n,
                          x.dtype)
    t = {key: card_ms(cs.cycling(fn, sets), batches=10, inner=5)
         for key, fn in (
             ("ms", lambda x, w, *_: ig.conv2d_im2col_fused(x, w, stride=st)),
             ("sliding_ms", lambda x, w, *_: s2.conv2d_sliding(x, w, None,
                                                               stride=st)),
             ("plain_ms", lambda x, w, *_: ig.conv2d_im2col_fused_plain(
                 x, w, stride=st)),
             ("library_ms", lambda x, w, xl, wl: torch.nn.functional.conv2d(
                 xl, wl, stride=st)))}
    return dict(t, bound_ms=bms, bound_by=by, max_abs_err=err,
                splits=plan.splits, tile=plan.tile.id, va=va)


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
    rows = sys.argv[1:] or ["matmul", "conv2d_bwd_dw", "conv2d",
                            "conv2d_quant", "im2col_conv2d"]
    build.build_all()
    for lib in ("im2col_gemm", "sliding_conv2d_bwd", "sliding_conv2d",
                "sliding_conv2d_quant"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    out = {"device": smi, **{r: {} for r in rows}}
    for name, M, K, N, dtype, n_sets in MATMUL * ("matmul" in rows):
        out["matmul"][name] = r = matmul_row(name, M, K, N, dtype, n_sets)
        print(f"matmul {name} ({M}, {K}) @ ({K}, {N}) {dtype}: "
              f"{json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
    for name, s, dtype, n_sets in DW * ("conv2d_bwd_dw" in rows):
        out["conv2d_bwd_dw"][name] = r = dw_row(name, s, dtype, n_sets)
        print(f"conv2d_bwd_dw {name} {s} {dtype}: {json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
    for name, s, dtype, act, with_bias, n_sets in CONV * ("conv2d" in rows):
        out["conv2d"][name] = r = conv_row(name, s, dtype, act, with_bias,
                                           n_sets)
        print(f"conv2d {name} {s} {dtype}: {json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
    for name, s, mode, o, act, with_bias, n_sets in QUANT * (
            "conv2d_quant" in rows):
        out["conv2d_quant"][name] = r = quant_row(name, s, mode, o, act,
                                                  with_bias, n_sets)
        print(f"conv2d_quant {name} {s} {mode} -> {o}: {json.dumps(r)}",
              flush=True)
        torch.cuda.empty_cache()
    for c in [c for c in cs.comparison_cases() if c["dims"] == 2] * (
            "im2col_conv2d" in rows):
        out["im2col_conv2d"][c["name"]] = r = im2col_row(c)
        print(f"im2col_conv2d {c['name']} {c['s']} {c['dtype']}: "
              f"{json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
