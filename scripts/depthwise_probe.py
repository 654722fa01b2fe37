"""What holds row 3 (the depthwise conv, ``csrc/depthwise_rows.cuh``) at
jamba-1.5-large's prefill shape ((4, 259, 16384) bf16, K 4, bias), on one
card: the checkout's kernel beside copies of its source with one half of
the work taken out, and a timeline of its blocks.

    python3 scripts/depthwise_probe.py

  * ``kernel``: the checkout's kernel, with silu and without an activation.
  * ``no_store``: the same, but no output row is stored (the loads, the
    ring and the sums alone; the epilogue is compiled away with it).
  * ``no_load``: the same, but no input row is staged (the sums, the
    epilogue and the stores alone, on whatever the stages hold).
  * ``yardsticks``: ``copy_`` of x into a tensor of its size and
    ``F.silu(x)``, the same bytes as the conv moves.
  * ``timeline``: the kernel with a ``%globaltimer`` stamp by thread 0 of
    each block when it starts, when each item's stage is ready (after the
    ring's barrier) and when each item's rows are stored (after another
    barrier); quartiles over the blocks of the wait before each item, of
    each item's compute and store, and of the blocks' ends, in ns from the
    first block's start.

Each copy is built from ``csrc`` with one edit (``EDITS``) into
``build/kernels/probe/<name>``, loaded in place of the checkout's library
(``build._LOADED``); ``kernel`` and the timeline are held to the plain
version first. Times as ``chip_smoke.card_ms`` takes them (CUDA events,
queue filled, inputs cycled past the L2). Prints a line a reading and,
last, one JSON object. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import sliding_conv1d as sc  # noqa: E402

STORE = "              epi.store((out0 + o + p) * s.C, c0, acc);"
COPY = ("      stage_copy(dst + r * SLAB_BYTES + col * s.cb,\n"
        "                 valid ? xb + (size_t)row * s.C + c : x, s.cb, "
        "valid);")
STAMP = ("  auto stamp = [&](int k) {\n"
         "    if (threadIdx.x == 0 && k < 16) {\n"
         "      unsigned long long t;\n"
         "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "      dw_stamps[blockIdx.x * 16 + k] = t;\n"
         "    }\n"
         "  };\n")
LOOP = ("    cp_wait_pending(s.stages - 2);  // item i has landed (this "
        "thread's part)\n    __syncthreads();  // ... everyone's; and item "
        "i-1's stage is free again\n")
COMPUTE = ("    compute(first + i * step, ring + (i % s.stages) * "
           "stage_bytes);\n")
START = "  const int first = blockIdx.x, step = gridDim.x;\n"
EDITS = {
    "kernel": [],
    "no_store": [(STORE, "              if (acc[0] == 1234.5f)\n  " + STORE)],
    "no_load": [(COPY, "      if (row < 0)\n  " + COPY)],
    "timeline": [
        ("namespace {\n", "__device__ unsigned long long dw_stamps[4096 * 16];"
         "\nnamespace {\n"),
        (START, START + STAMP + "  stamp(0);\n"),
        (LOOP, LOOP + "    stamp(1 + 2 * i);\n"),
        (COMPUTE, COMPUTE + "    __syncthreads();\n    stamp(2 + 2 * i);\n")],
}
READ = ('\nextern "C" int stamps(void* host) {\n  return (int)'
        'cudaMemcpyFromSymbol(host, dw_stamps, sizeof(dw_stamps));\n}\n')


def build_copies() -> dict:
    """The edited copies of the checkout's row-3 kernel, built at once."""
    procs = {}
    for name, edits in EDITS.items():
        d = build.BUILD_DIR / "probe" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        header = (d / "depthwise_rows.cuh").read_text()
        for old, new in edits:
            if header.count(old) < 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()[:40]!r}")
            header = header.replace(old, new, 1 if old.startswith(
                "namespace") else -1)
        (d / "depthwise_rows.cuh").write_text(header)
        if name == "timeline":
            with open(d / "conv1d_depthwise.cu", "a") as f:
                f.write(READ)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "conv1d_depthwise.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(build.BUILD_DIR / "probe" / name / "lib.so"))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def quartiles(a) -> list[int]:
    return [int(np.percentile(a, p)) for p in (0, 25, 50, 75, 100)]


def main() -> int:
    if not torch.cuda.is_available():
        print("depthwise_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    repro_torch.resolve_device("cuda")
    s = cs.DEPTHWISE_MAIN
    B, L, C, K = s["B"], s["L"], s["C"], s["K"]
    sets = [cs.depthwise_inputs(50 + i, B, L, C, K, torch.bfloat16)
            for i in range(4)]  # 4 inputs of 34 MB: > 50 MB
    plan = gemm_plan.depthwise_plan(B, L - K + 1, C, 2, K, 1,
                                    build.sm_count(sets[0][0].device))
    out = {"device": smi, "plan": repr(plan)}
    libs = build_copies()
    for name, lib in libs.items():
        build._LOADED["conv1d_depthwise"] = lib
        if name in ("kernel", "timeline"):
            x, w, b = sets[0]
            cs.dw_check(sc.conv1d_depthwise(x, w, b, activation="silu"),
                        sc.conv1d_depthwise_plain(x, w, b, activation="silu"),
                        f"depthwise {name}")
        if name == "timeline":
            continue
        out[name] = {act: cs.card_ms(cs.cycling(
            lambda x, w, b, act=act: sc.conv1d_depthwise(
                x, w, b, activation=act), sets)) for act in ("silu", "none")}
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    ys = [torch.empty_like(x) for x, _, _ in sets]
    out["yardsticks"] = {
        "copy": cs.card_ms(cs.cycling(lambda x, y: y.copy_(x),
                                      [(x, y) for (x, _, _), y in
                                       zip(sets, ys)])),
        "silu": cs.card_ms(cs.cycling(lambda x, w, b: F.silu(x), sets))}
    print(f"yardsticks: {json.dumps(out['yardsticks'])}", flush=True)

    lib = libs["timeline"]
    lib.stamps.argtypes = [ctypes.c_void_p]
    build._LOADED["conv1d_depthwise"] = lib
    for x, w, b in sets:  # warm, then one launch on a cold input
        sc.conv1d_depthwise(x, w, b, activation="silu")
    x, w, b = sets[0]
    sc.conv1d_depthwise(x, w, b, activation="silu")
    torch.cuda.synchronize()
    buf = np.zeros(4096 * 16, dtype=np.uint64)
    if lib.stamps(buf.ctypes.data) != 0:
        raise RuntimeError("timeline: reading the stamps failed")
    t = buf.reshape(4096, 16)[:plan.blocks].astype(np.int64)
    t -= t[:, 0].min()
    n = plan.items // plan.blocks
    out["timeline_ns"] = {
        "start": quartiles(t[:, 0]),
        "wait": [quartiles(t[:, 1 + 2 * i] - t[:, 2 * i]) for i in range(n)],
        "compute_and_store": [quartiles(t[:, 2 + 2 * i] - t[:, 1 + 2 * i])
                              for i in range(n)],
        "end": quartiles(t[:, 2 * n])}
    print(f"timeline: {json.dumps(out['timeline_ns'])}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
