"""Sliding-window pooling on one card, alone: row 8's forms (sum, avg, max
scan, max shift), its sum gradient and row 9 (the max gradient) at the
shapes ``chip_smoke.py`` phase 39 times them, each first held to its plain
version, then timed beside its plain version, one PyTorch call and the
bound.

    python3 scripts/pool_times.py [float32] [bfloat16]

(no names: both). The paper's shape (1, 16384, 32) at every window of
``chip_smoke.POOL_WINDOWS`` in each type, and (8, 16384, 1024) at w 16 in
float32; row 9 in float32 only (bf16 inputs hold ties, where the library
call takes one argmax a window). Sum, avg and the sum gradient must equal
their plain versions bit for bit, the max forms exactly. Timing as
``chip_smoke._pool_case_times`` (CUDA events, queue filled, inputs cycled
past the L2, median of 10 batches of 5). Prints the card's name and
power limit, each case's layout and times, and, last, one JSON object
with every reading. Needs one card and ``nvcc``.
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sliding_pool as sp  # noqa: E402

FORMS = [(name, op, method) for name, op, method in cs.POOL_FORMS]


def check_exact(B, L, C, w, dtype) -> dict:
    """Each form and the sum gradient against its plain version on one
    input: equal (sum, avg and the gradient bit for bit). Returns the
    layout of each form."""
    x = cs.pool_input(395, B, L, C, dtype)
    for name, op, method in FORMS:
        got = sp.sliding_pool(x, window=w, op=op, method=method)
        if not torch.equal(got, sp.sliding_pool_plain(x, window=w, op=op,
                                                      method=method)):
            raise AssertionError(f"{name} ({B}, {L}, {C}) w={w} {dtype}: "
                                 "not equal to its plain version")
    dy = cs.pool_input(396, B, L - w + 1, C, dtype)
    if not torch.equal(sp.sum_pool_bwd(dy, window=w),
                       sp.sum_pool_bwd_plain(dy, window=w)):
        raise AssertionError(f"sum_pool_bwd ({B}, {L}, {C}) w={w} {dtype}: "
                             "not equal to its plain version")
    sms = build.sm_count(x.device)
    return {f: vars(sp.pool_layout(B, L - w + 1, C, w, f, x.element_size(),
                                   sms)) for f in sp.FORMS}


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    import repro_torch

    repro_torch.resolve_device("cuda")
    types = sys.argv[1:] or ["float32", "bfloat16"]
    build.build_all()
    for line in build.build_log("sliding_pool").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas sliding_pool: {line.strip()}", flush=True)
    P, W = cs.POOL_PAPER, cs.POOL_WIDE
    out = {"device": smi}
    for t in types:
        dtype = getattr(torch, t)
        cases = [(f"paper_w{w}", P["B"], P["L"], P["C"], w, 26)
                 for w in cs.POOL_WINDOWS]
        if dtype == torch.float32:
            cases.append((f"wide_w{W['w']}", W["B"], W["L"], W["C"], W["w"],
                          2))
        for case, B, L, C, w, n_sets in cases:
            layout = check_exact(B, L, C, w, dtype)
            rows = cs._pool_case_times(sp, B, L, C, w, n_sets, 10, 5, dtype)
            out[f"{case}_{t}"] = dict(layout=layout, **rows)
            print(f"pool {case} ({B}, {L}, {C}) {t} layout {layout}: "
                  + "; ".join(f"{n} {r['ms']:.4f} (plain {r['plain_ms']:.4f}"
                              f", library {r['library_ms']:.4f}, bound "
                              f"{r['bound_ms']:.5f})"
                              for n, r in rows.items()), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
