"""The plans each tuning search of ``chip_smoke.py`` phase 47 times, for one
tree of this repository, so that a tree whose searches time every plan and
one whose searches rank them can be compared in one call on one card:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/tuning_counts.py $r; done

Imports ``chip_smoke`` and the port from the tree at argv[1] (its kernels
built there, into its ``build/kernels``) and runs that tree's phase 47
alone: every search into a fresh cache, each winner launched through
``ops`` and held to its plain version. Prints one line, ``COUNTS <tree>
{json}``: each key's plans timed and winner, the sum of the plans timed
and the phase's seconds. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = sys.argv[1] if len(sys.argv) > 1 else "."
for p in (ROOT, ROOT + "/src"):
    sys.path.insert(0, p)

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import attention_decode as ad  # noqa: E402
from repro_torch.kernels import autotune, build, ops  # noqa: E402
from repro_torch.kernels import sliding_conv1d as sc  # noqa: E402
from repro_torch.kernels import sliding_conv2d as s2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as sb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as sq  # noqa: E402
from repro_torch.kernels import sliding_pool as sp  # noqa: E402


def main() -> int:
    repro_torch.resolve_device("cuda")
    build.build_all()
    t0 = time.perf_counter()
    out = cs.phase_tuning(autotune, ops, sc, s2, sq, sb, ad, sp)
    seconds = time.perf_counter() - t0
    if len(out) > 2:  # a tree whose phase 47 hands its cache file on
        shutil.rmtree(Path(out[2]).parent, ignore_errors=True)
    tuned = out[0]
    keys = {k: {"timed": v["timed"], "winner": v["winner"]}
            for k, v in tuned.items()}
    print("COUNTS", ROOT, json.dumps({
        "keys": keys, "timed": sum(v["timed"] for v in keys.values()),
        "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
