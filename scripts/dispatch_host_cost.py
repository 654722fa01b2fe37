"""Host time a call of the ``ops`` entries that serving repeats, disarmed
(no tracing, no dispatch metrics) and with no tuning cache, for one tree
of this repository, so that two trees can be compared in one call on one
card, in turns:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . build/parent . build/parent .; do
        python3 scripts/dispatch_host_cost.py $r; done

Imports ``repro_torch`` from the tree at argv[1] (its kernels built there,
into its ``build/kernels``; the first run in a tree builds them). Each
entry runs at a small shape, so that the loop's time is mostly the
host's: ``ops.attention_decode`` (bf16 and int8 cache), ``ops.conv1d``
(float32, no gradient) and ``ops.conv1d_depthwise`` (bfloat16, VALID).
An entry's numbers are the median and the least, over ``REPS`` loops of
``CALLS`` calls, of the loop's wall time over its calls, the card
synchronised at the end of each loop. Where the tree's ``ops`` has the
tuned plan rung (``ops._resolve``), ``rung_us`` is that rung alone with
no cache: a conv1d shape key made and resolved, ``RUNG_CALLS`` times in
one loop. ``ladder_us`` isolates the degradation ladder's disarmed cost in
one process, where the tree has one (``ops._ladder``): ``dispatch_us`` is
``ops._dispatch`` on a trivial thunk over a card tensor, as an entry
called it before the ladder (its thunk made each call), ``ladder_us`` the
same thunk through ``ops._ladder`` (the thunk and the lower rungs' lambda
made each call, as an entry makes them), interleaved, ``RUNG_CALLS``
calls a loop, the least of ``REPS`` loops each. Prints one line,
``HOST <tree> {json}``. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

ROOT = sys.argv[1] if len(sys.argv) > 1 else "."
sys.path.insert(0, ROOT + "/src")
# no tuning cache: a path that does not exist (either tree ignores it or
# finds nothing there)
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="dispatch_host_cost_"), "absent.json")

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CALLS = 2000
REPS = 15
RUNG_CALLS = 200_000


def inputs(dev):
    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    B, S, KV, G, D = 1, 64, 1, 1, 128
    q = rnd(B, KV * G, D, dtype=torch.bfloat16)
    k = rnd(B, S, KV, D, dtype=torch.bfloat16)
    v = rnd(B, S, KV, D, dtype=torch.bfloat16)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    kq = torch.randint(-127, 128, (B, S, KV, D), generator=g).to(
        dev, torch.int8)
    vq = torch.randint(-127, 128, (B, S, KV, D), generator=g).to(
        dev, torch.int8)
    ks = (rnd(B, S, KV, 1).abs() / 127 + 1e-3)
    vs = (rnd(B, S, KV, 1).abs() / 127 + 1e-3)
    x1, w1 = rnd(1, 64, 32), rnd(3, 32, 32) / 10
    xd, wd = rnd(1, 64, 256, dtype=torch.bfloat16), rnd(
        4, 256, dtype=torch.bfloat16)
    return {
        "attention_decode_bf16": lambda: ops.attention_decode(
            q, k, v, lengths=lengths),
        "attention_decode_int8": lambda: ops.attention_decode(
            q, kq, vq, lengths=lengths, k_scale=ks, v_scale=vs),
        "conv1d_f32": lambda: ops.conv1d(x1, w1),
        "conv1d_depthwise_bf16": lambda: ops.conv1d_depthwise(
            xd, wd, padding="VALID"),
    }


def host_us(fn) -> dict:
    per = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / CALLS * 1e6)
    return {"median_us": round(statistics.median(per), 3),
            "min_us": round(min(per), 3)}


def rung_us() -> float | None:
    if not hasattr(ops, "_resolve"):
        return None
    from repro_torch.kernels import autotune

    x = torch.zeros(4, 514, 1024)
    t0 = time.perf_counter()
    for _ in range(RUNG_CALLS):
        ops._resolve(autotune.conv1d_key(*x.shape, 1024, 3, 2,
                                         ops._dtype_name(x)), None)
    return round((time.perf_counter() - t0) / RUNG_CALLS * 1e6, 3)


def ladder_us(dev) -> dict:
    x = torch.zeros(1, device=dev)
    ops_ = (x,)

    def via_dispatch():
        t0 = time.perf_counter()
        for _ in range(RUNG_CALLS):
            ops._dispatch("conv1d", "k", ops_, lambda: x)
        return (time.perf_counter() - t0) / RUNG_CALLS * 1e6

    def via_ladder():
        t0 = time.perf_counter()
        for _ in range(RUNG_CALLS):
            ops._ladder("conv1d", lambda: x,
                        lambda: [("plain", lambda: x), ("ref", lambda: x)],
                        key="k", operands=ops_)
        return (time.perf_counter() - t0) / RUNG_CALLS * 1e6

    has_ladder = hasattr(ops, "_ladder")
    d, lad = [], []
    for _ in range(REPS):
        d.append(via_dispatch())
        if has_ladder:
            lad.append(via_ladder())
    return {"dispatch_us": round(min(d), 3),
            "ladder_us": round(min(lad), 3) if has_ladder else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = repro_torch.resolve_device("cuda")
    with torch.no_grad():
        cases = inputs(dev)
        for fn in cases.values():  # build and warm every kernel
            for _ in range(50):
                fn()
        torch.cuda.synchronize()
        out = {name: host_us(fn) for name, fn in cases.items()}
    out["rung_us"] = rung_us()
    out.update(ladder_us(dev))
    print(f"HOST {ROOT} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
