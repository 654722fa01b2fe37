"""Quickstart: the paper's sliding-window primitives in PyTorch, in a
minute (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Shows: (1) the three conv evaluation backends computing the same
function, (2) the kernel-regime dispatch by filter size, (3) the sliding
conv1d CUDA kernel against its plain PyTorch version (on the CPU the
kernel's wrapper runs that plain version itself), (4) one point of the
paper's Fig. 1, k=17: the sliding conv2d against im2col + GEMM. On the
card both are the hand-written kernels, timed by ``kernels.timing.card_ms``
(CUDA events); on the CPU both are plain PyTorch, timed by the host clock.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import conv as core
from repro_torch.kernels import ops


def _host_ms(fn, reps: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def t(*shape):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    # --- 1. three evaluations of the same convolution ---------------------
    x, w = t(1, 128, 128, 16), t(5, 5, 16, 32)
    y = {b: core.conv2d(x, w, padding="SAME", backend=b)
         for b in ("sliding", "im2col_gemm", "xla")}
    d_im2col = (y["sliding"] - y["im2col_gemm"]).abs().max().item()
    d_xla = (y["sliding"] - y["xla"]).abs().max().item()
    print("max |sliding - im2col| =", d_im2col)
    print("max |sliding - xla|    =", d_xla)

    # --- 2. the paper's kernel regimes ------------------------------------
    regimes = {k: core.regime_for(k) for k in (3, 5, 9, 17, 25)}
    for k, r in regimes.items():
        print(f"filter {k:>2} -> regime {r!r}")

    # --- 3. the sliding conv1d kernel against its plain version -----------
    x1, w1 = t(2, 300, 16), t(5, 16, 32)
    y_kernel = ops.conv1d(x1, w1, padding="SAME", backend="sliding_pallas")
    y_ref = core.conv1d(x1, w1, padding="SAME", backend="sliding")
    d_kernel = (y_kernel - y_ref).abs().max().item()
    what = "CUDA kernel" if dev.type == "cuda" else "plain version (CPU)"
    print(f"{what} vs core.conv1d:", d_kernel)

    # --- 4. Fig. 1 in one data point --------------------------------------
    k = 17
    w17 = t(k, k, 16, 16)
    fns = {b: (lambda b=b: ops.conv2d(x, w17, backend=b))
           for b in ("sliding", "im2col_gemm")}
    if dev.type == "cuda":
        from repro_torch.kernels.timing import card_ms

        clock = "card time, CUDA events"
        ms = {b: card_ms(f) for b, f in fns.items()}
    else:
        clock = "host clock, CPU"
        ms = {b: _host_ms(f) for b, f in fns.items()}
    print(f"k={k}: sliding {ms['sliding']:.3f} ms vs im2col+GEMM "
          f"{ms['im2col_gemm']:.3f} ms -> speedup "
          f"{ms['im2col_gemm'] / ms['sliding']:.2f}x ({clock})")
    return dict(max_diff_im2col=d_im2col, max_diff_xla=d_xla,
                regimes=regimes, kernel_vs_plain=d_kernel,
                fig1_k17_ms=ms, clock=clock, fig1_k17_operands=(x, w17))


if __name__ == "__main__":
    main()
