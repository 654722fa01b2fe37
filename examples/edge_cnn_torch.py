"""Edge-device CNN example in PyTorch, the paper's own target workload
(``examples/edge_cnn.py`` on ``repro_torch``).

Trains a small conv net (5x5 then two 3x3 convs, each with a relu and the
first two with a 2x2 max pool, then a linear head) on a synthetic
image-classification task, with the convolution backend selectable as the
paper compares them:

    PYTHONPATH=src python examples/edge_cnn_torch.py --backend sliding
    PYTHONPATH=src python examples/edge_cnn_torch.py --backend im2col_gemm
    PYTHONPATH=src python examples/edge_cnn_torch.py --backend xla --device cpu

Each backend trains to the same accuracy (the same math); the time
differs. It runs on the card unless ``--device cpu`` is given. The
functions take every backend ``layers.conv2d_bias_act`` takes:
``sliding_pallas`` runs each conv through the 2-D CUDA kernel (forward and
dx), its weight gradient through the 2-D dw kernel, and the int8 chain
through the int8 2-D kernel.

``--quant int8`` quantizes the trained net after training: calibrate the
activation scales on a sample batch, quantize the conv weights to int8
(per output channel, absmax), and evaluate the w8a8 forward. The
``quant.CHAINS`` entries edge/c1 -> c2 -> c3 make c1 and c2 requantize in
their epilogues onto their consumer's grid, so int8 codes flow through the
max pools (the max of codes is the code of the max on a per-tensor grid)
and c3 is the one dequant site. The int8 accuracy must stay within 2% of
float32.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import quant, resolve_device
from repro_torch.core import sliding
from repro_torch.models import layers as L

LR = 0.03  # plain SGD: the 3-conv stack diverges or stalls at 0.3 and 0.1
SITES = (("c1", "edge/c1"), ("c2", "edge/c2"), ("c3", "edge/c3"))


def init_params(gen: torch.Generator):
    """He-normal conv weights (kh, kw, Cin, Cout) and head, zero head
    bias, float32, drawn from ``gen`` on its device."""
    dev = gen.device

    def s(shape):
        std = (2.0 / np.prod(shape[:-1])) ** 0.5
        return torch.randn(shape, generator=gen, device=dev) * std

    return {
        "c1": s((5, 5, 1, 16)),     # the paper's custom k=5 regime
        "c2": s((3, 3, 16, 32)),    # custom k=3 regime
        "c3": s((3, 3, 32, 32)),    # tail of the 3-deep requant chain
        "head": s((7 * 7 * 32, 10)),
        "b": torch.zeros((10,), device=dev),
    }


def forward(p, x, backend, precision="fp"):
    """Logits (B, 10) of images x (B, 28, 28, 1). With ``precision="w8a8"``
    and ``QuantizedWeight`` convs, the int8 path: chained sites emit int8
    codes, and the head reads c3's float output."""
    h = x
    for i, (key, site) in enumerate(SITES):
        h = L.conv2d_bias_act(h, p[key], None, activation="relu",
                              padding="SAME", backend=backend,
                              precision=precision, site=site)
        if i < 2:
            h = sliding.max_pool2d(h, (2, 2))
    # flattened, not globally pooled: the task needs position
    return h.reshape(h.shape[0], -1) @ p["head"] + p["b"]


def synthetic_task(rng: np.random.Generator, n: int, res: int = 28,
                   device="cpu"):
    """Classify which quadrant holds the bright blob: (images (n, res,
    res, 1) float32, labels (n,) int64) on ``device``, drawn from ``rng``
    as the reference draws them."""
    x = rng.normal(0, 0.3, size=(n, res, res, 1)).astype(np.float32)
    y = rng.integers(0, 4, size=(n,))
    for i, lbl in enumerate(y):
        r0 = (lbl // 2) * res // 2 + res // 8
        c0 = (lbl % 2) * res // 2 + res // 8
        x[i, r0: r0 + res // 4, c0: c0 + res // 4, 0] += 2.0
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(y % 10).to(device))


def loss_fn(p, x, y, backend):
    logp = torch.log_softmax(forward(p, x, backend), dim=-1)
    return -logp[torch.arange(y.shape[0], device=y.device), y].mean()


def sgd_step(p, x, y, backend):
    """One SGD step at ``LR``: (new params, loss)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = loss_fn(leaves, x, y, backend)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: v - LR * g for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def accuracy(p, x, y, backend, precision="fp") -> float:
    with torch.no_grad():
        pred = forward(p, x, backend, precision).argmax(-1)
    return (pred == y).float().mean().item()


def quantize_net(params, calib_x, backend):
    """Post-training quantization of the conv stack: an eager calibration
    forward, per-site activation scales, int8 weights with the scales
    folded in. The ``quant.CHAINS`` entries give c1 and c2 their
    consumer's scale as ``out_scale``, so the stack runs int8 end to end
    and c3 is the chain's one dequant site."""
    calib = quant.Calibration()
    with torch.no_grad(), quant.collecting(calib):
        forward(params, calib_x, backend)
    spec = calib.spec(chains=quant.CHAINS)
    qp = dict(params)
    for key, site in SITES:
        qp[key] = quant.quantize_weight(params[key], spec[site]["x_scale"],
                                        spec[site].get("out_scale"))
    return qp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="sliding",
                    choices=["sliding", "im2col_gemm", "xla"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="evaluate an int8 (w8a8) quantization of the "
                         "trained net")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    params = init_params(torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        x, y = synthetic_task(rng, 64, device=dev)
        params, loss = sgd_step(params, x, y, args.backend)
        losses.append(loss)
        if i % 20 == 0:
            print(f"[cnn/{args.backend}] step {i} loss {float(loss):.3f}")
    xt, yt = synthetic_task(rng, 256, device=dev)
    acc = accuracy(params, xt, yt, args.backend)
    seconds = time.perf_counter() - t0
    print(f"[cnn/{args.backend}] test acc {acc:.2%} "
          f"({seconds:.1f}s for {args.steps} steps)")
    if acc <= 0.9:
        raise AssertionError("conv net should solve the quadrant task")
    out = dict(acc=acc, losses=[float(v) for v in losses], seconds=seconds)

    if args.quant:
        calib_x, _ = synthetic_task(rng, 64, device=dev)
        qp = quantize_net(params, calib_x, args.backend)
        with quant.counting_dequants() as deq:
            acc_q = accuracy(qp, xt, yt, args.backend, precision="w8a8")
        print(f"[cnn/{args.backend}] int8 (w8a8) test acc {acc_q:.2%} "
              f"(f32 {acc:.2%}); dequant sites: {deq}")
        if deq != ["edge/c3"]:
            raise AssertionError(
                f"3-deep chain must dequant exactly once at the tail: {deq}")
        if abs(acc - acc_q) > 0.02:
            raise AssertionError("int8 accuracy drifted >2% from f32")
        out.update(acc_q=acc_q, dequant_sites=list(deq))
    return out


if __name__ == "__main__":
    main()
