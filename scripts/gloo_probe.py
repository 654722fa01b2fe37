"""Which gloo collectives take CUDA tensors, for two ranks sharing cuda:0,
and how fast gloo all-reduces a CUDA tensor:

    python3 scripts/gloo_probe.py

Two ranks of ``repro_torch.launch.mesh.run_ranks`` (gloo, ``file://``
rendezvous) each run every collective on CUDA tensors and check the
result; ``send``/``recv`` run in a second pair, since gloo may fail there
(each refusal is caught inside its rank and is the verdict). Then 256 MiB
of float32 is all-reduced three times as it is and three times through
pinned host memory by hand. Another pair, run before ``send``/``recv``
(whose refusal has also aborted the process from a gloo thread), runs
``reduce_scatter`` (the list form, which ``collectives.reduce_scatter``
calls) and ``reduce_scatter_tensor`` on host tensors, then on CUDA
tensors, printing each verdict as it comes, and times the list form on
256 MiB through pinned host memory. Prints one ``A``, ``C`` and ``B``
line of JSON per pair (each rank's verdicts and seconds). The table
``repro_torch.distributed.collectives.DEVICE_TENSORS`` follows it. Needs
one card.
"""
import json
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.launch.mesh import run_ranks  # noqa: E402


def _check(name, fn, out):
    try:
        out[name] = "ok" if fn() else "WRONG"
    except (RuntimeError, NotImplementedError, ValueError) as e:
        # the verdict is the refusal itself
        out[name] = f"raises: {str(e)[:160]}"


def collectives(mesh):
    rank, world = mesh.rank, mesh.size
    dev = torch.device("cuda", 0)
    out = {}

    def all_reduce(op, dtype, want):
        x = torch.full((1000,), rank + 1, device=dev, dtype=dtype)
        dist.all_reduce(x, op=op)
        return bool((x == want).all())

    def all_gather():
        x = torch.full((10,), float(rank), device=dev)
        outs = [torch.empty(10, device=dev) for _ in range(world)]
        dist.all_gather(outs, x)
        return all(bool((o == i).all()) for i, o in enumerate(outs))

    def broadcast():
        x = torch.full((1000,), float(rank), device=dev)
        dist.broadcast(x, 1)
        return bool((x == 1).all())

    for name, fn in (
            ("all_reduce_sum", lambda: all_reduce(dist.ReduceOp.SUM,
                                                  torch.float32, 3)),
            ("all_reduce_max", lambda: all_reduce(dist.ReduceOp.MAX,
                                                  torch.float32, 2)),
            ("all_reduce_int32", lambda: all_reduce(dist.ReduceOp.SUM,
                                                    torch.int32, 3)),
            ("all_gather", all_gather), ("broadcast", broadcast)):
        _check(name, fn, out)
        dist.barrier()
    n = 64 * 2 ** 20  # 256 MiB of float32
    x = torch.randn(n, device=dev)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    out["all_reduce_256MiB_s"] = (time.perf_counter() - t0) / 3
    h = torch.empty(n, pin_memory=True)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        h.copy_(x)
        dist.all_reduce(h)
        x.copy_(h)
    torch.cuda.synchronize()
    out["all_reduce_256MiB_staged_s"] = (time.perf_counter() - t0) / 3
    return out


def send_recv(mesh):
    dev = torch.device("cuda", 0)
    out = {}
    if mesh.rank == 0:
        _check("send", lambda: dist.send(torch.full((1000,), 7.0, device=dev),
                                         1) is None, out)
    else:
        y = torch.zeros(1000, device=dev)
        _check("recv", lambda: dist.recv(y, 0) is not None
               and bool((y == 7).all()), out)
    return out


def reduce_scatter(mesh):
    rank, world = mesh.rank, mesh.size
    out = {}

    def rs_list(dev):
        parts = [torch.full((10,), float(rank + 1 + 10 * j), device=dev)
                 for j in range(world)]
        y = torch.empty(10, device=dev)
        dist.reduce_scatter(y, parts)
        want = sum(r + 1 + 10 * rank for r in range(world))
        return bool((y == want).all())

    def rs_tensor(dev):
        x = torch.cat([torch.full((10,), float(rank + 1 + 10 * j), device=dev)
                       for j in range(world)])
        y = torch.empty(10, device=dev)
        dist.reduce_scatter_tensor(y, x)
        want = sum(r + 1 + 10 * rank for r in range(world))
        return bool((y == want).all())

    for dev in ("cpu", "cuda"):
        for name, fn in (("reduce_scatter", rs_list),
                         ("reduce_scatter_tensor", rs_tensor)):
            key = f"{name}_{dev}"
            _check(key, lambda: fn(torch.device(dev)), out)
            print(f"C rank {rank} {key}: {out[key]}", flush=True)
            dist.barrier()
    n = 64 * 2 ** 20  # 256 MiB of float32, a host copy each way
    x = torch.randn(n, device="cuda")
    h = torch.empty(n, pin_memory=True)
    y = torch.empty(n // world, pin_memory=True)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        h.copy_(x)
        dist.reduce_scatter(y, list(h.chunk(world)))
        x[:n // world].copy_(y)
    torch.cuda.synchronize()
    out["reduce_scatter_256MiB_staged_s"] = (time.perf_counter() - t0) / 3
    return out


def run(fn, tag, timeout_s):
    with tempfile.TemporaryDirectory() as d:
        res = run_ranks(fn, 2, 1, device="cuda", backend="gloo", rdv_dir=d,
                        timeout_s=timeout_s)
    print(tag, json.dumps({"ranks": dict(enumerate(res))}), flush=True)


if __name__ == "__main__":
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    run(collectives, "A", 120)
    run(reduce_scatter, "C", 120)
    run(send_recv, "B", 60)  # gloo may abort its process here
