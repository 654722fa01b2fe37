"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository's
``src/`` beside this file; it imports ``torch``, ``numpy`` and
``repro_torch`` only. Phases, each of which raises on failure:

  1. device: require a card; print ``nvidia-smi``'s name and power limit;
  2. build: compile every kernel under ``src/repro_torch/kernels/csrc``;
  3. kernels vs plain: each CUDA kernel against its plain PyTorch version
     on the card, at the shapes whisper-medium serving gives it and at edge
     shapes (ragged tiles, K in {1, 3, 5, 7}, stride 3, lengths 0 and S,
     G in {1, 2, 4, 8}, float32 and bfloat16);
  4. smoke serve, card vs CPU: whisper smoke config (float32), one set of
     weights; equal greedy tokens and prefill logits within tolerance;
  5. full-width serve: whisper-medium (24+24 layers, d 1024, bf16, random
     weights from a seeded generator), B=4, P=256, 32 tokens, with the
     kernels' launch counts checked over that one request;
  6. times: each kernel at the serving shapes beside its plain version,
     one PyTorch library call computing the same function, and the card's
     bound for the work. ``ms`` is card time per call from CUDA events,
     median of 20 batches of 10 calls after warm-up, with the card's queue
     filled first so that the host's queueing time does not count;
     ``call_ms`` is the same without the filled queue (host time
     included).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Times are those of the card this runs on,
named on the ``nvidia-smi`` line.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# float32: the kernels sum in another order than the plain versions
# (tests/test_kernels.py TOL); bfloat16 outputs are compared in float32
TOL = dict(rtol=3e-4, atol=3e-4)
BTOL = dict(rtol=5e-2, atol=5e-2)

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): device memory rate
# and arithmetic rate by operand type. f32 runs on the CUDA cores: the port
# keeps TF32 off.
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

DEV = "cuda"
SERVE = dict(B=4, P=256, gen=32)  # full-width request
SMOKE = dict(B=2, P=16, gen=8)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> float:
    """Raise unless got ~= want elementwise (in float32); return max |err|."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max "
                             f"|err| {err.max().item():.3e}")
    return err.max().item()


def call_ms(fn, batches: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Per-call time from CUDA events around ``inner`` back-to-back calls,
    median over ``batches``. Where the host queues calls more slowly than
    the card runs them, this is the host's time per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _sleep_cycles_per_ms() -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def card_ms(fn, batches: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Card time per call from CUDA events: before each batch of ``inner``
    calls the card is kept busy (``torch.cuda._sleep``) for three times as
    long as the host takes to queue the batch, so the calls then run back
    to back with no wait for the host. Median over ``batches``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(3 * host_ms * _sleep_cycles_per_ms()) + 1
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _profiled(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler (host and CUDA
    activity); return the per-key averages."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _kernel_us(e) -> float:
    """Device time of a profiler entry that is a kernel on the card (host
    ops also report their kernels' time; counting them would count twice)."""
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


def timings(kernel, plain, library) -> dict:
    """The kernel's, the plain version's and the library call's times per
    call: card time from CUDA events (``ms``) and the event time per call
    with the host's time in it (``call_ms``)."""
    out = {}
    for pre, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[pre + "ms"] = card_ms(fn)
        out[pre + "call_ms"] = call_ms(fn)
    return out


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for the operand type, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def conv_inputs(seed, B, L, Cin, Cout, K, dtype, with_bias=True):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, L, Cin), generator=g, device=DEV).to(dtype)
    w = (torch.randn((K, Cin, Cout), generator=g, device=DEV)
         / (K * Cin) ** 0.5).to(dtype)
    b = torch.randn((Cout,), generator=g, device=DEV) if with_bias else None
    return x, w, b


def attn_inputs(seed, B, S, KV, G, D, dtype, lengths):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, KV, G, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, S, KV, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, S, KV, D), generator=g, device=DEV).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=DEV)


# the serving shapes: whisper-medium frontend at P=256 (2P mel frames, SAME
# padding adds 2 rows), and the decode reads at S=288
CONV_MAIN = {
    "conv1": dict(B=4, L=514, Cin=80, Cout=1024, K=3, stride=1),
    "conv2": dict(B=4, L=514, Cin=1024, Cout=1024, K=3, stride=2),
}
ATTN_MAIN = dict(B=4, S=288, KV=16, G=1, D=64)


def phase_kernels(sc, ad) -> dict:
    errs = {"sliding_conv1d": 0.0, "attention_decode": 0.0}
    for name, s in CONV_MAIN.items():
        x, w, b = conv_inputs(1, s["B"], s["L"], s["Cin"], s["Cout"], s["K"],
                              torch.float32)
        args = dict(stride=s["stride"], activation="gelu")
        err = close(sc.conv1d_sliding(x, w, b, **args),
                    sc.conv1d_sliding_plain(x, w, b, **args), TOL, name)
        errs["sliding_conv1d"] = max(errs["sliding_conv1d"], err)
        log(f"conv {name} {s} f32 gelu: max|err| {err:.3e}")
    edge = [(1, 3, "none", True), (3, 3, "gelu", False), (5, 3, "silu", True),
            (7, 3, "relu", True), (3, 1, "gelu", True), (4, 2, "silu", False)]
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BTOL)):
        for K, stride, act, with_bias in edge:
            x, w, b = conv_inputs(K + stride, 3, 203, 37, 70, K, dtype, with_bias)
            what = f"conv edge K={K} s={stride} {act} bias={with_bias} {dtype}"
            err = close(sc.conv1d_sliding(x, w, b, stride=stride, activation=act),
                        sc.conv1d_sliding_plain(x, w, b, stride=stride,
                                                activation=act), tol, what)
            log(f"{what}: max|err| {err:.3e}")

    lens = [0, 1, 127, 288]
    q, k, v, ln = attn_inputs(2, **ATTN_MAIN, dtype=torch.bfloat16, lengths=lens)
    got = ad.decode_attention(q, k, v, ln)
    err = close(got, ad.attention_decode_plain(q, k, v, ln), BTOL,
                "attention bf16 main shape")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("attention: a length-0 slot must give a zero row")
    errs["attention_decode"] = err
    log(f"attention {ATTN_MAIN} bf16 lengths {lens}: max|err| {err:.3e}")
    for G in (2, 4, 8):
        for S, D in ((288, 64), (200, 128), (24, 32)):
            lens = [0, 1, S // 2, S]
            q, k, v, ln = attn_inputs(G * S, 4, S, 2, G, D, torch.float32, lens)
            what = f"attention f32 G={G} S={S} D={D} lengths {lens}"
            err = close(ad.decode_attention(q, k, v, ln),
                        ad.attention_decode_plain(q, k, v, ln), TOL, what)
            log(f"{what}: max|err| {err:.3e}")
    for S, lens, G in ((65, [31, 32, 33, 65], 1), (1, [0, 1, 1, 0], 3)):
        q, k, v, ln = attn_inputs(S, 4, S, 3, G, 64, torch.float32, lens)
        what = f"attention f32 G={G} S={S} D=64 lengths {lens}"
        err = close(ad.decode_attention(q, k, v, ln),
                    ad.attention_decode_plain(q, k, v, ln), TOL, what)
        log(f"{what}: max|err| {err:.3e}")
    torch.cuda.synchronize()
    return errs


def phase_smoke_serve(serve, models, configs, map_tree):
    """One set of float32 smoke weights on the CPU and on the card: equal
    greedy tokens, prefill logits within TOL."""
    cfg = configs.smoke_config(configs.get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas")
    model = models.build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    gpu_params = map_tree(lambda t: t.to(DEV), cpu_params)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(SMOKE["B"], SMOKE["P"])
                     ).astype(np.int32))
    cache_len = SMOKE["P"] + SMOKE["gen"]
    out = {}
    for dev, params in (("cpu", cpu_params), (DEV, gpu_params)):
        with torch.no_grad():
            logits, _ = serve.prefill_cache(model, params, prompts.to(dev),
                                            cache_len=cache_len)
        toks, _ = serve.generate(model, params, prompts.to(dev),
                                 gen_len=SMOKE["gen"], cache_len=cache_len)
        out[dev] = (logits.cpu(), toks.cpu())
    err = close(out[DEV][0], out["cpu"][0], TOL, "smoke prefill logits")
    if not torch.equal(out[DEV][1], out["cpu"][1]):
        raise AssertionError(f"smoke greedy tokens differ: card "
                             f"{out[DEV][1].tolist()} vs CPU "
                             f"{out['cpu'][1].tolist()}")
    log(f"smoke serve {SMOKE}: greedy tokens equal on card and CPU "
        f"{out[DEV][1].tolist()}; prefill logits max|err| {err:.3e}")


def phase_full_serve(serve, models, configs, sc, ad, map_tree) -> dict:
    cfg = configs.get_config("whisper-medium").replace(
        conv_backend="sliding_pallas", attn_decode="fused")
    model = models.build_model(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    from repro_torch.distributed.sharding import iter_leaves

    n_params = sum(t.numel() for _, t in iter_leaves(params))
    log(f"full width {cfg.name}: {n_params} params ({cfg.param_dtype}), "
        f"{cfg.encoder_layers}+{cfg.num_layers} layers, d {cfg.d_model}, "
        f"init {time.perf_counter() - t0:.2f}s")
    B, P, gen = SERVE["B"], SERVE["P"], SERVE["gen"]
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, P)),
                              dtype=torch.int32, device=DEV)
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen)
    serve.generate(model, params, prompts, gen_len=2, cache_len=cache_len)  # warm-up
    torch.cuda.reset_peak_memory_stats()

    sc.conv1d_sliding.launches = 0
    ad.decode_attention.launches = 0
    stats: dict = {}
    t0 = time.perf_counter()
    toks, _ = serve.generate(model, params, prompts, gen_len=gen,
                             cache_len=cache_len, stats=stats)
    wall = time.perf_counter() - t0
    launches = {"sliding_conv1d": sc.conv1d_sliding.launches,
                "attention_decode": ad.decode_attention.launches}

    want = {"sliding_conv1d": 2, "attention_decode": 2 * cfg.num_layers * (gen - 1)}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if tuple(toks.shape) != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    with torch.no_grad():
        logits, cache = serve.prefill_cache(model, params, prompts,
                                            cache_len=cache_len)
        step, _ = model.decode_step(params, cache, toks[:, :1], P)
    for what, t in (("prefill", logits), ("decode step", step)):
        if t.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(t).all():
            raise AssertionError(f"full-width {what} logits not finite / bad shape")
    # the model in float32 (the same random weights, widened): prefill
    # logits through the kernels against the plain versions, and, as the
    # control, against the kernels on mels nudged by one part in a million.
    # Random weights make this model chaotic, so the two differences are of
    # one size (printed, not held to a tolerance; see PERF.md)
    model32 = models.build_model(cfg.replace(param_dtype="float32",
                                             compute_dtype="float32"))
    params32 = map_tree(lambda t: t.float() if t.is_floating_point() else t,
                        params)
    batch = serve.serve_batch(model32, B, P, prompts)
    nudged = dict(batch, frames=batch["frames"] * (1 + 1e-6))
    runs = {}
    for name, ctx, bt in (("kernels", contextlib.nullcontext(), batch),
                          ("plain versions", plain_kernels(sc, ad), batch),
                          ("kernels on mels x (1 + 1e-6)",
                           contextlib.nullcontext(), nudged)):
        with torch.no_grad(), ctx:
            runs[name] = model32.prefill(params32, bt)[0]
    ref = runs.pop("kernels")
    for name, other in runs.items():
        rel = ((ref - other).abs().max() / ref.abs().max()).item()
        agree = (ref.argmax(-1) == other.argmax(-1)).float().mean().item()
        log(f"full-width float32 prefill logits, kernels vs {name}: max "
            f"|diff| {rel:.3e} of max |logit|, argmax agreement {agree:.2f}")
    del params32, runs
    res_prof = {
        "prefill": profile_busy(lambda: serve.prefill_cache(
            model, params, prompts, cache_len=cache_len)),
        "decode_step": profile_busy(lambda: model.decode_step(
            params, cache, toks[:, :1], P)),
    }
    for what, r in res_prof.items():
        log(f"profile {what}: wall {r['wall_ms']:.3f} ms, card busy "
            f"{r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%), "
            f"{r['kernels']} kernels; top: {r['top']}")
    step_ms = statistics.median(stats["step_s"]) * 1e3
    res = dict(tok_per_s=B * gen / wall, ttft_ms=stats["ttft_s"] * 1e3,
               decode_step_ms=step_ms, wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, cache_len=cache_len,
               busy_share={k: r["busy_share"] for k, r in res_prof.items()})
    log(f"full-width serve B={B} P={P} gen={gen}: {res['tok_per_s']:.1f} tok/s, "
        f"TTFT {res['ttft_ms']:.2f} ms, decode step {step_ms:.3f} ms (median "
        f"of {len(stats['step_s'])}), {wall:.3f}s, peak mem "
        f"{res['peak_mem_gb']:.2f} GB, launches {launches}, sample "
        f"{toks[0, :16].tolist()}")
    return res


@contextlib.contextmanager
def plain_kernels(sc, ad):
    """Route both kernel wrappers to their plain versions for the block."""
    saved = sc._launch, ad._launch
    sc._launch = lambda x, w, b, stride, act, _n: sc.conv1d_sliding_plain(
        x, w, b, stride=stride, activation=act)
    ad._launch = ad.attention_decode_plain
    try:
        yield
    finally:
        sc._launch, ad._launch = saved


def profile_busy(fn, reps: int = 3) -> dict:
    """Wall time per call (host clock around calls that end in a
    synchronise, profiler off) and the card's busy time per call (the sum
    of kernel device times, from a second, profiled run), with the kernels
    that take most of it."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        ev = [(_kernel_us(e), e.count, e.key)
              for e in _profiled(fn, reps) if _kernel_us(e) > 0]
    busy_ms = sum(t for t, _, _ in ev) / reps / 1e3
    top = sorted(ev, reverse=True)[:6]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
                kernels=sum(c for _, c, _ in ev) // reps,
                top=[(k[:60], round(t / reps / 1e3, 4), c // reps)
                     for t, c, k in top])


def cycling(fn, sets):
    """A call of ``fn`` that takes the next argument set each time: the
    sets together exceed the 50 MB L2, so every call reads its inputs from
    device memory, as the main path does."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def phase_times(sc, ad, launches, errs) -> list[dict]:
    conv_rows = {}
    for name, s in CONV_MAIN.items():
        args = dict(stride=s["stride"], activation="gelu")
        n_sets = 8 if s["Cin"] < 512 else 4  # > 50 MB of inputs in all
        sets = []
        for i in range(n_sets):
            x, w, b = conv_inputs(3 + i, s["B"], s["L"], s["Cin"], s["Cout"],
                                  s["K"], torch.float32)
            # the library's weight layout, (Cout, Cin, K), made ahead
            sets.append((x, w, b, w.permute(2, 1, 0).contiguous()))

        def library(x, w, b, w_lib, stride=s["stride"]):
            y = F.conv1d(x.transpose(1, 2), w_lib, b, stride=stride)
            return F.gelu(y, approximate="tanh").transpose(1, 2)

        x, w, b, w_lib = sets[0]
        close(library(x, w, b, w_lib), sc.conv1d_sliding_plain(x, w, b, **args),
              TOL, f"library conv {name}")
        lout = (s["L"] - s["K"]) // s["stride"] + 1
        nbytes = 4 * (x.numel() + w.numel() + b.numel() + s["B"] * lout * s["Cout"])
        ops = 2 * s["B"] * lout * s["Cout"] * s["Cin"] * s["K"]
        bms, by = bound_ms(nbytes, ops, torch.float32)
        conv_rows[name] = dict(
            timings(cycling(lambda x, w, b, _: sc.conv1d_sliding(x, w, b, **args),
                            sets),
                    cycling(lambda x, w, b, _: sc.conv1d_sliding_plain(
                        x, w, b, **args), sets),
                    cycling(library, sets)),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        log(f"time conv {name} {s}: {json.dumps(conv_rows[name])}")

    lens = [256] * ATTN_MAIN["B"]  # the cross-attention read's lengths
    B, S, KV, G, D = (ATTN_MAIN[n] for n in ("B", "S", "KV", "G", "D"))
    sets = []
    for i in range(16):  # 16 caches of 4.7 MB: > 50 MB, as the 24 layers are
        q, k, v, ln = attn_inputs(4 + i, **ATTN_MAIN, dtype=torch.bfloat16,
                                  lengths=lens)
        mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None])[:, None, None, :]
        sets.append((q, k, v, ln, mask))

    def library(q, k, v, ln, mask):
        return F.scaled_dot_product_attention(
            q.reshape(B, KV * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)

    q, k, v, ln, mask = sets[0]
    close(library(q, k, v, ln, mask).float().reshape(B, KV, G, D),
          ad.attention_decode_plain(q, k, v, ln), BTOL, "library attention")
    nbytes = (2 * q.numel() + 2 * 2 * sum(lens) * KV * D + 4 * B
              + 4 * B * KV * G * D)
    ops = 4 * G * D * KV * sum(lens)
    bms, by = bound_ms(nbytes, ops, torch.bfloat16)
    attn = dict(
        timings(cycling(lambda q, k, v, ln, _: ad.decode_attention(q, k, v, ln), sets),
                cycling(lambda q, k, v, ln, _: ad.attention_decode_plain(
                    q, k, v, ln), sets),
                cycling(library, sets)),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    log(f"time attention {ATTN_MAIN} bf16 lengths {lens}: {json.dumps(attn)}")

    both = conv_rows.values()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
            "plain_call_ms", "library_call_ms")
    conv_sum = {key: sum(r[key] for r in both) for key in keys}
    conv_sum["bound_by"] = ("operations" if sum(r["bound_by"] == "operations"
                                                for r in both) else "bytes")
    return [
        dict(name="sliding_conv1d", route="cuda",
             source="src/repro_torch/kernels/csrc/sliding_conv1d.cu",
             replaces="src/repro/kernels/sliding_conv1d.py:235",
             launches=launches["sliding_conv1d"],
             max_abs_err=errs["sliding_conv1d"],
             per="prefill: conv1 80->1024 s1 + conv2 1024->1024 s2, B=4 L=514 f32",
             **conv_sum),
        dict(name="attention_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/attention_decode.cu",
             replaces="src/repro/kernels/attention_decode.py:144",
             launches=launches["attention_decode"],
             max_abs_err=errs["attention_decode"],
             per="launch: B=4 S=288 KV=16 G=1 D=64 bf16, lengths 256",
             **{key: attn[key] for key in keys + ("bound_by",)}),
    ]


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch import configs, models
    from repro_torch.distributed.sharding import map_tree
    from repro_torch.kernels import attention_decode as ad
    from repro_torch.kernels import build
    from repro_torch.kernels import sliding_conv1d as sc
    from repro_torch.launch import serve

    repro_torch.resolve_device("cuda")  # full float32: TF32 off
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f}s")
    for name in sorted(libs):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # -- 3-6 --------------------------------------------------------------------
    errs = phase_kernels(sc, ad)
    phase_smoke_serve(serve, models, configs, map_tree)
    full = phase_full_serve(serve, models, configs, sc, ad, map_tree)
    kernels = phase_times(sc, ad, full["launches"], errs)
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels, "serve": full}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
