"""The port's observability layer (``repro_torch.obs``) on the CPU.

The port's copy of each of ``tests/test_obs.py``'s tests: deterministic
histogram quantiles, snapshot round-trips, Chrome-trace validity, the
near-zero disarmed path, the health mirror, the dispatch logs, and the
instrumented dispatch, serve, train and report surfaces (the dispatch test
recast on the ``ops`` entry points, whose rung is ``plain`` on a CPU
tensor). Then parity with the reference: the same name vocabularies, the
same quantiles from the same counts, and each package's report rendering
the other's ``metrics.json``.
"""
import argparse
import inspect
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.health import HEALTH  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.metrics import (  # noqa: E402
    BOUNDS, REGISTRY, DispatchLog, hist_quantile,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_obs():
    """Each test sees a fresh registry, an empty trace ring and both arm
    flags off; the process-global state is restored afterwards."""
    REGISTRY.reset()
    obs_trace.clear()
    was_tracing = obs_trace.TRACING
    was_dispatch = obs_metrics.DISPATCH_ON
    obs_trace.disable()
    obs_metrics.enable_dispatch(False)
    yield
    REGISTRY.reset()
    obs_trace.clear()
    obs_trace.enable(was_tracing)
    obs_metrics.enable_dispatch(was_dispatch)
    HEALTH.reset()


def _cli_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


# -- histogram quantile determinism -------------------------------------------

def test_hist_quantile_is_deterministic_function_of_counts():
    counts = [0] * (len(BOUNDS) + 1)
    counts[BOUNDS.index(5e-3)] = 10
    counts[BOUNDS.index(2e-2)] = 10
    # p50: the 10th observation fills the first bucket, its upper bound
    assert hist_quantile(BOUNDS, counts, 0.5) == pytest.approx(5e-3)
    # p75: the 15th, halfway through the second bucket
    assert hist_quantile(BOUNDS, counts, 0.75) == pytest.approx(
        1e-2 + (2e-2 - 1e-2) * 0.5)


def test_hist_quantile_edges():
    empty = [0] * (len(BOUNDS) + 1)
    assert hist_quantile(BOUNDS, empty, 0.99) == 0.0
    overflow = [0] * (len(BOUNDS) + 1)
    overflow[-1] = 5  # all in +Inf: saturates at the last finite bound
    assert hist_quantile(BOUNDS, overflow, 0.5) == BOUNDS[-1]


def test_histogram_observe_quantile_and_sums():
    h = REGISTRY.histogram("serve.decode_step_s")
    for v in (0.0015, 0.0015, 0.003, 0.03, 0.4):
        h.observe(v, arch="a")
    assert h.count(arch="a") == 5
    assert h.sum(arch="a") == pytest.approx(0.436)
    assert h.quantile(0.5, arch="a") == pytest.approx(0.0035)
    assert h.quantile(0.95, arch="a") == pytest.approx(0.425)
    assert h.count(arch="b") == 0


# -- name vocabulary enforcement ----------------------------------------------

def test_registry_rejects_unknown_metric_names():
    with pytest.raises(ValueError, match="unknown metric name"):
        REGISTRY.counter("serve.not_a_metric")
    with pytest.raises(ValueError, match="unknown metric name"):
        REGISTRY.histogram("dispatch.bogus")


def test_registry_rejects_kind_collisions():
    REGISTRY.counter("serve.requests")
    with pytest.raises(TypeError, match="already registered as counter"):
        REGISTRY.gauge("serve.requests")


def test_span_rejects_unknown_names_when_armed():
    obs_trace.enable()
    with pytest.raises(ValueError, match="unknown span name"):
        obs.span("serve.not_a_span")
    obs_trace.disable()  # traced() checks at decoration, armed or not
    with pytest.raises(ValueError, match="unknown span name"):
        obs.traced("nope.nope")


# -- snapshot round-trip ------------------------------------------------------

def test_snapshot_write_load_roundtrip(tmp_path):
    REGISTRY.counter("dispatch.calls").inc(3.0, site="conv1d", rung="cuda")
    REGISTRY.gauge("serve.kv_cache_bytes").set(1024.0, kind="served")
    h = REGISTRY.histogram("serve.ttft_s")
    h.observe(0.12, arch="whisper-medium")
    REGISTRY.facts("serve.run").set("arch", "whisper-medium")

    path = REGISTRY.write(tmp_path / "fresh" / "run")  # made on the way
    snap = obs_metrics.Registry.load(path)
    assert snap["schema"] == obs_metrics.SCHEMA == 1
    assert snap["bounds"] == list(BOUNDS)
    assert snap["counters"]["dispatch.calls"] == [
        {"labels": {"rung": "cuda", "site": "conv1d"}, "value": 3.0}]
    g = snap["gauges"]["serve.kv_cache_bytes"][0]
    assert g["labels"] == {"kind": "served"} and g["value"] == 1024.0
    hs = snap["histograms"]["serve.ttft_s"][0]
    assert hs["count"] == 1 and hs["sum"] == pytest.approx(0.12)
    assert hist_quantile(snap["bounds"], hs["buckets"], 0.5) == pytest.approx(
        h.quantile(0.5, arch="whisper-medium"))
    assert snap["facts"]["serve.run"]["arch"] == "whisper-medium"


def test_prometheus_exposition_shape():
    REGISTRY.counter("serve.requests").inc(2.0, arch="a")
    REGISTRY.histogram("serve.ttft_s").observe(0.0015, arch="a")
    text = REGISTRY.to_prometheus()
    assert "# TYPE repro_serve_requests counter" in text
    assert 'repro_serve_requests{arch="a"} 2' in text
    assert "# TYPE repro_serve_ttft_s histogram" in text
    assert 'repro_serve_ttft_s_bucket{arch="a",le="+Inf"} 1' in text
    assert 'repro_serve_ttft_s_count{arch="a"} 1' in text


# -- tracing ------------------------------------------------------------------

def test_trace_spans_nest_and_export_valid_chrome_json(tmp_path):
    obs_trace.enable()
    with obs.span("serve.generate", arch="a"):
        with obs.span("serve.prefill", arch="a"):
            time.sleep(0.002)
        obs.instant("health.event", site="serve/slot", reason="nan_logits",
                    action="quarantine")
    doc = json.load(open(obs_trace.export(tmp_path / "trace.json")))
    evs = doc["traceEvents"]
    # spans record on exit: the inner one closes first
    assert [e["name"] for e in evs] == [
        "serve.prefill", "health.event", "serve.generate"]
    prefill, inst, gen = evs
    assert prefill["ph"] == "X" and gen["ph"] == "X" and inst["ph"] == "i"
    assert gen["ts"] <= prefill["ts"]
    assert gen["ts"] + gen["dur"] >= prefill["ts"] + prefill["dur"]
    assert prefill["dur"] >= 2_000  # slept 2 ms; microseconds
    assert inst["args"]["reason"] == "nan_logits"
    for e in evs:
        assert {"name", "ph", "pid", "tid", "ts"} <= set(e)


def test_disabled_span_is_shared_null_and_records_nothing():
    s1 = obs.span("serve.generate")
    s2 = obs.span("kernel.dispatch", site="conv1d")
    assert s1 is s2  # one shared null context manager
    with s1:
        pass
    obs.instant("health.event", site="serve/slot", reason="nan_logits",
                action="quarantine")
    assert obs_trace.events() == []


def test_disabled_span_overhead_is_flag_check_cheap():
    """Disarmed, span() is one module-global flag check: 200k calls stay
    far under any instrumented site's real work (a bound loose enough
    for a loaded machine)."""
    t0 = time.perf_counter()
    for _ in range(200_000):
        obs.span("serve.decode_step")
    dt = time.perf_counter() - t0
    assert dt < 2.0, f"disabled span() too slow: {dt:.3f}s / 200k calls"


def test_disarmed_dispatch_is_flag_check_cheap():
    """The ops entries' dispatch record, disarmed, adds one flag check to a
    call: 200k calls of ``_dispatch`` on a trivial thunk stay cheap and
    record nothing."""
    x = torch.zeros(1)
    t0 = time.perf_counter()
    for _ in range(200_000):
        tops._dispatch("pool1d", "k", (x,), lambda: x)
    dt = time.perf_counter() - t0
    assert dt < 2.0, f"disarmed _dispatch too slow: {dt:.3f}s / 200k calls"
    assert REGISTRY.snapshot()["counters"] == {} and obs_trace.events() == []


# -- health mirror ------------------------------------------------------------

def test_health_record_mirrors_counter_and_trace_instant():
    obs_trace.enable()
    HEALTH.reset()
    HEALTH.record("serve/slot", "nan_logits", "quarantine", "boom")
    HEALTH.record("serve/slot", "nan_logits", "quarantine")
    c = REGISTRY.counter("health.events")
    assert c.value(site="serve/slot", reason="nan_logits",
                   action="quarantine") == 2.0
    insts = [e for e in obs_trace.events() if e["name"] == "health.event"]
    assert len(insts) == 2
    assert insts[0]["args"] == {"site": "serve/slot", "reason": "nan_logits",
                                "action": "quarantine"}
    assert len(HEALTH.events) == 1 and HEALTH.events[0].count == 2


# -- DispatchLog --------------------------------------------------------------

def test_unnamed_dispatch_log_stays_pure_mapping():
    log = DispatchLog()
    log["k"] = "cuda"
    log["k"] = "plain"
    assert log["k"] == "plain" and log.count("k") == 2
    snap = REGISTRY.snapshot()
    assert snap["counters"] == {} and snap["facts"] == {}


def test_named_dispatch_log_mirrors_into_registry():
    key = "attn_dec|B2|S24|KV24|G1|D64|int8"
    log = DispatchLog("attn_decode")
    log[key] = "cuda"
    log[key] = "cuda"
    c = REGISTRY.counter("dispatch.log_calls")
    assert c.value(log="attn_decode", key=key) == 2.0
    facts = REGISTRY.facts("dispatch.attn_decode")
    assert facts.get(key) == "cuda"
    log.clear()
    assert c.series() == [] and facts.items() == []


def test_ops_logs_are_the_moved_class():
    """``ops`` keeps its five logs as instances of ``obs.metrics``'
    ``DispatchLog``; only the attention log is named, as the reference's."""
    logs = (tops.ATTN_DECODE_DISPATCH, tops.CONV1D_DW_DISPATCH,
            tops.CONV2D_DISPATCH, tops.CONV2D_QUANT_DISPATCH,
            tops.POOL1D_DISPATCH)
    assert all(type(lg) is DispatchLog for lg in logs)
    assert [lg._name for lg in logs] == ["attn_decode"] + [None] * 4
    assert not hasattr(tops, "DispatchLog") or tops.DispatchLog is DispatchLog


# -- kernel dispatch instrumentation ------------------------------------------

def _attn_inputs(rng, B=2, S=24, KV=2, G=2, D=32):
    q = torch.from_numpy(rng.normal(size=(B, KV * G, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    return q, k, v, torch.tensor([5, S], dtype=torch.int32)


def test_ladder_records_dispatch_metrics_and_spans(rng):
    """The reference's ``_ladder`` test on ``ops.attention_decode``: off,
    nothing is recorded; armed, one call is one ``kernel.dispatch`` span
    and one count under its shape key, rung ``plain``, with the bytes of
    q, k, v and the output, and the result is unchanged."""
    q, k, v, lengths = _attn_inputs(rng)
    y_off = tops.attention_decode(q, k, v, lengths=lengths)
    assert REGISTRY.snapshot()["counters"].keys() <= {"dispatch.log_calls"}
    assert obs_trace.events() == []

    obs_metrics.enable_dispatch()
    obs_trace.enable()
    y_on = tops.attention_decode(q, k, v, lengths=lengths)
    torch.testing.assert_close(y_on, y_off, rtol=0, atol=0)

    calls = REGISTRY.counter("dispatch.calls").series()
    assert len(calls) == 1
    labels, n = calls[0]
    assert n == 1.0
    assert labels == {"site": "attention_decode", "rung": "plain",
                      "key": "attn_dec|B2|S24|KV2|G2|D32|float32"}
    assert REGISTRY.counter("dispatch.seconds_total").value(**labels) > 0.0
    hbm = REGISTRY.counter("dispatch.est_hbm_bytes_total").value(**labels)
    # q and the output (2, 4, 32), k and v (2, 24, 2, 32), float32
    assert hbm == (2 * 2 * 4 * 32 + 2 * 2 * 24 * 2 * 32) * 4.0
    spans = [e for e in obs_trace.events() if e["name"] == "kernel.dispatch"]
    assert len(spans) == 1 and spans[0]["args"] == labels


def _entry_cases(rng):
    """Each instrumented entry, its site and its key, at a small shape."""
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x1, w1 = f(2, 18, 8), f(3, 8, 16)
    xd, wd = f(2, 16, 12), f(4, 12)
    x2, w2 = f(1, 9, 10, 3), f(3, 3, 3, 5)
    xp = f(2, 20, 4)
    return {
        "conv1d": (lambda: tops.conv1d(x1, w1, backend="sliding_pallas"),
                   "conv1d", "conv1d|B2|L18|Cin8|Cout16|K3|s1|float32"),
        "conv1d_w8a8": (lambda: tops.conv1d(x1, w1, backend="sliding_pallas",
                                            precision="w8a8"),
                        "conv1d.w8a8", "conv1d|B2|L18|Cin8|Cout16|K3|s1|w8a8"),
        "conv1d_depthwise": (lambda: tops.conv1d_depthwise(xd, wd),
                             "conv1d_depthwise",
                             "conv1ddw|B2|L19|C12|K4|s1|float32"),
        "conv1d_depthwise_w8a8": (
            lambda: tops.conv1d_depthwise(xd, wd, precision="w8a8"),
            "conv1d_depthwise.w8a8", "conv1ddw|B2|L19|C12|K4|s1|w8a8"),
        "conv2d": (lambda: tops.conv2d(x2, w2), "conv2d",
                   "conv2d|B1|H9|W10|Cin3|Cout5|K3x3|s1x1|float32"),
        "conv2d_w8a8": (lambda: tops.conv2d(x2, w2, precision="w8a8"),
                        "conv2d.w8a8",
                        "conv2d|B1|H9|W10|Cin3|Cout5|K3x3|s1x1|w8a8"),
        "pool1d": (lambda: tops.pool1d(xp, window=4, op="max"), "pool1d",
                   "pool1d|B2|L20|C4|w4|max|float32"),
    }


@pytest.mark.parametrize("entry", sorted(_entry_cases(np.random.default_rng(0))))
def test_each_entry_records_its_dispatch(entry, rng):
    """Every ops entry that picks a kernel records it under the
    reference's site name and autotune key (rung ``plain`` here), once a
    call, armed by the dispatch metrics alone; disarmed, nothing."""
    call, site, key = _entry_cases(rng)[entry]
    off = call()
    assert "dispatch.calls" not in REGISTRY.snapshot()["counters"]
    obs_metrics.enable_dispatch()
    on = call()
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    (labels, n), = REGISTRY.counter("dispatch.calls").series()
    assert labels == {"site": site, "key": key, "rung": "plain"} and n == 1.0
    assert REGISTRY.counter("dispatch.est_hbm_bytes_total").value(**labels) > 0
    assert obs_trace.events() == []  # metrics armed, tracing not


# -- serve smoke --------------------------------------------------------------

def test_serve_generate_populates_metrics(rng):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = smoke_config(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(2, 16)),
                              dtype=torch.int32)
    toks, done = generate(model, params, prompts, gen_len=4, cache_len=24)
    assert toks.shape == (2, 4)

    arch = cfg.name
    assert REGISTRY.counter("serve.requests").value(arch=arch) == 1.0
    assert REGISTRY.counter("serve.tokens_generated").value(arch=arch) == 8.0
    assert REGISTRY.histogram("serve.ttft_s").count(arch=arch) == 1
    assert REGISTRY.histogram("serve.prefill_s").count(arch=arch) == 1
    # the first token falls out of prefill; gen_len-1 decode steps follow
    assert REGISTRY.histogram("serve.decode_step_s").count(arch=arch) == 3
    assert REGISTRY.histogram("serve.request_s").count(arch=arch) == 1
    assert REGISTRY.gauge("serve.slots_total").value(arch=arch) == 2.0
    occ = REGISTRY.gauge("serve.slot_occupancy").value(arch=arch)
    assert occ is not None and 0.0 <= occ <= 1.0
    kv = REGISTRY.gauge("serve.kv_cache_bytes").value(kind="served")
    assert kv is not None and kv > 0


def test_generate_uses_monotonic_clock():
    from repro_torch.launch import serve

    src = inspect.getsource(serve._generate_once)
    assert "time.time()" not in src, "wall clock in the decode loop"
    assert "time.perf_counter()" in src


def test_serve_histograms_equal_the_stats_dict(rng):
    """``serve.prefill`` and ``serve.decode_step`` close after the
    synchronise that ends each, so the histograms hold the ``stats``
    values: one TTFT, one entry per decode step, equal sums."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = smoke_config(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(2, 8)),
                              dtype=torch.int32)
    obs_trace.enable()
    stats = {}
    generate(model, params, prompts, gen_len=5, cache_len=16, stats=stats)
    steps = REGISTRY.histogram("serve.decode_step_s")
    assert steps.count(arch=cfg.name) == len(stats["step_s"]) == 4
    assert steps.sum(arch=cfg.name) == pytest.approx(sum(stats["step_s"]))
    assert REGISTRY.histogram("serve.ttft_s").sum(arch=cfg.name) == (
        stats["ttft_s"])
    names = [e["name"] for e in obs_trace.events()]
    assert names.count("serve.decode_step") == 4
    assert names.count("serve.prefill") == names.count("serve.generate") == 1


# -- train smoke --------------------------------------------------------------

def _train_args(tmp_path, **over):
    d = dict(
        arch="qwen3-1.7b", smoke=True, steps=3, batch=2, seq=64,
        lr=3e-4, seed=0, run_dir=str(tmp_path), ckpt_every=2, log_every=100,
        grad_accum=1, conv_backend=None, audio_frontend="stub",
        no_resume=True, fail_at=None, max_restarts=0, device="cpu",
    )
    d.update(over)
    return argparse.Namespace(**d)


def test_train_loop_populates_metrics_and_artifacts(tmp_path):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.train import train_loop

    out = train_loop(_train_args(tmp_path))
    assert len(out["losses"]) == 3
    arch = smoke_config(get_config("qwen3-1.7b")).name
    assert REGISTRY.counter("train.steps").value(arch=arch) == 3.0
    assert REGISTRY.counter("train.tokens").value(arch=arch) == 3 * 2 * 64.0
    assert REGISTRY.histogram("train.step_s").count(arch=arch) == 3
    # one async save at step 2 and the blocking final save
    assert REGISTRY.histogram("train.ckpt_save_s").count(arch=arch) == 2
    assert REGISTRY.gauge("train.loss").value(arch=arch) == pytest.approx(
        out["losses"][-1])
    tps = REGISTRY.gauge("train.tokens_per_s").value(arch=arch)
    assert tps is not None and tps > 0
    snap = json.load(open(tmp_path / "metrics.json"))
    assert "train.step_s" in snap["histograms"]
    assert not (tmp_path / "trace.json").exists()  # tracing is off


# -- report CLI ---------------------------------------------------------------

def test_report_rebuilds_serve_summary_from_artifacts(tmp_path):
    run = REGISTRY.facts("serve.run")
    run.set("arch", "whisper-medium")
    run.set("shape", (2, 8))
    run.set("elapsed_s", "1.50")
    run.set("tok_per_s", "10.7")
    run.set("recyclable", 0)
    run.set("batch", 2)
    run.set("eos_id", 50257)
    run.set("sample", "[1 2 3]")
    key = "attn_dec|B2|S24|KV24|G1|D64|int8"
    REGISTRY.facts("dispatch.attn_decode").set(key, "cuda")
    REGISTRY.counter("dispatch.log_calls").inc(8.0, log="attn_decode", key=key)
    REGISTRY.gauge("serve.kv_cache_bytes").set(1000.0, kind="served")
    REGISTRY.gauge("serve.kv_cache_bytes").set(2400.0, kind="fp")
    for v in (0.01, 0.02, 0.03):
        REGISTRY.histogram("serve.decode_step_s").observe(v, arch="whisper-medium")
    REGISTRY.counter("health.events").inc(
        1.0, site="serve/slot", reason="nan_logits", action="quarantine")
    obs.write_artifacts(tmp_path)

    text = "\n".join(obs_report.render(tmp_path))
    assert ("[serve] generated (2, 8) in 1.50s (10.7 tok/s); "
            "0/2 slots recyclable (eos=50257)") in text
    assert f"[serve] attn-decode: impl=cuda key={key} calls=8" in text
    assert "[serve] kv-cache bytes: 1000 (fp 2400, ratio 2.40x)" in text
    assert "[serve] sample: [1 2 3]" in text
    assert "health: site=serve/slot reason=nan_logits action=quarantine" in text
    assert "decode-step" in text

    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", str(tmp_path)],
        capture_output=True, text=True, env=_cli_env())
    assert proc.returncode == 0, proc.stderr
    assert "kv-cache bytes: 1000" in proc.stdout
    missing = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report",
         str(tmp_path / "none")], capture_output=True, text=True,
        env=_cli_env())
    assert missing.returncode == 1 and "no metrics.json" in missing.stderr


# -- leveled logging ----------------------------------------------------------

def test_log_levels_and_format(capsys):
    from repro_torch.obs import logs

    old = logs.level()
    try:
        logs.set_level("info")
        obs.debug("serve", "hidden")
        obs.info("serve", "shown")
        obs.warn("ft", "also shown")
        out = capsys.readouterr().out
        assert "[serve] shown\n" in out and "[ft] also shown\n" in out
        assert "hidden" not in out
        logs.set_level("warn")
        obs.info("serve", "now hidden")
        assert "now hidden" not in capsys.readouterr().out
    finally:
        logs.set_level(old)


# -- parity with the reference -------------------------------------------------

def test_names_equal_the_reference():
    from repro.obs import names as jnames

    assert obs.names.METRICS == jnames.METRICS
    assert obs.names.SPANS == jnames.SPANS


def test_hist_quantile_equals_the_reference():
    from repro.obs import metrics as jmetrics

    assert tuple(BOUNDS) == tuple(jmetrics.BOUNDS)
    assert obs_metrics.SCHEMA == jmetrics.SCHEMA
    counts_rng = np.random.default_rng(7)
    for _ in range(20):
        counts = [int(c) for c in counts_rng.integers(
            0, 5, size=len(BOUNDS) + 1) * (counts_rng.random(
                len(BOUNDS) + 1) < 0.4)]
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert hist_quantile(BOUNDS, counts, q) == jmetrics.hist_quantile(
                jmetrics.BOUNDS, counts, q)


# CI's traced serve smoke (.github/workflows/ci.yml), with two requests
CI_SERVE = ["--arch", "whisper-medium", "--smoke", "--batch", "2",
            "--prompt-len", "16", "--gen", "8", "--kv-quant", "int8",
            "--requests", "2"]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The reference's and the port's traced serve CLIs on CI's command,
    each in its own process. The reference's journal writes before
    anything makes its run directory, so its directory is made first."""
    base = tmp_path_factory.mktemp("obs_runs")
    runs = {}
    for pkg, extra in (("repro", []), ("repro_torch", ["--device", "cpu"])):
        run_dir = base / pkg
        if pkg == "repro":
            run_dir.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.serve", *CI_SERVE,
             "--run-dir", str(run_dir), *extra],
            capture_output=True, text=True, timeout=600,
            env=_cli_env(REPRO_TRACE="1", JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[pkg] = (run_dir, proc.stdout)
    return runs


def _render_with(pkg, run_dir):
    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.obs", "report", str(run_dir)],
        capture_output=True, text=True, timeout=120,
        env=_cli_env(JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_report_renders_the_other_packages_run(both_runs, writer):
    """A ``metrics.json`` written by either package's traced serve renders
    the same lines in both packages' reports, and the serve lines there
    are those the writing CLI printed (its "generated" line with the
    request count, which the report does not keep)."""
    run_dir, stdout = both_runs[writer]
    reader = "repro_torch" if writer == "repro" else "repro"
    lines = obs_report.render(run_dir)
    assert lines == _render_with(reader, run_dir)
    assert lines == _render_with("repro_torch", run_dir)
    printed = stdout.replace(" x2 in ", " in ").splitlines()
    serve = [ln for ln in lines if ln.startswith("[serve]")
             and not ln.startswith(("[serve] ttft:", "[serve] decode-step:"))]
    assert len(serve) == 4  # generated, attn-decode, kv-cache bytes, sample
    for ln in serve:
        assert ln in printed, ln
    for needle in ("generated", "attn-decode:", "kv-cache bytes:",
                   "decode-step"):
        assert any(needle in ln for ln in lines), needle


def test_both_runs_agree_on_everything_but_impl_and_timing(both_runs):
    """The two snapshots carry the same series: the same metric names,
    labels, histogram counts, attention key and cache bytes; the values
    that differ are the timings, the impl names and the eager call count
    (the reference counts traces)."""
    snaps = {pkg: json.load(open(run_dir / "metrics.json"))
             for pkg, (run_dir, _) in both_runs.items()}
    ref, port = snaps["repro"], snaps["repro_torch"]
    assert ref["schema"] == port["schema"] == 1
    for kind in ("counters", "gauges", "histograms", "facts"):
        assert sorted(ref[kind]) == sorted(port[kind]), kind
    for name, series in ref["histograms"].items():
        assert ([s["count"] for s in series]
                == [s["count"] for s in port["histograms"][name]]), name
    assert ref["gauges"]["serve.kv_cache_bytes"] == (
        port["gauges"]["serve.kv_cache_bytes"])
    assert sorted(ref["facts"]["dispatch.attn_decode"]) == sorted(
        port["facts"]["dispatch.attn_decode"]) == [
        "attn_dec|B2|S24|KV2|G2|D32|int8"]
    assert set(port["facts"]["dispatch.attn_decode"].values()) == {"plain"}
    lab = lambda s: {k: v for k, v in s["labels"].items() if k != "rung"}  # noqa: E731
    assert ([lab(s) for s in ref["counters"]["dispatch.calls"]]
            == [lab(s) for s in port["counters"]["dispatch.calls"]])
