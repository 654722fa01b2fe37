"""The port's tuning layer (``repro_torch.kernels.autotune``) against the
reference's (``repro.kernels.autotune``) where the reference is plain
Python: the shape keys, the cache's load, quarantine and flush, ``_search``
under an injected timer, the measured quant-regression guard and the pool
method's tuned rung; then the port's own parts on the CPU: the plan
functions with nothing forced equal the rules as they were before any
plan could be forced, every candidate a search would time is a plan the
kernels take, ``ops`` resolves explicit → tuned → rule at every entry, and
a search refuses CPU tensors. The reference's interpret-mode searches are
not run: its Pallas kernels do not trace under jax 0.9.0."""
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import health as jhealth  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import health as thealth  # noqa: E402
from repro_torch.kernels import attention_decode as tad  # noqa: E402
from repro_torch.kernels import autotune as tat  # noqa: E402
from repro_torch.kernels import gemm_plan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_conv2d as ts2  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tsb  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's cache in a file of its own under tmp_path, both
    caches dropped from memory before and after."""
    ref = tmp_path / "ref" / "autotune.json"
    port = tmp_path / "port" / "autotune_cuda.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(ref))
    monkeypatch.setenv(tat.ENV_CACHE, str(port))
    jat.invalidate()
    tat.invalidate()
    yield ref, port
    jat.invalidate()
    tat.invalidate()


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


# ---------------------------------------------------------------------------
# keys and cache


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("args", [
    (1, 16384, 32, 32, 3, 1, "float32"), (4, 514, 1024, 1024, 3, 2,
                                          "bfloat16"),
    (2, 7, 5, 3, 1, 3, "w8a8")])
def test_conv1d_keys_match_reference(args, grad):
    assert tat.conv1d_key(*args, grad=grad) == jat.conv1d_key(*args,
                                                               grad=grad)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("args", [
    (1, 128, 128, 32, 32, 31, 31, 1, 1, "float32"),
    (20, 336, 336, 3, 1152, 14, 14, 14, 14, "bfloat16"),
    (2, 9, 11, 5, 7, 3, 2, 2, 1, "w8a16")])
def test_conv2d_keys_match_reference(args, grad):
    assert tat.conv2d_key(*args, grad=grad) == jat.conv2d_key(*args,
                                                               grad=grad)


@pytest.mark.parametrize("args", [(4, 259, 16384, 4, 1, "bfloat16"),
                                  (2, 515, 16384, 4, 2, "w8a8")])
def test_depthwise_keys_match_reference(args):
    assert tat.conv1d_dw_key(*args) == jat.conv1d_dw_key(*args)


@pytest.mark.parametrize("args", [(2, 2048, 2, 2, 32, "int8"),
                                  (4, 3168, 8, 7, 128, "bfloat16")])
def test_attention_keys_match_reference(args):
    assert tat.attn_dec_key(*args) == jat.attn_dec_key(*args)


@pytest.mark.parametrize("args", [(1, 16384, 32, 4, "max", "float32"),
                                  (8, 300, 7, 256, "sum", "bfloat16")])
def test_pool_keys_match_reference(args):
    assert tat.pool1d_key(*args) == jat.pool1d_key(*args)


def _events(h, site="autotune"):
    return [(e.site, e.reason, e.action) for e in h.HEALTH.events
            if e.site == site]


@pytest.mark.parametrize("body,reason", [
    ("{\"conv1d|B1", "cache_corrupt"),
    ("[1, 2, 3]", "cache_corrupt"),
    ("\x00\xff garbage", "cache_corrupt"),
    (json.dumps({"__schema__": 2, "k": {"us": 1.0}}), "cache_schema_mismatch"),
])
def test_quarantine_matches_reference(caches, body, reason):
    """The same bad bytes are moved to ``<name>.corrupt`` by both packages,
    each recording the same (site, reason, action) and reading an empty
    cache."""
    jhealth.HEALTH.reset()
    thealth.HEALTH.reset()
    for path in caches:
        _write(path, body)
    assert jat.lookup("k") is None and tat.lookup("k") is None
    for path in caches:
        assert not path.exists()
        assert path.with_name(path.name + ".corrupt").read_text() == body
    assert _events(jhealth) == _events(thealth) == [
        ("autotune", reason, "quarantine")]
    jhealth.HEALTH.reset()
    thealth.HEALTH.reset()


def test_unversioned_cache_is_accepted_and_reserved_keys_hidden(caches):
    """A file with no ``__schema__`` loads (legacy schema 1) in both; a
    port file's ``__schema__`` and ``__card__`` never come out of
    ``lookup``, and a flush writes both back."""
    ref, port = caches
    entry = {"tile": "narrow", "splits": 3, "us": 5.0, "default_us": 6.0}
    _write(ref, {"k": {"tile_l": 64, "us": 5.0}})
    _write(port, {"k": entry})
    assert jat.lookup("k") == {"tile_l": 64, "us": 5.0}
    assert tat.lookup("k") == entry
    assert ref.exists() and port.exists()
    tat.invalidate()
    _write(port, {"__schema__": 1, "__card__": {"name": "x", "sms": 1},
                  "k": entry})
    assert tat.lookup("__schema__") is None
    assert tat.lookup("__card__") is None
    assert tat.lookup("k") == entry
    tat.record("k2", {"method": "shift", "us": 1.0, "default_us": 2.0})
    on_disk = json.loads(port.read_text())
    assert on_disk["__schema__"] == tat.SCHEMA_VERSION
    assert set(on_disk["__card__"]) == {"name", "sms"}
    assert on_disk["k"] == entry and on_disk["k2"]["method"] == "shift"


def test_env_isolates_cache_and_flush_renames_a_per_process_temp(
        tmp_path, monkeypatch):
    """Entries recorded under one ``REPRO_TORCH_AUTOTUNE_CACHE`` are not
    seen under another, come back when it is set again, and never reach
    the reference's file; a change of the variable takes effect at
    ``invalidate()``; each write goes through ``.<name>.<pid>.tmp``."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    renamed = []
    real_replace = Path.replace

    def replace(self, target):
        renamed.append((self.name, Path(target).name))
        return real_replace(self, target)

    monkeypatch.setattr(Path, "replace", replace)
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    try:
        monkeypatch.setenv(tat.ENV_CACHE, str(a))
        tat.invalidate()
        tat.record("k", {"split_rows": 64, "us": 1.0, "default_us": 2.0})
        assert renamed == [(".a.json.4242.tmp", "a.json")]
        assert not (tmp_path / ".a.json.4242.tmp").exists()
        monkeypatch.setenv(tat.ENV_CACHE, str(b))
        assert tat.lookup("k")["split_rows"] == 64  # a's, until invalidate
        tat.invalidate()
        assert tat.lookup("k") is None
        monkeypatch.setenv(tat.ENV_CACHE, str(a))
        tat.invalidate()
        assert tat.lookup("k")["split_rows"] == 64
        assert not (tmp_path / "ref.json").exists()
        assert tat.cache_path() == a
        monkeypatch.delenv(tat.ENV_CACHE)
        assert tat.cache_path() == Path(".cache/autotune_cuda.json")
    finally:
        tat.invalidate()


# ---------------------------------------------------------------------------
# the search


def _counter(metrics, name, key):
    return metrics.REGISTRY.counter(name).value(key=key)


@pytest.mark.parametrize("times", [
    [5.0, 4.0, 6.0, 3.0, 3.5],     # a later candidate wins
    [2.0, 4.0, 6.0, 3.0, 3.5],     # the default stays
    [5.0, 5.0, 5.0, 5.0, 5.0],     # ties keep the earlier plan
])
def test_search_matches_reference(caches, monkeypatch, times):
    """Both ``_search``s, given the same candidates and the same injected
    timings and no cost model, pick the same winner with the same ``us``,
    ``default_us`` and ``timed``, record it, and count the same
    ``autotune.*`` increments; a candidate whose plan is refused is
    skipped untimed by both."""
    default = {"splits": 1}
    cands = [{"splits": 1}, {"splits": 2}, {"splits": 3}, {"splits": 99},
             {"splits": 4}, {"splits": 6}]

    def run(cfg):
        if cfg["splits"] == 99:
            raise gemm_plan.PlanError("refused")
        return cfg["splits"]

    def timer(seq):
        it = iter(seq)

        def time_fn(fn, **_kw):
            fn()
            return next(it) * 1e-6
        return time_fn

    key = "conv1d|B1|L64|Cin4|Cout4|K3|s1|float32|search"
    before = [(_counter(m, "autotune.searches", key),
               _counter(m, "autotune.candidates", key))
              for m in (jmetrics, tmetrics)]
    monkeypatch.setattr(jat, "_time_fn", timer(times))
    monkeypatch.setattr(tat, "_time_fn", timer(times))
    jr = jat._search(key, run, cands, default)
    tr = tat._search(key, run, cands, default)
    assert tr.best == jr.best
    assert (tr.default_us, tr.best_us, tr.timed) == (jr.default_us,
                                                     jr.best_us, jr.timed)
    assert tr.timed == 5 and not tr.ranked and tr.pruned == 0 \
        and tr.cost_skipped == 0
    assert tr.best["us"] <= tr.best["default_us"]
    assert tat.lookup(key) == tr.best and jat.lookup(key) == jr.best
    after = [(_counter(m, "autotune.searches", key),
              _counter(m, "autotune.candidates", key))
             for m in (jmetrics, tmetrics)]
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == \
        [(1.0, 5.0)] * 2


def test_search_lets_other_errors_through(caches, monkeypatch):
    """Only a refused plan is skipped: any other error (a fault on the
    card) propagates."""
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])

    def run(cfg):
        if cfg["splits"] == 2:
            raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal"):
        tat._search("k", run, [{"splits": 2}], {"splits": 1})


@pytest.mark.parametrize("search,args", [
    (tat.autotune_conv1d, ((1, 64, 4), (3, 4, 4))),
    (tat.autotune_conv2d, ((1, 8, 8, 4), (3, 3, 4, 4))),
    (tat.autotune_conv1d_depthwise, ((1, 64, 4), (3, 4))),
    (tat.autotune_conv1d_grad, ((1, 64, 4), (3, 4, 4))),
    (tat.autotune_conv2d_grad, ((1, 8, 8, 4), (3, 3, 4, 4))),
])
def test_search_refuses_cpu_tensors(caches, search, args):
    """The plain versions take no plan: there is nothing to time."""
    with pytest.raises(ValueError, match="CUDA"):
        search(*(torch.zeros(s) for s in args))


def test_attention_and_pool_searches_refuse_cpu_tensors(caches):
    q, k = torch.zeros(1, 2, 8), torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tat.autotune_attention_decode(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tat.autotune_pool1d(torch.zeros(1, 64, 4), window=4)


# ---------------------------------------------------------------------------
# the quant guard and the pool rung


def _record_both(key_fields: dict) -> None:
    for key, entry in key_fields.items():
        jat.record(key, entry)
        tat.record(key, entry)


@pytest.mark.parametrize("us_q,us_f", [(50.0, 40.0), (30.0, 40.0),
                                       (40.0, 40.0), (None, 40.0),
                                       (50.0, None)])
@pytest.mark.parametrize("precision", ["w8a8", "w8a16"])
def test_quant_fallback_reason_matches_reference(caches, us_q, us_f,
                                                 precision):
    """The same cache entries give the same answer and the same string;
    a fallback records one ``quant_slower`` event a key in each."""
    B, L, Cin, Cout, K, stride = 1, 64, 4, 6, 3, 1
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, L, Cin)).astype(np.float32)
    w = rng.normal(size=(K, Cin, Cout)).astype(np.float32)
    entries = {}
    if us_q is not None:
        entries[tat.conv1d_key(B, L, Cin, Cout, K, stride, precision)] = {
            "us": us_q, "default_us": us_q}
    if us_f is not None:
        entries[tat.conv1d_key(B, L, Cin, Cout, K, stride, "float32")] = {
            "us": us_f, "default_us": us_f}
    _record_both(entries)
    jops._QUANT_FALLBACKS.clear()
    tops._QUANT_FALLBACKS.clear()
    jhealth.HEALTH.reset()
    thealth.HEALTH.reset()
    for _ in range(2):
        want = jops._quant_fallback_reason(jnp.asarray(x), jnp.asarray(w),
                                           stride, precision)
        got = tops._quant_fallback_reason(torch.from_numpy(x),
                                          torch.from_numpy(w), stride,
                                          precision)
        assert got == want
    assert (got is not None) == (us_q is not None and us_f is not None
                                 and us_q > us_f)
    site = f"conv1d.{precision}"
    assert _events(jhealth, site) == _events(thealth, site) == (
        [(site, "quant_slower", "fallback:fp")] if got else [])
    assert [e.count for e in thealth.HEALTH.events] == ([1] if got else [])
    assert tops._QUANT_FALLBACKS.items() == jops._QUANT_FALLBACKS.items()
    jops._QUANT_FALLBACKS.clear()
    tops._QUANT_FALLBACKS.clear()
    jhealth.HEALTH.reset()
    thealth.HEALTH.reset()


def _spy(monkeypatch, mod, name):
    """Record the ``plan`` of each call of ``mod.name``."""
    real = getattr(mod, name)
    seen = []

    def spy(*a, **k):
        seen.append(k.get("plan"))
        return real(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    return seen


def test_quant_guard_serves_the_float_path_unless_pinned(caches,
                                                         monkeypatch):
    """With the quant key slower than the float key, a float-input call
    serves row 1; int8 input, a fused requant and an explicit plan stay on
    row 13, as in the reference."""
    B, L, Cin, Cout, K = 1, 40, 4, 6, 3
    _record_both({
        tat.conv1d_key(B, L, Cin, Cout, K, 1, "w8a8"): {"us": 9.0},
        tat.conv1d_key(B, L, Cin, Cout, K, 1, "float32"): {"us": 4.0}})
    thealth.HEALTH.reset()
    tops._QUANT_FALLBACKS.clear()
    fp = _spy(monkeypatch, tsc, "conv1d_sliding")
    q = _spy(monkeypatch, tsq, "conv1d_quant")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, L, Cin)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, Cin, Cout)).astype(np.float32))
    y = tops.conv1d(x, w, precision="w8a8")
    assert len(fp) == 1 and not q
    torch.testing.assert_close(y, tops.conv1d(x, w), rtol=0, atol=0)
    xq, wq, ws, xs, _ = tops._quant_operands(x, w, None, None, "w8a8")
    tops.conv1d(xq, wq, precision="w8a8", w_scale=ws, x_scale=xs)
    tops.conv1d(x, w, precision="w8a8", out_scale=torch.tensor(0.05))
    tops.conv1d(x, w, precision="w8a8", plan={"tile": "int8", "splits": 1})
    assert len(q) == 3 and len(fp) == 2
    assert q[-1] == {"tile": "int8", "splits": 1}
    # int8 weights dequantize onto the float path
    tops.conv1d(x, wq, precision="w8a16", w_scale=ws)
    assert len(fp) == 2 and len(q) == 4  # no w8a16 timing: quant path
    assert [(e.reason, e.count) for e in thealth.HEALTH.events] == [
        ("quant_slower", 1)]
    thealth.HEALTH.reset()
    tops._QUANT_FALLBACKS.clear()


@pytest.mark.parametrize("dispatch_us,falls_back", [(250.0, True),
                                                   (35.0, False)])
def test_quant_guard_compares_the_dispatch_time(caches, dispatch_us,
                                                falls_back):
    """Where the quant entry holds ``dispatch_us`` (its winner through a
    float-input ``ops`` call), the port's guard holds that, not the
    kernel's ``us``, against the float entry; the reference, which
    compares ``us``, keeps the quant path at these entries."""
    B, L, Cin, Cout, K = 1, 40, 4, 6, 3
    kq = tat.conv1d_key(B, L, Cin, Cout, K, 1, "w8a8")
    _record_both({kq: {"us": 30.0, "dispatch_us": dispatch_us},
                  tat.conv1d_key(B, L, Cin, Cout, K, 1, "float32"): {
                      "us": 40.0}})
    tops._QUANT_FALLBACKS.clear()
    jops._QUANT_FALLBACKS.clear()
    thealth.HEALTH.reset()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, L, Cin)).astype(np.float32)
    w = rng.normal(size=(K, Cin, Cout)).astype(np.float32)
    got = tops._quant_fallback_reason(torch.from_numpy(x),
                                      torch.from_numpy(w), 1, "w8a8")
    assert jops._quant_fallback_reason(jnp.asarray(x), jnp.asarray(w), 1,
                                       "w8a8") is None
    assert (got is not None) == falls_back
    if falls_back:
        assert got.startswith(f"tuned w8a8 path {dispatch_us:.0f}us > ")
        assert kq in tops._QUANT_FALLBACKS
    tops._QUANT_FALLBACKS.clear()
    jops._QUANT_FALLBACKS.clear()
    thealth.HEALTH.reset()


def test_untuned_plan_rung_is_cheap(caches):
    """With no cache file, an entry's tuned rung (its shape key and the
    lookup) adds a few microseconds to a launch: 200k of them stay far
    under any launch's own host work (a bound loose enough for a loaded
    machine)."""
    x = torch.zeros(4, 514, 1024)
    t0 = time.perf_counter()
    for _ in range(200_000):
        tops._resolve(tat.conv1d_key(*x.shape, 1024, 3, 2,
                                     tops._dtype_name(x)), None)
    dt = time.perf_counter() - t0
    assert dt < 4.0, f"untuned plan rung too slow: {dt:.3f}s / 200k calls"
    assert tat.lookup("conv1d|B4|L514|Cin1024|Cout1024|K3|s2|float32") \
        is None


def test_pool_method_tuned_rung_matches_reference(caches):
    """explicit → the tuned ``method`` → heuristic, in both packages, over
    the untuned test's grid with a tuned entry on every max key."""
    x = np.random.default_rng(0).normal(size=(1, 64, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    windows = (1, 4, 31, 32, 64)
    for i, window in enumerate(windows):
        for op in ("sum", "avg", "max"):
            method = ("scan", "shift")[i % 2]
            _record_both({tat.pool1d_key(1, 64, 4, window, op, "float32"):
                          {"method": method, "us": 1.0, "default_us": 1.0}})
    for window in windows:
        for op in ("sum", "avg", "max"):
            for explicit in (None, "scan", "shift"):
                assert tops._pool_method(tx, window, op, explicit) == \
                    jops._pool_method(jx, window, op, explicit)
    # the entries override the heuristic both ways
    assert tops._pool_method(tx, 4, "max", None) == "shift"  # i = 1
    assert tops._pool_method(tx, 1, "max", None) == "scan"   # heuristic shift
    assert tops._pool_method(tx, 31, "max", None) == "scan"
    assert tops._pool_method(tx, 32, "max", None) == "shift"  # heuristic scan
    assert tops._pool_method(tx, 4, "sum", None) == "scan"


# ---------------------------------------------------------------------------
# the plan functions: the rule unchanged, every candidate a valid plan


def _rule_gemm_plan(M, N, K, dtype, sms):
    """``gemm_plan`` as it was before a plan could be forced."""
    tile = gemm_plan.pick_tile(N, dtype)
    tiles = -(-M // tile.bm) * -(-N // tile.bn)
    chunks = -(-K // tile.bk)
    fill = tile.blocks_per_sm * sms
    splits = 1
    if tiles < fill:
        splits = max(1, min(fill // tiles,
                            chunks // gemm_plan.MIN_SPLIT_CHUNKS))
        if splits == 1 and tiles > sms and dtype == torch.float32:
            splits = gemm_plan._balanced_splits(tiles, chunks, sms, fill)
    per = -(-chunks // splits)
    return gemm_plan.GemmPlan(tile, -(-chunks // per), per, chunks, tiles)


def _rule_decode_splits(bkv, n, sms):
    want = max(1, tad.BLOCKS_PER_SM * sms // max(1, bkv))
    rows = max(tad.MIN_SPLIT_ROWS, -(-n // want))
    rows = max(1, min(n, rows, tad.MAX_SPLIT_ROWS))
    return -(-n // rows), rows


# (M, N, K): the rows' products at phase 47's shapes and ragged ones
GEMMS = [(9604, 32, 30752), (16384, 32, 96), (16382, 32, 1056),
         (2048, 1024, 240), (1024, 1024, 3072), (240, 1024, 2048),
         (3072, 1024, 1024), (11520, 1152, 588), (588, 1152, 11520),
         (7, 5, 3), (200, 90, 70), (1, 1, 1)]
DTYPES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.mark.parametrize("sms", [132, 114, 8, 1])
def test_gemm_plan_unforced_is_the_rule(sms):
    for (M, N, K) in GEMMS:
        for dt in DTYPES:
            rule = _rule_gemm_plan(M, N, K, dt, sms)
            assert gemm_plan.gemm_plan(M, N, K, dt, sms) == rule
            assert gemm_plan.gemm_plan(M, N, K, dt, sms, tile=None,
                                       splits=None) == rule
            # the rule's own fields forced: the same plan, the same bits
            assert gemm_plan.gemm_plan(M, N, K, dt, sms, tile=rule.tile.name,
                                       splits=rule.splits) == rule


def _covers(plan, K):
    """The splits cover the K reduction elements, each holding some."""
    bk = plan.tile.bk
    ranges = [plan.split_range(s) for s in range(plan.splits)]
    return (ranges[0][0] == 0 and ranges[-1][1] >= K
            and all(lo < min(hi, K) for lo, hi in ranges)
            and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            and plan.per * bk * (plan.splits - 1) < K)


@pytest.mark.parametrize("sms", [132, 8])
def test_gemm_candidates_are_valid_plans(sms):
    for (M, N, K) in GEMMS:
        for dt in DTYPES:
            default, cands = tat.gemm_candidates(M, N, K, dt, sms)
            rule = _rule_gemm_plan(M, N, K, dt, sms)
            assert default == {"tile": rule.tile.name, "splits": rule.splits}
            assert default in cands
            assert len(cands) == len({tuple(c.items()) for c in cands})
            for c in cands:
                assert c["tile"] in gemm_plan.DTYPE_TILES[dt]
                p = gemm_plan.gemm_plan(M, N, K, dt, sms, **c)
                assert p.splits == c["splits"] and _covers(p, K), (M, N, K, c)
                if p.splits > 1:
                    assert p.splits * gemm_plan.MIN_SPLIT_CHUNKS <= max(
                        p.chunks, rule.splits * gemm_plan.MIN_SPLIT_CHUNKS)


def test_gemm_candidates_at_fig1_k31():
    """fig1 k=31's product: the rule's narrow tile, 10 splits of 1,922
    chunks; both float32 tiles times the split counts and 10: 18 plans."""
    default, cands = tat.gemm_candidates(9604, 32, 30752, torch.float32, 132)
    assert default == {"tile": "narrow", "splits": 10}
    assert len(cands) == 18


@pytest.mark.parametrize("tile,dtype", [("mma", torch.float32),
                                        ("wide", torch.bfloat16),
                                        ("narrow", torch.int8),
                                        ("int8", torch.bfloat16),
                                        ("huge", torch.float32)])
def test_gemm_plan_refuses_a_tile_of_another_type(tile, dtype):
    with pytest.raises(gemm_plan.PlanError, match="tile"):
        gemm_plan.gemm_plan(100, 64, 256, dtype, 132, tile=tile)


@pytest.mark.parametrize("splits", [0, -1, 1.5])
def test_gemm_plan_refuses_a_split_below_one(splits):
    with pytest.raises(gemm_plan.PlanError, match="splits"):
        gemm_plan.gemm_plan(100, 64, 256, torch.float32, 132, splits=splits)


def test_forced_splits_round_as_the_rule():
    """per = ceil(chunks / splits), then splits = ceil(chunks / per): 20
    chunks forced to 6 splits walk 4 chunks each in 5 splits, the last
    ending at K; forced past the chunks, one chunk a split."""
    p = gemm_plan.gemm_plan(128, 32, 20 * 16, torch.float32, 132, splits=6)
    assert (p.chunks, p.per, p.splits) == (20, 4, 5) and _covers(p, 320)
    p = gemm_plan.gemm_plan(128, 32, 300, torch.float32, 132, splits=99)
    assert (p.chunks, p.per, p.splits) == (19, 1, 19) and _covers(p, 300)


# (B, Lout, C, elem, K, stride): jamba's prefill and training shapes, edges
DEPTHWISE = [(4, 256, 16384, 2, 4, 1), (4, 256, 16384, 1, 4, 1),
             (2, 512, 16384, 2, 4, 1), (2, 512, 16384, 4, 4, 1),
             (2, 150, 600, 4, 9, 2), (1, 3, 37, 4, 5, 1)]


@pytest.mark.parametrize("sms", [132, 2])
def test_depthwise_candidates_are_valid_plans(sms):
    for B, Lout, C, el, K, st in DEPTHWISE:
        default, cands = tat.depthwise_candidates(B, Lout, C, el, K, st, sms)
        rule = gemm_plan.depthwise_plan(B, Lout, C, el, K, st, sms)
        assert default == {"rows": rule.rows, "stages": rule.stages}
        assert default in cands
        assert gemm_plan.depthwise_plan(B, Lout, C, el, K, st, sms,
                                        **default) == rule
        for c in cands:
            p = gemm_plan.depthwise_plan(B, Lout, C, el, K, st, sms, **c)
            assert p.smem <= gemm_plan.SMEM_BLOCK
            assert p.chunks * p.rows >= Lout > (p.chunks - 1) * p.rows


@pytest.mark.parametrize("sms", [132, 2])
def test_depthwise_dw_candidates_are_valid_plans(sms):
    for B, Lout, C, el, K, st in DEPTHWISE:
        default, cands = tat.depthwise_dw_candidates(B, Lout, C, el, K, st,
                                                     sms)
        rule = gemm_plan.depthwise_dw_plan(B, Lout, C, el, K, st, sms)
        assert default == {"bwd_rows": rule.rows, "bwd_stages": rule.stages,
                           "bwd_splits": rule.splits}
        assert default in cands
        for c in cands:
            p = gemm_plan.depthwise_dw_plan(
                B, Lout, C, el, K, st, sms, rows=c["bwd_rows"],
                stages=c["bwd_stages"], splits=c["bwd_splits"])
            assert p.smem <= gemm_plan.SMEM_BLOCK
            assert 1 <= p.splits <= p.items // p.slabs
            assert p.workspace == (p.splits * (K + 1) * C
                                   if p.splits > 1 else 0)


def test_depthwise_plans_refuse_what_does_not_fit():
    with pytest.raises(gemm_plan.PlanError):
        gemm_plan.depthwise_plan(2, 100, 64, 4, 4, 1, 132, rows=10)
    with pytest.raises(gemm_plan.PlanError):
        gemm_plan.depthwise_dw_plan(2, 100, 64, 4, 4, 1, 132, stages=5)
    with pytest.raises(gemm_plan.PlanError):  # a ring past shared memory
        gemm_plan.depthwise_plan(1, 100, 64, 4, 2000, 1, 132, rows=64,
                                 stages=4)


# (B * KV, S): the decode reads of phase 47 and edges
ATTN = [(4, 2048), (16, 288), (32, 3168), (4, 3168), (64, 288), (1, 1),
        (3, 65), (600, 24)]


@pytest.mark.parametrize("sms", [132, 8])
def test_decode_splits_unforced_is_the_rule_and_candidates_cover(sms):
    for bkv, S in ATTN:
        assert tad.decode_splits(bkv, S, sms) == _rule_decode_splits(bkv, S,
                                                                     sms)
        default, cands = tat.attention_candidates(bkv, S, sms)
        assert default == {"split_rows": _rule_decode_splits(bkv, S, sms)[1]}
        assert default in cands
        for c in cands:
            n, rows = tad.decode_splits(bkv, S, sms, rows=c["split_rows"])
            assert 1 <= rows <= min(S, tad.MAX_SPLIT_ROWS)
            assert n * rows >= S > (n - 1) * rows


def test_decode_splits_refuses_rows_out_of_range():
    for rows in (0, 300, 513):
        with pytest.raises(gemm_plan.PlanError):
            tad.decode_splits(4, 288 if rows != 513 else 3168, 132,
                              rows=rows)


# ---------------------------------------------------------------------------
# ops: explicit → tuned → rule


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]


def test_conv1d_resolves_explicit_tuned_rule(caches, monkeypatch):
    """Forward under the shape key, the weight gradient under its
    ``grad=True`` key, dx under the dx conv's own key."""
    fwd = _spy(monkeypatch, tsc, "conv1d_sliding")
    dw = _spy(monkeypatch, tsb, "conv1d_bwd_dw")
    x, w = _inputs((2, 21, 3), (3, 3, 5))
    tops.conv1d(x, w, stride=2)
    assert fwd == [None]
    key = tat.conv1d_key(2, 21, 3, 5, 3, 2, "float32")
    tat.record(key, {"tile": "narrow", "splits": 2, "us": 1.0})
    tat.record(key + "|grad", {"tile": "wide", "splits": 3})
    # dz (2, 10, 5) dilated by 2 and padded by 2 each side: 23 rows
    tat.record(tat.conv1d_key(2, 23, 5, 3, 3, 1, "float32"),
               {"tile": "wide", "splits": 1})
    y = tops.conv1d(x, w, stride=2)
    assert fwd[-1]["splits"] == 2
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    tops.conv1d(xg, wg, stride=2).sum().backward()
    assert [p["splits"] for p in fwd[-2:]] == [2, 1]  # forward, then dx
    assert dw == [{"tile": "wide", "splits": 3}]
    tops.conv1d(xg, wg, stride=2, plan={"splits": 4},
                bwd_plan={"splits": 5}).sum().backward()
    assert fwd[-2] == {"splits": 4} and dw[-1] == {"splits": 5}
    torch.testing.assert_close(y, tops.conv1d(x, w, stride=2, plan={}),
                               rtol=0, atol=0)


def test_depthwise_resolves_explicit_tuned_rule(caches, monkeypatch):
    """One entry under ``conv1d_dw_key``: rows and stages for the forward
    and the dx conv, the ``bwd_*`` fields for row 11; the int8 kernel
    under its precision key."""
    fwd = _spy(monkeypatch, tsc, "conv1d_depthwise")
    dw = _spy(monkeypatch, tsb, "conv1d_depthwise_bwd_dw")
    q = _spy(monkeypatch, tsq, "conv1d_depthwise_quant")
    x, w, b = _inputs((2, 30, 8), (4, 8), (8,))
    entry = {"rows": 16, "stages": 3, "bwd_rows": 8, "bwd_stages": 4,
             "bwd_splits": 2, "us": 1.0, "default_us": 2.0}
    tat.record(tat.conv1d_dw_key(2, 33, 8, 4, 1, "float32"), entry)
    tat.record(tat.conv1d_dw_key(2, 33, 8, 4, 1, "w8a8"),
               {"rows": 4, "stages": 2})
    tops.conv1d_depthwise(x, w, bias=b, activation="silu")  # CAUSAL: L 33
    assert fwd == [entry]
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    tops.conv1d_depthwise(xg, wg, bias=bg,
                          activation="silu").sum().backward()
    assert fwd[-2:] == [entry, entry]
    assert dw == [{"rows": 8, "stages": 4, "splits": 2}]
    tops.conv1d_depthwise(x, w, precision="w8a8")
    assert q == [{"rows": 4, "stages": 2}]
    tops.conv1d_depthwise(x, w, plan={"rows": 32})
    assert fwd[-1] == {"rows": 32}
    tops.conv1d_depthwise(torch.zeros(1, 5, 8), w)  # another key: the rule
    assert fwd[-1] is None


def test_conv2d_resolves_explicit_tuned_rule(caches, monkeypatch):
    fwd = _spy(monkeypatch, ts2, "conv2d_sliding")
    dw = _spy(monkeypatch, tsb, "conv2d_bwd_dw")
    q = _spy(monkeypatch, tsq, "conv2d_quant")
    x, w = _inputs((1, 9, 8, 3), (3, 2, 3, 4))
    key = tat.conv2d_key(1, 9, 8, 3, 4, 3, 2, 2, 1, "float32")
    tat.record(key, {"tile": "narrow", "splits": 2})
    tat.record(key + "|grad", {"tile": "wide", "splits": 1})
    tat.record(tat.conv2d_key(1, 9, 8, 3, 4, 3, 2, 2, 1, "w8a8"),
               {"tile": "int8", "splits": 3})
    tops.conv2d(x, w, stride=(2, 1))
    assert fwd == [{"tile": "narrow", "splits": 2}]
    wg = w.clone().requires_grad_()
    tops.conv2d(x, wg, stride=(2, 1)).sum().backward()  # no dx: x needs none
    assert len(fwd) == 2 and dw == [{"tile": "wide", "splits": 1}]
    tops.conv2d(x, w, stride=(2, 1), precision="w8a8")
    assert q == [{"tile": "int8", "splits": 3}]
    tops.conv2d(x, wg, stride=(2, 1), plan={"splits": 7},
                bwd_plan={"splits": 8}).sum().backward()
    assert fwd[-1] == {"splits": 7} and dw[-1] == {"splits": 8}


def test_attention_resolves_explicit_tuned_rule(caches, monkeypatch):
    seen = _spy(monkeypatch, tad, "decode_attention")
    q, k, v = _inputs((2, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8))
    ln = torch.tensor([16, 9], dtype=torch.int32)
    y = tops.attention_decode(q, k, v, lengths=ln)
    tat.record(tat.attn_dec_key(2, 16, 2, 2, 8, "float32"),
               {"split_rows": 8})
    torch.testing.assert_close(tops.attention_decode(q, k, v, lengths=ln), y,
                               rtol=0, atol=0)
    tops.attention_decode(q, k, v, lengths=ln, plan={"split_rows": 4})
    assert seen == [None, {"split_rows": 8}, {"split_rows": 4}]


def test_a_refused_tuned_plan_raises_naming_its_key(caches):
    """On the card a refused plan raises before any launch; ``ops`` names
    the key the plan came under. The launch geometry refuses it on the
    CPU too."""
    x, w = _inputs((1, 20, 4), (3, 4, 8))
    with pytest.raises(gemm_plan.PlanError, match="tile"):
        tsc.conv1d_launch(x, w, 1, 18, {"tile": "mma"})

    def launch(*a, plan=None, **k):
        return tsc.conv1d_launch(x, w, 1, 18, plan)

    with pytest.raises(gemm_plan.PlanError, match=r"under conv1d\|B1"):
        tops._planned("conv1d|B1|L20", {"tile": "int8"}, launch)
    with pytest.raises(gemm_plan.PlanError) as e:  # the rule's own refusal
        tops._planned("k", None, lambda plan=None: gemm_plan.depthwise_plan(
            1, 4, 4, 4, 5000, 1, rows=64, stages=4))
    assert "under" not in str(e.value)
    with pytest.raises(gemm_plan.PlanError, match="split rows"):
        tops._planned("attn", {"split_rows": 0}, lambda plan=None:
                      tad.decode_splits(4, 16, rows=plan["split_rows"]))


def test_no_cache_file_means_the_rule(tmp_path, monkeypatch):
    """With the cache path pointing at no file, every entry passes no plan
    (the rule) and nothing is written."""
    monkeypatch.setenv(tat.ENV_CACHE, str(tmp_path / "none.json"))
    tat.invalidate()
    seen = _spy(monkeypatch, tsc, "conv1d_sliding")
    x, w = _inputs((1, 20, 4), (3, 4, 8))
    tops.conv1d(x, w)
    assert seen == [None] and not any(tmp_path.iterdir())
    tat.invalidate()
