"""The port's H100 roofline (``repro_torch.analysis.costmodel``) on the CPU:
peaks, traffic, the sweep, validate's gate, the ranked search the tuning
layer runs on it, and the work it counts against the reference's
``repro.analysis.costmodel.instance_flops``."""
import json
import math

import pytest
import torch

from repro.analysis import contracts as ref_contracts
from repro.analysis import costmodel as ref_costmodel
from repro_torch.analysis import contracts, costmodel
from repro_torch.kernels import autotune as tat


@pytest.fixture
def no_peaks(tmp_path, monkeypatch):
    monkeypatch.setenv(costmodel.ENV_PEAKS, str(tmp_path / "absent.json"))
    return tmp_path


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv(tat.ENV_CACHE, str(tmp_path / "t.json"))
    tat.invalidate()
    yield tmp_path
    tat.invalidate()


# ---------------------------------------------------------------------------
# peaks


def test_peaks_priors_when_no_file(no_peaks):
    pk = costmodel.peaks()
    assert pk.source == "prior+prior"
    assert pk.ops == costmodel.H100_PEAK_OPS
    assert pk.hbm_bw == costmodel.H100_HBM_BYTES_S == 3.35e12
    assert costmodel.H100_PEAK_OPS == {"float32": 67e12, "bfloat16": 989e12,
                                       "int8": 1979e12}


def test_peaks_from_probe_file(no_peaks):
    f = no_peaks / "peaks.json"
    f.write_text(json.dumps({"float32_tflops": 50.0, "bfloat16_tflops": 791.2,
                             "hbm_gbps": 3000.0, "sms": 132}))
    pk = costmodel.peaks(f)
    assert pk.source == "probe+probe"
    assert pk.ops["float32"] == 50e12 and pk.hbm_bw == 3000e9
    # int8: the bf16 probe's share of its data-sheet rate
    assert pk.ops["int8"] == pytest.approx(1979e12 * 0.8)
    assert costmodel.peaks(str(f)).as_stats()["tflops"]["bfloat16"] == 791.2


def test_peaks_file_from_env(no_peaks, monkeypatch):
    """``$REPRO_TORCH_PEAKS`` names the file where no path is given; a
    file with only the copy's rate keeps the data sheet's arithmetic."""
    f = no_peaks / "peaks.json"
    f.write_text(json.dumps({"hbm_gbps": 3000.0}))
    monkeypatch.setenv(costmodel.ENV_PEAKS, str(f))
    pk = costmodel.peaks()
    assert pk.source == "prior+probe"
    assert pk.ops == costmodel.H100_PEAK_OPS and pk.hbm_bw == 3000e9


def test_probe_peaks_needs_a_card():
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        costmodel.probe_peaks(0)


# ---------------------------------------------------------------------------
# traffic


def test_smaller_tiles_move_more_bytes():
    """The 128 x 32 tile reads A once per 32 columns, the 128 x 128 one
    once per 128; shorter depthwise items re-read more halo rows."""
    shape = dict(B=1, L=4096, Cin=32, Cout=128, K=9, splits=1)
    narrow = contracts.build_conv1d(**shape, tile="narrow")
    wide = contracts.build_conv1d(**shape, tile="wide")
    assert costmodel.hbm_bytes(narrow) > costmodel.hbm_bytes(wide)
    dw = dict(B=4, L=259, C=16384, K=4, dtype="bfloat16", stages=2)
    assert (costmodel.hbm_bytes(contracts.build_conv1d_depthwise(**dw,
                                                                 rows=4))
            > costmodel.hbm_bytes(contracts.build_conv1d_depthwise(
                **dw, rows=32)))


def test_more_splits_more_partial_bytes():
    shape = dict(B=1, L=16384, Cin=32, Cout=32, K=33, tile="narrow")
    b = [costmodel.hbm_bytes(contracts.build_conv1d(**shape, splits=s))
         for s in (1, 2, 4, 8)]
    assert b == sorted(b) and len(set(b)) == 4
    one = contracts.build_conv1d(**shape, splits=1)
    assert costmodel._partial_bytes(one) == 0


def test_sweep_every_instance_finite(no_peaks):
    violations, stats = costmodel.check_all(quick=True,
                                            cache=str(no_peaks / "x.json"))
    assert violations == [], [v.line() for v in violations]
    assert stats["instances"] > 500
    for fam, d in stats["pred_us"].items():
        assert 0 < d["min"] <= d["max"] < math.inf, fam


def test_unknown_family_and_bad_candidate_degrade_to_none(no_peaks):
    assert costmodel.predict_us("nope", {}) is None
    assert costmodel.candidate_cost("nope", {}) is None
    shape = dict(B=1, L=64, Cin=4, Cout=4, K=3)
    assert costmodel.predict_us("conv1d", shape, {"tile_l": 64}) is None
    assert costmodel.predict_us("conv1d", shape, {"tile": "mma"}) is None
    # a plan refused for its bytes launches nothing: no prediction
    dw = dict(B=2, L=515, C=16384, K=4, dtype="float32")
    assert costmodel.predict_us("conv1d_depthwise_bwd_dw", dw,
                                {"bwd_rows": 64, "bwd_stages": 4}) is None


def test_candidate_cost_row11_adds_the_forward(no_peaks):
    shape = dict(B=2, L=515, C=16384, K=4, stride=1, dtype="bfloat16")
    cand = {"rows": 32, "stages": 2, "bwd_rows": 32, "bwd_stages": 2,
            "bwd_splits": 6}
    got = costmodel.candidate_cost("conv1d_depthwise_bwd_dw", shape)(cand)
    bwd = costmodel.predict_us("conv1d_depthwise_bwd_dw", shape, cand)
    fwd = costmodel.predict_us("conv1d_depthwise", dict(shape,
                                                        precision="fp"),
                               {"rows": 32, "stages": 2})
    assert got == pytest.approx(bwd + fwd)


def test_parse_key_round_trips_every_family():
    cases = [
        (tat.conv1d_key(1, 64, 4, 8, 3, 2, "float32"), "conv1d",
         dict(B=1, L=64, Cin=4, Cout=8, K=3, stride=2, precision="fp",
              dtype="float32")),
        (tat.conv1d_key(1, 64, 4, 8, 3, 1, "w8a8"), "conv1d",
         dict(B=1, L=64, Cin=4, Cout=8, K=3, stride=1, precision="w8a8",
              dtype="float32")),
        (tat.conv1d_key(1, 64, 4, 8, 3, 1, "bfloat16", grad=True),
         "conv1d_bwd_dw", dict(B=1, L=64, Cin=4, Cout=8, K=3, stride=1,
                               dtype="bfloat16")),
        (tat.conv2d_key(1, 9, 9, 2, 3, 3, 3, 1, 1, "w8a16"), "conv2d",
         dict(B=1, H=9, W=9, Cin=2, Cout=3, kh=3, kw=3, stride=(1, 1),
              precision="w8a16", dtype="float32")),
        (tat.conv2d_key(1, 9, 9, 2, 3, 3, 3, 1, 1, "float32", grad=True),
         "conv2d_bwd_dw", dict(B=1, H=9, W=9, Cin=2, Cout=3, kh=3, kw=3,
                               stride=(1, 1), dtype="float32")),
        (tat.conv1d_dw_key(2, 67, 130, 4, 1, "bfloat16"), "conv1d_depthwise",
         dict(B=2, L=67, C=130, K=4, stride=1, precision="fp",
              dtype="bfloat16")),
        (tat.attn_dec_key(2, 64, 2, 2, 32, "int8"), "attention_decode",
         dict(B=2, S=64, KV=2, G=2, D=32, kind="int8")),
        (tat.pool1d_key(1, 64, 4, 8, "max", "float32"), "pool1d",
         dict(B=1, L=64, C=4, window=8, op="max", dtype="float32")),
    ]
    for key, fam, shape in cases:
        assert costmodel.parse_key(key) == (fam, shape), key
        assert costmodel.predict_us(fam, shape) > 0, key
    assert costmodel.parse_key("conv1d|B1|Lx|Cin1|Cout1|K1|s1|f") is None
    assert costmodel.parse_key("other|B1") is None


def test_spearman_and_mape_units():
    assert costmodel.spearman([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert costmodel.spearman([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
    assert costmodel.spearman([1, 1, 2], [5, 5, 9]) == pytest.approx(1.0)
    assert costmodel.spearman([1], [1]) == 0.0
    assert costmodel.spearman([1, 1], [2, 3]) == 0.0
    assert costmodel.mape([110, 90], [100, 100]) == pytest.approx(0.1)
    # the same ranks as the reference's
    xs, ys = [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]
    assert costmodel.spearman(xs, ys) == pytest.approx(
        ref_costmodel.spearman(xs, ys))


def _tuned_cache(measure):
    """A tuning cache of four conv2d keys, measured as ``measure(pred)``."""
    cache = {}
    for k in (3, 9, 17, 31):
        key = tat.conv2d_key(1, 128, 128, 32, 32, k, k, 1, 1, "float32")
        fam, shape = costmodel.parse_key(key)
        default, _ = tat.gemm_candidates((128 - k + 1) ** 2, 32,
                                         k * k * 32, torch.float32)
        pred = costmodel.predict_us(fam, shape, default)
        cache[key] = {**default, "us": measure(pred), "default_us": 1.0}
    return cache


def test_validate_gates_on_lying_rank_order(no_peaks):
    v, stats = costmodel.validate(_tuned_cache(lambda p: 2.0 * p))
    assert v == [] and stats["families"]["conv2d"]["spearman"] == 1.0
    assert stats["families"]["conv2d"]["gated"]
    v, stats = costmodel.validate(_tuned_cache(lambda p: 1e4 / p))
    assert [x.kind for x in v] == ["cost_rank"]
    assert stats["families"]["conv2d"]["spearman"] == -1.0


def test_validate_below_gate_rows_not_gated(no_peaks):
    cache = dict(list(_tuned_cache(lambda p: 1e4 / p).items())[:2])
    v, stats = costmodel.validate(cache)
    assert v == [] and not stats["families"]["conv2d"]["gated"]


def test_validate_reads_row11_entries(no_peaks):
    key = tat.conv1d_dw_key(2, 515, 16384, 4, 1, "bfloat16")
    cache = {key: {"rows": 32, "stages": 2, "bwd_rows": 32, "bwd_stages": 2,
                   "bwd_splits": 6, "us": 700.0, "default_us": 700.0},
             "__schema__": 1}
    rows = list(costmodel.cache_rows(cache))
    assert [r[0] for r in rows] == ["conv1d_depthwise_bwd_dw"]
    _, stats = costmodel.validate(cache)
    assert stats["families"]["conv1d_depthwise_bwd_dw"]["n"] == 1


# ---------------------------------------------------------------------------
# the ranked search


def _model_as_measurement(monkeypatch, family, shape):
    """``_time_fn`` returns the model's own prediction for the plan being
    timed (in seconds); returns the timed plans."""
    cost = costmodel.candidate_cost(family, shape)
    timed = []
    state = {}

    def run(cfg):
        state["cfg"] = cfg

    def time_fn(fn, **_):
        fn()
        timed.append(state["cfg"])
        return cost(state["cfg"]) * 1e-6

    monkeypatch.setattr(tat, "_time_fn", time_fn)
    return run, timed


@pytest.mark.parametrize("family,shape,cands", [
    ("conv1d_depthwise", dict(B=4, L=259, C=16384, K=4, stride=1,
                              precision="fp", dtype="bfloat16"),
     lambda: tat.depthwise_candidates(4, 256, 16384, 2, 4, 1)),
    ("conv1d_depthwise_bwd_dw", dict(B=2, L=515, C=16384, K=4, stride=1,
                                     dtype="bfloat16"),
     lambda: tat.depthwise_dw_candidates(2, 512, 16384, 2, 4, 1)),
])
def test_ranked_search_times_fewer_same_winner(monkeypatch, caches, no_peaks,
                                               family, shape, cands):
    """The CI step's property on memory-bound shapes: with the model as the
    measurement, the ranked search times fewer plans than the exhaustive
    one and keeps its winner."""
    default, cs = cands()
    run, timed = _model_as_measurement(monkeypatch, family, shape)
    ex = tat._search("k", run, cs, default)
    n_ex = len(timed)
    timed.clear()
    rk = tat._search("k", run, cs, default,
                     cost=tat._cost_model(family, shape))
    assert not ex.ranked and ex.cost_skipped == 0 and ex.timed == n_ex
    assert rk.ranked and rk.cost_skipped > 0 and rk.timed < ex.timed
    assert rk.best == ex.best
    assert timed[0] == default


def test_ranking_requires_total_predictions(monkeypatch, caches):
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])
    cands = [{"s": i} for i in range(1, 8)]

    def partial(c):
        return None if c["s"] == 4 else float(c["s"])

    order, ranked = tat._ranked(cands, partial)
    assert not ranked and order == cands
    order, ranked = tat._ranked(cands, lambda c: float(-c["s"]))
    assert ranked and order == cands[::-1]
    order, ranked = tat._ranked(cands, lambda c: math.inf)
    assert not ranked
    res = tat._search("k", lambda c: None, cands, {"s": 0}, cost=partial)
    assert not res.ranked and res.timed == 8


def test_cost_kill_switch_and_patience(monkeypatch, caches):
    shape = dict(B=1, L=16384, Cin=32, Cout=32, K=3, stride=1,
                 precision="fp", dtype="float32")
    assert tat._cost_model("conv1d", shape) is not None
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_COST", "0")
    assert tat._cost_model("conv1d", shape) is None
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_COST")
    assert tat.COST_PATIENCE == 3
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])
    cands = [{"s": i} for i in range(1, 8)]
    res = tat._search("k", lambda c: None, cands, {"s": 0},
                      cost=lambda c: float(c["s"]))
    assert res.ranked and res.timed == 4 and res.cost_skipped == 4
    # a time that improves resets the count: 1 and 3 improve, then 4-6
    # do not and 7 is never timed
    times = {0: 9, 1: 8, 2: 8, 3: 7, 4: 8, 5: 8, 6: 8, 7: 1}
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: fn())
    res = tat._search("k", lambda c: times[c["s"]], cands, {"s": 0},
                      cost=lambda c: float(c["s"]))
    assert res.ranked and res.best["s"] == 3
    assert res.timed == 7 and res.cost_skipped == 1


def test_search_counts_pruned_and_cost_skipped(monkeypatch, caches):
    from repro_torch.obs import metrics

    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])
    reg = metrics.REGISTRY

    def count(name):
        return reg.counter(name).value(key="kc")

    before = (count("autotune.pruned"), count("autotune.cost_skipped"))
    verdict = contracts.Violation("smem_budget", "f", "k", "too big")
    res = tat._search("kc", lambda c: None, [{"s": i} for i in range(1, 9)],
                      {"s": 0}, contract=lambda c: verdict if c["s"] == 1
                      else None, cost=lambda c: float(c["s"]))
    assert (res.pruned, res.cost_skipped) == (1, 4)
    assert (count("autotune.pruned") - before[0],
            count("autotune.cost_skipped") - before[1]) == (1.0, 4.0)


# ---------------------------------------------------------------------------
# the work, against the reference


_SHARED = ("conv1d", "conv2d", "conv1d_depthwise", "pool1d", "conv1d_bwd_dw",
           "conv2d_bwd_dw", "conv1d_depthwise_bwd_dw", "attention_decode",
           "ssm_scan")


def _reference_shapes(family):
    seen = []
    for fam, shape, _ in ref_contracts.default_space(quick=False):
        if fam == family and shape not in seen:
            seen.append(shape)
    return seen


@pytest.mark.parametrize("family", _SHARED)
def test_instance_flops_matches_reference(family):
    shapes = _reference_shapes(family)
    assert shapes, family
    for shape in shapes:
        assert costmodel.instance_flops(family, shape) == \
            ref_costmodel.instance_flops(family, shape), (family, shape)
    if family == "pool1d":
        for method in ("scan", "shift"):
            assert costmodel.instance_flops(family, shapes[0],
                                            method=method) == \
                ref_costmodel.instance_flops(family, shapes[0],
                                             method=method)


def test_instance_flops_unknown_family_raises():
    with pytest.raises(KeyError):
        costmodel.instance_flops("nope", {})


def test_default_space_quant_instances_covered_by_cost_model(no_peaks):
    n = 0
    for family, shape, cand in contracts.default_space(quick=True):
        if shape.get("precision") in ("w8a8", "w8a16"):
            p = costmodel.predict_us(family, shape, cand)
            assert p is not None and p > 0, (family, shape, cand)
            n += 1
    assert n > 100


def test_bound_ms_priors_give_perf_rows():
    """chip_smoke's bound_ms reads the priors from here: row 1 bf16 conv1
    at 0.00150 ms (bytes) and row 4 fig1 k31 at 0.2821 ms (operations),
    as PERF.md's section 6 has them."""
    import importlib.util
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.pop("chip_smoke_mod", None)
    spec.loader.exec_module(mod)
    # conv1: x (4, 514, 80), w (3, 80, 1024), y (4, 512, 1024) in bf16
    nbytes = 2 * (4 * 514 * 80 + 3 * 80 * 1024 + 4 * 512 * 1024)
    ops = 2 * 4 * 512 * 3 * 80 * 1024
    ms, by = mod.bound_ms(nbytes, ops, torch.bfloat16)
    assert (round(ms, 5), by) == (0.0015, "bytes")
    # fig1 k31 f32: 2 · 98² · 31² · 32²
    ops = 2 * 98 * 98 * 31 * 31 * 32 * 32
    nbytes = 4 * (128 * 128 * 32 + 31 * 31 * 32 * 32 + 98 * 98 * 32)
    ms, by = mod.bound_ms(nbytes, ops, torch.float32)
    assert (round(ms, 4), by) == (0.2821, "operations")
