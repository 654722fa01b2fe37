"""The port's quant-range proofs (``repro_torch.analysis.ranges``) held to
the reference's ``repro.analysis.ranges``: the same chain paths, the same
overflow bound, the same verdicts for the shared stages and for poisoned
specs, run through both packages."""
import numpy as np
import pytest
import torch

from repro.analysis import ranges as ref
from repro_torch.analysis import ranges

PATHS = ranges.shipped_chains()


def test_shipped_chains_match_reference():
    assert PATHS == ref.shipped_chains()
    assert ("edge/c1", "edge/c2", "edge/c3") in PATHS


def test_overflow_constant_matches_reference_and_is_exact():
    assert ranges.OVERFLOW_REDUCE_LEN == ref.OVERFLOW_REDUCE_LEN == 133_145
    n = ranges.OVERFLOW_REDUCE_LEN
    assert 127 * 127 * (n - 1) <= ranges.INT32_MAX < 127 * 127 * n


def test_site_geometry_matches_reference():
    assert {s: (g.taps, g.cin, g.pools) for s, g in ranges.SITE_GEOM.items()} \
        == {s: (g.taps, g.cin, g.pools) for s, g in ref.SITE_GEOM.items()}


@pytest.mark.parametrize("path", PATHS, ids="->".join)
def test_chain_verdicts_match_reference(path):
    got = ranges.check_chain(path)
    want = ref.check_chain(path)
    assert got[0] == want[0] == "safe"
    assert got[1] == want[1] == []
    assert got[2] == want[2]


@pytest.mark.parametrize("poison,reason", [
    (0.0, "zero"), (float("nan"), "nan"), (-0.01, "zero"),
    (float("inf"), "nan"),
])
def test_poisoned_scale_is_unreachable_not_safe(poison, reason):
    path = ("whisper/conv1", "whisper/conv2")
    spec = {"whisper/conv1": {"x_scale": 0.02, "out_scale": poison},
            "whisper/conv2": {"x_scale": 0.04}}
    status, vio, detail = ranges.check_chain(path, spec=spec)
    assert (status, vio, detail) == ref.check_chain(path, spec=spec)
    assert status == "unreachable" and vio == []
    assert reason in detail["reason"]


def test_poisoned_consumer_scale_tensor_is_unreachable():
    """A scale held as a tensor (as ``Calibration.spec`` gives it) is
    screened by ``quant.apply.scale_reason`` like a float."""
    path = ("edge/c1", "edge/c2", "edge/c3")
    spec = {"edge/c1": {"x_scale": torch.tensor(0.1),
                        "out_scale": torch.tensor(0.2)},
            "edge/c2": {"x_scale": torch.tensor(0.2),
                        "out_scale": torch.tensor(float("nan"))},
            "edge/c3": {"x_scale": torch.tensor(0.3)}}
    status, _, detail = ranges.check_chain(path, spec=spec)
    assert status == "unreachable" and detail["edge"] == "edge/c2->edge/c3"


def test_check_all_with_poisoned_spec_not_reported_safe():
    spec = {"whisper/conv1": {"x_scale": 0.02, "out_scale": float("nan")},
            "whisper/conv2": {"x_scale": 0.04}}
    violations, stats = ranges.check_all(spec=spec, quick=True)
    _, ref_stats = ref.check_all(spec=spec, quick=True)
    chain = stats["chains"]["whisper/conv1->whisper/conv2"]
    assert chain["status"] == "unreachable"
    assert chain == ref_stats["chains"]["whisper/conv1->whisper/conv2"]
    assert not any(v.key.startswith("whisper") for v in violations)


def test_concrete_spec_miswired_out_scale_fires_on_chain():
    path = ("whisper/conv1", "whisper/conv2")
    spec = {"whisper/conv1": {"x_scale": 0.02, "out_scale": 0.01},
            "whisper/conv2": {"x_scale": 0.04}}
    got, want = ranges.check_chain(path, spec), ref.check_chain(path, spec)
    assert got[0] == want[0] == "violated"
    assert [v.kind for v in got[1]] == [v.kind for v in want[1]] == [
        "requant_clip"]
    ok = {"whisper/conv1": {"x_scale": 0.02, "out_scale": 0.04},
          "whisper/conv2": {"x_scale": 0.04}}
    assert ranges.check_chain(path, ok)[0] == ref.check_chain(path, ok)[0] \
        == "safe"


def test_acc_bits_max_matches_reference():
    _, got = ranges.check_all()
    _, want = ref.check_all()
    assert got["acc_bits_max"] == want["acc_bits_max"]
    assert got["overflow_reduce_len"] == want["overflow_reduce_len"]
    assert got["chains"] == want["chains"]


def test_quant_kernel_space_accumulators_safe():
    violations, stats = ranges.check_all(quick=False)
    assert violations == [], [v.line() for v in violations]
    assert stats["kernel_stages"] > 40
    assert all(c["status"] == "safe" for c in stats["chains"].values())


def test_split_partials_bounded_by_their_sum():
    stages = list(ranges._quant_space_stages(quick=True))
    splits = [s for s in stages if s.site.endswith("|split")]
    assert splits  # the int8 products of the key space do split
    whole = {s.site: s for s in stages}
    for s in splits:
        assert s.acc_bound() <= whole[s.site[:-len("|split")]].acc_bound()


@pytest.mark.parametrize("taps,cin", [(3, 80), (196, 3), (961, 32),
                                      (1, 133_145), (65, 2048)])
def test_fixture_acc_overflow(taps, cin):
    got = ranges.check_stage(ranges.Stage("s", taps=taps, cin=cin))
    want = ref.check_stage(ref.Stage("s", taps=taps, cin=cin))
    assert [v.kind for v in got] == [v.kind for v in want]
    assert bool(got) == (taps * cin >= ranges.OVERFLOW_REDUCE_LEN)


def test_fixture_requant_clip():
    assert ranges.check_requant("p", 0.05, 0.05) == []
    assert ranges.check_requant("p", 0.05, 0.05 * (1 + 5e-5)) == []
    assert [v.kind for v in ranges.check_requant("p", 0.04, 0.05)] == [
        "requant_clip"]
    assert len(ref.check_requant("p", 0.04, 0.05)) == 1


def test_kv_fold_shipped_layout_valid():
    assert ranges.check_kv_fold() == [] == ref.check_kv_fold()


def test_fixture_scale_fold_mismatch():
    bad = (1, 2, 4, 2, 8)
    assert [v.kind for v in ranges.check_kv_fold(bad)] == ["scale_fold"]
    assert len(ref.check_kv_fold(bad)) == 1


def test_chain_geometry_matches_model_code():
    from repro_torch.configs import get_config
    from repro_torch.models.whisper import frontend_defs

    d = frontend_defs(get_config("whisper-medium"))
    g1, g2 = ranges.SITE_GEOM["whisper/conv1"], ranges.SITE_GEOM[
        "whisper/conv2"]
    assert (g1.taps, g1.cin) == d["conv1_w"].shape[:2]
    assert (g2.taps, g2.cin) == d["conv2_w"].shape[:2]


def test_interval_algebra():
    c = ranges.Interval.codes()
    assert (c.lo, c.hi) == (-127, 127)
    s = c.scaled(0.5)
    assert (s.lo, s.hi) == (-63.5, 63.5)
    flipped = c.scaled(-0.5)
    assert flipped.lo < flipped.hi
    assert ranges.Interval.for_scale(0.1).contains(
        ranges.Interval(-12.7, 12.7))


def test_percentile_interval_narrower_than_absmax():
    from repro_torch.quant.calibrate import Calibration

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 256, 8)).astype(np.float32)
    x[0, 0, 0] = 40.0
    pct, absm = Calibration(percentile=99.0), Calibration(percentile=None)
    pct.observe("site", torch.from_numpy(x))
    absm.observe("site", torch.from_numpy(x))
    i_pct = ranges.Interval.for_scale(float(pct.site_scale("site")))
    i_abs = ranges.Interval.for_scale(float(absm.site_scale("site")))
    assert i_abs.contains(i_pct) and i_pct.width() < i_abs.width()
    assert i_abs.hi >= 40.0 * (1 - 1e-6)


def test_codes_through_max_pool_unchanged():
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(
        rng.integers(-127, 128, size=(1, 4, 8, 8)).astype(np.float32))
    scale = 0.03
    pooled = torch.nn.functional.max_pool2d(codes, 2) * scale
    assert torch.equal(pooled, torch.nn.functional.max_pool2d(codes * scale,
                                                              2))
    assert float(pooled.abs().max()) <= 127 * scale
