"""The depthwise weight gradient (row 11, ``csrc/conv1d_depthwise_bwd.cu``
on ``csrc/depthwise_rows.cuh``'s ring) against its plain version, on the
card.

jamba-1.5-large's training shape (x (2, 515, 16384), dz (2, 512, 16384),
K 4) in float32 and bfloat16, with and without db; then ``chip_smoke.py``
phase 20's edges and K 9 (the tap groups): K 1-5 and 9, strides 1 and 2,
C 37, 600 and 16384, x and dz one or two elements off their storage's
alignment; then the plan's edges: the SM count forced to 2 (one block a
slab walking every item), each item length and ring depth forced, the
split forced to 1 (the blocks write dw and db, no reduce pass), 2 and the
items of a slab, and the plan on the card's own SM count. One launch a
call, two calls bitwise equal.

Tolerance: phase 20's, ``chip_smoke.TOL`` (3e-4 relative and absolute)
with the absolute part scaled by max(1, max |want|): the kernel sums the
same float32 products as the plain version in another order.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_depthwise_bwd_card.py -m cuda
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tsb  # noqa: E402

RTOL = ATOL = 3e-4  # chip_smoke.TOL
TRAIN = (2, 515, 16384, 4)  # (B, L, C, K): a mamba conv in a jamba step
# (K, stride, (C, L)): phase 20's edges and K 9; (600, 9) has fewer dz
# rows than any item
EDGES = list(itertools.product((1, 2, 3, 4, 5, 9), (1, 2),
                               ((37, 203), (600, 9), (16384, 45))))


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


def _inputs(card, seed, B, L, C, K, stride, dtype, x_off=0, dz_off=0):
    """x (B, L, C) and dz (B, Lout, C), ``x_off`` and ``dz_off`` elements
    into their storage."""
    rng = np.random.default_rng(seed)
    lout = (L - K) // stride + 1

    def draw(n, off):
        flat = torch.from_numpy(rng.normal(size=(n + off,)).astype(
            np.float32)).to(card, dtype)
        return flat[off:]

    x = draw(B * L * C, x_off).view(B, L, C)
    dz = draw(B * lout * C, dz_off).view(B, lout, C)
    return x, dz


def _close(got, want):
    """Within TOL of the plain value, the absolute part scaled."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    atol = ATOL * max(1.0, want.abs().max().item())
    bad = err > atol + RTOL * want.abs()
    assert not bad.any(), f"{int(bad.sum())} off, max |err| {err.max()}"


def _case(x, dz, K, stride, has_bias):
    """One launch (counted) against the plain version; two calls bitwise
    equal."""
    before = tsb.conv1d_depthwise_bwd_dw.launches
    dw, db = tsb.conv1d_depthwise_bwd_dw(x, dz, K, stride=stride,
                                         has_bias=has_bias)
    assert tsb.conv1d_depthwise_bwd_dw.launches == before + 1
    want_dw, want_db = tsb.conv1d_depthwise_bwd_dw_plain(
        x, dz, K, stride=stride, has_bias=has_bias)
    _close(dw, want_dw)
    dw2, db2 = tsb.conv1d_depthwise_bwd_dw(x, dz, K, stride=stride,
                                           has_bias=has_bias)
    assert torch.equal(dw, dw2)
    if has_bias:
        _close(db, want_db)
        assert torch.equal(db, db2)
    else:
        assert db is None and db2 is None


@pytest.mark.cuda
@pytest.mark.parametrize("has_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_shape(card, dtype, has_bias):
    """Row 11 at jamba's training shape, the plan's split (S > 1: the
    workspace and one reduce pass)."""
    B, L, C, K = TRAIN
    x, dz = _inputs(card, 80, B, L, C, K, 1, getattr(torch, dtype))
    plan, cb = tsb.depthwise_dw_launch(x, dz, K, 1)
    assert cb == 16 and plan.splits > 1
    _case(x, dz, K, 1, has_bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,stride,CL", EDGES)
def test_edges(card, K, stride, CL, dtype):
    """Phase 20's edges and K 9, the bias and the offsets of x and dz by
    the edge's place in the list."""
    C, L = CL
    i = EDGES.index((K, stride, CL))
    x, dz = _inputs(card, i, 3, L, C, K, stride, getattr(torch, dtype),
                    x_off=i % 3, dz_off=(i // 3) % 3)
    _case(x, dz, K, stride, i % 2 == 0)


@pytest.fixture
def few_sms(monkeypatch):
    """The wrapper plans for a card of 2 SMs: one block a slab (S = 1)
    walks every item of its slab."""
    monkeypatch.setattr(build, "sm_count", lambda device: 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(*TRAIN, 1), (3, 203, 1032, 5, 2)],
                         ids=["train", "edge"])
def test_few_sms(card, few_sms, shape):
    """bf16 with db planned for 2 SMs: S = 1, dw and db written by the
    blocks themselves."""
    B, L, C, K, stride = shape
    lout = (L - K) // stride + 1
    plan = gemm_plan.depthwise_dw_plan(B, lout, C, 2, K, stride, 2)
    assert plan.splits == 1 and plan.blocks == plan.slabs
    x, dz = _inputs(card, 12, B, L, C, K, stride, torch.bfloat16)
    _case(x, dz, K, stride, True)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("rows", [4, 8, 16, 32, 64])
def test_forced_plans(card, monkeypatch, rows, stages):
    """Every item length and ring depth the kernel takes, at C 600 (a
    ragged slab), x one element off: bf16 at stride 1 and K 4 (taps
    unrolled) and at stride 2 and K 9 (tap groups), each fitting every
    pair; f32 at stride 1 and K 4, refused where its ring does not fit."""
    real = gemm_plan.depthwise_dw_plan
    monkeypatch.setattr(gemm_plan, "depthwise_dw_plan",
                        lambda *a, **k: real(*a, rows=rows, stages=stages))
    for seed, dtype, K, stride in ((14, torch.bfloat16, 4, 1),
                                   (15, torch.bfloat16, 9, 2),
                                   (16, torch.float32, 4, 1)):
        x, dz = _inputs(card, seed, 2, 299, 600, K, stride, dtype, x_off=1)
        smem = gemm_plan.depthwise_dw_smem(rows, stages, x.element_size(), K,
                                           stride)
        if smem > gemm_plan.SMEM_BLOCK:
            assert dtype == torch.float32
            with pytest.raises(ValueError):
                tsb.conv1d_depthwise_bwd_dw(x, dz, K, stride=stride)
        else:
            _case(x, dz, K, stride, True)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, "most"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_splits(card, monkeypatch, dtype, splits):
    """The split forced to 1 (no workspace), 2, and one block an item."""
    B, L, C, K = 2, 203, 1032, 4
    real = gemm_plan.depthwise_dw_plan
    n = B * real(B, L - K + 1, C, 4, K, 1).chunks
    S = n if splits == "most" else splits
    monkeypatch.setattr(gemm_plan, "depthwise_dw_plan",
                        lambda *a, **k: real(*a, splits=S))
    x, dz = _inputs(card, 16, B, L, C, K, 1, getattr(torch, dtype))
    plan, _ = tsb.depthwise_dw_launch(x, dz, K, 1)
    assert plan.splits == S and (plan.workspace > 0) == (S > 1)
    _case(x, dz, K, 1, True)


@pytest.mark.cuda
def test_plan_on_the_card(card):
    """The wrapper plans on the card's own SM count: a whole number of
    slab rounds, each slab split into at most its items."""
    B, L, C, K = TRAIN
    x, dz = _inputs(card, 17, B, L, C, K, 1, torch.bfloat16)
    plan, cb = tsb.depthwise_dw_launch(x, dz, K, 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert build.sm_count(x.device) == sms and cb == 16
    assert plan == gemm_plan.depthwise_dw_plan(B, L - K + 1, C, 2, K, 1, sms)
    assert plan.blocks == plan.slabs * plan.splits
    assert plan.splits <= plan.items // plan.slabs


@pytest.mark.cuda
def test_refused(card):
    """What the kernel does not take raises: float16 operands, operands of
    two types, a filter whose ring and sums fit no block."""
    x, dz = _inputs(card, 18, 1, 300, 64, 3, 1, torch.float16)
    with pytest.raises(TypeError):
        tsb.conv1d_depthwise_bwd_dw(x, dz, 3)
    with pytest.raises(TypeError):
        tsb.conv1d_depthwise_bwd_dw(x.float(), dz.bfloat16(), 3)
    x, dz = _inputs(card, 19, 1, 400, 64, 250, 1, torch.float32)
    with pytest.raises(ValueError):
        tsb.conv1d_depthwise_bwd_dw(x, dz, 250)
