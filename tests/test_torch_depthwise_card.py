"""The depthwise convs on ``csrc/depthwise_rows.cuh``'s staged body against
their plain versions, on the card.

Row 3, the float conv (``csrc/conv1d_depthwise.cu``), and row 15, the int8
conv (``csrc/conv1d_depthwise_quant.cu``), at jamba-1.5-large's prefill
shape ((4, 259, 16384), K 4) and, for row 3, its training shape ((2, 515,
16384), z written and not), then at ``chip_smoke.py`` phase 16's edges: K
in {2, 3, 4, 5}, strides 1 and 2, C 37, 600 and 1032, Lout shorter than
an item's rows, x one or two elements off its storage's alignment, with
and without bias and z, every activation; row 15 in w8a8 and in w8a16 on
float32 and bfloat16 x, float and requantized outputs. Then the plan's
edges: the SM count forced to 2 (a few persistent blocks walking many
items), each item length and ring depth forced, and the plan on the
card's own SM count. One launch a call, two calls bitwise equal.

Tolerances are phase 16's: float32 within 1e-6 of the largest output (the
sums are the plain version's, in its order and rounding; the activation's
last bits differ), bfloat16 within one bfloat16 step of the plain value
(gelu's 1 + tanh cancels near x = -5, where the step of its ~1e-7 values
falls below float32's error: there the float32 floor of 1e-6 of the
largest output holds too), requantized codes equal but for ties.

Needs an NVIDIA card and ``nvcc``; skips without a card. It imports neither
jax nor the JAX package, so it runs where the port runs (``--noconftest``:
the suite's conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_depthwise_card.py -m cuda
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, gemm_plan  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_conv_quant as tsq  # noqa: E402

ACTS = ("none", "relu", "gelu", "silu")
SERVE = (4, 259, 16384, 4)   # (B, L, C, K): mamba's prefill conv
TRAIN = (2, 515, 16384, 4)   # ... in a training step (512 tokens + K-1)
# (K, stride, C, L): phase 16's edges; (600, 9) has fewer output rows than
# any item
EDGES = list(itertools.product((2, 3, 4, 5), (1, 2),
                               ((37, 203), (600, 9), (1032, 64))))


@pytest.fixture
def card():
    """Skip without a card; full float32 (TF32 off) with one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch

    repro_torch.resolve_device("cuda")
    return "cuda"


def _inputs(card, seed, B, L, C, K, dtype, with_bias=True, offset=0):
    """x (``offset`` elements into its storage), w (K, C) and bias."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=(B * L * C + offset,)).astype(
        np.float32)).to(card, dtype)
    x = flat[offset:].view(B, L, C)
    w = torch.from_numpy((rng.normal(size=(K, C)) / np.sqrt(K)).astype(
        np.float32)).to(card, dtype)
    b = (torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)).to(card)
         if with_bias else None)
    return x, w, b


def _close(got, want, act="none"):
    """Phase 16's tolerance: float32 within 1e-6 of max |want|; bfloat16
    within one bf16 step of each plain value (for gelu, or within the
    float32 floor)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    floor = 1e-6 * max(1.0, w.abs().max().item())
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30)))
                          - 7)
        bad = (err > step) & (err > floor) if act == "gelu" else err > step
        assert not bad.any(), f"{int(bad.sum())} off by more than a step"
    else:
        assert err.max().item() <= floor, err.max().item()


def _fp_case(x, w, b, stride, act, z):
    """One launch (counted) against the plain version; with z, z too and y
    as without it; two calls bitwise equal."""
    args = dict(stride=stride, activation=act, save_preact=z)
    before = tsc.conv1d_depthwise.launches
    got = tsc.conv1d_depthwise(x, w, b, **args)
    assert tsc.conv1d_depthwise.launches == before + 1
    want = tsc.conv1d_depthwise_plain(x, w, b, **args)
    again = tsc.conv1d_depthwise(x, w, b, **args)
    if z:
        _close(got[0], want[0], act)
        _close(got[1], want[1])
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        assert torch.equal(got[0], tsc.conv1d_depthwise(
            x, w, b, stride=stride, activation=act))
    else:
        _close(got, want, act)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("z", [False, True])
@pytest.mark.parametrize("shape", [SERVE, TRAIN], ids=["serve", "train"])
def test_fp_jamba(card, shape, z):
    """Row 3 at jamba's prefill and training shapes, bf16, bias + silu."""
    B, L, C, K = shape
    x, w, b = _inputs(card, 40, B, L, C, K, torch.bfloat16)
    _fp_case(x, w, b, 1, "silu", z)


@pytest.mark.cuda
@pytest.mark.parametrize("z", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,stride,CL", EDGES)
def test_fp_edges(card, K, stride, CL, dtype, z):
    """Row 3 at phase 16's edges, the activation, bias and offset by the
    edge's place in the list."""
    C, L = CL
    i = EDGES.index((K, stride, CL))
    x, w, b = _inputs(card, i, 3, L, C, K, getattr(torch, dtype),
                      with_bias=i % 2 == 0, offset=i % 3)
    _fp_case(x, w, b, stride, ACTS[i % 4], z)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp_every_activation(card, dtype, act, with_bias):
    """Every activation, with and without bias, y and z, C 1032 (a ragged
    last slab) at stride 2."""
    x, w, b = _inputs(card, 9, 2, 301, 1032, 4, getattr(torch, dtype),
                      with_bias)
    _fp_case(x, w, b, 2, act, True)


def _quant_inputs(card, seed, B, L, C, K, mode, x_dtype, with_bias=True,
                  offset=0):
    """int8 weight codes with per-channel scales (1, C), a bias, and int8
    input codes with their scale (w8a8) or a float input (w8a16),
    ``offset`` elements into its storage; outputs O(1)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(-127, 128, size=(K, C),
                                      dtype=np.int8)).to(card)
    ws = torch.from_numpy((rng.uniform(0.5, 1.5, size=(1, C))
                           / (73 * np.sqrt(K))).astype(np.float32)).to(card)
    b = (torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)).to(card)
         if with_bias else None)
    n = B * L * C + offset
    if mode == "w8a8":
        x = torch.from_numpy(rng.integers(-127, 128, size=(n,),
                                          dtype=np.int8)).to(card)
        return (x[offset:].view(B, L, C), w, ws, b,
                torch.tensor(1 / 73, device=card))
    x = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(
        card, x_dtype)
    return x[offset:].view(B, L, C), w, ws, b, None


def _codes_close(got, want, pre):
    """int8 codes equal but for codes one apart where the plain version's
    ``pre`` (y / out_scale) lies within 1e-4 of a half-integer, at most
    1e-4 of them (chip_smoke.py's codes_close)."""
    assert got.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    off = diff > 0
    near = ((pre - pre.floor()).abs() - 0.5).abs() < 1e-4
    assert diff.max().item() <= 1 and not (off & ~near).any()
    assert int(off.sum()) <= 1e-4 * diff.numel()


def _quant_case(x, w, ws, b, xs, mode, stride, act, out_dtype, requant):
    """One launch (counted) against the plain version, two calls bitwise
    equal; with ``requant`` also the codes on a grid that clips the
    largest outputs."""
    args = dict(x_scale=xs, mode=mode, stride=stride, activation=act)
    before = tsq.conv1d_depthwise_quant.launches
    got = tsq.conv1d_depthwise_quant(x, w, ws, b, out_dtype=out_dtype, **args)
    assert tsq.conv1d_depthwise_quant.launches == before + 1
    want = tsq.conv1d_depthwise_quant_plain(x, w, ws, b, out_dtype=out_dtype,
                                            **args)
    _close(got, want, act)
    assert torch.equal(got, tsq.conv1d_depthwise_quant(
        x, w, ws, b, out_dtype=out_dtype, **args))
    if requant:
        y = tsq.conv1d_depthwise_quant_plain(x, w, ws, b, **args)
        os_ = (y.abs().max() * 0.8 / 127).reshape(())
        got_q = tsq.conv1d_depthwise_quant(x, w, ws, b, out_scale=os_, **args)
        want_q = tsq.conv1d_depthwise_quant_plain(x, w, ws, b, out_scale=os_,
                                                  **args)
        assert want_q.abs().max().item() == 127  # the clip is exercised
        _codes_close(got_q, want_q, y / os_)


QMODES = [("w8a8", "int8"), ("w8a16", "float32"), ("w8a16", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,x_dtype", QMODES)
def test_quant_jamba(card, mode, x_dtype, out_dtype):
    """Row 15 at jamba's prefill shape, silu, float output and the codes
    requantized."""
    B, L, C, K = SERVE
    x, w, ws, b, xs = _quant_inputs(card, 41, B, L, C, K, mode,
                                    getattr(torch, x_dtype))
    _quant_case(x, w, ws, b, xs, mode, 1, "silu", getattr(torch, out_dtype),
                True)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,x_dtype", QMODES)
@pytest.mark.parametrize("K,stride,CL", EDGES)
def test_quant_edges(card, K, stride, CL, mode, x_dtype, out_dtype):
    """Row 15 at phase 16's edges, the activation, bias and offset by the
    edge's place in the list, requantized where the activation is silu."""
    C, L = CL
    i = EDGES.index((K, stride, CL))
    act = ACTS[i % 4]
    x, w, ws, b, xs = _quant_inputs(card, 100 + i, 3, L, C, K, mode,
                                    getattr(torch, x_dtype), i % 2 == 0,
                                    offset=i % 3)
    _quant_case(x, w, ws, b, xs, mode, stride, act,
                getattr(torch, out_dtype), act == "silu")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,x_dtype", QMODES)
@pytest.mark.parametrize("act", ACTS)
def test_quant_every_activation(card, act, mode, x_dtype):
    """Every activation, requantized, at C 1032 and stride 2."""
    x, w, ws, b, xs = _quant_inputs(card, 11, 2, 301, 1032, 4, mode,
                                    getattr(torch, x_dtype))
    _quant_case(x, w, ws, b, xs, mode, 2, act, torch.bfloat16, True)


@pytest.fixture
def few_sms(monkeypatch):
    """The wrappers plan for a card of 2 SMs: a few persistent blocks each
    walk many items, across slabs, chunks and batch rows."""
    monkeypatch.setattr(build, "sm_count", lambda device: 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SERVE, (3, 203, 1032, 5)],
                         ids=["serve", "edge"])
def test_few_sms(card, few_sms, shape):
    """Rows 3 (y and z) and 15 (w8a8, requantized) planned for 2 SMs."""
    B, L, C, K = shape
    plan = gemm_plan.depthwise_plan(B, L - K + 1, C, 2, K, 1, 2)
    assert plan.blocks <= 2 * plan.per_sm < plan.items
    x, w, b = _inputs(card, 12, B, L, C, K, torch.bfloat16)
    _fp_case(x, w, b, 1, "silu", True)
    x, w, ws, b, xs = _quant_inputs(card, 13, B, L, C, K, "w8a8", None)
    _quant_case(x, w, ws, b, xs, "w8a8", 1, "silu", torch.bfloat16, True)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("rows", [4, 8, 16, 32, 64])
def test_forced_plans(card, monkeypatch, rows, stages):
    """Every item length and ring depth the kernel takes, at C 600 (a
    ragged slab): row 3 in bf16 at stride 1, row 15 in w8a8 at stride 2
    (the largest rings that fit a block)."""
    real = gemm_plan.depthwise_plan
    monkeypatch.setattr(gemm_plan, "depthwise_plan",
                        lambda *a, **k: real(*a, rows=rows, stages=stages))
    x, w, b = _inputs(card, 14, 2, 299, 600, 4, torch.bfloat16, offset=1)
    _fp_case(x, w, b, 1, "gelu", True)
    x, w, ws, b, xs = _quant_inputs(card, 15, 2, 299, 600, 4, "w8a8", None,
                                    offset=1)
    _quant_case(x, w, ws, b, xs, "w8a8", 2, "silu", torch.float32, True)


@pytest.mark.cuda
def test_plan_on_the_card(card):
    """The wrappers plan on the card's own SM count, and fill it at the
    prefill shape."""
    x, w, _ = _inputs(card, 16, *SERVE, torch.bfloat16)
    plan, cb = tsc.depthwise_launch(x, SERVE[3], 1, SERVE[1] - SERVE[3] + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert build.sm_count(x.device) == sms and cb == 16
    assert plan == gemm_plan.depthwise_plan(4, 256, 16384, 2, 4, 1, sms)
    rounds = -(-plan.items // (sms * plan.per_sm))
    assert plan.blocks == -(-plan.items // rounds)


@pytest.mark.cuda
def test_refused(card):
    """What the kernels do not take raises: float16 x, a filter whose ring
    fits no block."""
    x, w, b = _inputs(card, 17, 1, 300, 64, 3, torch.float16)
    with pytest.raises(TypeError):
        tsc.conv1d_depthwise(x, w, b)
    x, w, b = _inputs(card, 18, 1, 400, 64, 250, torch.float32)
    with pytest.raises(ValueError):
        tsc.conv1d_depthwise(x, w, b)
