"""The GEMM-convolution baselines of the PyTorch port against the JAX
reference, on the CPU.

The same numpy inputs go through the reference and through the port: the
1-D ``core.conv`` twins (``conv1d_im2col``, ``conv1d_xla``, the
``conv1d`` dispatcher, ``conv_flops``); the tiled GEMM's plain version
against ``matmul_pallas`` in interpret mode; the column-tensor baselines
``conv{1d,2d}_im2col_hbm`` against the reference's, in interpret mode;
the fused im2col kernels' plain versions; ``ops.conv1d`` / ``ops.conv2d``
on the ``im2col_gemm`` and ``im2col_hbm`` backends, ``ops.matmul`` and a
dilated ``ops.conv1d``; the serve CLI with ``--conv-backend im2col_gemm``.
The kernels themselves are held to their plain versions on the card by
``tests/test_torch_im2col_card.py``.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.kernels import im2col_gemm as jig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.kernels import im2col_gemm as tig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.quant import qconv  # noqa: E402

# float32: the sums run in another order than the reference's (the
# tolerance of tests/test_kernels.py); bfloat16 compared in float32
TOL = dict(rtol=3e-4, atol=3e-4)
BTOL = dict(rtol=5e-2, atol=5e-2)
ACTS = ("none", "relu", "gelu", "silu")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# -- core.conv: the 1-D twins --------------------------------------------------

@pytest.mark.parametrize("stride,dilation,groups", [
    (1, 1, 1), (2, 1, 1), (1, 2, 1), (3, 2, 2), (1, 1, 4)])
@pytest.mark.parametrize("padding", ["VALID", "SAME", "CAUSAL", (2, 1)])
@pytest.mark.parametrize("backend", ["sliding", "im2col_gemm", "xla"])
def test_core_conv1d_twins_match_reference(backend, padding, stride,
                                            dilation, groups):
    """Each backend of the port's ``core.conv.conv1d`` against the same
    backend of the reference's (groups 2 with 4 input channels a group:
    the twins' grouping is the reference's, see ``conv1d``)."""
    x, w = _normal(stride * 7 + dilation + groups, (2, 29, 8),
                   (3, 8 // groups, 12))
    args = dict(stride=stride, padding=padding, dilation=dilation,
                groups=groups, backend=backend)
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), **args))
    got = tconv.conv1d(*_t(x, w), **args)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("backend", ["sliding", "im2col_gemm", "xla"])
def test_core_conv1d_twins_bf16(backend):
    x, w = _normal(3, (2, 40, 6), (5, 6, 7))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(jconv.conv1d(xb, wb, padding="SAME", backend=backend),
                      np.float32)
    got = tconv.conv1d(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16(), padding="SAME",
                       backend=backend)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BTOL)


def test_core_conv1d_errors():
    x = torch.zeros(1, 9, 6)
    with pytest.raises(ValueError, match="groups mismatch"):
        tconv.conv1d_im2col(x, torch.zeros(3, 4, 6), groups=2)
    with pytest.raises(ValueError, match="divisible by groups"):
        tconv.conv1d_sliding(x, torch.zeros(3, 3, 5), groups=2)
    with pytest.raises(KeyError):
        tconv.conv1d(x, torch.zeros(3, 6, 2), backend="winograd")


@pytest.mark.parametrize("args", [
    (2, 100, 3, 16, 32), (1, (126, 126), (3, 3), 32, 32),
    (20, (24, 24), (14, 14), 3, 1152), (4, 512, 3, 80, 1024)])
def test_conv_flops_matches_reference(args):
    assert tconv.conv_flops(*args) == jconv.conv_flops(*args)


# -- row 5: the tiled GEMM -----------------------------------------------------

@pytest.mark.parametrize("M,K,N,tiles", [
    (200, 150, 70, {}), (1, 1, 1, {}), (129, 257, 65, {}),
    (64, 100, 48, dict(tm=64, tn=32, tk=32)), (300, 33, 200, dict(tk=16))])
def test_matmul_plain_matches_pallas_interpret(M, K, N, tiles):
    """Ragged M, N and K against the reference's Pallas GEMM, which pads
    them (interpret mode); the tile arguments do not change the port's
    result."""
    a, b = _normal(M + K + N, (M, K), (K, N))
    want = np.asarray(jig.matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True, **tiles))
    got = tig.matmul(*_t(a, b), **tiles)
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(tig.matmul_plain(*_t(a, b)).numpy(),
                                  got.numpy())


def test_matmul_bf16_matches_reference():
    """bfloat16 in, bfloat16 out (A's type); the reference rounds its
    running sum to bfloat16 after each 128-deep K slice, the port once."""
    a, b = _normal(9, (96, 300), (300, 40))
    ab, bb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(
        jnp.bfloat16)
    want = np.asarray(jig.matmul_pallas(ab, bb, interpret=True), np.float32)
    got = tig.matmul(torch.from_numpy(a).bfloat16(),
                     torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BTOL)


def test_ops_matmul_matches_reference():
    a, b = _normal(11, (70, 90), (90, 33))
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b),
                                  interpret=True))
    np.testing.assert_allclose(tops.matmul(*_t(a, b)).numpy(), want, **TOL)


# -- the column tensor in memory, then row 5 ----------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("K", [3, 7, 17])
def test_conv1d_hbm_matches_reference_interpret(K, stride):
    x, w = _normal(K + stride, (2, 200, 8), (K, 8, 16))
    want = np.asarray(jig.conv1d_im2col_hbm(jnp.asarray(x), jnp.asarray(w),
                                            stride=stride, interpret=True))
    got = tig.conv1d_im2col_hbm(*_t(x, w), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kh,kw,stride", [
    (3, 3, (1, 1)), (5, 5, (2, 2)), (7, 5, (2, 3)), (5, 5, (1, 1))])
def test_conv2d_hbm_matches_reference_interpret(kh, kw, stride):
    x, w = _normal(kh * kw, (1, 24, 26, 4), (kh, kw, 4, 8))
    want = np.asarray(jig.conv2d_im2col_hbm(jnp.asarray(x), jnp.asarray(w),
                                            stride=stride, interpret=True))
    got = tig.conv2d_im2col_hbm(*_t(x, w), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- rows 6 and 7: the fused im2col kernels' plain versions ---------------------
# The reference's fused Pallas kernels index their halo with pl.unblocked,
# which this container's jax lacks: they cannot trace here. The plain
# versions are held to the reference's own twins of the same function
# (core.conv1d_im2col / conv2d_im2col) and its oracles (kernels.ref), at
# tests/test_kernels.py's shapes.

@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("K", [3, 7, 17])
def test_conv1d_fused_plain_matches_reference_twins(K, stride):
    x, w = _normal(K * 3 + stride, (2, 200, 8), (K, 8, 16))
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    got = tig.conv1d_im2col_fused(*_t(x, w), stride=stride, tile_l=64)
    for want in (jconv.conv1d_im2col(xj, wj, stride=stride),
                 jref.conv1d_ref(xj, wj, stride=stride)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kh,kw,stride", [
    (3, 3, (1, 1)), (5, 5, (2, 2)), (7, 5, (2, 3)), (1, 1, (1, 1)),
    (14, 14, (14, 14))])
def test_conv2d_fused_plain_matches_reference_twins(kh, kw, stride):
    """The reference tests' shapes, and llava's patch-embedding filter."""
    cin = 3 if kh == 14 else 4
    x, w = _normal(kh * 10 + kw, (2, 33 if kh < 14 else 28, 29, cin),
                   (kh, kw, cin, 8))
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    got = tig.conv2d_im2col_fused(*_t(x, w), stride=stride, tile_h=8,
                                  tile_w=8)
    for want in (jconv.conv2d_im2col(xj, wj, stride=stride),
                 jref.conv2d_ref(xj, wj, stride=stride)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dims", [1, 2])
def test_fused_plain_bf16_matches_reference_twin(dims):
    """bfloat16 operands, output in x's type."""
    if dims == 1:
        x, w = _normal(21, (2, 60, 8), (5, 8, 16))
        fn, twin, args = tig.conv1d_im2col_fused, jconv.conv1d_im2col, dict(
            stride=2)
    else:
        x, w = _normal(22, (2, 20, 21, 4), (3, 5, 4, 8))
        fn, twin, args = tig.conv2d_im2col_fused, jconv.conv2d_im2col, dict(
            stride=(2, 1))
    want = np.asarray(twin(jnp.asarray(x).astype(jnp.bfloat16),
                           jnp.asarray(w).astype(jnp.bfloat16), **args),
                      np.float32)
    got = fn(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
             **args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BTOL)


# -- ops: the im2col backends, with bias and activation -----------------------

@pytest.mark.parametrize("padding", ["SAME", "VALID", "CAUSAL", (2, 1)])
@pytest.mark.parametrize("backend", ["im2col_gemm", "im2col_hbm"])
def test_ops_conv1d_im2col_backends_match_reference(backend, padding):
    """As ``tests/test_kernels.py::test_ops_conv1d_dispatch``: against the
    reference's ``ops.conv1d(backend="xla")``, here with bias and an
    activation (unfused on both sides)."""
    x, w, b = _normal(5, (2, 100, 16), (3, 16, 32), (32,))
    act = ACTS[len(str(padding)) % len(ACTS)]
    for stride in (1, 2):
        want = np.asarray(jops.conv1d(
            jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
            backend="xla", bias=jnp.asarray(b), activation=act))
        got = tops.conv1d(*_t(x, w), stride=stride, padding=padding,
                          backend=backend, bias=torch.from_numpy(b),
                          activation=act)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((2, 1), (0, 3))])
@pytest.mark.parametrize("backend", ["im2col_gemm", "im2col_hbm"])
def test_ops_conv2d_im2col_backends_match_reference(backend, padding):
    x, w, b = _normal(6, (1, 20, 20, 8), (5, 5, 8, 16), (16,))
    for stride, act in (((1, 1), "gelu"), ((2, 3), "relu")):
        want = np.asarray(jops.conv2d(
            jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
            backend="xla", bias=jnp.asarray(b), activation=act))
        got = tops.conv2d(*_t(x, w), stride=stride, padding=padding,
                          backend=backend, bias=torch.from_numpy(b),
                          activation=act)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("backend", ["sliding", "sliding_pallas", "xla",
                                     "im2col_gemm", "im2col_hbm"])
def test_ops_conv1d_dilated_matches_reference(backend):
    """Dilation 2 and 3 go to the ``core.conv`` twins (the sliding one for
    the sliding backends, the im2col one otherwise), as in the
    reference."""
    x, w, b = _normal(7, (2, 50, 6), (3, 6, 10), (10,))
    for dilation, padding in ((2, "SAME"), (3, "CAUSAL")):
        want = np.asarray(jops.conv1d(
            jnp.asarray(x), jnp.asarray(w), padding=padding,
            dilation=dilation, backend="xla", bias=jnp.asarray(b),
            activation="silu"))
        got = tops.conv1d(*_t(x, w), padding=padding, dilation=dilation,
                          backend=backend, bias=torch.from_numpy(b),
                          activation="silu")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ops_conv1d_refusals():
    x, w = torch.zeros(1, 9, 4), torch.zeros(3, 4, 5)
    with pytest.raises(ValueError, match="unknown conv backend"):
        tops.conv1d(x, w, backend="winograd")
    with pytest.raises(ValueError, match="dilation == 1 only"):
        tops.conv1d(x, w, precision="w8a8", dilation=2)
    with pytest.raises(ValueError, match="sliding_pallas backend only"):
        tops.conv1d(x, w, precision="w8a8", backend="im2col_gemm")


def test_wrappers_refuse_bad_input_and_count_no_cpu_launches():
    x, w = torch.zeros(1, 9, 4), torch.zeros(3, 4, 5)
    before = (tig.matmul.launches, tig.conv1d_im2col_fused.launches,
              tig.conv2d_im2col_fused.launches)
    tig.conv1d_im2col_fused(x, w)
    tig.conv1d_im2col_hbm(x, w)
    tig.conv2d_im2col_fused(x[:, None].expand(1, 4, 9, 4), w[None])
    assert (tig.matmul.launches, tig.conv1d_im2col_fused.launches,
            tig.conv2d_im2col_fused.launches) == before
    with pytest.raises(ValueError, match="exceeds input"):
        tig.conv1d_im2col_fused(x, torch.zeros(10, 4, 5))
    with pytest.raises(ValueError, match="do not form"):
        tig.conv1d_im2col_hbm(x, torch.zeros(3, 2, 5))
    with pytest.raises(ValueError, match="exceeds input"):
        tig.conv2d_im2col_hbm(torch.zeros(1, 5, 5, 4), torch.zeros(3, 6, 4, 5))
    with pytest.raises(ValueError, match="do not form"):
        tig.matmul(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError, match="tile_l"):
        tig.conv1d_im2col_fused(x, w, tile_l=0)
    with pytest.raises(ValueError, match="tk"):
        tig.matmul(torch.zeros(3, 4), torch.zeros(4, 6), tk=0)
    with pytest.raises(ValueError, match="no matmul for device"):
        tig.matmul(torch.zeros(3, 4, device="meta"),
                   torch.zeros(4, 6, device="meta"))
    with pytest.raises(ValueError, match="no conv2d_im2col_fused for device"):
        tig.conv2d_im2col_fused(torch.zeros(1, 5, 5, 4, device="meta"),
                                torch.zeros(3, 3, 4, 5, device="meta"))


def test_columns_are_the_im2col_matrix():
    """Column (i·kw + j)·Cin + c of row (b, oy, ox) is x[b, oy·sh + i,
    ox·sw + j, c]."""
    x = torch.arange(2 * 7 * 8 * 3, dtype=torch.float32).reshape(2, 7, 8, 3)
    col = tig.columns_2d(x, 3, 2, (2, 3))
    assert col.is_contiguous() and col.shape == (2 * 3 * 3, 3 * 2 * 3)
    b, oy, ox, i, j, c = 1, 2, 1, 2, 1, 2
    assert col[(b * 3 + oy) * 3 + ox, (i * 2 + j) * 3 + c] == x[
        b, oy * 2 + i, ox * 3 + j, c]
    col1 = tig.columns_1d(x[:, 0], 3, 2)
    assert col1.shape == (2 * 3, 3 * 3) and col1.is_contiguous()
    assert col1[1 * 3 + 2, 2 * 3 + 1] == x[1, 0, 2 * 2 + 2, 1]
    # stride 1: an overlapping view of x until copied
    x1 = torch.arange(2 * 9 * 4, dtype=torch.float32).reshape(2, 9, 4)
    col1 = tig.columns_1d(x1, 3, 1)
    assert col1.is_contiguous() and col1.data_ptr() != x1.data_ptr()
    assert torch.equal(col1[1 * 7 + 4], x1[1, 4:7].reshape(-1))


# -- the model layers and the CLIs ------------------------------------------------

def test_layers_im2col_gemm_runs_the_core_twin(monkeypatch):
    """``layers.conv1d_bias_act(backend="im2col_gemm")`` is the core
    column-tensor twin with the unfused epilogue (the reference's
    ``layers.py``), not the fused kernel."""
    def refuse(*a, **k):
        raise AssertionError("the fused kernel's wrapper was called")

    monkeypatch.setattr(tig, "conv1d_im2col_fused", refuse)
    x, w, b = _normal(8, (2, 32, 80), (3, 80, 24), (24,))
    want = np.asarray(jL.conv1d_bias_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation="gelu",
        stride=2, padding="SAME", backend="im2col_gemm"))
    got = tL.conv1d_bias_act(*_t(x, w, b), activation="gelu", stride=2,
                             padding="SAME", backend="im2col_gemm")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _sample(out: str) -> str:
    return next(line.split("sample:", 1)[1].strip()
                for line in out.splitlines() if "[serve] sample:" in line)


def _reference_cli(monkeypatch, args):
    """The reference's serve CLI, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *args])
    jserve.main()


SERVE_ARGS = ["--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "4",
              "--conv-backend", "im2col_gemm"]


def test_whisper_serve_cli_im2col_gemm_gives_reference_tokens(monkeypatch,
                                                              capsys):
    """The whisper serve CLI on ``--conv-backend im2col_gemm``, on the
    reference's init (the port's model init replaced by the reference's
    weights through ``bridge.params_from_numpy``): the same sample tokens
    as the reference's CLI."""
    _reference_cli(monkeypatch, ["--arch", "whisper-medium", *SERVE_ARGS])
    want = _sample(capsys.readouterr().out)
    jm = jbuild_model(jsmoke_config(jget_config("whisper-medium")))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    monkeypatch.setattr(
        twhisper.Whisper, "init",
        lambda self, gen: params_from_numpy(jp, "cpu",
                                            defs=self.param_defs()))
    tserve.main(["--arch", "whisper-medium", *SERVE_ARGS, "--device", "cpu"])
    got = _sample(capsys.readouterr().out)
    assert got == want and len(got.strip("[]").split()) == 4


def test_jamba_im2col_gemm_raises_as_the_reference(monkeypatch):
    """The reference's mamba conv has no im2col_gemm backend and raises
    ``ValueError``; so does the port's."""
    args = ["--arch", "jamba-1.5-large-398b", *SERVE_ARGS]
    with pytest.raises(ValueError, match="im2col_gemm"):
        _reference_cli(monkeypatch, args)
    with pytest.raises(ValueError, match="im2col_gemm"):
        tserve.main([*args, "--device", "cpu"])


# -- quant: the calibrated scales follow the weight ------------------------------

def test_quantize_weight_places_scales_on_the_weight_device():
    """A weight on another device (``meta`` stands in for the card here)
    with calibration's CPU scales: every field of the ``QuantizedWeight``
    lies on the weight's device, values and types kept."""
    xs, os = torch.tensor(0.25), torch.tensor(0.5, dtype=torch.float32)
    qw = qconv.quantize_weight(torch.zeros(3, 3, 4, 5, device="meta"),
                               x_scale=xs, out_scale=os)
    assert {t.device.type for t in qw} == {"meta"}
    assert qw.x_scale.dtype == torch.float32 and qw.x_scale.shape == ()
    qc = qconv.quantize_weight(torch.ones(3, 4), x_scale=xs)
    assert qc.x_scale.item() == 0.25 and qc.out_scale is None
