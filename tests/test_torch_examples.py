"""The four examples' PyTorch ports (``examples/*_torch.py``) on the CPU.

The edge CNN against ``examples/edge_cnn.py`` on ``sliding``,
``im2col_gemm`` and ``sliding_pallas`` (on the CPU the port's
``sliding_pallas`` runs the 2-D kernels' plain versions): the reference's
init carried across with ``bridge.params_from_numpy``, the same batches
from one numpy seed, five
SGD steps (losses and parameters within 1e-4), ``quantize_net``'s int8
leaves and scales, the w8a8 chain's int8 codes (equal but at ties) and
logits, and the dequant sites. The quickstart, serve_decode (qwen3-1.7b and
rwkv6-1.6b) and train_lm ports run through their ``main`` at a small size.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro_torch import quant as tquant  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIE = 1e-3  # code units: how near a half-integer float rounding can move
STEPS, N = 5, 64
BACKENDS = ("sliding", "im2col_gemm", "sliding_pallas")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def E():
    return _load("edge_cnn")


@pytest.fixture(scope="module")
def T():
    return _load("edge_cnn_torch")


def _ref_train(E, backend, steps):
    """The reference example's training loop (its jitted SGD step at lr
    0.03): (init params, params after ``steps``, losses, the rng)."""
    rng = np.random.default_rng(0)
    p0 = E.init_params(jax.random.key(0), backend)

    def loss_fn(p, x, y):
        logits = E.forward(p, x, backend)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y])

    @jax.jit
    def step(p, x, y):
        loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        return jax.tree.map(lambda a, b: a - 0.03 * b, p, g), loss

    p, losses = p0, []
    for _ in range(steps):
        x, y = E.synthetic_task(rng, N)
        p, loss = step(p, x, y)
        losses.append(float(loss))
    return p0, p, losses, rng


@pytest.fixture(scope="module", params=BACKENDS)
def trained(request, E):
    backend = request.param
    p0, p, losses, rng = _ref_train(E, backend, STEPS)
    return dict(backend=backend, p0=p0, p=p, losses=losses, rng=rng)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_synthetic_task_matches_reference(E, T):
    """The same images and labels from the same numpy seed."""
    jx, jy = E.synthetic_task(np.random.default_rng(3), 8)
    tx, ty = T.synthetic_task(np.random.default_rng(3), 8)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tx.shape == (8, 28, 28, 1) and tx.dtype == torch.float32


def test_sgd_steps_match_reference(trained, T):
    """Five SGD steps from the reference's init on the same batches:
    losses and every parameter within 1e-4."""
    backend = trained["backend"]
    p = params_from_numpy(_np(trained["p0"]), "cpu")
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(STEPS):
        x, y = T.synthetic_task(rng, N)
        p, loss = T.sgd_step(p, x, y, backend)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, trained["losses"], rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0]
    for k, want in _np(trained["p"]).items():
        np.testing.assert_allclose(p[k].numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{backend} {k}")


def test_w8a8_chain_matches_reference(trained, E, T):
    """``quantize_net`` on the trained weights and one calibration batch:
    the same int8 codes and scales, the same calibrated input and output
    scales. Then the w8a8 convs on the reference's inputs: c1 and c2 emit
    int8 codes equal to the reference's but for ties, c3 float within 1e-5
    of max |y|. The whole chain: the one dequant site ``edge/c3`` in both,
    the same predicted classes, logits within 1e-2 of max |logit| (a code
    one apart at a tie moves them up to ~4e-4)."""
    backend, rng = trained["backend"], np.random.default_rng(11)
    cx, _ = E.synthetic_task(rng, 16)
    x, _ = E.synthetic_task(rng, 32)
    jp = trained["p"]
    jqp = E.quantize_net(jp, cx, backend)
    tqp = T.quantize_net(params_from_numpy(_np(jp), "cpu"),
                         torch.from_numpy(np.array(cx)), backend)
    for key, site in T.SITES:
        j, t = jqp[key], tqp[key]
        assert isinstance(t, tquant.QuantizedWeight), key
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q), key)
        for f in ("scale", "x_scale", "out_scale"):
            want = getattr(j, f)
            got = getattr(t, f)
            assert (got is None) == (want is None), (key, f)
            if want is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, err_msg=f"{key} {f}")
    assert tqp["c3"].out_scale is None and tqp["c1"].out_scale is not None

    # layer by layer on the reference's inputs: c1 and c2 emit int8 codes
    # equal but at ties, c3 float within 1e-5 of max |y|
    hj = x
    for i, (key, site) in enumerate(T.SITES):
        jy = E.L.conv2d_bias_act(hj, jqp[key], None, activation="relu",
                                 padding="SAME", backend=backend,
                                 precision="w8a8", site=site)
        with torch.no_grad():
            ty = T.L.conv2d_bias_act(torch.from_numpy(np.array(hj)), tqp[key],
                                     None, activation="relu", padding="SAME",
                                     backend=backend, precision="w8a8",
                                     site=site)
        want = np.asarray(jy)
        if i == 2:
            assert ty.dtype == torch.float32
            np.testing.assert_allclose(ty.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            break
        q = jqp[key]  # the float value each code rounds from
        yf = E.L.conv2d_bias_act(
            hj, jquant.QuantizedWeight(q.q, q.scale, q.x_scale, None), None,
            activation="relu", padding="SAME", backend=backend,
            precision="w8a8", site=site)
        pre = np.asarray(yf) / np.asarray(q.out_scale)
        assert ty.dtype == torch.int8, key
        diff = np.abs(ty.numpy().astype(np.int32) - want.astype(np.int32))
        near_tie = np.abs(np.abs(pre - np.floor(pre)) - 0.5) < TIE
        assert diff.max() <= 1 and (near_tie | (diff == 0)).all(), key
        hj = E.core.max_pool2d(jy, (2, 2))
    # the whole chain: the one dequant site, logits within one code's
    # reach of the reference's and the same predicted classes
    with jquant.counting_dequants() as jdeq:
        jl = np.asarray(E.forward(jqp, x, backend, precision="w8a8"))
    with torch.no_grad(), tquant.counting_dequants() as tdeq:
        tl = T.forward(tqp, torch.from_numpy(np.array(x)), backend,
                       precision="w8a8").numpy()
    assert jdeq == tdeq == ["edge/c3"]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-2 * np.abs(jl).max())
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_edge_cnn_main_runs(T, capsys):
    """The CLI at a few steps with ``--quant int8``: its numbers returned,
    its asserts passed (the quadrant task is solved within a few
    steps)."""
    out = T.main(["--device", "cpu", "--steps", "4", "--backend", "xla",
                  "--quant", "int8"])
    assert len(out["losses"]) == 4 and out["acc"] > 0.9
    assert out["dequant_sites"] == ["edge/c3"]
    assert abs(out["acc"] - out["acc_q"]) <= 0.02
    assert "[cnn/xla] int8 (w8a8) test acc" in capsys.readouterr().out


def test_quickstart_runs():
    out = _load("quickstart_torch").main(["--device", "cpu"])
    assert out["max_diff_im2col"] < 1e-3 and out["max_diff_xla"] < 1e-3
    assert out["kernel_vs_plain"] < 1e-4
    assert out["regimes"] == {3: "custom", 5: "custom", 9: "generic",
                              17: "generic", 25: "compound"}
    assert out["clock"] == "host clock, CPU"
    assert all(ms > 0 for ms in out["fig1_k17_ms"].values())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
def test_serve_decode_runs(arch, capsys):
    out = _load("serve_decode_torch").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2",
         "--prompt-len", "8", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert "determinism check passed" in capsys.readouterr().out


def test_train_lm_runs(tmp_path):
    out = _load("train_lm_torch").main(
        ["--device", "cpu", "--steps", "12", "--batch", "2", "--seq", "64",
         "--run-dir", str(tmp_path)])
    assert len(out["losses"]) == 12 and out["final_loss"] < out["first10"]
