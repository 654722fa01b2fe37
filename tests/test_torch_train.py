"""The port's whisper training slice against the JAX reference, on the CPU.

One set of smoke-config weights (float32) is made by the reference and
carried across with ``repro_torch.bridge.params_from_numpy``; the same numpy
batch goes to both. The reference runs ``conv_backend="sliding_pallas"``,
which under this container's jax serves its compiled-JAX rung; the port
runs ``sliding_pallas``, whose autograd Function runs the kernels' plain
versions on CPU tensors. Then the train loops: the port resumes from a
step directory the reference wrote and must continue its loss curve.
"""
import argparse
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_from_step_dir  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptConfig, global_norm, init_opt_state  # noqa: E402

B, S = 2, 64


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(tokens=rng.integers(2, 512, (B, S)).astype(np.int32),
                labels=rng.integers(-1, 512, (B, S)).astype(np.int32),
                frames=rng.normal(size=(B, S, 80)).astype(np.float32))


def _ref_value_and_grad(backend, batch):
    jm = jbuild_model(jsmoke_config(jget_config("whisper-medium")).replace(
        conv_backend=backend))
    jp = jm.init(jax.random.key(0))
    loss, grads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jp, float(loss), dict(iter_leaves(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def reference():
    """The reference's loss and grads on one batch (``sliding_pallas``),
    and its grads with the ``xla`` conv backend: the two compute the same
    function with sums in another order."""
    batch = _batch()
    jp, loss, grads = _ref_value_and_grad("sliding_pallas", batch)
    _, _, grads_xla = _ref_value_and_grad("xla", batch)
    return batch, jp, loss, grads, grads_xla


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_every_grad_match_reference(reference, remat):
    """Loss within 1e-5. Each gradient leaf within rtol 1e-4 and an atol of
    (1e-4 + 3·spread)·max|g|, spread the reference's own: this
    random-weight model amplifies float32 rounding, so the reference's
    ``xla`` and ``sliding_pallas`` backends, which compute the same
    function with sums in another order, already differ by up to 5e-4 of
    a leaf's max|g| here (``spread``, the largest such fraction over the
    leaves)."""
    batch, jp, jloss, jgrads, jgrads_xla = reference
    cfg = smoke_config(get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas", remat=remat)
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                               defs=model.param_defs())
    loss, grads = tsteps.loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    got = dict(iter_leaves(grads))
    assert set(got) == set(jgrads)
    spread = max(np.abs(jgrads_xla[p] - g).max() / np.abs(g).max()
                 for p, g in jgrads.items())
    assert spread < 2e-3, spread  # the model's own sensitivity stays small
    for path, g in got.items():
        want = jgrads[path]
        atol = (1e-4 + 3 * spread) * np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=atol,
                                   err_msg=path)


def test_remat_changes_no_grad(reference):
    """Recomputing each block in backward gives the same grads, bit for
    bit, as keeping its activations."""
    batch, jp, *_ = reference
    out = {}
    for remat in ("block", "none"):
        model = build_model(smoke_config(get_config("whisper-medium")).replace(
            conv_backend="sliding_pallas", remat=remat))
        params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _, grads = tsteps.loss_and_grads(
            model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
        out[remat] = dict(iter_leaves(grads))
    for path, g in out["block"].items():
        assert torch.equal(g, out["none"][path]), path


def test_grad_accumulation_averages_microbatches():
    """Two microbatches of one give the mean loss and the mean grads of the
    two single-row steps (taken first: the step updates the params in
    place)."""
    cfg = smoke_config(get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = OptConfig(total_steps=10, warmup_steps=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    rows = [tsteps.loss_and_grads(model, params,
                                  {k: v[i:i + 1] for k, v in batch.items()})
            for i in range(2)]
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    _, m2 = tsteps.make_train_step(model, opt_cfg, accum_steps=2)(state, batch)
    np.testing.assert_allclose(float(m2["loss"]),
                               (float(rows[0][0]) + float(rows[1][0])) / 2,
                               rtol=1e-6)
    mean = {p: (a + b) / 2 for (p, a), (_, b) in zip(iter_leaves(rows[0][1]),
                                                    iter_leaves(rows[1][1]))}
    np.testing.assert_allclose(float(m2["grad_norm"]), float(global_norm(mean)),
                               rtol=1e-5)


# -- train loops ---------------------------------------------------------------

def _args(run_dir, **over):
    d = dict(
        arch="whisper-medium", smoke=True, steps=4, batch=2, seq=64, lr=3e-4,
        seed=0, run_dir=str(run_dir), ckpt_every=1, log_every=1, grad_accum=1,
        conv_backend="sliding_pallas", audio_frontend="mels", no_resume=True,
        fail_at=None, max_restarts=0,
    )
    d.update(over)
    return argparse.Namespace(**d)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's train loop, steps 0-3, with a checkpoint every step."""
    from repro.launch.train import train_loop

    run = tmp_path_factory.mktemp("ref_run")
    out = train_loop(_args(run))
    return run, out["losses"]


def test_port_resumes_the_reference_run(reference_run, tmp_path):
    """The port resumes from the reference's step-1 checkpoint and gives
    the reference's losses at steps 2 and 3."""
    run, ref_losses = reference_run
    assert len(ref_losses) == 4 and min(ref_losses[1:]) < ref_losses[0]
    (tmp_path / "ckpt").mkdir()
    shutil.copytree(run / "ckpt" / "step_1", tmp_path / "ckpt" / "step_1")
    out = ttrain.train_loop(_args(tmp_path, no_resume=False, device="cpu"))
    np.testing.assert_allclose(out["losses"], ref_losses[2:], rtol=1e-4)


def test_bridge_loads_a_reference_step_dir(reference_run):
    run, _ = reference_run
    model = build_model(smoke_config(get_config("whisper-medium")))
    state = state_from_step_dir(run / "ckpt" / "step_1", model.param_defs(), "cpu")
    assert int(state["opt"]["count"]) == 2
    defs = dict(iter_leaves(model.param_defs()))
    for tree in (state["params"], state["opt"]["m"], state["opt"]["v"]):
        assert {p: tuple(t.shape) for p, t in iter_leaves(tree)} == {
            p: d.shape for p, d in defs.items()}
    wrong = build_model(smoke_config(get_config("whisper-medium")).replace(d_ff=64))
    with pytest.raises(ValueError, match="shape mismatch"):
        state_from_step_dir(run / "ckpt" / "step_1", wrong.param_defs(), "cpu")


def test_reference_restores_a_port_step_dir_with_bf16_leaves(tmp_path):
    """The reference's CheckpointManager reads what the port wrote; a
    bfloat16 leaf comes back as its 2-byte bits, equal to JAX's."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointManager

    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    state = {"params": {"w": torch.from_numpy(vals).to(torch.bfloat16),
                        "b": torch.arange(4, dtype=torch.float32)},
             "opt": {"count": torch.tensor(7, dtype=torch.int32)}}
    CheckpointManager(tmp_path).save(5, state)
    skeleton = {"params": {"w": 0, "b": 0}, "opt": {"count": 0}}
    got = JManager(tmp_path).restore(5, skeleton)
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got["params"]["w"].view(np.uint16),
                                  want.view(np.uint16))
    np.testing.assert_array_equal(got["params"]["b"], np.arange(4))
    assert int(got["opt"]["count"]) == 7
    manifest = JManager(tmp_path).manifest(5)["leaves"]
    assert manifest["params.w"]["dtype"] == "bfloat16"
    # and the port reads it back, bits and all
    back = CheckpointManager(tmp_path).restore(5, state)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"], state["params"]["w"])


def test_resume_after_a_crash_replays_the_same_losses(tmp_path):
    """A run crashed at step 2 and resumed gives the losses of an
    uninterrupted run (the data and frame streams are pure functions of
    (seed, step))."""
    whole = ttrain.train_loop(_args(tmp_path / "a", device="cpu"))
    crash = _args(tmp_path / "b", device="cpu", fail_at=2, no_resume=False)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        ttrain.train_loop(crash)
    crash.fail_at = None
    resumed = ttrain.train_loop(crash)
    np.testing.assert_allclose(resumed["losses"], whole["losses"][3:], rtol=1e-6)


def test_train_cli_restarts_and_finishes(tmp_path, capsys):
    out = ttrain.main([
        "--arch", "whisper-medium",
        "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq", "32", "--audio-frontend", "mels", "--conv-backend",
        "sliding_pallas", "--run-dir", str(tmp_path), "--ckpt-every", "1",
        "--log-every", "1", "--fail-at", "1", "--max-restarts", "1",
    ])
    text = capsys.readouterr().out
    assert "[train] step 0 loss " in text and " gnorm " in text and " lr " in text
    assert "[ft] injected failure at step 1; restarting" in text
    assert "[train] resumed from step 1" in text
    assert "[train] done; final loss" in text and len(out["losses"]) == 1
    assert (tmp_path / "heartbeats" / "host_0").exists()


def test_train_cli_rejects_trace(capsys):
    """--trace is ported (tests/test_torch_serve_cli.py runs it); as in the
    reference's parser it is a switch, and a value given to it is
    rejected."""
    with pytest.raises(SystemExit):
        ttrain.main(["--smoke", "--device", "cpu", "--trace=on"])
    err = capsys.readouterr().err
    assert "ignored explicit argument" in err and "not ported yet" not in err
