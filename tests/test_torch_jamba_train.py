"""The port's jamba training slice against the JAX reference, on the CPU.

jamba-1.5-large-398b's smoke config (float32, one period: 7 Mamba blocks,
one attention block, 4 experts top-2 on the odd positions) on one batch of
B=2, 64 tokens. The reference makes the weights
(``model.init(jax.random.key(0))``), carried across with
``repro_torch.bridge.params_from_numpy``, and runs
``conv_backend="sliding_pallas"``, whose depthwise Pallas rungs demote here
to its plain depthwise conv, differentiated by JAX; the port runs
``sliding_pallas`` too, whose ``Conv1dDepthwise`` runs the kernels' plain
versions on CPU tensors.

Numerics. At the reference's own init this model is ill-conditioned (the
period-stacked fan-in quirk, ROADMAP Queue 3): the reference's ``xla`` and
``sliding_pallas`` conv backends, which compute the same function with
sums in another order, give gradient leaves up to half of a leaf's max |g|
apart. On those weights the port is held to three times that spread, as
``tests/test_torch_train.py`` holds whisper's, and the loss to 1e-5 plus
three times the backends' loss spread. On the same weights rescaled to std
1/sqrt(input width) (``test_torch_jamba._conditioned``) the model is well
conditioned: loss and every gradient leaf within ``TOL``
(``tests/test_kernels.py``).
"""
import argparse
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import init_opt_state as jinit_opt_state  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_from_step_dir  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.kernels import sliding_conv1d as tsc  # noqa: E402
from repro_torch.kernels import sliding_conv_bwd as tsb  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from test_torch_jamba import _conditioned  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py TOL
B, S = 2, 64
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(tokens=rng.integers(2, 512, (B, S)).astype(np.int32),
                labels=rng.integers(-1, 512, (B, S)).astype(np.int32))


def _jcfg(backend="sliding_pallas"):
    return jsmoke_config(jget_config(ARCH)).replace(conv_backend=backend)


def _ref_value_and_grad(params, batch, backend="sliding_pallas"):
    jm = jbuild_model(_jcfg(backend))
    loss, grads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), dict(iter_leaves(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def ref():
    """The reference's weights (its own and rescaled), its loss and grads
    on one batch (own weights: ``sliding_pallas`` and ``xla``; rescaled:
    ``sliding_pallas``), and one train step on the rescaled weights with
    two microbatches and a bfloat16 accumulator."""
    batch = _batch()
    jm = jbuild_model(_jcfg())
    own = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    cond = _conditioned(own, jm.param_defs())
    out = dict(batch=batch, own=own, cond=cond)
    out["own_grads"] = _ref_value_and_grad(own, batch)
    out["own_grads_xla"] = _ref_value_and_grad(own, batch, "xla")
    out["cond_grads"] = _ref_value_and_grad(cond, batch)
    jcfg = _jcfg().replace(grad_accum=2)
    jp = jax.tree.map(jnp.asarray, cond)
    state = {"params": jp, "opt": jinit_opt_state(jp, JOptConfig(**OPT))}
    step = jmake_train_step(jbuild_model(jcfg), JOptConfig(**OPT),
                            accum_steps=2, accum_dtype="bfloat16")
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    out["step"] = (dict(iter_leaves(jax.tree.map(np.asarray, new["params"]))),
                   float(metrics["loss"]), float(metrics["grad_norm"]))
    return out


def _port(remat="block"):
    return build_model(smoke_config(get_config(ARCH)).replace(
        conv_backend="sliding_pallas", remat=remat))


def _loss_and_grads(model, params, batch):
    loss, grads = tsteps.loss_and_grads(
        model, params_from_numpy(params, "cpu", defs=model.param_defs()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), dict(iter_leaves(grads))


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_every_grad_match_reference_conditioned(ref, remat):
    """Rescaled weights: loss within 1e-5, every gradient leaf within TOL
    with atol taken times max(1, max |g|) (``tests/test_grads.py``
    ``_close_scaled``), with and without remat per position."""
    jloss, jgrads = ref["cond_grads"]
    loss, grads = _loss_and_grads(_port(remat), ref["cond"], ref["batch"])
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        want = jgrads[path]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, np.abs(want).max()), err_msg=path)
    conv = [grads[f"periods/pos{j}/mamba/conv_w"] for j in (0, 1, 2, 3, 5, 6, 7)]
    assert all(g.abs().max() > 0 for g in conv)


def test_loss_and_every_grad_within_the_reference_spread(ref):
    """The reference's own weights: every gradient leaf within rtol 1e-4
    and an atol of (1e-4 + 3·spread)·max|g|, spread the largest fraction
    of a leaf's max |g| by which the reference's two conv backends differ;
    the loss within 1e-5 plus three times their loss spread, relative."""
    jloss, jgrads = ref["own_grads"]
    xloss, xgrads = ref["own_grads_xla"]
    loss, grads = _loss_and_grads(_port(), ref["own"], ref["batch"])
    spread = max(np.abs(xgrads[p] - g).max() / np.abs(g).max()
                 for p, g in jgrads.items())
    loss_spread = abs(xloss - jloss) / abs(jloss)
    assert abs(loss - jloss) / abs(jloss) <= 1e-5 + 3 * loss_spread
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        want = jgrads[path]
        assert np.isfinite(g.numpy()).all(), path
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4,
            atol=(1e-4 + 3 * spread) * np.abs(want).max(), err_msg=path)


def test_remat_changes_no_grad_and_counts_the_conv_calls(ref, monkeypatch):
    """Recomputing each position in backward gives the same grads, bit for
    bit, as keeping its activations. With remat, a step's Mamba convs run
    the forward depthwise kernel (here its plain version) three times a
    block, twice saving the pre-activation (forward and recompute) and once
    for dx, and the dw kernel once a block: the counts ``chip_smoke.py``
    expects on the card."""
    calls = {"fwd_z": 0, "fwd": 0, "dw": 0}
    fwd, dw = tsc.conv1d_depthwise, tsb.conv1d_depthwise_bwd_dw

    def count_fwd(*a, save_preact=False, **kw):
        calls["fwd_z" if save_preact else "fwd"] += 1
        return fwd(*a, save_preact=save_preact, **kw)

    def count_dw(*a, **kw):
        calls["dw"] += 1
        return dw(*a, **kw)

    monkeypatch.setattr(tsc, "conv1d_depthwise", count_fwd)
    monkeypatch.setattr(tsb, "conv1d_depthwise_bwd_dw", count_dw)
    out = {}
    for remat in ("block", "none"):
        for k in calls:
            calls[k] = 0
        out[remat] = _loss_and_grads(_port(remat), ref["cond"], ref["batch"])[1]
        want = dict(fwd_z=14 if remat == "block" else 7, fwd=7, dw=7)
        assert calls == want, (remat, calls)
    for path, g in out["block"].items():
        assert torch.equal(g, out["none"][path]), path


def test_grad_accum_bf16_step_matches_reference(ref):
    """``make_train_step`` with two microbatches and a bfloat16 accumulator
    (jamba's ``grad_accum_dtype``) against the reference's, one AdamW step
    on the rescaled weights: loss within 1e-5, grad norm within 1e-4, and
    the parameters after the step within 1e-6, but for at most one in a
    thousand elements of a leaf, each within 2·lr: AdamW's first step
    moves an element by about lr·sign(g), and where the two microbatch
    grads nearly cancel, the bfloat16 rounding of their sum can decide
    that sign."""
    want_p, want_loss, want_norm = ref["step"]
    model = _port()
    params = params_from_numpy(ref["cond"], "cpu", defs=model.param_defs())
    state = {"params": params, "opt": init_opt_state(params, OptConfig(**OPT))}
    step = tsteps.make_train_step(model, OptConfig(**OPT), accum_steps=2,
                                  accum_dtype="bfloat16")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in ref["batch"].items()})
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-4)
    for path, p in iter_leaves(state["params"]):
        d = np.abs(p.numpy() - want_p[path])
        off = d > 1e-6 + 1e-6 * np.abs(want_p[path])
        assert off.mean() <= 1e-3 and d.max() <= 2 * OPT["lr"], (
            path, int(off.sum()), d.max())


# -- the train CLI ---------------------------------------------------------------

def test_train_cli_trains_jamba(tmp_path, capsys):
    """The jamba train command on the CPU: the config's 16 microbatches do
    not divide a batch of 2 (the reference's step fails its assertion
    there), so the loop takes 2 and says so; then the usual lines, losses
    finite."""
    out = ttrain.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--conv-backend",
        "sliding_pallas", "--steps", "4", "--batch", "2", "--seq", "64",
        "--run-dir", str(tmp_path), "--log-every", "1",
    ])
    text = capsys.readouterr().out
    assert "[train] grad_accum 16 does not divide batch 2: 2 microbatches" in text
    for step in range(4):
        assert f"[train] step {step} loss " in text
    assert "[train] done; final loss" in text
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()


def _args(run_dir, **over):
    d = dict(
        arch=ARCH, smoke=True, steps=4, batch=2, seq=64, lr=3e-4, seed=0,
        run_dir=str(run_dir), ckpt_every=1, log_every=1, grad_accum=2,
        conv_backend="sliding_pallas", audio_frontend="stub", no_resume=True,
        fail_at=None, max_restarts=0,
    )
    d.update(over)
    return argparse.Namespace(**d)


def test_port_resumes_the_reference_jamba_run(ref, tmp_path):
    """Both train loops (``--grad-accum 2``) start from one step-0
    checkpoint of the rescaled weights, written by the reference's manager
    (at the reference's own init, the grads are chaotic: see the module
    docstring). The reference's loop resumes from it and writes a
    checkpoint every step; the bridge loads its step-1 directory onto the
    port's trees; the port's loop resumes from that directory and gives the
    reference's losses at steps 2 and 3 within 1e-4 (step 3 comes after an
    update from the moments it loaded)."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro.launch.train import train_loop

    ref_dir = tmp_path / "ref"
    cond = jax.tree.map(jnp.asarray, ref["cond"])
    JManager(ref_dir / "ckpt").save(0, {"params": cond, "opt": jinit_opt_state(
        cond, JOptConfig())})
    want = train_loop(_args(ref_dir, no_resume=False))["losses"]
    assert len(want) == 3 and np.isfinite(want).all()
    model = _port()
    state = state_from_step_dir(ref_dir / "ckpt" / "step_1",
                                model.param_defs(), "cpu")
    assert int(state["opt"]["count"]) == 1
    (tmp_path / "port" / "ckpt").mkdir(parents=True)
    shutil.copytree(ref_dir / "ckpt" / "step_1",
                    tmp_path / "port" / "ckpt" / "step_1")
    out = ttrain.train_loop(_args(tmp_path / "port", no_resume=False,
                                  device="cpu"))
    np.testing.assert_allclose(out["losses"], want[1:], rtol=1e-4)
