"""The port's optimizer, data pipeline, checkpoints and fault-tolerance
utilities against the JAX reference's, on the CPU: the same inputs (numpy,
from a seed) go through both."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.distributed import ft as jft  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import apply_updates as japply_updates  # noqa: E402
from repro.optim import init_opt_state as jinit_opt_state  # noqa: E402
from repro.optim import lr_at as jlr_at  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, latest_step  # noqa: E402
from repro_torch.data import SyntheticLMData, make_batch_iterator  # noqa: E402
from repro_torch.distributed import ft  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptConfig, apply_updates, init_opt_state, lr_at,
)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.normal(size=(4, 6)) * scale).astype(np.float32),
                  "b": (rng.normal(size=(6,)) * scale).astype(np.float32)},
            "c": (rng.normal(size=(3, 2, 5)) * scale).astype(np.float32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _flat(tree):
    return {p: np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                          np.float32)
            for p, t in iter_leaves(tree)}


def _pairs(tree):
    """{path: (codes, scales)} of an int8 moment tree, as numpy."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k in tree
                for p, v in _pairs(tree[k]).items()}
    return {"": tuple(np.asarray(a) for a in tree)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("gscale", [0.01, 10.0])  # under and over clip_norm
def test_adamw_step_matches_reference(state_dtype, gscale):
    """Two steps of apply_updates on shared params and grads: params, m, v,
    count, grad_norm and lr equal to the reference's within 1e-6 (moments
    stored in bfloat16 within one bfloat16 rounding; int8 moments: codes
    equal and per-row scales within 1e-6)."""
    params, g1, g2 = _tree(0), _tree(1, gscale), _tree(2, gscale)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, state_dtype=state_dtype)
    jp, jo = params, jinit_opt_state(params, JOptConfig(**cfg))
    tp = _to_torch(params)
    to = init_opt_state(tp, OptConfig(**cfg))
    for g in (g1, g2):
        jp, jo, jinfo = japply_updates(jp, g, jo, JOptConfig(**cfg))
        tp, to, tinfo = apply_updates(tp, _to_torch(g), to, OptConfig(**cfg))
    mtol = dict(rtol=1e-6, atol=1e-6) if state_dtype == "float32" else dict(
        rtol=1e-2, atol=1e-6)
    trees = [("params", tp, jp, dict(rtol=1e-6, atol=1e-6))]
    if state_dtype == "int8":
        for name in ("m", "v"):
            got, want = _pairs(to[name]), _pairs(jax.tree.map(
                np.asarray, jo[name]))
            assert set(got) == set(want) == set(_flat(tp))
            for p, (q, sc) in got.items():
                assert q.dtype == np.int8 and sc.shape == (*q.shape[:-1], 1)
                np.testing.assert_array_equal(q, want[p][0], err_msg=p)
                np.testing.assert_allclose(sc, want[p][1], rtol=1e-6,
                                           err_msg=p)
        assert to["m"]["c"][0].dtype == torch.int8
    else:
        trees += [("m", to["m"], jo["m"], mtol), ("v", to["v"], jo["v"], mtol)]
        assert to["m"]["c"].dtype == getattr(torch, state_dtype)
    for name, got, want, tol in trees:
        g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
        assert set(g) == set(w)
        for p in g:
            np.testing.assert_allclose(g[p], w[p], err_msg=f"{name} {p}", **tol)
    assert int(to["count"]) == int(jo["count"]) == 2
    np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]), rtol=1e-6)


def test_adamw_keeps_param_types_and_refuses_int8_moments():
    """Parameters keep their type. The update is in place (the int8
    refusal and the "arguments unchanged" check this test was named for
    are gone with it): the params and moments passed in are the ones
    returned, overwritten, the gradient tree is emptied as it is used, and
    int8 moments are (codes, scales) pairs updated in place too."""
    p = {"w": torch.ones(2, 3, dtype=torch.bfloat16)}
    w0 = p["w"]
    cfg = OptConfig(lr=0.1, warmup_steps=1)  # a step bf16 can see
    opt0 = init_opt_state(p, cfg)
    m0 = opt0["m"]["w"]
    grads = {"w": torch.ones(2, 3, dtype=torch.bfloat16)}
    new_p, opt, _ = apply_updates(p, grads, opt0, cfg)
    assert new_p["w"].dtype == torch.bfloat16 and opt["m"]["w"].dtype == torch.float32
    assert new_p is p and new_p["w"] is w0 and opt["m"]["w"] is m0
    assert not torch.equal(w0, torch.ones(2, 3, dtype=torch.bfloat16))  # moved
    assert grads == {} and int(opt["count"]) == 1
    cfg8 = OptConfig(lr=0.1, warmup_steps=1, state_dtype="int8")
    opt8 = init_opt_state(p, cfg8)
    q, sc = opt8["v"]["w"]
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert sc.shape == (2, 1) and not q.any()
    apply_updates(p, {"w": torch.full((2, 3), 0.5, dtype=torch.bfloat16)},
                  opt8, cfg8)
    assert opt8["v"]["w"][0] is q and (q == 127).all()  # sqrt(v): one row max
    with pytest.raises(ValueError, match="state_dtype"):
        init_opt_state(p, OptConfig(state_dtype="int4"))


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(jlr_at(JOptConfig(**cfg), jnp.asarray(steps)))
    got = lr_at(OptConfig(**cfg), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_data_stream_is_the_references():
    for kw in (dict(vocab_size=512, seq_len=64, global_batch=2, seed=0),
               dict(vocab_size=51865, seq_len=128, global_batch=3, seed=7,
                    mean_doc_len=40)):
        ours, ref = SyntheticLMData(**kw), JData(**kw)
        for step in (0, 1, 5):
            a, b = ours.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    it = make_batch_iterator(SyntheticLMData(512, 16, 2), start_step=3)
    assert [next(it)[0] for _ in range(3)] == [3, 4, 5]
    it.close()


# -- checkpoints ----------------------------------------------------------------

def _state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "h": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "opt": {"count": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_round_trip_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in range(4):
        st = _state()
        st["params"]["w"] += step
        mgr.save(step, st, blocking=step % 2 == 0)
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    assert latest_step(tmp_path) == 3 and mgr.validate(3) is None
    back = mgr.restore(3, _state())
    assert torch.equal(back["params"]["w"], _state()["params"]["w"] + 3)
    assert back["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["h"], _state()["params"]["h"])
    assert mgr.manifest(3)["leaves"]["params.h"]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, {"params": {"w": torch.zeros(3, 2), "h": torch.zeros(4)},
                        "opt": {"count": torch.tensor(0)}})


def test_torn_checkpoints_are_quarantined_with_suffixes(tmp_path, capsys):
    mgr = CheckpointManager(tmp_path, keep=5)
    for step in (1, 2):
        mgr.save(step, _state())
    leaf = tmp_path / "step_2" / "params.w.npy"
    leaf.write_bytes(leaf.read_bytes()[:40])  # a torn write
    assert "B != manifest" in mgr.validate(2)
    assert mgr.latest_valid_step() == 1
    assert (tmp_path / "step_2.corrupt").is_dir()
    mgr.save(2, _state())
    (tmp_path / "step_2" / "manifest.json").write_text("{")
    assert mgr.latest_valid_step() == 1
    assert (tmp_path / "step_2.corrupt.1").is_dir()
    (tmp_path / "step_x").mkdir()
    assert latest_step(tmp_path) == 1
    assert "quarantined step 2" in capsys.readouterr().err


def test_reference_written_step_dir_validates_and_restores(tmp_path):
    from repro.checkpoint import CheckpointManager as JManager

    tree = {"params": {"w": jnp.arange(6.0).reshape(2, 3)},
            "opt": {"count": jnp.int32(4)}}
    JManager(tmp_path).save(9, tree)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_valid_step() == 9
    back = mgr.restore(9, {"params": {"w": torch.zeros(2, 3)},
                           "opt": {"count": torch.tensor(0, dtype=torch.int32)}})
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert int(back["opt"]["count"]) == 4
    meta = json.loads((tmp_path / "step_9" / "manifest.json").read_text())
    assert set(meta["leaves"]) == {"params.w", "opt.count"}


def test_int8_moment_checkpoints_cross_both_ways(tmp_path):
    """A state with int8 moments after one AdamW step, written by the
    reference's manager, validates and restores in the port (manager and
    bridge) with the reference's codes and scales; the port's own state
    after the same step, written by the port, restores in the reference's
    manager with the same codes and scales. Each (codes, scales) pair is
    two leaves, ``<path>.0`` and ``<path>.1``, in both managers."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.bridge import state_from_step_dir
    from repro_torch.distributed.sharding import ParamDef

    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, state_dtype="int8")
    params, grads = _tree(0), _tree(1)
    jp, jo, _ = japply_updates(params, grads, jinit_opt_state(
        params, JOptConfig(**cfg)), JOptConfig(**cfg))
    JManager(tmp_path / "ref").save(1, {"params": jp, "opt": jo})
    want = {n: _pairs(jax.tree.map(np.asarray, jo[n])) for n in ("m", "v")}
    tp = _to_torch(params)
    skeleton = {"params": tp, "opt": init_opt_state(tp, OptConfig(**cfg))}
    mgr = CheckpointManager(tmp_path / "ref")
    assert mgr.latest_valid_step() == 1
    leaves = mgr.manifest(1)["leaves"]
    assert leaves["opt.m.a.w.0"]["dtype"] == "int8"
    assert leaves["opt.v.c.1"]["shape"] == [3, 2, 1]
    defs = {"a": {"w": ParamDef((4, 6), (None, None)),
                  "b": ParamDef((6,), (None,))},
            "c": ParamDef((3, 2, 5), (None, None, None))}
    for back in (mgr.restore(1, skeleton),
                 state_from_step_dir(tmp_path / "ref" / "step_1", defs, "cpu")):
        assert int(back["opt"]["count"]) == 1
        for n in ("m", "v"):
            got = _pairs(back["opt"][n])
            assert set(got) == set(want[n])
            for path, (q, sc) in got.items():
                np.testing.assert_array_equal(q, want[n][path][0])
                np.testing.assert_array_equal(sc, want[n][path][1])
    bad = {**defs, "c": ParamDef((3, 2, 4), (None, None, None))}
    with pytest.raises(ValueError, match="shape mismatch"):
        state_from_step_dir(tmp_path / "ref" / "step_1", bad, "cpu")

    tp, to, _ = apply_updates(tp, _to_torch(grads), skeleton["opt"],
                              OptConfig(**cfg))
    CheckpointManager(tmp_path / "port").save(1, {"params": tp, "opt": to})
    got = JManager(tmp_path / "port").restore(1, {"params": jp, "opt": jo})
    for n in ("m", "v"):
        for path, (q, sc) in _pairs(got["opt"][n]).items():
            np.testing.assert_array_equal(q, want[n][path][0])
            np.testing.assert_allclose(sc, want[n][path][1], rtol=1e-6)
    np.testing.assert_allclose(got["params"]["a"]["w"], np.asarray(jp["a"]["w"]),
                               rtol=1e-6, atol=1e-6)


# -- fault tolerance ------------------------------------------------------------

def test_watchdog_flags_the_same_steps_as_the_reference():
    times = [1.0] * 8 + [5.0, 1.0, 1.1, 4.0, 1.0]
    ours, ref = ft.StepWatchdog(), jft.StepWatchdog()
    got = [ours.observe(i, t) for i, t in enumerate(times)]
    want = [ref.observe(i, t) for i, t in enumerate(times)]
    assert got == want and any(got) and not any(got[:6])
    assert ours.events == ref.events


@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_restart_policy_matches_reference(jitter):
    kw = dict(max_restarts=6, base_backoff_s=0.5, max_backoff_s=7.0,
              jitter=jitter, seed=3)
    ours, ref = ft.RestartPolicy(**kw), jft.RestartPolicy(**kw)
    seq = [ours.next_backoff() for _ in range(8)]
    assert seq == [ref.next_backoff() for _ in range(8)]
    assert seq[-1] is None and seq[-3] == 7.0
    ours.reset()
    assert ours.next_backoff() == seq[0]


def test_heartbeat_and_serve_use_the_ported_utilities(tmp_path):
    ft.beat(tmp_path, host_id=2)
    hb = tmp_path / "heartbeats" / "host_2"
    assert float(hb.read_text()) > 0
    assert not list(hb.parent.glob(".*.tmp"))
    assert serve.RestartPolicy is ft.RestartPolicy
