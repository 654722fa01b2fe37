"""The mesh runtime across ranks on the CPU (gloo), against the reference.

Every multi-rank test runs through ``launch.mesh.run_ranks`` on gloo with a
``file://`` rendezvous under ``tmp_path`` and a 120-s ``timeout_s``, so a
hang fails the test. The reference results come from one JAX subprocess on
8 host devices (``--xla_force_host_platform_device_count``, as
``tests/test_distributed.py`` runs them), which writes them to a file:

  * the error-feedback all-reduce under ``shard_map`` on 4 devices (the
    local leaf taken by ``reshape``: the reference test's ``[0]`` gather
    fails on jax 0.9);
  * the expert-parallel ``moe_apply`` on a (data 2, model 2) mesh at
    ``capacity_factor`` 8 and at the smoke config's 1.25, with its
    weights, and the no-mesh one;
  * the single-device loss of the reference test's qwen3-moe smoke config
    and its weights;
  * ``pipeline_apply`` on a (stage 4, data 2) mesh;
  * a checkpoint saved from leaves sharded over 8 devices.

Tolerances: the EF means 1e-6 and its codes equal but at a half-integer
tie; the EP MoE 1e-3 of the reference's (its own bound) and 1e-5 of the
port's no-mesh path; the sharded loss 5e-3 of the reference's
single-device loss (its own bound) and, at capacity_factor 8, 1e-5 (of
the largest magnitude) of the port's one-rank loss and gradients; the
pipeline 2e-5; data-parallel losses and synced gradients of the other
families 1e-5; checkpoints bit for bit.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    RankError, choose_backend, run_ranks,
)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120.0

REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro._compat import set_mesh, shard_map
from repro.configs import get_config, smoke_config
from repro.distributed.sharding import Runtime, DEFAULT_RULES, init_params
from repro.distributed.pipeline import pipeline_apply
from repro.models import build_model, moe as moe_lib
from repro.optim.compress import ef_allreduce_grads
from repro.checkpoint import CheckpointManager

out_dir = sys.argv[1]
res = {}
dev = jax.devices()

# -- the error-feedback all-reduce on 4 devices
mesh = jax.make_mesh((4,), ('data',), devices=dev[:4])
rng = np.random.default_rng(0)
g_all = rng.normal(size=(4, 16, 32)).astype(np.float32)

def f(g_local, err):
    mean, new_err = ef_allreduce_grads(
        {'w': g_local.reshape(16, 32)}, {'w': err.reshape(16, 32)}, mesh,
        ('data',))
    return mean['w'][None], new_err['w'][None]

sm = shard_map(f, mesh=mesh, in_specs=(P('data'), P('data')),
               out_specs=(P('data'), P('data')), check_vma=False)
mean, err = sm(jnp.asarray(g_all), jnp.zeros((4, 16, 32), jnp.float32))
res['ef_g'] = g_all
res['ef_mean'] = np.asarray(mean)
res['ef_err'] = np.asarray(err)

# -- expert-parallel MoE on (data 2, model 2)
base = smoke_config(get_config('phi3.5-moe-42b-a6.6b')).replace(
    d_model=32, d_ff=64, num_experts=8, experts_per_token=2)
defs = moe_lib.moe_defs(base)
params = init_params(defs, jax.random.key(1), 'float32')
x = np.random.default_rng(1).normal(size=(2, 32, 32)).astype(np.float32)
mesh = jax.make_mesh((2, 2), ('data', 'model'), devices=dev[:4])
rt = Runtime(mesh=mesh, rules=dict(DEFAULT_RULES))
shard = rt.param_shardings(defs)
p2 = jax.tree.map(lambda v, s: jax.device_put(v, s), params, shard)
x2 = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P('data', None, None)))
for tag, cf in (('cf8', 8.0), ('cfdef', base.capacity_factor)):
    cfg = base.replace(capacity_factor=cf)
    with set_mesh(mesh):
        y, _ = jax.jit(lambda p, x: moe_lib.moe_apply(p, x, cfg, rt))(p2, x2)
    res[f'moe_y_ep_{tag}'] = np.asarray(y)
res['moe_x'] = x
for k, v in params.items():
    res[f'moe_p_{k}'] = np.asarray(v)

# -- the reference test's qwen3-moe smoke loss on one device
cfg = smoke_config(get_config('qwen3-moe-30b-a3b')).replace(
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4,
    experts_per_token=2)
rng = np.random.default_rng(0)
tokens = rng.integers(2, 512, (4, 64)).astype(np.int32)
labels = rng.integers(0, 512, (4, 64)).astype(np.int32)
m1 = build_model(cfg, Runtime())
p1 = m1.init(jax.random.key(0))
res['loss_l1'] = np.float64(jax.jit(m1.loss)(
    p1, {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(labels)}))
res['loss_tokens'], res['loss_labels'] = tokens, labels
leaves = jax.tree_util.tree_flatten_with_path(p1)[0]
for path, v in leaves:
    res['loss_p_' + '/'.join(str(k.key) for k in path)] = np.asarray(v)

# -- the pipeline on (stage 4, data 2)
S, M, mb, d = 4, 6, 2, 8
mesh = jax.make_mesh((S, 2), ('stage', 'data'))
rng = np.random.default_rng(0)
Ws = rng.normal(size=(S, d, d)).astype(np.float32) * 0.5
bs = rng.normal(size=(S, d)).astype(np.float32) * 0.1
xp = rng.normal(size=(M, mb, d)).astype(np.float32)
got = pipeline_apply(lambda p, h: jnp.tanh(h @ p['w'] + p['b']),
                     {'w': jnp.asarray(Ws), 'b': jnp.asarray(bs)},
                     jnp.asarray(xp), mesh)
res['pipe_w'], res['pipe_b'], res['pipe_x'] = Ws, bs, xp
res['pipe_y'] = np.asarray(got)

# -- a checkpoint of leaves sharded over 8 devices
mesh8 = jax.make_mesh((8,), ('data',))
s8 = NamedSharding(mesh8, P('data'))
state = {'w': jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
         'h': (jnp.arange(32, dtype=jnp.float32).reshape(8, 4) / 7
               ).astype(jnp.bfloat16)}
CheckpointManager(out_dir + '/ckpt').save(
    3, {k: jax.device_put(v, s8) for k, v in state.items()})
res['ckpt_w'] = np.asarray(state['w'])
res['ckpt_h_bits'] = np.asarray(state['h']).view(np.uint16)

np.savez(out_dir + '/ref.npz', **res)
print('REF OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0 and "REF OK" in r.stdout, r.stderr[-4000:]
    data = dict(np.load(out / "ref.npz"))
    data["dir"] = out
    return data


def _ranks(fn, n_data, n_model, tmp_path, *args):
    """``fn`` on every rank (one CPU thread each)."""
    return run_ranks(fn, n_data, n_model, device="cpu", backend="gloo",
                     rdv_dir=tmp_path, args=args, timeout_s=TIMEOUT)


@pytest.fixture
def one_thread():
    """The one-rank oracles on one CPU thread, as the ranks run: with more
    threads the CPU's matrix products sum in another order, which moves
    llava's random-input gradients by 4e-4 of their largest element."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *parents, name = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return out


# -- the launcher ---------------------------------------------------------------

def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    C.barrier(mesh)  # rank 0 waits for a rank that never comes
    return mesh.rank


def _hang_on_rank_1(mesh):
    if mesh.rank == 1:
        import time
        time.sleep(600)
    return mesh.rank


def _coords(mesh):
    return mesh.rank, dict(mesh.coords), {
        a: mesh.group(a)[1] for a in ("data", "model", ("data", "model"))}


def test_run_ranks_lays_out_the_mesh(tmp_path):
    out = _ranks(_coords, 2, 3, tmp_path)
    for rank, coords, groups in out:
        assert rank == coords["data"] * 3 + coords["model"]
        assert groups["data"] == [coords["model"], 3 + coords["model"]]
        assert groups["model"] == [3 * coords["data"] + i for i in range(3)]
        assert groups[("data", "model")] == list(range(6))


def test_failing_rank_fails_the_run_with_its_traceback(tmp_path):
    with pytest.raises(RankError, match="rank 1 of 2 failed(.|\n)*rank one "
                                        "fails on purpose"):
        _ranks(_raise_on_rank_1, 2, 1, tmp_path)


def test_hanging_rank_times_out(tmp_path):
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2"):
        run_ranks(_hang_on_rank_1, 2, 1, device="cpu", rdv_dir=tmp_path,
                  timeout_s=20.0)


def test_backend_is_explicit():
    assert choose_backend(4, "cpu", None) == "gloo"
    with pytest.raises(ValueError, match="only gloo"):
        choose_backend(2, "cpu", "nccl")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        choose_backend(n + 1, "cuda", None)
    with pytest.raises(ValueError, match="nccl with"):
        choose_backend(n + 1, "cuda", "nccl")
    assert choose_backend(n + 1, "cuda", "gloo") == "gloo"


def test_host_copies_follow_the_table():
    """The staging of a CUDA tensor is read from ``DEVICE_TENSORS`` (every
    collective the module calls has an entry for both backends) and the
    module decides nothing by catching an exception."""
    tree = ast.parse(Path(C.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    used = {n.args[1].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "_staged"}
    assert used == {"all_reduce", "all_gather", "reduce_scatter", "send",
                    "recv"}
    for backend in ("nccl", "gloo"):
        assert {c for b, c in C.DEVICE_TENSORS if b == backend} == used
    cuda = type("T", (), {"device": torch.device("cuda", 0)})()
    gloo = type("M", (), {"backend": "gloo"})()
    nccl = type("M", (), {"backend": "nccl"})()
    assert [c for c in sorted(used) if C._staged(gloo, c, cuda)] == ["recv", "send"]
    assert not any(C._staged(nccl, c, cuda) for c in used)
    assert not any(C._staged(gloo, c, torch.ones(1)) for c in used)


# -- collectives --------------------------------------------------------------------

def _collectives(mesh):
    from repro_torch.distributed import collectives as C

    r = float(mesh.rank)
    x = torch.full((3,), r)
    out = {a if isinstance(a, str) else "+".join(a): (
        C.psum(x, a, mesh)[0].item(), C.pmax(x, a, mesh)[0].item(),
        C.pmean(x, a, mesh)[0].item(), C.axis_index(a, mesh),
        C.all_gather(x[:1], a, mesh).tolist())
        for a in ("data", "model", ("data", "model"))}
    y = C.ppermute(x, "model", [(0, 1), (1, 0)], mesh)
    z = C.ppermute(x, "data", [(0, 1)], mesh)
    # the differentiable forms: d(sum of the psum)/dx = 1 on every rank,
    # copy_in sums the ranks' gradients, mean_out divides by the group
    w = torch.full((2,), r, requires_grad=True)
    (C.reduce_out(w * 2, "model", mesh).sum()
     + (C.copy_in(w, "model", mesh) * (r + 1)).sum()
     + C.mean_out(w, "model", mesh).sum()).backward()
    return mesh.rank, out, y[0].item(), z[0].item(), w.grad.tolist()


def test_collectives_over_axes_and_tuples(tmp_path):
    """(data 2, model 2): rank = 2 * data + model."""
    res = _ranks(_collectives, 2, 2, tmp_path)
    for rank, out, y, z, grad in res:
        d, m = divmod(rank, 2)
        data_ranks, model_ranks = [m, 2 + m], [2 * d, 2 * d + 1]
        assert out["data"] == (sum(data_ranks), max(data_ranks),
                               sum(data_ranks) / 2, d, data_ranks)
        assert out["model"] == (sum(model_ranks), max(model_ranks),
                                sum(model_ranks) / 2, m, model_ranks)
        assert out["data+model"] == (6.0, 3.0, 1.5, rank, [0, 1, 2, 3])
        assert y == 2 * d + (1 - m)  # swapped along model
        assert z == (m if d == 1 else 0.0)  # data 0 -> 1; data 0 gets zeros
        # 2 (reduce_out) + sum over model of (r + 1) (copy_in) + 1/2
        assert grad == [2 + sum(r + 1 for r in model_ranks) + 0.5] * 2


# -- the error-feedback all-reduce ---------------------------------------------------

def _ef(mesh, g_all):
    from repro_torch.optim.compress import ef_allreduce_grads, init_error_feedback

    g = {"w": torch.from_numpy(g_all[mesh.rank])}
    err = init_error_feedback(g)
    mean, err1 = ef_allreduce_grads(g, err, mesh, ("data",))
    total = torch.zeros(16, 32)
    err = init_error_feedback(g)
    for _ in range(20):
        m, err = ef_allreduce_grads(g, err, mesh, ("data",))
        total += m["w"]
    return mean["w"].numpy(), err1["w"].numpy(), (total / 20).numpy()


def _codes(g_all, err):
    """The int8 codes a rank sent, from its target and carried error:
    ``round((target - err) / s)``, s the shared row scale; and target / s."""
    s = np.abs(g_all).max(axis=-1, keepdims=True).max(axis=0) / 127.0 + 1e-12
    return np.round((g_all - err) / s), g_all / s


def test_ef_allreduce_matches_reference(ref, tmp_path):
    g_all = ref["ef_g"]
    res = _ranks(_ef, 4, 1, tmp_path, g_all)
    exact = g_all.mean(0)
    err_port = np.stack([r[1] for r in res])
    for r, (mean, err, avg) in enumerate(res):
        np.testing.assert_allclose(mean, ref["ef_mean"][r], rtol=0, atol=1e-6)
        rel = np.abs(mean - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel
        assert np.abs(err).max() > 0
        rel20 = np.abs(avg - exact).max() / np.abs(exact).max()
        assert rel20 < 0.01, rel20
    q_port, pre = _codes(g_all, err_port)
    q_ref, _ = _codes(g_all, ref["ef_err"])
    differ = q_port != q_ref
    ties = np.abs(np.abs(pre - np.trunc(pre)) - 0.5) < 1e-4
    assert not (differ & ~ties).any()
    assert (np.abs(q_port - q_ref) <= 1).all()
    assert np.abs(q_port).max() <= 127


# -- the expert-parallel MoE ---------------------------------------------------------

def _moe_cfg(cf=None):
    """The reference test's config; ``cf`` None keeps the smoke config's
    capacity factor."""
    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(get_config("phi3.5-moe-42b-a6.6b")).replace(
        d_model=32, d_ff=64, num_experts=8, experts_per_token=2)
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


def _ep_moe(mesh, params_np, x, cfs):
    from repro_torch.bridge import params_block_from_numpy, params_from_numpy
    from repro_torch.distributed.sharding import Runtime
    from repro_torch.models import moe as moe_lib

    rt = Runtime(mesh)
    out = {}
    for cf in cfs:
        cfg = _moe_cfg(cf)
        defs = moe_lib.moe_defs(cfg)
        p = params_block_from_numpy(params_np, defs, rt, "cpu")
        whole = params_from_numpy(params_np, "cpu")
        i = mesh.coords["data"]
        xl = torch.from_numpy(x[i:i + 1])
        y, aux = moe_lib.moe_apply(p, xl, cfg, rt)
        y1, aux1 = moe_lib.moe_apply(whole, xl, cfg)
        _, ids, _ = moe_lib._route(xl.reshape(-1, 32), whole["router"], 2)
        cap = int(max(1, (32 * 2 / 8) * cf))
        per = torch.bincount(ids.reshape(-1), minlength=8)
        out[cf] = (y.numpy(), y1.numpy(), float(aux), float(aux1),
                   int((per - cap).clamp(min=0).sum()), tuple(p["wg"].shape))
    return mesh.rank, out


def test_ep_moe_matches_reference(ref, tmp_path):
    """(data 2, model 2), each rank 4 of 8 experts and its data rank's one
    row: at capacity_factor 8 (no drops) the reference's EP output at its
    1e-3 and the port's no-mesh path at 1e-5; at the smoke config's 1.25,
    with drops, the reference's EP path."""
    params = {k: ref[f"moe_p_{k}"] for k in ("router", "wg", "wu", "wd")}
    cf_default = _moe_cfg().capacity_factor
    res = _ranks(_ep_moe, 2, 2, tmp_path, params, ref["moe_x"],
                 (8.0, cf_default))
    dropped = 0
    for rank, out in res:
        i = rank // 2
        for cf, tag in ((8.0, "cf8"), (cf_default, "cfdef")):
            y, y1, aux, aux1, drops, wg_shape = out[cf]
            assert wg_shape == (4, 32, 64)
            np.testing.assert_allclose(y, ref[f"moe_y_ep_{tag}"][i:i + 1],
                                       rtol=0, atol=1e-3)
            assert abs(aux - aux1) <= 1e-6
            if cf == 8.0:
                assert drops == 0
                np.testing.assert_allclose(y, y1, rtol=0, atol=1e-5)
            else:
                dropped += drops
                np.testing.assert_allclose(
                    y, ref[f"moe_y_ep_{tag}"][i:i + 1], rtol=0, atol=1e-5)
    assert dropped > 0


# -- the sharded loss and its synced gradients -----------------------------------

def _loss_cfg(cf=None):
    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(get_config("qwen3-moe-30b-a3b")).replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4,
        experts_per_token=2)
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


def _sharded_loss(mesh, params_np, tokens, labels):
    from repro_torch.bridge import params_block_from_numpy
    from repro_torch.distributed.sharding import Runtime, iter_leaves
    from repro_torch.launch.steps import loss_and_grads, sync_grads
    from repro_torch.models import build_model

    rt = Runtime(mesh)
    i = mesh.coords["data"]
    batch = {"tokens": torch.from_numpy(tokens[2 * i:2 * i + 2]),
             "labels": torch.from_numpy(labels[2 * i:2 * i + 2])}
    out = {}
    for cf in (None, 8.0):
        model = build_model(_loss_cfg(cf), rt)
        p = params_block_from_numpy(params_np, model.param_defs(), rt, "cpu")
        loss, grads = loss_and_grads(model, p, batch)
        grads = sync_grads(grads, rt)
        out[cf] = (float(loss), {k: g.numpy() for k, g in iter_leaves(grads)})
    return mesh.rank, out


def _one_rank_oracle(params_np, tokens, labels):
    """The port's one-rank loss and gradient of the mesh's objective: the
    CE summed over both data shards over their summed count, plus the aux
    averaged over the shards (each shard routed on its own tokens, as a
    data rank routes them)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed.sharding import iter_leaves, map_tree
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    cfg = _loss_cfg(8.0)
    model = build_model(cfg)
    p = map_tree(lambda t: t.requires_grad_(True),
                 params_from_numpy(params_np, "cpu"))
    tot = cnt = aux = 0.0
    for i in range(2):
        sl = slice(2 * i, 2 * i + 2)
        h, a = model.hidden(p, model.embeds_for(
            p, {"tokens": torch.from_numpy(tokens[sl])}))
        t, n = L.chunked_ce_sums(p["embed"], h, torch.from_numpy(labels[sl]),
                                 cfg)
        tot, cnt, aux = tot + t, cnt + n, aux + a / 2
    loss = tot / cnt + 0.01 * aux / cfg.num_layers
    flat = [t for _, t in iter_leaves(p)]
    grads = torch.autograd.grad(loss, flat)
    return loss.item(), {k: g.numpy() for (k, _), g in zip(iter_leaves(p), grads)}


def test_sharded_loss_matches_single_device(ref, tmp_path, one_thread):
    """The reference test's qwen3-moe smoke config on (data 2, model 2):
    the global loss within the reference's 5e-3 of its single-device
    loss; at capacity_factor 8 the loss and every synced gradient leaf
    (this rank's block of it: the experts, heads, kv heads and vocabulary
    split over model) within 1e-5 of the port's one-rank ones."""
    params = _tree({k: v for k, v in ref.items() if k.startswith("loss_p_")},
                   "loss_p_")
    tokens, labels = ref["loss_tokens"], ref["loss_labels"]
    res = _ranks(_sharded_loss, 2, 2, tmp_path, params, tokens, labels)
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import Runtime, iter_leaves
    from repro_torch.models import build_model

    l8, g8 = _one_rank_oracle(params, tokens, labels)
    defs = dict(iter_leaves(build_model(_loss_cfg(8.0)).param_defs()))
    for rank, out in res:
        loss, _ = out[None]
        assert abs(loss - float(ref["loss_l1"])) < 5e-3, (loss, ref["loss_l1"])
        loss8, grads = out[8.0]
        assert abs(loss8 - l8) <= 1e-5 * abs(l8), (loss8, l8)
        rt = Runtime(SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 2},
            coords={"data": rank // 2, "model": rank % 2}))
        for k, want in g8.items():
            want = rt.local(torch.from_numpy(want), defs[k]).numpy()
            np.testing.assert_allclose(grads[k], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
    assert res[0][1][None][0] == res[3][1][None][0]


# -- data parallelism across the families ---------------------------------------

FAMILIES = ("whisper-medium", "qwen3-1.7b", "rwkv6-1.6b",
            "jamba-1.5-large-398b", "llava-next-34b")


def _family_cfg(arch):
    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(get_config(arch))
    if arch == "jamba-1.5-large-398b":
        cfg = cfg.replace(num_experts=0)  # no aux: the mean is the one-rank's
    if arch == "whisper-medium":
        cfg = cfg.replace(conv_backend="sliding_pallas")
    return cfg


def _family_batch(arch, cfg):
    rng = np.random.default_rng(7)
    B, S = 4, 64
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels[0, :40] = -1  # the shards' counts differ
    labels[3, 10:20] = -1
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int64),
             "labels": labels}
    if arch == "whisper-medium":
        batch["frames"] = rng.normal(size=(B, 2 * S, 80)).astype(np.float32)
    if arch == "llava-next-34b":
        batch["patches"] = rng.normal(
            size=(B, cfg.num_patches, 1152)).astype(np.float32)
    return batch


def _data_parallel(mesh, arches):
    from repro_torch.distributed.sharding import Runtime, iter_leaves
    from repro_torch.launch.steps import loss_and_grads, make_train_step, sync_grads
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, init_opt_state

    rt = Runtime(mesh)
    i = mesh.coords["data"]
    out = {}
    for arch in arches:
        cfg = _family_cfg(arch)
        model = build_model(cfg, rt)
        params = model.init(torch.Generator().manual_seed(0))
        full = _family_batch(arch, cfg)
        batch = {k: torch.from_numpy(v[2 * i:2 * i + 2]) for k, v in full.items()}
        loss, grads = loss_and_grads(model, params, batch)
        grads = sync_grads(grads, rt)
        opt_cfg = OptConfig(total_steps=2, warmup_steps=1)
        step = make_train_step(model, opt_cfg, rt=rt)
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        state, metrics = step(state, batch)
        out[arch] = (float(loss), {k: g.numpy() for k, g in iter_leaves(grads)},
                     {k: t.numpy() for k, t in iter_leaves(state["params"])})
    return out


def test_data_parallel_loss_and_step_match_one_rank(tmp_path, one_thread):
    """Each family's smoke config on (data 2): the loss the global mean
    over labels that are not -1 (rows 0 and 3 partly masked, so the shards'
    counts differ), the synced gradient the one-rank whole-batch gradient,
    both within 1e-5; after one synced AdamW step the params are equal on
    both ranks and are AdamW's update of the one-rank params by the synced
    gradient (the step syncs before it updates). AdamW's first step moves
    an element by about lr · sign(g), so a near-zero gradient's last bits
    can flip it: the step is held to the synced gradient, not to the
    one-rank step's params."""
    from repro_torch.distributed.sharding import iter_leaves
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state

    res = _ranks(_data_parallel, 2, 1, tmp_path, FAMILIES)
    for arch in FAMILIES:
        cfg = _family_cfg(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v) for k, v in _family_batch(arch, cfg).items()}
        loss, grads = loss_and_grads(model, params, batch)
        for r in range(2):
            l_r, g_r, p_r = res[r][arch]
            assert abs(l_r - float(loss)) <= 1e-5 * abs(float(loss)), (arch, l_r)
            for k, g in iter_leaves(grads):
                g = g.numpy()
                np.testing.assert_allclose(g_r[k], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max() + 1e-12,
                                           err_msg=f"{arch} {k}")
            for k, p in p_r.items():
                np.testing.assert_array_equal(p, res[0][arch][2][k])
        opt_cfg = OptConfig(total_steps=2, warmup_steps=1)
        synced = _tree({k: torch.from_numpy(g)
                        for k, g in res[0][arch][1].items()}, "")
        want, _, _ = apply_updates(params, synced,
                                   init_opt_state(params, opt_cfg), opt_cfg)
        for k, p in iter_leaves(want):
            np.testing.assert_allclose(res[0][arch][2][k], p.numpy(),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{arch} {k}")


# -- the pipeline --------------------------------------------------------------------

def _pipeline(mesh, w, b, x):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((mesh.size,), ("stage",))  # the same ranks, one axis
    s = mesh.coords["stage"]
    p = {"w": torch.from_numpy(w[s]), "b": torch.from_numpy(b[s])}
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), p,
                       torch.from_numpy(x), mesh)
    return y.numpy()


def test_pipeline_matches_reference_and_sequential(ref, tmp_path):
    from repro_torch.distributed.pipeline import pipeline_bubble_fraction

    w, b, x = ref["pipe_w"], ref["pipe_b"], ref["pipe_x"]
    res = _ranks(_pipeline, 4, 1, tmp_path, w, b, x)
    seq = torch.from_numpy(x)
    for s in range(4):
        seq = torch.tanh(seq @ torch.from_numpy(w[s]) + torch.from_numpy(b[s]))
    for y in res:
        np.testing.assert_allclose(y, ref["pipe_y"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(y, seq.numpy(), rtol=2e-5, atol=2e-5)
    assert abs(pipeline_bubble_fraction(4, 6) - 3 / 9) < 1e-9


# -- elastic checkpoints ---------------------------------------------------------------

def _ckpt_defs():
    from repro_torch.distributed.sharding import ParamDef
    from repro_torch.models import moe as moe_lib

    defs = moe_lib.moe_defs(_moe_cfg(8.0))
    return defs, {"params": defs, "opt": {"m": defs, "count": None}}


def _ckpt_state(rt, seed):
    from repro_torch.distributed.sharding import init_params, map_tree
    from repro_torch.optim.compress import quantize_int8

    defs, _ = _ckpt_defs()
    params = init_params(defs, torch.Generator().manual_seed(seed), "float32", rt)
    m = map_tree(quantize_int8, init_params(
        defs, torch.Generator().manual_seed(seed + 1), "float32", rt))
    return {"params": params, "opt": {"m": m, "count": torch.tensor(5)}}


def _save_on_mesh(mesh, directory):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import Runtime

    rt = Runtime(mesh)
    _, state_defs = _ckpt_defs()
    CheckpointManager(directory).save(7, _ckpt_state(rt, 11), rt=rt,
                                      defs=state_defs)
    return mesh.rank


def _restore_on_mesh(mesh, directory, ref_dir):
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.distributed.sharding import ParamDef, Runtime

    rt = Runtime(mesh)
    _, state_defs = _ckpt_defs()
    skeleton = _ckpt_state(rt, 99)
    got = CheckpointManager(directory).restore(7, skeleton, rt=rt,
                                               defs=state_defs)
    want = _ckpt_state(rt, 11)
    same = {k: bool(torch.equal(v, _flatten(want)[k]))
            for k, v in _flatten(got).items()}
    defs = {"w": ParamDef((8, 8), ("experts", None)),
            "h": ParamDef((8, 4), ("experts", None), dtype="bfloat16")}
    sk = {"w": torch.zeros(4, 8), "h": torch.zeros(4, 4, dtype=torch.bfloat16)}
    r = CheckpointManager(ref_dir).restore(3, sk, rt=rt, defs=defs)
    return (mesh.rank, same, r["w"].numpy(),
            r["h"].view(torch.int16).numpy().view(np.uint16))


def test_elastic_restore_across_meshes(ref, tmp_path):
    """Saved on (data 2, model 2), each rank holding half the experts: one
    step dir of whole leaves (an int8 moment's codes and scales too),
    restored bit for bit on (model 2) and on one rank; a step the
    reference wrote from leaves sharded over 8 devices restored on (model
    2), each rank its half."""
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten

    ckpt = tmp_path / "ckpt"
    assert _ranks(_save_on_mesh, 2, 2, tmp_path, str(ckpt)) == [0, 1, 2, 3]
    mgr = CheckpointManager(ckpt)
    assert mgr.validate(7) is None
    whole = _ckpt_state(None, 11)
    assert mgr.manifest(7)["leaves"]["params.wg"]["shape"] == [8, 32, 64]
    one = mgr.restore(7, _ckpt_state(None, 99))
    for k, v in _flatten(one).items():
        assert torch.equal(v, _flatten(whole)[k]), k
    ref_dir = ref["dir"] / "ckpt"
    res = _ranks(_restore_on_mesh, 1, 2, tmp_path, str(ckpt), str(ref_dir))
    for rank, same, w, h in res:
        assert all(same.values()), same
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(w, ref["ckpt_w"][rows])
        np.testing.assert_array_equal(h, ref["ckpt_h_bits"][rows])
    whole_ref = CheckpointManager(ref_dir).restore(
        3, {"w": torch.zeros(8, 8), "h": torch.zeros(8, 4, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(whole_ref["w"].numpy(), ref["ckpt_w"])
