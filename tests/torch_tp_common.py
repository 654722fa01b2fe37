"""Shared by the ``test_torch_tp_*`` files: each family's smoke config run
on a mesh of gloo ranks on the CPU (``launch.mesh.run_ranks``) and on one
rank, with the same weights (the ranked ``init_params`` draw is each
rank's block of the one-rank draw) and the same batch.

The weights are the reference's init rescaled to std 1/sqrt(input width)
(``rescale``), as the jamba, llava and card tests rescale them: the
reference draws a stacked fan-in weight with std 1/sqrt(layers), and from
that init whisper's and jamba's smoke models are chaotic, so the order in
which tensor parallelism sums a product's terms (the ranks' partial sums,
then their ``psum``) moves their logits by 2e-5 of the largest.

A rank returns its loss, every gradient leaf synced and gathered whole
(``Runtime.gather``), the params after one synced AdamW step gathered
whole, and one greedy request through ``serve.generate`` (prefill and
three decode steps) with its logits. The one-rank oracle computes the
same on one CPU thread, as the ranks run: with more threads the CPU's
matrix products sum in another order.
"""
from __future__ import annotations

import numpy as np
import torch

FAMILIES = ("whisper-medium", "qwen3-1.7b", "gemma-2b", "qwen3-moe-30b-a3b",
            "llava-next-34b", "jamba-1.5-large-398b")
TIMEOUT = 120.0
GEN = 4  # the prefill's token and three decode steps
PROMPT = 8
# AdamW at an eps above the gradients' scale: the first step's update is
# then continuous in the gradient (at 1e-8 it is sign(g), which a last-bit
# difference of a near-zero element flips)
OPT = dict(total_steps=2, warmup_steps=1, eps=1e-3)


def family_cfg(arch: str):
    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(get_config(arch))
    if arch == "jamba-1.5-large-398b":
        # the period's mamba layers and MLPs, in float64: in float32 the
        # scan's sums leave the one-rank gradients 1.3e-5 (relative L2) from
        # their own float64 values, the size of the bound held here
        cfg = cfg.replace(num_experts=0, param_dtype="float64",
                          compute_dtype="float64")
    if arch == "whisper-medium":
        # an odd vocabulary, as the published 51,865: the rules keep it whole
        cfg = cfg.replace(conv_backend="sliding_pallas", vocab_size=513)
    if arch == "qwen3-moe-30b-a3b":
        cfg = cfg.replace(capacity_factor=8.0)  # no drops: grouping-free
    return cfg


def family_batch(arch: str, cfg, B: int = 4, S: int = 64) -> dict:
    rng = np.random.default_rng(7)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels[0, :40] = -1  # the data shards' counts differ
    labels[3, 10:20] = -1
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int64),
             "labels": labels}
    if arch == "whisper-medium":
        batch["frames"] = rng.normal(size=(B, 2 * S, 80)).astype(np.float32)
    if arch == "llava-next-34b":
        batch["patches"] = rng.normal(
            size=(B, cfg.num_patches, 1152)).astype(np.float32)
    return batch


def prompts(cfg, B: int = 4) -> np.ndarray:
    rng = np.random.default_rng(11)
    return rng.integers(2, cfg.vocab_size, (B, PROMPT)).astype(np.int64)


def rules_of(name: str) -> dict:
    from repro_torch.distributed.sharding import DEFAULT_RULES, FSDP_RULES

    return dict(FSDP_RULES if name == "fsdp" else DEFAULT_RULES)


def rescale(params, defs) -> None:
    """Every stacked fan-in weight at std 1/sqrt of its input width
    (experts and the attention output projection contract more), and
    whisper's frontend convs at 1/sqrt(K * Cin), in place. A constant a
    leaf, from the whole leaf's def: a rank's block scales alike."""
    from repro_torch.distributed.sharding import iter_leaves

    want = dict(iter_leaves(defs))
    with torch.no_grad():
        for path, t in iter_leaves(params):
            d, parts = want[path], path.split("/")
            if parts[-1] in ("conv1_w", "conv2_w"):
                t.div_(d.shape[1] ** 0.5)
                continue
            if parts[0] not in ("blocks", "periods", "encoder", "decoder") \
                    or d.init != "fan_in":
                continue
            heads_in = parts[-1] == "wo" and len(d.shape) == 4
            fan = (d.shape[2] if "moe" in parts else
                   d.shape[1] * d.shape[2] if heads_in else d.shape[1])
            if d.shape[0] > 1:  # drawn with std 1/sqrt(stacked layers)
                t.mul_(d.shape[0] ** 0.5)
            t.div_(fan ** 0.5)


def _serve(model, params, rows):
    """(tokens, [prefill logits, step logits...]) of one greedy request."""
    from repro_torch.launch import serve

    cfg = model.cfg
    B, P = rows.shape
    logits: list = []

    def recording(fn):
        def rec(*a, **k):
            out = fn(*a, **k)
            logits.append(out[0][:, -1].float().numpy())
            return out
        return rec

    model.prefill = recording(model.prefill)
    model.decode_step = recording(model.decode_step)
    cache_len = serve.resolve_cache_len(cfg, P + GEN, P, GEN)
    with torch.no_grad():
        toks, _ = serve.generate(model, params, rows, gen_len=GEN,
                                 cache_len=cache_len)
    del model.prefill, model.decode_step
    return toks.numpy(), logits


def family_rank(mesh, rules_name, arches):
    """One rank: per family its loss, whole synced gradients, whole params
    after one synced AdamW step, and its data rank's greedy request."""
    from repro_torch.distributed.sharding import Runtime, iter_leaves, map_tree
    from repro_torch.launch.steps import loss_and_grads, make_train_step, sync_grads
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, init_opt_state

    rt = Runtime(mesh, rules_of(rules_name))
    n_data = mesh.shape["data"]
    i = mesh.coords["data"]
    out = {}
    for arch in arches:
        cfg = family_cfg(arch)
        model = build_model(cfg, rt)
        defs = dict(iter_leaves(model.param_defs()))
        params = model.init(torch.Generator().manual_seed(0))
        rescale(params, model.param_defs())
        full = family_batch(arch, cfg)
        per = 4 // n_data
        batch = {k: torch.from_numpy(v[per * i:per * (i + 1)])
                 for k, v in full.items()}
        loss, grads = loss_and_grads(model, params, batch)
        grads = sync_grads(grads, rt, model.param_defs())
        whole_g = {k: rt.gather(g, defs[k]).numpy()
                   for k, g in iter_leaves(grads)}
        opt_cfg = OptConfig(**OPT)
        state = {"params": map_tree(torch.clone, params),
                 "opt": init_opt_state(params, opt_cfg)}
        state, metrics = make_train_step(model, opt_cfg, rt=rt)(state, batch)
        whole_p = {k: rt.gather(p, defs[k]).numpy()
                   for k, p in iter_leaves(state["params"])}
        rows = torch.from_numpy(prompts(cfg)[per * i:per * (i + 1)])
        toks, logits = _serve(model, params, rows)
        out[arch] = dict(loss=float(loss), grads=whole_g, stepped=whole_p,
                         grad_norm=float(metrics["grad_norm"]), tokens=toks,
                         logits=logits,
                         blocks={k: tuple(t.shape)
                                 for k, t in iter_leaves(params)})
    return dict(rank=mesh.rank, coords=dict(mesh.coords), out=out)


def _moe_shard_loss(model, params, batch, n_data):
    """qwen3-moe's mesh objective on one rank: the CE summed over the data
    shards over their summed count, plus the aux averaged over the shards
    (each shard routed on its own tokens, as a data rank routes them)."""
    from repro_torch.models import layers as L

    cfg = model.cfg
    per = batch["tokens"].shape[0] // n_data
    tot = cnt = aux = 0.0
    for i in range(n_data):
        sl = slice(per * i, per * (i + 1))
        h, a = model.hidden(params, model.embeds_for(
            params, {"tokens": batch["tokens"][sl]}))
        t, n = L.chunked_ce_sums(params["embed"], h, batch["labels"][sl], cfg)
        tot, cnt, aux = tot + t, cnt + n, aux + a / n_data
    return tot / cnt + 0.01 * aux / cfg.num_layers


def one_rank(arches, n_data):
    """The oracle: per family the one-rank loss, gradients, AdamW step on
    the whole batch, and each data rank's greedy request."""
    from repro_torch.distributed.sharding import iter_leaves, map_tree
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, init_opt_state

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch in arches:
            cfg = family_cfg(arch)
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0))
            rescale(params, model.param_defs())
            batch = {k: torch.from_numpy(v)
                     for k, v in family_batch(arch, cfg).items()}
            if cfg.num_experts and n_data > 1:
                real = model.loss
                model.loss = lambda p, b: _moe_shard_loss(model, p, b, n_data)
            loss, grads = steps.loss_and_grads(model, params, batch)
            opt_cfg = OptConfig(**OPT)
            state = {"params": map_tree(torch.clone, params),
                     "opt": init_opt_state(params, opt_cfg)}
            state, metrics = steps.make_train_step(model, opt_cfg)(state, batch)
            if cfg.num_experts and n_data > 1:
                model.loss = real
            per = 4 // n_data
            serve = [_serve(model, params, torch.from_numpy(
                prompts(cfg)[per * i:per * (i + 1)])) for i in range(n_data)]
            out[arch] = dict(
                loss=float(loss),
                grads={k: g.numpy() for k, g in iter_leaves(grads)},
                stepped={k: p.numpy() for k, p in iter_leaves(state["params"])},
                grad_norm=float(metrics["grad_norm"]), serve=serve)
        return out
    finally:
        torch.set_num_threads(threads)


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| in float64 (0 for two zero tensors)."""
    den = np.linalg.norm(want.astype(np.float64))
    num = np.linalg.norm(got.astype(np.float64) - want)
    return float(num / den) if den else float(num)


def check_loss_and_grads(res, oracle, arch) -> float:
    """Every rank's loss, clip norm, gradients (gathered whole) and params
    after the step against the one-rank ones, each leaf within 1e-5 in
    relative L2 norm; every leaf's
    gradient equal on every rank, a replicated leaf's too. Returns the
    worst gradient leaf's relative error."""
    want = oracle[arch]
    first = res[0]["out"][arch]
    worst = 0.0
    for r in res:
        got = r["out"][arch]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (
            arch, r["rank"], got["loss"], want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-5 * want["grad_norm"], (arch, got["grad_norm"], want["grad_norm"])
        for k, g in want["grads"].items():
            assert got["grads"][k].shape == g.shape, (arch, k)
            e = rel_l2(got["grads"][k], g)
            worst = max(worst, e)
            assert e <= 1e-5, (arch, r["rank"], k, e)
            np.testing.assert_array_equal(got["grads"][k], first["grads"][k],
                                          err_msg=f"{arch} {k} across ranks")
        for k, p in want["stepped"].items():
            e = rel_l2(got["stepped"][k], p)
            assert e <= 1e-5, (arch, r["rank"], "stepped", k, e)
    return worst


def check_serving(res, oracle, arch):
    """Each rank's prefill and decode logits within 1e-5 (of their largest
    magnitude) of the one-rank model's on its data rank's rows, and its
    greedy tokens equal."""
    for r in res:
        got = r["out"][arch]
        toks, logits = oracle[arch]["serve"][r["coords"]["data"]]
        assert len(got["logits"]) == len(logits) == GEN
        for t, (a, b) in enumerate(zip(got["logits"], logits)):
            assert a.shape == b.shape, (arch, t, a.shape, b.shape)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=f"{arch} rank {r['rank']} step {t}")
        np.testing.assert_array_equal(got["tokens"], toks, err_msg=arch)
