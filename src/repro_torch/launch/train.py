"""Training loop and command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \
        --smoke --steps 4 --batch 2 --seq 64 --audio-frontend mels \
        --conv-backend sliding_pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch jamba-1.5-large-398b --smoke --steps 4 --batch 2 --seq 64 \
        --conv-backend sliding_pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llava-next-34b --smoke --steps 2 --batch 2 --grad-accum 1 \
        --seq 32 --device cpu

The core of ``repro.launch.train``, with the same flags (plus ``--device``)
and the same ``[train]`` lines, so one command line drives both packages.
It runs on the card unless ``--device cpu`` is given. Deterministic
resumable data (the token stream and the per-step frame and patch streams
are pure functions of (seed, step)), resume from the newest checkpoint that
validates, async checkpoints every ``--ckpt-every`` steps and a blocking
one at the end, the straggler watchdog and the heartbeat under
``--run-dir``, and a bounded restart loop around the whole run
(``--max-restarts``; ``--fail-at`` injects one crash).

With ``--audio-frontend mels --conv-backend sliding_pallas`` whisper's two
frontend convs train through the CUDA kernels: the forward conv kernel with
the saved pre-activation, dx through the same kernel, dw and db through the
dw kernel. The hybrid family (jamba) trains on tokens alone; with
``--conv-backend sliding_pallas`` every Mamba conv trains through the
depthwise kernels in the same way, and the optimizer keeps the config's
int8 moments (``opt_state_dtype``). The config's ``grad_accum`` (jamba:
16 microbatches, bfloat16 accumulator) applies unless ``--grad-accum`` is
given; where it does not divide ``--batch``, the reference's train step
fails its assertion, and this loop takes the largest count that divides
both and says so on a ``[train]`` line. The vlm family (llava) trains on
tokens and the patch embeddings of ``build_batch_extras``, drawn per step
as the reference draws them.

The loop records the reference's spans (``train.step``, ``train.resume``,
``train.ckpt_save``) while tracing is armed (``--trace`` or
``REPRO_TRACE=1``), and its metrics always (``train.steps``,
``train.tokens``, ``train.step_s``, ``train.tokens_per_s``, ``train.loss``,
``train.ckpt_save_s``, ``train.resumes``); the run ends by writing
``metrics.json``, ``metrics.prom`` and, under ``--trace``, ``trace.json``
in ``--run-dir`` (``python -m repro_torch.obs report`` reads them back).

The runtime fault domain is the reference's: a runtime trip of a kernel
site (an injected ``pallas_runtime`` or ``nan_activations`` at the site, or
the ``REPRO_RUNTIME_SENTINEL`` sentinel) raises at the step's loss,
before the optimizer writes anything (``steps.make_train_step``). For an
injected trip the loop records ``demote:<rung>(runtime)``, opens the
rung's breaker, counts ``runtime.demote`` and retries the same step on
the untouched state, on the next rung of the ``ops`` ladder (at most
``_MAX_RUNTIME_DEMOTIONS_PER_STEP`` times a step); the first step after a
demotion is counted in ``runtime.retrace_ms``. A trip of the sentinel (a
kernel's own non-finite output, nothing injected) is recorded as
``error:<rung>(sentinel)`` and the step fails, with no demotion. Each
step ticks the breakers' cooldowns, and a demoted rung re-enters through
one probation call. ``faults.sleep_point("slow_step", "train")`` makes a
straggler step. Any other error propagates, to the restart loop of
``main``.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import faults, obs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLMData, make_batch_iterator
from repro_torch.distributed.ft import RestartPolicy, StepWatchdog, beat
from repro_torch.health import HEALTH, demote_tripped
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptConfig, init_opt_state

# the frames and patches streams' tags keep them disjoint from each other
# and from the token pipeline's SeedSequence([seed, row]) (the reference's
# values, so both draw the same)
_TAG_FRAMES = 1_000_003
_TAG_PATCHES = 1_000_033
#: runtime demotions one step may take before its error propagates
_MAX_RUNTIME_DEMOTIONS_PER_STEP = 4


def log(msg: str) -> None:
    obs.info("train", msg)


def step_stream(seed: int, step: int, tag: int) -> np.random.Generator:
    """Generator that is a pure function of (seed, tag, step): a resumed
    run replays the exact inputs an uninterrupted run saw at every step."""
    return np.random.default_rng(np.random.SeedSequence([seed, tag, step]))


def build_batch_extras(cfg, B: int, rng: np.random.Generator) -> dict:
    """Synthetic modality inputs, one draw per step: the vlm family's patch
    embeddings (B, num_patches, 1152) float32; nothing for other
    families. Host arrays, as the reference draws them."""
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = rng.normal(
            size=(B, cfg.num_patches, 1152)).astype(np.float32)
    return extras


def train_loop(args) -> dict:
    device = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    accum = args.grad_accum or cfg.grad_accum
    if not args.grad_accum and args.batch % accum:
        accum = math.gcd(args.batch, accum)
        log(f"grad_accum {cfg.grad_accum} does not divide batch {args.batch}: "
            f"{accum} microbatches")
    cfg = cfg.replace(grad_accum=accum)
    if getattr(args, "conv_backend", None):
        cfg = cfg.replace(conv_backend=args.conv_backend)
    model = build_model(cfg)
    opt_cfg = OptConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 5),
        state_dtype=cfg.opt_state_dtype,
    )
    step_fn = make_train_step(model, opt_cfg, accum_steps=cfg.grad_accum,
                              accum_dtype=cfg.grad_accum_dtype)
    ckpt = CheckpointManager(Path(args.run_dir) / "ckpt", keep=3)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
    )
    # audio: "stub" feeds frame embeddings (B, S, d_model); "mels" feeds
    # mel frames (B, S, 80) through the conv frontend
    frame_dim = cfg.d_model
    if cfg.family == "audio" and getattr(args, "audio_frontend", "stub") == "mels":
        from repro_torch.models.whisper import N_MELS

        frame_dim = N_MELS

    with torch.no_grad():
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    # resume from the newest checkpoint that validates: a torn one is
    # quarantined and the previous intact one is taken
    reg = obs.REGISTRY
    start = ckpt.latest_valid_step()
    if start is not None and not args.no_resume:
        with obs.span("train.resume", step=start):
            state = ckpt.restore(start, state)
        start_step = start + 1
        reg.counter("train.resumes").inc(1.0, arch=cfg.name)
        log(f"resumed from step {start}")
    else:
        start_step = 0

    wd = StepWatchdog(on_straggler=lambda s, t, ema: obs.warn(
        "ft", f"straggler at step {s}: {t:.2f}s vs EMA {ema:.2f}s"))
    losses = []
    retrace_t0 = None
    try:
        for step, host_batch in make_batch_iterator(data, start_step=start_step):
            if step >= args.steps:
                break
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            if cfg.family == "audio":
                srng = step_stream(args.seed, step, _TAG_FRAMES)
                batch["frames"] = torch.from_numpy(srng.normal(
                    size=(args.batch, args.seq, frame_dim)).astype(np.float32)
                ).to(device)
            extras = build_batch_extras(
                cfg, args.batch, step_stream(args.seed, step, _TAG_PATCHES))
            batch.update({k: torch.from_numpy(v).to(device)
                          for k, v in extras.items()})
            t0 = time.perf_counter()
            with obs.span("train.step", step=step):
                faults.sleep_point("slow_step", "train")  # a straggler
                for attempt in range(_MAX_RUNTIME_DEMOTIONS_PER_STEP + 1):
                    try:
                        state, metrics = step_fn(state, batch)
                        break
                    except faults.FaultError as e:
                        trip = faults.consume_trip()
                        # the step raised before its update: an injected
                        # trip demotes the rung it names and this step is
                        # retried on the same state (a sentinel trip is
                        # recorded and propagates)
                        if (trip is None
                                or attempt == _MAX_RUNTIME_DEMOTIONS_PER_STEP
                                or not demote_tripped(trip, e,
                                                      where=f" step {step}")):
                            raise
                        retrace_t0 = time.perf_counter()
                loss = float(metrics["loss"])  # waits for the step
            if retrace_t0 is not None:
                dt_ms = (time.perf_counter() - retrace_t0) * 1000.0
                reg.counter("runtime.retrace_ms").inc(dt_ms, arch=cfg.name)
                log(f"retrace after runtime demotion: {dt_ms:.0f}ms")
                retrace_t0 = None
            dt = time.perf_counter() - t0
            wd.observe(step, dt)
            HEALTH.tick()  # a clean step toward the demoted rungs' cooldowns
            beat(args.run_dir, host_id=0)
            losses.append(loss)
            toks = args.batch * args.seq
            reg.counter("train.steps").inc(1.0, arch=cfg.name)
            reg.counter("train.tokens").inc(float(toks), arch=cfg.name)
            reg.histogram("train.step_s").observe(dt, arch=cfg.name)
            reg.gauge("train.tokens_per_s").set(toks / dt if dt > 0 else 0.0,
                                                arch=cfg.name)
            reg.gauge("train.loss").set(loss, arch=cfg.name)
            if step % args.log_every == 0:
                log(f"step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} ({dt:.2f}s)")
            if args.ckpt_every and step > 0 and step % args.ckpt_every == 0:
                _save(ckpt, step, state, cfg.name, blocking=False)
            if args.fail_at is not None and step == args.fail_at:
                raise RuntimeError(f"injected failure at step {step}")
        _save(ckpt, args.steps - 1, state, cfg.name, blocking=True)
    finally:
        ckpt.wait()  # an async save in flight lands before the run ends
    if args.run_dir:
        obs.write_artifacts(args.run_dir)
    return {"losses": losses, "final_loss": losses[-1] if losses else None}


def _save(ckpt, step: int, state: dict, arch: str, *, blocking: bool) -> None:
    """One checkpoint save in a ``train.ckpt_save`` span, its host time
    into ``train.ckpt_save_s`` (an async save: the time to hand it off)."""
    t0 = time.perf_counter()
    with obs.span("train.ckpt_save", step=step, blocking=blocking):
        ckpt.save(step, state, blocking=blocking)
    obs.REGISTRY.histogram("train.ckpt_save_s").observe(
        time.perf_counter() - t0, arch=arch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_run"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--conv-backend", default=None,
                    choices=["sliding", "sliding_pallas", "im2col_gemm",
                             "xla"],
                    help="conv evaluation for the conv frontend; "
                         "sliding_pallas trains through the CUDA kernels")
    ap.add_argument("--audio-frontend", default="stub", choices=["stub", "mels"],
                    help="audio archs: stub frame embeddings, or mel frames "
                         "through the sliding-conv frontend")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (FT testing)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="auto-restart budget after crashes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", action="store_true",
                    help="arm span tracing (as REPRO_TRACE=1); trace.json "
                         "is written under --run-dir")
    args = ap.parse_args(argv)
    if args.trace:
        obs.enable()

    policy = RestartPolicy(max_restarts=args.max_restarts)
    while True:
        try:
            out = train_loop(args)
            log(f"done; final loss {out['final_loss']:.4f}")
            return out
        except RuntimeError as e:
            delay = policy.next_backoff()
            if delay is None:
                raise
            obs.warn("ft", f"{e}; restarting in {delay:.1f}s "
                           f"({policy.restarts}/{policy.max_restarts})")
            time.sleep(min(delay, 2.0))  # capped, as the reference does
            args.fail_at = None  # the injected fault is transient


if __name__ == "__main__":
    main()
