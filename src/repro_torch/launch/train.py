"""Training loop and command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \
        --smoke --steps 4 --batch 2 --seq 64 --audio-frontend mels \
        --conv-backend sliding_pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch jamba-1.5-large-398b --smoke --steps 4 --batch 2 --seq 64 \
        --conv-backend sliding_pallas --device cpu

The core of ``repro.launch.train``, with the same flags (plus ``--device``)
and the same ``[train]`` lines, so one command line drives both packages.
It runs on the card unless ``--device cpu`` is given. Deterministic
resumable data (the token stream and the per-step frame stream are pure
functions of (seed, step)), resume from the newest checkpoint that
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
both and says so on a ``[train]`` line.

Not ported yet: span tracing (``--trace``, which the CLI rejects), the
runtime demotion and probation machinery of the reference's step loop (a
failing kernel raises here), the obs metrics registry and its artifacts
and the patches stream of the vlm family.
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

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLMData, make_batch_iterator
from repro_torch.distributed.ft import RestartPolicy, StepWatchdog, beat
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptConfig, init_opt_state

# the frames stream's tag keeps it disjoint from the token pipeline's
# SeedSequence([seed, row]) (the reference's value, so both draw the same)
_TAG_FRAMES = 1_000_003


def log(msg: str) -> None:
    print(f"[train] {msg}", flush=True)


def step_stream(seed: int, step: int, tag: int) -> np.random.Generator:
    """Generator that is a pure function of (seed, tag, step): a resumed
    run replays the exact inputs an uninterrupted run saw at every step."""
    return np.random.default_rng(np.random.SeedSequence([seed, tag, step]))


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
    start = ckpt.latest_valid_step()
    if start is not None and not args.no_resume:
        state = ckpt.restore(start, state)
        start_step = start + 1
        log(f"resumed from step {start}")
    else:
        start_step = 0

    wd = StepWatchdog(on_straggler=lambda s, t, ema: print(
        f"[ft] straggler at step {s}: {t:.2f}s vs EMA {ema:.2f}s", flush=True))
    losses = []
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
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            wd.observe(step, dt)
            beat(args.run_dir, host_id=0)
            losses.append(loss)
            if step % args.log_every == 0:
                log(f"step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} ({dt:.2f}s)")
            if args.ckpt_every and step > 0 and step % args.ckpt_every == 0:
                ckpt.save(step, state, blocking=False)
            if args.fail_at is not None and step == args.fail_at:
                raise RuntimeError(f"injected failure at step {step}")
        ckpt.save(args.steps - 1, state, blocking=True)
    finally:
        ckpt.wait()  # an async save in flight lands before the run ends
    return {"losses": losses, "final_loss": losses[-1] if losses else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-medium")
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
    ap.add_argument("--trace", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    if args.trace:
        ap.error("--trace is not ported yet")

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
            print(f"[ft] {e}; restarting in {delay:.1f}s "
                  f"({policy.restarts}/{policy.max_restarts})", flush=True)
            time.sleep(min(delay, 2.0))  # capped, as the reference does
            args.fail_at = None  # the injected fault is transient


if __name__ == "__main__":
    main()
