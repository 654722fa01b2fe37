"""Serving: batched prefill, then greedy or temperature decode
against a static KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --smoke --batch 2 --prompt-len 16 --gen 8 --conv-backend sliding_pallas

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --batch 2 --prompt-len 16 \
        --gen 8 --conv-backend sliding_pallas --quant int8 --kv-quant int8

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llava-next-34b --smoke --batch 2 --prompt-len 8 --gen 4

    REPRO_TRACE=1 PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --smoke --batch 2 --prompt-len 16 --gen 8 \
        --kv-quant int8 --requests 2 --run-dir obs_run --device cpu
    PYTHONPATH=src python -m repro_torch.obs report obs_run

``repro.launch.serve`` in PyTorch, with the same flags (plus ``--device``)
and the same ``[serve]`` lines, so one command line drives both packages.
It runs on the card unless ``--device cpu`` is given. One prefill per batch
of requests, then one decode step per token; slots that emit
``cfg.eos_id`` are finished and keep decoding into masked positions.

The run substrate is the reference's. ``generate`` sheds a request at
admission (``LoadShedError``) when the decode-step p95 times ``gen_len``
projects past ``deadline_s``; truncates a request at ``deadline_s``; re-runs
a request whose logits turn non-finite in every slot (``--retries``) and
quarantines a slot whose logits alone turn non-finite (eos-masked,
recyclable). With ``--run-dir`` every decode step writes a heartbeat, a
watchdog flags straggler steps, and a request journal (``requests.jsonl``)
records each request at admission and completion: the CLI first replays
what an earlier process left in flight, then serves ``--requests`` new
ones, and writes ``metrics.json``, ``metrics.prom`` and, under
``--trace``, ``trace.json`` there (``python -m repro_torch.obs report``
reads them back). The reference retries any exception; the port retries
only non-finite logits (``FloatingPointError``): a CUDA fault is sticky
for its process context, so a retry in the same process fixes nothing.
Every other error propagates at once.

A vision-stub model (llava) prefills its patch embeddings ahead of the
prompt: zeros of (B, num_patches, 1152), as the reference serves them, or
the ``patches`` a caller passes to ``prefill_cache`` / ``generate`` (the
output of ``models.llava.patch_embed``). The cache and the decode
positions count that prefix: the cache holds at least prefix + prompt +
generated rows, and decode step i runs at position prefix + P + i. (The
reference's CLI sizes the cache and places the decode positions without
the prefix, and fails for llava; see ROADMAP.)

``--quant int8`` runs the model's conv path (whisper's frontend, jamba's
mamba convs) w8a8 (``quantize_for_serving``): an eager calibration
prefill collects activation scales, int8 weight leaves are swapped into
the params (whisper's conv1 -> conv2 requant chain gets ``out_scale``, so
int8 codes flow between them), and the request runs with
``conv_precision="w8a8"``: whisper's convs through the int8 sliding conv
kernel, the mamba convs through the int8 depthwise kernel, each with a
dynamic activation scale (the reference calibrates no mamba site). Conv-free
archs pass through unchanged. ``--kv-quant int8`` stores the serving KV
cache as int8 codes with per-row scales, read by the decode-attention
kernel with the scales folded into its softmax; jamba's recurrent mamba
states stay float.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs, quant, resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.ft import RestartPolicy, StepWatchdog, beat
from repro_torch.distributed.sharding import iter_leaves, torch_dtype
from repro_torch.health import HEALTH, canon_reason
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.common import quantize_kv_leaf
from repro_torch.models.llava import VISION_DIM


def log(msg: str) -> None:
    obs.info("serve", msg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cache_nbytes(defs, param_dtype) -> int:
    """Bytes a cache built from ``defs`` occupies (ParamDef dtype, falling
    back to the model's param dtype)."""
    return sum(
        math.prod(d.shape) * torch_dtype(d.dtype or param_dtype).itemsize
        for _, d in iter_leaves(defs)
    )


def quantize_cache_to_defs(cache: dict, defs: dict) -> dict:
    """Quantize the float prefill cache leaves that ``defs`` stores as int8
    (those with a ``<name>_scale`` def), emitting the scale leaf beside
    each, through ``common.quantize_kv_leaf``: the same quantizer as the
    per-token decode write. Nested defs (jamba's ``mamba{j}: {conv, ssm}``
    states) are walked; other leaves pass through."""
    out = {}
    for name, d in defs.items():
        if isinstance(d, dict):
            out[name] = quantize_cache_to_defs(cache[name], d)
        elif name.endswith("_scale") and name[: -len("_scale")] in defs:
            continue  # emitted with its int8 leaf
        elif d.dtype == "int8" and f"{name}_scale" in defs:
            out[name], out[f"{name}_scale"] = quantize_kv_leaf(cache[name])
        else:
            out[name] = cache[name]
    return out


def pad_cache_to_defs(cache: dict, defs: dict, param_dtype) -> dict:
    """Zero-pad each prefill cache leaf up to the decode cache shape along
    its sequence axis, the one named ``kv_seq`` in the leaf's
    ``ParamDef.axes``, and cast it to the def's dtype (the param dtype
    where the def names none). Leaves without a ``kv_seq`` axis (jamba's
    recurrent conv and ssm states, walked in their nested dicts) are cast
    only."""
    out = {}
    for name, d in defs.items():
        c = cache[name]
        if isinstance(d, dict):
            out[name] = pad_cache_to_defs(c, d, param_dtype)
            continue
        if "kv_seq" in d.axes:
            ax = d.axes.index("kv_seq")
            if c.shape[ax] != d.shape[ax]:
                full = torch.zeros(d.shape, dtype=c.dtype, device=c.device)
                full.narrow(ax, 0, c.shape[ax]).copy_(c)
                c = full
        out[name] = c.to(torch_dtype(d.dtype or param_dtype))
    return out


def prefix_len(cfg, patches: torch.Tensor | None = None) -> int:
    """Positions the prefill puts ahead of the prompt: a vision stub's
    patch prefix (``patches``' length, or ``cfg.num_patches`` for the zero
    patches of ``serve_batch``), else none."""
    if cfg.frontend != "vision_stub":
        return 0
    return cfg.num_patches if patches is None else patches.shape[1]


def serve_batch(model, B: int, P: int, prompts: torch.Tensor,
                patches: torch.Tensor | None = None) -> dict:
    """The prefill batch: the prompts, a whisper request's mel frames, a
    vision stub's ``patches`` (zeros of (B, num_patches, 1152) where none
    are given, as the reference serves them)."""
    batch = {"tokens": prompts}
    if model.cfg.family == "audio":
        # real mels so serving runs the conv frontend: 2P mel frames give P
        # encoder positions after the stride-2 conv2 (same seed and values
        # as the reference's serve_batch)
        from repro_torch.models.whisper import N_MELS

        rng = np.random.default_rng(0)
        mels = rng.normal(size=(B, 2 * P, N_MELS)).astype(np.float32)
        batch["frames"] = torch.from_numpy(mels).to(prompts.device)
    if model.cfg.family == "vlm":
        batch["patches"] = patches if patches is not None else torch.zeros(
            (B, model.cfg.num_patches, VISION_DIM), dtype=torch.float32,
            device=prompts.device)
    return batch


def resolve_cache_len(cfg, cache_len: int, P: int, gen_len: int,
                      prefix: int = 0) -> int:
    """Clamp an undersized cache request. Enc-dec cache defs split ``seq``
    evenly between encoder frames and decoder tokens, so the decoder half
    alone must hold prompt + gen; a decoder-only cache holds the prefill's
    ``prefix`` (``prefix_len``) + prompt + gen."""
    if cfg.encoder_layers:
        return max(cache_len, 2 * (P + gen_len))
    return max(cache_len, prefix + P + gen_len)


def prefill_cache(model, params, prompts: torch.Tensor, *, cache_len: int,
                  gen_len: int = 0, patches: torch.Tensor | None = None):
    """Prefill, quantize the cache where ``cfg.kv_quant`` is int8, then pad
    it up to ``cache_len`` (widened by ``resolve_cache_len``) along each
    leaf's kv_seq axis (zero codes and zero scales past the prefill).
    ``patches`` replaces a vision stub's zero patches. Returns (last-token
    logits, cache)."""
    cfg = model.cfg
    B, P = prompts.shape
    cache_len = resolve_cache_len(cfg, cache_len, P, gen_len,
                                  prefix_len(cfg, patches))
    logits, cache = model.prefill(params, serve_batch(model, B, P, prompts,
                                                      patches))
    defs = model.cache_defs(B, cache_len)
    if cfg.kv_quant == "int8":
        cache = quantize_cache_to_defs(cache, defs)
    # metadata only: the decode cache this request serves from
    obs.REGISTRY.gauge("serve.kv_cache_bytes").set(
        float(cache_nbytes(defs, cfg.param_dtype)), kind="served")
    return logits, pad_cache_to_defs(cache, defs, cfg.param_dtype)


class LoadShedError(RuntimeError):
    """A request rejected at admission: the decode-step p95 projects it past
    its deadline, so it would only truncate after taking a batch."""


#: decode-step samples required before admission trusts the p95
_SHED_MIN_SAMPLES = 8


class RequestJournal:
    """Append-only request journal, ``<run_dir>/requests.jsonl``: a
    ``begin`` record (prompts and decode parameters) at admission, an
    ``end`` record (tokens and done mask) at completion, the reference's
    records key for key. Each append rewrites the file through a temporary
    file and a rename, so a crash leaves the old or the new journal, never
    a torn line. ``pending()`` gives the begins without an end: a restarted
    server replays them (``replay_pending``), and greedy decode reproduces
    their tokens. The directory is created on first use (the reference's
    journal assumes it exists)."""

    def __init__(self, run_dir):
        self.path = Path(run_dir) / "requests.jsonl"

    def _append(self, rec: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        prev = self.path.read_text() if self.path.exists() else ""
        tmp = self.path.with_name(f".{self.path.name}.{os.getpid()}.tmp")
        tmp.write_text(prev + json.dumps(rec) + "\n")
        tmp.replace(self.path)

    def begin(self, req_id: str, prompts: torch.Tensor, *, gen_len: int,
              cache_len: int, temperature: float, seed: int) -> None:
        self._append({
            "id": req_id, "event": "begin", "prompts": prompts.cpu().tolist(),
            "gen_len": gen_len, "cache_len": cache_len,
            "temperature": temperature, "seed": seed,
        })

    def end(self, req_id: str, tokens: torch.Tensor,
            done: torch.Tensor) -> None:
        self._append({"id": req_id, "event": "end",
                      "tokens": tokens.cpu().tolist(),
                      "done": done.cpu().tolist()})

    def records(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [json.loads(line) for line in self.path.read_text().splitlines()
                if line.strip()]

    def pending(self) -> list[dict]:
        """Begin records with no matching end: in flight at a crash."""
        begun: dict[str, dict] = {}
        ended: set[str] = set()
        for r in self.records():
            if r["event"] == "begin":
                begun[r["id"]] = r
            elif r["event"] == "end":
                ended.add(r["id"])
        return [r for rid, r in begun.items() if rid not in ended]


def _screen_logits(logits: torch.Tensor, step: int):
    """Per-step numeric guard: every slot non-finite fails the request (the
    retry in ``generate`` re-runs it); some slots non-finite returns their
    (B,) mask, and the decode loop quarantines just those slots."""
    bad = ~torch.isfinite(logits).flatten(1).all(dim=1)
    if not bool(bad.any()):
        return None
    if bool(bad.all()):
        raise FloatingPointError(f"non-finite logits at decode step {step}")
    return bad


def _quarantine(bad: torch.Tensor, done: torch.Tensor, step: int,
                arch: str) -> torch.Tensor:
    """Fold a bad-slot mask into ``done``: the slots' remaining tokens pin
    to eos and they are reported recyclable. Records and counts only the
    slots newly poisoned."""
    newly = bad & ~done
    n = int(newly.sum())
    if n:
        HEALTH.record("serve/slot", "nan_logits", "quarantine",
                      detail=f"step {step}: {n} slot(s) "
                             f"{torch.nonzero(newly).flatten().tolist()}")
        obs.REGISTRY.counter("serve.quarantined").inc(float(n), arch=arch)
    return done | bad


def _generate_once(model, params, prompts, *, gen_len, cache_len,
                   temperature, seed, deadline_s, nan_guard, stats, patches,
                   run_dir, host_id, watchdog):
    cfg = model.cfg
    dev = prompts.device
    eos = cfg.eos_id
    B, P = prompts.shape
    reg = obs.REGISTRY
    start = prefix_len(cfg, patches) + P  # the first decode position
    # perf_counter, not the wall clock: a clock step must not fire a false
    # deadline or straggler (the heartbeat alone records wall time)
    t_start = time.perf_counter()
    with obs.span("serve.prefill", arch=cfg.name):
        logits, cache = prefill_cache(model, params, prompts,
                                      cache_len=cache_len, gen_len=gen_len,
                                      patches=patches)
        bad = _screen_logits(logits, -1) if nan_guard else None
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        _sync(dev)
    stats["ttft_s"] = time.perf_counter() - t_start  # prefill + first token
    reg.histogram("serve.prefill_s").observe(stats["ttft_s"], arch=cfg.name)
    reg.histogram("serve.ttft_s").observe(stats["ttft_s"], arch=cfg.name)
    done = tok[:, 0] == eos
    if bad is not None:
        done = _quarantine(bad, done, -1, cfg.name)
        tok = torch.where(done[:, None], eos, tok)
    out = [tok]
    step_hist = reg.histogram("serve.decode_step_s")
    for i in range(gen_len - 1):
        t_step = time.perf_counter()
        with obs.span("serve.decode_step", arch=cfg.name, step=start + i):
            logits, cache = model.decode_step(params, cache, tok, start + i)
            bad = _screen_logits(logits, i) if nan_guard else None
            if bad is not None:
                done = _quarantine(bad, done, i, cfg.name)
            last = logits[:, -1]
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen).to(torch.int32)
            else:
                tok = last.argmax(dim=-1, keepdim=True).to(torch.int32)
            tok = torch.where(done[:, None], eos, tok)  # finished: masked
            out.append(tok)
            done = done | (tok[:, 0] == eos)
            _sync(dev)
        dt_step = time.perf_counter() - t_step
        stats.setdefault("step_s", []).append(dt_step)
        step_hist.observe(dt_step, arch=cfg.name)
        if watchdog is not None:
            watchdog.observe(start + i, dt_step)
        if run_dir is not None:
            beat(run_dir, host_id)
        if deadline_s is not None and time.perf_counter() - t_start > deadline_s:
            # truncate: the remaining positions pad with eos, every slot done
            HEALTH.record("serve/generate", "deadline_exceeded", "truncate",
                          detail=f"{len(out)}/{gen_len} tokens in "
                                 f"{deadline_s}s")
            reg.counter("serve.deadline_exceeded").inc(1.0, arch=cfg.name)
            out.append(torch.full((B, gen_len - len(out)), eos,
                                  dtype=torch.int32, device=dev))
            done = torch.ones_like(done)
            stats["truncated"] = True
            break
    n_done = int(done.sum())
    reg.counter("serve.tokens_generated").inc(float(B * gen_len),
                                              arch=cfg.name)
    reg.gauge("serve.slots_total").set(float(B), arch=cfg.name)
    reg.gauge("serve.slots_recyclable").set(float(n_done), arch=cfg.name)
    reg.gauge("serve.slot_occupancy").set((B - n_done) / B if B else 0.0,
                                          arch=cfg.name)
    return torch.cat(out, dim=1), done


def _admission_check(model, gen_len: int, deadline_s: float | None) -> None:
    """Load shedding: with a deadline set and at least
    ``_SHED_MIN_SAMPLES`` decode steps in the histogram, reject a request
    whose projected decode time (step p95 x ``gen_len``) exceeds the
    deadline. A deadline <= 0 bypasses admission: it is the force-truncate
    idiom (the request is taken and truncates at its first step)."""
    if deadline_s is None or deadline_s <= 0:
        return
    arch = model.cfg.name
    hist = obs.REGISTRY.histogram("serve.decode_step_s")
    n = hist.count(arch=arch)
    if n < _SHED_MIN_SAMPLES:
        return
    p95 = hist.quantile(0.95, arch=arch)
    projected = p95 * gen_len
    if projected <= deadline_s:
        return
    HEALTH.record("serve/admission", "load_shed", "shed",
                  detail=f"p95 {p95 * 1e3:.1f}ms x {gen_len} = "
                         f"{projected:.2f}s > deadline {deadline_s}s (n={n})")
    obs.REGISTRY.counter("serve.shed").inc(1.0, arch=arch)
    raise LoadShedError(
        f"projected decode {projected:.2f}s exceeds deadline {deadline_s}s")


def generate(model, params, prompts: torch.Tensor, *, gen_len: int,
             cache_len: int, temperature: float = 0.0, seed: int = 0,
             deadline_s: float | None = None, max_retries: int = 2,
             nan_guard: bool = True, stats: dict | None = None,
             patches: torch.Tensor | None = None, run_dir=None,
             host_id: int = 0, watchdog: StepWatchdog | None = None,
             journal: RequestJournal | None = None,
             request_id: str | None = None):
    """prompts: (B, P) integer tensor on the serving device -> ((B, gen_len)
    int32 tokens, (B,) bool done mask). ``patches`` (B, n, 1152) replaces
    a vision stub's zero patches.

    With ``deadline_s`` set the request is shed at admission
    (``LoadShedError``, no retry) when the decode-step p95 projects past
    it, and truncated when it expires: the rest is eos-padded and every
    slot done. A request whose logits are non-finite in every slot is
    re-run, up to ``max_retries`` times with short backoff, before the
    error propagates; a slot whose logits alone are non-finite is
    quarantined; any other failure propagates at once. With ``run_dir``
    each decode step writes this host's heartbeat and a ``watchdog`` (or a
    default one) flags straggler steps. With ``journal`` the request is
    journaled begin and end under ``request_id`` (its ``patches`` cannot
    be: a journaled request takes none). ``stats``, when given, receives
    ``ttft_s`` (prefill through the first token) and ``step_s`` (one entry
    per decode step), host clock around work that ends in a device
    synchronise: the same values as the ``serve.ttft_s`` and
    ``serve.decode_step_s`` histograms."""
    reg = obs.REGISTRY
    arch = model.cfg.name
    if journal is not None and patches is not None:
        raise ValueError("a journaled request takes no patches")
    _admission_check(model, gen_len, deadline_s)
    request_id = request_id or "req"
    if journal is not None:
        journal.begin(request_id, prompts, gen_len=gen_len,
                      cache_len=cache_len, temperature=temperature, seed=seed)
    if watchdog is None and run_dir is not None:
        def _flag_straggler(step, s, ema):
            HEALTH.record("serve/decode", "straggler", "flag",
                          detail=f"step {step}: {s:.3f}s vs EMA {ema:.3f}s")
            reg.counter("serve.stragglers").inc(1.0)

        watchdog = StepWatchdog(on_straggler=_flag_straggler)
    stats = {} if stats is None else stats
    policy = RestartPolicy(max_restarts=max_retries, base_backoff_s=0.05,
                           max_backoff_s=2.0)
    reg.counter("serve.requests").inc(1.0, arch=arch)
    while True:
        stats.clear()
        try:
            t_req = time.perf_counter()
            with torch.no_grad(), obs.span("serve.generate", arch=arch):
                toks, done = _generate_once(
                    model, params, prompts, gen_len=gen_len,
                    cache_len=cache_len, temperature=temperature, seed=seed,
                    deadline_s=deadline_s, nan_guard=nan_guard, stats=stats,
                    patches=patches, run_dir=run_dir, host_id=host_id,
                    watchdog=watchdog,
                )
            reg.histogram("serve.request_s").observe(
                time.perf_counter() - t_req, arch=arch)
            if journal is not None:
                journal.end(request_id, toks, done)
            return toks, done
        except FloatingPointError as e:
            reason = canon_reason(e)
            delay = policy.next_backoff()
            if delay is None:
                HEALTH.record("serve/generate", reason,
                              "error:retries_exhausted", detail=repr(e)[:200])
                raise
            HEALTH.record("serve/generate", reason, "retry",
                          detail=repr(e)[:200])
            reg.counter("serve.retries").inc(1.0, arch=arch)
            time.sleep(delay)


def replay_pending(model, params, journal: RequestJournal, *,
                   device: torch.device, **kw):
    """Replay the journal's in-flight requests (begun, never ended) after a
    restart, their prompts rebuilt on ``device``; completion writes the
    ``end`` record the crash never did. Greedy decode reproduces the
    tokens. Returns ``[(request_id, tokens, done), ...]``."""
    out = []
    for rec in journal.pending():
        prompts = torch.tensor(rec["prompts"], dtype=torch.int32,
                               device=device)
        toks, done = generate(
            model, params, prompts, gen_len=rec["gen_len"],
            cache_len=rec["cache_len"], temperature=rec["temperature"],
            seed=rec["seed"], journal=journal, request_id=rec["id"], **kw)
        obs.REGISTRY.counter("serve.journal_replayed").inc(1.0)
        log(f"journal: replayed in-flight request {rec['id']}")
        out.append((rec["id"], toks, done))
    return out


def quantize_for_serving(model, params, prompts):
    """int8 post-training quantization of the model's conv path: an eager
    calibration prefill, the activation scales with the requant chains
    (``quant.CHAINS``), then int8 weight leaves. Returns (cfg', params'),
    cfg' with ``conv_precision="w8a8"``."""
    cfg = model.cfg
    B, P = prompts.shape
    calib = quant.Calibration()
    with obs.span("serve.quantize", arch=cfg.name):
        with torch.no_grad(), quant.collecting(calib):
            model.prefill(params, serve_batch(model, B, P, prompts))
        spec = calib.spec(chains=quant.CHAINS)
        qparams = quant.quantize_params(params, spec=spec)
    n = quant.quantized_site_count(qparams)
    if n == 0:
        log(f"--quant: {cfg.name} has no conv sites; unchanged")
        return cfg, params
    chained = sum(1 for e in spec.values() if "out_scale" in e)
    log(f"--quant: {n} conv weight(s) int8, {len(calib.seen)} calibrated "
        f"site(s), {chained} chained")
    return cfg.replace(conv_precision="w8a8"), qparams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-decode", choices=["fused", "view"], default="fused",
                    help="decode-attention read: the CUDA kernel (fused) or "
                         "a direct softmax over the whole cache (view)")
    ap.add_argument("--conv-backend", default=None,
                    choices=["sliding", "sliding_pallas", "im2col_gemm",
                             "xla"],
                    help="conv evaluation for the model's conv layers "
                         "(whisper's frontend, jamba's mamba convs); "
                         "sliding_pallas runs them through the CUDA kernels")
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="post-training-quantize the conv path (w8a8)")
    ap.add_argument("--kv-quant", choices=["int8"], default=None,
                    help="store the serving KV cache int8 + per-row scales")
    ap.add_argument("--run-dir", default=None,
                    help="heartbeats, the request journal and the obs "
                         "artifacts (metrics.json [+ trace.json]) go here")
    ap.add_argument("--trace", action="store_true",
                    help="arm span tracing (as REPRO_TRACE=1); trace.json "
                         "is written under --run-dir")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget: expiry truncates "
                         "the batch with eos padding, and admission sheds "
                         "a request projected past it")
    ap.add_argument("--retries", type=int, default=2,
                    help="retries of a request whose logits turn non-finite "
                         "in every slot")
    ap.add_argument("--requests", type=int, default=1,
                    help="sequential requests to serve (same prompts and "
                         "seed: greedy decode makes them bit-identical)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.trace:
        obs.enable()
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=args.kv_quant)
    if args.conv_backend:
        cfg = cfg.replace(conv_backend=args.conv_backend)
    cfg = cfg.replace(attn_decode=args.attn_decode)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(2, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        dtype=torch.int32, device=device,
    )
    if args.quant:
        cfg, params = quantize_for_serving(model, params, prompts)
        model = build_model(cfg)
    cache_len = args.prompt_len + args.gen + (args.prompt_len + args.gen) % 2
    cache_len = resolve_cache_len(cfg, cache_len, args.prompt_len, args.gen,
                                  prefix_len(cfg))
    journal = RequestJournal(args.run_dir) if args.run_dir else None
    serving = dict(deadline_s=args.deadline_s, max_retries=args.retries,
                   run_dir=args.run_dir)
    t0 = time.perf_counter()
    if journal is not None:
        # an earlier process stopped mid-request: finish its work first
        for rid, rtoks, _ in replay_pending(model, params, journal,
                                            device=device, **serving):
            log(f"sample[{rid}]: {rtoks[0][:16].cpu().numpy()}")
    for r in range(args.requests):
        toks, done = generate(
            model, params, prompts, gen_len=args.gen, cache_len=cache_len,
            temperature=args.temperature, seed=args.seed, journal=journal,
            request_id=f"req{r}", **serving,
        )
        if args.requests > 1:
            log(f"sample[req{r}]: {toks[0][:16].cpu().numpy()}")
    dt = time.perf_counter() - t0
    n_tok = args.requests * args.batch * args.gen
    sample = toks[0][:16].cpu().numpy()
    n_done = int(done.sum())
    # the facts the obs report rebuilds the summary lines from
    run = obs.REGISTRY.facts("serve.run")
    run.set("arch", cfg.name)
    run.set("shape", tuple(toks.shape))
    run.set("elapsed_s", f"{dt:.2f}")
    run.set("tok_per_s", f"{n_tok / dt:.1f}")
    run.set("recyclable", n_done)
    run.set("batch", args.batch)
    run.set("eos_id", cfg.eos_id)
    run.set("sample", sample)
    log(f"generated {tuple(toks.shape)} x{args.requests} in {dt:.2f}s "
        f"({n_tok / dt:.1f} tok/s); {n_done}/{args.batch} slots "
        f"recyclable (eos={cfg.eos_id})")
    for akey, impl in sorted(ops.ATTN_DECODE_DISPATCH.items()):
        log(f"attn-decode: impl={impl} key={akey} "
            f"calls={ops.ATTN_DECODE_DISPATCH.count(akey)}")
    nbytes = cache_nbytes(model.cache_defs(args.batch, cache_len), cfg.param_dtype)
    fp_model = build_model(cfg.replace(kv_quant="fp"))
    nbytes_fp = cache_nbytes(fp_model.cache_defs(args.batch, cache_len),
                             cfg.param_dtype)
    obs.REGISTRY.gauge("serve.kv_cache_bytes").set(float(nbytes),
                                                   kind="served")
    obs.REGISTRY.gauge("serve.kv_cache_bytes").set(float(nbytes_fp),
                                                   kind="fp")
    log(f"kv-cache bytes: {nbytes} (fp {nbytes_fp}, ratio "
        f"{nbytes_fp / nbytes:.2f}x)")
    log(f"sample: {sample}")
    for line in HEALTH.summary():
        log(f"health: {line}")
    if args.run_dir:
        for path in obs.write_artifacts(args.run_dir):
            log(f"obs artifact: {path}")


if __name__ == "__main__":
    main()
