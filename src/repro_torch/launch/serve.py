"""Serving: batched prefill, then greedy or temperature decode
against a static KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --smoke --batch 2 --prompt-len 16 --gen 8 --conv-backend sliding_pallas

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --batch 2 --prompt-len 16 \
        --gen 8 --conv-backend sliding_pallas --quant int8 --kv-quant int8

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llava-next-34b --smoke --batch 2 --prompt-len 8 --gen 4

The core of ``repro.launch.serve``, with the same flags and the same
``[serve]`` summary lines, so one command line drives both packages. It
runs on the card unless ``--device cpu`` is given. One prefill per batch
of requests, then one decode step per token; slots that emit
``cfg.eos_id`` are finished and keep decoding into masked positions.
``generate`` re-runs a request whose logits turn non-finite in every slot
(bounded retries) and truncates it at ``deadline_s``.

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

Not ported yet: the request journal, load shedding, the watchdog and
heartbeats (``--run-dir``) and span tracing (``--trace``).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch import quant, resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.ft import RestartPolicy
from repro_torch.distributed.sharding import iter_leaves, torch_dtype
from repro_torch.health import HEALTH
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.common import quantize_kv_leaf
from repro_torch.models.llava import VISION_DIM


def log(msg: str) -> None:
    print(f"[serve] {msg}", flush=True)


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
    return logits, pad_cache_to_defs(cache, defs, cfg.param_dtype)


def _screen_logits(logits: torch.Tensor, step: int):
    """Per-step numeric guard: every slot non-finite fails the request (the
    retry in ``generate`` re-runs it); some slots non-finite returns their
    (B,) mask, and the decode loop finishes just those slots."""
    bad = ~torch.isfinite(logits).flatten(1).all(dim=1)
    if not bool(bad.any()):
        return None
    if bool(bad.all()):
        raise FloatingPointError(f"non-finite logits at decode step {step}")
    return bad


def _generate_once(model, params, prompts, *, gen_len, cache_len,
                   temperature, seed, deadline_s, nan_guard, stats, patches):
    cfg = model.cfg
    dev = prompts.device
    eos = cfg.eos_id
    B, P = prompts.shape
    start = prefix_len(cfg, patches) + P  # the first decode position
    t_start = time.perf_counter()
    logits, cache = prefill_cache(model, params, prompts, cache_len=cache_len,
                                  gen_len=gen_len, patches=patches)
    bad = _screen_logits(logits, -1) if nan_guard else None
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
    _sync(dev)
    stats["ttft_s"] = time.perf_counter() - t_start  # prefill + first token
    done = tok[:, 0] == eos
    if bad is not None:
        done = done | bad
        tok = torch.where(done[:, None], eos, tok)
    out = [tok]
    for i in range(gen_len - 1):
        t_step = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, start + i)
        bad = _screen_logits(logits, i) if nan_guard else None
        if bad is not None:
            done = done | bad
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
        stats.setdefault("step_s", []).append(time.perf_counter() - t_step)
        if deadline_s is not None and time.perf_counter() - t_start > deadline_s:
            # truncate: the remaining positions pad with eos, every slot done
            out.append(torch.full((B, gen_len - len(out)), eos,
                                  dtype=torch.int32, device=dev))
            done = torch.ones_like(done)
            stats["truncated"] = True
            break
    return torch.cat(out, dim=1), done


def generate(model, params, prompts: torch.Tensor, *, gen_len: int,
             cache_len: int, temperature: float = 0.0, seed: int = 0,
             deadline_s: float | None = None, max_retries: int = 2,
             nan_guard: bool = True, stats: dict | None = None,
             patches: torch.Tensor | None = None):
    """prompts: (B, P) integer tensor on the serving device -> ((B, gen_len)
    int32 tokens, (B,) bool done mask). ``patches`` (B, n, 1152) replaces
    a vision stub's zero patches.

    A request whose logits are non-finite in every slot is re-run, up to
    ``max_retries`` times with short backoff, before the error propagates;
    any other failure propagates at once. ``deadline_s`` bounds the wall
    clock per request: on expiry the result is eos-padded and every slot is
    done. ``stats``, when given, receives ``ttft_s`` (prefill through the
    first token) and ``step_s`` (one entry per decode step), host clock
    around work that ends in a device synchronise."""
    stats = {} if stats is None else stats
    policy = RestartPolicy(max_restarts=max_retries, base_backoff_s=0.05,
                           max_backoff_s=2.0)
    while True:
        stats.clear()
        try:
            with torch.no_grad():
                return _generate_once(
                    model, params, prompts, gen_len=gen_len,
                    cache_len=cache_len, temperature=temperature, seed=seed,
                    deadline_s=deadline_s, nan_guard=nan_guard, stats=stats,
                    patches=patches,
                )
        except FloatingPointError:
            delay = policy.next_backoff()
            if delay is None:
                raise
            time.sleep(delay)


def quantize_for_serving(model, params, prompts):
    """int8 post-training quantization of the model's conv path: an eager
    calibration prefill, the activation scales with the requant chains
    (``quant.CHAINS``), then int8 weight leaves. Returns (cfg', params'),
    cfg' with ``conv_precision="w8a8"``."""
    cfg = model.cfg
    B, P = prompts.shape
    calib = quant.Calibration()
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


NOT_PORTED = ("run_dir", "trace")


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
                    choices=["sliding", "sliding_pallas", "xla"],
                    help="conv evaluation for the model's conv layers "
                         "(whisper's frontend, jamba's mamba convs); "
                         "sliding_pallas runs them through the CUDA kernels")
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="post-training-quantize the conv path (w8a8)")
    ap.add_argument("--kv-quant", choices=["int8"], default=None,
                    help="store the serving KV cache int8 + per-row scales")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), nargs="?",
                        const="on", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag) is not None:
            ap.error(f"--{flag.replace('_', '-')} is not ported yet")

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
    t0 = time.perf_counter()
    toks, done = generate(
        model, params, prompts, gen_len=args.gen, cache_len=cache_len,
        temperature=args.temperature, seed=args.seed,
    )
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.gen
    log(f"generated {tuple(toks.shape)} x1 in {dt:.2f}s "
        f"({n_tok / dt:.1f} tok/s); {int(done.sum())}/{args.batch} slots "
        f"recyclable (eos={cfg.eos_id})")
    for akey, impl in sorted(ops.ATTN_DECODE_DISPATCH.items()):
        log(f"attn-decode: impl={impl} key={akey} "
            f"calls={ops.ATTN_DECODE_DISPATCH.count(akey)}")
    nbytes = cache_nbytes(model.cache_defs(args.batch, cache_len), cfg.param_dtype)
    fp_model = build_model(cfg.replace(kv_quant="fp"))
    nbytes_fp = cache_nbytes(fp_model.cache_defs(args.batch, cache_len),
                             cfg.param_dtype)
    log(f"kv-cache bytes: {nbytes} (fp {nbytes_fp}, ratio "
        f"{nbytes_fp / nbytes:.2f}x)")
    log(f"sample: {toks[0][:16].cpu().numpy()}")
    for line in HEALTH.summary():
        log(f"health: {line}")


if __name__ == "__main__":
    main()
