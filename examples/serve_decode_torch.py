"""Batched serving example in PyTorch: prefill a batch of prompts, then
decode against a static cache (``examples/serve_decode.py`` on
``repro_torch``).

    PYTHONPATH=src python examples/serve_decode_torch.py --arch qwen3-1.7b
    # rwkv6: O(1) state per layer
    PYTHONPATH=src python examples/serve_decode_torch.py --arch rwkv6-1.6b
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

The arch's smoke config (float32, 2 layers, d 128) with random weights
from a seed, on the card unless ``--device cpu`` is given; on the card a
decoder's every decode step reads its KV cache through the
decode-attention kernel (rwkv6 has no attention and no kernel). Two
requests with the same prompts must give the same greedy tokens.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_config(args.arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(2, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    cache_len = args.prompt_len + args.gen
    t0 = time.perf_counter()
    toks, done = generate(model, params, prompts, gen_len=args.gen,
                          cache_len=cache_len)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch}: {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, first request); "
          f"{int(done.sum())}/{args.batch} slots hit eos={cfg.eos_id}")
    print("[serve] greedy sample:", toks[0][:12].cpu().numpy())
    # decode determinism: same prompt -> same continuation
    toks2, _ = generate(model, params, prompts, gen_len=args.gen,
                        cache_len=cache_len)
    if not torch.equal(toks, toks2):
        raise AssertionError("two requests gave different greedy tokens")
    print("[serve] determinism check passed")
    return dict(tokens=toks.cpu(), seconds=dt, done=int(done.sum()))


if __name__ == "__main__":
    main()
