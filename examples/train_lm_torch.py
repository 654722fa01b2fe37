"""End-to-end LM training example in PyTorch (``examples/train_lm.py`` on
``repro_torch``).

Default: a ~10M-parameter qwen3-family model for 300 steps, the whole
production loop: deterministic data, checkpoints, resume, the watchdog.
``--preset 100m`` trains the ~100M-parameter config (the same code path).
It runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""
import argparse
import os
import tempfile
from types import SimpleNamespace

from repro_torch.configs import get_config
from repro_torch.launch import train as T

PRESETS = {
    # ~10M params: d=256, 4 layers
    "10m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                head_dim=64, d_ff=1024, vocab_size=8192),
    # ~100M params: d=768, 12 layers
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=2304, vocab_size=32768),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="10m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--run-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args_in = ap.parse_args(argv)

    cfg = get_config("qwen3-1.7b").replace(
        **PRESETS[args_in.preset],
        param_dtype="float32", compute_dtype="float32",
        attn_chunk=128, loss_chunk=128,
    )
    n_params = (
        cfg.vocab_size * cfg.d_model
        + cfg.num_layers * (
            cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads)
            * cfg.resolved_head_dim
            + cfg.num_heads * cfg.resolved_head_dim * cfg.d_model
            + 3 * cfg.d_model * cfg.d_ff
        )
    )
    print(f"[example] training ~{n_params / 1e6:.0f}M-param model "
          f"for {args_in.steps} steps")
    args = SimpleNamespace(  # train_loop's arguments
        arch="qwen3-1.7b", smoke=False, steps=args_in.steps,
        batch=args_in.batch, seq=args_in.seq, lr=1e-3, seed=0,
        run_dir=args_in.run_dir, ckpt_every=100, log_every=10,
        grad_accum=None, no_resume=True, fail_at=None,
        device=args_in.device)
    # the custom config goes in through the lookup train_loop makes
    orig = T.get_config
    T.get_config = lambda name: cfg
    try:
        out = T.train_loop(args)
    finally:
        T.get_config = orig
    first = sum(out["losses"][:10]) / max(len(out["losses"][:10]), 1)
    print(f"[example] loss: first10 {first:.3f} -> final "
          f"{out['final_loss']:.3f}")
    if not out["final_loss"] < first:
        raise AssertionError("loss should decrease")
    return dict(out, n_params=n_params, first10=first)


if __name__ == "__main__":
    main()
