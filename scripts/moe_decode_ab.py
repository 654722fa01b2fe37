"""qwen3-moe-30b-a3b's full-width fp request and decode step, as
``chip_smoke.py`` phase 45 serves them, for one tree of this repository, so
that two trees' one-rank MoE path can be compared in one call on one card:

    git archive <commit> | tar -x -C build/parent
    python3 scripts/moe_decode_ab.py . build      # builds the kernels only
    cp -r build/kernels build/parent/build/       # same sources, same names
    for r in build/parent . . build/parent; do
        python3 scripts/moe_decode_ab.py $r; done

Imports ``chip_smoke`` and the port from the tree at argv[1] (its kernels
in that tree's ``build/kernels``), draws the model as phase 45 does
(``_decoder_init``, seed 0) and serves phase 45's request through
``_serve_request`` (B 4, P 256, 32 tokens, row 2's launches checked).
Then it profiles one decode step at position P with ``profile_busy``
(``REPS`` calls timed, then profiled). Prints one line, ``MOE <tree>
{json}``: the request's decode-step median, TTFT and tokens/s, and the
profiled step's wall ms, busy ms and kernels. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import sys

ROOT = sys.argv[1] if len(sys.argv) > 1 else "."
for p in (ROOT, ROOT + "/src"):
    sys.path.insert(0, p)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

REPS = 20  # decode steps timed, then as many profiled


def main() -> int:
    repro_torch.resolve_device("cuda")
    build.build_all()
    if sys.argv[2:] == ["build"]:
        return 0
    model, params, _ = cs._decoder_init(models, configs, cs.MOE, iter_leaves)
    cfg = model.cfg
    prompts = cs._decoder_prompts(cfg)
    gen, (B, P) = cs.SERVE["gen"], prompts.shape
    req = cs._serve_request(serve, model, params, prompts, gen,
                            cs.only(attention_decode=cfg.num_layers * (gen - 1)),
                            f"{cs.MOE} full-width fp")
    cache_len = serve.resolve_cache_len(cfg, P + gen, P, gen)
    with torch.no_grad():
        logits, cache = serve.prefill_cache(model, params, prompts,
                                            cache_len=cache_len)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    step = cs.profile_busy(lambda: model.decode_step(params, cache, tok, P),
                           reps=REPS)
    out = dict(request_decode_step_ms=req["decode_step_ms"],
               ttft_ms=req["ttft_ms"], tok_per_s=req["tok_per_s"],
               step_wall_ms=step["wall_ms"], step_busy_ms=step["busy_ms"],
               step_kernels=step["kernels"], reps=REPS)
    print("MOE", ROOT, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
