"""How far apart are jamba-1.5-large's float32 serving states when only the
order of a sum changes, on the card? Phase 53(e)'s model (one period, no
experts, published widths, fan-in rescaled):

    python3 scripts/jamba_tp_noise.py

The one-rank request's prefill mamba states (conv and ssm, each of the 7
layers) and its prefill and decode logits, against (1) the same request
on (model 2) ranks sharing the card over gloo, each rank's channel block
(tensor parallelism: x_proj's and out_proj's sums split over the ranks,
then ``psum``); (2) rows 0-1 of the same weights prefilled alone (B 2 in
place of 4: the matrix products' shapes, so their summation order,
change; nothing else does). Prints, per state leaf, max |diff| over the
leaf's max |value| and the relative L2 norm of the difference. Builds
only the depthwise and decode-attention libraries. Needs one card.
"""
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402


def _states(cache) -> dict:
    return {f"{k}/{n}": t.float().cpu().numpy()
            for k, v in cache.items() if k.startswith("mamba")
            for n, t in v.items()}


def main() -> int:
    dev = repro_torch.resolve_device("cuda")
    keep = {"conv1d_depthwise", "attention_decode"}
    every = build.sources
    build.sources = lambda: {k: v for k, v in every().items() if k in keep}
    build.build_all()
    over = dict(cs.MESH_JAMBA_CUT)
    cfg = configs.get_config(cs.JAMBA).replace(**over)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(
        cs.SERVE["B"], cs.SERVE["P"])), dtype=torch.int32, device=dev)
    gen = cs.MESH_MOE_GEN
    m = models.build_model(cfg)
    with torch.no_grad():
        p = m.init(torch.Generator(device=dev).manual_seed(0))
        cs.rescale_fan_in(p, m.param_defs(), iter_leaves)
        _, c4 = serve.prefill_cache(m, p, prompts, cache_len=cs.SERVE["P"])
        _, c2 = serve.prefill_cache(m, p, prompts[:2], cache_len=cs.SERVE["P"])
    s4, s2 = _states(c4), _states(c2)
    del c4, c2
    states: list = []
    one = cs._mesh_serve(serve, m, p, prompts, gen, states)
    del m, p
    torch.cuda.empty_cache()
    out = {"batch_split": {k: cs.state_errs(s2[k], s4[k][:, :2])
                           for k in s4}}
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(cs._serve_rank, 1, 2, device="cuda",
                          backend="gloo", rdv_dir=d,
                          args=(cs.JAMBA, over, prompts.cpu().numpy(), gen,
                                True), timeout_s=cs.MESH_TIMEOUT_S)
    ref = cs.flat_states(states[0])
    tp = {}
    for r in ranks:
        for k, got in r["states"].items():
            e = cs.state_errs(got, cs.state_block(ref[k], k,
                                                  r["coords"]["model"], got))
            tp[k] = tuple(max(a, b) for a, b in zip(tp.get(k, (0, 0)), e))
        out[f"logits_rank{r['rank']}"] = [
            cs.state_errs(g, w) for g, w in zip(r["logits"], one[1])]
        out[f"tokens_equal_rank{r['rank']}"] = bool(
            np.array_equal(r["tokens"], one[0]))
    out["tensor_parallel"] = tp
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
