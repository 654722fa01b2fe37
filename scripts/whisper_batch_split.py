"""Is whisper-medium's float32 loss the same on four rows as on its rows
split, on the card? With the reference's init and with the fan-in
weights rescaled (``chip_smoke.rescale_whisper``):

    python3 scripts/whisper_batch_split.py

For the conv backends ``sliding_pallas`` (rows 1 and 10) and ``xla``
(the library convs), and each init: the frontend and the encoder on
rows 0-1 of a four-row batch against the same rows alone (max |diff|
and the output's max), and the loss on four rows against the four
one-row losses combined by their label counts, as a data-parallel mean
combines them. Builds only the two conv libraries. Needs one card.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.distributed.sharding import iter_leaves  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.whisper import conv_frontend  # noqa: E402


def main() -> int:
    dev = repro_torch.resolve_device("cuda")
    keep = {"sliding_conv1d", "sliding_conv_bwd"}
    every = build.sources
    build.sources = lambda: {k: v for k, v in every().items() if k in keep}
    build.build_all()
    B, seq = cs.MESH_TRAIN["B"], cs.MESH_TRAIN["seq"]
    for rescaled in (False, True):
        for backend in ("sliding_pallas", "xla"):
            cfg = configs.get_config("whisper-medium").replace(
                conv_backend=backend, param_dtype="float32",
                compute_dtype="float32")
            m = models.build_model(cfg)
            with torch.no_grad():
                p = m.init(torch.Generator(device=dev).manual_seed(0))
                if rescaled:
                    cs.rescale_whisper(p, m.param_defs(), iter_leaves)
                full = cs.train_batches(cfg, B, seq, 1, 0, dev, train)[0]
                f4 = conv_frontend(p["frontend"], full["frames"], cfg)
                f2 = conv_frontend(p["frontend"], full["frames"][:2], cfg)
                e4 = m.encode(p, full["frames"])
                e2 = m.encode(p, full["frames"][:2])
                l4 = float(m.loss(p, full))
                c = min(cfg.loss_chunk, seq)
                rows = [float(m.loss(p, {k: v[i:i + 1] for k, v in full.items()}))
                        for i in range(B)]
                counts = [float((full["labels"][i, :(seq // c) * c] >= 0).sum())
                          for i in range(B)]
            comb = sum(a * n for a, n in zip(rows, counts)) / sum(counts)
            print(f"rescaled={rescaled} {backend}: frontend rows 0-1 max "
                  f"|diff| {(f4[:2] - f2).abs().max().item():.3e} of "
                  f"{f4.abs().max().item():.3e}; encoder "
                  f"{(e4[:2] - e2).abs().max().item():.3e} of "
                  f"{e4.abs().max().item():.3e}; loss {B} rows {l4:.6f}, "
                  f"rows combined {comb:.6f} (rel "
                  f"{abs(l4 - comb) / abs(l4):.3e})", flush=True)
            del m, p, full
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
