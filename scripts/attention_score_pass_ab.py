"""Decode attention (rows 2 and 2b) with its score pass on the tensor cores
against the same kernel with the score pass on the CUDA cores, on one card.

``csrc/attention_decode.cu`` scores a bfloat16 q against a bfloat16 cache
or int8 codes with ``mma.sync`` (``UsesMma``); every other type pair scores
on the CUDA cores. This script builds the checkout's kernel and a copy of
its source with ``UsesMma`` false (so every type pair takes the CUDA-core
path), holds both to ``attention_decode_plain``, and times them at llava's
and jamba's decode shapes, bf16 and int8 caches with a bf16 q, in the order
tensor, cuda, cuda, tensor, twice (``chip_smoke.card_ms``: CUDA events,
queue filled, median of 20 batches of 10, inputs cycled past the L2).

    python3 scripts/attention_score_pass_ab.py

Prints a line a reading and, last, one JSON object with every reading.
Needs one card and ``nvcc``; builds into ``build/kernels/ab``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import attention_decode as ad  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.timing import card_ms  # noqa: E402

MMA_RULE = ("static constexpr bool value = std::is_same<TQ, __nv_bfloat16>"
            "::value &&\n                                !std::is_same<TKV, "
            "float>::value;")
SHAPES = {"llava": (cs.ATTN_LLAVA, [3152] * 4, 4),
          "jamba": (cs.ATTN_JAMBA, [272] * 4, 16)}


def cuda_core_library() -> ctypes.CDLL:
    """The kernel built from the checkout's source with ``UsesMma`` false."""
    src = (build.CSRC / "attention_decode.cu").read_text()
    if MMA_RULE not in src:
        raise RuntimeError("attention_decode.cu has no UsesMma rule to turn off")
    out = build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "attention_decode_cuda_cores.cu"
    cu.write_text(src.replace(MMA_RULE, "static constexpr bool value = false;"))
    lib = out / "attention_decode_cuda_cores.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   check=True, timeout=600)
    cdll = ctypes.CDLL(str(lib))
    cdll.error_string.argtypes = [ctypes.c_int]
    cdll.error_string.restype = ctypes.c_char_p
    return cdll


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = {"tensor": build.library("attention_decode"),
            "cuda": cuda_core_library()}

    def use(which):  # the library ad.decode_attention launches from
        build._LOADED["attention_decode"] = libs[which]

    readings = []
    for shape, (dims, lens, n_sets) in SHAPES.items():
        for cache in ("bf16", "int8"):
            sets = []
            for i in range(n_sets):
                if cache == "int8":
                    sets.append(cs.attn_int8_inputs(
                        500 + i, **dims, q_dtype=torch.bfloat16, lengths=lens))
                else:
                    sets.append(cs.attn_inputs(500 + i, **dims,
                                               dtype=torch.bfloat16,
                                               lengths=lens))
            want = ad.attention_decode_plain(*sets[0])
            outs = {}
            for which in libs:
                use(which)
                outs[which] = ad.decode_attention(*sets[0])
                cs.close(outs[which], want, cs.BTOL,
                         f"{which} {shape} {cache}")
            for which in ("tensor", "cuda", "cuda", "tensor") * 2:
                use(which)
                ms = card_ms(cs.cycling(ad.decode_attention, sets))
                readings.append(dict(shape=shape, cache=cache,
                                     score_pass=which, ms=ms))
                print(f"{shape} {cache} cache, scores on {which} cores: "
                      f"{ms:.5f} ms", flush=True)
            del sets
            torch.cuda.empty_cache()
    use("tensor")
    print(json.dumps({"device": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
