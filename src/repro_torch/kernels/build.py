"""Build and load the hand-written CUDA kernels.

Every ``*.cu`` under ``kernels/csrc`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

Each output is keyed on a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an unchanged tree loads what an earlier
run built. All sources compile in parallel, one
``nvcc`` each. A missing ``nvcc`` or a failed build raises; nothing falls
back. ``ptxas``'s report (registers, shared memory, spills) is kept beside
each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# streaming multiprocessors of the H100 SXM: the launch geometry that the
# plain versions follow for tensors that lie on no card
DEFAULT_SMS = 132

_LOADED: dict[str, ctypes.CDLL] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``'s card, from which the
    wrappers size their launches; ``DEFAULT_SMS`` for a device that is no
    card."""
    if device.type != "cuda":
        return DEFAULT_SMS
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _card_sms(index)


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _output(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Build every kernel whose library is missing, all at once; return
    ``{name: library path}``. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {name: _output(src) for name, src in sources().items()}
    todo = {n: o for n, o in outs.items() if not o.exists()}
    if not todo:
        return outs
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out = todo[name]
        out.with_suffix(".log").write_text(log)
        tmp.replace(out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """The compiler's report for kernel ``name`` (after a build)."""
    return _output(sources()[name]).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of kernel ``name``, typed once: every pointer and
    the stream ``c_void_p``, every int ``c_int``, returning a CUDA error
    code."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a C entry of kernel ``name`` returned a CUDA error code."""
    if code != 0:
        msg = library(name).error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
