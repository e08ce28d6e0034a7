"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``build/repro_torch_kernels/`` at first use; the file
name carries a hash of the source and flags, so an edited source rebuilds
and an unchanged one loads straight away.  Nothing here runs at import
time: this module only touches ``nvcc`` or the CUDA driver when a wrapper
is handed a CUDA tensor (or :func:`build` is called).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["BUILD_DIR", "KERNEL_SOURCES", "build", "load", "loaded"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
# repo root (src/repro_torch/kernels -> repo)
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch_kernels"
KERNEL_SOURCES = ("filtered_topk", "distance", "quant_topk", "graph_step",
                  "flash_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "filtered_topk": {
        "repro_filtered_topk": ([_P] * 8 + [_I] * 15 + [_L] * 6 + [_P], _I),
    },
    "distance": {
        "repro_pairwise_dist": ([_P, _P, _P] + [_I] * 10 + [_P], _I),
    },
    "quant_topk": {
        "repro_quant_topk": ([_P] * 9 + [_I] * 14 + [_L] * 4 + [_P], _I),
    },
    "graph_step": {
        "repro_graph_step": ([_P] * 8 + [_I] * 13 + [_P], _I),
    },
    "flash_decode": {
        "repro_flash_decode": ([_P] * 8 + [_I] * 8 + [_P], _I),
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("repro_torch: nvcc not found (looked on PATH and "
                           "in /usr/local/cuda/bin); the CUDA kernels are "
                           "built from source at first use")
    return path


def _so_path(name: str) -> Path:
    """Library path keyed by the source, every shared header and the
    flags, so an edit to any of them rebuilds."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns ``{name: compiler
    output}`` (``-Xptxas -v``: registers, shared memory, spills) for the
    sources built by this call; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _so_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch: nvcc failed for " + "\n".join(failed))
    return logs


def loaded(name: str) -> bool:
    """Whether the library for ``csrc/<name>.cu`` is loaded already."""
    return name in _LIBS


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_so_path(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LIBS[name] = lib
    return lib
