"""Builds the port's CUDA kernels from ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under ``build/kernels/``
at the root of the checkout (git-ignored). The library's file name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
:func:`build_all` compiles every missing library with one ``nvcc`` process
per source, all started together; :func:`load` builds on first use.
Nothing here runs at import time.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("conv3x3", "conv3x3_dw", "warp_depth", "warp_grid", "warp_grad",
           "warp_mei", "photo_loss")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of fsnet_tpu_torch "
                           "are built from source on a machine with the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in
    parallel. Returns the compiler's messages by name (``-Xptxas -v``:
    registers, shared memory and spills of each kernel); raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)     # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
