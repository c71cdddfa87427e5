"""Build and load the port's CUDA kernels.

Each ``vitok_torch/csrc/<name>.cu`` is compiled on first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, cached under
``vitok_torch/build/`` by a hash of the source and the flags, and loaded with
``ctypes``. Several sources build in parallel, one ``nvcc`` each.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels are "
        "compiled from vitok_torch/csrc on the machine with the card"
    )


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no cached library, all at once."""
    pending = []
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((name, so, tmp, proc))
    failures = []
    for name, so, tmp, proc in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.vitok_cuda_error_string.argtypes = [ctypes.c_int]
            lib.vitok_cuda_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.vitok_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["build", "load", "check", "BUILD_DIR", "CSRC"]
