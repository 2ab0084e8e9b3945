"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so one
source builds in seconds.  Libraries land in ``ops/_build/`` keyed by the
source's content hash: an edited source rebuilds, an unchanged one loads
the library already there.  A build failure raises with nvcc's output;
nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("segment_agg", "expand_positions", "bitonic_sort",
           "prefetch_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found (CUDA toolkit required to "
                               "build the kernels)")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every named source whose library is missing — one nvcc
    process per source, all started together — and return the library
    paths.  Raises :class:`KernelBuildError` if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = [_lib_path(n) for n in names]
    procs = []
    for name, path in zip(names, paths):
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never see half
    if errors:
        raise KernelBuildError("nvcc failed\n" + "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
