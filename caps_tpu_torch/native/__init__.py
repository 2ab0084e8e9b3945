"""Loader for the native host runtime (native/csrc/host_runtime.cpp).

The counterpart of ``caps_tpu/native/__init__.py``.  On first use
:func:`runtime` compiles the CPython extension with ``g++ -O2 -std=c++17
-shared -fPIC`` into ``native/_build/`` (one file per source hash,
written to a temporary file and renamed, so concurrent builders and an
interrupted link leave nothing half written), loads it and keeps it for
the process.  Importing this module builds nothing.

Unlike the reference, a failed build does not fall back to pure Python
quietly: :func:`runtime` raises :class:`NativeBuildError` with the
compiler's error.  The pure-Python and numpy twins of its callers
(``backends/cuda/pool.py``, ``backends/cuda/column.py``,
``ops/expand.py``) run only when the caller opts out explicitly with
``CAPS_TPU_NO_NATIVE=1`` in the environment, as the tests do to compare
the two.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from types import ModuleType
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "host_runtime.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")
_MODULE = "_caps_torch_host"
#: set (to anything non-empty) to opt out: the callers take their
#: pure-Python / numpy twins
OPT_OUT_ENV = "CAPS_TPU_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ModuleType] = None


class NativeBuildError(RuntimeError):
    """The native runtime could not be compiled or loaded."""


def opted_out() -> bool:
    return bool(os.environ.get(OPT_OUT_ENV))


def so_path(source: Optional[str] = None) -> str:
    """The shared object for ``source`` (default the package's): keyed
    by the source's hash and the interpreter's ABI tag."""
    with open(source or _SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    tag = sysconfig.get_config_var("SOABI") or "none"
    return os.path.join(_BUILD_DIR, f"{_MODULE}.{digest}.{tag}.so")


def build(source: Optional[str] = None, so: Optional[str] = None) -> str:
    """Compile ``source`` (default the package's) into ``so`` (default
    :func:`so_path`) unless it is there already; returns the path.
    Raises :class:`NativeBuildError` naming the compiler's error."""
    source = source or _SRC
    so = so or so_path(source)
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    include = sysconfig.get_paths()["include"]
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           f"-I{include}", source, "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as ex:
            raise NativeBuildError(
                f"native build failed: {' '.join(cmd)}: {ex}") from ex
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed ({' '.join(cmd)}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load(so: str) -> ModuleType:
    """Import the extension at ``so``."""
    spec = importlib.util.spec_from_file_location(_MODULE, so)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
    except ImportError as ex:
        raise NativeBuildError(f"native load failed: {so}: {ex}") from ex
    return mod


def runtime() -> Optional[ModuleType]:
    """The native runtime, built and loaded on first use; None only when
    the caller opted out (:data:`OPT_OUT_ENV`).  A failed build raises
    :class:`NativeBuildError` on every call."""
    global _lib
    if opted_out():
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = load(build())
    return _lib
