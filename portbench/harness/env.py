"""The run's environment: caches inside the checkout, the card check,
and the check that nothing of JAX or the JAX package was loaded."""
from __future__ import annotations

import os
import sys
from typing import Iterable, List

from portbench.harness.spec import HERE

# top-level module names a run may not load, compared whole: the port
# (``caps_tpu_torch``) begins with the JAX package's name
FORBIDDEN = ("jax", "jaxlib", "flax", "caps_tpu", "chip_smoke")

CACHE = os.path.join(HERE, ".cache")


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


class ForbiddenImport(RuntimeError):
    """A module of JAX or of the JAX package is loaded."""


def prepare() -> None:
    """Before torch or the port is imported: fixed cache directories in
    the checkout, and no engine setting from the environment (the
    configuration and the mix state every setting the run uses)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var in [v for v in os.environ if v.startswith("CAPS_TPU_")]:
        del os.environ[var]


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} are visible")


def forbidden_loaded(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` that are forbidden."""
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_imports() -> None:
    found = forbidden_loaded(list(sys.modules))
    if found:
        raise ForbiddenImport(f"loaded modules of JAX or the JAX package: "
                              f"{found}")
