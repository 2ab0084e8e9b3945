"""caps_tpu_torch — the openCypher property-graph engine on PyTorch + CUDA.

A port of ``caps_tpu`` (JAX + Pallas on a TPU) to PyTorch with kernels
written by hand for NVIDIA Hopper.  The layering mirrors the JAX
package module for module:

    okapi/       value model, type lattice, schema, graph/session API
    frontend/    openCypher lexer + recursive-descent parser + semantic checks
    ir/          typed expression tree, query blocks, pattern, IR builder
    logical/     logical operator algebra, planner, optimizer
    relational/  RecordHeader, Table SPI, relational operators, planner, graphs
    backends/    cuda: the Table SPI over device tensors; local: the
                 pure-Python oracle
    ops/         hand-written CUDA kernels for the hot operators
    interop.py   build a graph from the numpy arrays a test or loader holds

Features the port has not reached yet raise ``NotImplementedError``
naming ROADMAP.
"""

from caps_tpu_torch.okapi.types import (  # noqa: F401
    CTAny, CTBoolean, CTFloat, CTInteger, CTList, CTMap, CTNode, CTNull,
    CTRelationship, CTString, CTVoid, CypherType,
)
from caps_tpu_torch.okapi.values import (  # noqa: F401
    CypherList, CypherMap, CypherNode, CypherRelationship, CypherValue,
)
from caps_tpu_torch.okapi.schema import Schema  # noqa: F401
from caps_tpu_torch.okapi.graph import (  # noqa: F401
    GraphName, Namespace, QualifiedGraphName,
)

__version__ = "0.1.0"


class _Card(str):
    """The default ``device``: equal to ``"cuda"``, and told apart from
    an explicit ``device="cuda"`` by identity."""


_CARD = _Card("cuda")


def local_session(backend: str = "cuda", device=_CARD, **kwargs):
    """Create a local Cypher session (the counterpart of
    ``caps_tpu.local_session``).

    backend="cuda" returns a
    :class:`~caps_tpu_torch.backends.cuda.session.CUDACypherSession` on
    ``device`` — the card unless the caller passes ``device="cpu"``.
    With ``device="cuda"`` and no CUDA it raises; it never quietly runs
    on the CPU.  backend="local" (or "oracle") returns the pure-Python
    oracle session (:mod:`caps_tpu_torch.backends.local`): host-only by
    nature, so an explicit ``device`` raises ``ValueError``.
    """
    if backend in ("local", "oracle"):
        if device is not _CARD:
            raise ValueError(
                f"backend {backend!r} runs on the host and takes no device "
                f"(got device={device!r})")
        from caps_tpu_torch.backends.local.session import LocalCypherSession
        return LocalCypherSession(**kwargs)
    if backend == "cuda":
        from caps_tpu_torch.backends.cuda.session import CUDACypherSession
        return CUDACypherSession(
            device=str(device) if device is _CARD else device, **kwargs)
    raise ValueError(f"unknown backend {backend!r}")
