"""The ``CALL algo.*`` procedure registry: names, signatures, defaults.

One catalog maps a dotted procedure name to its :class:`ProcedureSignature`
— the positional argument specs (name, coarse type, default) and the
YIELD columns (name, CypherType) the procedure emits.  The frontend's
semantic pass resolves ``CALL`` clauses against this catalog so an
unknown name or a mis-typed argument fails at *check* time with a typed
error that names the procedure and renders the registered signatures
(satellite: not a generic parse failure), and the planner reads the
yield specs to type the operator's output columns.

This module is deliberately dependency-light (no jax, no numpy): the
semantic pass imports it on every ``CALL`` statement, including in
environments where the kernel substrate is absent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from caps_tpu_torch.frontend.semantic import CypherSemanticError
from caps_tpu_torch.okapi.types import CTFloat, CTInteger, CypherType

#: sentinel: the argument has no default and must be supplied
REQUIRED = object()


class ProcedureError(CypherSemanticError):
    """Base of the typed ``CALL`` resolution errors — a subclass of the
    semantic error so callers that catch check failures keep working."""


class UnknownProcedureError(ProcedureError):
    """``CALL`` named a procedure the registry does not know."""


class ProcedureArgumentError(ProcedureError):
    """Arity or argument-type mismatch against a known signature."""


class ProcedureYieldError(ProcedureError):
    """``YIELD`` named a column the procedure does not emit."""


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One positional argument: coarse type tag + optional default."""

    name: str
    type_tag: str  # "INTEGER" | "FLOAT" | "STRING"
    default: Any = REQUIRED

    @property
    def required(self) -> bool:
        return self.default is REQUIRED

    def accepts(self, value: Any) -> bool:
        if self.type_tag == "INTEGER":
            return isinstance(value, int) and not isinstance(value, bool)
        if self.type_tag == "FLOAT":
            return (isinstance(value, (int, float))
                    and not isinstance(value, bool))
        if self.type_tag == "STRING":
            return isinstance(value, str)
        return True  # pragma: no cover — no other tags registered

    def render(self) -> str:
        d = "" if self.required else f" = {self.default!r}"
        return f"{self.name}{d} :: {self.type_tag}"


@dataclasses.dataclass(frozen=True)
class YieldSpec:
    """One output column the procedure emits."""

    name: str
    ctype: CypherType

    def render(self) -> str:
        return f"{self.name} :: {self.ctype!r}"


@dataclasses.dataclass(frozen=True)
class ProcedureSignature:
    name: str
    args: Tuple[ArgSpec, ...]
    yields: Tuple[YieldSpec, ...]
    description: str
    #: prior on fixpoint iterations — the cost model's pricing input
    est_iterations: int = 1

    def render(self) -> str:
        a = ", ".join(s.render() for s in self.args)
        y = ", ".join(s.render() for s in self.yields)
        return f"{self.name}({a}) :: ({y})"

    @property
    def yield_names(self) -> Tuple[str, ...]:
        return tuple(y.name for y in self.yields)

    def yield_type(self, name: str) -> CypherType:
        for y in self.yields:
            if y.name == name:
                return y.ctype
        raise ProcedureYieldError(
            f"procedure {self.name} does not yield {name!r}; "
            f"signature: {self.render()}")

    def check_arity(self, n_args: int) -> None:
        required = sum(1 for a in self.args if a.required)
        if not required <= n_args <= len(self.args):
            raise ProcedureArgumentError(
                f"procedure {self.name} takes "
                f"{required}..{len(self.args)} argument(s), got {n_args}; "
                f"signature: {self.render()}")

    def check_literal(self, position: int, value: Any) -> None:
        """Type-check one *literal* argument at semantic-check time
        (parameter bindings are only checkable at bind time)."""
        spec = self.args[position]
        if not spec.accepts(value):
            raise ProcedureArgumentError(
                f"procedure {self.name} argument {spec.name!r} "
                f"(position {position}) expects {spec.type_tag}, "
                f"got {value!r}; signature: {self.render()}")

    def bind(self, values: Sequence[Any]) -> Dict[str, Any]:
        """Positional values (+ defaults) -> the kernels' kwargs dict,
        re-validated (parameter bindings bypass the literal check)."""
        self.check_arity(len(values))
        bound: Dict[str, Any] = {}
        for i, spec in enumerate(self.args):
            if i < len(values):
                self.check_literal(i, values[i])
                v = values[i]
            else:
                v = spec.default
            if spec.type_tag == "FLOAT" and isinstance(v, int):
                v = float(v)
            bound[spec.name] = v
        return bound


_REGISTRY: Dict[str, ProcedureSignature] = {}


def _register(sig: ProcedureSignature) -> ProcedureSignature:
    _REGISTRY[sig.name] = sig
    return sig


PAGERANK = _register(ProcedureSignature(
    "algo.pagerank",
    (ArgSpec("damping", "FLOAT", 0.85),
     ArgSpec("max_iterations", "INTEGER", 20),
     ArgSpec("tolerance", "FLOAT", 1.0e-6)),
    (YieldSpec("node", CTInteger), YieldSpec("score", CTFloat)),
    "damped PageRank by power iteration (SpMV per round)",
    est_iterations=20))

WCC = _register(ProcedureSignature(
    "algo.wcc",
    (ArgSpec("max_iterations", "INTEGER", 100),),
    (YieldSpec("node", CTInteger), YieldSpec("component", CTInteger)),
    "weakly connected components by min-label propagation",
    est_iterations=8))

BFS = _register(ProcedureSignature(
    "algo.bfs",
    (ArgSpec("source", "INTEGER"),
     ArgSpec("max_depth", "INTEGER", -1)),
    (YieldSpec("node", CTInteger), YieldSpec("dist", CTInteger)),
    "unweighted hop distance by frontier relaxation (reachable only)",
    est_iterations=8))

SSSP = _register(ProcedureSignature(
    "algo.sssp",
    (ArgSpec("source", "INTEGER"),
     ArgSpec("weight", "STRING", ""),
     ArgSpec("max_iterations", "INTEGER", -1)),
    (YieldSpec("node", CTInteger), YieldSpec("dist", CTFloat)),
    "single-source shortest paths by edge relaxation",
    est_iterations=8))

DEGREE = _register(ProcedureSignature(
    "algo.degree",
    (ArgSpec("direction", "STRING", "both"),),
    (YieldSpec("node", CTInteger), YieldSpec("degree", CTInteger)),
    "per-node degree by segment sum (the warm-up case)",
    est_iterations=1))


def procedure_names() -> List[str]:
    return sorted(_REGISTRY)


def registered_signatures() -> str:
    """Every signature rendered one per line — the text the typed
    unknown-name error carries so the caller sees what IS registered."""
    return "\n".join(_REGISTRY[n].render() for n in procedure_names())


def lookup(name: str) -> ProcedureSignature:
    sig = _REGISTRY.get(name)
    if sig is None:
        raise UnknownProcedureError(
            f"unknown procedure {name!r}; registered procedures:\n"
            + registered_signatures())
    return sig


def maybe_lookup(name: str) -> Optional[ProcedureSignature]:
    return _REGISTRY.get(name)
