"""User-facing graph/session API surface.

Mirrors the reference's ``CypherSession``, ``PropertyGraph``,
``CypherResult``/``CypherRecords``, ``QualifiedGraphName``/``Namespace``/
``GraphName`` (ref: okapi-api/.../api/graph/ — reconstructed, mount empty;
SURVEY.md §2 "Graph/session API").

These are pure interfaces; the concrete engine lives in
``caps_tpu.relational`` with backends under ``caps_tpu.backends``.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from caps_tpu_torch.okapi.schema import Schema


@dataclasses.dataclass(frozen=True, order=True)
class Namespace:
    value: str = "session"

    def __repr__(self):
        return self.value


@dataclasses.dataclass(frozen=True, order=True)
class GraphName:
    value: str

    def __repr__(self):
        return self.value


@dataclasses.dataclass(frozen=True, order=True)
class QualifiedGraphName:
    namespace: Namespace
    graph_name: GraphName

    @staticmethod
    def parse(qualified: str) -> "QualifiedGraphName":
        """``"ns.path.to.graph"`` → QGN(ns, path.to.graph); a bare name maps
        to the default ``session`` namespace."""
        if "." in qualified:
            ns, _, rest = qualified.partition(".")
            return QualifiedGraphName(Namespace(ns), GraphName(rest))
        return QualifiedGraphName(Namespace(), GraphName(qualified))

    def __repr__(self):
        return f"{self.namespace!r}.{self.graph_name!r}"


class PropertyGraph(abc.ABC):
    """A queryable property graph."""

    @property
    @abc.abstractmethod
    def schema(self) -> Schema:
        ...

    @abc.abstractmethod
    def cypher(self, query: str, parameters: Optional[Mapping[str, Any]] = None) -> "CypherResult":
        ...

    @abc.abstractmethod
    def nodes(self, var: str = "n", labels: Iterable[str] = ()) -> "CypherRecords":
        """All nodes (optionally restricted by labels) as records of one
        node column."""

    @abc.abstractmethod
    def relationships(self, var: str = "r", rel_types: Iterable[str] = ()) -> "CypherRecords":
        ...

    @abc.abstractmethod
    def union_all(self, *others: "PropertyGraph") -> "PropertyGraph":
        ...

    def statistics(self):
        """Ingest-time statistics sketch (cardinalities, degree
        distributions, skew — ``caps_tpu.relational.stats``) used by
        the cost-based planner; None when the graph keeps none.
        Concrete relational graphs compute it lazily at construction
        time and refresh it across versioned commits."""
        return None


class CypherRecords(abc.ABC):
    """A table of Cypher values — the tabular part of a query result."""

    @property
    @abc.abstractmethod
    def columns(self) -> Tuple[str, ...]:
        ...

    @abc.abstractmethod
    def to_maps(self) -> List[Dict[str, Any]]:
        """Materialize as a list of dicts (entities as CypherNode/
        CypherRelationship).  Multiset semantics: duplicates significant,
        order insignificant unless ORDER BY was used."""

    @abc.abstractmethod
    def size(self) -> int:
        ...

    def show(self, n: int = 20) -> None:
        rows = self.to_maps()[:n]
        cols = list(self.columns)
        widths = {c: max([len(c)] + [len(repr(r.get(c))) for r in rows]) for c in cols}
        line = "│ " + " │ ".join(c.ljust(widths[c]) for c in cols) + " │"
        sep = "╪".join("═" * (widths[c] + 2) for c in cols)
        print(line)
        print("╞" + sep + "╡")
        for r in rows:
            print("│ " + " │ ".join(repr(r.get(c)).ljust(widths[c]) for c in cols) + " │")
        print(f"({self.size()} rows)")


class CypherResult(abc.ABC):
    """The result of ``cypher(...)``: records and/or a constructed graph."""

    @property
    @abc.abstractmethod
    def records(self) -> Optional[CypherRecords]:
        ...

    @property
    @abc.abstractmethod
    def graph(self) -> Optional[PropertyGraph]:
        """The graph produced by ``RETURN GRAPH`` / ``CONSTRUCT``."""

    @abc.abstractmethod
    def explain(self) -> str:
        """Pretty-print the IR / logical / relational plans (the reference's
        ``result.plans`` explain facility; SURVEY.md §5.5)."""


class CypherSession(abc.ABC):
    """A Cypher session: catalog + query entry points."""

    @property
    @abc.abstractmethod
    def catalog(self) -> "PropertyGraphCatalog":
        ...

    @abc.abstractmethod
    def cypher(self, query: str, parameters: Optional[Mapping[str, Any]] = None) -> CypherResult:
        ...


class PropertyGraphCatalog(abc.ABC):
    """Catalog of graphs addressable by qualified name, backed by data
    sources registered per namespace."""

    @abc.abstractmethod
    def graph(self, qualified_name) -> PropertyGraph:
        ...

    @abc.abstractmethod
    def store(self, name, graph: PropertyGraph) -> None:
        ...

    @abc.abstractmethod
    def delete(self, name) -> None:
        ...

    @abc.abstractmethod
    def source(self, namespace: Namespace):
        ...

    @abc.abstractmethod
    def register_source(self, namespace: Namespace, source) -> None:
        ...
