"""Concrete catalog: namespaces → data sources, with the default in-memory
``session`` namespace.

Mirrors the reference's ``CypherCatalog`` + ``SessionGraphDataSource``
(ref: okapi-api/.../api/graph/CypherCatalog.scala and
spark-cypher/.../impl/io/SessionGraphDataSource.scala — reconstructed,
mount empty; SURVEY.md §2, §3.3).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from caps_tpu_torch.obs.lockgraph import make_rlock
from caps_tpu_torch.okapi.graph import (
    GraphName, Namespace, PropertyGraph, PropertyGraphCatalog, QualifiedGraphName,
)
from caps_tpu_torch.okapi.io import PropertyGraphDataSource

NameLike = Union[str, GraphName, QualifiedGraphName]


def _qualify(name: NameLike) -> QualifiedGraphName:
    if isinstance(name, QualifiedGraphName):
        return name
    if isinstance(name, GraphName):
        return QualifiedGraphName(Namespace(), name)
    return QualifiedGraphName.parse(name)


class SessionGraphDataSource(PropertyGraphDataSource):
    """The default in-memory source behind the ``session`` namespace."""

    def __init__(self):
        self._graphs: Dict[GraphName, PropertyGraph] = {}

    def has_graph(self, name: GraphName) -> bool:
        return name in self._graphs

    def graph(self, name: GraphName) -> PropertyGraph:
        if name not in self._graphs:
            raise KeyError(f"graph {name!r} not found in session catalog")
        return self._graphs[name]

    def store(self, name: GraphName, graph: PropertyGraph) -> None:
        self._graphs[name] = graph

    def delete(self, name: GraphName) -> None:
        self._graphs.pop(name, None)

    def graph_names(self) -> Tuple[GraphName, ...]:
        return tuple(self._graphs.keys())


class CypherCatalog(PropertyGraphCatalog):
    def __init__(self):
        self._sources: Dict[Namespace, PropertyGraphDataSource] = {
            Namespace(): SessionGraphDataSource()
        }
        # bumped on every mutation (observability / coarse fingerprint)
        self.version = 0
        # scoped dependency tokens (relational/plan_cache.py): one
        # counter per qualified name, plus one per namespace for
        # register/deregister — a mutation invalidates exactly the
        # mutated name's dependents, never the whole plan cache
        self._name_versions: Dict[QualifiedGraphName, int] = {}
        self._ns_epochs: Dict[Namespace, int] = {}
        self._listeners: list = []
        # Serializes mutations: store/delete + the version bump + the
        # subscription fan-out (plan-cache eviction) must be atomic, or
        # two serving threads interleaving mutations could leave the
        # token bumped with stale entries still cached.  Reentrant
        # because a listener may legitimately read the catalog back.
        self._lock = make_rlock("catalog.CypherCatalog._lock")

    def subscribe(self, fn) -> None:
        """Register a callback invoked as ``fn(version, qgn)`` after
        every catalog mutation — ``qgn`` is the mutated qualified name,
        or None for a namespace-level change (register/deregister).
        The session plan cache evicts the mutated name's dependents
        through this (scoped — unrelated graphs' plans survive)."""
        with self._lock:
            self._listeners.append(fn)

    def dep_token(self, name: NameLike) -> Tuple[int, int]:
        """The scoped consistency token a cached plan records per
        resolved catalog graph: (namespace epoch, per-name version).
        Any mutation of the name — or of its namespace's source set —
        changes the token, and lookup revalidation drops the plan.

        Deliberately LOCK-FREE: the plan cache validates tokens while
        holding its own lock, and catalog mutations fan out INTO the
        plan cache while holding this one — taking the catalog lock
        here would close a lock-order cycle (the runtime lock graph
        caught exactly that).  The two dict reads are each atomic under
        the GIL and only ever mutated under the catalog lock; a lookup
        that races a mutation reads the pre-mutation token, which is
        indistinguishable from the lookup having happened just before
        the mutation — and the mutation's eager eviction fan-out drops
        the entry right after."""
        qgn = _qualify(name)
        return (self._ns_epochs.get(qgn.namespace, 0),
                self._name_versions.get(qgn, 0))

    def _bump(self, qgn: Optional[QualifiedGraphName] = None) -> None:
        self.version += 1
        if qgn is not None:
            self._name_versions[qgn] = self._name_versions.get(qgn, 0) + 1
        for fn in list(self._listeners):
            fn(self.version, qgn)

    @property
    def session_namespace(self) -> Namespace:
        return Namespace()

    def register_source(self, namespace: Namespace, source: PropertyGraphDataSource) -> None:
        if isinstance(namespace, str):
            namespace = Namespace(namespace)
        with self._lock:
            if namespace in self._sources:
                raise ValueError(f"namespace {namespace!r} already registered")
            self._sources[namespace] = source
            self._ns_epochs[namespace] = \
                self._ns_epochs.get(namespace, 0) + 1
            self._bump()

    def deregister_source(self, namespace: Namespace) -> None:
        if isinstance(namespace, str):
            namespace = Namespace(namespace)
        if namespace == Namespace():
            raise ValueError("cannot deregister the session namespace")
        with self._lock:
            if self._sources.pop(namespace, None) is not None:
                # resolvable graphs changed: every name in the namespace
                # is stale — the epoch bump flips all their dep tokens
                self._ns_epochs[namespace] = \
                    self._ns_epochs.get(namespace, 0) + 1
                self._bump()

    def source(self, namespace: Namespace) -> PropertyGraphDataSource:
        if isinstance(namespace, str):
            namespace = Namespace(namespace)
        if namespace not in self._sources:
            raise KeyError(f"no data source registered for namespace {namespace!r}")
        return self._sources[namespace]

    @property
    def namespaces(self) -> Tuple[Namespace, ...]:
        return tuple(self._sources.keys())

    def has_graph(self, name: NameLike) -> bool:
        qgn = _qualify(name)
        try:
            return self.source(qgn.namespace).has_graph(qgn.graph_name)
        except KeyError:
            return False

    def graph(self, name: NameLike) -> PropertyGraph:
        qgn = _qualify(name)
        return self.source(qgn.namespace).graph(qgn.graph_name)

    def store(self, name: NameLike, graph: PropertyGraph) -> None:
        qgn = _qualify(name)
        with self._lock:
            self.source(qgn.namespace).store(qgn.graph_name, graph)
            self._bump(qgn)

    def delete(self, name: NameLike) -> None:
        qgn = _qualify(name)
        with self._lock:
            self.source(qgn.namespace).delete(qgn.graph_name)
            self._bump(qgn)

    def graph_names(self) -> Tuple[QualifiedGraphName, ...]:
        out = []
        for ns, src in self._sources.items():
            out.extend(QualifiedGraphName(ns, gn) for gn in src.graph_names())
        return tuple(out)
