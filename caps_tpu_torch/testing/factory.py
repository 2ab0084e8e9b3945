"""CREATE-string graph factory.

Mirrors the reference's ``CreateGraphFactory``/``CypherCreateParser`` +
``CAPSScanGraphFactory`` (ref: okapi-testing and spark-cypher-testing;
SURVEY.md §3.5): parse a ``CREATE`` pattern
through the engine's own front-end, build an in-memory property graph,
group nodes by label-set and relationships by type into scan tables.

This is how every acceptance test bootstraps its graph:

    g = create_graph(session, "CREATE (a:Person {name:'Alice'})-[:KNOWS]->(b)")
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from caps_tpu_torch.frontend import ast
from caps_tpu_torch.frontend.parser import parse_query
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.relational.entity_tables import (
    NodeTable, RelationshipTable,
)
from caps_tpu_torch.relational.graphs import ScanGraph
# the record-grouping builders the delta store and compaction use, so
# the factory, the write path and compaction agree on layout
from caps_tpu_torch.relational.updates import (  # noqa: F401
    build_node_tables, build_rel_tables,
)


class GraphFactoryError(Exception):
    pass


def _eval_literal(expr: E.Expr, params: Mapping[str, Any]) -> Any:
    if isinstance(expr, E.Lit):
        return expr.value
    if isinstance(expr, E.Param):
        return params[expr.name]
    if isinstance(expr, E.Negate):
        return -_eval_literal(expr.expr, params)
    if isinstance(expr, E.ListLit):
        return [_eval_literal(i, params) for i in expr.items]
    if isinstance(expr, E.MapLit):
        return {k: _eval_literal(v, params)
                for k, v in zip(expr.keys, expr.values)}
    if isinstance(expr, E.FunctionExpr) \
            and expr.name in ("date", "datetime", "localdatetime",
                              "duration"):
        from caps_tpu_torch.okapi.values import temporal_construct
        try:
            return temporal_construct(
                expr.name, *[_eval_literal(a, params) for a in expr.args])
        except (ValueError, TypeError) as ex:
            raise GraphFactoryError(str(ex))
    raise GraphFactoryError(
        f"CREATE properties must be literals, got {expr!r}")


class InMemoryTestGraph:
    """Plain node/rel records before table grouping (the reference's
    ``InMemoryTestGraph``)."""

    def __init__(self):
        self.nodes: Dict[int, Tuple[Tuple[str, ...], Dict[str, Any]]] = {}
        self.rels: List[Tuple[int, int, int, str, Dict[str, Any]]] = []
        self._next_id = 0

    def add_node(self, labels: Tuple[str, ...], props: Dict[str, Any]) -> int:
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = (tuple(sorted(labels)), props)
        return nid

    def add_rel(self, src: int, tgt: int, rel_type: str,
                props: Dict[str, Any]) -> int:
        rid = self._next_id
        self._next_id += 1
        self.rels.append((rid, src, tgt, rel_type, props))
        return rid


def parse_create(create_query: str,
                 parameters: Optional[Mapping[str, Any]] = None
                 ) -> InMemoryTestGraph:
    """Parse one-or-more CREATE clauses into an in-memory graph."""
    params = dict(parameters or {})
    stmt = parse_query(create_query)
    if not isinstance(stmt, ast.SingleQuery):
        raise GraphFactoryError("factory expects a plain CREATE statement")
    g = InMemoryTestGraph()
    env: Dict[str, int] = {}
    for clause in stmt.clauses:
        if isinstance(clause, ast.UnwindClause):
            raise GraphFactoryError("UNWIND is not supported in the factory")
        if not isinstance(clause, ast.CreateClause):
            raise GraphFactoryError(
                f"factory only supports CREATE clauses, got "
                f"{type(clause).__name__}")
        for part in clause.pattern.parts:
            prev: Optional[int] = None
            pending_rel: Optional[ast.RelPattern] = None
            for el in part.elements:
                if isinstance(el, ast.NodePattern):
                    if el.var is not None and el.var in env:
                        if el.labels or el.properties is not None:
                            raise GraphFactoryError(
                                f"variable `{el.var}` already declared; "
                                "reference it without labels/properties")
                        nid = env[el.var]
                    else:
                        props = {}
                        if el.properties is not None:
                            props = _eval_literal(el.properties, params)
                        nid = g.add_node(el.labels, props)
                        if el.var is not None:
                            env[el.var] = nid
                    if pending_rel is not None:
                        rel = pending_rel
                        props = {}
                        if rel.properties is not None:
                            props = _eval_literal(rel.properties, params)
                        if len(rel.rel_types) != 1:
                            raise GraphFactoryError(
                                "CREATE relationships need exactly one type")
                        if rel.direction == ast.Direction.INCOMING:
                            g.add_rel(nid, prev, rel.rel_types[0], props)
                        elif rel.direction == ast.Direction.OUTGOING:
                            g.add_rel(prev, nid, rel.rel_types[0], props)
                        else:
                            raise GraphFactoryError(
                                "CREATE relationships must be directed")
                        pending_rel = None
                    prev = nid
                else:
                    pending_rel = el
    return g


def tables_from_memory(session, g: InMemoryTestGraph
                       ) -> Tuple[List[NodeTable], List[RelationshipTable]]:
    """Group in-memory records into scan tables (the builders of
    relational/updates.py)."""
    factory = session.table_factory
    node_tables = build_node_tables(
        factory, [(nid, labels, props)
                  for nid, (labels, props) in g.nodes.items()])
    rel_tables = build_rel_tables(factory, g.rels)
    return node_tables, rel_tables


def create_graph(session, create_query: str = "",
                 parameters: Optional[Mapping[str, Any]] = None) -> ScanGraph:
    """Build a ScanGraph from a CREATE statement (empty string → empty graph)."""
    if not create_query.strip():
        return session.create_graph((), ())
    g = parse_create(create_query, parameters)
    node_tables, rel_tables = tables_from_memory(session, g)
    return session.create_graph(node_tables, rel_tables)
