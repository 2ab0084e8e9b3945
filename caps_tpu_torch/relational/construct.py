"""CONSTRUCT / RETURN GRAPH planning (multiple-graph queries).

The counterpart of ``caps_tpu/relational/construct.py``, after the
reference's ``ConstructGraphPlanner`` — CLONE/NEW/SET over the driving
rows, id-space management, result graph = UnionGraph(built, ON graphs)
(ref: okapi-relational/.../impl/graph/ConstructGraphPlanner.scala —
reconstructed, mount empty; SURVEY.md §3.4).

Semantics implemented:
  * ``CONSTRUCT ON g1, g2`` seeds the result with the union of those graphs;
  * ``CLONE a [AS b]`` copies the bound entity (distinct by id) into the
    built graph — skipped when ON graphs are present and no SET touches it
    (the entity is already in the union);
  * ``NEW (x)-[:T]->(y)`` creates entities per driving row; endpoints may
    be bound/cloned vars (their ids) or fresh vars (ids allocated beyond
    every id visible in the inputs);
  * ``SET x.k = expr / SET x:Label`` applies to cloned/new entities.

The build step materializes the driving rows host-side and groups new
entities by label combination / relationship type into scan tables — the
CONSTRUCT path is catalog machinery, not the per-query hot path.  Two
things differ from the reference:

* the property expressions of NEW and SET are evaluated on the device,
  as a column of the driving table through the backend's expression
  compiler (as a projection is), and read once; an expression the
  compiler lacks raises ``UnsupportedOnDevice`` naming it (the reference
  evaluates them on its host backend, which the port does not have);
* the largest id of a graph comes from each id column on the device
  (``Table.max_int``), not from a walk over its values in Python.

The overlay (SET on a cloned entity of an ON graph) copies every entity
of the ON graphs into the build dicts, as the reference does: on the
slice's graph (1,000,000 persons, 10,000,000 relationships) that copy and
the table build each take under a minute on the card's host
(PERF.md §6), so they stay as the reference has them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from caps_tpu_torch.frontend import ast
from caps_tpu_torch.obs import clock
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import CTAny, CTInteger, from_python, join_all
from caps_tpu_torch.relational import ops as R
from caps_tpu_torch.relational.graphs import UnionGraph
from caps_tpu_torch.relational.header import RecordHeader

#: the driving-table column a NEW or SET expression is computed into
_EVAL_COL = "__construct_value"


class ConstructError(Exception):
    pass


class GraphResultOp(R.RelationalOperator):
    """A relational operator whose result is a graph (RETURN GRAPH)."""

    def __init__(self, context, graph):
        super().__init__(context)
        self._graph = graph

    @property
    def result_graph(self):
        return self._graph

    def _compute(self):
        return RecordHeader.empty(), self.context.factory.unit()


class ConstructOp(R.RelationalOperator):
    def __init__(self, context, parent: R.RelationalOperator,
                 on_graphs: Tuple, clones, news, sets, session,
                 working_graph):
        super().__init__(context, [parent])
        self.on_graphs = on_graphs
        self.clones = clones
        self.news = news
        self.sets = sets
        self.session = session
        self.working_graph = working_graph
        self._graph_cache = None

    def _compute(self):
        return RecordHeader.empty(), self.context.factory.unit()

    @property
    def result_graph(self):
        if self._graph_cache is None:
            self._graph_cache = self._build_graph()
        return self._graph_cache

    # ------------------------------------------------------------------

    def _build_graph(self):
        t0 = clock.now()
        parent = self.children[0]
        header, table = parent.result
        # exact: CONSTRUCT mints entity ids per input row — a served
        # upper bound (generic fused replay) would mint phantom entities
        n = table.exact_size()
        params = self.parameters
        t_match = clock.now()

        set_vars = {s.var for s in self.sets}
        clone_specs: Dict[str, E.Expr] = {c.var: c.source for c in self.clones}

        # Vars used as NEW endpoints that are bound in scope become
        # implicit clones.
        bound = set(header.vars)
        for pat in self.news:
            for part in pat.parts:
                for el in part.elements:
                    if isinstance(el, ast.NodePattern) and el.var \
                            and el.var in bound and el.var not in clone_specs:
                        clone_specs[el.var] = E.Var(el.var)

        # SET on a cloned ON-graph entity must *replace* the original, not
        # add a modified twin beside it (UnionGraph ids are disjoint).  In
        # that case the ON graphs are materialized into the build and the
        # union is dropped — overlay semantics.
        overlay = bool(self.on_graphs) and bool(set_vars & set(clone_specs))

        # Materialize what each bound entity var looks like per row.
        def entity_rows(var: str):
            v = E.Var(var)
            ids = table.column_values(header.column(v))
            labels = []
            props = []
            for e in header.exprs:
                if isinstance(e, E.HasLabel) and e.node == v:
                    labels.append((e.label,
                                   table.column_values(header.column(e))))
                elif isinstance(e, E.Property) and e.entity == v:
                    props.append((e.key,
                                  table.column_values(header.column(e))))
            return ids, labels, props

        def rel_rows(var: str):
            v = E.Var(var)
            ids = table.column_values(header.column(v))
            srcs = table.column_values(header.column(E.StartNode(v)))
            tgts = table.column_values(header.column(E.EndNode(v)))
            typs = table.column_values(header.column(E.Type(v)))
            props = []
            for e in header.exprs:
                if isinstance(e, E.Property) and e.entity == v:
                    props.append((e.key,
                                  table.column_values(header.column(e))))
            return ids, srcs, tgts, typs, props

        # Base for freshly-allocated ids: beyond everything visible.
        max_id = 0
        for var in header.entity_vars:
            max_id = max(max_id, _max_int(table, header.column(E.Var(var)))
                         or 0)
        for g in self.on_graphs + ((self.working_graph,)
                                   if self.working_graph else ()):
            max_id = max(max_id, _max_graph_id(g))
        next_id = [max_id + 1]

        def alloc(count: int) -> List[int]:
            base = next_id[0]
            next_id[0] += count
            return list(range(base, base + count))

        # nodes[id] = (set(labels), {key: value}); collected then grouped
        nodes: Dict[int, Tuple[set, Dict[str, Any]]] = {}
        # rels[id] = [src, tgt, type, {key: value}]
        rels: Dict[int, List[Any]] = {}
        # per-row id bindings for construct-scope vars
        row_ids: Dict[str, List[Optional[int]]] = {}

        t_materialize = clock.now()
        if overlay:
            for g in self.on_graphs:
                _materialize_graph_into(nodes, rels, g)
        materialize_s = clock.now() - t_materialize

        from caps_tpu_torch.okapi.types import _CTRelationship
        # 1. clones
        for var, src in clone_specs.items():
            if not isinstance(src, E.Var):
                raise ConstructError("CLONE source must be a variable")
            src_t = header.var_type(src.name).material
            if isinstance(src_t, _CTRelationship):
                ids, srcs, tgts, typs, props = rel_rows(src.name)
                row_ids[var] = ids
                if self.on_graphs and not overlay and var not in set_vars:
                    continue  # entity already present via the ON-union
                for i, rid in enumerate(ids):
                    if rid is None or rid in rels:
                        continue
                    p = {k: col[i] for k, col in props if col[i] is not None}
                    rels[rid] = [srcs[i], tgts[i], typs[i] or "", p]
            else:
                ids, labels, props = entity_rows(src.name)
                row_ids[var] = ids
                if self.on_graphs and not overlay and var not in set_vars:
                    continue  # entity already present via the ON-union
                for i, nid in enumerate(ids):
                    if nid is None or nid in nodes:
                        continue
                    lbls = {l for l, col in labels if col[i] is True}
                    p = {k: col[i] for k, col in props if col[i] is not None}
                    nodes[nid] = (lbls, p)

        def evaluate(expr: E.Expr) -> List[Any]:
            """One expression over the driving rows: a column computed
            on the device, read once."""
            resolved = R.resolve_expr(expr, header)
            return table.with_column(_EVAL_COL, resolved, header, params,
                                     CTAny).column_values(_EVAL_COL)

        # 2. NEW patterns
        def eval_props(props_expr: Optional[E.Expr]) -> List[Dict[str, Any]]:
            if props_expr is None:
                return [{} for _ in range(n)]
            if not isinstance(props_expr, E.MapLit):
                raise ConstructError("NEW properties must be a map literal")
            out: List[Dict[str, Any]] = [dict() for _ in range(n)]
            for key, vexpr in zip(props_expr.keys, props_expr.values):
                col = evaluate(vexpr)
                for i in range(n):
                    if col[i] is not None:
                        out[i][key] = col[i]
            return out

        for pat in self.news:
            for part in pat.parts:
                prev_ids: Optional[List[Optional[int]]] = None
                pending_rel: Optional[ast.RelPattern] = None
                for el in part.elements:
                    if isinstance(el, ast.NodePattern):
                        if el.var and el.var in row_ids:
                            ids = row_ids[el.var]
                            if el.labels or el.properties is not None:
                                props = eval_props(el.properties)
                                for i, nid in enumerate(ids):
                                    if nid is None or nid not in nodes:
                                        continue
                                    nodes[nid][0].update(el.labels)
                                    nodes[nid][1].update(props[i])
                        else:
                            ids = alloc(n)
                            props = eval_props(el.properties)
                            for i, nid in enumerate(ids):
                                nodes[nid] = (set(el.labels), props[i])
                            if el.var:
                                row_ids[el.var] = ids
                        if pending_rel is not None:
                            rel = pending_rel
                            if len(rel.rel_types) != 1:
                                raise ConstructError(
                                    "NEW relationships need exactly one type")
                            rprops = eval_props(rel.properties)
                            rids = alloc(n)
                            if rel.var:
                                row_ids[rel.var] = rids
                            assert prev_ids is not None
                            for i in range(n):
                                a, b = prev_ids[i], ids[i]
                                if a is None or b is None:
                                    continue
                                if rel.direction == ast.Direction.INCOMING:
                                    a, b = b, a
                                rels[rids[i]] = [a, b, rel.rel_types[0],
                                                 rprops[i]]
                            pending_rel = None
                        prev_ids = ids
                    else:
                        pending_rel = el

        # 3. SET items on construct-scope entities
        for item in self.sets:
            if item.var not in row_ids:
                raise ConstructError(
                    f"SET on unknown construct variable `{item.var}`")
            ids = row_ids[item.var]
            if item.labels:
                for nid in ids:
                    if nid is not None and nid in nodes:
                        nodes[nid][0].update(item.labels)
                continue
            if item.key is None or item.value is None:
                raise ConstructError("SET supports `var.key = expr` and labels")
            col = evaluate(item.value)
            for i, eid in enumerate(ids):
                if eid is None or col[i] is None:
                    continue
                if eid in nodes:
                    nodes[eid][1][item.key] = col[i]
                elif eid in rels:
                    rels[eid][3][item.key] = col[i]

        t_entities = clock.now()
        built = _tables_from_entities(self.session, nodes, rels)
        graphs = ((tuple(self.on_graphs) if not overlay else ())
                  + (built,))
        out = built if len(graphs) == 1 else UnionGraph(self.session,
                                                        graphs)
        t_tables = clock.now()
        # where the time went (the driving MATCH, the entity build — of
        # which the overlay's copy of the ON graphs, materialize_s — and
        # the table build) and what was built, for the caller to read
        self.build_stats = {
            "match_s": t_match - t0, "entity_s": t_entities - t_match,
            "materialize_s": materialize_s,
            "table_s": t_tables - t_entities, "rows": n,
            "nodes": len(nodes), "rels": len(rels),
            "minted": next_id[0] - max_id - 1, "overlay": overlay}
        out.construct_stats = self.build_stats
        return out


def _materialize_graph_into(nodes: Dict[int, Tuple[set, Dict[str, Any]]],
                            rels: Dict[int, List[Any]], graph) -> None:
    """Copy a graph's entities into the host-side build dicts (overlay
    path: ON-graph entities get replaced by SET-modified clones in place).
    First writer wins, matching the clone loops' dedup-by-id."""
    for nt in getattr(graph, "node_tables", ()):
        m = nt.mapping
        ids = nt.table.column_values(m.id_col)
        prop_cols = {k: nt.table.column_values(c)
                     for k, c in m.property_cols.items()}
        for i, nid in enumerate(ids):
            if nid is None or nid in nodes:
                continue
            props = {k: col[i] for k, col in prop_cols.items()
                     if col[i] is not None}
            nodes[nid] = (set(m.labels), props)
    for rt in getattr(graph, "rel_tables", ()):
        m = rt.mapping
        ids = rt.table.column_values(m.id_col)
        srcs = rt.table.column_values(m.source_col)
        tgts = rt.table.column_values(m.target_col)
        prop_cols = {k: rt.table.column_values(c)
                     for k, c in m.property_cols.items()}
        for i, rid in enumerate(ids):
            if rid is None or rid in rels:
                continue
            props = {k: col[i] for k, col in prop_cols.items()
                     if col[i] is not None}
            rels[rid] = [srcs[i], tgts[i], m.rel_type, props]
    for sub in getattr(graph, "graphs", ()):
        _materialize_graph_into(nodes, rels, sub)


def _max_graph_id(graph) -> int:
    """The largest node or relationship id of a graph (0 when it has
    none): the largest value of each id column, computed on the device
    (``Table.max_int``, one read per column), members of a union
    included."""
    out = 0
    for et in (tuple(getattr(graph, "node_tables", ()))
               + tuple(getattr(graph, "rel_tables", ()))):
        v = _max_int(et.table, et.mapping.id_col)
        if v is not None and v > out:
            out = v
    for sub in getattr(graph, "graphs", ()):
        out = max(out, _max_graph_id(sub))
    return out


def _max_int(table, col: str):
    """The largest value of an integer column (None when it has none):
    ``Table.max_int`` on a device table; on a host table (a session with
    no device backend, ``backends/local``) the reference's walk over its
    values."""
    max_int = getattr(table, "max_int", None)
    if max_int is not None:
        return max_int(col)
    return max((v for v in table.column_values(col) if v is not None),
               default=None)


def _tables_from_entities(session, nodes, rels):
    """Group host-side entity dicts into scan tables (same shape as the
    testing factory's grouping)."""
    from caps_tpu_torch.relational.entity_tables import (
        NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
    )
    factory = session.table_factory

    by_labels: Dict[Tuple[str, ...], List[Tuple[int, Dict[str, Any]]]] = {}
    for nid, (labels, props) in nodes.items():
        by_labels.setdefault(tuple(sorted(labels)), []).append((nid, props))
    node_tables = []
    for labels, rows in sorted(by_labels.items()):
        keys = sorted({k for _, p in rows for k in p})
        types = {"_id": CTInteger}
        data: Dict[str, List[Any]] = {"_id": [nid for nid, _ in rows]}
        for k in keys:
            vals = [p.get(k) for _, p in rows]
            t = join_all(from_python(v) for v in vals if v is not None)
            if any(v is None for v in vals):
                t = t.nullable
            types[k] = t
            data[k] = vals
        mapping = NodeMapping.on("_id").with_implied_labels(*labels)
        for k in keys:
            mapping = mapping.with_property(k)
        node_tables.append(NodeTable(mapping, factory.from_columns(data, types)))

    by_type: Dict[str, List[Tuple[int, int, int, Dict[str, Any]]]] = {}
    for rid, (src, tgt, rel_type, props) in rels.items():
        by_type.setdefault(rel_type, []).append((rid, src, tgt, props))
    rel_tables = []
    for rel_type, rows in sorted(by_type.items()):
        keys = sorted({k for *_, p in rows for k in p})
        types = {"_id": CTInteger, "_src": CTInteger, "_tgt": CTInteger}
        data = {"_id": [r[0] for r in rows], "_src": [r[1] for r in rows],
                "_tgt": [r[2] for r in rows]}
        for k in keys:
            vals = [r[3].get(k) for r in rows]
            t = join_all(from_python(v) for v in vals if v is not None)
            if any(v is None for v in vals):
                t = t.nullable
            types[k] = t
            data[k] = vals
        mapping = RelationshipMapping.on(rel_type)
        for k in keys:
            mapping = mapping.with_property(k)
        rel_tables.append(
            RelationshipTable(mapping, factory.from_columns(data, types)))
    return session.create_graph(node_tables, rel_tables)


def plan_construct(planner, op):
    """Entry from the relational planner for ConstructGraph / ReturnGraph."""
    from caps_tpu_torch.logical import ops as L
    if isinstance(op, L.ReturnGraph):
        planned = planner.plan_op(op.parent)
        if isinstance(planned, (ConstructOp, GraphResultOp)):
            return planned
        # plain `FROM GRAPH g RETURN GRAPH`
        return GraphResultOp(planner.context, planner.current_graph)
    assert isinstance(op, L.ConstructGraph)
    parent = planner.plan_op(op.parent)
    resolved_on = tuple(planner.graph_resolver(qgn) for qgn in op.on_graphs) \
        if planner.graph_resolver else ()
    session = planner.context.session
    return ConstructOp(planner.context, parent, resolved_on, op.clones,
                       op.news, op.sets, session, planner.current_graph)
