"""IR → logical plan.

Mirrors the reference's ``LogicalPlanner``/``LogicalOperatorProducer``:
blocks are solved into an operator tree; pattern connections are solved
incrementally from already-bound fields (the reference's
``SolvedQueryModel``), choosing node scans for fresh components and
expands for connections with a solved endpoint (ref:
okapi-logical/.../logical/impl/LogicalPlanner.scala — reconstructed,
mount empty; SURVEY.md §2, §3.1).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional as Opt, Tuple

from caps_tpu_torch.ir import blocks as B
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Connection, Direction, Pattern
from caps_tpu_torch.ir.typer import SchemaTyper
from caps_tpu_torch.logical import ops as L
from caps_tpu_torch.okapi.graph import QualifiedGraphName
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    CTAny, CTBoolean, CTList, CTNode, CTRelationship, CypherType, _CTList,
    _CTNode, _CTRelationship,
)


class LogicalPlanningError(Exception):
    pass


SchemaResolver = Callable[[QualifiedGraphName], Schema]


class LogicalPlanner:
    def __init__(self, ambient_schema: Schema,
                 schema_resolver: Opt[SchemaResolver] = None,
                 parameters: Opt[Mapping[str, object]] = None):
        self.ambient_schema = ambient_schema
        self.schema_resolver = schema_resolver
        # kept as-is (not copied): a PlanParams view must keep recording
        # plan-time value reads for the plan cache (relational/plan_cache)
        self.parameters: Mapping[str, object] = \
            parameters if parameters is not None else {}

    def process(self, stmt: B.CypherStatement) -> L.LogicalPlan:
        if isinstance(stmt, B.CypherQuery):
            return self._plan_query(stmt)
        if isinstance(stmt, B.UnionOfQueries):
            plans = [self._plan_query(q) for q in stmt.queries]
            result_fields = plans[0].result_fields
            root = plans[0].root
            for p in plans[1:]:
                if p.result_fields != result_fields:
                    raise LogicalPlanningError(
                        f"UNION column mismatch: {result_fields} vs {p.result_fields}")
                root = L.TabularUnionAll(root, p.root, fields=root.fields)
            if not stmt.union_all:
                root = L.Distinct(root, fields=root.fields)
            return L.LogicalPlan(root, result_fields)
        raise LogicalPlanningError(f"cannot plan {type(stmt).__name__}")

    # ------------------------------------------------------------------

    def _plan_query(self, q: B.CypherQuery) -> L.LogicalPlan:
        state = _QueryPlanner(self)
        op: L.LogicalOperator = L.Start(None, fields=())
        returns_graph = False
        for block in q.blocks:
            op = state.plan_block(op, block)
            if isinstance(block, B.ReturnGraphBlock):
                returns_graph = True
        result_fields = q.result_fields
        return L.LogicalPlan(op, result_fields, returns_graph)


def _top_exists(expr: E.Expr) -> List[E.ExistsSubQuery]:
    """Top-level ExistsSubQuery nodes of ``expr`` — does NOT descend into a
    subquery's own predicates (those lower inside its rhs)."""
    out: List[E.ExistsSubQuery] = []

    def go(n):
        if isinstance(n, E.ExistsSubQuery):
            out.append(n)
            return
        for c in n.children:
            go(c)

    go(expr)
    return out


def _replace_exists(expr: E.Expr, mapping: Mapping[E.Expr, E.Expr]) -> E.Expr:
    """Replace top-level ExistsSubQuery nodes wholesale (no descent into a
    replaced node, so a structurally-equal nested subquery inside another
    subquery's predicates is left alone)."""
    if isinstance(expr, E.ExistsSubQuery):
        return mapping[expr]
    return expr.map_children(
        lambda c: _replace_exists(c, mapping) if isinstance(c, E.Expr) else c)


def _rel_types_of(ct: CypherType) -> frozenset:
    """Declared rel types of a rel var (CTRelationship) or var-length rel
    var (CTList(CTRelationship))."""
    m = ct.material
    if isinstance(m, _CTList):
        m = m.inner.material
    return m.rel_types if isinstance(m, _CTRelationship) else frozenset()


class _QueryPlanner:
    def __init__(self, parent: LogicalPlanner):
        self.parent = parent
        self.schema = parent.ambient_schema
        self.typer = SchemaTyper(self.schema, parent.parameters)
        self.current_graph: Opt[QualifiedGraphName] = None
        self._marker_count = 0

    # -- helpers ------------------------------------------------------------

    def type_of(self, expr: E.Expr, env: Mapping[str, CypherType]) -> CypherType:
        return self.typer.type_of(expr, env)

    # -- block dispatch -----------------------------------------------------

    def plan_block(self, op: L.LogicalOperator, block: B.Block) -> L.LogicalOperator:
        if isinstance(block, B.MatchBlock):
            return self._plan_match(op, block)
        if isinstance(block, B.ProjectBlock):
            return self._plan_project(op, block)
        if isinstance(block, B.AggregationBlock):
            return self._plan_aggregation(op, block)
        if isinstance(block, B.FilterBlock):
            names = op.field_names
            out, pred = self._rewrite_exists(op, block.predicate)
            out = L.Filter(out, pred, fields=out.fields)
            if out.field_names != names:
                out = self._select(out, names)  # drop EXISTS markers
            return out
        if isinstance(block, B.OrderAndSliceBlock):
            out = op
            if block.order:
                names = out.field_names
                items = []
                for expr, asc in block.order:
                    out, expr = self._rewrite_exists(out, expr)
                    items.append((expr, asc))
                out = L.OrderBy(out, tuple(items), fields=out.fields)
                if out.field_names != names:
                    out = self._select(out, names)  # drop EXISTS markers
            if block.skip is not None:
                out = L.Skip(out, block.skip, fields=out.fields)
            if block.limit is not None:
                out = L.Limit(out, block.limit, fields=out.fields)
            return out
        if isinstance(block, B.SelectBlock):
            return self._select(op, block.fields)
        if isinstance(block, B.UnwindBlock):
            t = self.type_of(block.list_expr, op.env)
            inner = t.material.inner if isinstance(t.material, _CTList) else CTAny
            if isinstance(inner.material, (_CTNode, _CTRelationship)):
                # Entity lists hold ids in columnar form; rehydrate the
                # unwound var by left-joining back to a full entity scan so
                # labels/properties are accessible (left: UNWIND of a list
                # containing null keeps the null row, openCypher).
                self._marker_count += 1
                tmp = f"__unwind_id_{self._marker_count}"
                out = L.Unwind(op, block.list_expr, tmp,
                               fields=op.fields + ((tmp, CTAny),))
                if isinstance(inner.material, _CTNode):
                    ent_t: CypherType = CTNode(inner.material.labels).nullable
                    scan: L.LogicalOperator = L.NodeScan(
                        L.Start(self.current_graph, fields=()), block.var,
                        inner.material.labels, fields=((block.var, ent_t),))
                else:
                    ent_t = CTRelationship(inner.material.rel_types).nullable
                    scan = L.RelScan(
                        L.Start(self.current_graph, fields=()), block.var,
                        inner.material.rel_types, fields=((block.var, ent_t),))
                out = L.ValueJoin(
                    out, scan, (E.Equals(E.Var(tmp), E.Var(block.var)),),
                    join_type="left",
                    fields=out.fields + ((block.var, ent_t),))
                return self._select(out, op.field_names + (block.var,))
            return L.Unwind(op, block.list_expr, block.var,
                            fields=op.fields + ((block.var, inner),))
        if isinstance(block, B.FromGraphBlock):
            if self.parent.schema_resolver is not None:
                self.schema = self.parent.schema_resolver(block.qgn)
                self.typer = SchemaTyper(self.schema, self.parent.parameters)
            self.current_graph = block.qgn
            return L.FromGraph(op, block.qgn, fields=op.fields)
        if isinstance(block, B.ConstructBlock):
            return L.ConstructGraph(op, block.on_graphs, block.clones,
                                    block.news, block.sets, fields=())
        if isinstance(block, B.ReturnGraphBlock):
            return L.ReturnGraph(op, fields=())
        if isinstance(block, B.CallBlock):
            return self._plan_call(op, block)
        if isinstance(block, B.ResultBlock):
            return self._select(op, block.fields)
        raise LogicalPlanningError(f"cannot plan block {type(block).__name__}")

    def _plan_call(self, op: L.LogicalOperator, block: B.CallBlock
                   ) -> L.LogicalOperator:
        """CALL composes like a scan of a fresh component: chained onto
        an empty-row upstream, cross-producted onto populated rows (one
        output row per (input row, yielded row) pair)."""
        from caps_tpu_torch.algo import registry
        sig = registry.lookup(block.procedure)
        new_fields = tuple((out, sig.yield_type(y))
                           for y, out in block.yields)
        if not op.fields:
            return L.ProcedureCall(op, block.procedure, block.args,
                                   block.yields, fields=new_fields)
        call = L.ProcedureCall(L.Start(self.current_graph, fields=()),
                               block.procedure, block.args, block.yields,
                               fields=new_fields)
        return L.CartesianProduct(op, call, fields=op.fields + call.fields)

    def _select(self, op: L.LogicalOperator, names: Tuple[str, ...]) -> L.LogicalOperator:
        env = op.env
        missing = [n for n in names if n not in env]
        if missing:
            raise LogicalPlanningError(f"cannot select missing fields {missing}")
        if op.field_names == tuple(names):
            return op  # already exactly this shape
        if isinstance(op, L.Select):
            # Select(Select(p, wider), names) == Select(p, names)
            op = op.parent
        return L.Select(op, tuple(names), fields=tuple((n, env[n]) for n in names))

    # -- projection / aggregation ------------------------------------------

    def _plan_project(self, op: L.LogicalOperator, block: B.ProjectBlock
                      ) -> L.LogicalOperator:
        new_items = []
        for name, expr in block.items:
            if isinstance(expr, E.Var) and expr.name == name:
                continue  # passthrough
            op, expr = self._rewrite_exists(op, expr)
            new_items.append((name, expr))
        env = op.env
        out = op
        if new_items:
            added = tuple((n, self.type_of(x, env)) for n, x in new_items)
            kept = tuple((n, t) for n, t in op.fields
                         if n not in {a for a, _ in new_items})
            out = L.Project(out, tuple(new_items), fields=kept + added)
        out = self._select(out, tuple(n for n, _ in block.items))
        if block.distinct:
            out = L.Distinct(out, fields=out.fields)
        return out

    def _plan_aggregation(self, op: L.LogicalOperator, block: B.AggregationBlock
                          ) -> L.LogicalOperator:
        group = []
        for n, x in block.group:
            op, x = self._rewrite_exists(op, x)
            group.append((n, x))
        aggs = []
        for n, a in block.aggregations:
            op, a = self._rewrite_exists(op, a)
            aggs.append((n, a))
        env = op.env
        fields = tuple((n, self.type_of(x, env)) for n, x in group) + \
            tuple((n, self.type_of(a, env)) for n, a in aggs)
        return L.Aggregate(op, tuple(group), tuple(aggs), fields=fields)

    # -- MATCH pattern solving ---------------------------------------------

    def _plan_match(self, op: L.LogicalOperator, block: B.MatchBlock
                    ) -> L.LogicalOperator:
        lhs = op
        rhs = self._plan_pattern(op, block.pattern)
        base_names = rhs.field_names
        for pred in block.predicates:
            rhs, pred = self._rewrite_exists(rhs, pred)
            rhs = L.Filter(rhs, pred, fields=rhs.fields)
        if block.optional:
            # A leading OPTIONAL MATCH left-joins against the single unit
            # driving row: no match yields one all-null row (openCypher).
            out = L.Optional(lhs, rhs, fields=rhs.fields)
        else:
            out = rhs
        if out.field_names != base_names:
            # EXISTS markers linger inside the (possibly Optional) branch —
            # a Select inside an Optional rhs would break its row-id wiring,
            # so they are dropped here, outside it.
            out = self._select(out, base_names)
        return out

    # -- EXISTS subqueries ---------------------------------------------------

    def _rewrite_exists(self, op: L.LogicalOperator, expr: E.Expr
                        ) -> Tuple[L.LogicalOperator, E.Expr]:
        """Lower every top-level ExistsSubQuery in ``expr`` to a row-id
        semi-join (L.ExistsSemiJoin) producing a nullable marker field, and
        substitute ``IS NOT NULL(marker)`` for the subquery node."""
        subqueries = _top_exists(expr)
        if not subqueries:
            return op, expr
        mapping: Dict[E.Expr, E.Expr] = {}
        for sq in subqueries:
            if sq in mapping:
                continue
            marker = f"__exists_{self._marker_count}"
            self._marker_count += 1
            rhs = self._plan_pattern(op, sq.pattern)
            for p in sq.predicates:
                rhs, p = self._rewrite_exists(rhs, p)  # nested EXISTS
                rhs = L.Filter(rhs, p, fields=rhs.fields)
            rhs = L.Project(rhs, ((marker, E.Lit(True)),),
                            fields=rhs.fields + ((marker, CTBoolean),))
            op = L.ExistsSemiJoin(
                op, rhs, marker,
                fields=op.fields + ((marker, CTBoolean.nullable),))
            mapping[sq] = E.IsNotNull(E.Var(marker))
        return op, _replace_exists(expr, mapping)

    def _plan_pattern(self, op: L.LogicalOperator, pattern: Pattern
                      ) -> L.LogicalOperator:
        declared: Dict[str, CypherType] = {f.name: f.cypher_type
                                           for f in pattern.entities}
        solved = set(op.field_names)
        pending = list(pattern.connections)
        # Rel vars newly bound by THIS pattern: Cypher edge isomorphism
        # requires pairwise-distinct relationships per MATCH.  VarExpand
        # dedups hops within its own path only; cross-connection pairs get
        # explicit uniqueness filters below.
        fixed_rels: List[str] = [
            c.rel for c in pending
            if not c.is_var_length and c.rel not in solved]
        var_rels: List[str] = [
            c.rel for c in pending
            if c.is_var_length and c.rel not in solved]
        # Node entities that must be scanned (not produced by an expansion)
        node_vars = [f.name for f in pattern.entities
                     if isinstance(f.cypher_type.material, _CTNode)]
        unsolved_nodes = [v for v in node_vars if v not in solved]

        def scan(var: str) -> L.LogicalOperator:
            labels = declared[var].material.labels
            if not op.fields:
                # Chain directly onto the (empty-row) upstream operator.
                return L.NodeScan(op, var, labels,
                                  fields=((var, CTNode(labels)),))
            node = L.NodeScan(L.Start(self.current_graph, fields=()), var,
                              labels, fields=((var, CTNode(labels)),))
            return L.CartesianProduct(op, node, fields=op.fields + node.fields)

        while pending or unsolved_nodes:
            made_progress = False
            for conn in list(pending):
                src_ok = conn.source in solved
                tgt_ok = conn.target in solved
                if not (src_ok or tgt_ok):
                    continue
                pending.remove(conn)
                made_progress = True
                if src_ok:
                    from_var, to_var = conn.source, conn.target
                    direction = conn.direction
                else:
                    from_var, to_var = conn.target, conn.source
                    direction = (Direction.INCOMING
                                 if conn.direction == Direction.OUTGOING
                                 else conn.direction)
                into = to_var in solved
                target_labels = (declared.get(to_var) or CTNode()).material.labels \
                    if not into else frozenset()
                rel_type = declared[conn.rel]
                new_fields = list(op.fields)
                new_fields.append((conn.rel, rel_type))
                if not into:
                    new_fields.append((to_var, CTNode(target_labels)))
                if conn.is_var_length:
                    lower, upper = conn.var_length
                    op = L.BoundedVarLengthExpand(
                        op, from_var, conn.rel, conn.rel_types, to_var,
                        target_labels, direction, lower, upper, into,
                        fields=tuple(new_fields))
                else:
                    op = L.Expand(
                        op, from_var, conn.rel, conn.rel_types, to_var,
                        target_labels, direction, into,
                        fields=tuple(new_fields))
                solved.add(conn.rel)
                solved.add(to_var)
                if to_var in unsolved_nodes:
                    unsolved_nodes.remove(to_var)
            if made_progress:
                continue
            # No connection touches a solved var: scan a fresh component.
            if unsolved_nodes:
                # Prefer a node that participates in a pending connection.
                conn_vars = {c.source for c in pending} | {c.target for c in pending}
                pick = next((v for v in unsolved_nodes if v in conn_vars),
                            unsolved_nodes[0])
                unsolved_nodes.remove(pick)
                op = scan(pick)
                solved.add(pick)
            else:
                raise LogicalPlanningError(
                    f"cannot solve pattern: connections {pending} reference "
                    "no bound or scannable variable")
        # Edge-isomorphism filters for rel pairs whose declared type sets
        # could overlap (disjoint non-empty sets can never collide):
        #   fixed-fixed: id(r1) <> id(r2)
        #   fixed-var:   NOT id(r1) IN r_var   (var rel binds a rel list)
        #   var-var:     DISJOINT(r1, r2)      (planner-internal expr)
        def could_overlap(r1: str, r2: str) -> bool:
            t1 = _rel_types_of(declared[r1])
            t2 = _rel_types_of(declared[r2])
            return not (t1 and t2 and not (set(t1) & set(t2)))

        for i, r1 in enumerate(fixed_rels):
            for r2 in fixed_rels[i + 1:]:
                if could_overlap(r1, r2):
                    pred = E.Not(E.Equals(E.Id(E.Var(r1)), E.Id(E.Var(r2))))
                    op = L.Filter(op, pred, fields=op.fields)
        for rf in fixed_rels:
            for rv in var_rels:
                if could_overlap(rf, rv):
                    pred = E.Not(E.In(E.Id(E.Var(rf)), E.Var(rv)))
                    op = L.Filter(op, pred, fields=op.fields)
        for i, r1 in enumerate(var_rels):
            for r2 in var_rels[i + 1:]:
                if could_overlap(r1, r2):
                    op = L.Filter(op, E.Disjoint(E.Var(r1), E.Var(r2)),
                                  fields=op.fields)
        return op
