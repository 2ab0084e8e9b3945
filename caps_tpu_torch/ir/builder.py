"""AST → IR: clause chains to query blocks.

Mirrors the reference's ``IRBuilder`` — AST clauses → Blocks, patterns →
``Pattern`` + ``Connection``s, expressions typed via ``SchemaTyper``,
graph references resolved via the catalog (ref: okapi-ir/.../ir/impl/
IRBuilder.scala — reconstructed, mount empty; SURVEY.md §2 "IR", §3.1).

Normalizations performed here:
  * inline pattern property maps → equality predicates;
  * labels on already-bound vars → HasLabel predicates;
  * undirected/incoming pattern hops → OUTGOING or BOTH connections
    (incoming is flipped);
  * aggregating projection items → AggregationBlock (+ post-ProjectBlock
    when aggregators sit inside larger expressions);
  * ORDER BY over pre-projection scope → hidden helper fields.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from caps_tpu_torch.frontend import ast
from caps_tpu_torch.frontend.semantic import CypherSemanticError, check_statement
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.blocks import (
    AggregationBlock, Block, CallBlock, ConstructBlock, CreateGraphStatement,
    CypherQuery, CypherStatement, DropGraphStatement, FilterBlock,
    FromGraphBlock, MatchBlock, OrderAndSliceBlock, ProjectBlock, ResultBlock,
    ReturnGraphBlock, SelectBlock, UnionOfQueries, UnwindBlock,
)
from caps_tpu_torch.ir.pattern import Connection, Direction, IRField, Pattern
from caps_tpu_torch.ir.typer import SchemaTyper
from caps_tpu_torch.okapi.graph import QualifiedGraphName
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    CTAny, CTList, CTNode, CTPath, CTRelationship, CypherType, _CTList,
)

SchemaResolver = Callable[[QualifiedGraphName], Schema]


class IRBuildError(Exception):
    pass


_DIRECTION = {
    ast.Direction.OUTGOING: Direction.OUTGOING,
    ast.Direction.INCOMING: Direction.INCOMING,
    ast.Direction.BOTH: Direction.BOTH,
}


class IRBuilder:
    def __init__(self, ambient_schema: Schema,
                 schema_resolver: Optional[SchemaResolver] = None,
                 parameters: Optional[Mapping[str, object]] = None):
        self.ambient_schema = ambient_schema
        self.schema_resolver = schema_resolver
        # kept as-is (not copied): a PlanParams view must keep recording
        # plan-time value reads for the plan cache (relational/plan_cache)
        self.parameters: Mapping[str, object] = \
            parameters if parameters is not None else {}

    # -- entry --------------------------------------------------------------

    def process(self, stmt: ast.Statement) -> CypherStatement:
        check_statement(stmt)
        if isinstance(stmt, ast.SingleQuery):
            return self._build_single(stmt)
        if isinstance(stmt, ast.UnionQuery):
            return UnionOfQueries(
                tuple(self._build_single(q) for q in stmt.queries),
                union_all=stmt.union_all)
        if isinstance(stmt, ast.CatalogCreateGraph):
            return CreateGraphStatement(
                QualifiedGraphName.parse(stmt.qualified_name),
                self.process(stmt.inner))
        if isinstance(stmt, ast.CatalogDropGraph):
            return DropGraphStatement(QualifiedGraphName.parse(stmt.qualified_name))
        raise IRBuildError(f"unsupported statement {type(stmt).__name__}")

    # -- single query -------------------------------------------------------

    def _build_single(self, q: ast.SingleQuery) -> CypherQuery:
        b = _SingleQueryBuilder(self)
        for clause in q.clauses:
            b.add_clause(clause)
        if q.clauses and isinstance(q.clauses[-1], ast.CallClause):
            # standalone trailing CALL: its YIELD columns are the result
            # (a WHERE after YIELD appends a FilterBlock — look past it)
            call = next(blk for blk in reversed(b.blocks)
                        if isinstance(blk, CallBlock))
            b.blocks.append(ResultBlock(tuple(o for _, o in call.yields)))
        return CypherQuery(tuple(b.blocks))


@dataclasses.dataclass(frozen=True)
class _PathDef:
    """Scope record for a named path: constituent vars while the defining
    MATCH's bindings are live (``projected=False``), or just the segment
    shape once the path has been reified through a WITH/RETURN
    (``projected=True`` — reads then resolve to PathSeg/PathNode header
    columns)."""
    node_vars: Tuple[str, ...]
    rel_vars: Tuple[str, ...]
    varlen: Tuple[bool, ...]
    projected: bool = False


class _SingleQueryBuilder:
    def __init__(self, parent: IRBuilder):
        self.parent = parent
        self.schema = parent.ambient_schema
        self.typer = SchemaTyper(self.schema, parent.parameters)
        self.env: Dict[str, CypherType] = {}
        self.path_defs: Dict[str, _PathDef] = {}
        self.blocks: List[Block] = []
        self._anon = 0

    def fresh(self, prefix: str) -> str:
        self._anon += 1
        return f"__{prefix}{self._anon}"

    def _set_schema(self, schema: Schema) -> None:
        self.schema = schema
        self.typer = SchemaTyper(schema, self.parent.parameters)

    # -- clause dispatch ----------------------------------------------------

    def add_clause(self, clause: ast.Clause) -> None:
        if isinstance(clause, ast.MatchClause):
            self._add_match(clause)
        elif isinstance(clause, ast.UnwindClause):
            self._add_unwind(clause)
        elif isinstance(clause, ast.WithClause):
            self._add_projection(clause.body, where=clause.where, is_return=False)
        elif isinstance(clause, ast.ReturnClause):
            self._add_projection(clause.body, where=None, is_return=True)
        elif isinstance(clause, ast.FromGraphClause):
            self._add_from_graph(clause)
        elif isinstance(clause, ast.ConstructClause):
            self._add_construct(clause)
        elif isinstance(clause, ast.ReturnGraphClause):
            self.blocks.append(ReturnGraphBlock())
        elif isinstance(clause, ast.CallClause):
            self._add_call(clause)
        elif isinstance(clause, ast.CreateClause):
            raise IRBuildError(
                "CREATE as a query clause is not supported; use the graph "
                "factory (caps_tpu.testing) or CONSTRUCT ... NEW")
        else:
            raise IRBuildError(f"unsupported clause {type(clause).__name__}")

    # -- MATCH --------------------------------------------------------------

    def _add_match(self, clause: ast.MatchClause) -> None:
        entities: List[IRField] = []
        connections: List[Connection] = []
        bound: List[str] = []
        predicates: List[E.Expr] = []
        self._build_pattern(clause.pattern, entities, connections, bound,
                            predicates)
        if clause.where is not None:
            predicates.extend(self._split_ands(clause.where))
        predicates = [self._resolve(p) for p in predicates]
        self.blocks.append(MatchBlock(
            Pattern(tuple(entities), tuple(connections), tuple(bound)),
            tuple(predicates), clause.optional))

    def _build_pattern(self, pattern: ast.Pattern, entities: List[IRField],
                       connections: List[Connection], bound: List[str],
                       predicates: List[E.Expr]) -> None:
        """Declare an AST pattern's entities into the current env, emitting
        connections and inline-property/label predicates."""

        def declare_node(n: ast.NodePattern) -> str:
            name = n.var or self.fresh("node")
            if name in self.path_defs:
                raise IRBuildError(
                    f"variable `{name}` is already declared as a path and "
                    "cannot be reused as a node")
            if name in self.env:
                if name not in bound:
                    bound.append(name)
                for lbl in n.labels:
                    predicates.append(E.HasLabel(E.Var(name), lbl))
            else:
                self.env[name] = CTNode(n.labels)
                entities.append(IRField(name, CTNode(n.labels)))
            if n.properties is not None:
                self._property_predicates(name, n.properties, predicates)
            return name

        for part in pattern.parts:
            if part.path_var is not None and part.path_var in self.env:
                raise IRBuildError(
                    f"path variable `{part.path_var}` already bound")
            path_nodes: List[str] = []
            path_rels: List[str] = []
            path_varlen: List[bool] = []
            elems = part.elements
            prev = declare_node(elems[0])
            path_nodes.append(prev)
            i = 1
            while i < len(elems):
                rel: ast.RelPattern = elems[i]
                node: ast.NodePattern = elems[i + 1]
                nxt = declare_node(node)
                rname = rel.var or self.fresh("rel")
                if rname in self.env and rel.var is not None:
                    raise IRBuildError(f"relationship variable `{rname}` already bound")
                rel_ct: CypherType = CTRelationship(rel.rel_types)
                if rel.var_length is not None:
                    rel_ct = CTList(rel_ct)
                self.env[rname] = rel_ct
                entities.append(IRField(rname, rel_ct))
                if rel.properties is not None:
                    if rel.var_length is not None:
                        raise IRBuildError(
                            "property maps on variable-length relationships "
                            "are not supported")
                    self._property_predicates(rname, rel.properties, predicates)
                direction = _DIRECTION[rel.direction]
                if direction == Direction.INCOMING:
                    connections.append(Connection(
                        nxt, rname, prev, Direction.OUTGOING,
                        rel.rel_types, rel.var_length))
                else:
                    connections.append(Connection(
                        prev, rname, nxt, direction,
                        rel.rel_types, rel.var_length))
                path_nodes.append(nxt)
                path_rels.append(rname)
                path_varlen.append(rel.var_length is not None)
                prev = nxt
                i += 2
            if part.path_var is not None:
                self.env[part.path_var] = CTPath
                self.path_defs[part.path_var] = _PathDef(
                    tuple(path_nodes), tuple(path_rels), tuple(path_varlen))

    # -- EXISTS subqueries ---------------------------------------------------

    def _resolve_exists(self, expr: E.Expr) -> E.Expr:
        """Rebind parser-stage ExistsSubQuery nodes (clause-AST pattern) to
        IR-stage ones (ir Pattern + typed predicate tuple).  Resolution is
        TOP-DOWN: a nested EXISTS must be built inside its enclosing
        subquery's scope (after the enclosing pattern declared its vars),
        which _build_exists does by recursing on the inner WHERE."""
        if isinstance(expr, E.ExistsSubQuery):
            if isinstance(expr.pattern, ast.Pattern):
                return self._build_exists(expr)
            return expr  # already IR-stage
        return expr.map_children(
            lambda c: self._resolve_exists(c) if isinstance(c, E.Expr) else c)

    def _build_exists(self, sq: E.ExistsSubQuery) -> E.ExistsSubQuery:
        saved_env = self.env
        self.env = dict(saved_env)  # subquery scope: sees outer, adds local
        try:
            entities: List[IRField] = []
            connections: List[Connection] = []
            bound: List[str] = []
            preds: List[E.Expr] = []
            self._build_pattern(sq.pattern, entities, connections, bound,
                                preds)
            if sq.where is not None:
                preds.extend(self._split_ands(
                    self._resolve_exists(sq.where)))
            pattern = Pattern(tuple(entities), tuple(connections),
                              tuple(bound))
            return E.ExistsSubQuery(pattern, None, tuple(preds))
        finally:
            self.env = saved_env

    # -- named paths ---------------------------------------------------------

    def _path_rel_piece(self, d: _PathDef, name: str, i: int) -> E.Expr:
        if d.projected:
            return E.PathSeg(E.Var(name), i, d.varlen[i])
        return E.Var(d.rel_vars[i])

    def _resolve_paths(self, expr: E.Expr) -> E.Expr:
        """Rewrite reads of named-path variables into expressions over the
        path's constituent vars (fresh scope) or its PathSeg/PathNode
        header columns (after a projection reified the path):

          * ``length(p)`` → fixed hop count (+ ``size(<rel list>)`` per
            var-length segment);
          * ``relationships(p)`` → list concat of the hop rels;
          * ``nodes(p)`` → list of the node vars (fixed-length paths);
          * any other bare ``Var(p)`` in a fresh scope → ``PathExpr``
            (only ProjectOp consumes it; see relational/ops.py).
        """
        if not self.path_defs:
            return expr

        def path_of(x) -> Optional[str]:
            if isinstance(x, E.Var) and x.name in self.path_defs:
                return x.name
            return None

        def start_id_expr(p: str) -> E.Expr:
            # Id(Var(p)) rather than bare Var(p) for projected paths: the
            # evaluators unwrap Id to the entity's id column, and the bare
            # var would re-match this very rewrite (infinite recursion).
            d = self.path_defs[p]
            return E.Id(E.Var(p)) if d.projected \
                else E.Id(E.Var(d.node_vars[0]))

        def rels_expr(p: str) -> E.Expr:
            d = self.path_defs[p]
            acc: Optional[E.Expr] = None
            for i, vl in enumerate(d.varlen):
                piece = self._path_rel_piece(d, p, i)
                if not vl:
                    piece = E.ListLit((piece,))
                acc = piece if acc is None else E.Add(acc, piece)
            return acc if acc is not None else E.ListLit(())

        def rule(n: E.Expr) -> E.Expr:
            if isinstance(n, (E.Equals, E.NotEquals)):
                pl, pr = path_of(n.lhs), path_of(n.rhs)
                if pl is not None and pr is not None:
                    # path equality = same start node + same relationship
                    # id sequence (the node chain follows from those)
                    eq = E.Ands((E.Equals(start_id_expr(pl),
                                          start_id_expr(pr)),
                                 E.Equals(rels_expr(pl), rels_expr(pr))))
                    return E.Not(eq) if isinstance(n, E.NotEquals) else eq
            if isinstance(n, (E.IsNull, E.IsNotNull)) \
                    and (p := path_of(n.expr)) is not None:
                d = self.path_defs[p]
                witness = (self._path_rel_piece(d, p, 0) if d.varlen
                           else start_id_expr(p))
                return type(n)(witness)
            if isinstance(n, E.FunctionExpr) and len(n.args) == 1 \
                    and (p := path_of(n.args[0])) is not None:
                d = self.path_defs[p]
                k = len(d.varlen)  # hop count (rel_vars is empty once projected)
                fname = n.name.lower()
                if fname in ("length", "size"):
                    out: E.Expr = E.Lit(sum(1 for v in d.varlen if not v))
                    for i, vl in enumerate(d.varlen):
                        if vl:
                            out = E.Add(out, E.FunctionExpr(
                                "size", (self._path_rel_piece(d, p, i),)))
                    return out
                if fname in ("relationships", "rels"):
                    return rels_expr(p)
                if fname == "nodes":
                    if any(d.varlen):
                        # Interior nodes of var-length segments are unbound
                        # vars, but the hop rel ids are — reconstruct the
                        # node sequence at eval time by walking endpoints
                        # (same machinery as path materialization).
                        return E.PathNodes(
                            start_id_expr(p),
                            tuple(self._path_rel_piece(d, p, i)
                                  for i in range(k)),
                            d.varlen)
                    if d.projected:
                        return E.ListLit(tuple(
                            E.PathNode(E.Var(p), i) for i in range(k + 1)))
                    return E.ListLit(tuple(E.Var(nv) for nv in d.node_vars))
            if isinstance(n, E.Aggregator):
                arg = getattr(n, "expr", None)
                if (p := path_of(arg)) is not None:
                    d = self.path_defs[p]
                    if isinstance(n, E.Count) and not n.distinct:
                        # count(p) = count of non-null paths.  The witness
                        # must be a column that is null exactly when the
                        # (optional) path is: the FIRST HOP's rel binding —
                        # the start node may be bound outside the OPTIONAL
                        # MATCH and hence non-null on a failed match.
                        # Zero-hop paths are their start node.
                        if d.projected:
                            if d.varlen:
                                return E.Count(E.PathSeg(E.Var(p), 0,
                                                         d.varlen[0]))
                            return n  # zero-hop: the path column itself
                        if d.rel_vars:
                            return E.Count(E.Var(d.rel_vars[0]))
                        return E.Count(E.Id(E.Var(d.node_vars[0])))
                    raise IRBuildError(
                        f"aggregating path values ({type(n).__name__.lower()}"
                        f" over `{p}`) is not supported; aggregate "
                        f"length({p})/nodes({p})/relationships({p}) instead")
            if (p := path_of(n)) is not None:
                d = self.path_defs[p]
                if d.projected:
                    return n  # real header var: passthrough / aliasing
                return E.PathExpr(
                    tuple(E.Var(nv) for nv in d.node_vars),
                    tuple(E.Var(rv) for rv in d.rel_vars), d.varlen)
            return n

        return expr.transform_down(rule)

    def _resolve(self, expr: E.Expr) -> E.Expr:
        return self._resolve_paths(self._resolve_exists(expr))

    def _property_predicates(self, var: str, props: E.Expr,
                             out: List[E.Expr]) -> None:
        if isinstance(props, E.MapLit):
            for k, v in zip(props.keys, props.values):
                out.append(E.Equals(E.Property(E.Var(var), k), v))
        elif isinstance(props, E.Param):
            # Pattern-property expansion depends on the map's KEY SET
            # only (values flow through Index(param, key) at runtime):
            # under a PlanParams view the key set is recorded as a cache
            # specialization, so the plan is shared across bindings with
            # the same keys and re-planned when the keys change.
            params = self.parent.parameters
            map_keys = getattr(params, "map_keys", None)
            if map_keys is not None:
                keys = map_keys(props.name)
            else:
                value = params.get(props.name) if hasattr(params, "get") \
                    else None
                keys = tuple(sorted(value)) if isinstance(value, dict) \
                    else None
            if keys is None:
                raise IRBuildError(
                    f"pattern property parameter ${props.name} must be a map")
            for k in keys:
                out.append(E.Equals(E.Property(E.Var(var), k),
                                    E.Index(props, E.Lit(k))))
        else:
            raise IRBuildError("pattern properties must be a map literal or parameter")

    @staticmethod
    def _split_ands(e: E.Expr) -> List[E.Expr]:
        if isinstance(e, E.Ands):
            out: List[E.Expr] = []
            for x in e.exprs:
                out.extend(_SingleQueryBuilder._split_ands(x))
            return out
        return [e]

    # -- UNWIND -------------------------------------------------------------

    def _add_unwind(self, clause: ast.UnwindClause) -> None:
        expr = self._resolve(clause.expr)
        t = self.typer.type_of(expr, self.env)
        inner = t.material.inner if isinstance(t.material, _CTList) else CTAny
        self.blocks.append(UnwindBlock(expr, clause.var))
        self.env[clause.var] = inner

    # -- WITH / RETURN ------------------------------------------------------

    def _add_projection(self, body: ast.ProjectionBody, where: Optional[E.Expr],
                        is_return: bool) -> None:
        items: List[Tuple[str, E.Expr]] = []
        if body.star:
            for name in sorted(self.env):
                if not name.startswith("__"):
                    items.append((name, self._resolve(E.Var(name))))
        for item in body.items:
            if item.alias is not None:
                name = item.alias
            elif isinstance(item.expr, E.Var):
                name = item.expr.name
            else:
                name = item.expr.cypher_repr()
            items.append((name, self._resolve(item.expr)))
        visible = [name for name, _ in items]
        defining: Dict[str, E.Expr] = dict(items)

        aggregating = any(E.is_aggregating(e) for _, e in items)
        new_env: Dict[str, CypherType] = {}

        if aggregating:
            group: List[Tuple[str, E.Expr]] = []
            aggs: List[Tuple[str, E.Aggregator]] = []
            post: List[Tuple[str, E.Expr]] = []
            needs_post = False
            for name, expr in items:
                if not E.is_aggregating(expr):
                    group.append((name, expr))
                    post.append((name, E.Var(name)))
                elif isinstance(expr, E.Aggregator):
                    aggs.append((name, expr))
                    post.append((name, E.Var(name)))
                else:
                    # aggregator(s) nested inside a larger expression
                    needs_post = True
                    replaced = self._extract_aggs(expr, aggs)
                    post.append((name, replaced))
            path_groups = [(n, x) for n, x in group
                           if isinstance(x, E.PathExpr)]
            if path_groups:
                # Grouping by a path value: reify the path columns with a
                # pre-projection, then group by the (multi-column) path var.
                path_names = {n for n, _ in path_groups}
                keep = [(v, E.Var(v)) for v in self.env
                        if v not in path_names
                        and (v not in self.path_defs
                             or self.path_defs[v].projected)]
                self.blocks.append(ProjectBlock(
                    tuple(keep) + tuple(path_groups), distinct=False))
                env2 = {v: self.env[v] for v, _ in keep}
                for n, x in path_groups:
                    env2[n] = CTPath
                    self.path_defs[n] = _PathDef((), (), x.varlen,
                                                 projected=True)
                self.env = env2
                group = [(n, E.Var(n) if isinstance(x, E.PathExpr) else x)
                         for n, x in group]
            for gname, gexpr in group:
                for v in E.vars_in(gexpr):
                    if v.name not in self.env:
                        raise IRBuildError(f"variable `{v.name}` not in scope")
            agg_env: Dict[str, CypherType] = {}
            for gname, gexpr in group:
                agg_env[gname] = self.typer.type_of(gexpr, self.env)
            for aname, aexpr in aggs:
                agg_env[aname] = self.typer.type_of(aexpr, self.env)
            self.blocks.append(AggregationBlock(tuple(group), tuple(aggs)))
            self.env = agg_env
            if needs_post:
                self.blocks.append(ProjectBlock(tuple(post), distinct=False))
                new_env = {n: self.typer.type_of(x, agg_env) for n, x in post}
                self.env = new_env
            if body.distinct and needs_post:
                # grouped output is unique per group key already unless a
                # post-projection collapsed columns; re-distinct to be safe
                self.blocks.append(ProjectBlock(
                    tuple((n, E.Var(n)) for n, _ in post), distinct=True))
        else:
            project_items = list(items)
            hidden: List[str] = []
            order_rewritten: List[Tuple[E.Expr, bool]] = []
            for oi in body.order_by:
                expr = self._resolve_order_expr(
                    self._resolve(oi.expr), visible, defining)
                # ORDER BY <expr> where <expr> is exactly a projected item's
                # defining expression sorts by that item (openCypher rule).
                for name, dexpr in items:
                    if expr == dexpr:
                        expr = E.Var(name)
                        break
                if self._uses_only(expr, visible):
                    order_rewritten.append((expr, oi.ascending))
                elif body.distinct:
                    # With DISTINCT the sort key would join the distinct key
                    # and change duplicate elimination; openCypher forbids it.
                    raise IRBuildError(
                        "with DISTINCT, ORDER BY may only reference "
                        "projected columns")
                else:
                    hname = self.fresh("order")
                    project_items.append((hname, expr))
                    hidden.append(hname)
                    order_rewritten.append((E.Var(hname), oi.ascending))
            self.blocks.append(ProjectBlock(tuple(project_items), body.distinct))
            new_env = {n: self.typer.type_of(x, self.env) for n, x in project_items}
            self.env = new_env
            if order_rewritten or body.skip is not None or body.limit is not None:
                self.blocks.append(OrderAndSliceBlock(
                    tuple(order_rewritten), body.skip, body.limit))
            if hidden:
                self.blocks.append(SelectBlock(tuple(visible)))
                self.env = {n: t for n, t in self.env.items() if n in visible}

        if aggregating and (body.order_by or body.skip is not None
                            or body.limit is not None):
            order_rewritten = []
            for oi in body.order_by:
                expr = self._resolve_order_expr(
                    self._resolve(oi.expr), visible, defining)
                for name, dexpr in items:
                    if expr == dexpr:  # ORDER BY a grouping-key expression
                        expr = E.Var(name)
                        break
                if not self._uses_only(expr, list(self.env)):
                    raise IRBuildError(
                        "ORDER BY after aggregation may only reference "
                        "projected columns")
                order_rewritten.append((expr, oi.ascending))
            self.blocks.append(OrderAndSliceBlock(
                tuple(order_rewritten), body.skip, body.limit))

        # Scope transition for named paths: a projected PathExpr becomes a
        # real multi-column var (reads resolve to PathSeg/PathNode columns);
        # everything else falls out of scope with its constituent vars.
        new_defs: Dict[str, _PathDef] = {}
        for name, expr in items:
            if isinstance(expr, E.PathExpr):
                new_defs[name] = _PathDef((), (), expr.varlen, projected=True)
            elif isinstance(expr, E.Var) and expr.name in self.path_defs \
                    and self.path_defs[expr.name].projected:
                new_defs[name] = self.path_defs[expr.name]
        self.path_defs = new_defs

        if where is not None:
            self.blocks.append(FilterBlock(self._resolve(where)))
        if is_return:
            self.blocks.append(ResultBlock(tuple(visible)))

    def _extract_aggs(self, expr: E.Expr,
                      aggs: List[Tuple[str, E.Aggregator]]) -> E.Expr:
        def rule(n):
            if isinstance(n, E.Aggregator):
                for name, existing in aggs:
                    if existing == n:
                        return E.Var(name)
                name = self.fresh("agg")
                aggs.append((name, n))
                return E.Var(name)
            return n
        return expr.transform_down(rule)

    def _resolve_order_expr(self, expr: E.Expr, visible: List[str],
                            defining: Dict[str, E.Expr]) -> E.Expr:
        """ORDER BY sees both projected aliases and the pre-projection scope.
        Rewrite alias references that are *not* pre-existing vars to their
        defining expressions when mixed with old-scope vars."""
        if self._uses_only(expr, visible):
            return expr

        def rule(n):
            if isinstance(n, E.Var) and n.name in defining \
                    and n.name not in self.env:
                return defining[n.name]
            return n
        return expr.transform_down(rule)

    @staticmethod
    def _uses_only(expr: E.Expr, names: List[str]) -> bool:
        return all(v.name in names for v in E.vars_in(expr))

    # -- CALL ---------------------------------------------------------------

    def _add_call(self, clause: ast.CallClause) -> None:
        """Resolve the procedure against the registry (the semantic pass
        already validated it) and declare the YIELD outputs into scope
        with the registered column types."""
        from caps_tpu_torch.algo import registry
        sig = registry.lookup(clause.procedure)
        yields = clause.yields or tuple((n, None) for n in sig.yield_names)
        resolved = tuple((y, a or y) for y, a in yields)
        self.blocks.append(CallBlock(clause.procedure, tuple(clause.args),
                                     resolved))
        for yname, out in resolved:
            self.env[out] = sig.yield_type(yname)
        if clause.where is not None:
            self.blocks.append(FilterBlock(self._resolve(clause.where)))

    # -- multiple graphs ----------------------------------------------------

    def _add_from_graph(self, clause: ast.FromGraphClause) -> None:
        qgn = QualifiedGraphName.parse(clause.qualified_name)
        if self.parent.schema_resolver is None:
            raise IRBuildError(
                f"FROM GRAPH {qgn!r} requires a catalog (no schema resolver)")
        self._set_schema(self.parent.schema_resolver(qgn))
        self.blocks.append(FromGraphBlock(qgn))

    def _add_construct(self, clause: ast.ConstructClause) -> None:
        on = tuple(QualifiedGraphName.parse(g) for g in clause.on_graphs)
        self.blocks.append(ConstructBlock(
            on, clause.clones, clause.news, clause.sets))
