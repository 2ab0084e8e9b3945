"""Logical plan → relational operator tree.

Mirrors the reference's ``RelationalPlanner`` — each LogicalOperator maps to
RelationalOperators parameterized by the backend Table; Expand becomes
Join(Join(rows, rel-scan), node-scan) on id columns (ref:
okapi-relational/.../impl/RelationalPlanner.scala — reconstructed, mount
empty; SURVEY.md §2, §3.2 "planExpand").
"""
from __future__ import annotations

from typing import Callable, Dict, Optional as Opt, Tuple

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.logical import ops as L
from caps_tpu_torch.okapi.graph import QualifiedGraphName
from caps_tpu_torch.okapi.types import CTNode, CTRelationship
from caps_tpu_torch.relational import ops as R
from caps_tpu_torch.relational.graphs import RelationalCypherGraph
from caps_tpu_torch.relational.var_expand import VarExpandOp


class RelationalPlanningError(Exception):
    pass


GraphResolver = Callable[[QualifiedGraphName], RelationalCypherGraph]


class RelationalPlanner:
    def __init__(self, context: R.RelationalRuntimeContext,
                 ambient_graph: RelationalCypherGraph,
                 graph_resolver: Opt[GraphResolver] = None,
                 cost_model=None):
        self.context = context
        self.ambient_graph = ambient_graph
        self.graph_resolver = graph_resolver
        #: relational/cost.py CostModel — physical-strategy choices
        #: (count pushdown vs cascade, WCOJ vs cascade) consult it when
        #: present
        self.cost_model = cost_model
        self._entity_ctx_cache: Dict[int, R.EntityContext] = {}
        self.current_graph = ambient_graph
        self._memo: Dict[L.LogicalOperator, R.RelationalOperator] = {}
        self._fresh = 0
        # Names referenced anywhere in the plan (None = unknown, assume
        # everything is used); lets VarExpand prove its rel var dead and
        # take the matrix path (var_expand.py module docstring).
        self._used_names: Opt[frozenset] = None
        # Names whose only reads are size()/length() — a var-length rel
        # list read that way is served by a PATH-LENGTH column instead,
        # keeping the query on the matrix path (e.g. LDBC IC13/IC14's
        # min(size(r))).  _fix() rewrites those reads in consumers.
        self._size_only_ok: frozenset = frozenset()
        self._len_names: Dict[str, str] = {}
        # single-hop rel var -> its pattern endpoints (for the
        # startNode()/endNode() property rewrite in _fix)
        self._rel_endpoints: Dict[str, Tuple[str, str]] = {}

    @property
    def current_graph(self) -> RelationalCypherGraph:
        return self._current_graph

    @current_graph.setter
    def current_graph(self, g: RelationalCypherGraph) -> None:
        # keep one EntityContext per graph so ops planned while this graph
        # is current share lookup caches (and multi-graph queries rehydrate
        # against the right graph — RelationalOperator snapshots this)
        self._current_graph = g
        ctx = self._entity_ctx_cache.get(id(g))
        if ctx is None:
            ctx = R.EntityContext(g)
            self._entity_ctx_cache[id(g)] = ctx
        self.context.entity_ctx = ctx

    def fresh(self, prefix: str) -> str:
        self._fresh += 1
        return f"__{prefix}_{self._fresh}"

    def _fix(self, e: E.Expr, scope: Opt[L.LogicalOperator] = None
             ) -> E.Expr:
        """Expression rewrites that need plan context:

        * size(rel)/length(rel) of a size-only var-length rel variable
          → its path-length column (see _len_names);
        * startNode(rel).k / endNode(rel).k where the MATCH bound the
          endpoints → CASE WHEN startNode(rel) = id(x) THEN x.k ELSE
          y.k — correct for every match direction, because startNode/
          endNode follow the STORED orientation and the comparison is
          against the actual stored id (previously these silently
          evaluated the property of a bare node id: null).  Applied only
          when ``scope`` (the consumer's input subtree) still carries
          the pattern's endpoint bindings unobscured — see
          _endpoints_reach."""
        if not self._len_names and not self._rel_endpoints:
            return e

        def repl(x):
            if (isinstance(x, E.FunctionExpr)
                    and x.name.lower() in ("size", "length")
                    and len(x.args) == 1 and isinstance(x.args[0], E.Var)
                    and x.args[0].name in self._len_names):
                return E.Var(self._len_names[x.args[0].name])
            if (isinstance(x, E.Property)
                    and isinstance(x.entity, (E.StartNode, E.EndNode))
                    and isinstance(x.entity.rel, E.Var)
                    and x.entity.rel.name in self._rel_endpoints
                    and scope is not None):
                a, b = self._rel_endpoints[x.entity.rel.name]
                if self._endpoints_reach(scope, x.entity.rel.name, a, b):
                    return E.CaseExpr(
                        (E.Equals(x.entity, E.Id(E.Var(a))),),
                        (E.Property(E.Var(a), x.key),),
                        E.Property(E.Var(b), x.key))
            return x

        return e.transform_up(repl)

    def _endpoints_reach(self, op, rel: str, a: str, b: str) -> bool:
        """True when, walking down the consumer's input subtree, the
        Expand binding ``rel`` is reached with its endpoint names
        ``a``/``b`` neither dropped by a Select nor rebound by a
        Project/Aggregate/Unwind/var-length bind along the way."""
        while op is not None:
            if isinstance(op, L.Select):
                if not {a, b} <= set(op.names):
                    return False
                op = op.parent
            elif isinstance(op, L.Project):
                if {rel, a, b} & {n for n, _ in op.items}:
                    return False  # rel or endpoint rebound here
                op = op.parent
            elif isinstance(op, L.Aggregate):
                return False  # only grouped aliases survive
            elif isinstance(op, L.Unwind):
                if op.var in (rel, a, b):
                    return False
                op = op.parent
            elif isinstance(op, L.Expand):
                if op.rel == rel:
                    return {op.source, op.target} == {a, b}
                op = op.parent
            elif isinstance(op, L.BoundedVarLengthExpand):
                if op.rel == rel or op.target in (a, b) \
                        or op.rel in (a, b):
                    return False
                op = op.parent
            elif isinstance(op, (L.Filter, L.Distinct, L.OrderBy, L.Skip,
                                 L.Limit, L.NodeScan, L.FromGraph)):
                op = getattr(op, "parent", None)
            elif isinstance(op, (L.Optional, L.ExistsSemiJoin)):
                return (self._endpoints_reach(op.rhs, rel, a, b)
                        or self._endpoints_reach(op.lhs, rel, a, b))
            elif isinstance(op, (L.CartesianProduct, L.ValueJoin)):
                return (self._endpoints_reach(op.lhs, rel, a, b)
                        or self._endpoints_reach(op.rhs, rel, a, b))
            elif isinstance(op, L.TabularUnionAll):
                # rows come from either branch: both must satisfy
                return (self._endpoints_reach(op.lhs, rel, a, b)
                        and self._endpoints_reach(op.rhs, rel, a, b))
            else:
                return False  # unknown operator: conservative
        return False

    def process(self, plan: L.LogicalPlan) -> R.RelationalOperator:
        self._used_names, self._size_only_ok, self._rel_endpoints = \
            self._collect_used_names(plan.root)
        return self.plan_op(plan.root)

    @staticmethod
    def _op_exprs(op):
        """The expression trees one logical operator carries."""
        if isinstance(op, L.Filter):
            return (op.predicate,)
        if isinstance(op, L.Project):
            return tuple(e for _, e in op.items)
        if isinstance(op, L.Aggregate):
            return (tuple(e for _, e in op.group)
                    + tuple(a for _, a in op.aggregations))
        if isinstance(op, L.OrderBy):
            return tuple(e for e, _ in op.items)
        if isinstance(op, (L.Skip, L.Limit)):
            return (op.expr,)
        if isinstance(op, L.Unwind):
            return (op.list_expr,)
        if isinstance(op, L.ValueJoin):
            return tuple(op.predicates)
        return ()

    @staticmethod
    def _collect_used_names(root: L.LogicalOperator):
        """(used, size_only): every name read by an expression or
        selection in the plan, and the subset whose EVERY read is
        ``size(name)``/``length(name)`` (those reads can be served by a
        path-length column instead of the materialized value).  used is
        None (= treat all names as used) when the plan contains
        operators whose name flow this walk doesn't model (CONSTRUCT
        patterns carry var references outside the Expr tree)."""
        used = set()
        selected = set()
        total: dict = {}
        wrapped: dict = {}
        varlen_binds: dict = {}
        other_binds = set()
        rel_endpoints: dict = {}
        shadowed = set()
        conservative = False
        has_exists = False

        def count_expr(e):
            nonlocal has_exists
            if isinstance(e, E.Var):
                total[e.name] = total.get(e.name, 0) + 1
            if isinstance(e, E.ExistsSubQuery):
                # the subquery pattern introduces its own scope this
                # name-level analysis does not model
                has_exists = True
            if (isinstance(e, E.FunctionExpr)
                    and e.name.lower() in ("size", "length")
                    and len(e.args) == 1 and isinstance(e.args[0], E.Var)):
                n = e.args[0].name
                wrapped[n] = wrapped.get(n, 0) + 1
            for c in e.children:
                if isinstance(c, E.Expr):
                    count_expr(c)

        seen_ops = set()

        def walk(op):
            nonlocal conservative
            # shared subtrees (Optional/ExistsSemiJoin rhs embeds lhs)
            # must count once, or a single Expand looks rebound
            if id(op) in seen_ops:
                return
            seen_ops.add(id(op))
            if isinstance(op, (L.ConstructGraph, L.ReturnGraph)):
                conservative = True
            if isinstance(op, L.Select):
                used.update(op.names)
                selected.update(op.names)
            # binding sites: a size-only rewrite is sound only when the
            # name has exactly ONE binding in the whole plan and it is a
            # var-length rel — same-named bindings in sibling scopes
            # (UNION branches, UNWIND) would otherwise be rewritten to a
            # length column their branch does not have
            if isinstance(op, L.BoundedVarLengthExpand):
                varlen_binds[op.rel] = varlen_binds.get(op.rel, 0) + 1
                other_binds.add(op.target)
            elif isinstance(op, (L.NodeScan, L.RelScan)):
                other_binds.add(op.var)
            elif isinstance(op, L.Expand):
                other_binds.update((op.rel, op.target))
                if op.rel in rel_endpoints and \
                        rel_endpoints[op.rel] != (op.source, op.target):
                    shadowed.add(op.rel)  # rebound: ambiguous endpoints
                rel_endpoints[op.rel] = (op.source, op.target)
            elif isinstance(op, L.Unwind):
                other_binds.add(op.var)
            elif isinstance(op, L.Project):
                other_binds.update(n for n, _ in op.items)
            elif isinstance(op, L.Aggregate):
                other_binds.update(n for n, _ in op.group)
                other_binds.update(n for n, _ in op.aggregations)
            for e in RelationalPlanner._op_exprs(op):
                used.update(v.name for v in E.vars_in(e))
                count_expr(e)
            for c in op.children:
                if isinstance(c, L.LogicalOperator):
                    walk(c)

        walk(root)
        for n in shadowed:
            rel_endpoints.pop(n, None)

        if conservative:
            return None, frozenset(), {}
        if has_exists:
            return frozenset(used), frozenset(), rel_endpoints
        size_only = frozenset(
            n for n, t in total.items()
            if wrapped.get(n, 0) == t and n not in selected
            and varlen_binds.get(n, 0) == 1 and n not in other_binds)
        return frozenset(used), size_only, rel_endpoints

    # ------------------------------------------------------------------

    def plan_op(self, op: L.LogicalOperator) -> R.RelationalOperator:  # noqa: C901
        # Memo keys are the logical ops themselves (frozen dataclasses, so
        # structural): shared or structurally-identical subtrees plan to one
        # relational operator, which Optional planning depends on.
        if op in self._memo:
            return self._memo[op]
        out = self._plan_op(op)
        self._memo[op] = out
        return out

    def _plan_op(self, op: L.LogicalOperator) -> R.RelationalOperator:  # noqa: C901
        ctx = self.context
        if isinstance(op, L.Start):
            if op.qgn is not None and self.graph_resolver is not None:
                self.current_graph = self.graph_resolver(op.qgn)
            return R.StartOp(ctx)
        if isinstance(op, L.NodeScan):
            self.plan_op(op.parent)  # graph-context side effects (FromGraph)
            return R.ScanOp(ctx, self.current_graph, op.var, CTNode(op.labels))
        if isinstance(op, L.RelScan):
            self.plan_op(op.parent)
            return R.ScanOp(ctx, self.current_graph, op.var,
                            CTRelationship(op.rel_types))
        if isinstance(op, L.Expand):
            return self._plan_expand(op)
        if isinstance(op, L.BoundedVarLengthExpand):
            parent = self.plan_op(op.parent)
            rel_needed = (self._used_names is None
                          or op.rel in self._used_names)
            emit_len = None
            if rel_needed and op.rel in self._size_only_ok:
                # every read is size(rel)/length(rel): emit a path-length
                # column and rewrite those reads to it — the rel list
                # itself need not materialize
                emit_len = f"__{op.rel}_len"
                self._len_names[op.rel] = emit_len
                rel_needed = False
            return VarExpandOp(
                ctx, parent, self.current_graph, op.source, op.rel,
                op.rel_types, op.target, op.target_labels, op.direction,
                op.lower, op.upper, op.into, rel_needed=rel_needed,
                emit_len=emit_len)
        if isinstance(op, L.Filter):
            parent = self.plan_op(op.parent)
            return R.FilterOp(ctx, parent,
                               self._fix(op.predicate, op.parent))
        if isinstance(op, L.Project):
            parent = self.plan_op(op.parent)
            env = dict(op.fields)
            items = [(name, self._fix(expr, op.parent), env[name])
                     for name, expr in op.items]
            return R.ProjectOp(ctx, parent, items)
        if isinstance(op, L.Select):
            return R.SelectOp(ctx, self.plan_op(op.parent), op.names)
        if isinstance(op, L.Distinct):
            return R.DistinctOp(ctx, self.plan_op(op.parent))
        if isinstance(op, L.Aggregate):
            parent = self.plan_op(op.parent)
            env = dict(op.fields)
            group = [(n, self._fix(e, op.parent), env[n])
                     for n, e in op.group]
            aggs = [(n, self._fix(a, op.parent), env[n])
                    for n, a in op.aggregations]
            default = R.AggregateOp(ctx, parent, group, aggs)
            from caps_tpu_torch.relational.count_pattern import (
                CountCycleOp, try_plan_count_pushdown,
            )
            pushed = try_plan_count_pushdown(self, op, default)
            if pushed is not None and self.cost_model is not None \
                    and not isinstance(pushed, CountCycleOp) \
                    and not self._pushdown_wins(pushed):
                # count pushdown vs cascade is a model choice: a
                # hyper-selective seed on a huge graph keeps the join
                # cascade (tiny padded frontiers beat a full-graph SpMV)
                pushed = None
            return pushed if pushed is not None else default
        if isinstance(op, L.OrderBy):
            parent = self.plan_op(op.parent)
            items = tuple((self._fix(e, op.parent), asc)
                          for e, asc in op.items)
            return R.OrderByOp(ctx, parent, items)
        if isinstance(op, L.Skip):
            parent = self.plan_op(op.parent)
            return R.SkipOp(ctx, parent, self._fix(op.expr, op.parent))
        if isinstance(op, L.Limit):
            parent = self.plan_op(op.parent)
            return R.LimitOp(ctx, parent, self._fix(op.expr, op.parent))
        if isinstance(op, L.Unwind):
            env = dict(op.fields)
            parent = self.plan_op(op.parent)
            return R.UnwindOp(ctx, parent,
                              self._fix(op.list_expr, op.parent),
                              op.var, env[op.var])
        if isinstance(op, L.Optional):
            tagged, rhs, rid = self._plan_optional(op.lhs, op.rhs)
            return R.OptionalJoinOp(ctx, tagged, rhs, rid)
        if isinstance(op, L.ExistsSemiJoin):
            tagged, rhs, rid = self._plan_optional(op.lhs, op.rhs)
            return R.ExistsJoinOp(ctx, tagged, rhs, rid, op.marker)
        if isinstance(op, L.CartesianProduct):
            l, r = self._plan_two(op.lhs, op.rhs)
            return R.CrossOp(ctx, l, r)
        if isinstance(op, L.ValueJoin):
            pairs = []
            for pred in op.predicates:
                if not isinstance(pred, E.Equals):
                    raise RelationalPlanningError(
                        f"ValueJoin predicate must be equality: {pred!r}")
                pairs.append((pred.lhs, pred.rhs))
            l, r = self._plan_two(op.lhs, op.rhs)
            return R.JoinOp(ctx, l, r, pairs, op.join_type)
        if isinstance(op, L.TabularUnionAll):
            l, r = self._plan_two(op.lhs, op.rhs, keep="pre")
            return R.UnionAllOp(ctx, l, r)
        if isinstance(op, L.FromGraph):
            planned = self.plan_op(op.parent)
            if self.graph_resolver is None:
                raise RelationalPlanningError(
                    f"FROM GRAPH {op.qgn!r} requires a catalog")
            self.current_graph = self.graph_resolver(op.qgn)
            return planned
        if isinstance(op, (L.ConstructGraph, L.ReturnGraph)):
            from caps_tpu_torch.relational.construct import plan_construct
            return plan_construct(self, op)
        if isinstance(op, L.EmptyRecords):
            return R.StartOp(ctx)
        if isinstance(op, L.ProcedureCall):
            return self._plan_procedure(op)
        raise RelationalPlanningError(f"cannot plan {type(op).__name__}")

    def _plan_procedure(self, op: L.ProcedureCall) -> R.RelationalOperator:
        from caps_tpu_torch.algo import registry
        from caps_tpu_torch.algo.op import AlgoProcedureOp
        parent = self.plan_op(op.parent)
        sig = registry.lookup(op.procedure)
        prefer_host = False
        if self.cost_model is not None:
            try:
                prefer_host = not self.cost_model.algo_pushdown_wins(
                    sig.name, sig.est_iterations)
            except Exception:  # pragma: no cover — pricing must not fail
                prefer_host = False
        return AlgoProcedureOp(self.context, parent, self.current_graph,
                               sig, op.args, op.yields,
                               prefer_host=prefer_host)

    def _pushdown_wins(self, pushed) -> bool:
        """Price the matched count chain both ways (relational/cost.py
        ``count_pushdown_wins``) — SpMV touches every edge once, the
        cascade the padded expanded frontiers."""
        model = self.cost_model
        seed = pushed.seed
        try:
            return model.count_pushdown_wins(
                seed.labels, model.selectivity(seed.preds, seed.labels),
                [(h.rel_types, h.direction, h.target.labels,
                  model.selectivity(h.target.preds, h.target.labels))
                 for h in pushed.hops])
        except Exception:  # pragma: no cover — pricing must not fail
            return True

    # -- branch-scoped graph context ----------------------------------------

    def _plan_two(self, lhs: L.LogicalOperator, rhs: L.LogicalOperator,
                  keep: str = "lhs"):
        """Plan two independent subtrees with branch-scoped FROM GRAPH
        effects: a graph switch inside one branch must not leak into its
        sibling.  ``keep`` selects which graph context survives: the lhs
        chain's ("lhs", the main chain for joins/products) or the
        pre-branch one ("pre", for UNION where neither branch's switch
        outlives the union)."""
        pre = self.current_graph
        l = self.plan_op(lhs)
        lhs_graph = self.current_graph
        self.current_graph = pre
        r = self.plan_op(rhs)
        self.current_graph = lhs_graph if keep == "lhs" else pre
        return l, r

    def _plan_optional(self, lhs: L.LogicalOperator, rhs: L.LogicalOperator):
        """Optional-match planning: lhs is planned, tagged with a row index,
        and the optional side is planned on the tagged lhs (it continues the
        lhs graph context)."""
        lhs_planned = self.plan_op(lhs)
        rid = self.fresh("rid")
        tagged = R.RowIndexOp(self.context, lhs_planned, rid)
        self._memo[lhs] = tagged
        rhs_planned = self.plan_op(rhs)
        self._memo[lhs] = lhs_planned
        return tagged, rhs_planned, rid

    # -- Expand (SURVEY.md §3.2: the hot path generator) --------------------

    def _plan_expand(self, op: L.Expand) -> R.RelationalOperator:
        ctx = self.context
        rel_var = E.Var(op.rel)
        src_var = E.Var(op.source)
        tgt_var = E.Var(op.target)
        rel_ct = CTRelationship(op.rel_types)

        def branch(outgoing: bool, rel_name: str) -> R.RelationalOperator:
            # parent planning lives INSIDE the branch (memoized, so the
            # BOTH union's two branches still share one subtree): a WCOJ
            # substitution must not plan the chain below it until the
            # decision is made, or nested closing edges would substitute
            # their own operators into what becomes this op's fallback
            parent = self.plan_op(op.parent)
            rel_scan = R.ScanOp(ctx, self.current_graph, rel_name, rel_ct)
            rv = E.Var(rel_name)
            near = E.StartNode(rv) if outgoing else E.EndNode(rv)
            far = E.EndNode(rv) if outgoing else E.StartNode(rv)
            if op.into:
                return R.JoinOp(ctx, parent, rel_scan,
                                [(src_var, near), (tgt_var, far)], "inner")
            j1 = R.JoinOp(ctx, parent, rel_scan, [(src_var, near)], "inner")
            tgt_scan = R.ScanOp(ctx, self.current_graph, op.target,
                                CTNode(op.target_labels))
            return R.JoinOp(ctx, j1, tgt_scan, [(far, tgt_var)], "inner")

        if op.direction in (Direction.OUTGOING, Direction.INCOMING):
            if op.into and not getattr(self, "_in_wcoj_fallback", False):
                # cyclic pattern: a closing edge (both endpoints bound)
                # roots a segment the worst-case-optimal multiway join
                # can own (relational/wcoj.py) — decided before the
                # cascade is built, and the embedded fallback cascade is
                # built with nested substitution suppressed: ONE
                # MultiwayJoinOp per segment, never a second one buried
                # inside the fallback of the first
                from caps_tpu_torch.relational.wcoj import try_plan_wcoj

                def build_cascade():
                    self._in_wcoj_fallback = True
                    try:
                        return branch(op.direction == Direction.OUTGOING,
                                      op.rel)
                    finally:
                        self._in_wcoj_fallback = False
                pushed = try_plan_wcoj(self, op, build_cascade)
                if pushed is not None:
                    return pushed
            return branch(op.direction == Direction.OUTGOING, op.rel)
        # BOTH: union of the two orientations; exclude self-loops from the
        # second branch so each loop edge matches exactly once.
        out_b = branch(True, op.rel)
        in_b = branch(False, op.rel)
        in_b = R.FilterOp(ctx, in_b,
                          E.Not(E.Equals(E.StartNode(rel_var), E.EndNode(rel_var))))
        return R.UnionAllOp(ctx, out_b, in_b)
