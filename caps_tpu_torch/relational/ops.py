"""Relational operators: each lazily defines ``header`` + ``table``.

Mirrors the reference's ``RelationalOperator[T]`` family — Start, Scan,
Filter, Select, Project/Add, Aggregate, Join, Distinct, OrderBy, Skip,
Limit, TabularUnionAll — where every operator defines a lazy ``header:
RecordHeader`` and ``table: T`` evaluated through the Table SPI (ref:
okapi-relational/.../relational/impl/operators/ — reconstructed, mount
empty; SURVEY.md §2 "Relational planner", §3.1).
"""
from __future__ import annotations

import abc
import dataclasses
import itertools
from contextlib import nullcontext
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.obs import clock
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTInteger, CTList, CTNode, CTRelationship, CypherType,
    _CTNode, _CTRelationship,
)
from caps_tpu_torch.relational.header import HeaderError, RecordHeader
from caps_tpu_torch.relational.table import AggSpec, Table
from caps_tpu_torch.serve.deadline import checkpoint as _cancel_checkpoint
from caps_tpu_torch.serve.errors import CancellationError as _CancellationError


ENTITY_CTX_PARAM = "__entity_ctx__"
"""Reserved parameter key carrying the :class:`EntityContext` to the
expression evaluators (popped before query-parameter lookup, excluded
from fused-executor cache keys)."""


class EntityContext:
    """Host-side entity rehydration for expression evaluation: property /
    label access on entity values flowing through list expressions, and
    node-sequence reconstruction for var-length named paths.  One context
    per planned graph — operators snapshot the context current at THEIR
    planning time, so multi-graph queries (FROM GRAPH / UNION branches)
    rehydrate against the graph they actually matched.  Lookups build
    lazily so queries that never touch entity values pay nothing."""

    def __init__(self, graph):
        self._graph = graph
        self._nodes: Optional[Dict] = None
        self._rels: Optional[Dict] = None
        self._indexes: Dict[Any, Any] = {}

    def index(self, key, build):
        """A backend's index of this context's graph (the device
        backend's sorted entity ids, ``backends/cuda/lists.py``), built
        by ``build(graph)`` on first use and kept with the graph, as a
        relationship table keeps its CSR: every plan over an immutable
        graph shares it (a versioned handle's data changes, so its
        index stays with this context)."""
        g = self._graph
        store = self._indexes
        if g is not None and not getattr(g, "plan_token_unstable", False):
            store = g.__dict__.setdefault("_entity_indexes", {})
        if key not in store:
            store[key] = build(g)
        return store[key]

    def node(self, nid) -> Optional[Tuple[Tuple[str, ...], Dict[str, Any]]]:
        if self._nodes is None:
            g = self._graph
            self._nodes = g.node_lookup() if g is not None else {}
        return self._nodes.get(nid)

    def rel(self, rid) -> Optional[Tuple[int, int, str, Dict[str, Any]]]:
        if self._rels is None:
            g = self._graph
            self._rels = g.rel_lookup() if g is not None else {}
        return self._rels.get(rid)


class RelationalRuntimeContext:
    """Per-query context: parameters, session, catalog view (ref:
    ``RelationalRuntimeContext`` — SURVEY.md §2).

    Parameter VALUES are late-bound: every operator reads
    ``context.parameters`` inside ``_compute`` (filters, projections,
    SKIP/LIMIT counts, percentile args), never at plan-construction time.
    That contract is what lets the session plan cache
    (relational/plan_cache.py) re-execute one planned operator tree for
    every binding of the same parameter signature."""

    def __init__(self, session, parameters: Optional[Mapping[str, Any]] = None):
        self.session = session
        self.parameters: Dict[str, Any] = dict(parameters or {})
        # per-operator wall-clock + row counts, filled as ops evaluate
        # (SURVEY.md §5.1 — the structured analog of the Spark UI stage view)
        self.op_metrics: List[Dict[str, Any]] = []
        # plan-node id sequence: operators draw a stable id at
        # CONSTRUCTION (planner order is deterministic per query)
        self.op_seq = itertools.count()
        # the session tracer, cached so the per-operator hot path pays
        # one attribute read
        self.tracer = getattr(session, "tracer", None)

    def rebind(self, parameters: Mapping[str, Any]) -> None:
        """Swap in fresh parameter bindings for a cached-plan
        re-execution: operators hold a reference to THIS context, so an
        in-place update reaches every ``_compute``; per-run operator
        metrics start fresh (the previous run's list stays owned by the
        result that captured it)."""
        self.parameters.clear()
        self.parameters.update(parameters)
        self.op_metrics = []

    @property
    def factory(self):
        return self.session.table_factory


def resolve_expr(expr: E.Expr, header: RecordHeader) -> E.Expr:
    """Normalize an expression against a header so backends only ever see
    resolvable expressions:

      * ``HasLabel`` on a var whose header lacks that label column → false
        (the label cannot occur there);
      * ``HasType(r, T)`` → ``Type(r) = 'T'``;
      * ``Property`` on an entity var whose header lacks the column → null.

    The walk is scope-aware: a comprehension / quantifier / reduce variable
    that shadows a header entity var must NOT have its property reads
    rewritten against the outer header."""
    entity_vars = set(header.entity_vars)

    def rw(n: E.Expr, bound: frozenset) -> E.Expr:
        if isinstance(n, E.ListComprehension):
            inner = bound | {n.var}
            return dataclasses.replace(
                n, list_expr=rw(n.list_expr, bound),
                predicate=(rw(n.predicate, inner)
                           if n.predicate is not None else None),
                projection=(rw(n.projection, inner)
                            if n.projection is not None else None))
        if isinstance(n, E.QuantifiedPredicate):
            return dataclasses.replace(
                n, list_expr=rw(n.list_expr, bound),
                predicate=rw(n.predicate, bound | {n.var}))
        if isinstance(n, E.Reduce):
            return dataclasses.replace(
                n, init=rw(n.init, bound),
                list_expr=rw(n.list_expr, bound),
                expr=rw(n.expr, bound | {n.acc, n.var}))
        n = n.map_children(lambda c: rw(c, bound))
        if isinstance(n, E.HasLabel) and isinstance(n.node, E.Var) \
                and n.node.name not in bound \
                and n.node.name in entity_vars and not header.has(n):
            return E.Lit(False)
        if isinstance(n, E.HasType) and isinstance(n.rel, E.Var) \
                and n.rel.name not in bound:
            return E.Equals(E.Type(n.rel), E.Lit(n.rel_type))
        if isinstance(n, E.Property) and isinstance(n.entity, E.Var) \
                and n.entity.name not in bound \
                and n.entity.name in entity_vars and not header.has(n):
            return E.Lit(None)
        return n

    return rw(expr, frozenset())


def host_eval(expr: E.Expr, parameters: Mapping[str, Any]) -> Any:
    """Evaluate a host-side expression (SKIP/LIMIT counts etc.)."""
    if isinstance(expr, E.Lit):
        return expr.value
    if isinstance(expr, E.Param):
        if expr.name not in parameters:
            raise KeyError(f"missing parameter ${expr.name}")
        return parameters[expr.name]
    if isinstance(expr, E.Negate):
        return -host_eval(expr.expr, parameters)
    raise ValueError(f"expression {expr!r} must be a literal or parameter")


class RelationalOperator(abc.ABC):
    """Base: caches the computed (header, table) pair in ``_result``
    (cleared by ``plan_cache.reset_plan`` before a cached tree
    re-executes)."""

    def __init__(self, context: RelationalRuntimeContext,
                 children: Sequence["RelationalOperator"] = ()):
        self.context = context
        self.children = tuple(children)
        self._result: Optional[Tuple[RecordHeader, Table]] = None
        # snapshot of the planner's graph-scoped entity context at THIS
        # op's planning time (multi-graph correctness — see EntityContext)
        self.entity_ctx: Optional[EntityContext] = getattr(
            context, "entity_ctx", None)
        # stable per-plan node id (-1 under bare mock contexts)
        seq = getattr(context, "op_seq", None)
        self.op_id: int = next(seq) if seq is not None else -1

    @property
    def parameters(self) -> Dict[str, Any]:
        """Query parameters plus this op's entity-context snapshot under
        the reserved key (backends pop it before parameter lookup)."""
        if self.entity_ctx is None:
            return self.context.parameters
        p = dict(self.context.parameters)
        p[ENTITY_CTX_PARAM] = self.entity_ctx
        return p

    @abc.abstractmethod
    def _compute(self) -> Tuple[RecordHeader, Table]:
        ...

    @property
    def result(self) -> Tuple[RecordHeader, Table]:
        if self._result is None:
            # Cooperative cancel/deadline boundary (serve/deadline.py): a
            # served request with an expired budget stops HERE, before
            # the next operator computes — one thread-local read when no
            # scope is installed, and no synchronizing call
            _cancel_checkpoint("execute")
            name = type(self).__name__.removesuffix("Op")
            tracer = self.context.tracer
            traced = tracer is not None and tracer.enabled
            tr_span = (tracer.span(f"op.{name}", kind="operator")
                       if traced else nullcontext())
            t0 = clock.now()
            device_s: Optional[float] = None
            with tr_span as sp:
                # a named range on the card's timeline, opened only
                # while torch.profiler records (the C-level check costs
                # nothing otherwise)
                prof_range = (torch.profiler.record_function(
                    f"caps_tpu_torch.{name}")
                    if torch.autograd._profiler_enabled() else nullcontext())
                with prof_range:
                    try:
                        self._result = self._compute()
                    except _CancellationError:
                        raise  # budget expiry, not an operator failure
                    except Exception as ex:
                        # only the op that ACTUALLY failed reports; the
                        # ancestors it unwinds through (parents evaluate
                        # children lazily inside their own _compute)
                        # must not re-count it
                        if getattr(ex, "caps_failed_op", None) is None:
                            self._propagate_error(ex, name, tracer)
                        raise
                if traced and tracer.sync_device:
                    # PROFILE per-op device mode: wait for the card so
                    # this span's time includes the operator's device
                    # work (torch.cuda.synchronize; a no-op on the CPU)
                    self._result[1].device_sync()
                    device_s = clock.now() - t0
            evaluated = [c for c in self.children if c._result is not None]
            bytes_in = (sum(c.table.nbytes for c in evaluated) if evaluated
                        else self._result[1].nbytes)
            if device_s is not None:
                # PROFILE per-op mode: exact cardinality, not a served
                # bound (free in eager/exact-replay mode; one counted
                # read per op under generic replay)
                rows = self._result[1].exact_size()
            else:
                rows = self._result[1].size
            entry = {
                "op": name,
                "op_id": self.op_id,
                "seconds": clock.now() - t0,
                "rows": rows,
                "bytes_in": bytes_in,
                # operator-specific keys (e.g. the pushdown and
                # var-expand "strategy", a closure's own "bytes_in")
                **getattr(self, "_metric_extra", {}),
            }
            if device_s is not None:
                entry["device_s"] = device_s
            # cost-model estimate (relational/cost.py annotate_plan):
            # ride the entry so the observed-statistics store measures
            # model error, not drift from its own running mean
            est = getattr(self, "est_rows", None)
            if est is not None:
                entry["est_rows"] = int(est)
            self.context.op_metrics.append(entry)
            # run-stamped measurement for PROFILE (obs/profile.py): the
            # op_metrics LIST identity tags which run the entry belongs
            # to — rebind() swaps in a fresh list, so stale stamps from
            # an earlier cached-plan execution are detectable
            self._last_metrics = (self.context.op_metrics, entry)
            if sp is not None:  # nullcontext (tracing off) yields None
                sp.annotate(rows=entry["rows"], bytes=bytes_in,
                            device_s=device_s)
        return self._result

    def _propagate_error(self, ex: Exception, name: str, tracer) -> None:
        """Failure telemetry for one operator failure: an ``op.error``
        trace event, an ``ops.errors`` counter tick, and the failing
        operator stamped on the exception.  The caller gates on the
        stamp being absent, so the report fires once per failure — at
        the operator that raised, not at every ancestor it unwound
        through."""
        try:
            if tracer is not None and tracer.enabled:
                tracer.event("op.error", kind="event", op=name,
                             error=type(ex).__name__)
            registry = getattr(self.context.session, "metrics_registry",
                               None)
            if registry is not None:
                registry.counter("ops.errors").inc()
            if getattr(ex, "caps_failed_op", None) is None:
                ex.caps_failed_op = name
        except Exception:  # pragma: no cover — telemetry must not mask
            pass

    @property
    def header(self) -> RecordHeader:
        return self.result[0]

    @property
    def table(self) -> Table:
        return self.result[1]

    def pretty(self, depth: int = 0) -> str:
        label = type(self).__name__.removesuffix("Op")
        extra = self._pretty_args()
        est = getattr(self, "est_rows", None)
        suffix = ""
        if est is not None:
            # estimated-vs-chosen in EXPLAIN: the cost model's row
            # estimate (src: model prior or observed calibration)
            src = getattr(self, "est_source", "model")
            suffix = f"  ~rows={est} ({src})"
        lines = [("    " * depth) + ("└─" if depth else "") + label
                 + (f"({extra})" if extra else "") + suffix]
        for c in self.children:
            lines.append(c.pretty(depth + 1))
        return "\n".join(lines)

    def _pretty_args(self) -> str:
        return ""


class StartOp(RelationalOperator):
    """A single empty driving row (or an externally supplied driving table)."""

    def __init__(self, context, header: Optional[RecordHeader] = None,
                 table: Optional[Table] = None):
        super().__init__(context)
        self._start_header = header or RecordHeader.empty()
        self._start_table = table

    def _compute(self):
        t = self._start_table if self._start_table is not None \
            else self.context.factory.unit()
        return self._start_header, t


class ScanOp(RelationalOperator):
    """Aligned union of entity tables for one var (ref: ``scanOperator``)."""

    def __init__(self, context, graph, var: str, entity_type: CypherType):
        super().__init__(context)
        self.graph = graph
        self.var = var
        self.entity_type = entity_type

    def _compute(self):
        m = self.entity_type.material
        if isinstance(m, _CTNode):
            return self.graph.scan_node(self.var, m.labels)
        if isinstance(m, _CTRelationship):
            return self.graph.scan_rel(self.var, m.rel_types)
        raise TypeError(f"cannot scan entity type {self.entity_type!r}")

    def _pretty_args(self):
        return f"{self.var}: {self.entity_type!r}"


class FilterOp(RelationalOperator):
    def __init__(self, context, parent: RelationalOperator, predicate: E.Expr):
        super().__init__(context, [parent])
        self.predicate = predicate

    def _compute(self):
        header, table = self.children[0].result
        pred = resolve_expr(self.predicate, header)
        return header, table.filter(pred, header, self.parameters)

    def _pretty_args(self):
        return self.predicate.cypher_repr()


class SelectOp(RelationalOperator):
    """Narrow to the expressions owned by the given vars."""

    def __init__(self, context, parent: RelationalOperator,
                 names: Sequence[str]):
        super().__init__(context, [parent])
        self.names = tuple(names)

    def _compute(self):
        header, table = self.children[0].result
        out_header = header.select_vars(self.names)
        return out_header, table.select(list(out_header.columns))

    def _pretty_args(self):
        return ", ".join(self.names)


class ProjectOp(RelationalOperator):
    """Add computed/aliased columns; overwriting an existing var drops its
    old columns first (computed via temporaries to avoid clobbering inputs
    still referenced by later items)."""

    def __init__(self, context, parent: RelationalOperator,
                 items: Sequence[Tuple[str, E.Expr, CypherType]]):
        super().__init__(context, [parent])
        self.items = tuple(items)

    def _compute(self):
        header, table = self.children[0].result
        params = self.parameters
        overwritten = [name for name, expr, _ in self.items
                       if name in set(header.vars) and expr != E.Var(name)]
        pending_renames: Dict[str, str] = {}
        new_entries: List[Tuple[E.Expr, str, CypherType]] = []

        for name, expr, ctype in self.items:
            target = name
            tmp_prefix = f"__new__{name}" if name in overwritten else name
            if isinstance(expr, E.Var) and expr.name in header.composite_vars:
                # entity/path alias: copy all owned columns under the new
                # prefix (paths own __start/__seg*/__node* columns)
                src = expr.name
                sub = header.select_vars([src])
                copied = set()
                for e in sub.exprs:
                    old_col = sub.column(e)
                    suffix = old_col[len(src):]  # '__id', '__prop_x', ...
                    new_col = f"{tmp_prefix}{suffix}"
                    if old_col not in copied:
                        table = table.copy_column(old_col, new_col)
                        copied.add(old_col)
                    ne = e.transform_down(
                        lambda n: E.Var(target) if n == E.Var(src) else n)
                    final_col = f"{target}{suffix}"
                    if new_col != final_col:
                        pending_renames[new_col] = final_col
                    t = ctype if e == E.Var(src) else sub.type_of(e)
                    new_entries.append((ne, final_col, t))
            elif isinstance(expr, E.PathExpr):
                # reify a named path: path-owned copies of the constituent
                # id columns — start node id + one column per hop (rel id,
                # or rel-id list for var-length segments); fixed-length
                # paths also pin per-position node ids for nodes(p)
                pv = E.Var(target)
                fixed = not any(expr.varlen)

                def path_col(src_expr, suffix, entry_expr, etype):
                    nonlocal table
                    tmp_col = f"{tmp_prefix}{suffix}"
                    table = table.copy_column(header.column(src_expr), tmp_col)
                    final_col = f"{target}{suffix}"
                    if tmp_col != final_col:
                        pending_renames[tmp_col] = final_col
                    new_entries.append((entry_expr, final_col, etype))
                    return final_col

                start_col = path_col(expr.nodes[0], "__start", pv, ctype)
                if fixed:
                    new_entries.append((E.PathNode(pv, 0), start_col,
                                        header.type_of(expr.nodes[0])))
                for i, (rexpr, vl) in enumerate(zip(expr.rels, expr.varlen)):
                    path_col(rexpr, f"__seg{i}", E.PathSeg(pv, i, vl),
                             header.type_of(rexpr))
                if fixed:
                    for i, nexpr in enumerate(expr.nodes[1:], start=1):
                        path_col(nexpr, f"__node{i}", E.PathNode(pv, i),
                                 header.type_of(nexpr))
            else:
                resolved = resolve_expr(expr, header)
                if isinstance(resolved, E.Var) and resolved.name in header.vars:
                    table = table.copy_column(header.column(resolved), tmp_prefix)
                else:
                    table = table.with_column(tmp_prefix, resolved, header,
                                              params, ctype)
                if tmp_prefix != target:
                    pending_renames[tmp_prefix] = target
                new_entries.append((E.Var(target), target, ctype))

        if overwritten:
            drop_cols = set()
            keep_entries = []
            for e, c, t in zip(header.exprs, (header.column(x) for x in header.exprs),
                               (header.type_of(x) for x in header.exprs)):
                owners = {v.name for v in E.vars_in(e)}
                if owners & set(overwritten):
                    drop_cols.add(c)
                else:
                    keep_entries.append((e, c, t))
            keep_cols = [c for c in table.columns
                         if c not in drop_cols]
            table = table.select(keep_cols)
            if pending_renames:
                table = table.rename(pending_renames)
            base_entries = keep_entries
        else:
            base_entries = [(e, header.column(e), header.type_of(e))
                            for e in header.exprs]
        out_entries = base_entries + [
            (e, c, t) for e, c, t in new_entries
            if all(e != be[0] for be in base_entries)]
        return RecordHeader(out_entries), table

    def _pretty_args(self):
        return ", ".join(f"{e.cypher_repr()} AS {n}" for n, e, _ in self.items)


class JoinOp(RelationalOperator):
    def __init__(self, context, lhs: RelationalOperator, rhs: RelationalOperator,
                 pairs: Sequence[Tuple[E.Expr, E.Expr]], how: str = "inner"):
        super().__init__(context, [lhs, rhs])
        self.pairs = tuple(pairs)
        self.how = how

    def _compute(self):
        lh, lt = self.children[0].result
        rh, rt = self.children[1].result
        col_pairs = [(lh.column(le), rh.column(re)) for le, re in self.pairs]
        out_header = lh.concat(rh)
        return out_header, lt.join(rt, self.how, col_pairs)

    def _pretty_args(self):
        conds = ", ".join(f"{l.cypher_repr()}={r.cypher_repr()}"
                          for l, r in self.pairs)
        return f"{self.how}: {conds}"


class CrossOp(RelationalOperator):
    def __init__(self, context, lhs, rhs):
        super().__init__(context, [lhs, rhs])

    def _compute(self):
        lh, lt = self.children[0].result
        rh, rt = self.children[1].result
        return lh.concat(rh), lt.join(rt, "cross", [])


class UnionAllOp(RelationalOperator):
    def __init__(self, context, lhs, rhs):
        super().__init__(context, [lhs, rhs])

    def _compute(self):
        lh, lt = self.children[0].result
        rh, rt = self.children[1].result
        target = lh.union_target(rh)

        def align(h: RecordHeader, t: Table) -> Table:
            for e in target.exprs:
                col = target.column(e)
                if col not in t.columns:
                    default = False if isinstance(e, E.HasLabel) else None
                    t = t.with_literal_column(col, default, target.type_of(e))
            return t.select(list(target.columns))

        return target, align(lh, lt).union_all(align(rh, rt))


class ExistsJoinOp(RelationalOperator):
    """Row-id semi-join implementing EXISTS subqueries: lhs (tagged with a
    row index) keeps every row exactly once; the nullable boolean
    ``marker`` var is true where the subquery side produced at least one
    row for that row id, null otherwise (ref: okapi-relational planning of
    ExistsSubQuery — reconstructed; SURVEY.md §2)."""

    def __init__(self, context, lhs_tagged: RelationalOperator,
                 rhs: RelationalOperator, rid_col: str, marker: str):
        super().__init__(context, [lhs_tagged, rhs])
        self.rid_col = rid_col
        self.marker = marker

    def _compute(self):
        lh, lt = self.children[0].result
        rh, rt = self.children[1].result
        mcol = rh.column(E.Var(self.marker))
        rid_right = f"__ex_{self.rid_col}"
        rsel = rt.select([self.rid_col, mcol]).distinct() \
            .rename({self.rid_col: rid_right})
        joined = lt.join(rsel, "left", [(self.rid_col, rid_right)])
        out_entries = [(e, lh.column(e), lh.type_of(e)) for e in lh.exprs
                       if e != E.Var(self.rid_col)] \
            + [(E.Var(self.marker), mcol, CTBoolean.nullable)]
        out_header = RecordHeader(out_entries)
        return out_header, joined.select(list(out_header.columns))

    def _pretty_args(self):
        return self.marker


class DistinctOp(RelationalOperator):
    def __init__(self, context, parent):
        super().__init__(context, [parent])

    def _compute(self):
        header, table = self.children[0].result
        return header, table.distinct()


class AggregateOp(RelationalOperator):
    _KINDS = {
        E.Count: "count", E.Sum: "sum", E.Avg: "avg", E.Min: "min",
        E.Max: "max", E.Collect: "collect", E.StDev: "stdev",
        E.PercentileCont: "percentile_cont", E.PercentileDisc: "percentile_disc",
    }

    def __init__(self, context, parent,
                 group: Sequence[Tuple[str, E.Expr, CypherType]],
                 aggregations: Sequence[Tuple[str, E.Aggregator, CypherType]]):
        super().__init__(context, [parent])
        self.group = tuple(group)
        self.aggregations = tuple(aggregations)

    def _compute(self):
        header, table = self.children[0].result
        params = self.parameters

        by_cols: List[str] = []
        out_entries: List[Tuple[E.Expr, str, CypherType]] = []
        first_specs: List[AggSpec] = []
        renames: Dict[str, str] = {}

        for name, expr, ctype in self.group:
            if isinstance(expr, E.Var) and expr.name in header.entity_vars:
                src = expr.name
                sub = header.select_vars([src])
                id_col = sub.column(E.Var(src))
                by_cols.append(id_col)
                for e in sub.exprs:
                    old_col = sub.column(e)
                    suffix = old_col[len(src):]
                    new_col = f"{name}{suffix}"
                    ne = e.transform_down(
                        lambda n: E.Var(name) if n == E.Var(src) else n)
                    t = ctype if e == E.Var(src) else sub.type_of(e)
                    if old_col == id_col:
                        renames[old_col] = new_col
                    else:
                        first_specs.append(AggSpec(new_col, "first", old_col,
                                                   result_type=t))
                    out_entries.append((ne, new_col, t))
            elif isinstance(expr, E.Var) and expr.name in header.composite_vars:
                # path var: path identity = the full column tuple (start id
                # + every hop id column), so group by all of them
                src = expr.name
                sub = header.select_vars([src])
                for e in sub.exprs:
                    old_col = sub.column(e)
                    suffix = old_col[len(src):]
                    new_col = f"{name}{suffix}"
                    ne = e.transform_down(
                        lambda n: E.Var(name) if n == E.Var(src) else n)
                    t = ctype if e == E.Var(src) else sub.type_of(e)
                    if old_col not in by_cols:
                        by_cols.append(old_col)
                        renames[old_col] = new_col
                    out_entries.append((ne, new_col, t))
            else:
                resolved = resolve_expr(expr, header)
                col = f"__group__{name}"
                table = table.with_column(col, resolved, header, params, ctype)
                by_cols.append(col)
                renames[col] = name
                out_entries.append((E.Var(name), name, ctype))

        agg_specs: List[AggSpec] = []
        for name, agg, ctype in self.aggregations:
            if isinstance(agg, E.CountStar):
                agg_specs.append(AggSpec(name, "count_star", result_type=ctype))
                out_entries.append((E.Var(name), name, ctype))
                continue
            inner = resolve_expr(agg.expr, header)
            in_col = f"__agg_in__{name}"
            in_type = header.type_of(inner) if header.has(inner) else ctype
            table = table.with_column(in_col, inner, header, params, in_type)
            kind = self._KINDS[type(agg)]
            distinct = bool(getattr(agg, "distinct", False))
            pct = None
            if isinstance(agg, (E.PercentileCont, E.PercentileDisc)):
                pct = host_eval(agg.percentile, params)
            agg_specs.append(AggSpec(name, kind, in_col, distinct, pct, ctype))
            out_entries.append((E.Var(name), name, ctype))

        grouped = table.group(by_cols, tuple(first_specs) + tuple(agg_specs))
        if renames:
            grouped = grouped.rename(renames)
        out_header = RecordHeader(out_entries)
        return out_header, grouped.select(list(out_header.columns))

    def _pretty_args(self):
        g = ", ".join(n for n, _, _ in self.group)
        a = ", ".join(f"{agg.cypher_repr()} AS {n}" for n, agg, _ in self.aggregations)
        return f"group=[{g}] aggs=[{a}]"


class OrderByOp(RelationalOperator):
    def __init__(self, context, parent, items: Sequence[Tuple[E.Expr, bool]]):
        super().__init__(context, [parent])
        self.items = tuple(items)

    def _compute(self):
        header, table = self.children[0].result
        params = self.parameters
        sort_cols: List[Tuple[str, bool]] = []
        temp_cols: List[str] = []
        for i, (expr, asc) in enumerate(self.items):
            resolved = resolve_expr(expr, header)
            if header.has(resolved):
                sort_cols.append((header.column(resolved), asc))
            else:
                col = f"__sort__{i}"
                from caps_tpu_torch.okapi.types import CTAny
                table = table.with_column(col, resolved, header, params, CTAny)
                temp_cols.append(col)
                sort_cols.append((col, asc))
        table = table.order_by(sort_cols)
        if temp_cols:
            table = table.select([c for c in table.columns if c not in temp_cols])
        return header, table


def _slice_count(expr: E.Expr, parameters, what: str) -> int:
    """SKIP/LIMIT operand: openCypher requires a non-negative integer
    (negative literals are a SyntaxError upstream; parameters make it a
    runtime check here)."""
    n = int(host_eval(expr, parameters))
    if n < 0:
        raise ValueError(f"{what} must be a non-negative integer, got {n}")
    return n


class SkipOp(RelationalOperator):
    def __init__(self, context, parent, expr: E.Expr):
        super().__init__(context, [parent])
        self.expr = expr

    def _compute(self):
        header, table = self.children[0].result
        return header, table.skip(
            _slice_count(self.expr, self.context.parameters, "SKIP"))


class LimitOp(RelationalOperator):
    def __init__(self, context, parent, expr: E.Expr):
        super().__init__(context, [parent])
        self.expr = expr

    def _compute(self):
        header, table = self.children[0].result
        return header, table.limit(
            _slice_count(self.expr, self.context.parameters, "LIMIT"))


class UnwindOp(RelationalOperator):
    def __init__(self, context, parent, list_expr: E.Expr, var: str,
                 inner_type: CypherType):
        super().__init__(context, [parent])
        self.list_expr = list_expr
        self.var = var
        self.inner_type = inner_type

    def _compute(self):
        header, table = self.children[0].result
        params = self.parameters
        resolved = resolve_expr(self.list_expr, header)
        tmp = f"__unwind__{self.var}"
        from caps_tpu_torch.okapi.types import CTAny, CTList
        table = table.with_column(tmp, resolved, header, params,
                                  CTList(self.inner_type))
        table = table.explode(tmp, self.var, self.inner_type)
        out_header = header.with_expr(E.Var(self.var), self.inner_type,
                                      column=self.var)
        return out_header, table.select(list(out_header.columns))


class RowIndexOp(RelationalOperator):
    def __init__(self, context, parent, col: str):
        super().__init__(context, [parent])
        self.col = col

    def _compute(self):
        header, table = self.children[0].result
        out = header.with_expr(E.Var(self.col), CTInteger, column=self.col)
        return out, table.with_row_index(self.col)


class OptionalJoinOp(RelationalOperator):
    """Left outer join of lhs (tagged with a row index) against the planned
    optional side, implementing OPTIONAL MATCH."""

    def __init__(self, context, lhs_tagged: RelationalOperator,
                 rhs: RelationalOperator, rid_col: str):
        super().__init__(context, [lhs_tagged, rhs])
        self.rid_col = rid_col

    def _compute(self):
        lh, lt = self.children[0].result
        rh, rt = self.children[1].result
        lhs_cols = set(lt.columns)
        # Right side: row id + columns new in rhs.
        new_entries = [(e, rh.column(e), rh.type_of(e).nullable)
                       for e in rh.exprs
                       if not lh.has(e) and e != E.Var(self.rid_col)]
        if self.rid_col not in rt.columns:
            # The optional pattern shares no variable with the lhs (e.g. a
            # leading OPTIONAL MATCH over the unit driving row), so it
            # never consumed the tagged rows: OPTIONAL MATCH then pairs
            # every lhs row with every rhs row, or null-pads when the
            # pattern found nothing (openCypher).
            out_header = RecordHeader(
                [(e, lh.column(e), lh.type_of(e)) for e in lh.exprs
                 if e != E.Var(self.rid_col)] + new_entries)
            new_cols = [c for _, c, _ in new_entries if c not in lhs_cols]
            if rt.branch_empty():
                out = lt
                for e, c, t in new_entries:
                    if c not in lhs_cols:
                        out = out.with_literal_column(c, None, t)
            else:
                out = lt.join(rt.select(list(dict.fromkeys(new_cols))),
                              "cross", [])
            keep = [c for c in out.columns if c != self.rid_col]
            return out_header, out.select(keep).select(
                list(out_header.columns))
        rid_right = f"__opt_{self.rid_col}"
        sel_cols = [self.rid_col] + [c for _, c, _ in new_entries
                                     if c not in lhs_cols]
        rsel = rt.select(list(dict.fromkeys(sel_cols)))
        rsel = rsel.rename({self.rid_col: rid_right})
        joined = lt.join(rsel, "left", [(self.rid_col, rid_right)])
        # Drop the row-id bookkeeping columns.
        keep = [c for c in joined.columns if c not in (self.rid_col, rid_right)]
        out_entries = [(e, lh.column(e), lh.type_of(e)) for e in lh.exprs
                       if e != E.Var(self.rid_col)] + new_entries
        out_header = RecordHeader(out_entries)
        return out_header, joined.select(keep).select(list(out_header.columns))
