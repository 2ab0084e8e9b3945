"""Backend-generic session orchestration: the parse → IR → logical →
relational → execute pipeline, result records, and entity materialization.

Mirrors the reference's ``RelationalCypherSession`` / ``RelationalCypherRecords``
(ref: okapi-relational/.../relational/api/ — reconstructed, mount empty;
SURVEY.md §2, §3.1).  Repeated queries are served from the prepared-
statement plan cache (relational/plan_cache.py).  Plans are priced by the
cost model (relational/cost.py) over the graph's statistics
(relational/stats.py), each execution's operator rows feed the
observed-statistics store (obs/telemetry.py), and a family whose rows
keep diverging from the model's estimates re-plans (``_maybe_replan``).
Queries run under the session tracer (phase and operator spans, EXPLAIN
and PROFILE — obs/), and CREATE / SET / DELETE commit through a
versioned graph (relational/updates.py).  A served request's deadline
is checked at the phase boundaries (``serve/deadline.py checkpoint``):
after parse, after planning, at every operator, after execution; the
checks read the host clock only, so kernels a request already queued on
the card still run after it is cancelled.  The serving tier's hooks are
here too: ``clone`` (a replica session), ``cypher_batch`` (a
micro-batch), the snapshot-keyed result cache's read sites, and the
warm-path bindings the plan store persists.
"""
from __future__ import annotations

import abc
import contextlib
import hashlib
import json
import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

logger = logging.getLogger("caps_tpu_torch")

from caps_tpu_torch import obs
from caps_tpu_torch._unported import not_ported
from caps_tpu_torch.frontend.parser import (
    normalize_query, parse_query, query_mode,
)
from caps_tpu_torch.ir import blocks as B
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.builder import IRBuilder
from caps_tpu_torch.logical.optimizer import LogicalOptimizer
from caps_tpu_torch.logical.planner import LogicalPlanner
from caps_tpu_torch.obs import clock
from caps_tpu_torch.okapi.catalog import CypherCatalog
from caps_tpu_torch.okapi.config import DEFAULT_CONFIG, EngineConfig
from caps_tpu_torch.okapi.graph import (
    CypherRecords, CypherResult, CypherSession, QualifiedGraphName,
)
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    _CTList, _CTNode, _CTPath, _CTRelationship,
)
from caps_tpu_torch.okapi.values import CypherNode, CypherPath, CypherRelationship
from caps_tpu_torch.relational import ops as R
from caps_tpu_torch.relational.graphs import EmptyGraph, RelationalCypherGraph, ScanGraph
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.plan_cache import (
    CachedPlan, PlanCache, PlanParams, PreparedQuery, _plan_nbytes,
    graph_plan_token, param_signature, reset_plan,
)
from caps_tpu_torch.relational.planner import RelationalPlanner
from caps_tpu_torch.relational.shapes import ShapeBucketLattice
from caps_tpu_torch.relational.table import Table, TableFactory
from caps_tpu_torch.relational.updates import (
    UpdateError, VersionedGraph, describe_plan, is_update_query,
    is_update_statement, plan_update, stage_rows,
)
from caps_tpu_torch.serve.deadline import cancel_scope, checkpoint


class NondeterministicResultError(RuntimeError):
    """Raised by the determinism check (EngineConfig.determinism_check)
    when a replayed query yields a different result multiset."""


# -- degraded execution (failure containment) --------------------------------
#
# When shared cached state is suspect (a quarantined plan entry, a poisoned
# fused memo), a query can re-execute in a degraded mode that provably
# avoids that state: ``no_plan_cache`` bypasses the session plan cache in
# BOTH directions (no lookup, no store — a degraded run must not mutate
# shared state), ``no_fused`` additionally forces per-operator eager
# execution on backends with a fused record/replay executor.  The flags
# are per-THREAD: one thread's degraded re-execution must not strip
# another thread's fast path.

_degraded_tls = threading.local()


def degraded_state() -> Tuple[bool, bool]:
    """(no_plan_cache, no_fused) for the calling thread."""
    return (getattr(_degraded_tls, "no_plan_cache", False),
            getattr(_degraded_tls, "no_fused", False))


@contextlib.contextmanager
def degraded_execution(no_plan_cache: bool = True,
                       no_fused: bool = False) -> Iterator[None]:
    """Run queries on this thread in a degraded mode (see above).
    Nests by OR-ing: an unfused region inside a replan region stays
    unfused."""
    prev = degraded_state()
    _degraded_tls.no_plan_cache = prev[0] or no_plan_cache
    _degraded_tls.no_fused = prev[1] or no_fused
    try:
        yield
    finally:
        _degraded_tls.no_plan_cache, _degraded_tls.no_fused = prev


def result_digest(result: "CypherResult") -> str:
    """Order-insensitive sha256 of a result's rows (multiset digest):
    per-row digests are sorted before hashing, so any valid row order
    yields the same digest."""
    rows = result.to_maps()
    row_digests = sorted(
        hashlib.sha256(repr(sorted(r.items())).encode()).hexdigest()
        for r in rows)
    return hashlib.sha256("".join(row_digests).encode()).hexdigest()


class RelationalCypherRecords(CypherRecords):
    def __init__(self, session: "RelationalCypherSession", header: RecordHeader,
                 table: Table, columns: Tuple[str, ...],
                 graph: Optional[RelationalCypherGraph] = None):
        self._session = session
        self._header = header
        self._table = table
        self._columns = tuple(columns)
        self._graph = graph

    @property
    def columns(self) -> Tuple[str, ...]:
        return self._columns

    @property
    def header(self) -> RecordHeader:
        return self._header

    @property
    def table(self) -> Table:
        return self._table

    def size(self) -> int:
        return self._table.exact_size()

    # -- materialization ----------------------------------------------------

    def to_maps(self) -> List[Dict[str, Any]]:
        header, table = self._header, self._table
        n = table.exact_size()
        out: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name in self._columns:
            values = self._materialize_var(name, header, table, n)
            for i in range(n):
                out[i][name] = values[i]
        return out

    def _materialize_var(self, name: str, header: RecordHeader, table: Table,
                         n: int) -> List[Any]:
        var = E.Var(name)
        t = header.type_of(var).material
        if isinstance(t, _CTNode):
            return self._materialize_nodes(name, header, table, n)
        if isinstance(t, _CTRelationship):
            return self._materialize_rels(name, header, table, n)
        if isinstance(t, _CTList) and isinstance(t.inner.material,
                                                 _CTRelationship):
            ids_list = table.column_values(header.column(var))
            lookup = self._rel_lookup()
            return [None if ids is None else
                    [self._rel_from_lookup(i, lookup) for i in ids]
                    for ids in ids_list]
        if isinstance(t, _CTList) and isinstance(t.inner.material, _CTNode):
            ids_list = table.column_values(header.column(var))
            lookup = self._node_lookup()
            return [None if ids is None else
                    [self._node_from_lookup(i, lookup) for i in ids]
                    for ids in ids_list]
        if isinstance(t, _CTPath):
            return self._materialize_paths(name, header, table, n)
        return table.column_values(header.column(var))

    def _materialize_nodes(self, name, header, table, n) -> List[Any]:
        var = E.Var(name)
        ids = table.column_values(header.column(var))
        label_cols = []
        prop_cols = []
        for e in header.exprs:
            if isinstance(e, E.HasLabel) and e.node == var:
                label_cols.append((e.label, table.column_values(header.column(e))))
            elif isinstance(e, E.Property) and e.entity == var:
                prop_cols.append((e.key, table.column_values(header.column(e))))
        if not label_cols and not prop_cols:
            # bare id column (e.g. an indexed element of nodes(p)): fill
            # labels/properties from the graph's host-side lookup
            lookup = self._node_lookup()
            return [None if i is None else self._node_from_lookup(i, lookup)
                    for i in ids]
        out = []
        for i in range(n):
            if ids[i] is None:
                out.append(None)
                continue
            labels = tuple(lbl for lbl, col in label_cols if col[i] is True)
            props = {k: col[i] for k, col in prop_cols if col[i] is not None}
            out.append(CypherNode(ids[i], labels, props))
        return out

    def _materialize_rels(self, name, header, table, n) -> List[Any]:
        var = E.Var(name)
        ids = table.column_values(header.column(var))
        if not header.has(E.StartNode(var)):
            # bare rel-id column (e.g. an indexed element of
            # relationships(p)): materialize via the graph lookup
            lookup = self._rel_lookup()
            return [None if i is None else self._rel_from_lookup(i, lookup)
                    for i in ids]
        srcs = table.column_values(header.column(E.StartNode(var)))
        tgts = table.column_values(header.column(E.EndNode(var)))
        types = table.column_values(header.column(E.Type(var)))
        prop_cols = []
        for e in header.exprs:
            if isinstance(e, E.Property) and e.entity == var:
                prop_cols.append((e.key, table.column_values(header.column(e))))
        out = []
        for i in range(n):
            if ids[i] is None:
                out.append(None)
                continue
            props = {k: col[i] for k, col in prop_cols if col[i] is not None}
            out.append(CypherRelationship(ids[i], srcs[i], tgts[i],
                                          types[i] or "", props))
        return out

    def _materialize_paths(self, name, header, table, n) -> List[Any]:
        """Assemble path values: start node id + per-hop rel id columns,
        walking each hop's stored endpoints to find the next node
        (direction-agnostic: next = the endpoint that isn't current,
        which also handles undirected matches and self-loops)."""
        var = E.Var(name)
        starts = table.column_values(header.column(var))
        segs = sorted(
            ((e.index, e.is_varlen, table.column_values(header.column(e)))
             for e in header.exprs
             if isinstance(e, E.PathSeg) and e.path == var),
            key=lambda s: s[0])
        rel_lk = self._rel_lookup()
        node_lk = self._node_lookup()
        out: List[Any] = []
        for i in range(n):
            if starts[i] is None:
                out.append(None)
                continue
            cur = starts[i]
            nodes = [self._node_from_lookup(cur, node_lk)]
            rels: List[CypherRelationship] = []
            dead = False
            for _, is_varlen, col in segs:
                cell = col[i]
                if cell is None:
                    dead = True  # null hop (optional path): whole path null
                    break
                for rid in (cell if is_varlen else [cell]):
                    rel = self._rel_from_lookup(rid, rel_lk)
                    rels.append(rel)
                    cur = rel.end if rel.start == cur else rel.start
                    nodes.append(self._node_from_lookup(cur, node_lk))
            out.append(None if dead else CypherPath(tuple(nodes), tuple(rels)))
        return out

    def _rel_lookup(self) -> Dict[int, Tuple[int, int, str, Dict[str, Any]]]:
        if self._graph is None:
            return {}
        return self._graph.rel_lookup()

    def _node_lookup(self) -> Dict[int, Tuple[Tuple[str, ...], Dict[str, Any]]]:
        if self._graph is None:
            return {}
        return self._graph.node_lookup()

    def _node_from_lookup(self, nid, lookup) -> CypherNode:
        if nid in lookup:
            labels, props = lookup[nid]
            return CypherNode(nid, labels, props)
        return CypherNode(nid)

    def _rel_from_lookup(self, rid, lookup) -> CypherRelationship:
        if rid in lookup:
            src, tgt, typ, props = lookup[rid]
            return CypherRelationship(rid, src, tgt, typ, props)
        return CypherRelationship(rid, -1, -1, "")


class RelationalCypherResult(CypherResult):
    def __init__(self, records: Optional[RelationalCypherRecords] = None,
                 graph: Optional[RelationalCypherGraph] = None,
                 plans: Optional[Dict[str, str]] = None,
                 metrics: Optional[Dict[str, Any]] = None):
        self._records = records
        self._graph = graph
        self.plans = plans or {}
        self.metrics = metrics or {}
        #: ((qgn, dep token), ...) of the catalog graphs the query's plan
        #: resolved (CachedPlan.catalog_deps)
        self.catalog_deps: Tuple = ()
        # PROFILE annotation (obs/profile.py): plain-dict operator tree
        # with per-node rows/seconds/bytes; None unless profiled.
        self.profile: Optional[Dict[str, Any]] = None

    @property
    def records(self) -> Optional[RelationalCypherRecords]:
        return self._records

    @property
    def graph(self) -> Optional[RelationalCypherGraph]:
        return self._graph

    def to_maps(self) -> List[Dict[str, Any]]:
        return self._records.to_maps() if self._records is not None else []

    def explain(self) -> str:
        parts = []
        for phase in ("ir", "logical", "relational", "cost", "profile"):
            if phase in self.plans:
                parts.append(f"=== {phase.upper()} ===\n{self.plans[phase]}")
        return "\n\n".join(parts)


class RelationalCypherSession(CypherSession):
    """Backend-generic session; concrete backends provide a TableFactory."""

    def __init__(self, config: Optional[EngineConfig] = None):
        self._catalog = CypherCatalog()
        self.config = config or DEFAULT_CONFIG
        for flag in self.config.UNPORTED_FLAGS:
            if getattr(self.config, flag):
                raise not_ported(f"EngineConfig.{flag}")
        self._ambient = EmptyGraph(self)
        # Observability (obs/): the session tracer collects query →
        # phase → operator spans; the registry holds the session's
        # counters (cost.*, wcoj.*, replan.*, stats.*, opstats.*,
        # updates.*, compaction.*, compile.*), gauges (mem.*) and
        # per-phase histograms behind metrics_snapshot().  Tracing is
        # off unless config.trace or a PROFILE query force-enables it.
        self.metrics_registry = obs.MetricsRegistry()
        self.tracer = obs.Tracer(enabled=self.config.trace)
        # Observed per-operator statistics (obs/telemetry.py): every
        # execution folds its op_metrics entries in, keyed by (plan
        # family, operator id) — the cost model's calibration and the
        # model-divergence detector that triggers re-planning.
        self.op_stats = obs.OpStatsStore(
            registry=self.metrics_registry,
            replan_threshold=max(1, self.config.replan_threshold or 1),
            # late-binding: backends set the session's shape lattice
            bucket_fn=lambda n: self.shape_lattice.bucket(n))
        # Divergence-triggered re-planning: a family whose executions
        # keep diverging from the model's estimates retires its cached
        # plans (plan_cache.evict_family) and re-plans.  Listeners
        # observe the replan.* events; the pending set marks families
        # whose NEXT cold plan completes a re-plan.
        self.replan_listeners: List[Any] = []
        self._replanned_pending: set = set()
        # Compile ledger (obs/compile.py): the host seconds of a shape's
        # first run at each compile boundary — the cold plan phase here,
        # a fused record run, a count-closure build, a multiway join's
        # first-seen step shape — charged per plan family.
        self.compile_ledger = obs.CompileLedger(
            registry=self.metrics_registry)
        self._profiling = False
        # Prepared-statement plan cache (relational/plan_cache.py): keyed
        # value-independently; catalog mutations evict dependent entries.
        self.plan_cache = PlanCache(self.config.plan_cache_size,
                                    enabled=self.config.use_plan_cache,
                                    registry=self.metrics_registry)
        # Snapshot-keyed result & subplan cache (relational/
        # result_cache.py): attached by the serving tier
        # (ServerConfig.result_cache), which reads and fills its result
        # level at admission and completion; the execution paths seed
        # and store its scan→filter prefixes.  None means every read
        # runs on the device.  It exists before the memory ledger
        # registers its gauge over it.
        self.result_cache = None
        # Memory ledger (obs/ledger.py): live mem.* gauges over the plan
        # cache, string pool, tracked graphs and the card's allocator.
        self.memory_ledger = obs.MemoryLedger(
            registry=self.metrics_registry, session=self)
        # Scoped catalog eviction: a mutation of graph X drops exactly
        # X's dependents (okapi/catalog.py dep_token) — unrelated graphs'
        # cached state survives.
        self._catalog.subscribe(
            lambda _version, qgn: self._evict_catalog_dependents(qgn))
        # per-thread recorder of catalog graphs resolved while planning
        # (they become the cached plan's catalog_deps)
        self._deps_tls = threading.local()
        # Shape-bucket lattice (relational/shapes.py): device backends
        # adopt it as their padding ladder; ``seed_shape_buckets()`` folds
        # observed op_stats sizes in, and the plan store
        # (relational/plan_store.py) carries the boundaries across
        # processes.
        self.shape_lattice = ShapeBucketLattice(
            self.config.bucket_sizes, registry=self.metrics_registry)
        # Warm-path binding recorder: the JSON-able parameter bindings
        # that crossed a compile boundary, per plan family, recorded on
        # the cold path only.  The plan store persists them so a fresh
        # process's warmup (serve/warmup.py) runs each hot family with a
        # binding of the right shape.
        from caps_tpu_torch.obs.lockgraph import make_lock
        self._warm_bindings: "OrderedDict[str, Tuple[str, List, set]]" = \
            OrderedDict()
        self._warm_bindings_lock = make_lock("session._warm_bindings_lock")
        self._warm_bindings_cap = 128

    def _evict_catalog_dependents(self, qgn) -> None:
        """Drop the cached state of every query that resolved the
        catalog graph ``qgn`` (any catalog graph when None).  Backends
        with more per-query state than the plan cache extend it."""
        self.plan_cache.evict_dependents(qgn)

    # -- backend SPI --------------------------------------------------------

    @property
    @abc.abstractmethod
    def table_factory(self) -> TableFactory:
        ...

    # -- public API ---------------------------------------------------------

    @property
    def catalog(self) -> CypherCatalog:
        return self._catalog

    def cypher(self, query: str,
               parameters: Optional[Mapping[str, Any]] = None) -> CypherResult:
        return self.cypher_on_graph(self._ambient, query, parameters)

    def clone(self) -> "RelationalCypherSession":
        """A fresh session of the same class and config — the serving
        tier's per-device replica seam (serve/devices.py): the clone owns
        its own plan cache, catalog, metrics registry, and (on device
        backends) string pool and fused memos.  Nothing cached is shared
        with this session, so one replica's quarantine never leaks into
        another's.  Device backends keep the clone on their device."""
        return type(self)(config=self.config)

    def prepare(self, query: str,
                graph: Optional[RelationalCypherGraph] = None) -> PreparedQuery:
        """Prepare a query for repeated execution: parses (and validates)
        once, and every ``.run(params)`` serves the planned operator tree
        from the session plan cache — the steady state skips
        parse/IR/logical/relational planning entirely."""
        return PreparedQuery(self, query, graph)

    def cypher_batch(self, graph: RelationalCypherGraph,
                     items: List[Tuple[str, Mapping[str, Any]]],
                     scopes: Optional[List] = None) -> List[Any]:
        """Micro-batched execution (the serving tier's hot path —
        serve/batcher.py): ``items`` is a list of ``(query, params)``
        pairs of one plan-cache key family, run back to back as ONE
        batch under a single tracer span; after the first member every
        later one re-binds the same cached plan.

        Returns a list aligned with ``items``; each element is the
        member's CypherResult *or the exception it raised* — one
        member's deadline expiry must not fail the rest of the batch.
        ``scopes`` optionally installs a per-member
        :class:`~caps_tpu_torch.serve.deadline.CancelScope`."""
        out: List[Any] = []
        with self._observed(), self.tracer.span("batch", kind="query",
                                                n=len(items)):
            for i, (query, params) in enumerate(items):
                scope = scopes[i] if scopes is not None else None
                try:
                    with cancel_scope(scope):
                        out.append(self.cypher_on_graph(graph, query,
                                                        params))
                except Exception as ex:
                    out.append(ex)
        self.metrics_registry.observe("session.batch_size", len(items))
        return out

    def cypher_degraded(self, graph: RelationalCypherGraph, query: str,
                        parameters: Optional[Mapping[str, Any]] = None, *,
                        no_plan_cache: bool = True,
                        no_fused: bool = False) -> CypherResult:
        """Degraded re-execution (see :func:`degraded_execution`): bypass
        the plan cache (fresh plan, nothing stored) and optionally force
        unfused per-operator execution.  Correct results, none of the
        shared cached state a poisoned entry could hide in."""
        with degraded_execution(no_plan_cache=no_plan_cache,
                                no_fused=no_fused):
            return self.cypher_on_graph(graph, query, parameters)

    def cypher_on_graph(self, graph: RelationalCypherGraph, query: str,
                        parameters: Optional[Mapping[str, Any]] = None
                        ) -> CypherResult:
        # EXPLAIN / PROFILE prefixes strip HERE, before any cache key is
        # formed — a PROFILE run hits the same plan-cache / fused-memo
        # entries as the plain query (and vice versa), never a poisoned
        # key.
        mode, body = query_mode(query)
        if isinstance(graph, VersionedGraph) \
                and not is_update_query(body if mode is not None else query):
            # snapshot isolation: a READ resolves the mutable handle to
            # the latest committed snapshot ONCE, here, and runs on it
            # end to end — commits that land meanwhile are invisible.
            # Writes keep the handle (they serialize on its commit
            # lock); so does EXPLAIN of a write.
            graph = graph.current()
        if mode == "explain":
            return self._explain_on_graph(graph, body, parameters)
        if mode == "profile":
            return self._profile_on_graph(graph, body, parameters)
        # Compile attribution (obs/compile.py): every compile boundary
        # crossed below charges the session ledger under THIS query's
        # plan-cache family, and the per-query total is stamped into the
        # result metrics.
        with obs.compile_attributed(self.compile_ledger,
                                    normalize_query(query)) as charges:
            with self._observed():
                result = self._cypher_on_graph(graph, query, parameters)
            if self.config.determinism_check and result.records is not None:
                # SURVEY.md §5.2: deterministic replay — run the same
                # query a second time and compare multiset digests.
                again = self._cypher_on_graph(graph, query, parameters)
                d1 = result_digest(result)
                d2 = result_digest(again)
                if d1 != d2:
                    raise NondeterministicResultError(
                        f"query produced different results on replay "
                        f"({d1[:12]} vs {d2[:12]}): {query!r}")
                result.metrics["determinism_digest"] = d1
        if charges:
            # a binding that crossed a compile boundary (a cold plan, a
            # fused record, a count-closure build) is one the warmup
            # must cover: record it for the plan store
            self._note_warm_binding(normalize_query(query), query,
                                    dict(parameters or {}))
        self._stamp_compile_charges(result, charges)
        return result

    @staticmethod
    def _stamp_compile_charges(result, charges) -> None:
        """Per-query compile accounting onto the result metrics:
        ``compile_s_charged`` is ALWAYS present (0.0 on a warm path),
        the per-charge detail only when something was charged."""
        if result.metrics is None:
            return
        result.metrics["compile_s_charged"] = round(
            sum(c["seconds"] for c in charges), 9)
        if charges:
            result.metrics["compile_charges"] = [
                {"kind": c["kind"], "seconds": round(c["seconds"], 9),
                 "recompile": c["recompile"]} for c in charges]

    def _make_cost_model(self, graph: RelationalCypherGraph,
                         family: Optional[str] = None):
        """One query's cost model (relational/cost.py): the graph's
        statistics sketch + the session shape lattice + observed-actuals
        calibration for ``family``.  None with the model disabled
        (``EngineConfig.use_cost_model=False``: the fixed heuristics)."""
        if not self.config.use_cost_model:
            return None
        from caps_tpu_torch.relational.cost import CostModel
        from caps_tpu_torch.relational.stats import graph_statistics
        return CostModel(graph_statistics(graph),
                         lattice=getattr(self, "shape_lattice", None),
                         op_stats=self.op_stats,
                         compile_ledger=self.compile_ledger,
                         config=self.config, family=family,
                         registry=self.metrics_registry)

    def _plan_ir(self, graph: RelationalCypherGraph, ir, plan_params,
                 params: Dict[str, Any], family: Optional[str] = None):
        """Logical planning + optimization + relational planning for one
        (non-catalog) IR statement — shared by the execute path, EXPLAIN
        and CATALOG CREATE GRAPH, so the plan EXPLAIN renders is the
        plan that executes, with the same cost-model decisions (chain
        orientation, physical strategy, per-operator estimates).
        Planning reads parameters through ``plan_params`` (a
        :class:`PlanParams` view on the cached path); the runtime
        context gets the plain ``params``.  Returns (logical, context,
        rel_planner, root, t_logical_done); the model rides
        ``rel_planner.cost_model``."""
        model = self._make_cost_model(graph, family)
        with self.tracer.span("logical", kind="phase"):
            logical = LogicalPlanner(graph.schema, self._schema_resolver,
                                     plan_params).process(ir)
            logical = LogicalOptimizer(model).process(logical)
        t3 = clock.now()
        with self.tracer.span("relational", kind="phase"):
            context = R.RelationalRuntimeContext(self, params)
            rel_planner = RelationalPlanner(context, graph,
                                            self._graph_resolver,
                                            cost_model=model)
            root = rel_planner.process(logical)
        rel_planner.cost_summary = None
        if model is not None:
            from caps_tpu_torch.relational.cost import annotate_plan
            try:
                rel_planner.cost_summary = annotate_plan(root, model)
            except Exception:  # pragma: no cover — pricing must not fail
                rel_planner.cost_summary = None
        return logical, context, rel_planner, root, t3

    @staticmethod
    def _cost_text(rel_planner) -> Optional[str]:
        """EXPLAIN's cost section: the model's decision log, when it
        made a decision."""
        summary = rel_planner.cost_summary
        if summary and summary.get("decisions"):
            return rel_planner.cost_model.render_decisions()
        return None

    @contextlib.contextmanager
    def _observed(self):
        """Activate this session's tracer for the duration of a query so
        session-less instrumentation (compile charges) lands in it.  With
        tracing disabled the only cost is one enabled check."""
        if not self.tracer.enabled:
            yield
            return
        with obs.activate(self.tracer):
            yield

    # -- EXPLAIN / PROFILE ---------------------------------------------------

    def _explain_on_graph(self, graph: RelationalCypherGraph, query: str,
                          parameters: Optional[Mapping[str, Any]] = None
                          ) -> CypherResult:
        """``EXPLAIN <query>``: run the full planning frontend and return
        the rendered plan trees WITHOUT executing anything — no operator
        computes, no catalog mutation applies, no write commits."""
        t0 = clock.now()
        params = dict(parameters or {})
        plan_params = PlanParams(params)
        plans: Dict[str, str] = {}
        with self._observed(), self.tracer.span("explain", kind="query",
                                                query=query):
            stmt = parse_query(query)
            if is_update_statement(stmt):
                # EXPLAIN of a write: render the staged update program
                # (and plan — not execute — its read half) without
                # committing anything
                up = plan_update(stmt)
                plans["updates"] = describe_plan(up)
                if up.read_ast is not None:
                    read_graph = graph.current() \
                        if isinstance(graph, VersionedGraph) else graph
                    ir = IRBuilder(read_graph.schema, self._schema_resolver,
                                   plan_params).process(up.read_ast)
                    logical, _ctx, _planner, root, _t = self._plan_ir(
                        read_graph, ir, plan_params, params)
                    plans["logical"] = logical.pretty()
                    plans["relational"] = root.pretty()
            else:
                ir = IRBuilder(graph.schema, self._schema_resolver,
                               plan_params).process(stmt)
                pretty = getattr(ir, "pretty", None)
                if pretty is not None:
                    plans["ir"] = pretty()
                if not isinstance(ir, B.DropGraphStatement):
                    inner = ir.inner \
                        if isinstance(ir, B.CreateGraphStatement) else ir
                    logical, _context, planner, root, _t3 = self._plan_ir(
                        graph, inner, plan_params, params,
                        family=normalize_query(query))
                    plans["logical"] = logical.pretty()
                    plans["relational"] = root.pretty()
                    cost = self._cost_text(planner)
                    if cost is not None:
                        # estimated-vs-chosen: the model's decision log
                        # rides EXPLAIN next to the annotated tree
                        plans["cost"] = cost
        metrics = {"mode": "explain", "plan_s": clock.now() - t0, "rows": 0}
        return RelationalCypherResult(plans=plans, metrics=metrics)

    def _profile_on_graph(self, graph: RelationalCypherGraph, query: str,
                          parameters: Optional[Mapping[str, Any]] = None
                          ) -> CypherResult:
        """``PROFILE <query>``: execute with the tracer force-enabled and
        annotate every relational operator with its measured span (rows,
        wall time, bytes; device time when per-op sync is on —
        ``config.profile_sync_each_op``)."""
        prev_profiling = self._profiling
        self._profiling = True
        try:
            with self.tracer.forced(
                    sync_device=self.config.profile_sync_each_op):
                with obs.activate(self.tracer):
                    with self.tracer.span("query", kind="query",
                                          query=query, mode="profile"), \
                            obs.compile_attributed(
                                self.compile_ledger,
                                normalize_query(query)) as charges:
                        result = self._cypher_on_graph(graph, query,
                                                       parameters)
            self._stamp_compile_charges(result, charges)
        finally:
            self._profiling = prev_profiling
        if result.metrics is not None:
            result.metrics["mode"] = "profile"
        if result.profile is not None:
            # copy-on-write: the plans dict may be SHARED with a cached
            # plan entry — annotating in place would leak profile text
            # into later non-profile results served from the cache
            result.plans = dict(result.plans)
            result.plans["profile"] = obs.render_profile(result.profile)
        return result

    # -- metrics / trace export ----------------------------------------------

    def metrics_snapshot(self) -> Dict[str, Any]:
        """One flat dict of every session-level stat: the metrics
        registry (counters, gauges, per-phase histograms), the plan
        cache's numbers and the tracer's span counts.  Backends extend
        this with their device counters.  Consumers measure intervals
        with ``obs.diff_snapshots(before, after)``."""
        snap = self.metrics_registry.snapshot()
        for k, v in self.plan_cache.stats().items():
            snap[f"plan_cache.{k}"] = v
        snap["tracer.spans"] = len(self.tracer.spans)
        snap["tracer.dropped"] = self.tracer.dropped
        return snap

    def export_trace(self, path: str, fmt: str = "chrome") -> str:
        """Dump the tracer's collected spans: ``fmt='chrome'`` writes a
        ``chrome://tracing``-loadable file, ``fmt='jsonl'`` one JSON
        object per span."""
        if fmt == "chrome":
            obs.write_chrome_trace(self.tracer.spans, path)
        elif fmt == "jsonl":
            obs.write_jsonl(self.tracer.spans, path)
        else:
            raise ValueError(f"unknown trace format {fmt!r}")
        return path

    # -- warm path (serve/warmup.py + relational/plan_store.py) --------------

    #: distinct compile-charging bindings kept per family — enough to
    #: cover a per-value compile cache's rotation (the count-pushdown
    #: closures) without letting ad-hoc values grow the store
    _WARM_BINDINGS_PER_FAMILY = 4

    def _note_warm_binding(self, family: str, query: str,
                           params: Mapping[str, Any]) -> None:
        """Record a compile-charging binding for the family — only when
        the values are JSON-able (the store is plain JSON; anything else
        is skipped, and warmup then cannot cover that binding).
        Distinct bindings are kept up to a small per-family cap."""
        try:
            token = json.dumps(dict(params), sort_keys=True)
            clean = json.loads(token)
        except (TypeError, ValueError):
            return
        with self._warm_bindings_lock:
            ent = self._warm_bindings.pop(family, None)
            if ent is None:
                ent = (query, [], set())
            q, bindings, tokens = ent
            if token not in tokens and \
                    len(bindings) < self._WARM_BINDINGS_PER_FAMILY:
                tokens.add(token)
                bindings.append(clean)
            self._warm_bindings[family] = (q, bindings, tokens)
            while len(self._warm_bindings) > self._warm_bindings_cap:
                self._warm_bindings.popitem(last=False)

    def warmup_bindings(self) -> List[Dict[str, Any]]:
        """Per hot plan family: the original query text and every kept
        compile-charging binding — the plan store's family entries
        (``relational/plan_store.py collect_warm_state``)."""
        with self._warm_bindings_lock:
            return [{"family": fam, "query": q,
                     "params": dict(bs[0]) if bs else {},
                     "bindings": [dict(b) for b in bs]}
                    for fam, (q, bs, _toks) in self._warm_bindings.items()]

    def seed_shape_buckets(self) -> int:
        """Fold observed operator-launch sizes (``op_stats`` actual max
        rows) into the session's shape-bucket lattice.  Returns how many
        boundaries were added."""
        return self.shape_lattice.seed_from_op_stats(self.op_stats)

    # -- execution -------------------------------------------------------------

    def _plan_cache_key(self, graph: RelationalCypherGraph, query: str,
                        params: Mapping[str, Any]) -> Optional[Tuple]:
        gtok = graph_plan_token(graph)
        if gtok is None:
            return None
        # catalog consistency is per-plan (CachedPlan.catalog_deps),
        # not part of the key: a catalog mutation invalidates exactly
        # its dependents instead of re-keying the whole session
        return (normalize_query(query), gtok, param_signature(params))

    def _cypher_on_graph(self, graph: RelationalCypherGraph, query: str,
                         parameters: Optional[Mapping[str, Any]] = None
                         ) -> CypherResult:
        t0 = clock.now()
        params = dict(parameters or {})
        tracer = self.tracer

        no_plan_cache, _no_fused = degraded_state()
        cache_key: Optional[Tuple] = None
        if self.plan_cache.enabled and not no_plan_cache:
            cache_key = self._plan_cache_key(graph, query, params)
            if cache_key is not None:
                cached = self.plan_cache.lookup(cache_key, params,
                                                catalog=self._catalog)
                if cached is not None:
                    return self._run_cached(cached, query, params, t0,
                                            family=cache_key[0])

        # Cold path: the full front end.  Planning sees the parameters
        # through a PlanParams view, which records any plan-time VALUE
        # read as a cache specialization; runtime parameter reads go
        # through the context's plain dict and stay free.
        plan_params = PlanParams(params)
        with tracer.span("parse", kind="phase"):
            stmt = parse_query(query)
        checkpoint("parse")
        if is_update_statement(stmt):
            # the write path: read on the current snapshot, stage,
            # commit atomically (relational/updates.py)
            return self._run_update(graph, stmt, query, params, t0)
        t1 = clock.now()
        with self._record_catalog_deps() as catalog_deps:
            with tracer.span("ir", kind="phase"):
                ir = IRBuilder(graph.schema, self._schema_resolver,
                               plan_params).process(stmt)
            t2 = clock.now()
            if isinstance(ir, B.CreateGraphStatement):
                return self._run_create_graph(graph, ir, params)
            if isinstance(ir, B.DropGraphStatement):
                self._catalog.delete(ir.qgn)
                return RelationalCypherResult()
            family = cache_key[0] if cache_key is not None \
                else normalize_query(query)
            logical, context, rel_planner, root, t3 = self._plan_ir(
                graph, ir, plan_params, params, family=family)
        t4 = clock.now()
        checkpoint("plan")
        # Compile ledger (obs/compile.py): the cold plan phase is a
        # compile boundary — a cache hit never pays it again, and a
        # re-plan of the same (family, signature) counts as a
        # re-compile.
        obs.compile_charge("plan", t4 - t0,
                           shape=repr(param_signature(params)))

        plans = {"ir": ir.pretty(), "logical": logical.pretty(),
                 "relational": root.pretty()}
        cost = self._cost_text(rel_planner)
        if cost is not None:
            plans["cost"] = cost
        if family in self._replanned_pending:
            # this cold plan IS the divergence-triggered re-plan, its
            # estimates calibrated from observed actuals
            self._replanned_pending.discard(family)
            self.metrics_registry.counter("replan.completed").inc()
            summary = rel_planner.cost_summary or {}
            self._notify_replan("replan.completed", {
                "family": family, "plan_s": t4 - t0,
                "root_est_rows": summary.get("root_est_rows"),
                "decisions": summary.get("decisions")})
        self._print_plans(plans)

        result_graph: Optional[RelationalCypherGraph] = None
        records: Optional[RelationalCypherRecords] = None
        with tracer.span("execute", kind="phase"):
            if logical.returns_graph:
                result_graph = self._evaluate_graph(root)
            else:
                rcache = self.result_cache
                if rcache is not None:
                    # snapshot-keyed subplan reuse: seed memoized
                    # scan→filter intermediates before pulling the root
                    self._seed_subplans(rcache, root)
                header, table = root.result
                if rcache is not None:
                    # capture BEFORE any reset_plan clears the memos
                    rcache.store_subplans(root)
                records = RelationalCypherRecords(
                    self, header, table, logical.result_fields,
                    graph=rel_planner.current_graph)
        checkpoint("execute")
        t5 = clock.now()

        metrics = {
            "parse_s": t1 - t0, "ir_s": t2 - t1, "plan_s": t3 - t2,
            "relational_s": t4 - t3, "execute_s": t5 - t4,
            # size_hint never syncs (generic replay may only know an
            # upper bound until the result is materialized)
            "rows": records.table.size_hint() if records is not None else 0,
            "operators": context.op_metrics,
            "bytes_touched": sum(m.get("bytes_in", 0)
                                 for m in context.op_metrics),
            "plan_cache": "miss" if cache_key is not None else "off",
        }
        if self.config.print_timings:
            print(f"[caps-tpu-torch] timings: {metrics}")
        logger.debug("query %r: %d rows in %.1f ms", query,
                     metrics["rows"], 1e3 * (t5 - t0))
        self.metrics_registry.observe("query.plan_s", t4 - t0)
        self.metrics_registry.observe("query.execute_s", t5 - t4)
        # observed-statistics fold, keyed by the plan family (the cache
        # key's normalized query text)
        self.op_stats.record(family, context.op_metrics)
        self._maybe_replan()
        # snapshot per-operator measurements into plain dicts BEFORE the
        # cache store resets the tree (obs/profile.py)
        result_profile = (obs.profile_tree(root, context)
                          if self._profiling else None)

        deps = tuple(sorted(catalog_deps.items()))
        if (cache_key is not None and records is not None
                and not logical.returns_graph and plan_params.cacheable):
            entry = CachedPlan(
                root=root, result_fields=logical.result_fields, plans=plans,
                records_graph=rel_planner.current_graph, context=context,
                spec_key=plan_params.spec_key(),
                cold_phase_s=t4 - t0,
                nbytes=_plan_nbytes(plans, root, context=context,
                                    catalog_deps=catalog_deps),
                catalog_deps=deps, query_text=query)
            # Drop the memoized results before parking the tree in the
            # cache: the records object holds the (header, table) refs,
            # so a cached plan retains no tables between executions.
            reset_plan(root)
            self.plan_cache.store(cache_key, entry)
        result = RelationalCypherResult(records, result_graph, plans, metrics)
        result.catalog_deps = deps
        result.profile = result_profile
        return result

    def _seed_subplans(self, rcache, root) -> int:
        """Seed ``root``'s memoized prefixes from the result cache's
        second level (relational/result_cache.py).  A backend whose runs
        replay recorded sizes extends it: a seeded prefix skips the
        sizes its operators would have read."""
        return rcache.seed_subplans(root)

    def _run_cached(self, plan: CachedPlan, query: str,
                    params: Dict[str, Any], t0: float,
                    family: Optional[str] = None) -> CypherResult:
        """Execute a cached relational operator tree with fresh parameter
        bindings: swap the shared runtime context's parameters, clear the
        per-run memos, and pull the root's result.  parse/ir/plan/
        relational metrics are 0 by construction (only the cache lookup
        preceded this)."""
        # The plan's operator tree and runtime context are shared mutable
        # state (parameter dict, per-op result memos): concurrent
        # executions of the SAME cached plan serialize on its lock.
        with plan.exec_lock:
            context = plan.context
            context.rebind(params)
            reset_plan(plan.root)
            rcache = self.result_cache
            if rcache is not None:
                # seed AFTER reset_plan (reset clears seeded memos)
                self._seed_subplans(rcache, plan.root)
            t1 = clock.now()
            try:
                with self.tracer.span("execute", kind="phase",
                                      plan_cache="hit"):
                    header, table = plan.root.result
                    if rcache is not None:
                        # capture before the finally's reset_plan
                        rcache.store_subplans(plan.root)
                    records = RelationalCypherRecords(
                        self, header, table, plan.result_fields,
                        graph=plan.records_graph)
                op_metrics = context.op_metrics
                result_profile = (obs.profile_tree(plan.root, context)
                                  if self._profiling else None)
            finally:
                # the records object owns (header, table) now; the parked
                # tree must not pin device buffers until its next
                # execution — including when a deadline or a failure
                # stopped the run mid-tree with partial operator memos
                # already computed
                reset_plan(plan.root)
        checkpoint("execute")
        t2 = clock.now()
        self._print_plans(plan.plans)
        metrics = {
            "parse_s": 0.0, "ir_s": 0.0, "plan_s": 0.0, "relational_s": 0.0,
            "plan_cache_lookup_s": t1 - t0,
            "execute_s": t2 - t1,
            "rows": table.size_hint(),
            "operators": op_metrics,
            "bytes_touched": sum(m.get("bytes_in", 0) for m in op_metrics),
            "plan_cache": "hit",
            "plan_cache_saved_s": plan.cold_phase_s,
        }
        if self.config.print_timings:
            print(f"[caps-tpu-torch] timings: {metrics}")
        logger.debug("query %r: %d rows in %.1f ms (plan cache hit)",
                     query, metrics["rows"], 1e3 * (t2 - t0))
        self.metrics_registry.observe("query.execute_s", t2 - t1)
        # observed statistics: op_metrics was captured under the exec
        # lock (rebind swaps in a fresh list per run)
        self.op_stats.record(
            family if family is not None else normalize_query(query),
            op_metrics)
        self._maybe_replan()
        result = RelationalCypherResult(records, None, plan.plans, metrics)
        result.catalog_deps = plan.catalog_deps
        result.profile = result_profile
        return result

    # -- divergence-triggered re-planning -------------------------------------

    def _maybe_replan(self) -> None:
        """Retire every plan family whose executions crossed the model-
        divergence threshold (obs/telemetry.py OpStatsStore): its cached
        plans and their fused recordings go, the family is marked so its
        next cold plan reports ``replan.completed``, and listeners
        observe ``replan.triggered``."""
        if not self.config.use_cost_model \
                or (self.config.replan_threshold or 0) <= 0:
            return
        for family in self.op_stats.take_replan_candidates():
            dropped = self.plan_cache.evict_family(family)
            # retire the fused recordings with the plans: the re-planned
            # tree may have another shape (re-rooted chain, changed
            # physical strategy), and replaying the old plan's recorded
            # size stream against it would mis-gather
            fused = getattr(self, "fused", None)
            if fused is not None:
                seen = set()
                for p in dropped:
                    fk = (id(p.records_graph), p.query_text)
                    if p.query_text and fk not in seen:
                        seen.add(fk)
                        fused.forget(p.records_graph, p.query_text)
            # the family's observed history is kept: a re-plan that
            # keeps the plan shape calibrates from it; one that changes
            # the shape resets it in cost.annotate_plan (operator ids do
            # not transfer across plan shapes)
            self.metrics_registry.counter("replan.triggered").inc()
            if len(self._replanned_pending) < 64:
                self._replanned_pending.add(family)
            self._notify_replan("replan.triggered", {
                "family": family, "quarantined_plans": len(dropped)})

    def _notify_replan(self, event: str, info: Dict[str, Any]) -> None:
        for listener in list(self.replan_listeners):
            try:
                listener(event, info)
            except Exception:  # pragma: no cover — observers must not fail
                pass

    def _print_plans(self, plans: Dict[str, str]) -> None:
        if self.config.print_ir:
            print(plans["ir"])
        if self.config.print_logical_plan:
            print(plans["logical"])
        if self.config.print_relational_plan:
            print(plans["relational"])

    # -- update statements (relational/updates.py) ---------------------------

    def _run_update(self, graph: RelationalCypherGraph, stmt, query: str,
                    params: Dict[str, Any], t0: float) -> CypherResult:
        """Execute a ``CREATE``/``SET``/``DELETE`` statement: plan-split
        it into a read query + staging directives, run the read part on
        the writer's CURRENT snapshot through the normal pipeline, stage
        per-row update ops host-side, and commit them atomically through
        the versioned handle.  A failure anywhere before the publish —
        validation, device placement, an injected fault — leaves the
        graph untouched (the commit is failure-atomic), so a
        transiently-failed write may be retried safely."""
        if not isinstance(graph, VersionedGraph):
            kind = type(graph).__name__
            if kind == "GraphSnapshot":
                raise UpdateError(
                    "snapshots are immutable — submit writes against "
                    "the versioned graph handle, not a pinned snapshot")
            raise UpdateError(
                f"updates need a versioned graph "
                f"(session.create_versioned_graph / "
                f"caps_tpu_torch.relational.updates.versioned), got {kind}")
        from caps_tpu_torch.frontend.semantic import check_statement
        check_statement(stmt)  # scope errors surface before any staging
        plan = plan_update(stmt)
        snap = graph.current()
        t1 = clock.now()
        rows: List[Dict[str, Any]] = [{}]
        if plan.read_ast is not None:
            rows = self._execute_read_ast(snap, plan.read_ast, params)
        t2 = clock.now()
        checkpoint("execute")
        staged = stage_rows(plan, rows, params)
        with self.tracer.span("apply", kind="phase"):
            info = graph.apply(staged)
        checkpoint("execute")
        t3 = clock.now()
        metrics = {
            "parse_s": t1 - t0, "read_s": t2 - t1, "apply_s": t3 - t2,
            "rows": 0, "plan_cache": "off",
            "updates": info.counts(),
            "snapshot_version": info.version,
        }
        self.metrics_registry.observe("query.execute_s", t3 - t1)
        plans = {"ir": describe_plan(plan)}
        logger.debug("update %r: %s -> v%d in %.1f ms", query,
                      info.counts(), info.version, 1e3 * (t3 - t0))
        return RelationalCypherResult(plans=plans, metrics=metrics)

    def _execute_read_ast(self, graph: RelationalCypherGraph, read_ast,
                          params: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Plan + execute the synthesized read half of an update
        statement on the pinned snapshot and materialize its rows (the
        bindings and computed SET/CREATE values the staging step
        consumes).  Uncached on purpose: the snapshot advances with
        every commit, so a write's read half is almost never re-planned
        against the same version."""
        plan_params = PlanParams(params)
        ir = IRBuilder(graph.schema, self._schema_resolver,
                       plan_params).process(read_ast)
        logical, _context, rel_planner, root, _t3 = self._plan_ir(
            graph, ir, plan_params, params)
        checkpoint("plan")
        with self.tracer.span("execute", kind="phase", update_read=True):
            header, table = root.result
            records = RelationalCypherRecords(
                self, header, table, logical.result_fields,
                graph=rel_planner.current_graph)
        return records.to_maps()

    def create_versioned_graph(self, node_tables=(),
                               rel_tables=()) -> VersionedGraph:
        """A writable graph: an immutable base plus the versioned delta
        store — ``CREATE``/``SET``/``DELETE`` and ``graph.apply(...)``
        commit new snapshots; readers are isolated on the snapshot they
        started with (relational/updates.py)."""
        return VersionedGraph(self,
                              self.create_graph(node_tables, rel_tables))

    # -- graph-returning statements -----------------------------------------

    def _run_create_graph(self, graph, ir: B.CreateGraphStatement, params):
        """CATALOG CREATE GRAPH qgn { inner }: evaluate the inner query's
        graph and store it under the qualified name."""
        logical, context, planner, root, _t3 = self._plan_ir(
            graph, ir.inner, params, params)
        if not logical.returns_graph:
            raise ValueError(
                "CATALOG CREATE GRAPH requires the inner query to end with "
                "RETURN GRAPH")
        result_graph = self._evaluate_graph(root)
        self._catalog.store(ir.qgn, result_graph)
        return RelationalCypherResult(graph=result_graph)

    def _evaluate_graph(self, root: R.RelationalOperator):
        result_graph = getattr(root, "result_graph", None)
        if result_graph is None:
            raise ValueError("query does not produce a graph")
        return result_graph

    @contextlib.contextmanager
    def _record_catalog_deps(self):
        """Collect every catalog graph the planning phases resolve on
        this thread — the cached plan stores (qgn, dep token) pairs and
        lookup revalidates them (scoped invalidation)."""
        prev = getattr(self._deps_tls, "rec", None)
        rec: Dict[QualifiedGraphName, Tuple] = {}
        self._deps_tls.rec = rec
        try:
            yield rec
        finally:
            self._deps_tls.rec = prev

    def _note_catalog_dep(self, qgn: QualifiedGraphName) -> None:
        rec = getattr(self._deps_tls, "rec", None)
        if rec is not None:
            rec[qgn] = self._catalog.dep_token(qgn)

    def _schema_resolver(self, qgn: QualifiedGraphName) -> Schema:
        self._note_catalog_dep(qgn)
        src = self._catalog.source(qgn.namespace)
        s = src.schema(qgn.graph_name)
        if s is None:
            raise KeyError(f"graph {qgn!r} not found")
        return s

    def _graph_resolver(self, qgn: QualifiedGraphName) -> RelationalCypherGraph:
        self._note_catalog_dep(qgn)
        g = self._catalog.graph(qgn)
        if not isinstance(g, RelationalCypherGraph):
            raise TypeError(f"graph {qgn!r} is not a relational graph")
        return g

    # -- helpers used by graphs ---------------------------------------------

    def records_from(self, header: RecordHeader, table: Table,
                     columns: Tuple[str, ...]) -> RelationalCypherRecords:
        return RelationalCypherRecords(self, header, table, columns)

    def create_graph(self, node_tables=(), rel_tables=()) -> ScanGraph:
        return ScanGraph(self, node_tables, rel_tables)
