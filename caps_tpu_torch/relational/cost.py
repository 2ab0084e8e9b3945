"""The tensor-path cost model: price plans in padded-bucket device terms.

ROADMAP item 3's optimizer core.  The model spends two substrates the
engine already maintains:

* **ingest-time statistics** (relational/stats.py) — cardinalities,
  degree-distribution sketches, hot-key skew — the prior for a plan
  family with no history;
* **observed actuals** (``session.op_stats``, obs/telemetry.py) — when
  a (family, operator) has execution history under the CURRENT plan
  shape, the observed row mean *calibrates* the estimate (the feedback
  loop: a model estimate that keeps diverging retires its cached plan
  through the quarantine path and the re-plan prices from the refreshed
  statistics prior — the retired plan's history resets with it, because
  operator ids do not transfer across plan shapes).

Costs are NOT abstract row counts: every operator launch on the device
pads its rows up to a shape-bucket boundary (relational/shapes.py), so
an estimate of 1 000 rows that pads to 4 096 pays 4 096 — the
"Premature Dimensional Collapse ..." tensor-path observation (PAPERS.md)
applied to plan pricing.  ``device_cost`` is therefore padded rows ×
row bytes, with a compile-risk surcharge when a step would launch at a
bucket the lattice has never seen (new bucket = new XLA program = the
compile ledger's measured cliff).

Decision surfaces:

* :meth:`CostModel.chain_cost` / :meth:`chain_orientation` — bounded
  join-order enumeration for Expand chains (logical/optimizer.py
  re-roots a chain at its cheaper end);
* :func:`choose_dist_strategy` — radix vs salted vs broadcast for the
  sharded path (okapi/config.py thresholds become model *inputs*;
  skew sketches pre-plan the salting JSPIM motivates);
* :meth:`CostModel.count_pushdown_wins` — SpMV count-pushdown vs the
  binary-join cascade (relational/planner.py consults it);
* :func:`annotate_plan` — stamps ``est_rows`` on every relational
  operator so EXPLAIN renders estimated vs chosen and
  ``opstats.divergences`` measures *model* error, not drift from a
  running mean.

The counterpart of ``caps_tpu/relational/cost.py``, host arithmetic
throughout.  Nothing in this package calls :func:`choose_dist_strategy`
or :meth:`CostModel.dist_strategy` yet (the sharded path is ROADMAP
Queue 1 item 12).  Counters go to the session's metrics registry
(``obs/metrics.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.okapi.types import _CTNode, _CTRelationship
from caps_tpu_torch.relational.stats import EMPTY_STATS, GraphStatistics

#: modeled bytes one row moves through an operator launch (id + a few
#: payload columns — a deliberate coarse constant: relative costs drive
#: every decision, absolute bytes only scale them)
ROW_BYTES = 24

#: equality-predicate distinct-count fallback when the sketch has none
DEFAULT_EQ_DISTINCT = 10

#: modeled cost of ONE program dispatch, in bytes-equivalent (host
#: orchestration + launch latency ≈ this much HBM traffic; ~10us at
#: v5e bandwidth).  Only priced where the compared structures differ in
#: LAUNCH COUNT — the fused count SpMV is one recorded program, the
#: join cascade pays 1 + 2 x hops operator launches.  Join-order
#: enumeration never includes it: both orientations of a chain launch
#: the same operator count, so the constant cancels.
LAUNCH_OVERHEAD_BYTES = ROW_BYTES * 32_768

#: reversal hysteresis: a chain only re-roots when the other end is at
#: least this much cheaper (plan churn on noisy estimates is worse than
#: a mildly sub-optimal order)
REORDER_MARGIN = 0.7

#: calibration needs at least this many recorded executions before the
#: observed mean overrides the model estimate
_CALIBRATE_MIN_EXECUTIONS = 2

#: modeled bytes per WCOJ frontier row: the multiway join's
#: intermediates are narrow int columns (ids + scan rows), not the
#: cascade's full-width materialized tables (relational/wcoj.py)
WCOJ_ROW_BYTES = 8


def choose_dist_strategy(probe_rows: int, build_rows: int, n_shards: int,
                         config, skew: float = 1.0
                         ) -> Tuple[str, Dict[str, Any]]:
    """Distribution strategy for one sharded join, in modeled wire
    bytes: ``broadcast`` gathers the build side to every device once
    (``build × (n-1)``), ``radix`` exchanges both sides once
    (``probe + build``), ``salted`` is radix with hot-key replication
    when the skew sketch predicts one device would drown.

    ``config.broadcast_join_threshold`` is the model's *prior* (a build
    side at or under it always broadcasts — the Spark
    autoBroadcastJoinThreshold contract callers rely on; <= 0 disables
    broadcasting entirely), and above it the modeled wire costs decide.
    ``config.join_hot_factor`` is the salting trigger: a sketch skew at
    or beyond it plans the salt instead of waiting for the runtime
    hot-key sample to react.  With ``config.use_cost_model`` off, only
    the threshold prior applies — the pre-item-3 fixed heuristic, which
    is also what the runtime dist-join call site must restore (the
    ``bench.py plan`` baseline contract)."""
    probe_rows = max(0, int(probe_rows))
    build_rows = max(0, int(build_rows))
    n = max(2, int(n_shards))
    threshold = int(getattr(config, "broadcast_join_threshold", 0) or 0)
    wire_broadcast = build_rows * (n - 1) * ROW_BYTES
    wire_radix = (probe_rows + build_rows) * ROW_BYTES
    info: Dict[str, Any] = {
        "probe_rows": probe_rows, "build_rows": build_rows,
        "shards": n, "wire_broadcast": wire_broadcast,
        "wire_radix": wire_radix, "skew": round(float(skew), 3),
    }
    if threshold > 0 and build_rows <= threshold:
        info["reason"] = "build<=threshold"
        return "broadcast", info
    if not bool(getattr(config, "use_cost_model", True)):
        # model off: the old threshold-only heuristic, nothing else
        info["reason"] = "exchange"
        return "radix", info
    if threshold > 0 and wire_broadcast * 2 < wire_radix \
            and build_rows <= threshold * 8:
        # decisively cheaper on the wire (2x margin keeps the modeled
        # call conservative where the prior said exchange) — but the
        # threshold stays a MEMORY cap: gathering the build side to
        # every device is bounded at a small multiple of it, never by
        # wire arithmetic alone
        info["reason"] = "wire_model"
        return "broadcast", info
    hot_factor = float(getattr(config, "join_hot_factor", 4.0) or 4.0)
    if skew >= hot_factor:
        info["reason"] = "skew_sketch"
        return "salted", info
    info["reason"] = "exchange"
    return "radix", info


class CostModel:
    """One query's pricing context: graph statistics + shape lattice +
    observed-actuals calibration + the decision log EXPLAIN renders."""

    def __init__(self, stats: Optional[GraphStatistics] = None,
                 lattice=None, op_stats=None, compile_ledger=None,
                 config=None, family: Optional[str] = None,
                 registry=None):
        self.stats = stats if stats is not None else EMPTY_STATS
        self.lattice = lattice
        self.op_stats = op_stats
        self.compile_ledger = compile_ledger
        self.config = config
        self.family = family
        #: decision log — ``render_decisions`` becomes plans["cost"]
        self.decisions: List[Dict[str, Any]] = []
        self._registry = registry
        #: per-op observed means for this family (lazy snapshot)
        self._history: Optional[Dict[str, Dict[str, Any]]] = None

    # -- device pricing -------------------------------------------------

    def padded_rows(self, rows: float) -> int:
        n = max(1, int(rows))
        if self.lattice is not None:
            return int(self.lattice.bucket(n))
        return n

    def device_cost(self, rows: float) -> float:
        """Padded bytes one launch moves, plus the compile-risk
        surcharge for a bucket beyond every boundary the lattice has
        seen (a brand-new bucket is a brand-new XLA program)."""
        padded = self.padded_rows(rows)
        cost = float(padded * ROW_BYTES)
        if self.lattice is not None:
            bounds = self.lattice.boundaries()
            if bounds and padded > bounds[-1]:
                cost *= 2.0  # un-compiled shape: price the cliff in
        return cost

    # -- cardinality estimation ----------------------------------------

    def scan_rows(self, labels: Iterable[str] = ()) -> float:
        return float(max(1, self.stats.node_cardinality(labels)))

    def rel_scan_rows(self, rel_types: Iterable[str] = ()) -> float:
        return float(max(1, self.stats.rel_cardinality(rel_types)))

    def degree(self, rel_types: Iterable[str],
               direction: Direction) -> float:
        out = self.stats.degree_per_node(rel_types, outgoing=True)
        inn = self.stats.degree_per_node(rel_types, outgoing=False)
        if direction == Direction.OUTGOING:
            return out
        if direction == Direction.INCOMING:
            return inn
        return out + inn  # BOTH: either orientation matches

    def predicate_selectivity(self, pred: E.Expr,
                              labels: Iterable[str] = ()) -> float:
        """Coarse selectivity of one predicate over rows of a var with
        ``labels``: equality estimates from the per-property distinct
        sketch, ranges 1/3, labels their population fraction."""
        if isinstance(pred, E.Ands):
            s = 1.0
            for p in pred.exprs:
                s *= self.predicate_selectivity(p, labels)
            return s
        if isinstance(pred, E.HasLabel):
            return self.stats.label_fraction({pred.label})
        if isinstance(pred, E.Equals):
            prop = None
            for side in (pred.lhs, pred.rhs):
                if isinstance(side, E.Property) \
                        and isinstance(side.entity, E.Var):
                    prop = side
            if prop is not None:
                distinct = self.stats.eq_distinct(labels, prop.key)
                if distinct is None:
                    distinct = DEFAULT_EQ_DISTINCT
                return 1.0 / max(1, distinct)
            return 0.1
        if isinstance(pred, (E.LessThan,)) or \
                type(pred).__name__ in ("LessThanOrEqual", "GreaterThan",
                                        "GreaterThanOrEqual"):
            return 1.0 / 3.0
        if isinstance(pred, E.Not):
            return max(0.0, 1.0 - self.predicate_selectivity(pred.expr,
                                                             labels))
        return 0.5

    def selectivity(self, preds: Sequence[E.Expr],
                    labels: Iterable[str] = ()) -> float:
        s = 1.0
        for p in preds:
            s *= self.predicate_selectivity(p, labels)
        return max(s, 1e-9)

    # -- chain costing (join-order enumeration) -------------------------

    def chain_cost(self, seed_labels: Iterable[str], seed_sel: float,
                   hops: Sequence[Tuple[Tuple[str, ...], Direction,
                                        Iterable[str], float]]
                   ) -> Tuple[float, List[float]]:
        """Price one orientation of an Expand chain.  ``hops`` is
        ``(rel_types, direction, target_labels, target_selectivity)``
        per hop; returns (total padded-device cost, per-step estimated
        rows — seed first)."""
        rows = self.scan_rows(seed_labels) * max(seed_sel, 1e-9)
        cost = self.device_cost(rows)
        ests = [rows]
        for rel_types, direction, tgt_labels, tgt_sel in hops:
            rows = (rows * self.degree(rel_types, direction)
                    * self.stats.label_fraction(tgt_labels)
                    * max(tgt_sel, 1e-9))
            # an Expand is two joins (rel scan + target node scan): the
            # launch pays the expanded frontier both times
            cost += 2.0 * self.device_cost(rows)
            ests.append(rows)
        return cost, ests

    def chain_orientation(self, fwd_cost: float,
                          rev_cost: float) -> bool:
        """True = reverse the chain (re-root at the far end)."""
        return rev_cost < fwd_cost * REORDER_MARGIN

    # -- physical choices ----------------------------------------------

    def count_pushdown_wins(self, seed_labels: Iterable[str],
                            seed_sel: float,
                            hops: Sequence[Tuple[Tuple[str, ...],
                                                 Direction,
                                                 Iterable[str],
                                                 float]]) -> bool:
        """SpMV count-pushdown vs the binary-join cascade: the pushdown
        touches EVERY edge of each hop's type once (dense-vector SpMV
        over the adjacency) but is ONE fused program; the cascade
        touches only the (padded) expanded frontier but pays a launch
        per operator.  A highly selective seed on a huge graph can make
        the cascade cheaper — exactly the physical choice ROADMAP
        item 3 asks the model, not a heuristic, to make."""
        cascade_cost, _ests = self.chain_cost(seed_labels, seed_sel, hops)
        cascade_cost += (1 + 2 * len(hops)) * LAUNCH_OVERHEAD_BYTES
        spmv_cost = LAUNCH_OVERHEAD_BYTES \
            + self.device_cost(self.stats.total_nodes or 1)
        for rel_types, _d, _tl, _ts in hops:
            spmv_cost += self.device_cost(self.rel_scan_rows(rel_types))
        # the fused program has no intermediate materialization and no
        # per-op host orchestration; the cascade must be decisively
        # cheaper in modeled bytes (4x) before the model routes around
        # the SpMV
        decision = spmv_cost <= cascade_cost * 4.0
        self.note("count_strategy",
                  chosen="fused-spmv" if decision else "cascade",
                  spmv_cost=round(spmv_cost, 1),
                  cascade_cost=round(cascade_cost, 1))
        return decision

    def algo_pushdown_wins(self, procedure: str,
                           est_iterations: int = 1) -> bool:
        """Device fixed-shape fixpoint vs the host NumPy kernel for one
        ``CALL algo.*`` (algo/): the device pays one launch
        plus per-iteration padded SpMV traffic over nodes + edges; the
        host streams the same arrays through sequential NumPy at a
        modeled per-byte penalty (no vector lanes, no overlap).  Tiny
        graphs — where the pad-to-bucket waste dwarfs the work — stay on
        the host; anything dense amortizes the launch in one iteration."""
        nodes = float(max(1, self.stats.total_nodes))
        edges = float(max(1, self.stats.total_rels))
        iters = max(1, int(est_iterations))
        device = LAUNCH_OVERHEAD_BYTES + iters * (
            self.device_cost(edges) + self.device_cost(nodes))
        host = iters * (edges + nodes) * ROW_BYTES * 8.0
        decision = device <= host
        self.note("algo_strategy", procedure=procedure,
                  chosen="device-fixpoint" if decision else "host",
                  device_cost=round(device, 1), host_cost=round(host, 1),
                  est_iterations=iters)
        return decision

    def closure_selectivity(self, rel_types: Iterable[str]) -> float:
        """Expected multiplicity of edges of these types between two
        SPECIFIC bound nodes — edge cardinality over the squared node
        population.  Deliberately DIRECTION-FREE: a pair probe hits the
        stored orientation whichever way the pattern arrow was written,
        and the per-direction degree sketches (edge count over distinct
        endpoints) overestimate pair existence badly on hub-skewed
        graphs — exactly where the WCOJ win is largest.  This is the
        semi-filter selectivity a closing edge applies the moment its
        endpoints bind (the early filter the cascade defers)."""
        n = max(1, self.stats.total_nodes)
        return min(1.0, max(self.rel_scan_rows(rel_types), 1.0) / (n * n))

    def wcoj_vs_cascade(self, seed_labels: Iterable[str], seed_sel: float,
                        extends: Sequence[Tuple[Tuple[str, ...], Direction,
                                                Iterable[str], float,
                                                Sequence[Tuple[str, ...]]]],
                        closes: Sequence[Tuple[str, ...]]
                        ) -> Tuple[bool, float, Dict[str, Any]]:
        """The WCOJ-vs-binary-cascade decision surface (ROADMAP item 4),
        priced from the ingest-time degree/skew sketches.

        ``extends`` is one entry per bound vertex beyond the seed:
        ``(anchor_rel_types, anchor_direction, target_labels,
        target_selectivity, checks)`` where ``checks`` lists the
        rel-type tuples of the closing edges that semi-filter that
        vertex's candidates at bind time; ``closes`` the rel-type
        tuples of the pair-multiplicity closings.  The cascade pays the
        full OPEN chain (every frontier materialized at ``ROW_BYTES``
        width, closing joins applied only at the top); the multiway join
        pays the same expansions at ``WCOJ_ROW_BYTES`` narrow width but
        its frontiers shrink by ``closure_selectivity`` the moment a
        closing edge's endpoints bind — on dense cyclic patterns the
        intersection cost tracks the min-degree frontier while the
        cascade's intermediates blow up super-linearly.

        Returns ``(use_wcoj, estimated_output_rows, info)`` and logs the
        decision for EXPLAIN (the ``wcoj_strategy`` line next to the
        existing ``dist`` stamps)."""
        hops = [(a_types, a_dir, t_labels, t_sel)
                for a_types, a_dir, t_labels, t_sel, _checks in extends]
        cascade_cost, ests = self.chain_cost(seed_labels, seed_sel, hops)
        open_rows = ests[-1] if ests else 1.0
        for rel_types in closes:
            # one into-join (probe + pair filter) over the still-open
            # frontier, then the closure selectivity finally applies
            cascade_cost += 2.0 * self.device_cost(open_rows)
            open_rows = max(1.0, open_rows
                            * self.closure_selectivity(rel_types))
        narrow = WCOJ_ROW_BYTES / float(ROW_BYTES)
        rows = self.scan_rows(seed_labels) * max(seed_sel, 1e-9)
        wcoj_cost = narrow * self.device_cost(rows)
        for a_types, a_dir, t_labels, t_sel, checks in extends:
            transient = rows * max(self.degree(a_types, a_dir), 1e-9)
            wcoj_cost += narrow * self.device_cost(transient)
            rows = (transient * self.stats.label_fraction(t_labels)
                    * max(t_sel, 1e-9))
            for c_types in checks:
                rows *= self.closure_selectivity(c_types)
            rows = max(rows, 1.0)
            wcoj_cost += narrow * self.device_cost(rows)
        for _rel_types in closes:
            wcoj_cost += narrow * self.device_cost(rows)
        est_rows = max(1.0, rows)
        wcoj_cost += self.device_cost(est_rows)  # the one full-width gather
        decision = wcoj_cost <= cascade_cost
        info = {"wcoj_cost": round(wcoj_cost, 1),
                "cascade_cost": round(cascade_cost, 1),
                "est_rows": int(round(est_rows))}
        self.note("wcoj_strategy",
                  chosen="wcoj" if decision else "cascade", **info)
        return decision, est_rows, info

    def dist_strategy(self, probe_rows: float, build_rows: float,
                      n_shards: int,
                      rel_types: Iterable[str] = ()
                      ) -> Tuple[str, Dict[str, Any]]:
        """Planned distribution strategy for one sharded join, with the
        skew SKETCH (not a runtime sample) as the salting signal."""
        skew = self.stats.skew(rel_types) if rel_types else 1.0
        return choose_dist_strategy(probe_rows, build_rows, n_shards,
                                    self.config, skew=skew)

    # -- calibration (observed actuals beat the prior) ------------------

    def _family_history(self) -> Dict[str, Dict[str, Any]]:
        if self._history is None:
            hist: Dict[str, Dict[str, Any]] = {}
            if self.op_stats is not None and self.family is not None:
                try:
                    hist = self.op_stats.stats(self.family)
                except Exception:  # pragma: no cover — advisory only
                    hist = {}
            self._history = hist
        return self._history

    def calibrated_rows(self, op_id: int, op_name: str,
                        model_rows: float) -> Tuple[float, str]:
        """(estimate, source): the observed per-op row mean when this
        (family, operator) has enough history, else the model prior."""
        st = self._family_history().get(f"{op_id}:{op_name}")
        if st is not None and \
                st.get("executions", 0) >= _CALIBRATE_MIN_EXECUTIONS:
            return float(st.get("rows_mean") or 0.0), "observed"
        return model_rows, "model"

    # -- decision log ---------------------------------------------------

    def note(self, kind: str, **fields) -> None:
        self.decisions.append({"kind": kind, **fields})

    def render_decisions(self) -> str:
        """The plans["cost"] text EXPLAIN carries: one line per model
        decision (estimated alternatives and the chosen one)."""
        lines = []
        for d in self.decisions:
            extra = ", ".join(f"{k}={v}" for k, v in d.items()
                              if k != "kind")
            lines.append(f"{d['kind']}: {extra}")
        return "\n".join(lines)


# -- plan annotation ---------------------------------------------------------


def _scan_est(model: CostModel, op) -> float:
    m = op.entity_type.material
    if isinstance(m, _CTNode):
        return model.scan_rows(m.labels)
    if isinstance(m, _CTRelationship):
        return model.rel_scan_rows(m.rel_types)
    return 1.0


def _join_est(model: CostModel, op, l_est: float, r_est: float) -> float:
    """Estimate a JoinOp's output: the Expand shapes the planner emits
    (probe × rel scan on an endpoint, then × target node scan) price as
    degree expansion / label-fraction selection; anything else as a
    conservative max."""
    from caps_tpu_torch.relational import ops as R
    rhs = op.children[1]
    if isinstance(rhs, R.ScanOp):
        m = rhs.entity_type.material
        if isinstance(m, _CTRelationship):
            near = op.pairs[0][1] if op.pairs else None
            direction = Direction.OUTGOING \
                if isinstance(near, E.StartNode) else Direction.INCOMING
            est = l_est * model.degree(m.rel_types, direction)
            if len(op.pairs) > 1:  # into-join: both endpoints bound
                est /= max(1, model.stats.total_nodes)
            return est
        if isinstance(m, _CTNode):
            return l_est * model.stats.label_fraction(m.labels)
    return max(l_est, r_est)


def annotate_plan(root, model: CostModel) -> Dict[str, Any]:
    """Stamp ``est_rows`` (and, on sharded joins, ``dist_strategy``)
    onto every relational operator, bottom-up.  The estimates ride into
    each execution's op metrics (relational/ops.py), so the observed-
    statistics store measures *model* error and EXPLAIN renders
    estimated-vs-chosen with zero extra plumbing.  Returns a summary
    for the result metrics."""
    from caps_tpu_torch.algo.op import AlgoProcedureOp
    from caps_tpu_torch.relational import ops as R
    from caps_tpu_torch.relational.count_pattern import CountPatternOp
    from caps_tpu_torch.relational.var_expand import VarExpandOp
    from caps_tpu_torch.relational.wcoj import MultiwayJoinOp

    config = model.config
    n_shards = 0
    if config is not None and getattr(config, "mesh_shape", ()):
        n_shards = 1
        for d in config.mesh_shape:
            n_shards *= int(d)

    seen: Dict[int, float] = {}
    order: List[Any] = []
    stack = [root]
    while stack:  # post-order without recursion (plans can be deep)
        op = stack.pop()
        if id(op) in seen:
            continue
        seen[id(op)] = -1.0
        order.append(op)
        stack.extend(op.children)
    history = model._family_history()
    if history:
        live_keys = {f"{op.op_id}:{type(op).__name__.removesuffix('Op')}"
                     for op in order}
        # a SUBSET of the live ids is the same plan shape with lazily
        # skipped children (a count-pushdown's fallback cascade never
        # executes, so only the CountPattern op ever records) — history
        # is stale only when it names ids the live plan does not have
        if not set(history) <= live_keys:
            # the recorded history describes a DIFFERENT plan shape (a
            # re-plan re-rooted the chain or changed a physical
            # strategy): operator ids do not transfer across shapes, so
            # calibrating against it would alias row means onto
            # unrelated operators.  Drop it — locally and in the store,
            # where continued recording under stale ids would blend two
            # plans' row streams — and let history restart under the
            # live shape.
            model._history = {}
            if model.op_stats is not None and model.family is not None:
                try:
                    model.op_stats.reset_family(model.family)
                except Exception:  # pragma: no cover — advisory only
                    pass
    annotated = 0
    for op in reversed(order):
        kids = [seen.get(id(c), 1.0) for c in op.children]
        l_est = kids[0] if kids else 1.0
        if isinstance(op, R.StartOp):
            est = 1.0
        elif isinstance(op, R.ScanOp):
            est = _scan_est(model, op)
        elif isinstance(op, CountPatternOp):
            est = 1.0
        elif isinstance(op, MultiwayJoinOp):
            # priced at plan time by wcoj_vs_cascade; the cascade child
            # never executes on the healthy path, so its estimates do
            # not flow up
            est = max(1.0, float(op.planned_rows))
        elif isinstance(op, AlgoProcedureOp):
            # one yielded row per snapshot node (BFS/SSSP emit fewer —
            # reachable only — but the full population bounds it)
            est = max(1.0, float(model.stats.total_nodes))
        elif isinstance(op, VarExpandOp):
            est, frontier = 0.0, l_est
            for length in range(1, op.upper + 1):
                frontier *= model.degree(op.rel_types, op.direction)
                if length >= op.lower:
                    est += frontier * model.stats.label_fraction(
                        op.target_labels)
            est = max(est, 1.0)
        elif isinstance(op, R.JoinOp):
            est = _join_est(model, op, l_est, kids[1] if len(kids) > 1
                            else 1.0)
            if n_shards > 1 and config is not None \
                    and getattr(config, "use_dist_join", False):
                rhs = op.children[1]
                rel_types: Tuple[str, ...] = ()
                if isinstance(rhs, R.ScanOp):
                    m = rhs.entity_type.material
                    if isinstance(m, _CTRelationship):
                        rel_types = tuple(m.rel_types)
                strategy, info = model.dist_strategy(
                    l_est, kids[1] if len(kids) > 1 else 1.0,
                    n_shards, rel_types)
                op.dist_strategy = strategy
                model.note("dist", op=f"{op.op_id}:Join",
                           chosen=strategy, **info)
        elif isinstance(op, R.FilterOp):
            labels: Iterable[str] = ()
            vs = {v.name for v in E.vars_in(op.predicate)}
            if len(vs) == 1:
                # resolve the predicate var's labels from the Scan that
                # binds it, so equality selectivity reads the
                # per-property distinct sketch instead of the fallback
                var = next(iter(vs))
                walk = [op]
                while walk:
                    node = walk.pop()
                    if isinstance(node, R.ScanOp) and node.var == var:
                        m = node.entity_type.material
                        if isinstance(m, _CTNode):
                            labels = tuple(m.labels)
                        break
                    walk.extend(node.children)
            est = l_est * model.selectivity([op.predicate], labels)
        elif isinstance(op, R.CrossOp):
            est = l_est * (kids[1] if len(kids) > 1 else 1.0)
        elif isinstance(op, R.UnionAllOp):
            est = sum(kids)
        elif isinstance(op, (R.OptionalJoinOp, R.ExistsJoinOp)):
            est = l_est
        elif isinstance(op, R.AggregateOp):
            est = 1.0 if not op.group else max(1.0, l_est ** 0.5)
        elif isinstance(op, R.DistinctOp):
            est = max(1.0, l_est * 0.9)
        elif isinstance(op, R.UnwindOp):
            est = l_est * 4.0
        else:  # Project/Select/OrderBy/Skip/Limit/RowIndex/...: carry
            est = l_est
        est, source = model.calibrated_rows(
            op.op_id, type(op).__name__.removesuffix("Op"), est)
        op.est_rows = max(0, int(round(est)))
        op.est_source = source
        seen[id(op)] = max(est, 0.0)
        annotated += 1
    if model._registry is not None:
        model._registry.counter("cost.annotated_ops").inc(annotated)
    return {
        "root_est_rows": int(round(seen.get(id(root), 0.0))),
        "annotated_ops": annotated,
        "decisions": list(model.decisions),
    }
