"""Logical plan optimizer.

Mirrors the reference's ``LogicalOptimizer`` rewrites: label pushdown into
scans and filter pushdown toward the sources (ref:
okapi-logical/.../logical/impl/LogicalOptimizer.scala — reconstructed,
mount empty; SURVEY.md §2).

Both rewrites matter much more here than on Spark: filtering before an
``Expand`` shrinks the gather/join the device executes, and narrowing scan
labels picks a smaller node table outright.

With a cost model attached (relational/cost.py — ROADMAP item 3) the
optimizer additionally runs **cost-ranked join-order enumeration** over
Expand chains: a linear pattern ``(v0)-[r1]->(v1)-...->(vk)`` can be
rooted at either end, and the two orientations' padded-device costs
(seeded by the ingest-time statistics sketch and calibrated by observed
actuals) decide which end scans.  A selective predicate at the FAR end
of a chain — ``MATCH (a)-[:L]->(t) WHERE t.name = $x`` — re-roots the
scan at ``t`` and walks the edges backwards, shrinking every frontier
the device launches.  The enumeration is bounded (a chain has exactly
two roots) and conservative: reversal needs a ``REORDER_MARGIN`` win,
Optional/Exists subtrees are opaque (their rhs embeds the lhs as a
structural prefix relational planning matches by equality), and
var-length / into / repeated-var shapes are left alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional as Opt, Tuple

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.logical import ops as L
from caps_tpu_torch.okapi.types import CTNode, CTRelationship


_MISSING = object()


def _flip(d: Direction) -> Direction:
    if d == Direction.OUTGOING:
        return Direction.INCOMING
    if d == Direction.INCOMING:
        return Direction.OUTGOING
    return d  # BOTH is orientation-free


# -- cyclic-segment analysis (shared with relational/wcoj.py) ----------------
#
# The generalization of count_pattern.py's CountCycleOp matcher from
# count-only triangles to ARBITRARY cyclic MATCH shapes: a maximal
# Filter*/Expand segment over one NodeScan(Start) whose Expands include
# at least one ``into`` edge (both endpoints already bound — the closing
# edge of a cycle).  The relational planner substitutes a worst-case-
# optimal MultiwayJoinOp for the whole segment; this optimizer skips
# chain re-rooting inside it (the WCOJ operator prices its own binding
# anchors, so enumerating cascade orientations for a segment the
# cascade will not execute is plan churn and a misleading EXPLAIN
# decision line).


@dataclasses.dataclass(frozen=True)
class EdgeRef:
    """One pattern edge in STORED orientation (``frm`` -> ``to`` is the
    direction edges lie in the relationship table, regardless of how the
    MATCH arrow was written)."""
    rel: str
    rel_types: Tuple[str, ...]
    frm: str
    to: str
    closing: bool
    intro: Opt[str]  # the node var this edge introduced (None if closing)


@dataclasses.dataclass(frozen=True)
class CyclicSegment:
    scan: "L.NodeScan"
    seed: str
    order: Tuple[str, ...]               # binding order: seed + targets
    labels: Tuple[Tuple[str, frozenset], ...]
    edges: Tuple[EdgeRef, ...]           # plan order (bottom-up)
    node_preds: Tuple[Tuple[str, Tuple[E.Expr, ...]], ...]
    rel_preds: Tuple[Tuple[str, Tuple[E.Expr, ...]], ...]
    uniq_pairs: Tuple[Tuple[str, str], ...]

    def labels_of(self, var: str) -> frozenset:
        return dict(self.labels).get(var, frozenset())


def _split_conjuncts(pred: E.Expr) -> Tuple[E.Expr, ...]:
    if isinstance(pred, E.Ands):
        out: List[E.Expr] = []
        for p in pred.exprs:
            out.extend(_split_conjuncts(p))
        return tuple(out)
    return (pred,)


def _uniqueness_pair(pred: E.Expr) -> Opt[Tuple[str, str]]:
    """``NOT id(r1) = id(r2)`` — the relationship-isomorphism filter the
    IR builder emits between pattern rels."""
    if (isinstance(pred, E.Not) and isinstance(pred.expr, E.Equals)
            and isinstance(pred.expr.lhs, E.Id)
            and isinstance(pred.expr.rhs, E.Id)
            and isinstance(pred.expr.lhs.entity, E.Var)
            and isinstance(pred.expr.rhs.entity, E.Var)):
        return (pred.expr.lhs.entity.name, pred.expr.rhs.entity.name)
    return None


def _plain_single_var(pred: E.Expr) -> Opt[str]:
    """The single var a predicate reads, or None when it reads several /
    none / contains a subquery (EXISTS patterns carry scope this
    name-level analysis does not model)."""
    vs = {v.name for v in E.vars_in(pred)}
    if len(vs) != 1:
        return None
    stack: List[E.Expr] = [pred]
    while stack:
        x = stack.pop()
        if isinstance(x, E.ExistsSubQuery):
            return None
        stack.extend(c for c in x.children if isinstance(c, E.Expr))
    return next(iter(vs))


def match_cyclic_segment(head: "L.LogicalOperator") -> Opt[CyclicSegment]:
    """Match the Filter*/Expand segment under (and including) ``head``
    as a cyclic pattern: fixed single-orientation hops over one
    ``NodeScan(Start)``, every non-into Expand growing from a bound var
    to a NEW var, plus >= 1 ``into`` (closing) edge.  Predicates inside
    the segment must be absorbable — single-var node/rel predicates or
    rel-uniqueness pairs — because the substituted operator replaces the
    whole subtree.  Returns None (cascade) for anything else."""
    if not isinstance(head, L.Expand) or not head.into \
            or head.direction == Direction.BOTH:
        return None
    filters: List[E.Expr] = []
    expands: List[L.Expand] = []
    cur: L.LogicalOperator = head
    while True:
        if isinstance(cur, L.Filter):
            filters.extend(_split_conjuncts(cur.predicate))
            cur = cur.parent
        elif isinstance(cur, L.Expand):
            if cur.direction == Direction.BOTH:
                return None
            expands.append(cur)
            cur = cur.parent
        elif isinstance(cur, L.NodeScan):
            if not isinstance(cur.parent, L.Start) \
                    or cur.parent.qgn is not None:
                return None
            scan = cur
            break
        else:
            return None
    expands.reverse()  # bottom-up: plan order

    bound = {scan.var}
    order: List[str] = [scan.var]
    labels: Dict[str, frozenset] = {scan.var: frozenset(scan.labels)}
    edges: List[EdgeRef] = []
    rel_vars: set = set()
    n_closing = 0
    for e in expands:
        if e.rel in rel_vars or e.rel in bound:
            return None  # repeated rel var / rel-node name collision
        frm, to = (e.source, e.target) \
            if e.direction == Direction.OUTGOING else (e.target, e.source)
        if e.into:
            if not {e.source, e.target} <= bound:
                return None
            if e.target_labels and not (
                    frozenset(e.target_labels)
                    <= labels.get(e.target, frozenset())):
                # labels restated on the closing mention must already be
                # implied by the var's own binding (the operator masks
                # each var once, at its scan)
                return None
            edges.append(EdgeRef(e.rel, tuple(sorted(set(e.rel_types))),
                                 frm, to, closing=True, intro=None))
            n_closing += 1
        else:
            if e.source not in bound or e.target in bound:
                return None  # not a forward extension of the bound set
            bound.add(e.target)
            order.append(e.target)
            labels[e.target] = frozenset(e.target_labels)
            edges.append(EdgeRef(e.rel, tuple(sorted(set(e.rel_types))),
                                 frm, to, closing=False, intro=e.target))
        rel_vars.add(e.rel)
    if n_closing == 0:
        return None  # acyclic chain: the binary cascade is already fine
    if rel_vars & bound:
        return None

    node_preds: Dict[str, List[E.Expr]] = {}
    rel_preds: Dict[str, List[E.Expr]] = {}
    uniq: List[Tuple[str, str]] = []
    for p in filters:
        pair = _uniqueness_pair(p)
        if pair is not None and set(pair) <= rel_vars:
            uniq.append(pair)
            continue
        var = _plain_single_var(p)
        if var is None:
            return None
        if var in bound:
            node_preds.setdefault(var, []).append(p)
        elif var in rel_vars:
            rel_preds.setdefault(var, []).append(p)
        else:
            return None
    return CyclicSegment(
        scan=scan, seed=scan.var, order=tuple(order),
        labels=tuple(labels.items()), edges=tuple(edges),
        node_preds=tuple((k, tuple(v)) for k, v in node_preds.items()),
        rel_preds=tuple((k, tuple(v)) for k, v in rel_preds.items()),
        uniq_pairs=tuple(uniq))


class LogicalOptimizer:
    def __init__(self, cost_model=None):
        # Optional/ExistsSemiJoin rhs trees embed the lhs chain as a shared
        # structural prefix that relational planning matches by equality to
        # thread the row-id tag.  While rewriting such an rhs, the embedded
        # lhs is a *barrier*: it is swapped for the already-rewritten lhs
        # and never descended into (and _push won't push predicates across
        # it), so the prefix stays structurally identical on both sides.
        self._barriers = {}
        #: relational/cost.py CostModel (None = heuristic-only: the
        #: pre-item-3 behavior, also the bench.py plan-mode baseline)
        self._model = cost_model

    def process(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        root = self._rewrite(plan.root)
        if self._model is not None:
            root = self._reorder(root)
        return L.LogicalPlan(root, plan.result_fields, plan.returns_graph)

    def _rewrite(self, op: L.LogicalOperator) -> L.LogicalOperator:
        rep = self._barriers.get(op, _MISSING)
        if rep is not _MISSING:
            return rep
        if isinstance(op, (L.Optional, L.ExistsSemiJoin)):
            new_lhs = self._rewrite(op.lhs)
            # Register the rewritten lhs too: once substituted into the rhs
            # it is what _push/_rewrite actually encounter there.
            saved = [(k, self._barriers.get(k, _MISSING))
                     for k in (op.lhs, new_lhs)]
            self._barriers[op.lhs] = new_lhs
            self._barriers[new_lhs] = new_lhs
            try:
                new_rhs = self._rewrite(op.rhs)
            finally:
                for k, prev in saved:
                    if prev is _MISSING:
                        self._barriers.pop(k, None)
                    else:
                        self._barriers[k] = prev
            return dataclasses.replace(op, lhs=new_lhs, rhs=new_rhs)
        op = op.map_children(
            lambda c: self._rewrite(c) if isinstance(c, L.LogicalOperator) else c)
        if isinstance(op, L.Filter):
            return self._optimize_filter(op)
        return op

    # -- filter / label pushdown -------------------------------------------

    def _optimize_filter(self, op: L.Filter) -> L.LogicalOperator:
        conjuncts = self._split(op.predicate)
        child = op.parent
        remaining = []
        for pred in conjuncts:
            pushed = self._push(child, pred)
            if pushed is None:
                remaining.append(pred)
            else:
                child = pushed
        if not remaining:
            return child
        if child is op.parent and len(remaining) == len(conjuncts):
            return op  # nothing changed: preserve sharing for Optional planning
        pred = remaining[0] if len(remaining) == 1 else E.Ands(tuple(remaining))
        return L.Filter(child, pred, fields=child.fields)

    @staticmethod
    def _split(pred: E.Expr) -> Tuple[E.Expr, ...]:
        if isinstance(pred, E.Ands):
            out = []
            for p in pred.exprs:
                out.extend(LogicalOptimizer._split(p))
            return tuple(out)
        return (pred,)

    def _push(self, op: L.LogicalOperator, pred: E.Expr
              ) -> Opt[L.LogicalOperator]:
        """Try to push ``pred`` below ``op``; returns the rewritten operator
        or None if the predicate must stay above."""
        if op in self._barriers:
            return None  # never rewrite across an Optional/Exists lhs prefix
        needed = {v.name for v in E.vars_in(pred)}

        # Label predicate meeting its producing scan/expand: absorb it.
        if isinstance(pred, E.HasLabel) and isinstance(pred.node, E.Var):
            var = pred.node.name
            if isinstance(op, L.NodeScan) and op.var == var:
                labels = frozenset(op.labels | {pred.label})
                return L.NodeScan(op.parent, var, labels,
                                  fields=((var, CTNode(labels)),))
            if isinstance(op, (L.Expand, L.BoundedVarLengthExpand)) \
                    and op.target == var and not op.into:
                labels = frozenset(op.target_labels | {pred.label})
                new_fields = tuple(
                    (n, CTNode(labels)) if n == var else (n, t)
                    for n, t in op.fields)
                return dataclasses.replace(op, target_labels=labels,
                                           fields=new_fields)

        if isinstance(op, L.Filter):
            inner = self._push(op.parent, pred)
            if inner is not None:
                return L.Filter(inner, op.predicate, fields=inner.fields)
            return None
        if isinstance(op, (L.Expand, L.BoundedVarLengthExpand)):
            introduced = {op.rel} | ({op.target} if not op.into else set())
            if needed & introduced:
                return None
            inner = self._push(op.parent, pred)
            if inner is None:
                inner = L.Filter(op.parent, pred, fields=op.parent.fields)
            return dataclasses.replace(op, parent=inner)
        if isinstance(op, L.CartesianProduct):
            lhs_names = set(op.lhs.field_names)
            rhs_names = set(op.rhs.field_names)
            if needed <= lhs_names:
                inner = self._push(op.lhs, pred) or \
                    L.Filter(op.lhs, pred, fields=op.lhs.fields)
                return L.CartesianProduct(inner, op.rhs, fields=op.fields)
            if needed <= rhs_names:
                inner = self._push(op.rhs, pred) or \
                    L.Filter(op.rhs, pred, fields=op.rhs.fields)
                return L.CartesianProduct(op.lhs, inner, fields=op.fields)
            return None
        if isinstance(op, L.FromGraph):
            inner = self._push(op.parent, pred)
            if inner is None:
                return None
            return L.FromGraph(inner, op.qgn, fields=inner.fields)
        # NodeScan (different var), Start, Optional, Aggregate, Project,
        # Select, Distinct, OrderBy, Skip, Limit, Unwind, unions: stop here.
        return None

    # -- cost-ranked join-order enumeration (chain re-rooting) -------------

    def _reorder(self, op: L.LogicalOperator) -> L.LogicalOperator:
        """Walk the plan; at the head of every maximal Filter/Expand
        chain, enumerate both roots and keep the cheaper orientation.
        Optional/Exists subtrees are opaque (see class docstring)."""
        if isinstance(op, (L.Optional, L.ExistsSemiJoin)):
            return op
        # NOTE: chains below a cyclic segment's closing edge still
        # re-root here — the WCOJ substitution (relational/wcoj.py)
        # consumes the REORDERED segment (a reversed chain is still a
        # valid cyclic segment, rooted at the cheaper end), and when
        # substitution does NOT happen (oracle sessions, wcoj priced
        # out, use_wcoj off) the cascade must keep the cost-model chain
        # orientation.
        if isinstance(op, (L.Filter, L.Expand)):
            matched, replacement = self._try_reverse(op)
            if matched:
                # whether reversed or kept, this segment was enumerated
                # once — never re-enumerate its inner sub-chains
                return replacement if replacement is not None else op
        return op.map_children(
            lambda c: self._reorder(c)
            if isinstance(c, L.LogicalOperator) else c)

    def _match_chain(self, head: L.LogicalOperator):
        """Match the subtree under ``head`` as ``Filter*/Expand`` chain
        segments over one ``NodeScan(Start)``.  Returns (scan, hops
        bottom-up, predicates) or None.  Constraints mirror the
        count-pushdown matcher: fixed hops only, no into, all node and
        rel vars distinct (a repeated var is a cycle — its join order is
        not a chain's)."""
        preds: List[E.Expr] = []
        hops_top_down: List[L.Expand] = []
        cur = head
        while True:
            if isinstance(cur, L.Filter):
                preds.extend(LogicalOptimizer._split(cur.predicate))
                cur = cur.parent
            elif isinstance(cur, L.Expand):
                if cur.into or cur in self._barriers:
                    return None
                hops_top_down.append(cur)
                cur = cur.parent
            elif isinstance(cur, L.NodeScan):
                if not isinstance(cur.parent, L.Start) \
                        or cur.parent.qgn is not None \
                        or cur in self._barriers:
                    return None
                scan = cur
                break
            else:
                return None
        if not hops_top_down:
            return None
        hops = list(reversed(hops_top_down))  # bottom-up: hop 1 first
        expected = scan.var
        for h in hops:
            if h.source != expected:
                return None  # star/branch shape, not a chain
            expected = h.target
        node_vars = [scan.var] + [h.target for h in hops]
        rel_vars = [h.rel for h in hops]
        if len(set(node_vars)) != len(node_vars) \
                or len(set(rel_vars)) != len(rel_vars):
            return None
        return scan, hops, preds

    def _try_reverse(self, head: L.LogicalOperator):
        """(matched, replacement): enumerate the chain under ``head``
        both ways; ``replacement`` is the reversed chain when the model
        prices it decisively cheaper, else None (keep)."""
        got = self._match_chain(head)
        if got is None:
            return False, None
        scan, hops, preds = got
        model = self._model
        preds_by_var: Dict[str, List[E.Expr]] = {}
        for p in preds:
            vs = {v.name for v in E.vars_in(p)}
            if len(vs) == 1:
                preds_by_var.setdefault(next(iter(vs)), []).append(p)

        def sel(var: str, labels) -> float:
            return model.selectivity(preds_by_var.get(var, ()), labels)

        labels_of = {scan.var: scan.labels}
        for h in hops:
            labels_of[h.target] = h.target_labels
        fwd_cost, _ = model.chain_cost(
            scan.labels, sel(scan.var, scan.labels),
            [(h.rel_types, h.direction, h.target_labels,
              sel(h.target, h.target_labels)) for h in hops])
        rev_seed = hops[-1].target
        rev_hops_desc = []
        for j in range(len(hops) - 1, -1, -1):
            h = hops[j]
            tgt = hops[j - 1].target if j > 0 else scan.var
            rev_hops_desc.append((h.rel_types, _flip(h.direction),
                                  labels_of[tgt], sel(tgt,
                                                      labels_of[tgt])))
        rev_cost, _ = model.chain_cost(
            labels_of[rev_seed], sel(rev_seed, labels_of[rev_seed]),
            rev_hops_desc)
        reverse = model.chain_orientation(fwd_cost, rev_cost)
        model.note("join_order",
                   chain="->".join(v for v in labels_of),
                   fwd_cost=round(fwd_cost, 1),
                   rev_cost=round(rev_cost, 1),
                   chosen="reversed" if reverse else "forward")
        if not reverse:
            return True, None
        # rebuild: scan the far end, walk the edges backwards
        env: Dict[str, object] = {}
        for node in [scan] + hops:
            env.update(dict(node.fields))
        seed_labels = labels_of[rev_seed]
        out: L.LogicalOperator = L.NodeScan(
            scan.parent, rev_seed, seed_labels,
            fields=((rev_seed, CTNode(seed_labels)),))
        for j in range(len(hops) - 1, -1, -1):
            h = hops[j]
            tgt = hops[j - 1].target if j > 0 else scan.var
            rel_type = env.get(h.rel) or CTRelationship(
                frozenset(h.rel_types))
            new_fields = out.fields + ((h.rel, rel_type),
                                       (tgt, CTNode(labels_of[tgt])))
            out = L.Expand(out, h.target, h.rel, h.rel_types, tgt,
                           labels_of[tgt], _flip(h.direction),
                           into=False, fields=new_fields)
        if preds:
            pred = preds[0] if len(preds) == 1 else E.Ands(tuple(preds))
            out = self._optimize_filter(
                L.Filter(out, pred, fields=out.fields))
        if model._registry is not None:
            model._registry.counter("cost.reorders").inc()
        return True, out
