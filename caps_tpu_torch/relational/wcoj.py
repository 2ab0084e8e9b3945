"""Worst-case-optimal multiway joins for cyclic MATCH patterns.

The counterpart of ``caps_tpu/relational/wcoj.py``.  The binary join
cascade the planner emits for a cyclic pattern —

    MATCH (a)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c) RETURN a, b, c

— materializes every OPEN 2-path before the closing edge filters it.
:class:`MultiwayJoinOp` takes the whole detected cyclic segment
(``logical/optimizer.py match_cyclic_segment``) as one operator that
binds the pattern variable at a time in the leapfrog style over the
``ops/wcoj.py`` sorted-edge layer:

* each new vertex expands along ONE cost-chosen **anchor** adjacency
  (the minimum-expected-degree incident edge), through the same
  expand-positions kernel (K2) the join path uses;
* every OTHER incident pattern edge **semi-filters** the candidates at
  once (sorted pair-key membership), so after compaction the frontier
  never exceeds the true partial-match count;
* the deferred edges then **close** by pair multiplicity, enumerating
  each parallel edge as its own binding, and the relationship-
  isomorphism pairs absorbed from the segment's filters drop rows whose
  rel bindings coincide;
* finally each variable's scan columns are gathered once at the bound
  rows — the only full-width materialization of the pattern.

Every data-dependent size (the id domain, each step's expansion, each
compaction) goes through the backend's size stream (``consume_count`` /
``consume_rows``), so an exact replay of the fused executor reads no
size.  The sorted structures are memoized on the scan columns
(``_wcoj_edges``, ``_wcoj_ids``): a static graph sorts once, and the
duplicate-id check that reads the card runs once per column.

Where the port differs from the reference:

* **No degraded fallback on a fault.**  The reference serves any
  exception of the WCOJ path from the embedded cascade.  Here only
  :class:`_Unsuitable` does (no device backend, an id domain over
  :data:`_MAX_DOMAIN`, duplicate node ids in a scan, an output column
  collision), counted under ``wcoj.fallbacks`` with
  ``strategy="fallback-cascade"``; every other exception — a K2 launch
  error, a ``KernelSelfTestError`` — propagates.
* **Compile ledger.**  As in the reference, each step's first-seen
  shape charges the ``wcoj`` kind (obs/compile.py): the host seconds of
  its first run, since eager PyTorch compiles nothing.
* No mesh and no cancellation checkpoints (nothing to guard yet).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional as Opt, Tuple

import torch

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.obs.compile import charged as _compile_charged
from caps_tpu_torch.logical.optimizer import (
    CyclicSegment, EdgeRef, match_cyclic_segment,
)
from caps_tpu_torch.relational.ops import RelationalOperator, resolve_expr

#: node-id domains above this refuse the composite-key form (keys are
#: frm*n + to in int64; the guard keeps n^2 < 2^52 with headroom)
_MAX_DOMAIN = 1 << 26


class _Unsuitable(Exception):
    """Runtime bail-out: serve this execution via the cascade child."""


@dataclasses.dataclass(frozen=True)
class ExtendStep:
    """Bind one new vertex: expand the ``anchor`` adjacency from
    ``probe`` (the bound endpoint), semi-filter by every other incident
    ``check`` edge."""
    var: str
    anchor: EdgeRef
    probe: str
    forward: bool  # probing along stored orientation (frm -> to)?
    checks: Tuple[EdgeRef, ...]


@dataclasses.dataclass(frozen=True)
class CloseStep:
    edge: EdgeRef


def plan_steps(seg: CyclicSegment, model=None
               ) -> Tuple[List[ExtendStep], List[CloseStep]]:
    """Assign each pattern edge a role under the plan-order binding
    sequence: for every new vertex, the incident edges whose other
    endpoint is already bound compete — the model's expected degree
    picks the anchor (min-degree frontier, the leapfrog choice), the
    rest semi-filter now and close later.  Without a model the
    introducing edge anchors (the cascade's own order)."""
    consumed: set = set()
    extends: List[ExtendStep] = []
    bound = {seg.seed}
    for var in seg.order[1:]:
        incident: List[Tuple[EdgeRef, str, bool]] = []
        for e in seg.edges:
            if e.rel in consumed or e.frm == e.to:
                continue
            if e.frm == var and e.to in bound:
                incident.append((e, e.to, False))
            elif e.to == var and e.frm in bound:
                incident.append((e, e.frm, True))
        if not incident:
            raise ValueError(f"variable {var!r} has no bound anchor")

        def score(item):
            e, _probe, forward = item
            if model is None:
                return 0.0 if e.intro == var else 1.0
            d = Direction.OUTGOING if forward else Direction.INCOMING
            return model.degree(e.rel_types, d)

        incident.sort(key=score)
        anchor, probe, forward = incident[0]
        consumed.add(anchor.rel)
        checks = tuple(e for e, _p, _f in incident[1:])
        extends.append(ExtendStep(var, anchor, probe, forward, checks))
        bound.add(var)
    closes = [CloseStep(e) for e in seg.edges if e.rel not in consumed]
    return extends, closes


def try_plan_wcoj(planner, op, build_fallback
                  ) -> Opt["MultiwayJoinOp"]:
    """Substitute a MultiwayJoinOp for the cyclic segment rooted at the
    into-Expand ``op``, or None to keep the cascade.  Selection is
    cost-based when the session carries a model; with the model off the
    detected shape substitutes unconditionally (``use_wcoj=False``
    disables both).  ``build_fallback`` is a zero-arg builder invoked
    only AFTER the decision to substitute (the planner builds it with
    nested substitution suppressed, so one segment yields one operator
    and a pure-cascade fallback)."""
    session = planner.context.session
    config = getattr(session, "config", None)
    if not getattr(session, "supports_wcoj", False):
        return None
    if config is None or not getattr(config, "use_wcoj", False):
        return None
    seg = match_cyclic_segment(op)
    if seg is None:
        return None
    model = planner.cost_model
    try:
        extends, closes = plan_steps(seg, model)
    except ValueError:
        return None
    est_rows = 1.0
    if model is not None:
        node_preds = dict(seg.node_preds)

        def sel(var: str) -> float:
            return model.selectivity(node_preds.get(var, ()),
                                     seg.labels_of(var))

        ext_desc = []
        for s in extends:
            d = Direction.OUTGOING if s.forward else Direction.INCOMING
            checks = tuple(c.rel_types for c in s.checks)
            ext_desc.append((s.anchor.rel_types, d,
                             seg.labels_of(s.var), sel(s.var), checks))
        close_desc = [c.edge.rel_types for c in closes]
        use, est_rows, _info = model.wcoj_vs_cascade(
            seg.labels_of(seg.seed), sel(seg.seed), ext_desc, close_desc)
        if not use:
            return None
    registry = getattr(session, "metrics_registry", None)
    if registry is not None:
        registry.counter("wcoj.substituted").inc()
    out = MultiwayJoinOp(planner.context, build_fallback(),
                         planner.current_graph,
                         seg, tuple(extends), tuple(closes))
    out.planned_rows = max(1.0, float(est_rows))
    return out


class MultiwayJoinOp(RelationalOperator):
    """Enumerate all bindings of a cyclic pattern in one pass over
    sorted edge keys (module docstring).  Child 0 is the binary join
    cascade, evaluated lazily ONLY when the device path is unsuitable
    for this execution (:class:`_Unsuitable`)."""

    def __init__(self, context, fallback: RelationalOperator, graph,
                 seg: CyclicSegment, extends: Tuple[ExtendStep, ...],
                 closes: Tuple[CloseStep, ...]):
        super().__init__(context, [fallback])
        self.graph = graph
        self.seg = seg
        self.extends = extends
        self.closes = closes
        self.strategy = "unplanned"
        self.planned_rows: float = 1.0

    # -- dispatch ----------------------------------------------------------

    def _compute(self):
        registry = getattr(self.context.session, "metrics_registry", None)
        try:
            out = self._compute_wcoj()
            self.strategy = "wcoj"
            if registry is not None:
                registry.counter("wcoj.executions").inc()
        except _Unsuitable:
            # an unsuitable input (no device tables, an oversized id
            # domain, duplicate ids, a column collision) is served by
            # the cascade — counted, so a monitor sees the fast path is
            # not running.  Nothing else falls back: a fault raises.
            if registry is not None:
                registry.counter("wcoj.fallbacks").inc()
            self.strategy = "fallback-cascade"
            out = self.children[0].result
        self._metric_extra = {"strategy": self.strategy}
        return out

    # -- scan plumbing -----------------------------------------------------

    def _filtered_scan(self, header, table, preds):
        for pred in preds:
            table = table.filter(resolve_expr(pred, header), header,
                                 self.parameters)
        return table

    def _node_scan(self, var: str):
        preds = dict(self.seg.node_preds).get(var, ())
        header, t = self.graph.scan_node(var, self.seg.labels_of(var))
        return header, t, self._filtered_scan(header, t, preds)

    def _rel_scan(self, e: EdgeRef):
        preds = dict(self.seg.rel_preds).get(e.rel, ())
        header, t = self.graph.scan_rel(e.rel, e.rel_types)
        return header, self._filtered_scan(header, t, preds)

    # -- device path -------------------------------------------------------

    def _compute_wcoj(self):
        from caps_tpu_torch import ops as OPS
        from caps_tpu_torch.backends.cuda import kernels as K
        from caps_tpu_torch.backends.cuda.sharded import whole
        from caps_tpu_torch.backends.cuda.table import (
            DeviceTable, _gather_cols,
        )
        from caps_tpu_torch.ops import wcoj as W

        backend = getattr(self.context.factory, "backend", None)
        if backend is None:
            raise _Unsuitable("no device backend")
        seg = self.seg
        dev = backend.device

        def need_device(t):
            # the multiway join probes whole scans: a row-resident one
            # gathers to the lead first (the all_gather GSPMD inserts)
            t = whole(t)
            if not isinstance(t, DeviceTable):
                raise _Unsuitable("no device table")
            return t

        node_parts: Dict[str, tuple] = {}
        for var in seg.order:
            header, _raw, t = self._node_scan(var)
            t = need_device(t)
            node_parts[var] = (header, t,
                               t._cols[header.column(E.Var(var))])
        rel_parts: Dict[str, tuple] = {}
        for e in seg.edges:
            header, t = self._rel_scan(e)
            t = need_device(t)
            v = E.Var(e.rel)
            rel_parts[e.rel] = (
                header, t,
                t._cols[header.column(E.StartNode(v))],
                t._cols[header.column(E.EndNode(v))],
                t._cols[header.column(v)])

        # id domain over everything the pattern touches; a negative
        # live id (the composite keys are frm*n + to) folds into the same
        # read as an oversized domain and takes the cascade
        minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        mx, mn = minus1, zero
        live = [(col.data, col.valid & t.row_ok)
                for _h, t, col in node_parts.values()]
        for _h, t, src, tgt, _idc in rel_parts.values():
            ok = src.valid & tgt.valid & t.row_ok
            live += [(src.data, ok), (tgt.data, ok)]
        for data, ok in live:
            ids = data.to(torch.int64)
            mx = torch.maximum(mx, torch.where(ok, ids, minus1).max())
            mn = torch.minimum(mn, torch.where(ok, ids, zero).min())
        n = backend.consume_count(
            torch.where(mn < 0, torch.full_like(mx, _MAX_DOMAIN), mx),
            relation="cap") + 1
        if n <= 0:
            n = 1
        if n > _MAX_DOMAIN:
            raise _Unsuitable(f"node-id domain {n} too large or negative")
        # the expand kernel's self-test, where the reference asks
        # whether its Pallas kernel is usable
        OPS.ensure_kernels("prefetch", dev)

        def charged_shape(sig, fn):
            """Compile-ledger seam: the FIRST run of a step at a new
            shape charges its host seconds under the ``wcoj`` kind;
            seen shapes (and every fused replay) charge nothing."""
            seen = getattr(backend, "wcoj_compiled_shapes", None)
            if seen is None:
                seen = backend.wcoj_compiled_shapes = set()
            if sig in seen:
                return fn()
            with _compile_charged("wcoj", shape=sig):
                out = fn()
            seen.add(sig)
            return out

        # sorted structures, memoized on the scan columns: a static
        # graph sorts once; predicate-filtered scans rebuild per
        # execution on their fresh columns
        def edge_structure(e: EdgeRef, forward: bool):
            _h, t, src, tgt, _idc = rel_parts[e.rel]
            frm_col, to_col = (src, tgt) if forward else (tgt, src)
            key = (t._n, int(n), forward)
            memo = getattr(frm_col, "_wcoj_edges", None)
            if memo is not None and key in memo:
                return memo[key]
            ok = src.valid & tgt.valid & t.row_ok
            res = charged_shape(
                f"sort:b{t.capacity}",
                lambda: W.sorted_edges(frm_col.data, to_col.data, ok, n,
                                       t._sort_perm))
            if memo is None:
                memo = frm_col._wcoj_edges = {}
            if len(memo) < 8:
                memo[key] = res
            return res

        def node_structure(var: str):
            _h, t, col = node_parts[var]
            key = (t._n, int(n))
            memo = getattr(col, "_wcoj_ids", None)
            if memo is not None and memo[0] == key:
                return memo[1]
            keys = W.sorted_ids(col.data, col.valid & t.row_ok)
            perm = charged_shape(f"sort:b{t.capacity}",
                                 lambda: t._sort_perm([keys]))
            ids_sorted = keys[perm]
            backend.syncs += 1  # the duplicate-id check reads the card
            dup = bool(((ids_sorted[:-1] == ids_sorted[1:])
                        & (ids_sorted[:-1] < W.PAD_KEY)).any())
            res = (ids_sorted, perm, dup)
            col._wcoj_ids = (key, res)
            return res

        # frontier: per bound node var its id and scan row, per bound
        # rel var its scan row — narrow int columns; the full-width
        # gather happens once, at the end
        seed = seg.seed
        _sh, st_, scol = node_parts[seed]
        cap = st_.capacity
        n_rows, live = st_._n, st_._live
        state: Dict[tuple, torch.Tensor] = {
            ("id", seed): torch.where(scol.valid, scol.data.to(torch.int64),
                                      minus1),
            ("row", seed): torch.arange(cap, device=dev),
        }

        def prefix_mask():
            return K.row_mask(cap, n_rows, dev, live)

        def compact(mask):
            nonlocal state, cap, n_rows, live
            n_rows, live = backend.consume_rows(K.mask_count(mask))
            out_cap = backend.bucket(n_rows)
            idx = charged_shape(f"compact:b{cap}x{out_cap}",
                                lambda: K.compact_indices(mask, out_cap))
            state = {k: v[idx] for k, v in state.items()}
            cap = out_cap

        for step in self.extends:
            S, P = edge_structure(step.anchor, step.forward)
            u_ids = state[("id", step.probe)]
            valid = prefix_mask()
            # the sizing probe feeds the extend, which never probes the
            # same adjacency twice
            counts, lo_a = charged_shape(
                f"adj:e{S.shape[0]}xb{cap}",
                lambda: W.probe_adj(S, u_ids, valid, n))
            total, t_live = backend.consume_rows(W.adj_total(counts))
            out_cap = backend.bucket(total)
            l_idx, cand, erow, ok = charged_shape(
                f"extend:e{S.shape[0]}b{cap}x{out_cap}",
                lambda: W.extend(S, P, u_ids, valid, n, out_cap,
                                 counts=counts, lo=lo_a))
            state = {k: v[l_idx] for k, v in state.items()}
            state[("erow", step.anchor.rel)] = erow
            cap, n_rows, live = out_cap, total, t_live
            # node membership = existence + labels + predicates (the
            # scan is pre-filtered); the sort perm doubles as id -> row
            ids_sorted, perm_v, dup = node_structure(step.var)
            if dup:
                raise _Unsuitable("duplicate node ids in scan")
            cnt_v, lo_v = charged_shape(
                f"nid:n{ids_sorted.shape[0]}xb{cap}",
                lambda: W.probe_id(ids_sorted, cand, ok))
            keep = ok & (cnt_v > 0)
            state[("id", step.var)] = cand
            state[("row", step.var)] = perm_v[
                lo_v.clamp(0, perm_v.shape[0] - 1)]
            # leapfrog semi-filters: every other incident pattern edge
            # must have at least one instance between the bound pair
            for c in step.checks:
                Sc, _Pc = edge_structure(c, True)
                cntc, _ = charged_shape(
                    f"pair:e{Sc.shape[0]}xb{cap}",
                    lambda: W.probe_pair(Sc, state[("id", c.frm)],
                                         state[("id", c.to)], keep, n))
                keep = keep & (cntc > 0)
            compact(keep)

        for step in self.closes:
            e = step.edge
            S, P = edge_structure(e, True)
            valid = prefix_mask()
            counts, lo_c = charged_shape(
                f"pair:e{S.shape[0]}xb{cap}",
                lambda: W.probe_pair(S, state[("id", e.frm)],
                                     state[("id", e.to)], valid, n))
            total, t_live = backend.consume_rows(W.adj_total(counts))
            out_cap = backend.bucket(total)
            l_idx, erow, _ok = charged_shape(
                f"close:e{S.shape[0]}b{cap}x{out_cap}",
                lambda: W.close(S, P, state[("id", e.frm)],
                                state[("id", e.to)], valid, n, out_cap,
                                counts=counts, lo=lo_c))
            state = {k: v[l_idx] for k, v in state.items()}
            state[("erow", e.rel)] = erow
            cap, n_rows, live = out_cap, total, t_live

        if self.seg.uniq_pairs:
            # relationship isomorphism absorbed from the segment's
            # filters: rel bindings of the named pairs must differ
            mask = prefix_mask()
            for r1, r2 in self.seg.uniq_pairs:
                id1 = rel_parts[r1][4].data[state[("erow", r1)]]
                id2 = rel_parts[r2][4].data[state[("erow", r2)]]
                mask = mask & (id1 != id2)
            compact(mask)

        # full-width materialization: gather each scan's columns once,
        # headers concatenated in the cascade's own order so downstream
        # operators see an identical layout
        out_cols: Dict[str, object] = {}
        headers = [node_parts[seed][0]]
        out_cols.update(_gather_cols(node_parts[seed][1]._cols,
                                     state[("row", seed)]))
        for e in seg.edges:
            headers.append(rel_parts[e.rel][0])
            out_cols_e = _gather_cols(rel_parts[e.rel][1]._cols,
                                      state[("erow", e.rel)])
            if set(out_cols) & set(out_cols_e):
                raise _Unsuitable("output column collision")
            out_cols.update(out_cols_e)
            if not e.closing:
                headers.append(node_parts[e.intro][0])
                out_cols_v = _gather_cols(node_parts[e.intro][1]._cols,
                                          state[("row", e.intro)])
                if set(out_cols) & set(out_cols_v):
                    raise _Unsuitable("output column collision")
                out_cols.update(out_cols_v)
        out_header = headers[0]
        for h in headers[1:]:
            out_header = out_header.concat(h)
        return out_header, DeviceTable(backend, out_cols, n_rows, live=live)

    # -- EXPLAIN -----------------------------------------------------------

    def _pretty_args(self):
        def edge(e: EdgeRef):
            t = "|".join(e.rel_types)
            tag = "*" if e.closing else ""
            return f"({e.frm})-[{e.rel}:{t}]{tag}->({e.to})"

        anchors = ",".join(f"{s.var}<~{s.anchor.rel}" for s in self.extends)
        return (f"{' '.join(edge(e) for e in self.seg.edges)}, "
                f"anchors=[{anchors}], strategy={self.strategy}")
