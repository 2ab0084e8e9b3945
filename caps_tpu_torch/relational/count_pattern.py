"""Aggregate-pushdown lowering of count-only pattern chains to SpMV.

The counterpart of ``caps_tpu/relational/count_pattern.py``.  A query
like

    MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c)
    WHERE a.name = $seed RETURN count(*)

needs no row materialization at all — per-hop partial-path counts
propagate as a dense node vector, and each Expand hop is one
sparse-matrix/vector product against the device-resident adjacency:

    x0[v] = [v matches the seed scan+filters]
    x1[v] = Σ_{edges (u,v)} x0[u]          (segment-sum)
    answer = Σ_v x2[v]

(ref analog: the planner owns such rewrites — okapi-logical
LogicalOptimizer / planBoundedVarLengthExpand, reconstructed, mount
empty; SURVEY.md §3.2.)

Correctness scope: openCypher matches with *relationship isomorphism* —
the IR builder emits ``Not(id(r_i) = id(r_j))`` filters between hops —
while SpMV counts walks.  For chains of ≤ 3 hops the difference is a
closed-form correction: 2-hop reuse is r2 == r1, detectable per edge;
3-hop reuse is an inclusion–exclusion over the pairs (see _build_corr3).
The lowering is *exact* there and the matcher refuses longer chains,
leaving them on the join path.

On a 1-D device mesh, uniform unmasked chains ride the ring schedule
(``parallel/ring.py``, strategy "ring").  Other chains on a mesh (every
chain on a 2-D one) run "spmv-sharded", as in the JAX package: each
shard segment-sums its resident edge block into a frontier, and the
shards' frontiers combine with ``global_sum`` at every hop (the
all-reduce GSPMD inserts).  Counts are int64 throughout; ids are cast
to int32 only under ``_MAX_DOMAIN``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional as Opt, Sequence, Tuple

import numpy as np
import torch

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.logical import ops as L
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.compile import charge as _compile_charge
from caps_tpu_torch.okapi.types import CTInteger
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.ops import RelationalOperator, resolve_expr

# Node-id domains larger than this refuse the dense-vector form.
_MAX_DOMAIN = 1 << 26

# Sentinel: the length-2 correction has no device path (vs None = the
# correction is provably zero).
_UNSUITABLE_CORR = object()

# Negative closure cache entry: this (graph, plan, params) shape is
# known unfusable — don't re-probe on every execution.
_NO_FUSE = object()

# Per-graph static structures kept at most for this many distinct graphs.
_MAX_STATIC_GRAPHS = 16


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    var: str
    labels: frozenset
    preds: Tuple[E.Expr, ...]


@dataclasses.dataclass(frozen=True)
class HopSpec:
    rel: str
    rel_types: Tuple[str, ...]
    direction: Direction
    target: NodeSpec


class _Unsuitable(Exception):
    """Runtime bail-out: compute via the fallback join plan instead."""


def _host_domain(scans, rels) -> Opt[int]:
    """The dense id domain N of the fused closures from the cached host
    copies: ``scans`` are (ids, ok) node arrays, ``rels`` (src, tgt, ok)
    edge arrays.  None when a live id is negative (the vectors index by
    id) or N exceeds :data:`_MAX_DOMAIN`; the eager path then refuses
    the same graph with :class:`_Unsuitable`."""
    mx, mn = -1, 0
    for ids, ok in scans:
        if ids.shape[0] and ok.any():
            live = ids[ok]
            mx, mn = max(mx, int(live.max())), min(mn, int(live.min()))
    for src, tgt, ok in rels:
        if src.shape[0] and ok.any():
            s, t = src[ok], tgt[ok]
            mx = max(mx, int(s.max()), int(t.max()))
            mn = min(mn, int(s.min()), int(t.min()))
    n = max(mx + 1, 1)
    if mn < 0 or n > _MAX_DOMAIN:
        return None
    return n


def _dense_bool_vec(okps: torch.Tensor, ends: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Node indicator over the id domain from an id-sorted membership
    mask: cumsum + one boundary gather (the segment-sum over sorted
    segments; shared by the chain closure and the cycle op's masks)."""
    if okps.shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=okps.device)
    c = torch.cumsum(okps.to(torch.int32), 0, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=okps.device)
    cum = torch.where(ends >= 0, c[ends.clamp(min=0)], zero)
    prev = torch.cat([zero[None], cum[:-1]])
    return (cum - prev) > 0


def _walk_expr(e: E.Expr):
    """Every sub-expression of ``e`` (itself included)."""
    stack = [e]
    while stack:
        x = stack.pop()
        yield x
        stack.extend(c for c in x.children if isinstance(c, E.Expr))


def _split(pred: E.Expr) -> Tuple[E.Expr, ...]:
    if isinstance(pred, E.Ands):
        out: List[E.Expr] = []
        for p in pred.exprs:
            out.extend(_split(p))
        return tuple(out)
    return (pred,)


def _corr_intersection(h1: "HopSpec", h2: "HopSpec"):
    """Edge scan an r2==r1 reuse can live in: the intersection of both
    hops' type constraints (an untyped hop matches every type).  Returns
    the type set, or None when provably disjoint (zero correction)."""
    ta, tb = set(h1.rel_types), set(h2.rel_types)
    if not ta:
        return tb
    if not tb:
        return ta
    inter = ta & tb
    return inter or None


def _corr_roles(h1: "HopSpec", h2: "HopSpec", src, tgt):
    """Per-edge index roles for the length-2 correction, resolved by hop
    directions: (a, b) = hop-1 (from, to), (near2, far2) = hop-2."""
    a, b = (src, tgt) if h1.direction == Direction.OUTGOING else (tgt, src)
    near2, far2 = (src, tgt) if h2.direction == Direction.OUTGOING \
        else (tgt, src)
    return a, b, near2, far2


def _as_uniqueness_pair(pred: E.Expr) -> Opt[Tuple[str, str]]:
    if (isinstance(pred, E.Not) and isinstance(pred.expr, E.Equals)
            and isinstance(pred.expr.lhs, E.Id)
            and isinstance(pred.expr.rhs, E.Id)
            and isinstance(pred.expr.lhs.entity, E.Var)
            and isinstance(pred.expr.rhs.entity, E.Var)):
        return (pred.expr.lhs.entity.name, pred.expr.rhs.entity.name)
    return None


def try_plan_count_pushdown(planner, op: "L.Aggregate", fallback):
    """Match Aggregate(count(*)) over a 1-3 hop Expand chain (or a
    var-length expand with upper <= 3) rooted at one NodeScan, and return
    a CountPatternOp, or None if the shape doesn't qualify."""
    session = planner.context.session
    config = getattr(session, "config", None)
    if not getattr(session, "supports_count_pushdown", False):
        return None
    if config is None or not config.use_count_pushdown:
        return None
    if op.group or len(op.aggregations) != 1:
        return None
    out_name, agg = op.aggregations[0]
    if not isinstance(agg, E.CountStar):
        return None

    hops_rev: List[Tuple[str, Tuple[str, ...], Direction, str, frozenset,
                         str]] = []
    preds_by_var: Dict[str, List[E.Expr]] = {}
    uniq_pairs: List[Tuple[str, str]] = []
    varlen: Opt[L.BoundedVarLengthExpand] = None
    closing: Opt[L.Expand] = None
    pending: List[E.Expr] = []

    cur = op.parent
    seed: Opt[Tuple[str, frozenset]] = None
    while seed is None:
        if isinstance(cur, L.Filter):
            pending.extend(_split(cur.predicate))
            cur = cur.parent
        elif isinstance(cur, L.Expand):
            if cur.direction == Direction.BOTH or varlen:
                return None
            if cur.into:
                # at most one cycle-closing edge (both endpoints bound)
                if closing is not None:
                    return None
                closing = cur
            else:
                hops_rev.append((cur.rel, cur.rel_types, cur.direction,
                                 cur.target, cur.target_labels, cur.source))
            cur = cur.parent
        elif isinstance(cur, L.BoundedVarLengthExpand):
            if (cur.into or cur.direction == Direction.BOTH or hops_rev
                    or varlen or closing or cur.upper is None or cur.upper > 3):
                return None
            varlen = cur
            cur = cur.parent
        elif isinstance(cur, L.NodeScan):
            if not isinstance(cur.parent, L.Start) or cur.parent.qgn is not None:
                return None
            seed = (cur.var, cur.labels)
        else:
            return None

    # The walk collected Expands in plan order; the SpMV/cycle lowerings
    # assume a CHAIN — every hop must expand from the previous hop's
    # target (first hop: from the seed).  A star pattern like
    # (a)->(b), (a)->(c) also type-checks as 2 hops over 3 node vars but
    # is NOT a chain; counting it as one is silently wrong.
    if hops_rev:
        expected_src = seed[0]
        for r, t, d, tv, tl, src in reversed(hops_rev):
            if src != expected_src:
                return None
            expected_src = tv

    if closing is not None and varlen is None:
        return _plan_cycle(planner, op, fallback, seed, hops_rev, closing,
                           pending, out_name)
    if closing is not None:
        return None

    if varlen is not None:
        node_vars = {seed[0], varlen.target}
        rel_vars = {varlen.rel}
        max_len = varlen.upper
        lengths = list(range(varlen.lower, varlen.upper + 1))
    else:
        if not 1 <= len(hops_rev) <= 3:
            return None
        node_vars = {seed[0]} | {h[3] for h in hops_rev}
        rel_vars = {h[0] for h in hops_rev}
        if len(node_vars) != 1 + len(hops_rev) or len(rel_vars) != len(hops_rev):
            return None  # repeated vars: not a simple chain
        max_len = len(hops_rev)
        lengths = [max_len]

    for pred in pending:
        pair = _as_uniqueness_pair(pred)
        if pair is not None:
            if set(pair) <= rel_vars:
                uniq_pairs.append(pair)
                continue
            return None
        vs = {v.name for v in E.vars_in(pred)}
        if len(vs) == 1 and (v := next(iter(vs))) in node_vars:
            preds_by_var.setdefault(v, []).append(pred)
            continue
        return None

    def node_spec(var: str, labels) -> NodeSpec:
        return NodeSpec(var, frozenset(labels),
                        tuple(preds_by_var.get(var, ())))

    seed_spec = node_spec(*seed)
    if varlen is not None:
        # VarExpand joins the target node scan only where a path *ends*;
        # intermediate frontier nodes need no node row (engine semantics —
        # see VarExpandOp).  It always enforces edge isomorphism between
        # every pair of hop positions.
        hop = HopSpec(varlen.rel, tuple(varlen.rel_types), varlen.direction,
                      node_spec(varlen.target, varlen.target_labels))
        hops = [hop] * max_len
        uniq_pos = frozenset((i, j) for i in range(1, max_len + 1)
                             for j in range(i + 1, max_len + 1))
    else:
        # Fixed Expand joins the target node scan at *every* hop, so every
        # hop output is masked by node existence (+labels/preds).  The
        # uniqueness filters the IR emitted map to hop-position pairs.
        hops = [HopSpec(r, tuple(t), d, node_spec(tv, tl))
                for r, t, d, tv, tl, _src in reversed(hops_rev)]
        if uniq_pairs and max_len < 2:
            return None
        pos_of = {h.rel: i + 1 for i, h in enumerate(hops)}
        uniq_pos = frozenset(
            (min(pos_of[x], pos_of[y]), max(pos_of[x], pos_of[y]))
            for x, y in uniq_pairs)

    return CountPatternOp(planner.context, fallback, planner.current_graph,
                          out_name, seed_spec, hops, lengths, uniq_pos,
                          is_varlen=varlen is not None)


def _plan_cycle(planner, op, fallback, seed, hops_rev, closing, pending,
                out_name):
    """Match the cyclic triangle shape: a 2-hop chain a->b->c plus one
    closing edge between a and c (any per-edge orientation), lowered to
    batched 2-path enumeration with a sorted closing-edge key probe
    (benchmark config 4; ref analog: Spark plans this as a 5-way shuffle
    join cascade — reconstructed, mount empty; SURVEY.md §3.2)."""
    if len(hops_rev) != 2:
        return None
    a_var = seed[0]
    hops_fwd = list(reversed(hops_rev))
    b_var, c_var = hops_fwd[0][3], hops_fwd[1][3]
    node_vars = {a_var, b_var, c_var}
    rel_vars = {h[0] for h in hops_fwd} | {closing.rel}
    if len(node_vars) != 3 or len(rel_vars) != 3:
        return None
    if {closing.source, closing.target} != {a_var, c_var}:
        return None
    if closing.target_labels:
        # labels restated on the closing mention must already be implied
        # by the var's own spec (the cycle build masks a/c once)
        existing = seed[1] if closing.target == a_var else hops_fwd[1][4]
        if not frozenset(closing.target_labels) <= frozenset(existing):
            return None

    preds_by_var: Dict[str, List[E.Expr]] = {}
    for pred in pending:
        pair = _as_uniqueness_pair(pred)
        if pair is not None:
            if set(pair) <= rel_vars:
                # relationship-isomorphism filters between the three rels:
                # enforced structurally by CountCycleOp (it refuses graphs
                # with self-loops, the only way two cycle rels can coincide)
                continue
            return None
        vs = {v.name for v in E.vars_in(pred)}
        if len(vs) == 1 and (v := next(iter(vs))) in node_vars:
            preds_by_var.setdefault(v, []).append(pred)
            continue
        return None

    def spec(var: str, labels) -> NodeSpec:
        return NodeSpec(var, frozenset(labels),
                        tuple(preds_by_var.get(var, ())))

    seed_spec = spec(a_var, seed[1])
    hops = [HopSpec(r, tuple(t), d, spec(tv, tl))
            for r, t, d, tv, tl, _src in hops_fwd]
    # orient the closing edge as a->c regardless of how it was written
    closes_forward = (closing.source == a_var) \
        == (closing.direction == Direction.OUTGOING)
    close_hop = HopSpec(closing.rel, tuple(closing.rel_types),
                        Direction.OUTGOING if closes_forward
                        else Direction.INCOMING,
                        spec(c_var, closing.target_labels))
    return CountCycleOp(planner.context, fallback, planner.current_graph,
                        out_name, seed_spec, hops, close_hop)


def graph_static(backend, gk) -> dict:
    """The per-graph static structures of graph epoch ``gk`` (sorted
    edges and ids, segment boundaries, the matrix var-expand's edge
    arrays), created empty on first use.  At most
    ``_MAX_STATIC_GRAPHS`` graphs are kept: the oldest goes with its
    closures, so discarded graphs' device copies don't pin memory for
    the process lifetime (a stale closure would also serve a reused
    epoch)."""
    st = backend.fused_count_static.get(gk)
    if st is None:
        while len(backend.fused_count_static) >= _MAX_STATIC_GRAPHS:
            old = next(iter(backend.fused_count_static))
            backend.fused_count_static.pop(old)
            for k in [k for k in backend.fused_count_fns if k[0] == old]:
                backend.fused_count_fns.pop(k)
        st = {"scans": {}, "rels": {}, "edges": {}, "ids": {},
              "matrix": {}}
        backend.fused_count_static[gk] = st
    return st


def _sorted_with_ends(keys: torch.Tensor, n: int):
    """(sorted keys, stable sort order, ends): ``ends[v]`` is the last
    position holding a key <= v, for v in [0, n) — the segment
    boundaries of a cumsum segment-sum.  Sorted on the device."""
    keys_sorted, order = torch.sort(keys, stable=True)
    probe = torch.arange(n, dtype=keys.dtype, device=keys.device)
    ends = torch.searchsorted(keys_sorted, probe, right=True) - 1
    return keys_sorted, order, ends.to(torch.int32)


def _nbytes(tree) -> int:
    """Bytes of every tensor in a nest of tuples/lists."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(x) for x in tree)
    return 0


class CountPatternOp(RelationalOperator):
    """Count pattern matches by dense-vector propagation (see module
    docstring).  Falls back to the embedded join plan when the node-id
    domain is unsuitable."""

    def __init__(self, context, fallback: RelationalOperator, graph,
                 out_name: str, seed: NodeSpec, hops: Sequence[HopSpec],
                 lengths: Sequence[int], uniq_pos: frozenset,
                 is_varlen: bool = False):
        super().__init__(context, [fallback])
        self.graph = graph
        self.out_name = out_name
        self.seed = seed
        self.hops = list(hops)
        self.lengths = list(lengths)
        # hop-position pairs (i, j), i<j, whose relationships must differ
        # (Cypher relationship isomorphism)
        self.uniq_pos = uniq_pos
        self.is_varlen = is_varlen
        self.strategy = "unplanned"

    @property
    def correct_len2(self) -> bool:
        return (1, 2) in self.uniq_pos and 2 in self.lengths

    @property
    def _backend(self):
        return self.context.factory.backend

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self._backend.device)

    # -- array extraction --------------------------------------------------

    def _node_ids(self, spec: NodeSpec):
        """Per block, (ids, ok) tensors of the nodes matching a
        NodeSpec."""
        header, t = self.graph.scan_node(spec.var, spec.labels)
        params = self.context.parameters
        for pred in spec.preds:
            t = t.filter(resolve_expr(pred, header), header, params)
        return self._column_arrays(t, header.column(E.Var(spec.var)))

    def _rel_arrays(self, types: Tuple[str, ...]):
        """Per shard block, the (src, ok) and (tgt, ok) arrays of the
        relationships of ``types``: a row-resident scan's own blocks; a
        whole scan on a mesh (several types gathered) split into shard
        blocks once, here."""
        from caps_tpu_torch.backends.cuda.sharded import (
            ShardedTable, split_table,
        )
        tmp = "__cnt_rel"
        header, t = self.graph.scan_rel(tmp, types)
        mesh = self._backend.mesh
        if mesh is not None and not isinstance(t, ShardedTable):
            t = split_table(t, mesh)
        src = self._column_arrays(t, header.column(E.StartNode(E.Var(tmp))))
        tgt = self._column_arrays(t, header.column(E.EndNode(E.Var(tmp))))
        return src, tgt

    @staticmethod
    def _column_arrays(table, col: str):
        """(values, ok) device tensors of an integer id column, one pair
        per resident block (one for a whole table)."""
        from caps_tpu_torch.backends.cuda.sharded import ShardedTable
        parts = table.parts if isinstance(table, ShardedTable) else [table]
        if any(p._cols[col].kind not in ("id", "int") for p in parts):
            raise _Unsuitable(f"non-integer id column {col}")
        return [(p._cols[col].data, p._cols[col].valid & p.row_ok)
                for p in parts]

    # -- execution ---------------------------------------------------------

    def _compute(self):
        self._fused_bytes = 0
        try:
            out = self._compute_pushdown()
        except _Unsuitable:
            self.strategy = "fallback-join"
            out = self.children[0].result
        self._metric_extra = {"strategy": self.strategy}
        if self.strategy != "fallback-join":
            # the fallback plan never ran: what the pushdown read is the
            # closure's inputs (0 on the eager path, as in the JAX package)
            self._metric_extra["bytes_in"] = self._fused_bytes
        return out

    # -- cached closure execution --------------------------------------------
    #
    # The whole seed→hops→masks→correction chain is built once into a
    # closure over device-resident static arrays (the engine's analog of
    # whole-stage codegen — ref analog: Spark Tungsten codegen,
    # SparkTable.scala†, SURVEY.md §3.1).  All data-dependent structure
    # is hoisted out of the steady state:
    #
    #   * per GRAPH (immutable): edge lists sorted by destination, node-scan
    #     ids sorted, and the per-node segment boundaries (`ends`) that
    #     turn segment-sum into cumsum + two gathers;
    #   * per (graph, plan shape, parameter shapes): the closure; node-
    #     predicate masks rebuild per unseen binding as eager args;
    #   * per ITERATION: the closure's eager launches, zero host reads.

    def _shape_key(self, params):
        """The value-independent closure-cache key component."""
        from caps_tpu_torch.relational.shapes import param_shape_signature
        session = getattr(self.context, "session", None)
        lattice = getattr(session, "shape_lattice", None)
        try:
            return param_shape_signature(params, lattice)
        except Exception:
            return None

    def _fused_total(self):
        backend = self._backend
        if backend.mesh is not None or not backend.config.use_fused_count:
            # cached closures are single-device programs: a mesh takes
            # the ring / sharded strategies
            return None
        from caps_tpu_torch.backends.cuda.fused import _graph_key, _params_key
        gk = _graph_key(self.graph)
        params = self.context.parameters
        pk = _params_key(params)
        if gk is None or pk is None:
            return None
        key_sig = self._shape_key(params)
        # parameter values the shape signature cannot describe key the
        # closure on their values (and on the pool: a value-keyed
        # closure's masks hold pooled string codes)
        value_keyed = key_sig is None
        if value_keyed:
            key_sig = pk
        key = (gk, key_sig, len(backend.pool) if value_keyed else -1,
               self._plan_sig())
        entry = backend.fused_count_fns.get(key)
        if entry is _NO_FUSE:
            return None
        fresh = entry is None
        if fresh:
            # the build's seconds go to the compile ledger only; no value
            # of the clock reaches the computation
            t_build = clock.now()  # capslint: disable=tracer-purity
            # Build outside any record/replay scope: the one-time host
            # reads of the static build must not leak into a fused-
            # executor recording (a replay would never repeat them).
            saved = backend.count_mode
            backend.count_mode = None
            try:
                built = self._build_fused(backend, gk)
            finally:
                backend.count_mode = saved
            backend.count_builds += 1
            fns = backend.fused_count_fns
            while len(fns) >= max(1, backend.config.compile_cache_size):
                fns.pop(next(iter(fns)))
            # negative results are cached too: repeats of an unfusable
            # query must not pay the build probing every execution
            if built is None:
                fns[key] = _NO_FUSE
                return None
            fn, args, valid, make_args = built
            entry = {"run": fn, "valid": valid, "make_args": make_args,
                     "args": args,
                     "token": pk if make_args is not None else None}
            fns[key] = entry
        elif entry["token"] is not None and entry["token"] != pk:
            # unseen binding, same shape: rebuild ONLY the predicate-mask
            # args (eager device ops over the static arrays)
            args = entry["make_args"](params)
            if args is None:
                return None
            entry["args"] = args
            entry["token"] = pk
        fn, args = entry["run"], entry["args"]
        # roofline numerator: the device arrays the closure reads per
        # execution — the per-binding args plus any static arrays the
        # closure self-reports (the cycle op's batches re-read theirs)
        self._fused_bytes = _nbytes(args) + getattr(fn, "nbytes_in", 0)
        self.strategy = "fused-spmv"
        if fresh:
            # Compile ledger (obs/compile.py): a fused_count_fns miss is
            # a compile boundary — the closure build plus its first run.
            # Hits (fresh bindings of a seen shape included) charge
            # nothing.
            out = fn(*args)
            t_done = clock.now()  # capslint: disable=tracer-purity
            sig = hashlib.sha1(
                repr(self._plan_sig()).encode()).hexdigest()[:10]
            _compile_charge("count_fused", t_done - t_build,
                            shape=f"g{gk}:{sig}")
            return out, entry["valid"]
        return fn(*args), entry["valid"]

    def _plan_sig(self):
        def nsig(s: NodeSpec):
            return (tuple(sorted(s.labels)), tuple(repr(p) for p in s.preds))
        return (nsig(self.seed),
                tuple((tuple(sorted(set(h.rel_types))), h.direction,
                       nsig(h.target)) for h in self.hops),
                tuple(self.lengths), self.is_varlen,
                tuple(sorted(self.uniq_pos)))

    def _fused_scan(self, st, labels: frozenset):
        """(header, table, static_ok, host_ids, host_ok) for a node scan;
        cached per graph.  The host copies (the ingest mirrors, or one
        read each) feed the numpy-side static builds below."""
        key = ("node", labels)
        if key in st["scans"]:
            return st["scans"][key]
        header, t = self.graph.scan_node("__cnt_n", labels)
        entry = None
        if t.capacity:
            col = header.column(E.Var("__cnt_n"))
            host = t.host_column(col)
            if host is not None:
                c = t._cols[col]
                static_ok = c.valid & t.row_ok
                entry = (header, t, static_ok, host[0], host[1])
        st["scans"][key] = entry
        return entry

    def _fused_rel(self, st, rk: Tuple[str, ...]):
        """(src, tgt, ok) HOST numpy arrays for a relationship scan;
        cached (the edge structures built from these are device-resident,
        the raw scan itself is only needed host-side)."""
        if rk in st["rels"]:
            return st["rels"][rk]
        header, t = self.graph.scan_rel("__cnt_r", rk)
        v = E.Var("__cnt_r")
        s = t.host_column(header.column(E.StartNode(v)))
        g = t.host_column(header.column(E.EndNode(v)))
        entry = None
        if s is not None and g is not None:
            entry = (s[0], g[0], s[1] & g[1])
        st["rels"][rk] = entry
        return entry

    def _fused_edges(self, st, rk, direction, n: int):
        """Edges of one hop sorted by destination + per-node segment
        boundaries: (frm_sorted, ok_sorted, ends, to_clip) device
        tensors, sorted on the device once per graph."""
        key = (rk, direction, n)
        if key in st["edges"]:
            return st["edges"][key]
        rel = self._fused_rel(st, rk)
        if rel is None:
            st["edges"][key] = None
            return None
        src, tgt, ok = rel
        frm, to = (src, tgt) if direction == Direction.OUTGOING else (tgt, src)
        to_fold = self._upload(np.where(ok, to, n).astype(np.int32))
        to_sorted, order, ends = _sorted_with_ends(to_fold, n)
        frm_sorted = self._upload(np.where(ok, frm, 0).astype(np.int32))[order]
        ok_sorted = self._upload(ok)[order]
        # clipped destination for edgewise mask gathers on the final hop
        # (invalid edges carry the n sentinel; ok_sorted already excludes
        # them, the clip just keeps the gather in bounds)
        to_clip = to_sorted.clamp(max=n - 1)
        entry = (frm_sorted, ok_sorted, ends, to_clip)
        st["edges"][key] = entry
        return entry

    def _fused_ids(self, st, labels: frozenset, n: int):
        """Node-scan ids sorted + segment boundaries: (order, ends,
        static_okps) device tensors — the order permutes a predicate
        mask into id order; static_okps is the predicate-free mask
        (node existence) already permuted, uploaded once."""
        key = (labels, n)
        if key in st["ids"]:
            return st["ids"][key]
        _, _, _ok, host_ids, host_ok = st["scans"][("node", labels)]
        id_fold = self._upload(np.where(host_ok, host_ids, n).astype(np.int32))
        _ids, order, ends = _sorted_with_ends(id_fold, n)
        entry = (order, ends, self._upload(host_ok)[order])
        st["ids"][key] = entry
        return entry

    def _fused_okpred(self, scan, spec: NodeSpec, ids, params=None):
        """Predicate mask over a node scan (a pure function of graph data
        and ``params``), permuted into id order (``ids`` is the
        :meth:`_fused_ids` entry).  Returns None if a predicate has no
        device path."""
        from caps_tpu_torch.backends.cuda.expr import (
            DeviceExprCompiler, UnsupportedOnDevice,
        )
        order, _ends, static_okps = ids
        if not spec.preds:
            return static_okps
        header, t, static_ok, _hids, _hok = scan
        if params is None:
            params = self.context.parameters
        compiler = DeviceExprCompiler(t._cols, t.capacity, header, params,
                                      self._backend.pool, t.row_ok)

        def rename(e: E.Expr) -> E.Expr:
            # the cached scan binds "__cnt_n", not the query's var name
            if isinstance(e, E.Var) and e.name == spec.var:
                return E.Var("__cnt_n")
            return e

        okpred = static_ok
        try:
            for pred in spec.preds:
                renamed = pred.transform_up(rename)
                col = compiler.compile(resolve_expr(renamed, header))
                if col.kind != "bool":
                    return None
                okpred = okpred & col.data & col.valid
        except (UnsupportedOnDevice, KeyError):
            return None
        return okpred[order]

    def _build_fused(self, backend, gk):
        st = graph_static(backend, gk)
        dev = backend.device

        seed_scan = self._fused_scan(st, self.seed.labels)
        if seed_scan is None:
            return None
        if self.is_varlen:
            mask_specs = [self.hops[0].target]
        else:
            mask_specs = [h.target for h in self.hops]
        mask_scans = [self._fused_scan(st, s.labels) for s in mask_specs]
        if any(m is None for m in mask_scans):
            return None
        relkeys = [tuple(sorted(set(h.rel_types))) for h in self.hops]
        rels = {rk: self._fused_rel(st, rk) for rk in relkeys}
        if any(r is None for r in rels.values()):
            return None

        # id domain over everything this chain touches (host-side — the
        # scan host copies were read once when cached)
        n = _host_domain([scan[3:5] for scan in [seed_scan] + mask_scans],
                         rels.values())
        if n is None:
            return None  # let the eager path raise _Unsuitable

        seed_ids = self._fused_ids(st, self.seed.labels, n)
        # Hops often share a target spec (e.g. two unlabeled nodes): build
        # each distinct mask once and index into it.  The distinct-mask
        # ORDER is structural (labels + pred shapes), so the per-binding
        # args builder below reproduces it exactly for every value.
        uniq_masks: List[tuple] = []  # (spec, scan) per distinct mask
        mask_index: List[int] = []
        uniq: Dict[tuple, int] = {}
        for spec, scan in zip(mask_specs, mask_scans):
            k = (spec.labels, tuple(repr(p) for p in spec.preds))
            if k not in uniq:
                uniq[k] = len(uniq_masks)
                uniq_masks.append((spec, scan))
            mask_index.append(uniq[k])
        mask_index = tuple(mask_index)
        hop_edges = [self._fused_edges(st, rk, h.direction, n)
                     for rk, h in zip(relkeys, self.hops)]
        if any(e is None for e in hop_edges):
            return None

        lengths = tuple(self.lengths)
        max_len = max(lengths)
        is_varlen = self.is_varlen
        cap1 = backend.bucket(1)

        corr = None
        if self.correct_len2:
            corr = self._fused_corr(st, n)
            if corr is _UNSUITABLE_CORR:
                return None
            if corr is not None:
                corr = self._compact_cond(n, *corr)

        corr3, coef_t = None, 0
        if max_len == 3 and 3 in lengths and self.uniq_pos:
            built = self._build_corr3(st, n)
            if built is _UNSUITABLE_CORR:
                return None
            if built is not None:
                corr3, coef_t = built

        # Dtype schedule: node indicators are BOOL; the frontier after
        # hop 1 is int32 (values bounded by in-degree < 2^31 since edges
        # are int32-indexed); hop 2+ frontiers are int64 (path counts
        # compose multiplicatively).  The final hop never builds a dense
        # frontier at all — it reduces edgewise with a bool mask gather
        # at the destination.
        zero64 = torch.zeros((), dtype=torch.int64, device=dev)

        def hop_dense(x, frm, ok, ends, out_dtype):
            """One SpMV hop to a dense frontier of ``out_dtype``.  The
            segment-sum is a cumsum over the destination-sorted edges
            and two gathers at the static segment ends (the JAX
            package's scatter-free form, kept: on the card it is as
            exact as an ``index_add_`` and needs no atomics)."""
            if frm.shape[0] == 0:
                return torch.zeros(n, dtype=out_dtype, device=dev)
            gx = x[frm]
            if gx.dtype == torch.bool:
                contrib = (ok & gx).to(out_dtype)
            else:
                contrib = torch.where(ok, gx, torch.zeros_like(gx)
                                      ).to(out_dtype)
            c = torch.cumsum(contrib, 0, dtype=out_dtype)
            zero = torch.zeros((), dtype=out_dtype, device=dev)
            cum = torch.where(ends >= 0, c[ends.clamp(min=0)], zero)
            prev = torch.cat([zero[None], cum[:-1]])
            return cum - prev

        def hop_edgewise(x, frm, ok, to_clip, emask):
            """Final hop: Σ_e x[frm]·mask[to] — no dense rebuild."""
            if frm.shape[0] == 0:
                return zero64
            keep = ok & emask[to_clip]
            gx = x[frm]
            if gx.dtype == torch.bool:
                return (keep & gx).sum(dtype=torch.int64)
            return torch.where(keep, gx, torch.zeros_like(gx)
                               ).sum(dtype=torch.int64)

        def masked_sum(keep, vals):
            return torch.where(keep, vals, torch.zeros_like(vals)
                               ).sum(dtype=torch.int64)

        def run(seed_okps, seed_ends, masks, hops, corr, corr3):
            x0 = _dense_bool_vec(seed_okps, seed_ends, n)
            uniq_vecs = [_dense_bool_vec(mo, me, n) for mo, me in masks]
            mask_vecs = [uniq_vecs[i] for i in mask_index]
            end_mask = mask_vecs[0] if is_varlen else mask_vecs[-1]
            total = zero64
            x = x0
            x1_saved = None
            for length in range(0, max_len + 1):
                if length in lengths and length < max_len:
                    xl = x.to(torch.int64)
                    if is_varlen:
                        xl = torch.where(end_mask, xl, torch.zeros_like(xl))
                    total = total + xl.sum()
                if length < max_len:
                    frm, ok, ends, to_clip = hops[length]
                    if length == max_len - 1 and max_len in lengths:
                        emask = end_mask if is_varlen \
                            else mask_vecs[length]
                        total = total + hop_edgewise(x, frm, ok, to_clip,
                                                     emask)
                    else:
                        dt = torch.int32 if length == 0 else torch.int64
                        x = hop_dense(x, frm, ok, ends, dt)
                        if not is_varlen:
                            x = torch.where(mask_vecs[length], x,
                                            torch.zeros_like(x))
                        if length == 0:
                            x1_saved = x
            if corr is not None:
                cvalid, a, b, f = corr
                hit = cvalid & x0[a]
                if not is_varlen:
                    hit = hit & mask_vecs[0][b]
                hit = hit & (end_mask if is_varlen else mask_vecs[1])[f]
                total = total - hit.sum(dtype=torch.int64)
            if corr3 is not None:
                # 3-hop inclusion–exclusion over the enforced uniqueness
                # pairs P: bad = ΣA_p − coef_t·T (every pairwise
                # intersection of the A_p equals the triple T).
                c12, c23, i13, c123, d3, pair2 = corr3
                m1 = None if is_varlen else mask_vecs[0]
                m2 = None if is_varlen else mask_vecs[1]
                m3 = end_mask if is_varlen else mask_vecs[2]
                sub = zero64
                if c12 is not None:
                    # A12: e2=e1 at positions (a,b,c); hop 3 continues
                    # freely — D3[v] = Σ_{e3 from v} m3[far3]
                    frm3, ok3, ends3, _t3 = d3
                    D3 = hop_dense(m3, frm3, ok3, ends3, torch.int32)
                    cv, a, b, c = c12
                    keep = cv & x0[a]
                    if m1 is not None:
                        keep = keep & m1[b]
                    if m2 is not None:
                        keep = keep & m2[c]
                    sub = sub + masked_sum(keep, D3[c])
                if c23 is not None:
                    # A23: e3=e2 at positions (b,c,d); weight by the
                    # number of length-1 walks from the seed into b
                    cv, b, c, d = c23
                    keep = cv & m3[d]
                    if m2 is not None:
                        keep = keep & m2[c]
                    sub = sub + masked_sum(keep, x1_saved[b])
                if i13 is not None:
                    # A13: e3=e1 with e2 free — count hop-2 edges between
                    # far1(e) and near3(e) via the sorted pair-key table
                    cv, a, b, c, d = i13
                    q = b.to(torch.int64) * n + c.to(torch.int64)
                    lo = torch.searchsorted(pair2, q)
                    hi = torch.searchsorted(pair2, q, right=True)
                    keep = cv & x0[a] & m3[d]
                    if m1 is not None:
                        keep = keep & m1[b]
                    if m2 is not None:
                        keep = keep & m2[c]
                    sub = sub + masked_sum(keep, hi - lo)
                if c123 is not None and coef_t:
                    cv, a, b, c, d = c123
                    keep = cv & x0[a] & m3[d]
                    if m1 is not None:
                        keep = keep & m1[b]
                    if m2 is not None:
                        keep = keep & m2[c]
                    sub = sub - coef_t * keep.sum(dtype=torch.int64)
                total = total - sub
            out = torch.zeros(cap1, dtype=torch.int64, device=dev)
            out[0] = total
            return out

        def build_args(params):
            """The parameter-dependent half of the closure: predicate
            masks evaluated for ONE binding (eager device ops).
            Everything else — edges, segment boundaries, corrections —
            is graph-static and captured above."""
            seed_okps = self._fused_okpred(seed_scan, self.seed, seed_ids,
                                           params)
            if seed_okps is None:
                return None
            masks: List[tuple] = []
            for spec, scan in uniq_masks:
                ids = self._fused_ids(st, spec.labels, n)
                okps = self._fused_okpred(scan, spec, ids, params)
                if okps is None:
                    return None
                masks.append((okps, ids[1]))
            return (seed_okps, seed_ids[1], tuple(masks),
                    tuple(hop_edges), corr, corr3)

        args = build_args(self.context.parameters)
        if args is None:
            return None
        # the count row is always valid
        valid = torch.ones(cap1, dtype=torch.bool, device=dev)
        all_preds = list(self.seed.preds) + [p for s, _sc in uniq_masks
                                             for p in s.preds]
        has_param_preds = any(
            isinstance(x, E.Param)
            for p in all_preds for x in _walk_expr(p))
        return (run, args, valid, build_args if has_param_preds else None)

    def _build_corr3(self, st, n: int):
        """Static data for the 3-hop isomorphism correction.

        For a 3-hop chain the excluded walks are the union of A12 (e2=e1),
        A23 (e3=e2), A13 (e3=e1) over the enforced pairs P; every pairwise
        intersection of these events is the triple T (all edges equal), so
        |∪| = ΣA_p − coef·T with coef = max(0, |P|−1).  Each A-term is a
        per-edge sum over the hops' type-intersection scan (generalizing
        the 2-hop closed form at _fused_corr / _len2_correction).
        Returns ((c12, c23, i13, c123, d3, pair2), coef) of device
        tensors, None for a provably-zero correction, or
        _UNSUITABLE_CORR."""
        h1, h2, h3 = self.hops
        P = self.uniq_pos
        if not P:
            return None

        def role(h, src, tgt):
            return (src, tgt) if h.direction == Direction.OUTGOING \
                else (tgt, src)

        def compact(cond, *arrs):
            return self._compact_cond(n, cond, *arrs)

        def pair_rel(ha, hb):
            inter = _corr_intersection(ha, hb)
            if inter is None:
                return None
            rel = self._fused_rel(st, tuple(sorted(inter)))
            if rel is None:
                return _UNSUITABLE_CORR
            return rel

        c12 = c23 = i13 = c123 = d3 = pair2 = None
        if (1, 2) in P:
            rel = pair_rel(h1, h2)
            if rel is _UNSUITABLE_CORR:
                return _UNSUITABLE_CORR
            if rel is not None and rel[0].shape[0]:
                src, tgt, ok = rel
                n1, f1 = role(h1, src, tgt)
                n2, f2 = role(h2, src, tgt)
                c12 = compact(ok & (f1 == n2), n1, f1, f2)
            if c12 is not None:
                opp = Direction.INCOMING \
                    if h3.direction == Direction.OUTGOING \
                    else Direction.OUTGOING
                d3 = self._fused_edges(
                    st, tuple(sorted(set(h3.rel_types))), opp, n)
                if d3 is None:
                    return _UNSUITABLE_CORR
        if (2, 3) in P:
            rel = pair_rel(h2, h3)
            if rel is _UNSUITABLE_CORR:
                return _UNSUITABLE_CORR
            if rel is not None and rel[0].shape[0]:
                src, tgt, ok = rel
                n2, f2 = role(h2, src, tgt)
                n3, f3 = role(h3, src, tgt)
                c23 = compact(ok & (f2 == n3), n2, f2, f3)
        if (1, 3) in P:
            rel = pair_rel(h1, h3)
            if rel is _UNSUITABLE_CORR:
                return _UNSUITABLE_CORR
            if rel is not None and rel[0].shape[0]:
                src, tgt, ok = rel
                n1, f1 = role(h1, src, tgt)
                n3, f3 = role(h3, src, tgt)
                i13 = compact(ok, n1, f1, n3, f3)
            if i13 is not None:
                rel2 = self._fused_rel(
                    st, tuple(sorted(set(h2.rel_types))))
                if rel2 is None:
                    return _UNSUITABLE_CORR
                s2, t2, ok2 = rel2
                if s2.shape[0] == 0:
                    i13 = None  # no hop-2 edges: A13 walks cannot exist
                else:
                    n2v, f2v = role(h2, s2, t2)
                    keys = np.where(ok2, n2v.astype(np.int64) * n + f2v,
                                    np.int64(2) ** 62)
                    pair2 = torch.sort(self._upload(keys)).values
        coef_t = max(0, len(P) - 1)
        if coef_t:
            i12t = _corr_intersection(h1, h2)
            inter3 = None
            if i12t is not None:
                t3 = set(h3.rel_types)
                if not t3:
                    inter3 = i12t
                elif not i12t:
                    inter3 = t3
                else:
                    inter3 = (i12t & t3) or None
            if inter3 is not None:
                rel = self._fused_rel(st, tuple(sorted(inter3)))
                if rel is None:
                    return _UNSUITABLE_CORR
                src, tgt, ok = rel
                if src.shape[0]:
                    n1, f1 = role(h1, src, tgt)
                    n2, f2 = role(h2, src, tgt)
                    n3, f3 = role(h3, src, tgt)
                    c123 = compact(ok & (f1 == n2) & (f2 == n3),
                                   n1, f1, f2, f3)
        if c12 is None and c23 is None and i13 is None and c123 is None:
            return None
        return ((c12, c23, i13, c123, d3, pair2), coef_t)

    def _compact_cond(self, n: int, cond, *arrs):
        """Compact per-edge correction data to the (usually tiny) subset
        where ``cond`` holds — a static property of the graph — clipping
        indices into [0, n) and padding to a bucket.  Returns (cvalid,
        *clipped) device tensors, or None when no edge qualifies."""
        (idx,) = np.nonzero(cond)
        nc = len(idx)
        if nc == 0:
            return None
        cap_c = self._backend.bucket(nc)
        idx = np.concatenate([idx, np.zeros(cap_c - nc, idx.dtype)])
        cvalid = np.arange(cap_c) < nc
        out = [self._upload(cvalid)]
        out += [self._upload(np.clip(a, 0, n - 1).astype(np.int32)[idx])
                for a in arrs]
        return tuple(out)

    def _fused_corr(self, st, n: int):
        """Static per-edge data for the length-2 isomorphism correction:
        (cond, a, b, far2) with indices pre-clipped.  None = zero
        correction; _UNSUITABLE_CORR = no device path."""
        h1, h2 = self.hops[0], self.hops[1]
        inter = _corr_intersection(h1, h2)
        if inter is None:
            return None
        rel = self._fused_rel(st, tuple(sorted(inter)))
        if rel is None:
            return _UNSUITABLE_CORR
        src, tgt, ok = rel
        if src.shape[0] == 0:
            return None
        a, b, near2, far2 = _corr_roles(h1, h2, src, tgt)
        cond = ok & (near2 == b)
        safe = lambda v: np.clip(np.where(cond, v, 0), 0, n - 1
                                 ).astype(np.int32)
        return (cond, safe(a), safe(b), safe(far2))

    # -- eager path ----------------------------------------------------------

    def _domain(self, parts) -> int:
        """Smallest N covering every id seen (consume_count, so a fused
        replay serves it with no read).  A negative live id folds into
        the same read as an oversized domain: the dense vectors index
        by id, so such a graph takes the join fallback."""
        backend = self._backend
        mx = torch.full((), -1, dtype=torch.int64, device=backend.device)
        mn = torch.zeros((), dtype=torch.int64, device=backend.device)
        for vals, ok in (b for blocks in parts for b in blocks):
            if vals.shape[0]:
                v = vals.to(torch.int64)
                mx = torch.maximum(mx, torch.where(
                    ok, v, torch.full_like(v, -1)).max().to(mx.device))
                mn = torch.minimum(mn, torch.where(
                    ok, v, torch.zeros_like(v)).min().to(mn.device))
        n = backend.consume_count(
            torch.where(mn < 0, torch.full_like(mx, _MAX_DOMAIN), mx),
            relation="cap") + 1
        if n <= 0:
            n = 1
        if n > _MAX_DOMAIN:
            raise _Unsuitable(f"node-id domain {n} too large or negative")
        return n

    def _indicator(self, blocks, n: int) -> torch.Tensor:
        """0/1 int64 node indicator on the lead device: each block
        ``index_add_``s its live ids into n + 1 slots (a native atomic
        add on the card, dead rows routed to slot n); the blocks' vectors
        combine with ``global_sum``."""
        parts = []
        for ids, ok in blocks:
            safe = torch.where(ok, ids, torch.full_like(ids, n)).long()
            vec = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
            parts.append(vec.index_add_(0, safe, ok.to(torch.int64))[:n])
        return self._combine(parts)[0].clamp(max=1)

    def _combine(self, parts, devices=None):
        """The blocks' partial vectors summed (``global_sum``, the
        all-reduce GSPMD inserts; one block is its own sum), on each of
        ``devices`` (default: the lead)."""
        from caps_tpu_torch.parallel.collectives import global_sum
        devices = devices or [self._backend.device]
        if len(parts) == 1:
            return [parts[0].to(d) for d in devices]
        return global_sum(parts, devices)

    def _compute_pushdown(self):
        fused = self._fused_total()
        if fused is not None:
            return self._emit_fused(*fused)

        if max(self.lengths) >= 3 and self.uniq_pos:
            # the 3-hop inclusion–exclusion correction only exists on the
            # closure path; walks-only 3-hop chains may continue below
            raise _Unsuitable("3-hop isomorphism correction is fused-only")

        seed_ids = self._node_ids(self.seed)
        rel_cache: Dict[Tuple[str, ...], tuple] = {}
        for h in self.hops:
            key = tuple(sorted(set(h.rel_types)))
            if key not in rel_cache:
                rel_cache[key] = self._rel_arrays(h.rel_types)
        # Mask regimes (engine join semantics):
        #   fixed chain — Expand joins the target node scan at EVERY hop:
        #     mask_vecs[i] (node existence + labels + preds) multiplies the
        #     frontier after hop i;
        #   var-length — VarExpand joins the target only where a path
        #     ends: one end_mask applied at counting lengths, frontier
        #     flows unmasked through intermediate (possibly node-less)
        #     endpoints.
        if self.is_varlen:
            mask_ids = [self._node_ids(self.hops[0].target)]
        else:
            mask_ids = [self._node_ids(h.target) for h in self.hops]

        domain_parts = [seed_ids]
        for (src, tgt) in rel_cache.values():
            domain_parts += [src, tgt]
        domain_parts += mask_ids
        n = self._domain(domain_parts)

        seed_vec = self._indicator(seed_ids, n)
        mask_vecs = [self._indicator(m, n) for m in mask_ids]
        end_mask = mask_vecs[0] if self.is_varlen else mask_vecs[-1]

        def hop_arrays(h: HopSpec):
            """Per resident edge block, (frm, to, ok)."""
            src_b, tgt_b = rel_cache[tuple(sorted(set(h.rel_types)))]
            out = []
            for (src, src_ok), (tgt, tgt_ok) in zip(src_b, tgt_b):
                frm, to = (src, tgt) if h.direction == Direction.OUTGOING \
                    else (tgt, src)
                out.append((frm, to, src_ok & tgt_ok))
            return out

        mesh = self._backend.mesh
        ring_total = self._try_ring(mesh, n, seed_vec, mask_vecs,
                                    hop_arrays)
        if ring_total is not None:
            total = ring_total
        else:
            self.strategy = "spmv-sharded" if mesh is not None else "spmv"
            total = torch.zeros((), dtype=torch.int64,
                                device=seed_vec.device)
            x = seed_vec
            for length in range(0, max(self.lengths) + 1):
                if length in self.lengths:
                    # fixed chains are already fully masked; var-length
                    # paths are masked only where they end
                    xl = x * end_mask if self.is_varlen else x
                    total = total + xl.sum()
                if length < max(self.lengths):
                    x = self._hop(x, hop_arrays(self.hops[length]), n)
                    if not self.is_varlen:
                        x = x * mask_vecs[length]

        if self.correct_len2:
            if self.is_varlen:
                corr_masks = (None, end_mask)
            else:
                corr_masks = (mask_vecs[0], mask_vecs[1])
            total = total - self._len2_correction(n, seed_vec, corr_masks)

        return self._emit(total)

    def _hop(self, x: torch.Tensor, edges, n: int) -> torch.Tensor:
        """One SpMV hop of the frontier ``x`` (on the lead): each edge
        block, on its shard, segment-sums its sources' counts by
        destination; the shards' partial frontiers combine with
        ``global_sum``."""
        parts = []
        for frm, to, ok in edges:
            xs = x.to(frm.device)
            safe_frm = torch.where(ok, frm, torch.zeros_like(frm)).long()
            safe_to = torch.where(ok, to, torch.full_like(to, n)).long()
            contrib = torch.where(ok, xs[safe_frm], torch.zeros_like(
                xs[safe_frm]))
            nxt = torch.zeros(n + 1, dtype=torch.int64, device=xs.device)
            parts.append(nxt.index_add_(0, safe_to, contrib)[:n])
        return self._combine(parts)[0]

    def _try_ring(self, mesh, n, seed_vec, mask_vecs, hop_arrays):
        """Uniform unmasked chains on a 1-D mesh ride the ring schedule
        (parallel/ring.py).  Returns the total, or None — a planned
        strategy, not an error path: 2-D meshes and chains whose hops
        differ take the unsharded "spmv"."""
        backend = self._backend
        if mesh is None or mesh.devices.ndim != 1:
            return None
        if not backend.config.use_ring:
            return None
        if len(self.lengths) != 1 or self.lengths[0] < 1:
            return None
        k = self.lengths[0]
        if len({(h.rel_types, h.direction) for h in self.hops}) != 1:
            return None
        if not self.is_varlen:
            # fixed chains mask every hop; the ring applies ONE mask per
            # hop, so all hop target specs must coincide
            if len({(h.target.labels, h.target.preds)
                    for h in self.hops}) != 1:
                return None
        from caps_tpu_torch.parallel.ring import ring_khop_cached
        s = mesh.size
        n_pad = ((n + s - 1) // s) * s

        def pad(a, length, fill):
            return torch.cat([a, torch.full((length - a.shape[0],), fill,
                                            dtype=a.dtype, device=a.device)])
        # the resident edge blocks as the ring's per-shard operands
        frm_p, to_p, ok_p = ([], [], [])
        for frm, to, ok in hop_arrays(self.hops[0]):
            zero = torch.zeros_like(frm)
            frm_p.append(torch.where(ok, frm, zero).to(torch.int32))
            to_p.append(torch.where(ok, to, zero).to(torch.int32))
            ok_p.append(ok)
        seed_p = pad(seed_vec, n_pad, 0)
        if self.is_varlen:
            # intermediate endpoints unmasked; the end mask applies to
            # the final frontier
            khop = ring_khop_cached(mesh, n_pad, k)
            _, blk = khop(seed_p, frm_p, to_p, ok_p)
            total = (blk.to(torch.int64) * pad(mask_vecs[0], n_pad, 0)).sum()
        else:
            khop = ring_khop_cached(mesh, n_pad, k, masked=True)
            total, _ = khop(seed_p, frm_p, to_p, ok_p,
                            pad(mask_vecs[0], n_pad, 0))
        self.strategy = "ring"
        return total

    def _len2_correction(self, n, seed_vec, corr_masks):
        """Walks of length 2 reusing their edge (r2 == r1): an edge can be
        reused only if it satisfies BOTH hops' type constraints, i.e. it
        lies in the *intersection* scan (an untyped hop matches every
        type).  For each such edge the reuse is expressible per edge —
        subtract seed[a]·mask_b[b]·mask_c[c] where the hop directions
        determine (a, b, c) — making the lowering exact under
        relationship isomorphism for every type combination."""
        h1, h2 = self.hops[0], self.hops[1]
        inter = _corr_intersection(h1, h2)
        if inter is None:
            return 0  # disjoint scans: an edge can't repeat
        src_b, tgt_b = self._rel_arrays(tuple(sorted(inter)))
        lead = seed_vec.device
        total = torch.zeros((), dtype=torch.int64, device=lead)
        for (src, src_ok), (tgt, tgt_ok) in zip(src_b, tgt_b):
            ok = src_ok & tgt_ok
            a, b, near2, far2 = _corr_roles(h1, h2, src, tgt)
            cond = ok & (near2 == b)

            def at(vec, ids):
                if vec is None:
                    return 1
                return vec.to(ids.device)[ids.clamp(0, n - 1).long()]

            safe_a = torch.where(cond, a, torch.zeros_like(a))
            term = at(seed_vec, safe_a) * at(corr_masks[0], b) \
                * at(corr_masks[1], far2)
            total = total + torch.where(cond, term, torch.zeros_like(
                term)).sum().to(lead)
        return total

    def _emit_fused(self, data, valid):
        """Wrap the closure's already-padded output column."""
        from caps_tpu_torch.backends.cuda.column import Column
        from caps_tpu_torch.backends.cuda.table import DeviceTable
        header = RecordHeader([(E.Var(self.out_name), self.out_name,
                                CTInteger)])
        col = Column("int", data, valid, CTInteger)
        return header, DeviceTable(self._backend, {self.out_name: col}, 1)

    def _emit(self, total):
        backend = self._backend
        cap = backend.bucket(1)
        data = torch.zeros(cap, dtype=torch.int64, device=backend.device)
        data[0] = total
        return self._emit_fused(data, torch.ones(cap, dtype=torch.bool,
                                                 device=backend.device))

    def _pretty_args(self):
        hops = "".join(
            f"-[:{'|'.join(h.rel_types)}]{'>' if h.direction == Direction.OUTGOING else '<'}"
            for h in self.hops)
        return (f"{self.out_name}=count(*), ({self.seed.var}){hops}, "
                f"lengths={self.lengths}, strategy={self.strategy}")


class CountCycleOp(CountPatternOp):
    """Count directed-triangle matches — a 2-hop chain a->b->c plus a
    closing edge between a and c — WITHOUT the join cascade.

    The lowering enumerates the chain's 2-paths in fixed-shape device
    batches and probes a sorted closing-edge key table:

        W[j]   = out-degree (hop 2) of hop-1 edge j's endpoint b
        P      = sum W — the number of 2-paths
        path p = (edge j, k-th hop-2 neighbour of b), recovered with one
                 searchsorted over cumsum(W)
        count += multiplicity of key a*n + c in the closing edge set

    One batch shape B serves every batch and every graph scale:
    intermediates are bounded by B, and parallel closing edges are
    counted exactly (the probe returns multiplicity).  Relationship
    isomorphism is enforced structurally: with no self-loop edges in any
    participating scan, the three matched rel instances are necessarily
    pairwise distinct (any coincidence forces a self-loop); graphs with
    self-loops fall back to the join plan.  (Ref analog: Spark executes
    this query as a 5-way shuffle-join cascade — reconstructed, mount
    empty; BASELINE.md config 4.)

    The closing probe is ``ops/wcoj.py``'s sorted pair-key multiplicity.
    The closure is shape-keyed like the main count path: node-predicate
    masks rebuild per unseen binding as eager device args
    (``_cycle_mask_dev``), with one read of the 2-path total P to size
    the batch loop.
    """

    #: per-launch 2-path batch
    _BATCH = 1 << 20

    def __init__(self, context, fallback, graph, out_name, seed: NodeSpec,
                 hops: Sequence[HopSpec], close_hop: HopSpec):
        super().__init__(context, fallback, graph, out_name, seed, hops,
                         lengths=[2], uniq_pos=frozenset())
        self.close_hop = close_hop

    def _plan_sig(self):
        ch = self.close_hop
        return (super()._plan_sig(), "cycle",
                tuple(sorted(set(ch.rel_types))), ch.direction)

    def _compute_pushdown(self):
        fused = self._fused_total()
        if fused is None:
            raise _Unsuitable("cycle count needs the closure path")
        self.strategy = "cycle-probe"
        return self._emit_fused(*fused)

    def _cycle_mask_dev(self, st, spec: NodeSpec, n: int, params):
        """Dense DEVICE bool mask over the id domain for one node var
        (existence + labels + predicates) — a pure function of graph
        data + ``params``, rebuilt per unseen binding as eager device
        ops so the cycle closure stays shape-keyed."""
        scan = self._fused_scan(st, spec.labels)
        if scan is None:
            return None
        ids = self._fused_ids(st, spec.labels, n)
        okps = self._fused_okpred(scan, spec, ids, params)
        if okps is None:
            return None
        return _dense_bool_vec(okps, ids[1], n)

    def _build_fused(self, backend, gk):
        from caps_tpu_torch.ops import wcoj as WC
        st = graph_static(backend, gk)
        dev = backend.device

        h1, h2, ch = self.hops[0], self.hops[1], self.close_hop
        relkeys = [tuple(sorted(set(h.rel_types))) for h in (h1, h2, ch)]
        rels = [self._fused_rel(st, rk) for rk in relkeys]
        if any(r is None for r in rels):
            return None
        # no self-loops anywhere rels participate: the structural
        # guarantee that the three cycle rels are pairwise distinct
        for src, tgt, ok in rels:
            if src.shape[0] and bool(np.any((src == tgt) & ok)):
                return None

        seed_scan = self._fused_scan(st, self.seed.labels)
        if seed_scan is None or \
                self._fused_scan(st, h1.target.labels) is None or \
                self._fused_scan(st, h2.target.labels) is None:
            return None

        n = _host_domain(
            [st["scans"][("node", labels)][3:5]
             for labels in (self.seed.labels, h1.target.labels,
                            h2.target.labels)], rels)
        if n is None:
            return None

        def oriented(rel, direction):
            src, tgt, ok = rel
            return (src, tgt, ok) if direction == Direction.OUTGOING \
                else (tgt, src, ok)

        # STATIC structures: validity-compacted only — node masks are
        # per-BINDING arguments, applied on the fly (a/b gate the 2-path
        # weights, c gates inside the batch), so one closure serves
        # every parameter value of the shape.
        f1, t1, ok1 = oriented(rels[0], h1.direction)
        e1f = np.clip(f1[ok1], 0, n - 1).astype(np.int32)
        e1t = np.clip(t1[ok1], 0, n - 1).astype(np.int32)

        # hop 2 CSR b->c (validity only; c-mask applied in the batch),
        # sorted on the device
        f2, t2, ok2 = oriented(rels[1], h2.direction)
        f2c, order2 = torch.sort(self._upload(f2[ok2].astype(np.int64)),
                                 stable=True)
        adj2 = self._upload(
            np.clip(t2[ok2], 0, n - 1).astype(np.int32))[order2]
        starts2 = torch.searchsorted(
            f2c, torch.arange(n + 1, dtype=torch.int64, device=dev))

        # closing edge key table a*n + c (multiplicity-preserving)
        f3, t3, ok3 = oriented(rels[2], ch.direction)
        keys = torch.sort(self._upload(
            f3[ok3].astype(np.int64) * n + t3[ok3].astype(np.int64))).values

        cap1 = backend.bucket(1)
        valid = torch.ones(cap1, dtype=torch.bool, device=dev)
        if e1f.shape[0] == 0 or keys.shape[0] == 0:
            zero = torch.zeros(cap1, dtype=torch.int64, device=dev)
            return ((lambda *a: zero), (), valid, None)

        B = self._BATCH
        d_e1f, d_e1t = self._upload(e1f), self._upload(e1t)
        d_starts2, d_keys = starts2, keys
        d_adj2 = adj2 if adj2.shape[0] \
            else torch.zeros(1, dtype=torch.int32, device=dev)
        steps = torch.arange(B, dtype=torch.int64, device=dev)
        # host loop extent for the current binding (set by build_args)
        cell = {"n_batches": 0}

        def batch(p0, p_lim, m_c, cum_w):
            p = steps + p0
            live = p < p_lim
            ps = torch.where(live, p, torch.zeros_like(p))
            j = torch.searchsorted(cum_w, ps, right=True).clamp(
                max=cum_w.shape[0] - 1)
            prev = torch.where(j > 0, cum_w[(j - 1).clamp(min=0)],
                               torch.zeros_like(j))
            k = ps - prev
            a = d_e1f[j].to(torch.int64)
            b = d_e1t[j].to(torch.int64)
            idx = (d_starts2[b] + k).clamp(max=d_adj2.shape[0] - 1)
            c = d_adj2[idx]
            live = live & m_c[c]
            # sorted-pair multiplicity probe: the aggregate-only
            # specialization of the WCOJ close step (ops/wcoj.py)
            cnt = WC.multiplicity(d_keys, a * n + c.to(torch.int64))
            return torch.where(live, cnt, torch.zeros_like(cnt)).sum()

        def run(m_c, cum_w):
            out = torch.zeros(cap1, dtype=torch.int64, device=dev)
            n_batches = cell["n_batches"]
            if n_batches == 0:
                return out
            # the exact 2-path total bounds the live slots of the last
            # batch; it stays on the device
            p_lim = cum_w[-1]
            total = batch(0, p_lim, m_c, cum_w)
            for i in range(1, n_batches):
                total = total + batch(i * B, p_lim, m_c, cum_w)
            out[0] = total
            return out

        static_nbytes = sum(int(x.nbytes) for x in (d_e1f, d_e1t, d_starts2,
                                                    d_adj2, d_keys))

        def build_args(params):
            """The parameter-dependent half: dense node masks + the
            masked 2-path weight prefix sum (eager device ops).  One
            host read (P, counted in the backend's size reads) sizes the
            batch loop — and re-stamps the bytes the batches read from
            the resident static arrays (``run.nbytes_in``)."""
            m_a = self._cycle_mask_dev(st, self.seed, n, params)
            m_b = self._cycle_mask_dev(st, h1.target, n, params)
            m_c = self._cycle_mask_dev(st, h2.target, n, params)
            if m_a is None or m_b is None or m_c is None:
                return None
            deg2 = d_starts2[d_e1t.long() + 1] - d_starts2[d_e1t]
            w = torch.where(m_a[d_e1f] & m_b[d_e1t], deg2,
                            torch.zeros_like(deg2))
            cum_w = torch.cumsum(w, 0)
            backend.syncs += 1
            p_total = int(cum_w[-1])
            cell["n_batches"] = (p_total + B - 1) // B
            run.nbytes_in = cell["n_batches"] * static_nbytes
            return (m_c, cum_w)

        args = build_args(self.context.parameters)
        if args is None:
            return None
        self.strategy = "cycle-probe"
        all_preds = (list(self.seed.preds) + list(h1.target.preds)
                     + list(h2.target.preds) + list(ch.target.preds))
        has_param_preds = any(
            isinstance(x, E.Param)
            for p in all_preds for x in _walk_expr(p))
        return (run, args, valid, build_args if has_param_preds else None)

    def _pretty_args(self):
        ch = self.close_hop
        arrow = ">" if ch.direction == Direction.OUTGOING else "<"
        return (f"{self.out_name}=count(*), triangle ({self.seed.var})"
                f"->({self.hops[0].target.var})->({self.hops[1].target.var})"
                f" closed by [:{'|'.join(ch.rel_types)}]{arrow}, "
                f"strategy={self.strategy}")
