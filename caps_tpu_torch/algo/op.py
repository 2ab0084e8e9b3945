"""``AlgoProcedureOp``: the relational operator behind ``CALL algo.*``.

The counterpart of ``caps_tpu/algo/op.py``.  One operator per planned
procedure call.  ``_compute`` reads the graph through the
snapshot-consistent ``scan_node``/``scan_rel`` seam (live writes and
delta overlays are visible exactly as every other operator sees them)
and builds the graph arrays ON THE DEVICE: sorted unique node ids,
endpoint indices by binary search in them, and the live-endpoint
filter, compacted in edge order.  Then it dispatches:

* **device-fixpoint** — the torch program (``algo/fixpoint.py``) at
  shape-lattice bucketed capacities, cached per ``(procedure, node
  capacity, edge capacity | "dense")`` on the backend
  (``backend.algo_fns``); a miss builds and first-runs the program
  inside a ``charged("algo", ...)`` compile-ledger boundary, so a
  warmed shape charges zero;
* **host** — the NumPy kernel (``algo/kernels.py``), chosen up front
  when the cost model priced the device program out (``prefer_host``)
  or the graph is empty: the only time the arrays go to the host.  A
  session with no device backend (the pure-Python oracle,
  ``backends/local``) always takes it, over the host arrays its tables
  give, as the reference's local session does.

There is no degraded ``fallback-host``: a fault in the device program
propagates to the caller (the serving tier's retry ladder answers it on
a later execution), as the multiway join's does.

The sizes the host needs (node and edge counts, the fixpoint's
iteration count and convergence, the reachable rows BFS/SSSP emit) go
through the backend's size stream, so an exact fused replay of a
``CALL`` query runs the recorded number of steps without reading the
card; a snapshot after a write is another graph, with its own
recording.  Convergence metrics (``iterations``, ``converged``,
``strategy``, ``layout``, ``procedure``) ride the operator's op_stats
entry into PROFILE and the observed-statistics store; the
``algo.executions`` and ``algo.iterations`` counters the session's
registry.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from caps_tpu_torch.algo import kernels
from caps_tpu_torch.algo.registry import ProcedureSignature
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.obs.compile import charged as _compile_charged
from caps_tpu_torch.okapi.types import CTFloat
from caps_tpu_torch.relational.header import HeaderError, RecordHeader
from caps_tpu_torch.relational.ops import RelationalOperator, host_eval

_TOP = torch.iinfo(torch.int64).max


class _GraphArrays:
    """The compacted snapshot view one execution operates on, on the
    device: ``ids`` (sorted unique node ids, padded to ``n_pad`` with
    int64 max), ``src``/``tgt`` (endpoint indices, padded to ``e_pad``
    with 0), ``edge_mask``, ``weights`` (float64); ``n`` and ``e`` are
    the live counts."""

    __slots__ = ("ids", "n", "src", "tgt", "edge_mask", "weights", "e")

    def __init__(self, ids, n, src, tgt, edge_mask, weights, e):
        self.ids, self.n = ids, n
        self.src, self.tgt, self.edge_mask = src, tgt, edge_mask
        self.weights, self.e = weights, e

    @property
    def node_mask(self) -> torch.Tensor:
        return torch.arange(self.ids.shape[0],
                            device=self.ids.device) < self.n

    def host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(ids, src, tgt, weights) of the live lanes as numpy arrays."""
        return (self.ids[:self.n].cpu().numpy(),
                self.src[:self.e].cpu().numpy(),
                self.tgt[:self.e].cpu().numpy(),
                self.weights[:self.e].cpu().numpy())


class AlgoProcedureOp(RelationalOperator):
    """Execute one registered graph-algorithm procedure and emit its
    YIELD columns as device columns."""

    def __init__(self, context, parent: RelationalOperator, graph,
                 signature: ProcedureSignature,
                 args: Tuple[E.Expr, ...],
                 yields: Tuple[Tuple[str, str], ...],
                 prefer_host: bool = False):
        super().__init__(context, [parent])
        self.graph = graph
        self.signature = signature
        self.args = args
        self.yields = yields
        self.prefer_host = prefer_host
        self.strategy = "unplanned"
        self._layout = "host"

    # -- dispatch ----------------------------------------------------------

    def _compute(self):
        from caps_tpu_torch.obs import clock
        registry = self._registry()
        values = [host_eval(a, self.context.parameters) for a in self.args]
        bound = self.signature.bind(values)
        if getattr(self.context.factory, "backend", None) is None:
            return self._compute_local(bound, registry)
        # the clock reads below time the three parts for the operator's
        # metrics only; no value they give reaches the computation, so a
        # replay gives the recorded rows whatever they read
        t0 = clock.now()  # capslint: disable=tracer-purity
        data = self._graph_arrays(bound)
        self._resolve_source(bound, data)
        t1 = clock.now()  # capslint: disable=tracer-purity
        if self.prefer_host or data.n == 0:
            out, iters, converged = self._compute_host(data, bound)
            self.strategy = "host"
            self._layout = "host"
        else:
            out, iters, converged = self._compute_device(data, bound)
            self.strategy = "device-fixpoint"
        t2 = clock.now()  # capslint: disable=tracer-purity
        if registry is not None:
            registry.counter("algo.executions").inc()
            registry.counter("algo.iterations").inc(int(iters))
        self._metric_extra = {
            "strategy": self.strategy,
            "procedure": self.signature.name,
            "layout": self._layout,
            "iterations": int(iters),
            "converged": bool(converged),
        }
        result = self._emit(data, out)
        t3 = clock.now()  # capslint: disable=tracer-purity
        # host seconds of the three parts (each ends in a read of the
        # card in eager and record runs; a replay's are enqueue times)
        self._metric_extra.update(graph_arrays_s=t1 - t0,
                                  fixpoint_s=t2 - t1, emit_s=t3 - t2)
        return result

    def _registry(self):
        session = getattr(self.context, "session", None)
        return getattr(session, "metrics_registry", None)

    def _backend(self):
        return self.context.factory.backend

    # -- snapshot seam -----------------------------------------------------

    def _graph_arrays(self, bound: Dict[str, Any]) -> _GraphArrays:
        from caps_tpu_torch.backends.cuda import kernels as K
        from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice

        backend = self._backend()
        dev = backend.device
        nvar, rvar = "__algo_n", "__algo_r"
        from caps_tpu_torch.backends.cuda.sharded import whole
        n_header, n_table = self.graph.scan_node(nvar, ())
        # the fixpoints run on one device: row-resident scans gather to
        # the lead first
        n_table = whole(n_table)
        idc = n_table._cols[n_header.column(E.Var(nvar))]
        top = torch.full((), _TOP, dtype=torch.int64, device=dev)
        keys = torch.where(idc.valid & n_table.row_ok,
                           idc.data.to(torch.int64), top)
        keys = torch.sort(keys).values
        first = keys != top
        first[1:] &= keys[1:] != keys[:-1]
        n = backend.consume_count(K.mask_count(first))
        n_pad = backend.bucket(max(n, 1))
        lanes = torch.arange(n_pad, device=dev)
        ids = torch.where(lanes < n, keys[K.compact_indices(first, n_pad)],
                          top)

        r_header, r_table = self.graph.scan_rel(rvar, ())
        r_table = whole(r_table)
        rv = E.Var(rvar)
        s = r_table._cols[r_header.column(E.StartNode(rv))]
        t = r_table._cols[r_header.column(E.EndNode(rv))]
        src_id = s.data.to(torch.int64)
        tgt_id = t.data.to(torch.int64)
        si = torch.searchsorted(ids, src_id).clamp_(max=n_pad - 1)
        ti = torch.searchsorted(ids, tgt_id).clamp_(max=n_pad - 1)
        live = (s.valid & t.valid & r_table.row_ok
                & (ids[si] == src_id) & (ids[ti] == tgt_id))

        weights = torch.ones(live.shape[0], dtype=torch.float64, device=dev)
        key = bound.get("weight")
        if key:
            try:
                wcol = r_header.column(E.Property(rv, key))
            except HeaderError:
                wcol = None  # unknown property: unit weights
            if wcol is not None:
                w = r_table._cols[wcol]
                if w.kind not in ("int", "id", "float"):
                    raise UnsupportedOnDevice(
                        f"{self.signature.name}: weight property {key!r} "
                        f"is not numeric")
                weights = torch.where(w.valid, w.data.to(torch.float64),
                                      torch.ones_like(weights))

        e = backend.consume_count(K.mask_count(live))
        e_pad = backend.bucket(max(e, 1))
        eidx = K.compact_indices(live, e_pad)
        edge_mask = torch.arange(e_pad, device=dev) < e
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return _GraphArrays(
            ids, n,
            torch.where(edge_mask, si[eidx], zero),
            torch.where(edge_mask, ti[eidx], zero),
            edge_mask,
            torch.where(edge_mask, weights[eidx],
                        torch.zeros((), dtype=torch.float64, device=dev)),
            e)

    def _resolve_source(self, bound: Dict[str, Any],
                        data: _GraphArrays) -> None:
        """Map a ``source`` node-id argument to its compacted index (-1
        when the id is absent from the snapshot), as a 0-d device
        tensor: no read."""
        if "source" not in bound:
            return
        sid = torch.full((1,), int(bound["source"]), dtype=torch.int64,
                         device=data.ids.device)
        idx = torch.searchsorted(data.ids, sid).clamp_(
            max=data.ids.shape[0] - 1)
        found = (data.ids[idx] == sid) & (idx < data.n)
        bound["source_index"] = torch.where(found, idx, -1)[0]

    # -- device path (the failing_algo patch point) ------------------------

    def _compute_device(self, data: _GraphArrays, bound: Dict[str, Any]
                        ) -> Tuple[torch.Tensor, int, bool]:
        from caps_tpu_torch.algo.fixpoint import (
            build_dense_program, build_program, dense_eligible, densify,
            scalar_values,
        )

        backend = self._backend()
        name = self.signature.name
        n_pad = data.ids.shape[0]
        e_pad = data.src.shape[0]
        scalars = scalar_values(name, bound, data.n)
        if dense_eligible(n_pad, data.e):
            # dense tile: the edge list approaches the full n x n
            # capacity square — densify once, iterate with products
            self._layout = "dense-tile"
            e = data.e
            A, W = densify(n_pad, data.src[:e], data.tgt[:e],
                           data.edge_mask[:e], data.weights[:e],
                           name == "algo.sssp")
            operands = (data.node_mask, A, W) + scalars
            live_edges = {}
            key = (name, n_pad, "dense")
            shape = f"{name}:n{n_pad}:dense"
            build = lambda: build_dense_program(name, n_pad)  # noqa: E731
        else:
            self._layout = "edge-list"
            operands = (data.node_mask, data.src, data.tgt, data.edge_mask,
                        data.weights) + scalars
            # the edges are compacted live-first: the tail is dead
            live_edges = {"n_edges": data.e}
            key = (name, n_pad, e_pad)
            shape = f"{name}:n{n_pad}:e{e_pad}"
            build = lambda: build_program(name, n_pad, e_pad)  # noqa: E731

        out_box = []

        def run(fn):
            def loop(steps, reads):
                out, it, done = fn(*operands, steps=steps, reads=reads,
                                   **live_edges)
                out_box.append(out)
                return it, done
            return backend.consume_fixpoint(loop)

        fn = backend.algo_fns.get(key)
        if fn is None:
            # build + first run inside ONE ledger boundary: re-running
            # a warmed shape charges zero (the once-then-zero contract)
            with _compile_charged("algo", shape=shape):
                fn = build()
                iters, converged = run(fn)
            backend.algo_fns[key] = fn
        else:
            iters, converged = run(fn)
        return out_box[-1], iters, converged

    # -- host path (the planned ``host`` strategy) -------------------------

    def _compute_host(self, data: _GraphArrays, bound: Dict[str, Any]
                      ) -> Tuple[np.ndarray, int, bool]:
        ids, src, tgt, weights = data.host()
        if "source" in bound:
            sid = bound["source"]
            idx = int(np.searchsorted(ids, sid)) if data.n else 0
            found = data.n and idx < data.n and int(ids[idx]) == sid
            bound = dict(bound, source_index=idx if found else -1)
        return kernels.run_host(self.signature.name, data.n, src, tgt,
                                weights, bound)

    # -- a session with no device backend (backends/local) ---------------

    def _compute_local(self, bound: Dict[str, Any], registry):
        """The reference's host path over host tables: the graph arrays
        from ``column_values``, the NumPy kernel, the YIELD columns as
        host value columns."""
        ids, src, tgt, weights = self._local_arrays(bound)
        n = int(ids.shape[0])
        if "source" in bound:
            sid = bound["source"]
            idx = int(np.searchsorted(ids, sid)) if n else 0
            found = n and idx < n and int(ids[idx]) == sid
            bound["source_index"] = idx if found else -1
        out, iters, converged = kernels.run_host(
            self.signature.name, n, src, tgt, weights, bound)
        self.strategy = "host"
        self._layout = "host"
        if registry is not None:
            registry.counter("algo.executions").inc()
            registry.counter("algo.iterations").inc(int(iters))
        self._metric_extra = {
            "strategy": self.strategy,
            "procedure": self.signature.name,
            "layout": self._layout,
            "iterations": int(iters),
            "converged": bool(converged),
        }
        return self._emit_local(ids, out)

    @staticmethod
    def _local_ints(table, col: str) -> Tuple[np.ndarray, np.ndarray]:
        raw = table.column_values(col)
        ok = np.array([v is not None for v in raw], dtype=bool)
        vals = np.array([0 if v is None else v for v in raw])
        if vals.shape[0] == 0:
            vals = vals.astype(np.int64)
        return vals, ok

    def _local_arrays(self, bound: Dict[str, Any]):
        """(ids, src, tgt, weights): sorted unique node ids, the live
        edges' endpoint indices and weights."""
        nvar, rvar = "__algo_n", "__algo_r"
        n_header, n_table = self.graph.scan_node(nvar, ())
        ids, ok = self._local_ints(n_table, n_header.column(E.Var(nvar)))
        ids = np.unique(ids[ok]).astype(np.int64)
        n = int(ids.shape[0])
        r_header, r_table = self.graph.scan_rel(rvar, ())
        rv = E.Var(rvar)
        src, sok = self._local_ints(r_table,
                                    r_header.column(E.StartNode(rv)))
        tgt, tok = self._local_ints(r_table,
                                    r_header.column(E.EndNode(rv)))
        eok = sok & tok
        src = src.astype(np.int64)[eok]
        tgt = tgt.astype(np.int64)[eok]
        weights = np.ones(src.shape[0], dtype=np.float64)
        key = bound.get("weight")
        if key:
            try:
                wcol = r_header.column(E.Property(rv, key))
            except HeaderError:
                wcol = None  # unknown property: unit weights
            if wcol is not None:
                w, wok = self._local_ints(r_table, wcol)
                w = np.where(wok, w.astype(np.float64), 1.0)[eok]
                if w.shape[0] == src.shape[0]:
                    weights = w
        if n == 0:
            empty = np.zeros(0, dtype=np.int64)
            return ids, empty, empty, np.zeros(0, dtype=np.float64)
        si = np.minimum(np.searchsorted(ids, src), n - 1)
        ti = np.minimum(np.searchsorted(ids, tgt), n - 1)
        live = (ids[si] == src) & (ids[ti] == tgt)
        return ids, si[live], ti[live], weights[live]

    def _emit_local(self, ids: np.ndarray, out: np.ndarray):
        name = self.signature.name
        n = int(ids.shape[0])
        if name == "algo.wcc":
            out = ids[out] if n else out
        keep = np.ones(n, dtype=bool)
        if name == "algo.bfs":
            keep = out != kernels.UNREACHED
        elif name == "algo.sssp":
            keep = np.isfinite(out)
        ids, out = ids[keep], out[keep]
        columns: Dict[str, list] = {}
        types: Dict[str, Any] = {}
        header = RecordHeader.empty()
        for yield_name, out_name in self.yields:
            ctype = self.signature.yield_type(yield_name)
            if yield_name == "node":
                vals = [int(v) for v in ids]
            elif ctype == CTFloat:
                vals = [float(v) for v in out]
            else:
                vals = [int(v) for v in out]
            columns[out_name] = vals
            types[out_name] = ctype
            header = header.concat(RecordHeader.for_value(out_name, ctype))
        return header, self.context.factory.from_columns(columns, types)

    # -- output assembly ---------------------------------------------------

    def _emit(self, data: _GraphArrays, out):
        from caps_tpu_torch.backends.cuda.column import Column
        from caps_tpu_torch.backends.cuda.table import DeviceTable

        backend = self._backend()
        dev = data.ids.device
        n_pad = data.ids.shape[0]
        if isinstance(out, np.ndarray):  # the host strategy
            padded = np.zeros(n_pad, dtype=out.dtype)
            padded[:out.shape[0]] = out
            out = torch.from_numpy(padded).to(dev)
        elif out.dtype.is_floating_point:
            # quantize with the SAME host function the oracle uses
            # (kernels.SCORE_DECIMALS), after one transfer
            out = torch.from_numpy(np.round(
                out.cpu().numpy(), kernels.SCORE_DECIMALS)).to(dev)
        name = self.signature.name
        node_lane = data.node_mask
        if name == "algo.wcc":
            # labels are component-min *indices*: map back to node ids
            # so components are named by their smallest member id
            out = data.ids[torch.where(node_lane, out, 0)]
        keep = None
        if name == "algo.bfs":
            keep = node_lane & (out != kernels.UNREACHED)
        elif name == "algo.sssp":
            keep = node_lane & torch.isfinite(out)

        cols = {}
        header = RecordHeader.empty()
        for yield_name, out_name in self.yields:
            ctype = self.signature.yield_type(yield_name)
            if yield_name == "node":
                vals, kind = data.ids, "int"
            elif ctype == CTFloat:
                vals, kind = out.to(torch.float64), "float"
            else:
                vals, kind = out.to(torch.int64), "int"
            cols[out_name] = Column(kind, torch.where(node_lane, vals, 0),
                                    node_lane, ctype)
            header = header.concat(RecordHeader.for_value(out_name, ctype))
        table = DeviceTable(backend, cols, data.n)
        if keep is not None:
            table = table._compact(keep)
        return header, table

    def _pretty_args(self) -> str:
        a = ", ".join(x.cypher_repr() for x in self.args)
        y = ", ".join(out if yn == out else f"{yn} AS {out}"
                      for yn, out in self.yields)
        return f"{self.signature.name}({a}) YIELD {y}"
