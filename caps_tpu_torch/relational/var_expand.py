"""Bounded variable-length expand.

Mirrors the reference's ``planBoundedVarLengthExpand`` — iterative
join-and-union up to the upper bound with relationship-uniqueness (edge
isomorphism) filters (ref: okapi-relational planner — reconstructed,
mount empty; SURVEY.md §3.2).  The counterpart of
``caps_tpu/relational/var_expand.py``.

The unroll is static: hop ``k`` joins the frontier against a per-hop copy
of the relationship scan (the expand-positions kernel materializes each
join); every new hop id is filtered against all previous hop ids;
lengths ``lower..upper`` are unioned, with traversed relationship ids
packed into one list-valued column.

When the relationship variable is dead downstream (the planner proves it
— no projection, filter, or return touches it), the op instead computes a
per-seed path-count MATRIX with SpMV hops (``parallel/ring.py``) and
explodes (source, target, multiplicity) back into rows (strategy
"matrix").  Per-path relationship lists cannot ride this form; those
queries stay on joins.  On a 1-D mesh the matrix's frontier blocks
rotate around the ring schedule instead (``make_ring_varexpand``,
strategy "ring-matrix"); a 2-D mesh runs the single-device form on the
lead device.
"""
from __future__ import annotations

from typing import List, Optional as Opt, Tuple

import numpy as np
import torch

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.okapi.types import (
    CTInteger, CTList, CTRelationship, CypherType,
)
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.ops import RelationalOperator
from caps_tpu_torch.relational.table import Table

# Safety cap for unbounded `[*]` patterns (the reference requires Spark to
# materialize each iteration too; unbounded expansion needs *some* limit).
DEFAULT_UNBOUNDED_UPPER = 10


def synth_header(table: Table) -> RecordHeader:
    """A header mapping every physical column to ``Var(col)`` — used for
    internal columnar filtering where no user-level header applies."""
    return RecordHeader([(E.Var(c), c, table.column_type(c))
                         for c in table.columns])


class VarExpandOp(RelationalOperator):
    def __init__(self, context, parent: RelationalOperator, graph,
                 source: str, rel: str, rel_types: Tuple[str, ...],
                 target: str, target_labels, direction: Direction,
                 lower: int, upper: Opt[int], into: bool,
                 rel_needed: bool = True, emit_len: Opt[str] = None):
        super().__init__(context, [parent])
        self.graph = graph
        self.source = source
        self.rel = rel
        self.rel_types = rel_types
        self.target = target
        self.target_labels = frozenset(target_labels)
        self.direction = direction
        self.lower = lower
        self.upper = upper if upper is not None else max(
            lower, DEFAULT_UNBOUNDED_UPPER)
        self.into = into
        # False = the planner proved no downstream operator reads the rel
        # variable, so per-path relationship lists need not materialize.
        self.rel_needed = rel_needed
        # Set when the planner rewrote every size(rel)/length(rel) read
        # to this path-length column (planner._collect_used_names).
        self.emit_len = emit_len
        self.strategy = "join"

    # ------------------------------------------------------------------

    def _rel_hop_table(self, k: int) -> Tuple[Table, str, str, str]:
        """The relationship table for hop ``k`` with per-hop column names
        (id, near, far) following the traversal direction."""
        tmp_var = f"__vle{k}"
        header, t = self.graph.scan_rel(tmp_var, self.rel_types)
        idc = header.column(E.Var(tmp_var))
        src = header.column(E.StartNode(E.Var(tmp_var)))
        tgt = header.column(E.EndNode(E.Var(tmp_var)))
        t = t.select([idc, src, tgt])
        hid, hnear, hfar = f"__hop{k}_id", f"__hop{k}_near", f"__hop{k}_far"
        if self.direction == Direction.OUTGOING:
            t = t.rename({idc: hid, src: hnear, tgt: hfar})
        elif self.direction == Direction.INCOMING:
            t = t.rename({idc: hid, tgt: hnear, src: hfar})
        else:  # BOTH: traverse each edge in either orientation
            fwd = t.rename({idc: hid, src: hnear, tgt: hfar})
            bwd = t.rename({idc: hid, tgt: hnear, src: hfar})
            sh = synth_header(bwd)
            bwd = bwd.filter(
                E.Not(E.Equals(E.Var(hnear), E.Var(hfar))), sh, {})
            fwd = fwd.select([hid, hnear, hfar])
            bwd = bwd.select([hid, hnear, hfar])
            t = fwd.union_all(bwd)
        return t.select([hid, hnear, hfar]), hid, hnear, hfar

    def _compute(self):
        out = self._try_matrix()
        if out is None:
            self.strategy = "join"
            out = self._join_compute()
        self._metric_extra = {"strategy": self.strategy}
        return out

    # -- matrix path (see module docstring) ---------------------------------

    # Refuse seed-matrix shapes beyond this many entries (the int64
    # frontier blocks must fit comfortably in device memory); larger
    # inputs stay on the join path.  Seed-axis chunking bounds the rest.
    _RING_MAX_MATRIX = 1 << 24

    def _try_matrix(self):
        """Matrix-form var-expand (multiplicity form): returns the
        (header, table) result, or None when the shape is ineligible.
        All three directions qualify — undirected patterns symmetrize
        the edge list and use the degree-form isomorphism correction.
        The join cascade and its per-hop materializations disappear."""
        # ``into`` (both endpoints bound) stays on joins, as in the JAX
        # package: the single-pair shape pays more in per-length
        # explode/union work than the tiny bound-pair joins cost.
        if self.rel_needed or self.into or self.upper > 3:
            return None
        backend = getattr(self.context.factory, "backend", None)
        if backend is None or not backend.config.use_ring:
            return None
        from caps_tpu_torch.backends.cuda import kernels as K
        from caps_tpu_torch.backends.cuda.column import Column
        from caps_tpu_torch.backends.cuda.table import DeviceTable
        from caps_tpu_torch.parallel.ring import (
            ring_varexpand3_cached, ring_varexpand3_reference,
            ring_varexpand_cached, ring_varexpand_reference,
        )
        dev = backend.device
        mesh = backend.mesh
        on_ring = mesh is not None and mesh.devices.ndim == 1
        n_shards = mesh.size if on_ring else 1

        parent_header, parent_table = self.children[0].result
        src_id_col = parent_header.column(E.Var(self.source))
        pcol = parent_table._cols.get(src_id_col)
        if pcol is None or pcol.kind not in ("id", "int"):
            return None
        static = self._matrix_static(backend)
        if static is None:
            return None
        tgt_header, tgt_table = self.graph.scan_node(
            self.target, self.target_labels)
        tgt_id_col = tgt_header.column(E.Var(self.target))

        # The seeds (the parent's source ids) stay on the device: the JAX
        # package reads them to the host; here the three sizes the plan
        # needs from them go through the size stream, so a replay reads
        # nothing.  "cap" sizes are exact outside generic replay, where
        # a served bound only adds dead (all-zero) seed rows.
        mx = static["mx"]
        pids = pcol.data.to(torch.int64)
        p_ok = pcol.valid & parent_table.row_ok
        if backend.consume_count((p_ok & (pids < 0)).any().to(torch.int64),
                                 relation="exact"):
            return None
        if pids.shape[0]:
            mx = max(mx, backend.consume_count(
                torch.where(p_ok, pids, torch.full_like(pids, -1)).max(),
                relation="cap"))
        n_pad = max(-(-(mx + 1) // n_shards) * n_shards, n_shards)
        if n_pad > self._RING_MAX_MATRIX:
            return None  # a single frontier row exceeds the budget
        # (large SEED sets are fine — the execution below chunks them)
        is_seed = torch.zeros(n_pad + 1, dtype=torch.bool, device=dev)
        is_seed[torch.where(p_ok, pids, torch.full_like(pids, n_pad)
                            ).clamp(0, n_pad)] = True
        is_seed = is_seed[:n_pad]
        n_seeds = backend.consume_count(is_seed.sum(), relation="cap")
        lengths = tuple(range(self.lower, self.upper + 1))
        self.strategy = "ring-matrix" if on_ring else "matrix"
        rel_list_type = CTList(CTRelationship(self.rel_types))

        if n_seeds == 0:
            def empty():
                return Column("int", torch.zeros(1, dtype=torch.int64,
                                                 device=dev),
                              torch.zeros(1, dtype=torch.bool, device=dev),
                              CTInteger)
            cols0 = {"__ring_src": empty(), "__ring_tgt": empty()}
            if self.emit_len:
                cols0[self.emit_len] = empty()
            pairs = DeviceTable(backend, cols0, n=0)
            return self._ring_assemble(parent_header, parent_table,
                                       src_id_col, tgt_header, tgt_table,
                                       tgt_id_col, pairs, rel_list_type)

        # peak working set is the per-hop (seeds, edges) gather — bound
        # it like the (seeds, nodes) frontier.  The 3-hop sparse
        # correction hops gather up to 4 entries per rel (vs <= 2 in the
        # base list), so bound the widest list the program will touch.
        e_pad = static["e_pad"]
        widest = e_pad * 2 if self.upper == 3 else e_pad
        # SEED BLOCKING: the per-hop working set is seeds x max(nodes,
        # edges); larger seed sets run in fixed-size chunks (zero-padded
        # last block) whose pair tables union.
        # (the ring splits the edges over the shards)
        per_seed = max(n_pad, widest // n_shards)
        if per_seed > self._RING_MAX_MATRIX:
            return None  # even one seed's per-hop gather exceeds budget
        # pow2-pad the chunk dimension so a parameter sweep keeps its
        # shapes; plain pow2 (no 256-row bucket minimum, which would
        # inflate a single-seed frontier 256x)
        seeds_p2 = 1 << max(0, n_seeds - 1).bit_length()
        chunk = max(1, min(seeds_p2, self._RING_MAX_MATRIX // per_seed))
        n_chunks = (n_seeds + chunk - 1) // chunk
        if n_chunks > 64:  # degenerate shapes stay on the join path
            return None
        extra3 = static["extra3"]
        if extra3 is None:
            return None  # no valid relationship ids for the 3-hop terms
        correction = static["correction"]
        frm_d, to_d, okp_d = static["edges"]
        tmask_d, r2_d = static["tmask"], static["r2"]
        if tmask_d.shape[0] < n_pad:   # parent ids beyond the graph's
            zeros = torch.zeros(n_pad - tmask_d.shape[0], dtype=torch.int64,
                                device=dev)
            tmask_d = torch.cat([tmask_d, zeros])
            r2_d = torch.cat([r2_d, zeros])

        if on_ring:
            def shard_pad(t):
                k = -(-max(t.shape[0], 1) // n_shards) * n_shards
                return torch.cat([t, torch.zeros(k - t.shape[0],
                                                 dtype=t.dtype, device=dev)])
            ring_edges = tuple(shard_pad(t) for t in (frm_d, to_d, okp_d))
            ring_extra3 = tuple(shard_pad(t) for t in extra3)

        def run_chunk(f0, lens):
            if on_ring:
                if max(lens) == 3:
                    fn = ring_varexpand3_cached(mesh, n_pad, lens,
                                                correction)
                    return fn(f0, *ring_edges, tmask_d, *ring_extra3)
                fn = ring_varexpand_cached(mesh, n_pad, lens, correction)
                return fn(f0, *ring_edges, tmask_d)
            base = (f0, frm_d, to_d, okp_d, tmask_d, lens)
            if max(lens) == 3:
                return ring_varexpand3_reference(
                    *base, extra3[:3], extra3[3:], correction, r2=r2_d)
            return ring_varexpand_reference(*base, correction, r2=r2_d)

        # emit_len: one multiplicity matrix PER length with its length
        # tagged on the rows; otherwise one matrix for the union
        length_runs = ([(L, (L,)) for L in lengths] if self.emit_len
                       else [(None, lengths)])
        # the distinct seed ids ascending (np.unique's order), padded to
        # the served count with rows that seed nothing
        seeds_d = K.compact_indices(is_seed, n_seeds)
        seed_live = (torch.arange(n_seeds, device=dev)
                     < is_seed.sum()).to(torch.int64)
        parts: List[Table] = []
        for ci in range(n_chunks):
            block = seeds_d[ci * chunk:(ci + 1) * chunk]
            nb = block.shape[0]
            f0 = torch.zeros((chunk, n_pad), dtype=torch.int64, device=dev)
            f0[torch.arange(nb, device=dev), block] = \
                seed_live[ci * chunk:(ci + 1) * chunk]
            block_pad = torch.zeros(chunk, dtype=torch.int64, device=dev)
            block_pad[:nb] = block
            for tag, lens in length_runs:
                counts = run_chunk(f0, lens).reshape(-1)
                total, live_n = backend.consume_rows(counts.sum())
                out_cap = backend.bucket(total)
                row, _within, valid, _tot = K.explode_expand(
                    counts, torch.ones_like(counts, dtype=torch.bool),
                    out_cap)
                cols = {
                    "__ring_src": Column("int", block_pad[row // n_pad],
                                         valid, CTInteger),
                    "__ring_tgt": Column("int", row % n_pad, valid,
                                         CTInteger),
                }
                if tag is not None:
                    cols[self.emit_len] = Column(
                        "int", torch.full((out_cap,), tag,
                                          dtype=torch.int64, device=dev),
                        valid, CTInteger)
                parts.append(DeviceTable(backend, cols, n=total,
                                         live=live_n))
        # balanced pairwise concat: incremental union over many chunk x
        # length parts would re-copy the accumulated rows quadratically
        while len(parts) > 1:
            parts = [parts[i].union_all(parts[i + 1])
                     if i + 1 < len(parts) else parts[i]
                     for i in range(0, len(parts), 2)]
        return self._ring_assemble(parent_header, parent_table, src_id_col,
                                   tgt_header, tgt_table, tgt_id_col,
                                   parts[0], rel_list_type)

    def _matrix_static(self, backend):
        """The matrix form's graph-static inputs — the edge list of this
        pattern's types and direction (live entries only, symmetrized
        for undirected patterns), the target mask, the 3-hop sparse
        correction lists, the largest id — built on the host once per
        graph and cached with the count closures' static structures.
        None when an id is negative (no dense domain)."""
        from caps_tpu_torch.backends.cuda.fused import _graph_key
        from caps_tpu_torch.relational.count_pattern import graph_static
        gk = _graph_key(self.graph)
        cache = graph_static(backend, gk)["matrix"] if gk is not None \
            else {}
        key = (tuple(self.rel_types), self.direction, self.target_labels,
               self.upper == 3)
        if key not in cache:
            cache[key] = self._build_matrix_static(backend)
        return cache[key]

    def _build_matrix_static(self, backend):
        from caps_tpu_torch.parallel.ring import build_iso3_sparse, r2_vector
        rel_header, rel_t = self.graph.scan_rel("__ring_r", self.rel_types)
        rv = E.Var("__ring_r")
        rsrc = rel_t.host_column(rel_header.column(E.StartNode(rv)))
        rtgt = rel_t.host_column(rel_header.column(E.EndNode(rv)))
        tgt_header, tgt_table = self.graph.scan_node(
            "__ring_t", self.target_labels)
        tids = tgt_table.host_column(
            tgt_header.column(E.Var("__ring_t")))
        if rsrc is None or rtgt is None or tids is None:
            return None
        esrc, eok1 = rsrc
        etgt, eok2 = rtgt
        eok = eok1 & eok2
        nids, nok = tids
        mx = -1
        for vals, ok in ((esrc, eok), (etgt, eok), (nids, nok)):
            if vals.shape[0] and ok.any():
                if int(vals[ok].min()) < 0:
                    return None
                mx = max(mx, int(vals[ok].max()))
        n_static = max(mx + 1, 1)
        tmask = np.zeros(n_static, dtype=np.int64)
        tmask[nids[nok]] = 1
        if self.direction == Direction.BOTH:
            # symmetrize: each non-loop edge in both orientations,
            # self-loops once (the BOTH hop table does the same); the
            # isomorphism correction switches to degree form
            nonloop = eok & (esrc != etgt)
            a = np.concatenate([esrc, etgt[nonloop]])
            b = np.concatenate([etgt, esrc[nonloop]])
            ok_cat = np.concatenate([eok, np.ones(nonloop.sum(), bool)])
            correction = "degree"
        else:
            a, b = (esrc, etgt) if self.direction == Direction.OUTGOING \
                else (etgt, esrc)
            ok_cat = eok
            correction = "loops"
        # compact to live entries: host mirrors are capacity-padded (the
        # bucket, not the live row count), and dead rows would inflate
        # every hop's gather width
        live = np.asarray(ok_cat)
        a, b = np.asarray(a)[live], np.asarray(b)[live]
        e_pad = max(a.shape[0], 1)
        frm = np.zeros(e_pad, dtype=np.int32)
        to = np.zeros(e_pad, dtype=np.int32)
        okp = np.zeros(e_pad, dtype=bool)
        frm[:a.shape[0]] = a
        to[:b.shape[0]] = b
        okp[:a.shape[0]] = True

        def up(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                backend.device)

        extra3 = ()
        if self.upper == 3:
            # 3-hop isomorphism correction needs the entries' underlying
            # relationship ids (host-side sparse-hop build)
            rids = rel_t.host_column(rel_header.column(rv))
            if rids is None or not bool(np.all(rids[1] >= eok)):
                # the id column must be valid wherever the endpoints are
                # (a garbage id would corrupt the orientation grouping)
                extra3 = None
            else:
                rid_all = rids[0]
                rid_cat = (np.concatenate([rid_all, rid_all[nonloop]])
                           if self.direction == Direction.BOTH else rid_all)
                # a/b are live-compacted; align rids with the same mask
                sp13, spt = build_iso3_sparse(a, b, rid_cat[live], n_static)
                extra3 = tuple(up(x) for x in (*sp13, *spt))
        edges = (up(frm), up(to), up(okp))
        # the length-2 correction vector depends on the graph alone: one
        # pass over the edges here, not one per seed chunk and length
        r2 = r2_vector(*edges, n_static, torch.int64, correction)
        return {"mx": mx, "e_pad": e_pad, "correction": correction,
                "edges": edges, "tmask": up(tmask), "r2": r2,
                "extra3": extra3}

    def _ring_assemble(self, parent_header, parent_table, src_id_col,
                       tgt_header, tgt_table, tgt_id_col, pairs,
                       rel_list_type):
        """(source, target) multiplicity rows -> the join path's exact
        output schema: parent columns + null rel-list (+ path-length)
        + target columns."""
        joined = parent_table.join(pairs, "inner",
                                   [(src_id_col, "__ring_src")])
        tt = tgt_table.rename({c: f"__t_{c}" for c in tgt_table.columns})
        joined = joined.join(tt, "inner",
                             [("__ring_tgt", f"__t_{tgt_id_col}")])
        joined = joined.rename({f"__t_{c}": c for c in tgt_table.columns})
        joined = joined.with_literal_column(self.rel, None, rel_list_type)
        out_header = parent_header.with_expr(E.Var(self.rel), rel_list_type,
                                             column=self.rel)
        if self.emit_len:
            out_header = out_header.with_expr(E.Var(self.emit_len),
                                              CTInteger,
                                              column=self.emit_len)
        out_header = out_header.concat(tgt_header)
        return out_header, joined.select(list(out_header.columns))

    # -- join path (the general form) --------------------------------------

    def _join_compute(self):
        parent_header, parent_table = self.children[0].result
        params = self.context.parameters
        rel_list_type: CypherType = CTList(CTRelationship(self.rel_types))

        src_id_col = parent_header.column(E.Var(self.source))
        if self.into:
            tgt_header = None
            tgt_id_col = parent_header.column(E.Var(self.target))
            final_cols = list(parent_table.columns) + [self.rel]
        else:
            tgt_header, tgt_table = self.graph.scan_node(
                self.target, self.target_labels)
            tgt_id_col = tgt_header.column(E.Var(self.target))
            final_cols = list(parent_table.columns) + [self.rel] \
                + list(tgt_header.columns)

        if self.emit_len:
            final_cols = final_cols + [self.emit_len]

        cur = "__vle_cur"
        frontier = parent_table.copy_column(src_id_col, cur)
        hop_id_cols: List[str] = []
        branches: List[Table] = []

        def finish_branch(t: Table, hops: List[str]) -> Table:
            """Pack hop ids into the rel list column, join/filter target,
            project to the uniform final column set."""
            t = t.pack_list(hops, self.rel, rel_list_type)
            if self.emit_len:
                t = t.with_literal_column(self.emit_len, len(hops),
                                          CTInteger)
            if self.into:
                sh = synth_header(t)
                t = t.filter(E.Equals(E.Var(cur), E.Var(tgt_id_col)), sh,
                             params)
                return t.select(final_cols)
            tt = tgt_table.rename({c: f"__t_{c}" for c in tgt_table.columns})
            joined = t.join(tt, "inner", [(cur, f"__t_{tgt_id_col}")])
            joined = joined.rename(
                {f"__t_{c}": c for c in tgt_table.columns})
            return joined.select(final_cols)

        if self.lower == 0:
            branches.append(finish_branch(frontier, []))

        for k in range(1, self.upper + 1):
            hop_t, hid, hnear, hfar = self._rel_hop_table(k)
            joined = frontier.join(hop_t, "inner", [(cur, hnear)])
            # edge-isomorphism: this hop's rel must differ from all previous
            sh = synth_header(joined)
            for prev in hop_id_cols:
                joined = joined.filter(
                    E.Not(E.Equals(E.Var(hid), E.Var(prev))), sh, params)
            # advance the frontier cursor to the far end of this hop
            joined = joined.select(
                [c for c in joined.columns if c not in (cur, hnear)])
            joined = joined.copy_column(hfar, cur)
            joined = joined.select(
                [c for c in joined.columns if c != hfar])
            frontier = joined
            hop_id_cols = hop_id_cols + [hid]
            if k >= self.lower:
                branches.append(finish_branch(frontier, hop_id_cols))

        if not branches:
            raise ValueError("variable-length expand produced no branches")
        out = branches[0]
        for b in branches[1:]:
            out = out.union_all(b)

        out_header = parent_header.with_expr(E.Var(self.rel), rel_list_type,
                                             column=self.rel)
        if self.emit_len:
            out_header = out_header.with_expr(E.Var(self.emit_len),
                                              CTInteger,
                                              column=self.emit_len)
        if not self.into and tgt_header is not None:
            out_header = out_header.concat(tgt_header)
        return out_header, out.select(list(out_header.columns))

    def _pretty_args(self):
        return (f"({self.source})-[{self.rel}:{'|'.join(self.rel_types)}"
                f"*{self.lower}..{self.upper}]-({self.target})")
