"""DeviceTable: the Table SPI over bucketed device columns.

The counterpart of ``caps_tpu/backends/tpu/table.py`` (itself the
analog of the reference's ``SparkTable.DataFrameTable``, SURVEY.md §2):
filter = mask + compact, join = CSR probe (or sort + search) + segmented
expansion, aggregate = dense histogram or sort + segment reductions,
orderBy = multi-key lexicographic sort — all over capacities padded to
size buckets.

Three hand-written kernels carry the hot path (``caps_tpu_torch/ops``):
the expand-positions kernel materializes every join, the dense
segment-aggregation kernel runs group-bys over dictionary-coded keys,
and the bitonic kernel sorts capacities of 256 … 16384 rows.  Each
kernel family passes its self-test (``ops/probe.py ensure_kernels``)
before its first use in a process.  There is no host fallback: an
operator or expression without a device path raises
:class:`UnsupportedOnDevice` naming it.

Every data-dependent size goes through ``DeviceBackend.consume_*``, so
the fused executor (``fused.py``) can record a query's sizes once and
replay them with no device→host reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from caps_tpu_torch import ops as OPS
from caps_tpu_torch.backends.cuda import kernels as K
from caps_tpu_torch.backends.cuda.column import (
    Column, column_to_host, elem_at, kind_for, list_dtype, list_elem_kind,
    literal_column, make_column, null_like, pad_width,
)
from caps_tpu_torch.backends.cuda.expr import (
    DeviceExprCompiler, UnsupportedOnDevice,
)
from caps_tpu_torch.backends.cuda import anyvalue as A
from caps_tpu_torch.backends.cuda import maps as M
from caps_tpu_torch.backends.cuda.pool import make_pool
from caps_tpu_torch.relational.table import ExprEvalError
from caps_tpu_torch.ir.exprs import Expr
from caps_tpu_torch.obs import active_tracer
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.okapi.types import (
    CTFloat, CTInteger, CTNull, CTVoid, CypherType,
)
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.shapes import ShapeBucketLattice
from caps_tpu_torch.relational.table import AggSpec, Table, TableFactory

# The dense group-by's slot limit (the JAX backend's literal in
# caps_tpu/backends/tpu/table.py _group_dense), so both route the same
# group-bys to the histogram kernel; the kernel itself takes any count.
DENSE_GROUP_MAX_SEGMENTS = 4096


class DeviceBackend:
    """Shared per-session state: the device, the string pool, the config,
    the padding ladder, the count of device→host size reads and the
    record/replay routing of the fused executor."""

    def __init__(self, config: EngineConfig, device: torch.device):
        self.pool = make_pool()
        self.config = config
        self.device = device
        # Row-capacity bucket lattice (relational/shapes.py): defaults to
        # config.bucket_sizes — the same rounding as config.bucket_for.
        # The session swaps in its own lattice.
        self.shapes = ShapeBucketLattice(config.bucket_sizes)
        self.syncs = 0  # device->host scalar reads (perf metric)
        # device->host reads of the distinct values a string-making
        # function formats (expr.py _held / _format_held): one each,
        # outside the size stream, so a replay makes them too
        self.held_reads = 0
        # Size-sync routing for the fused executor (fused.py):
        # None = eager (device->host read per data-dependent size);
        # ("record", entries)               = eager + record every size;
        # ("replay", entries, [i])          = serve sizes, NO reads;
        # ("replay_gen", entries, [i])      = serve merged sizes, check
        #                                     each on the device.
        self.count_mode: Optional[tuple] = None
        # device bool scalar accumulated by generic-replay relation
        # checks; the fused executor reads it once per query and
        # re-records on violation
        self._replay_viol: Optional[torch.Tensor] = None
        # (host rank array, its device copy): see rank_tensor()
        self._rank_dev: Optional[Tuple[Any, torch.Tensor]] = None
        # Count-pushdown caches (relational/count_pattern.py): per-graph
        # static structures (sorted edges and ids, segment boundaries)
        # and per-(graph, plan shape, parameter shapes) closures.
        self.fused_count_static: Dict[int, dict] = {}
        self.fused_count_fns: Dict[tuple, Any] = {}
        # count closures built (a cache miss; each also charges the
        # session's compile ledger, obs/compile.py)
        self.count_builds = 0
        # Graph-algorithm fixpoint programs (caps_tpu_torch/algo/): per
        # (procedure, node capacity, edge capacity | "dense") closures; a
        # miss builds and first-runs one and charges the compile
        # ledger's ``algo`` kind.
        self.algo_fns: Dict[tuple, Any] = {}
        # padded tombstone id arrays on the device (drop_in), keyed by
        # the id set's identity; the set is kept in the entry so its id
        # cannot be reused while the entry lives
        self._tombstones: Dict[int, Tuple[Any, torch.Tensor]] = {}
        # debug_obj_guard bookkeeping: __obj__ entries served under
        # generic replay with no non-stat relation check after them yet
        # (see consume_obj's invariant)
        self._obj_unguarded = 0
        # Distributed-join accounting (SURVEY.md §5.5/§5.8), under the
        # JAX package's names: bytes that cross between shards in the
        # hand-scheduled exchanges (the padded buffers, each counted once
        # per shard it reaches — on a virtual mesh a copy within one
        # card's memory), the live-row payload of those buffers measured
        # on the device, and how often each strategy ran.
        self.ici_bytes = 0
        self.ici_payload_bytes = 0
        self.dist_joins = 0       # radix exchange joins executed
        self.broadcast_joins = 0  # broadcast joins executed
        self.salted_joins = 0     # radix joins that salted hot keys
        # last cost-model distribution decision (relational/cost.py
        # choose_dist_strategy)
        self.last_dist_decision: Optional[Dict] = None
        self.mesh = None
        if config.mesh_shape:
            import math
            from caps_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
            # degenerate leading axes collapse to a 1-D mesh, so (1, 8)
            # keeps the ring schedules that (8,) gets
            if math.prod(config.mesh_shape[:-1] or (1,)) > 1:
                self.mesh = make_mesh_2d(
                    (math.prod(config.mesh_shape[:-1]),
                     config.mesh_shape[-1]), device=device)
            else:
                self.mesh = make_mesh(math.prod(config.mesh_shape),
                                      device=device)

    @property
    def n_shards(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def bucket(self, n: int) -> int:
        return max(1, self.shapes.bucket(n))

    def place_column(self, col: Column) -> Column:
        """The placement seam every ingested column passes.  Nothing
        moves, also on a mesh: a column keeps its rows whole on the lead
        device (there is no partitioner to keep 1/n of a table per card);
        the hand-scheduled paths pad to a shard multiple and split rows
        where they run (``parallel/collectives.shard_blocks``).  Fault
        injection (testing/faults.py ``abort_write``,
        ``flaky_compaction``, ``flaky_ingest``, ``corrupt_shard``) wraps
        it."""
        return col

    def tombstone_tensor(self, values, dtype: torch.dtype) -> torch.Tensor:
        """A snapshot's tombstone ids on the device, sorted and padded
        to a size bucket by repeating the largest (duplicates change
        nothing and keep the array sorted, so no sentinel id is
        reserved).  Copied to the card once per id set: a copy from
        host memory on every replay would synchronize the stream."""
        hit = self._tombstones.get(id(values))
        if hit is not None and hit[0] is values \
                and hit[1].dtype == dtype:
            return hit[1]
        vals = sorted(int(v) for v in values)
        padded = np.full(self.bucket(len(vals)), vals[-1], dtype=np.int64)
        padded[:len(vals)] = vals
        dev = torch.from_numpy(padded).to(self.device, dtype)
        while len(self._tombstones) >= 16:
            self._tombstones.pop(next(iter(self._tombstones)))
        self._tombstones[id(values)] = (values, dev)
        return dev

    def rank_tensor(self) -> torch.Tensor:
        """The string pool's rank array on the device, copied once per
        pool version: a host→device copy from pageable memory on every
        query would synchronize the stream."""
        arr = self.pool.rank_array()
        if self._rank_dev is None or self._rank_dev[0] is not arr:
            self._rank_dev = (arr, torch.from_numpy(arr).to(self.device))
        return self._rank_dev[1]

    def consume_count(self, dev_scalar: torch.Tensor,
                      relation: str = "exact") -> int:
        """Materialize a data-dependent size (see ``count_mode``).

        ``relation`` declares how the caller uses the value, so a
        param-GENERIC replay (fused.py) can serve sizes recorded for
        *different* parameter values and still stay exact:

        * ``"cap"``   — an upper bound (capacity/bucket/width choice);
          serving any value ≥ the actual one is correct.
        * ``"lo"``    — a lower bound (e.g. a domain minimum); serving
          any value ≤ the actual one is correct.
        * ``"exact"`` — semantics depend on the exact value (error
          counts, branch predicates); a generic replay must re-execute
          when the actual value differs.
        * ``"stat"``  — metrics only; any served value is acceptable.

        Under generic replay the relation is CHECKED on the device (no
        read): a violation raises the end-of-query re-record, so a wrong
        served value never reaches results."""
        mode = self.count_mode
        if mode is None:
            self.syncs += 1
            return int(dev_scalar)
        if mode[0] == "record":
            self.syncs += 1
            v = int(dev_scalar)
            mode[1].append(("size", v, relation))
            return v
        v = self._next_entry(mode, "size")
        if mode[0] == "replay_gen":
            if v[2] != relation:
                raise FusedReplayMismatch(
                    f"generic replay relation mismatch: recorded {v[2]}, "
                    f"consumed as {relation}")
            self._accumulate_violation(dev_scalar, v[1], relation)
        return v[1]

    def consume_fixpoint(self, run) -> Tuple[int, bool]:
        """An iterative fixpoint's iteration count and convergence flag
        through the size stream (``algo/fixpoint.py``).  ``run(steps,
        reads)`` runs the loop and returns its (iterations, done)
        device scalars: with ``steps`` None the loop reads its ``done``
        flag every few steps and counts the reads in ``reads``; with an
        int it runs that many steps and reads nothing.  Eager and
        record runs read both results in one transfer; replays run the
        recorded number of steps and serve the recorded values, and a
        generic replay checks on the device that the loop took
        exactly that many (a loop stopped while still active counts one
        more step, ``algo/fixpoint.py _loop``)."""
        mode = self.count_mode
        if mode is None or mode[0] == "record":
            reads = [0]
            it, done = run(None, reads)
            iters, conv = torch.stack([it, done.to(torch.int64)]).tolist()
            self.syncs += reads[0] + 1
            if mode is not None:
                mode[1].append(("size", iters, "exact"))
                mode[1].append(("size", conv, "exact"))
            return iters, bool(conv)
        v_it = self._next_entry(mode, "size")
        v_done = self._next_entry(mode, "size")
        if v_it[2] != "exact" or v_done[2] != "exact":
            raise FusedReplayMismatch(
                "replay op sequence diverged: a fixpoint consumed "
                f"{v_it[2]}/{v_done[2]} sizes")
        it, done = run(v_it[1], None)
        if mode[0] == "replay_gen":
            self._accumulate_violation(it, v_it[1], "exact")
            self._accumulate_violation(done, v_done[1], "exact")
        return v_it[1], bool(v_done[1])

    @staticmethod
    def _next_entry(mode, tag: str):
        """Pop the next record/replay stream entry, validating its tag —
        any misalignment means the op sequence diverged from the
        recording."""
        entries, cursor = mode[1], mode[2]
        if cursor[0] >= len(entries):
            raise FusedReplayMismatch(
                f"replay consumed {cursor[0]} entries but the recording "
                f"only has {len(entries)}")
        v = entries[cursor[0]]
        cursor[0] += 1
        if not (isinstance(v, tuple) and v and v[0] == tag):
            raise FusedReplayMismatch(
                f"replay op sequence diverged: {tag} consumed where "
                f"{v[0] if isinstance(v, tuple) else type(v)} was recorded")
        return v

    def consume_rows(self, dev_scalar: torch.Tensor
                     ) -> Tuple[int, Optional[torch.Tensor]]:
        """Like :meth:`consume_count` for a table's LIVE ROW COUNT:
        returns ``(n, live)`` where ``n`` is the host row count and
        ``live`` is None in eager/record/exact-replay mode.  Under
        generic replay ``n`` is a served upper bound and ``live`` is the
        exact count as a device scalar — the caller attaches it to the
        produced table (``DeviceTable(..., live=live)``) so ``row_ok``
        stays exact without a read."""
        mode = self.count_mode
        if mode is None:
            self.syncs += 1
            return int(dev_scalar), None
        if mode[0] == "record":
            self.syncs += 1
            v = int(dev_scalar)
            mode[1].append(("rows", v))
            return v, None
        v = self._next_entry(mode, "rows")
        if mode[0] == "replay_gen":
            # strict: the actual count must fit the SERVED count, not
            # just its bucket; headroom comes from the merge widening a
            # violated row cap to its bucket boundary
            # (fused._merge_streams)
            self._accumulate_violation(dev_scalar, v[1], "cap")
            return v[1], dev_scalar.to(torch.int32)
        return v[1], None

    def consume_pred(self, host_value: bool, dev_thunk) -> bool:
        """A host BRANCH PREDICATE routed through the record/replay
        stream.  Never reads the device: the host value is exact in
        eager/record mode, replay serves the recorded branch, and generic
        replay additionally checks ``dev_thunk()`` (a device bool of the
        actual predicate) against it — a divergent branch trips the
        end-of-query violation and re-records."""
        mode = self.count_mode
        if mode is None:
            return host_value
        if mode[0] == "record":
            mode[1].append(("size", int(host_value), "exact"))
            return host_value
        v = self._next_entry(mode, "size")
        if v[2] != "exact":
            raise FusedReplayMismatch(
                f"replay op sequence diverged: branch predicate consumed "
                f"where a {v[2]} size was recorded")
        if mode[0] == "replay_gen":
            self._accumulate_violation(dev_thunk(), v[1], "exact")
        return bool(v[1])

    def _accumulate_violation(self, dev_scalar: torch.Tensor, served: int,
                              relation: str) -> None:
        """Device-side relation check for generic replay: ORs into
        ``_replay_viol``, read ONCE at the end of the query."""
        if relation == "stat":
            return
        actual = dev_scalar.to(torch.int64)
        if relation == "cap":
            bad = actual > served
        elif relation == "lo":
            bad = actual < served
        else:  # exact
            bad = actual != served
        self._replay_viol = (bad if self._replay_viol is None
                             else self._replay_viol | bad)
        # any non-stat relation check downstream of a served __obj__
        # counts as its guard (see consume_obj's invariant)
        self._obj_unguarded = 0

    def consume_obj(self, make):
        """Materialize a small data-dependent HOST value (the hot-key
        sample of the radix dist join) through the same record/replay
        stream as sizes: eager and record runs call ``make()`` (counting
        its read), replays serve the recorded value with no device read.

        INVARIANT: an ``__obj__`` entry has no device-side relation check
        of its own — under GENERIC replay the served object may be stale
        for the current parameter values.  Every consumer must therefore
        be guarded by a later relation-checked consume (``consume_count``
        / ``consume_rows`` / ``consume_pred`` with a relation other than
        ``"stat"``) that trips the end-of-query violation flag whenever
        the stale object could shape results — the radix join consumes
        its sample and then checks ``dropped == 0`` with relation
        ``"exact"``.  With ``config.debug_obj_guard`` an obj served under
        generic replay with no later non-stat check raises at the end of
        the query (fused.py)."""
        mode = self.count_mode
        if mode is None:
            self.syncs += 1
            return make()
        if mode[0] == "record":
            self.syncs += 1
            v = make()
            mode[1].append(("__obj__", v))
            return v
        v = self._next_entry(mode, "__obj__")[1]
        if mode[0] == "replay_gen" and self.config.debug_obj_guard:
            self._obj_unguarded += 1
        return v


class FusedReplayMismatch(RuntimeError):
    """The op sequence during fused replay diverged from the recording."""


class DeviceTable(Table):
    def __init__(self, backend: DeviceBackend,
                 columns: Optional[Dict[str, Column]] = None, n: int = 0,
                 live: Optional[torch.Tensor] = None):
        self.backend = backend
        self._cols: Dict[str, Column] = dict(columns or {})
        self._n = n
        # Generic-replay mode (fused.py): ``n`` is a SERVED upper bound
        # and ``live`` is the exact live-row count as a device scalar —
        # live rows always form a prefix (every producer compacts or
        # expands live-first), so row_ok stays exact with no read.  None
        # in eager/record mode, where ``n`` is exact.
        self._live = live
        self._exact_cache: Optional[int] = None  # memoized int(_live)

    @property
    def capacity(self) -> int:
        if self._cols:
            return next(iter(self._cols.values())).capacity
        return self.backend.bucket(self._n)

    @property
    def row_ok(self) -> torch.Tensor:
        return K.row_mask(self.capacity, self._n, self.backend.device,
                          self._live)

    def _with_cols(self, columns: Dict[str, Column]) -> "DeviceTable":
        """Row-preserving rebuild: same n and live count."""
        return DeviceTable(self.backend, columns, self._n, live=self._live)

    def _exact_n(self) -> int:
        """The exact live row count as a host int.  Free in eager mode;
        under generic replay a read (counted), used only at
        materialization."""
        if self._live is None:
            return self._n
        if self._exact_cache is None:
            self.backend.syncs += 1
            self._exact_cache = int(self._live)
        return self._exact_cache

    def exact_size(self) -> int:
        return self._exact_n()

    def size_hint(self) -> int:
        if self._exact_cache is not None:
            return self._exact_cache
        return self._n

    def branch_empty(self) -> bool:
        mode = self.backend.count_mode
        if self._live is not None and (mode is None or mode[0] == "record"):
            # a table that escaped its fused run (a generic-replay result
            # reused as a plain input) only knows a served UPPER bound in
            # _n; the branch needs the exact count, so pay the read.  In
            # record mode too: consume_pred would bake the stale bound
            # into the recording as an "exact" branch.
            host_empty = self._exact_n() == 0
        else:
            host_empty = self._n == 0

        def actual_empty() -> torch.Tensor:
            if self._live is not None:
                return self._live == 0
            return torch.full((), self._n == 0, dtype=torch.bool,
                              device=self.backend.device)

        return self.backend.consume_pred(host_empty, actual_empty)

    def prime_exact(self, viol: torch.Tensor) -> bool:
        """Read the generic-replay violation flag together with this
        table's exact live count in ONE device→host transfer; primes the
        exact-count cache when the flag is clear (so a later ``to_maps``
        pays no second read).  Returns the flag's truth value."""
        if self._live is None or self._exact_cache is not None:
            return bool(viol)
        both = torch.stack([viol.to(torch.int64),
                            self._live.to(torch.int64)]).cpu()
        bad = bool(both[0])
        if not bad:
            self._exact_cache = int(both[1])
        return bad

    # -- shape ----------------------------------------------------------

    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(self._cols.keys())

    @property
    def size(self) -> int:
        return self._n

    def column_type(self, col: str) -> CypherType:
        return self._cols[col].ctype

    @property
    def nbytes(self) -> int:
        """Exact device-buffer bytes of the columns (data + validity +
        list lengths), padding included."""
        def size(col: Column) -> int:
            n = col.data.nbytes + col.valid.nbytes
            for t in (col.lens, col.elem_valid, col.tags):
                if t is not None:
                    n += t.nbytes
            kids = list((col.fields or {}).values())
            kids += [c for c in (col.child, col.maps) if c is not None]
            return n + sum(size(c) for c in kids)
        return sum(size(col) for col in self._cols.values())

    # -- column ops ------------------------------------------------------

    def select(self, cols: Sequence[str]) -> "DeviceTable":
        missing = [c for c in cols if c not in self._cols]
        if missing:
            raise KeyError(f"missing columns {missing}; have {self.columns}")
        return self._with_cols({c: self._cols[c] for c in cols})

    def rename(self, mapping: Mapping[str, str]) -> "DeviceTable":
        out = {mapping.get(c, c): col for c, col in self._cols.items()}
        if len(out) != len(self._cols):
            raise ValueError(f"rename collision: {mapping}")
        return self._with_cols(out)

    def copy_column(self, src: str, dst: str) -> "DeviceTable":
        out = dict(self._cols)
        out[dst] = self._cols[src]
        return self._with_cols(out)

    def with_literal_column(self, name, value, ctype) -> "DeviceTable":
        try:
            col = self.backend.place_column(
                literal_column(value, ctype, self.capacity,
                               self.backend.pool, self.backend.device))
        except ValueError as ex:
            raise UnsupportedOnDevice(f"with_literal_column: {ex}")
        out = dict(self._cols)
        out[name] = col
        return self._with_cols(out)

    def with_row_index(self, name: str) -> "DeviceTable":
        dev = self.backend.device
        col = self.backend.place_column(
            Column("int", torch.arange(self.capacity, dtype=torch.int64,
                                       device=dev),
                   torch.ones(self.capacity, dtype=torch.bool, device=dev),
                   CTInteger))
        out = dict(self._cols)
        out[name] = col
        return self._with_cols(out)

    def _compiler(self, header: RecordHeader, parameters
                  ) -> DeviceExprCompiler:
        return DeviceExprCompiler(self._cols, self.capacity, header,
                                  parameters, self.backend.pool, self.row_ok,
                                  backend=self.backend)

    def with_column(self, name, expr: Expr, header: RecordHeader,
                    parameters, ctype) -> "DeviceTable":
        compiler = self._compiler(header, parameters)
        col = _named(compiler.compile, "with_column", expr)
        self._raise_row_errors(compiler)
        out = dict(self._cols)
        out[name] = col
        return self._with_cols(out)

    def _raise_row_errors(self, compiler: DeviceExprCompiler) -> None:
        """Per-row runtime errors (e.g. division by zero): one host sync,
        only when the compiled expression contains an error site."""
        if compiler.error_mask is None:
            return
        if self.backend.consume_count(compiler.error_mask.sum()):
            raise ExprEvalError(compiler.error_what)

    # -- row ops ---------------------------------------------------------

    def filter(self, expr: Expr, header: RecordHeader,
               parameters) -> "DeviceTable":
        compiler = self._compiler(header, parameters)
        # a value that is not a boolean is not true: the oracle keeps a
        # row where its predicate is True
        pred = compiler.as_bool(_named(compiler.compile, "filter", expr))
        self._raise_row_errors(compiler)
        mask = pred.data & pred.valid & self.row_ok
        return self._compact(mask)

    def drop_in(self, col: str, values) -> "DeviceTable":
        """Tombstone mask (relational/updates.py snapshot overlay): drop
        rows whose ``col`` is in ``values``, on the card, then the same
        compaction as a filter, whose row count goes through the size
        stream.  Null cells never match.  Membership is a binary search
        in the sorted, padded id array (``DeviceBackend.tombstone_tensor``):
        it computes ``torch.isin``, whose sorting path (more than a
        hundred ids against millions of rows) synchronizes the stream,
        and a replay must not."""
        if not values:
            return self
        c = self._cols[col]
        ids = self.backend.tombstone_tensor(values, c.data.dtype)
        pos = torch.searchsorted(ids, c.data).clamp_(max=ids.shape[0] - 1)
        hit = (ids[pos] == c.data) & c.valid
        return self._compact(self.row_ok & ~hit)

    # -- point lookups for the write path (relational/updates.py) ---------

    def _id_index(self, col: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sorted int64 keys, row permutation) of an integer column's
        live non-null values, dead and null rows keyed past every value;
        memoized on the column for this row count (an immutable base is
        sorted once)."""
        c = self._cols[col]
        cached = getattr(c, "_id_index", None)
        if cached is not None and cached[0] == self._n \
                and self._live is None:
            return cached[1]
        top = torch.iinfo(torch.int64).max
        keys = torch.where(c.valid & self.row_ok, c.data.to(torch.int64),
                           torch.full((), top, dtype=torch.int64,
                                      device=self.backend.device))
        res = torch.sort(keys, stable=True)
        if self._live is None:
            c._id_index = (self._n, (res.values, res.indices))
        return res.values, res.indices

    def rows_where(self, col: str, value: int) -> "DeviceTable":
        """The live rows whose integer ``col`` equals ``value``, found by
        binary search in the column's sorted index: one read."""
        keys, perm = self._id_index(col)
        q = torch.full((2,), int(value), dtype=torch.int64,
                       device=self.backend.device)
        ends = torch.stack([torch.searchsorted(keys, q[:1]),
                            torch.searchsorted(keys, q[1:], right=True)])
        self.backend.syncs += 1
        lo, hi = ends.flatten().tolist()
        return DeviceTable(self.backend,
                           _gather_cols(self._cols, perm[lo:hi]), hi - lo)

    def max_int(self, col: str) -> Optional[int]:
        """The largest live non-null value of an integer column (None
        when there is none): one read."""
        keys, _perm = self._id_index(col)
        top = torch.iinfo(torch.int64).max
        n = torch.searchsorted(keys, torch.full(
            (1,), top, dtype=torch.int64, device=self.backend.device))
        both = torch.cat([n, keys[(n - 1).clamp(min=0)]])
        self.backend.syncs += 1
        count, hi = both.tolist()
        return hi if count else None

    def place(self) -> "DeviceTable":
        """This table with every column passed through the backend's
        placement seam (``DeviceBackend.place_column``), as an ingested
        table's are: compaction's folded base is a new placement."""
        return self._with_cols({c: self.backend.place_column(col)
                                for c, col in self._cols.items()})

    def _compact(self, mask: torch.Tensor) -> "DeviceTable":
        new_n, live = self.backend.consume_rows(K.mask_count(mask))
        idx = K.compact_indices(mask, self.backend.bucket(new_n))
        return DeviceTable(self.backend, _gather_cols(self._cols, idx), new_n,
                           live=live)

    def join(self, other: Table, how: str,
             pairs: Sequence[Tuple[str, str]]) -> "DeviceTable":
        assert isinstance(other, DeviceTable)
        shared = set(self.columns) & set(other.columns)
        if shared:
            raise ValueError(f"join column collision: {shared}")
        if how == "cross":
            return self._cross_join(other)
        if how not in ("inner", "left"):
            raise UnsupportedOnDevice(f"join: {how} join")
        return self._sort_merge_join(other, how, pairs)

    def _join_key(self, col: Column, side: str = "l") -> torch.Tensor:
        if col.kind in ("id", "int", "str", "bool", "date", "datetime"):
            return col.data.to(torch.int64)
        if col.kind == "float":
            # Monotone float64 -> int64 bit transform: order-preserving, so
            # the sort/search machinery works unchanged.  -0.0 is folded
            # into +0.0 first (they must join), and NaN maps to a per-side
            # sentinel so NaN never matches anything (incl. other NaNs).
            x = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                            col.data).contiguous()
            bits = x.view(torch.int64)
            key = torch.where(bits < 0, -(2 ** 63) - bits, bits)
            nan_sent = K._L_NAN if side == "l" else K._R_NAN
            return torch.where(torch.isnan(col.data),
                               torch.full_like(key, nan_sent), key)
        raise UnsupportedOnDevice(f"join: key of kind {col.kind}")

    def _cached_right_sort(self, other: "DeviceTable", rcol: Column):
        """Sort of the build side, memoized on the column object: static
        scan tables (a node table every hop probes) are sorted once per
        graph, not once per hop.  The memo keys on the table's row
        count, so it is used only where that count is exact: under
        generic replay ``_n`` of a derived table is a served bound."""
        key = (other._n,)
        memo = other._live is None
        cached = getattr(rcol, "_join_sort", None) if memo else None
        if cached is not None and cached[0] == key:
            return cached[1]
        r_ok = rcol.valid & other.row_ok
        rk = torch.where(r_ok, self._join_key(rcol, side="r"),
                         torch.full_like(rcol.data, K._R_NULL,
                                         dtype=torch.int64))
        perm = other._sort_perm([rk])
        res = (rk[perm], perm)
        if memo:
            rcol._join_sort = (key, res)
        return res

    def _csr_for(self, other: "DeviceTable", rcol: Column):
        """The device-resident CSR for a build-side column, if the ingest
        hook (DeviceTableFactory.prepare_rel_table) attached one and the
        table still has the exact shape it was built for."""
        if not self.backend.config.use_csr:
            return None
        cached = getattr(rcol, "_csr", None)
        if (cached is not None and other._live is None
                and cached[0] == (other._n,)):
            return cached[1]
        return None

    def _masked_left_key(self, lcol: Column) -> torch.Tensor:
        """Probe key with null values folded to the never-matching
        sentinel; liveness (row_ok) stays separate from key validity."""
        key = self._join_key(lcol)
        return torch.where(lcol.valid, key, torch.full_like(key, K._L_NULL))

    def _sort_merge_join(self, other: "DeviceTable", how: str,
                         pairs: Sequence[Tuple[str, str]]) -> "DeviceTable":
        lc, rc = pairs[0]
        lcol, rcol = self._cols[lc], other._cols[rc]
        l_ok = self.row_ok
        left_join = how == "left"
        csr = self._csr_for(other, rcol)
        if csr is None:
            # No resident adjacency to probe: on a mesh, schedule the
            # exchange by hand (radix exchange / broadcast join,
            # parallel/dist_join.py)
            dist = self._dist_join(other, how, pairs)
            if dist is not None:
                return dist
        if csr is not None:
            # CSR probe: two indptr gathers per row, no sort, no search
            counts, lo = csr.probe(self._masked_left_key(lcol), l_ok)
            perm = csr.perm
        else:
            rk_sorted, perm = self._cached_right_sort(other, rcol)
            counts, lo = K.probe_count(self._masked_left_key(lcol), l_ok,
                                       rk_sorted)
        total, live = self.backend.consume_rows(
            K.join_total(counts, l_ok, left_join))
        out_cap = self.backend.bucket(total)
        OPS.ensure_kernels("prefetch", self.backend.device)
        l_idx, r_idx, out_valid, r_matched = OPS.join_expand_via_positions(
            counts, lo, perm, l_ok, out_cap, left_join)
        out_cols = _gather_cols(self._cols, l_idx)
        right = _gather_cols(other._cols, r_idx)
        for c, col in right.items():
            out_cols[c] = dataclasses.replace(col,
                                              valid=col.valid & r_matched)
        out = DeviceTable(self.backend, out_cols, total, live=live)
        return out._extra_pair_filter(pairs, left_join)

    def _detect_hot_keys(self, l_key, l_ok, n: int, keep_top: int = 0):
        """Host-side probe-key sample → (sorted hot-key array, auto salt).
        A key is hot when its sampled frequency exceeds
        ``join_hot_factor`` × the per-shard fair share; the suggested
        salt spreads the hottest key back under the fair share (SURVEY.md
        §5.8).  ``keep_top``: when no key crosses the threshold, still
        return the ``keep_top`` most frequent sampled keys (a manual salt
        must engage on the heaviest keys)."""
        cfg = self.backend.config
        H = cfg.join_hot_capacity
        S = min(4096, int(l_key.shape[0]))
        # one read through the record/replay stream: a fused replay
        # serves the recorded sample with no read
        sample, ok = self.backend.consume_obj(
            lambda: (l_key[:S].cpu().numpy(), l_ok[:S].cpu().numpy()))
        live = sample[ok]
        if live.shape[0] == 0:
            return np.zeros((0,), np.int64), 1
        vals, counts = np.unique(live, return_counts=True)
        fair = max(1.0, live.shape[0] / n)
        hot_mask = counts > cfg.join_hot_factor * fair
        hot_vals = vals[hot_mask]
        if hot_vals.shape[0] > H:  # keep the heaviest H
            order = np.argsort(counts[hot_mask])[::-1][:H]
            hot_vals = hot_vals[order]
        salt = 1
        if hot_vals.shape[0]:
            need = int(np.ceil(counts.max() / fair))
            salt = 2
            while salt < min(n, need):
                salt *= 2
            salt = min(salt, n)
        elif keep_top:
            hot_vals = vals[np.argsort(counts)[::-1][:keep_top]]
        return np.sort(hot_vals.astype(np.int64)), salt

    def _dist_join(self, other: "DeviceTable", how: str,
                   pairs: Sequence[Tuple[str, str]]
                   ) -> Optional["DeviceTable"]:
        """Hand-scheduled distributed join over the mesh
        (parallel/dist_join.py): broadcast join for small build sides,
        radix exchange with SURGICAL hot-key salting (only detected-hot
        keys replicate) otherwise.  Both sides pad to a shard multiple;
        every per-row tensor of a column (list matrices included) rides
        the exchange.  Returns None when the config or join kind rules
        it out — a planned strategy: the caller then runs its
        single-program join."""
        be = self.backend
        cfg = be.config
        if (be.mesh is None or not cfg.use_dist_join
                or how not in ("inner", "left")):
            return None
        n = be.n_shards
        if n <= 1:
            return None
        from caps_tpu_torch.parallel import dist_join as DJ
        from caps_tpu_torch.relational.cost import choose_dist_strategy
        lc, rc = pairs[0]
        lcol, rcol = self._cols[lc], other._cols[rc]
        # null keys fold to the sentinel; liveness stays separate so
        # LEFT joins retain null-key rows
        l_key = self._masked_left_key(lcol)
        r_key = self._join_key(rcol, side="r")
        l_ok = self.row_ok
        r_ok = rcol.valid & other.row_ok
        left_join = how == "left"

        cap_l = -(-self.capacity // n) * n
        cap_r = -(-other.capacity // n) * n
        l_key, l_ok = _pad_rows(l_key, cap_l), _pad_rows(l_ok, cap_l)
        r_key, r_ok = _pad_rows(r_key, cap_r), _pad_rows(r_ok, cap_r)
        l_names, r_names = list(self._cols), list(other._cols)
        l_arrs = [_pad_rows(t, cap_l) for c in l_names
                  for t in _col_tensors(self._cols[c])]
        r_arrs = [_pad_rows(t, cap_r) for c in r_names
                  for t in _col_tensors(other._cols[c])]

        KEY_OK_BYTES = 9  # int64 key + bool validity channel

        def row_bytes(arrs) -> int:
            return KEY_OK_BYTES + sum(
                a.element_size() * int(np.prod(a.shape[1:], dtype=np.int64))
                for a in arrs)

        # the SAME model function the planner's EXPLAIN annotation
        # consults, pricing actual row counts
        strategy, decision = choose_dist_strategy(self._n, other._n, n, cfg)
        be.last_dist_decision = {"strategy": strategy, **decision}
        tr = active_tracer()
        if strategy == "broadcast":
            bp1 = DJ.broadcast_join_phase1(be.mesh, l_key, l_ok, r_key,
                                           r_ok, left_join)
            out_cap_dev = be.bucket(max(1, be.consume_count(
                bp1.max_total, relation="cap")))
            res = DJ.broadcast_join_phase2(be.mesh, bp1, l_key, l_ok, r_key,
                                           r_ok, l_arrs, r_arrs, out_cap_dev,
                                           left_join)
            # each shard receives the other (n-1) shards of the build
            # side; wire = padded buffers, payload = live rows measured
            # on the device
            wire = (KEY_OK_BYTES + row_bytes(r_arrs)) * cap_r * (n - 1)
            be.ici_bytes += wire
            payload = (KEY_OK_BYTES + row_bytes(r_arrs)) \
                * be.consume_count(bp1.live_r, relation="stat") * (n - 1)
            be.ici_payload_bytes += payload
            be.broadcast_joins += 1
            if tr.enabled:
                tr.event("dist_join.broadcast", kind="collective",
                         bytes=wire, payload_bytes=payload, shards=n)
        else:
            manual = cfg.join_salt > 1
            # a manual salt must engage even when detection finds no
            # outlier: salt the heaviest sampled key
            hot_np, auto_salt = self._detect_hot_keys(
                l_key, l_ok, n, keep_top=1 if manual else 0)
            salt = cfg.join_salt if manual else auto_salt
            # the salt must divide the shard count for distinct
            # sub-bucket targets (power-of-2 meshes: round down)
            salt = max(1, min(salt, n))
            while n % salt:
                salt -= 1
            H = max(1, cfg.join_hot_capacity)
            hot = np.full((H,), np.iinfo(np.int64).max, np.int64)
            hot[:hot_np.shape[0]] = hot_np[:H]
            hot_keys = torch.from_numpy(np.sort(hot)).to(be.device)

            local_cap = max(cap_l, cap_r) // n
            bin_cap = min(local_cap, max(8, -(-local_cap * 2 // n)))
            # hot sub-buckets carry only the replicated hot build rows
            hot_bin_cap = bin_cap if salt <= 1 else \
                min(local_cap, max(8, bin_cap // 2))
            wire_total = 0  # across bin-widening retries
            while True:
                p1 = DJ.radix_join_phase1(be.mesh, hot_keys, l_key, l_ok,
                                          r_key, r_ok, l_arrs, r_arrs,
                                          bin_cap, salt, hot_bin_cap)
                # of each shard's n bins, n-1 leave it (bin i stays on
                # shard i); hot sub-buckets are the smaller buffers
                wire = (row_bytes(l_arrs) * bin_cap
                        + row_bytes(r_arrs)
                        * (bin_cap + (salt - 1) * hot_bin_cap)) * n * (n - 1)
                be.ici_bytes += wire
                wire_total += wire
                if be.consume_count(p1.dropped, relation="exact") == 0:
                    break
                if bin_cap >= local_cap and hot_bin_cap >= local_cap:
                    raise RuntimeError(
                        "dist join: rows dropped at the safe bin bound")
                bin_cap = min(local_cap, bin_cap * 2)
                hot_bin_cap = min(local_cap, hot_bin_cap * 2)
            payload_bytes = (
                row_bytes(l_arrs) * be.consume_count(p1.sent_l,
                                                     relation="stat")
                + row_bytes(r_arrs) * be.consume_count(p1.sent_r,
                                                       relation="stat"))
            be.ici_payload_bytes += payload_bytes
            if tr.enabled:
                tr.event("dist_join.radix", kind="collective",
                         bytes=wire_total, payload_bytes=payload_bytes,
                         shards=n, salt=salt)
            total_dev = be.consume_count(
                p1.max_left if left_join else p1.max_total, relation="cap")
            out_cap_dev = be.bucket(max(1, total_dev))
            res = DJ.radix_join_phase2(be.mesh, p1, out_cap_dev, left_join)
            be.dist_joins += 1
            if salt > 1:
                be.salted_joins += 1

        l_valid, r_valid, l_out, r_out = res
        out_cols: Dict[str, Column] = {}
        for names, cols, datas, side_valid in (
                (l_names, self._cols, l_out, l_valid),
                (r_names, other._cols, r_out, r_valid)):
            it = iter(datas)
            for c in names:
                col = _col_from(cols[c], it)
                out_cols[c] = dataclasses.replace(
                    col, valid=col.valid & side_valid)
        tmp = DeviceTable(be, out_cols, int(l_valid.shape[0]))
        return tmp._compact(l_valid)._extra_pair_filter(pairs, left_join)

    def _extra_pair_filter(self, pairs: Sequence[Tuple[str, str]],
                           left_join: bool) -> "DeviceTable":
        """Extra equality pairs: post-filter (the first pair drove the
        merge)."""
        out = self
        for lc2, rc2 in pairs[1:]:
            a, b = out._cols[lc2], out._cols[rc2]
            if a.kind == "float" or b.kind == "float":
                # NaN == NaN is False here, matching join semantics
                eq = (a.data.to(torch.float64) == b.data.to(torch.float64))
            else:
                eq = a.data.to(torch.int64) == b.data.to(torch.int64)
            eq = eq & a.valid & b.valid
            if left_join:
                # unmatched left rows keep their single null-extended row
                keep = eq | ~out._cols[rc2].valid
            else:
                keep = eq
            out = out._compact(keep & out.row_ok)
        return out

    def _cross_join(self, other: "DeviceTable") -> "DeviceTable":
        """Every live left row paired with every live right row, left
        row major.  The output slots invert the cumulative pair counts
        as in ``explode``."""
        total = self._n * other._n
        out_cap = self.backend.bucket(total)
        dev = self.backend.device
        # per-live-left-row pair count: the exact device count when the
        # right side rides generic replay (other._n is then only a
        # served upper bound), the host int otherwise
        count_b = (other._live.to(torch.int64) if other._live is not None
                   else torch.tensor(other._n, dtype=torch.int64,
                                     device=dev))
        counts = torch.where(self.row_ok, count_b,
                             torch.zeros((), dtype=torch.int64, device=dev))
        offsets = torch.cumsum(counts, 0)
        t = torch.arange(out_cap, device=dev)
        l_idx = torch.searchsorted(offsets, t, right=True).clamp(
            0, max(0, self.capacity - 1))
        seg_start = torch.where(l_idx > 0, offsets[(l_idx - 1).clamp(min=0)],
                                torch.zeros_like(l_idx))
        within = (t - seg_start) % max(1, other.capacity)
        out_cols = _gather_cols(self._cols, l_idx)
        out_cols.update(_gather_cols(other._cols, within))
        live = (offsets[-1].to(torch.int32)
                if self._live is not None or other._live is not None
                else None)
        return DeviceTable(self.backend, out_cols, total, live=live)

    def union_all(self, other: Table) -> "DeviceTable":
        assert isinstance(other, DeviceTable)
        if set(self.columns) != set(other.columns):
            raise ValueError(f"union column mismatch: {self.columns} vs "
                             f"{other.columns}")
        total = self._n + other._n
        out_cap = self.backend.bucket(total)
        out: Dict[str, Column] = {}
        for c in self.columns:
            a, b = _union_pair(self._cols[c], other._cols[c], c)
            out[c] = _concat_columns(a, self._n, b, other._n, out_cap,
                                     a.ctype.join(b.ctype))
        if self._live is None and other._live is None:
            return DeviceTable(self.backend, out, total)
        # generic replay: either side's live prefix may be shorter than
        # its served n, leaving a dead gap in the middle of the concat —
        # close it with a read-free same-capacity compaction
        dev = self.backend.device
        live_a = (self._live if self._live is not None
                  else torch.tensor(self._n, dtype=torch.int32, device=dev))
        live_b = (other._live if other._live is not None
                  else torch.tensor(other._n, dtype=torch.int32,
                                    device=dev))
        t = torch.arange(out_cap, device=dev)
        mask = (t < live_a) | ((t >= self._n) & (t < self._n + live_b))
        idx = K.compact_indices(mask, out_cap)
        return DeviceTable(self.backend, _gather_cols(out, idx), total,
                           live=(live_a + live_b).to(torch.int32))

    def _sort_perm(self, keys: List[torch.Tensor]) -> torch.Tensor:
        """Stable multi-key sort permutation: the bitonic kernel on the
        capacities it covers (256 … 16384), the stable torch sort
        otherwise."""
        cap = self.capacity
        if OPS.sort_cap_supported(cap):
            OPS.ensure_kernels("sort", self.backend.device)
            return OPS.sort_perm_cuda(keys, cap)
        return K.sort_perm(keys, cap)

    def distinct(self) -> "DeviceTable":
        keys = [(~self.row_ok).to(torch.int64)]
        for col in self._cols.values():
            keys.extend(_sort_keys(col, ascending=True, nulls_last=True,
                                   backend=self.backend, op="distinct"))
        perm = self._sort_perm(keys)
        sorted_cols = _gather_cols(self._cols, perm)
        change = K.neighbor_change_keys([k[perm] for k in keys])
        # the sort puts dead rows last, so the sorted live mask is the
        # row_ok prefix
        keep = change & self.row_ok[perm]
        tmp = DeviceTable(self.backend, sorted_cols, self._n, live=self._live)
        return tmp._compact(keep)

    def order_by(self, items: Sequence[Tuple[str, bool]]) -> "DeviceTable":
        keys = [(~self.row_ok).to(torch.int64)]
        for col_name, asc in items:
            col = self._cols[col_name]
            keys.extend(_sort_keys(col, ascending=asc, nulls_last=asc,
                                   backend=self.backend, op="order_by"))
        perm = self._sort_perm(keys)
        return DeviceTable(self.backend, _gather_cols(self._cols, perm),
                           self._n, live=self._live)

    def skip(self, n: int) -> "DeviceTable":
        n = max(0, n)
        new_n = max(0, self._n - n)
        out_cap = self.backend.bucket(new_n)
        idx = torch.arange(out_cap, device=self.backend.device) + n
        idx = idx.clamp(0, max(0, self.capacity - 1))
        live = ((self._live - n).clamp(min=0).to(torch.int32)
                if self._live is not None else None)
        return DeviceTable(self.backend, _gather_cols(self._cols, idx), new_n,
                           live=live)

    def limit(self, n: int) -> "DeviceTable":
        new_n = min(max(0, n), self._n)
        out_cap = self.backend.bucket(new_n)
        idx = torch.arange(out_cap, device=self.backend.device).clamp(
            0, max(0, self.capacity - 1))
        live = (self._live.clamp(max=max(0, n)).to(torch.int32)
                if self._live is not None else None)
        return DeviceTable(self.backend, _gather_cols(self._cols, idx), new_n,
                           live=live)

    # -- aggregation ------------------------------------------------------

    def group(self, by: Sequence[str], aggs: Sequence[AggSpec]
              ) -> "DeviceTable":
        fast = self._group_dense_cuda(by, aggs)
        if fast is not None:
            return fast
        return self._group_device(by, aggs)

    def _group_device(self, by: Sequence[str],
                      aggs: Sequence[AggSpec]) -> "DeviceTable":
        """Sorted group-by: sort rows by the group keys, mark segment
        starts, and reduce each aggregation over the segments."""
        cap = self.capacity
        dev = self.backend.device
        if by:
            keys = [(~self.row_ok).to(torch.int64)]
            for c in by:
                keys.extend(_sort_keys(self._cols[c], True, True,
                                       self.backend, op="group"))
            perm = self._sort_perm(keys)
            sorted_cols = _gather_cols(self._cols, perm)
            row_ok_sorted = self.row_ok[perm]
            group_keys_sorted = [k[perm] for k in keys]
            change = K.neighbor_change_keys(
                group_keys_sorted[1:]) & row_ok_sorted
            seg_id = (torch.cumsum(change.to(torch.int32), 0,
                                   dtype=torch.int32) - 1).clamp(min=0)
            n_groups, groups_live = self.backend.consume_rows(
                K.mask_count(change))
        else:
            sorted_cols = dict(self._cols)
            group_keys_sorted = []
            seg_id = torch.zeros(cap, dtype=torch.int32, device=dev)
            n_groups, groups_live = 1, None
            change = torch.zeros(cap, dtype=torch.bool, device=dev)
            change[:1] = True
            row_ok_sorted = self.row_ok
        out_cap = self.backend.bucket(n_groups)
        if by:
            start_idx = K.compact_indices(change, out_cap)
        else:
            start_idx = torch.zeros(out_cap, dtype=torch.int64, device=dev)

        out: Dict[str, Column] = {}
        for c in by:
            out[c] = sorted_cols[c].take(start_idx)

        # DISTINCT aggregation: one extra stable sort by the group keys
        # plus the value marks the FIRST occurrence of each (group,
        # value); the aggregation then runs with that mask ANDed in (the
        # oracle keeps the first occurrence, so collect order matches)
        firstocc_cache: Dict[str, torch.Tensor] = {}

        def firstocc_for(col_name: str) -> torch.Tensor:
            if col_name not in firstocc_cache:
                combined = group_keys_sorted + _sort_keys(
                    sorted_cols[col_name], True, True, self.backend,
                    op="group")
                p2 = self._sort_perm(combined)
                first = torch.zeros(cap, dtype=torch.bool, device=dev)
                first[p2] = K.neighbor_change_keys([k[p2] for k in combined])
                firstocc_cache[col_name] = first
            return firstocc_cache[col_name]

        for a in aggs:
            firstocc = firstocc_for(a.col) if a.distinct else None
            if a.kind in ("percentile_cont", "percentile_disc"):
                out[a.name] = self._percentile_agg(
                    a, sorted_cols, group_keys_sorted, seg_id, out_cap,
                    row_ok_sorted, n_groups, start_idx, firstocc)
            else:
                out[a.name] = self._one_agg(a, sorted_cols, seg_id, out_cap,
                                            row_ok_sorted, n_groups,
                                            firstocc, start_idx)
        return DeviceTable(self.backend, out, n_groups, live=groups_live)

    def _percentile_agg(self, a: AggSpec, cols: Dict[str, Column],
                        group_keys_sorted: List[torch.Tensor], seg_id,
                        num_segments: int, row_ok, n_groups: int,
                        start_idx, firstocc=None) -> Column:
        """percentileDisc / percentileCont: one extra stable sort by
        (group keys, value) puts each group's valid values ascending at
        the head of its row block, so the percentile is a rank gather.
        disc takes the ceil(p·n) nearest rank (Neo4j's rule, as the
        oracle); cont interpolates between the two ranks either side, in
        float64.  The re-sort is group-major with the same keys, so each
        group's block keeps its offset (``start_idx``).  DISTINCT
        (``firstocc``) excludes repeated values and sorts them to the
        block's tail with one more key, so the ranks stay contiguous."""
        dev = self.backend.device
        group_live = torch.arange(num_segments, device=dev) < n_groups
        col = cols[a.col]
        if col.kind not in ("int", "float", "id", "bool") and not (
                a.kind == "percentile_disc"
                and col.kind in ("str", "list")):
            raise UnsupportedOnDevice(f"group: {a.kind} over kind {col.kind}")
        # (strings sort by the pool's rank: the ranked value is the
        # string's own code, gathered below)
        vk = _sort_keys(col, True, True, self.backend, op="group")
        # grouped, group_keys_sorted[0] is already the ~row_ok key;
        # ungrouped it must be added: padding rows look valid
        lead = (list(group_keys_sorted) if group_keys_sorted
                else [(~row_ok).to(torch.int64)])
        ok_full = col.valid & row_ok
        if firstocc is not None:
            ok_full = ok_full & firstocc
            lead = lead + [(~ok_full).to(torch.int64)]
        p2 = self._sort_perm(lead + vk)
        ok = ok_full[p2]
        seg2 = seg_id[p2]  # still non-decreasing: stable and group-major
        values = col.data[p2]
        counts = K.sorted_segment_agg(ok, ok, seg2, num_segments, "count")
        starts = start_idx.to(torch.int64)
        p = float(a.percentile or 0.0)
        last = values.shape[0] - 1
        top = (counts - 1).clamp(min=0)
        if a.kind == "percentile_disc":
            # nearest rank: the 1-based rank ceil(p * n)
            rank = torch.ceil(p * counts.to(torch.float64)).to(torch.int64)
            r = torch.minimum((rank.clamp(min=1) - 1).clamp(min=0), top)
            at = (starts + r).clamp(0, last)
            if col.kind == "list":
                out = col.take(p2[at])
                out.valid = (counts > 0) & group_live
                return out
            return Column(col.kind, values[at], (counts > 0) & group_live,
                          col.ctype)
        pos = p * top.to(torch.float64)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.minimum(lo + 1, top)
        frac = pos - lo.to(torch.float64)
        vlo = values[(starts + lo).clamp(0, last)].to(torch.float64)
        vhi = values[(starts + hi).clamp(0, last)].to(torch.float64)
        data = vlo * (1.0 - frac) + vhi * frac
        return Column("float", data, (counts > 0) & group_live, CTFloat)

    def _group_dense_cuda(self, by: Sequence[str], aggs: Sequence[AggSpec]
                          ) -> Optional["DeviceTable"]:
        """Sort-free group-by over a dictionary-coded key: the string pool
        makes group keys a *dense* int domain, so grouping is a histogram
        (the segment-aggregation kernel, ops/segment.py).  Returns None
        when the shape does not fit (the sorted path then runs)."""
        if len(by) != 1:
            return None
        if any(a.distinct or a.kind == "collect" for a in aggs):
            return None
        key_col = self._cols.get(by[0])
        if key_col is None or key_col.kind not in ("str", "bool"):
            return None
        domain = len(self.backend.pool) if key_col.kind == "str" else 2
        S = domain + 1  # one slot for the null-key group
        if S > DENSE_GROUP_MAX_SEGMENTS or S > self.capacity * 64:
            return None
        for a in aggs:
            if a.kind not in ("count_star", "count", "min", "max"):
                return None
            if a.kind in ("min", "max"):
                c = self._cols.get(a.col)
                if c is None or c.kind not in ("int", "id"):
                    return None
        row_ok = self.row_ok
        # int64 min/max ride the int32 kernel only when the values fit
        for c in {a.col for a in aggs if a.kind in ("min", "max")}:
            col = self._cols[c]
            if col.kind == "int":
                ok = col.valid & row_ok
                zero = torch.zeros_like(col.data)
                lo = self.backend.consume_count(
                    torch.where(ok, col.data, zero).min(), relation="lo")
                hi = self.backend.consume_count(
                    torch.where(ok, col.data, zero).max(), relation="cap")
                if not (-2**31 < lo and hi < 2**31):
                    return None

        dev = self.backend.device
        OPS.ensure_kernels("basic", dev)
        backend = self.backend
        # on a mesh the kernel runs once per shard's row block and the
        # partials combine (the JAX package's sharded Pallas group-by)
        sharded = (backend.mesh is not None
                   and self.capacity % backend.n_shards == 0)

        def agg_kernel(codes_, ok_, vals_, kind_):
            if sharded:
                return OPS.dense_segment_agg_sharded(
                    backend.mesh, codes_, ok_, vals_, S, kind_)
            return OPS.dense_segment_agg(codes_, ok_, vals_, S, kind_)

        codes = torch.where(key_col.valid & row_ok,
                            key_col.data.to(torch.int32),
                            torch.full_like(key_col.data, domain,
                                            dtype=torch.int32)).contiguous()
        counts_all = agg_kernel(codes, row_ok, codes, "count")
        count_cache: Dict[str, torch.Tensor] = {}

        def count_of(col_name: str) -> torch.Tensor:
            if col_name not in count_cache:
                col = self._cols[col_name]
                count_cache[col_name] = agg_kernel(
                    codes, col.valid & row_ok, codes, "count")
            return count_cache[col_name]

        slots = torch.arange(S, device=dev)
        live = torch.ones(S, dtype=torch.bool, device=dev)
        out: Dict[str, Column] = {}
        if key_col.kind == "str":
            out[by[0]] = Column("str", slots.to(torch.int32), slots < domain,
                                key_col.ctype)
        else:
            out[by[0]] = Column("bool", slots == 1, slots < domain,
                                key_col.ctype)
        for a in aggs:
            if a.kind == "count_star":
                out[a.name] = Column("int", counts_all.to(torch.int64), live,
                                     CTInteger)
            elif a.kind == "count":
                out[a.name] = Column("int", count_of(a.col).to(torch.int64),
                                     live, CTInteger)
            else:  # min / max over int/id
                col = self._cols[a.col]
                agg = agg_kernel(
                    codes, col.valid & row_ok,
                    col.data.to(torch.int32).contiguous(),
                    "min_i32" if a.kind == "min" else "max_i32")
                has = count_of(a.col) > 0
                out[a.name] = Column(col.kind, agg.to(
                    torch.int64 if col.kind == "int" else torch.int32),
                    has, col.ctype)
        dense = DeviceTable(self.backend, out, S)
        return dense._compact(counts_all > 0)

    def _one_agg(self, a: AggSpec, cols: Dict[str, Column], seg_id,
                 num_segments: int, row_ok, n_groups: int,
                 firstocc=None, start_idx=None) -> Column:
        dev = self.backend.device
        group_live = torch.arange(num_segments, device=dev) < n_groups
        if a.kind == "count_star":
            data = K.sorted_segment_agg(row_ok, row_ok, seg_id,
                                        num_segments, "count")
            return Column("int", data, group_live, CTInteger)
        col = cols[a.col]
        ok = col.valid & row_ok
        if firstocc is not None:
            ok = ok & firstocc
        if a.kind == "count":
            data = K.sorted_segment_agg(ok, ok, seg_id, num_segments, "count")
            return Column("int", data, group_live, CTInteger)
        if a.kind == "collect":
            return self._collect_agg(a, col, ok, seg_id, num_segments,
                                     group_live, start_idx)
        if col.kind in ("any", "list", "map", "duration") \
                and a.kind in ("min", "max"):
            return self._extreme_agg(a, col, ok, seg_id, num_segments,
                                     group_live, start_idx)
        if col.kind == "any" and a.kind in ("sum", "avg"):
            return self._number_sum(a, col, ok, seg_id, num_segments,
                                    group_live)
        if col.kind in ("list", "any", "map", "duration"):
            if a.kind != "first":
                raise UnsupportedOnDevice(f"group: {a.kind} over kind "
                                          f"{col.kind}")
            # the first kept row of each group, whole (a list property
            # carried through a grouping by its entity)
            rows = torch.arange(col.capacity, device=dev)
            first = K.segment_agg(rows, ok, seg_id, num_segments, "min")
            has = K.segment_agg(rows, ok, seg_id, num_segments, "count") > 0
            out = col.take(first.clamp(0, col.capacity - 1))
            out.valid = out.valid & has & group_live
            return out
        if a.kind == "first":
            data, has = K.segment_agg(col.data, ok, seg_id, num_segments,
                                      "first")
            return Column(col.kind, data, has & group_live, col.ctype)
        if col.kind == "str" and a.kind in ("min", "max"):
            rank = self.backend.rank_tensor()
            if rank.shape[0] == 0:
                return Column("str", torch.zeros(num_segments,
                                                 dtype=torch.int32,
                                                 device=dev),
                              torch.zeros(num_segments, dtype=torch.bool,
                                          device=dev), col.ctype)
            ranks = rank[col.data.clamp(0, rank.shape[0] - 1).long()]
            agg = K.segment_agg(ranks.to(torch.int64), ok, seg_id,
                                num_segments, a.kind)
            counts = K.segment_agg(ranks, ok, seg_id, num_segments, "count")
            inv = torch.argsort(rank).to(torch.int32)
            safe = agg.clamp(0, inv.shape[0] - 1)
            return Column("str", inv[safe], (counts > 0) & group_live,
                          col.ctype)
        if col.kind not in ("int", "float", "id", "bool") and not (
                col.kind in ("date", "datetime") and a.kind in ("min", "max")):
            raise UnsupportedOnDevice(f"group: {a.kind} over kind {col.kind}")
        values = col.data
        counts = K.segment_agg(values, ok, seg_id, num_segments, "count")
        if a.kind == "sum":
            if col.kind in ("int", "bool"):
                data = K.sorted_segment_agg(values.to(torch.int64), ok,
                                            seg_id, num_segments, "sum")
            else:
                data = K.segment_agg(values, ok, seg_id, num_segments, "sum")
            return Column(col.kind if col.kind != "bool" else "int",
                          data, group_live, a.result_type or col.ctype)
        if a.kind in ("min", "max"):
            data = K.segment_agg(values, ok, seg_id, num_segments, a.kind)
            return Column(col.kind, data, (counts > 0) & group_live,
                          col.ctype)
        if a.kind == "avg":
            s = K.segment_agg(values.to(torch.float64), ok, seg_id,
                              num_segments, "sum")
            data = s / counts.clamp(min=1)
            return Column("float", data, (counts > 0) & group_live, CTFloat)
        if a.kind == "stdev":
            v = values.to(torch.float64)
            s = K.segment_agg(v, ok, seg_id, num_segments, "sum")
            s2 = K.segment_agg(v * v, ok, seg_id, num_segments, "sum")
            nn = counts.clamp(min=1).to(torch.float64)
            var = ((s2 - s * s / nn) / (nn - 1).clamp(min=1)).clamp(min=0.0)
            data = torch.where(counts > 1, K.sqrt_f64(var),
                               torch.zeros_like(var))
            return Column("float", data, (counts > 0) & group_live, CTFloat)
        raise UnsupportedOnDevice(f"group: aggregation {a.kind}")

    def _extreme_agg(self, a: AggSpec, col: Column, ok, seg_id,
                     num_segments: int, group_live, start_idx) -> Column:
        """min / max of "any" values, lists, maps or durations in the
        global sort order (the oracle's ``min(vals, key=order_key)``):
        one more stable sort by (segment, kept first, the value's sort
        planes, those ORDER BY uses), ascending for min and descending
        for max, puts each group's answer at the head of its block,
        which stays where it was (the rows are in group order already);
        a tie keeps the first row, as ``min`` / ``max`` do."""
        keys = [seg_id.to(torch.int64), (~ok).to(torch.int64)] + \
            _sort_keys(col, a.kind == "min", True, self.backend,
                       op="group")
        p2 = self._sort_perm(keys)
        counts = K.sorted_segment_agg(ok, ok, seg_id, num_segments, "count")
        at = p2[start_idx.to(torch.int64).clamp(0, p2.shape[0] - 1)]
        out = col.take(at)
        out.valid = out.valid & (counts > 0) & group_live
        return out

    def _number_sum(self, a: AggSpec, col: Column, ok, seg_id,
                    num_segments: int, group_live) -> Column:
        """sum / avg of "any" numbers (the oracle's ``sum(vals)``): the
        integers summed exactly, the floats in float64; a group with a
        float gives a float, one of integers only an integer (sum) —
        avg is always a float.  A value that is not a number is an
        error, as adding it is in the oracle."""
        is_int = col.tags == A.TAG_INT
        is_float = col.tags == A.TAG_FLOAT
        if self.backend.consume_count((ok & ~is_int & ~is_float).sum()):
            raise ExprEvalError(f"{a.kind}() of a value that is not a "
                                f"number")
        p = A.payload(col)
        ints = K.sorted_segment_agg(p, ok & is_int, seg_id, num_segments,
                                    "sum")
        floats = K.segment_agg(A.bits_float(p), ok & is_float, seg_id,
                               num_segments, "sum")
        has_float = K.segment_agg(p, ok & is_float, seg_id, num_segments,
                                  "count") > 0
        total = ints.to(torch.float64) + floats
        if a.kind == "avg":
            counts = K.segment_agg(p, ok, seg_id, num_segments, "count")
            return Column("float", total / counts.clamp(min=1),
                          (counts > 0) & group_live, CTFloat)
        tags = torch.where(has_float, A.TAG_FLOAT, A.TAG_INT).to(torch.int8)
        payload = torch.where(has_float, A.float_bits(total), ints)
        return Column("any", payload, group_live,
                      a.result_type or col.ctype, tags=tags)

    def _collect_agg(self, a: AggSpec, col: Column, ok, seg_id,
                     num_segments: int, group_live, start_idx) -> Column:
        """collect(x): each group's values as one row of a (groups, L)
        list matrix of the element kind's dtype, written by one flat
        scatter.  The kept rows are in group-sorted (stable) order, so
        each list holds its values in row order: the oracle's collect
        order.  Nulls are dropped, so no element is null.  Lists, maps
        and durations are gathered whole into the slots
        (:meth:`_collect_rows`)."""
        if col.kind in ("list", "map", "duration"):
            return self._collect_rows(a, col, ok, seg_id, num_segments,
                                      group_live, start_idx)
        if col.kind not in ("id", "int", "float", "str", "bool", "date",
                            "datetime", "any"):
            raise UnsupportedOnDevice(f"group: collect over kind {col.kind}")
        if a.result_type is None or (
                list_elem_kind(a.result_type) is None
                and a.result_type.material.inner.material not in (CTVoid,
                                                                  CTNull)):
            # (a list of no element type: every value is null, so each
            # group's list is empty)
            raise UnsupportedOnDevice(
                f"group: collect to {a.result_type!r}, a list type with no "
                f"device representation")
        dev = self.backend.device
        ek = list_elem_kind(a.result_type)
        if ek == "any" or col.kind == "any":
            ek, col = "any", A.to_any(col)
            if col.data.dim() > 1:   # durations among the values
                return self._collect_rows(a, col, ok, seg_id, num_segments,
                                          group_live, start_idx)
        dtype = list_dtype(ek or col.kind)
        counts, L, flat_idx = self._collect_slots(ok, seg_id, num_segments,
                                                  start_idx)
        sentinel = num_segments * L

        def scatter(values, dtype):
            flat = torch.zeros(sentinel + 1, dtype=dtype, device=dev)
            flat.scatter_(0, flat_idx, values.to(dtype))
            return flat[:-1].reshape(num_segments, L)
        return Column("list", scatter(col.data, dtype), group_live,
                      a.result_type, counts.to(torch.int32),
                      tags=(None if col.tags is None
                            else scatter(col.tags, torch.int8)),
                      child=col.child, maps=col.maps)

    def _collect_slots(self, ok, seg_id, num_segments: int, start_idx):
        """(counts per group, the row width ``L``, each row's flat slot
        ``group * L + rank`` or the sentinel ``groups * L`` for a row not
        kept) of a collect.  The width is the longest list rounded up to
        a power of two on the card, so a param-generic replay whose
        longest list grows a little still fits the served width (the
        lengths bound each row)."""
        counts = K.sorted_segment_agg(ok, ok, seg_id, num_segments, "count")
        longest = counts.max().clamp(min=1)
        width = torch.exp2(torch.ceil(torch.log2(
            longest.to(torch.float64)))).to(torch.int64)
        L = self.backend.consume_count(width, relation="cap")
        # each kept row's rank within its segment
        c = torch.cumsum(ok.to(torch.int64), 0)
        sp = start_idx[seg_id.clamp(0, start_idx.shape[0] - 1).long()]
        base = torch.where(sp > 0, c[(sp - 1).clamp(min=0)],
                           torch.zeros_like(sp))
        within = c - 1 - base
        flat_idx = torch.where(ok, seg_id.to(torch.int64) * L + within,
                               torch.full_like(within, num_segments * L))
        return counts, L, flat_idx

    def _collect_rows(self, a: AggSpec, col: Column, ok, seg_id,
                      num_segments: int, group_live, start_idx) -> Column:
        """collect(x) of lists, maps or durations: each slot's source
        row scattered into a ``(groups, L)`` index, the rows gathered
        whole there (every per-row tensor of the column) and shaped into
        one list per group (a list of lists, of maps or of durations)."""
        from caps_tpu_torch.backends.cuda.lists import pack_elements
        dev = self.backend.device
        counts, L, flat_idx = self._collect_slots(ok, seg_id, num_segments,
                                                  start_idx)
        sentinel = num_segments * L
        src = torch.zeros(sentinel + 1, dtype=torch.int64, device=dev)
        src.scatter_(0, flat_idx, torch.arange(col.capacity, device=dev))
        elems = col.take(src[:-1])
        j = torch.arange(L, device=dev)[None, :]
        keep = j < counts[:, None]
        out = pack_elements(elems, keep, num_segments, L, a.result_type)
        out.valid = group_live
        out.elem_valid = None
        return out

    # -- lists -----------------------------------------------------------

    def explode(self, list_col: str, out_col: str,
                out_type: CypherType) -> "DeviceTable":
        """UNWIND: one output row per element of ``list_col``, in row
        order then element order; null and empty lists give no row, a
        null element a row holding null.  A string, a map or "any"
        values unwind as the oracle iterates them (``iterated``)."""
        col = self._cols[list_col]
        rest = {c: v for c, v in self._cols.items() if c != list_col}
        if col.kind in ("str", "map", "any"):
            comp = self._compiler(RecordHeader(), {})
            col = comp.iterated(col)
            self._raise_row_errors(comp)
        if col.kind != "list":
            # UNWIND of a value that is not a list: one row holding the
            # value itself, none for null
            rest[out_col] = Column(col.kind, col.data, col.valid, out_type,
                                   col.lens)
            return self._with_cols(rest)._compact(col.valid & self.row_ok)
        ok = col.valid & self.row_ok
        lens = torch.where(ok, col.lens, torch.zeros_like(col.lens))
        total, live = self.backend.consume_rows(lens.sum())
        out_cap = self.backend.bucket(total)
        row, within, out_valid, _ = K.explode_expand(col.lens, ok, out_cap)
        out_cols = _gather_cols(rest, row)
        at = within.clamp(0, col.data.shape[1] - 1)
        # the elements take the device list's element kind (a list of no
        # element type, or the planner's CTAny id of an entity it joins
        # back, keep theirs); elements of no type (an empty list's) are
        # nulls to what reads them: the rows hold none
        elem = elem_at(col, row, at, out_valid)
        out_kind = kind_for(out_type)
        if out_kind not in ("object", "any", "list", "map") \
                and elem.kind not in ("any", out_kind):
            elem = elem.astype_kind(out_kind)
        elem.ctype = CTNull if out_type.material == CTVoid else out_type
        out_cols[out_col] = elem
        return DeviceTable(self.backend, out_cols, total, live=live)

    def pack_list(self, cols: Sequence[str], out_col: str,
                  out_type: CypherType) -> "DeviceTable":
        """Pack integer columns (a path's hop ids) into one list column:
        per row the valid entries, left-aligned, and their count."""
        cap = self.capacity
        dev = self.backend.device
        dtype = list_dtype(list_elem_kind(out_type) or "id")
        if not cols:
            data = torch.zeros((cap, 1), dtype=dtype, device=dev)
            lens = torch.zeros(cap, dtype=torch.int32, device=dev)
        else:
            parts, valids = [], []
            for c in cols:
                col = self._cols[c]
                if col.kind not in ("id", "int"):
                    raise UnsupportedOnDevice(
                        f"pack_list: column {c!r} of kind {col.kind}")
                parts.append(col.data.to(dtype))
                valids.append(col.valid)
            # valid entries to the left of each row, in column order: a
            # running count over the k columns places them (the JAX
            # package's stable argsort of ~valid, whose tail no reader
            # sees; a scan along the short row axis is slow on the card)
            k = len(cols)
            count = torch.zeros(cap, dtype=torch.int64, device=dev)
            dest = []
            for v in valids:
                dest.append(torch.where(v, count, torch.full_like(count, k)))
                count = count + v
            data = torch.zeros((cap, k + 1), dtype=dtype, device=dev)
            data = data.scatter_(1, torch.stack(dest, dim=1),
                                 torch.stack(parts, dim=1))[:, :k]
            lens = count.to(torch.int32)
        out = dict(self._cols)
        out[out_col] = Column("list", data,
                              torch.ones(cap, dtype=torch.bool, device=dev),
                              out_type, lens)
        return self._with_cols(out)

    # -- materialization --------------------------------------------------

    def device_sync(self) -> None:
        """Wait for the card's queued work (PROFILE's per-operator
        device-time mode): ``torch.cuda.synchronize``; nothing to wait
        for on the CPU.  Reads no data and consumes no size."""
        if self.backend.device.type == "cuda":
            torch.cuda.synchronize(self.backend.device)

    def column_values(self, col: str) -> List[Any]:
        return column_to_host(self._cols[col], self._exact_n(),
                              self.backend.pool)

    def distinct_counts(self, cols: Sequence[str]) -> List[Optional[int]]:
        """Per column, its distinct non-null values as a Python ``set``
        of the host values counts them (``kernels.distinct_count``);
        None for a list column, which has no set semantics.  One
        device-to-host read for all columns (relational/stats.py)."""
        out: List[Optional[int]] = [None] * len(cols)
        at, counts = [], []
        for i, c in enumerate(cols):
            col = self._cols[c]
            if col.kind in ("list", "map", "duration", "any"):
                continue
            at.append(i)
            counts.append(K.distinct_count(col.data, col.valid & self.row_ok))
        if counts:
            self.backend.syncs += 1
            for i, v in zip(at, torch.stack(counts).tolist()):
                out[i] = int(v)
        return out

    def host_column(self, col: str):
        """(values, ok) numpy host view of an integer column — the
        ingest-time mirror when present (Column.host), else one counted
        device read.  ``ok`` folds in row liveness.  None when the
        column has no integer representation; host plan builders (count
        pushdown, matrix var-expand) key off this."""
        c = self._cols.get(col)
        if c is None or c.kind not in ("id", "int"):
            return None
        d, v, read = c.host_arrays()
        if read:
            self.backend.syncs += 1
        # _exact_n, not _n: under generic replay the served bound covers
        # dead-gap rows whose gathered values look valid — a host plan
        # builder (matrix var-expand seeds) must never see them
        return d, v & (np.arange(c.capacity) < self._exact_n())


    def host_values(self, col: str):
        """(values, ok) numpy arrays of the exact rows of a numeric or
        boolean column (int64, float64 or bool; ``ok`` False on a null):
        what ``column_values`` gives, without a Python value per row
        (``io/fs.py`` stores through it).  None for any other kind."""
        c = self._cols.get(col)
        if c is None or c.kind not in ("id", "int", "float", "bool"):
            return None
        n = self._exact_n()
        d, v, read = c.host_arrays()
        if read:
            self.backend.syncs += 1
        dtype = np.int64 if c.kind in ("id", "int") else d.dtype
        return d[:n].astype(dtype, copy=False), np.asarray(v[:n], bool)


def _named(compile_fn, op: str, expr: Expr):
    """Compile ``expr``; an expression without a device path raises
    :class:`UnsupportedOnDevice` naming the operator it was compiled for."""
    try:
        return compile_fn(expr)
    except UnsupportedOnDevice as ex:
        raise UnsupportedOnDevice(f"{op}: {ex}") from None


def _pad_rows(t: torch.Tensor, cap: int) -> torch.Tensor:
    """``t``'s rows zero-padded to ``cap``."""
    if t.shape[0] == cap:
        return t
    return torch.cat([t, torch.zeros((cap - t.shape[0],) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device=t.device)])


_ROW_FIELDS = ("data", "valid", "lens", "elem_valid", "tags", "order")


def _col_tensors(col: Column) -> List[torch.Tensor]:
    """Every per-row tensor of a column in a fixed order (a map's child
    columns after its own), for a collective to carry.  A list of lists'
    inner lists are no per-row tensor: they stay whole where they are,
    and the carried rows point into them."""
    out = [getattr(col, f) for f in _ROW_FIELDS
           if getattr(col, f) is not None]
    for k in col.fields or {}:
        out += _col_tensors(col.fields[k])
    return out


def _col_from(col: Column, it) -> Column:
    """``col`` rebuilt from the tensors :func:`_col_tensors` listed, read
    in the same order from the iterator ``it``."""
    kw = {f: next(it) for f in _ROW_FIELDS if getattr(col, f) is not None}
    if col.fields is not None:
        kw["fields"] = {k: _col_from(col.fields[k], it)
                        for k in col.fields}
    return dataclasses.replace(col, host=None, **kw)


def _gather_cols(cols: Dict[str, Column], idx: torch.Tensor
                 ) -> Dict[str, Column]:
    return {c: col.take(idx) for c, col in cols.items()}


def _all_valid(col: Column) -> torch.Tensor:
    """The ``elem_valid`` of a list column that has none: every element
    valid."""
    return torch.ones(col.data.shape[:2], dtype=torch.bool,
                      device=col.data.device)


def _widen(col: Column, width: int) -> Column:
    """A list column padded along its list axis to ``width`` (its map
    entries' lists too)."""
    if col.data.shape[1] >= width:
        return col
    kw = {f: pad_width(getattr(col, f), width,
                       True if f == "elem_valid" else 0)
          for f in ("data", "elem_valid", "tags", "order")
          if getattr(col, f) is not None}
    if col.fields is not None:
        kw["fields"] = {k: _widen(c, width) for k, c in col.fields.items()}
    return dataclasses.replace(col, host=None, **kw)


def _union_pair(a: Column, b: Column, name: str) -> Tuple[Column, Column]:
    """Two columns of one UNION output column brought to one kind: ids,
    ints and floats to the wider number, values of two kinds (lists and
    maps among them) to "any" values, lists of two element kinds or
    depths to lists of "any" values."""
    if a.nested and b.nested:
        # lists of lists: their inner lists brought to one kind
        ca, cb = _union_pair(a.child, b.child, name)
        return (dataclasses.replace(a, child=ca, host=None),
                dataclasses.replace(b, child=cb, host=None))
    if a.tags is not None and b.tags is not None \
            and a.data.dim() != b.data.dim():
        return A.widen(a), A.widen(b)   # durations among one side's
    if a.kind == b.kind and a.nested == b.nested and (
            a.kind != "list" or a.elem_kind == b.elem_kind
            or {a.elem_kind, b.elem_kind} <= {"id", "int"}):
        return a, b
    numeric = {"id", "int", "float"}
    held = set(A.HELD_KINDS + ("any",))
    if a.kind in numeric and b.kind in numeric:
        target = "float" if "float" in (a.kind, b.kind) else "int"
        return a.astype_kind(target), b.astype_kind(target)
    if a.kind == "list" == b.kind:
        if not (a.nested or b.nested or a.fields or b.fields) \
                and {a.elem_kind, b.elem_kind} <= numeric:
            dt = torch.float64 if "float" in (a.elem_kind, b.elem_kind) \
                else torch.int64
            return (dataclasses.replace(a, data=a.data.to(dt), host=None),
                    dataclasses.replace(b, data=b.data.to(dt), host=None))
        return _union_pair(A.list_to_any(a), A.list_to_any(b), name)
    if {a.kind, b.kind} <= held:
        return _union_pair(A.to_any(a), A.to_any(b), name)
    raise UnsupportedOnDevice(f"union_all: column {name!r} of kinds "
                              f"{a.kind} and {b.kind}")


def _concat_columns(a: Column, n_a: int, b: Column, n_b: int, out_cap: int,
                    ctype: CypherType) -> Column:
    """The first ``n_a`` rows of ``a`` then the first ``n_b`` of ``b``,
    padded to ``out_cap``: every per-row tensor concatenated, list axes
    widened to the wider side; maps (and lists of maps) over the union
    of their keys, a key absent on one side absent in its rows; lists of
    lists over both sides' inner lists (:func:`share_child`), "any"
    values over both sides' held lists and maps (``anyvalue.share``)."""
    if (a.fields is None) != (b.fields is None) or a.nested != b.nested \
            or (a.tags is None) != (b.tags is None) \
            or a.data.dim() != b.data.dim():
        raise UnsupportedOnDevice(f"union of {a.kind} and {b.kind} values "
                                  f"of different shapes")
    if a.nested:
        a, b = share_child(a, b)
    if a.tags is not None:
        a, b = A.share(a, b)
    fields = None
    if a.fields is not None:
        keys = list(a.fields) + [k for k in b.fields if k not in a.fields]
        fields, pres = {}, ([], [])
        for k in keys:
            ca, cb = a.fields.get(k), b.fields.get(k)
            ca = null_like(cb, torch.zeros_like(cb.valid)) if ca is None \
                else ca
            cb = null_like(ca, torch.zeros_like(ca.valid)) if cb is None \
                else cb
            ca, cb = _union_pair(ca, cb, k)
            fields[k] = _concat_columns(ca, n_a, cb, n_b, out_cap,
                                        ca.ctype.join(cb.ctype))
            for side, m in zip(pres, (a, b)):
                side.append(m.data[..., list(m.fields).index(k)]
                            if k in m.fields else
                            torch.zeros(m.data.shape[:-1], dtype=torch.bool,
                                        device=m.data.device))

        def presence(side, m):
            return (torch.stack(side, dim=-1) if side else
                    torch.zeros(m.data.shape[:-1] + (0,), dtype=torch.bool,
                                device=m.data.device))
        order = not M.in_order([a, b], keys)
        a = dataclasses.replace(a, data=presence(pres[0], a), order=(
            M.ranks(a, keys) if order else None))
        b = dataclasses.replace(b, data=presence(pres[1], b), order=(
            M.ranks(b, keys) if order else None))
        if a.kind == "list":
            # a list of maps: each key's list as wide as the lists
            width = max(a.data.shape[1], b.data.shape[1])
            fields = {k: _widen(c, width) for k, c in fields.items()}
    kw = {}
    for f in _ROW_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            kw[f] = None
            continue
        fill = True if f == "elem_valid" else 0
        # (only the validity masks of elements may be missing on one side)
        x = _all_valid(a) if x is None else x
        y = _all_valid(b) if y is None else y
        if x.dtype != y.dtype:
            x, y = x.to(torch.int64), y.to(torch.int64)
        shape = [max(p, q) for p, q in zip(x.shape[1:], y.shape[1:])]

        def grow(t):
            pad = []
            for d in reversed(range(1, t.dim())):
                pad += [0, shape[d - 1] - t.shape[d]]
            return F.pad(t, pad, value=fill) if any(pad) else t
        both = torch.cat([grow(x[:n_a]), grow(y[:n_b])])
        rest = out_cap - n_a - n_b
        kw[f] = F.pad(both, (0, 0) * (both.dim() - 1) + (0, rest),
                      value=fill if f != "valid" else False)
    return Column(a.kind, kw.pop("data"), kw.pop("valid"), ctype,
                  kw.pop("lens"), fields=fields, child=a.child, maps=a.maps,
                  **kw)


def share_child(a: Column, b: Column) -> Tuple[Column, Column]:
    """Two lists of lists over one child: their inner lists brought to
    one kind and concatenated, ``b``'s elements moved past ``a``'s inner
    lists (nothing moves where both already share one)."""
    if a.child is b.child:
        return a, b
    ca, cb = _union_pair(a.child, b.child, "inner list")
    n_a, n_b = ca.capacity, cb.capacity
    child = _concat_columns(ca, n_a, cb, n_b, n_a + n_b,
                            ca.ctype.join(cb.ctype))
    return (dataclasses.replace(a, child=child, host=None),
            dataclasses.replace(b, child=child, data=b.data + n_a,
                                host=None))


# A list element's key where one int64 plane holds it (ids, string
# ranks, booleans): past the row's length below every value, a null
# element above every value (openCypher: a prefix sorts first, and a
# null element takes null's place after the values).
_LIST_ABSENT = -(1 << 40)
_LIST_NULL = 1 << 40


def _list_sort_keys(col: Column, ascending: bool, nulls_last: bool,
                    backend: DeviceBackend) -> List[torch.Tensor]:
    """A list column's sort planes in openCypher list order (the
    oracle's ``okapi/values.py order_key``): the list's null key, then
    element by element.  Elements of ids, strings (by the pool's rank)
    and booleans take one plane each; ints and floats, whose values
    span their dtype, a tag plane (0 past the length, 1 a value, 2 a
    null element) and a value plane."""
    null_key = (~col.valid).to(torch.int64)
    if not nulls_last:
        null_key = -null_key
    sign = 1 if ascending else -1
    W = col.data.shape[1]
    j = torch.arange(W, device=col.data.device)[None, :]
    inside = (j < col.lens[:, None]) & col.valid[:, None]
    ev = col.valid_elems()
    data = col.data
    ek = col.elem_kind
    if ek == "str":
        rank = backend.rank_tensor()
        if rank.shape[0]:
            data = rank[data.clamp(0, rank.shape[0] - 1).long()]
    keys = [null_key]
    if ek in ("int", "float", "date", "datetime", "any"):
        tag = torch.where(inside, torch.where(ev, 1, 2), 0).to(torch.int64)
        if ek == "any":
            vals = A.view(Column("any", data, col.valid, col.ctype,
                                 tags=col.tags), backend.rank_tensor())
        else:
            vals = (data,)
        for i in range(W):
            keys.append(sign * tag[:, i])
            for v in vals:
                v = torch.where(inside & ev, v, torch.zeros_like(v))
                keys.append(v[:, i] if ascending else -v[:, i])
        return keys
    v = data.to(torch.int64)
    v = torch.where(inside, torch.where(ev, v, _LIST_NULL), _LIST_ABSENT)
    keys.extend(sign * v[:, i] for i in range(W))
    return keys


def _element_sort_keys(col: Column, ascending: bool, nulls_last: bool,
                       backend: DeviceBackend, op: str) -> List[torch.Tensor]:
    """Sort planes of a list of lists, of maps or of durations in
    ``order_key``'s order: the list's null key, then per position a tag
    (0 past the length, 1 a value, 2 a null element, the largest) and
    the element's own planes (:func:`_sort_keys` of the inner list, map
    or duration), zero where the position holds no value."""
    null_key = (~col.valid).to(torch.int64)
    if not nulls_last:
        null_key = -null_key
    sign = 1 if ascending else -1
    dev = col.data.device
    rows = torch.arange(col.capacity, device=dev)
    keys = [null_key]
    for i in range(col.data.shape[1]):
        inside = col.valid & (i < col.lens)
        elem = elem_at(col, rows, torch.full_like(rows, i), inside)
        tag = torch.where(inside, torch.where(elem.valid, 1, 2), 0)
        keys.append(sign * tag.to(torch.int64))
        for k in _sort_keys(elem, ascending, ascending, backend, op)[1:]:
            keys.append(torch.where(elem.valid, k, torch.zeros_like(k)))
    return keys


def _sort_keys(col: Column, ascending: bool, nulls_last: bool,
               backend: DeviceBackend, op: str) -> List[torch.Tensor]:
    """Transform one column into (null_key, data_key) int64/float64 arrays
    for an ascending lexicographic sort (a list column into its planes,
    :func:`_list_sort_keys`)."""
    if col.kind == "list":
        if col.child is not None or col.fields is not None \
                or col.maps is not None or col.data.dim() > 2:
            # lists of lists, of maps, of durations, of "any" values
            # with durations, lists or maps among them
            return _element_sort_keys(col, ascending, nulls_last, backend,
                                      op)
        return _list_sort_keys(col, ascending, nulls_last, backend)
    if col.kind == "any":
        # the class orders a held list or map among the other values, and
        # its own planes (zero on the other rows) among its kind
        keys = A.sort_keys(col, ascending, nulls_last, backend.rank_tensor())
        for kind, _attr in A.SIDES:
            h = A.held(col, kind)
            if h is not None:
                keys += _sort_keys(h, ascending, ascending, backend, op)[1:]
        return keys
    if col.kind == "map":
        # a null entry is the largest value inside a map (order_key), so
        # it sorts last ascending and first descending
        return M.sort_keys(col, ascending, nulls_last, lambda c: _sort_keys(
            c, ascending, ascending, backend, op))
    null_key = (~col.valid).to(torch.int64)
    if not nulls_last:
        null_key = -null_key
    if col.kind == "duration":
        # (months, days, seconds): the reference's deterministic key
        planes = torch.where(col.valid[:, None], col.data,
                             torch.zeros_like(col.data))
        sign = 1 if ascending else -1
        return [null_key] + [sign * planes[:, i] for i in range(3)]
    if col.kind == "str":
        rank = backend.rank_tensor()
        if rank.shape[0] == 0:
            data = col.data.to(torch.int64)
        else:
            data = rank[col.data.clamp(0, rank.shape[0] - 1).long()].to(
                torch.int64)
    elif col.kind == "float":
        data = col.data
    else:
        data = col.data.to(torch.int64)
    if not ascending:
        data = -data
    # nulls must not influence the data key
    data = torch.where(col.valid, data, torch.zeros_like(data))
    return [null_key, data]


class DeviceTableFactory(TableFactory):
    def __init__(self, backend: DeviceBackend):
        self.backend = backend

    def prepare_rel_table(self, rel_table) -> None:
        """Ingest-time physical layout: a device-resident CSR over the
        relationship table's source and target columns, built on the
        host from the columns' ingest mirrors.  Every later Expand hop
        against this table probes ``indptr`` instead of sorting +
        binary-searching the edge list."""
        if not self.backend.config.use_csr:
            return
        t = rel_table.table
        if not isinstance(t, DeviceTable):
            return
        m = rel_table.mapping
        for name in (m.source_col, m.target_col):
            col = t._cols.get(name)
            if col is None or col.kind not in ("id", "int"):
                continue
            if getattr(col, "_csr", None) is not None:
                continue
            if col.host is not None:
                keys, valid = col.host
            else:
                keys = col.data.cpu().numpy()
                valid = col.valid.cpu().numpy()
            csr = OPS.build_csr(keys[:t._n], valid[:t._n], t.capacity,
                                self.backend.device)
            col._csr = ((t._n,), csr)

    def from_columns(self, data: Mapping[str, Sequence[Any]],
                     types: Mapping[str, CypherType]) -> DeviceTable:
        n = len(next(iter(data.values()))) if data else 0
        cap = self.backend.bucket(n)
        cols: Dict[str, Column] = {}
        # a failed ingest must not leave the strings it interned behind
        pool_mark = self.backend.pool.mark()
        try:
            for c, values in data.items():
                ctype = types[c]
                if kind_for(ctype) == "object":
                    raise UnsupportedOnDevice(
                        f"from_columns: column {c!r} of type {ctype!r} has "
                        f"no device representation")
                try:
                    col = make_column(values, ctype, cap, self.backend.pool,
                                      self.backend.device)
                except ValueError as ex:
                    raise UnsupportedOnDevice(f"from_columns: {c!r}: {ex}")
                cols[c] = self.backend.place_column(col)
        except Exception:
            self.backend.pool.rollback(pool_mark)
            raise
        return DeviceTable(self.backend, cols, n)

    def unit(self) -> DeviceTable:
        return DeviceTable(self.backend, {}, 1)

    def empty(self, cols: Sequence[str],
              types: Mapping[str, CypherType]) -> DeviceTable:
        out: Dict[str, Column] = {}
        cap = self.backend.bucket(0)
        for c in cols:
            ctype = types.get(c, CTInteger)
            if kind_for(ctype) == "object":
                raise UnsupportedOnDevice(
                    f"empty: column {c!r} of type {ctype!r} has no device "
                    f"representation")
            out[c] = make_column([], ctype, cap, self.backend.pool,
                                 self.backend.device)
        return DeviceTable(self.backend, out, 0)
