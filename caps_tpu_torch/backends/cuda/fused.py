"""Whole-query fused execution: record/replay of data-dependent sizes.

The counterpart of ``caps_tpu/backends/tpu/fused.py``.  The eager
DeviceTable path reads one scalar on the host per data-dependent output
size (filter count, join total, group count — see kernels.py's two-phase
pattern), and each read waits for the card to drain its stream.  This
module is the engine's analog of whole-stage codegen (the reference
delegated the same problem to Spark's Tungsten pipeline — ref:
spark-cypher/.../impl/table/SparkTable.scala, reconstructed, mount empty;
SURVEY.md §3.1):

* the FIRST execution of a (graph, query, params) key runs in ``record``
  mode — it behaves exactly like the eager path but appends every size it
  materializes to a memo;
* every LATER execution runs in ``replay`` mode — ``consume_count`` serves
  the memoized sizes with ZERO host reads, so the whole query issues the
  same eager torch ops on the current stream as one uninterrupted async
  dispatch stream, and the only read left is the final result
  materialization.

Replay is sound because sizes are a pure function of (graph data, query,
parameters): graphs are immutable once created and the key includes the
query text and parameter values.  If the op sequence nevertheless
diverges (e.g. the session string pool crossed a kernel-eligibility
threshold between record and replay and the plan took a different
branch), ``consume_count`` or the end-of-run audit raises
:class:`FusedReplayMismatch` and :meth:`FusedExecutor.run` transparently
re-executes the query in record mode.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import (
    Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Tuple,
)

from caps_tpu_torch.backends.cuda.sharded import ShardedTable
from caps_tpu_torch.backends.cuda.table import (
    DeviceBackend, DeviceTable, FusedReplayMismatch,
)
from caps_tpu_torch.relational.ops import ENTITY_CTX_PARAM
from caps_tpu_torch.serve.errors import CancellationError
from caps_tpu_torch.serve.failure import TRANSIENT, classify

_graph_epochs = itertools.count()


def _graph_key(graph) -> Optional[int]:
    """A stable identity for a graph object.  Graphs are immutable, so an
    epoch stamped on first use is a sound memo key (``id()`` alone is not —
    it can be reused after gc)."""
    k = getattr(graph, "_fused_epoch", None)
    if k is None:
        k = next(_graph_epochs)
        try:
            graph._fused_epoch = k
        except Exception:
            return None
    return k


def _reprable(v: Any) -> bool:
    """True if ``repr(v)`` identifies the value's *content*.  Objects with
    the default ``object.__repr__`` embed a memory address, which can be
    reused after gc — a false memo hit there would replay sizes recorded
    for different data, so such params refuse fusion instead."""
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(_reprable(x) for x in v)
    if isinstance(v, dict):
        return all(_reprable(k) and _reprable(x) for k, x in v.items())
    return type(v).__repr__ is not object.__repr__


def _params_key(params: Mapping[str, Any]) -> Optional[str]:
    try:
        items = [(k, v) for k, v in params.items() if k != ENTITY_CTX_PARAM]
        if not all(_reprable(v) for _, v in items):
            return None
        return repr(sorted(items))
    except Exception:
        return None  # unorderable/unhashable params: skip fusion


def _merge_streams(merged: List[Tuple], rec: List[Tuple],
                   widen_rows=None) -> Optional[List[Tuple]]:
    """Merge a fresh recording into the param-generic stream: entry
    tags must align 1:1 (the op sequence must not depend on params);
    capacity-like values widen to the max, lower bounds to the min,
    exact values must agree, stats and objects take the latest.  Returns
    None when the streams are structurally incompatible (the query is
    then not param-generic).

    ``widen_rows`` (the backend's bucket function) adds convergence
    headroom: a row cap that a new recording EXCEEDED jumps to its
    bucket boundary, so per-param size jitter stops re-recording once
    the stream has seen the workload's bucket."""
    if len(merged) != len(rec):
        return None
    out: List[Tuple] = []
    for m, r in zip(merged, rec):
        if m[0] != r[0]:
            return None
        if m[0] == "__obj__":
            # host objects take the LATEST recording and are served
            # unchecked under generic replay: soundness rests on the
            # consume_obj invariant (table.py) — every consumer is guarded
            # by a later relation-checked consume
            out.append(r)
        elif m[0] == "seeds":
            # the prefixes seeded from the result cache: a stream of
            # another set is another op sequence
            if m[1] != r[1]:
                return None
            out.append(r)
        elif m[0] == "rows":
            hi = max(m[1], r[1])
            if widen_rows is not None and r[1] > m[1]:
                hi = max(hi, widen_rows(r[1]))
            out.append(("rows", hi))
        else:  # ("size", value, relation)
            if m[2] != r[2]:
                return None
            rel = m[2]
            if rel == "cap":
                out.append(("size", max(m[1], r[1]), rel))
            elif rel == "lo":
                out.append(("size", min(m[1], r[1]), rel))
            elif rel == "stat":
                out.append(r)
            else:  # exact — must agree across params or the query is
                # not param-generic
                if m[1] != r[1]:
                    return None
                out.append(r)
    return out


# After this many generic-replay violations for one (graph, query) the
# key stops trying generic replay: the sizes are too param-dependent and
# each violation costs a full re-execution.
_GENERIC_VIOLATION_LIMIT = 3


class FusedExecutor:
    """Per-session memo of recorded size streams.

    Two memo levels:

    * exact — keyed (graph epoch, query text, canonical params): replay
      serves the exact recorded sizes, ZERO syncs, no checks needed.
      Each entry keeps the catalog graphs its query resolved; the
      session's catalog subscription drops it when one of them changes
      (:meth:`evict_dependents`), as it drops the query's cached plan.
    * generic — keyed (graph epoch, query text): replay serves sizes
      merged across ALL recorded param values (capacities widened to
      the max).  Row counts become device scalars on the produced
      tables (DeviceTable._live), every served value is relation-checked
      on device, and ONE end-of-query sync of the violation flag decides
      whether results are exact (they are unless the flag is set) or
      the query must re-execute in record mode.  Steady-state
      parameterized workloads (e.g. reads with rotating ids) drop from
      one host read per data-dependent size to 1 per query."""

    def __init__(self, backend: DeviceBackend, max_entries: int = 512):
        self.backend = backend
        self.max_entries = max_entries
        # key -> (pool size at end of the record run, recorded entries,
        #         names of the catalog graphs the query resolved)
        self._memo: Dict[Tuple, Tuple[int, List[Tuple], FrozenSet]] = {}
        # (gk, query) -> [pool size, merged entries, violation count]
        self._generic: Dict[Tuple, List] = {}
        self.recordings = 0
        self.replays = 0
        self.generic_replays = 0
        self.mismatches = 0
        # serving micro-batches dispatched through batch() (serve/)
        self.batches = 0
        self.batch_members = 0
        # mode of the most recent run() — "record" | "replay" |
        # "replay_gen" | None (no key / nested)
        self.last_mode: Optional[str] = None

    def key(self, graph, query: str,
            params: Mapping[str, Any]) -> Optional[Tuple]:
        gk = _graph_key(graph)
        pk = _params_key(params)
        if gk is None or pk is None:
            return None
        return (gk, query, pk)

    def _replayable(self, key: Optional[Tuple]) -> bool:
        """A recording is replayable only if the session string pool has
        not grown since it was made: kernel-eligibility branches (e.g. the
        dense group-by kernel's domain check) read the pool size, so a grown
        pool could legally change the op sequence.  A changed pool is a
        clean memo miss (re-record), not a replay hazard."""
        entry = self._memo.get(key)
        return entry is not None and entry[0] == len(self.backend.pool)

    def _generic_entry(self, key: Tuple) -> Optional[List]:
        g = self._generic.get(key[:2])
        if (g is None or g[0] != len(self.backend.pool) or g[1] is None
                or g[2] >= _GENERIC_VIOLATION_LIMIT):
            return None
        return g

    def run(self, key: Optional[Tuple], thunk: Callable[[], Any]) -> Any:
        state: Dict[str, Any] = {"mode": None}
        try:
            with self._activate(key, state):
                result = thunk()
                # expose the result to the generic-replay epilogue so the
                # violation-flag sync can batch with the result table's
                # exact-count read (one transfer instead of two)
                state["result"] = result
                self.last_mode = state["mode"]
                return result
        except CancellationError:
            # Deadline expiry / client cancel (serve/deadline.py) is not
            # replay divergence: the recording is still sound, and a
            # re-execution would run the query after its budget was
            # already spent.
            raise
        except Exception as ex:
            if state["mode"] not in ("replay", "replay_gen"):
                # ambient/record-mode failures are genuine errors; a retry
                # under an active outer recording would double-append its
                # sizes and corrupt the outer memo.  (A failed RECORD run
                # never stores a memo: the store below the yield is
                # skipped when the thunk raises, so a device error cannot
                # park a partial recording.)
                raise
            if classify(ex) == TRANSIENT:
                # A transient device error (out of memory under pressure)
                # says nothing about the recording's soundness: keep the
                # memo, don't count a mismatch, and let the caller retry
                # — the retry replays sync-free again instead of paying a
                # needless re-record.
                raise
            # ANY failure during replay is treated as divergence: drop the
            # recording and re-execute in record mode (sizes served from a
            # stale memo can surface as shape/index errors far from here).
            self.mismatches += 1
            if state["mode"] == "replay_gen":
                g = self._generic.get(key[:2])
                if g is not None:
                    g[2] += 1
            else:
                self._memo.pop(key, None)
            self.last_mode = "record"
            state = {"mode": None}
            with self._activate(key, state, force_record=True):
                state["result"] = thunk()
            return state["result"]

    def clear(self) -> int:
        """Drop every exact memo and generic stream (a re-shard changes
        every recorded size: ``session.shrink_and_reshard``).  Returns
        the memos dropped."""
        n = len(self._memo)
        self._memo.clear()
        self._generic.clear()
        return n

    def evict_dependents(self, qgn=None) -> int:
        """The session's catalog subscription: drop the exact memo of
        every query that resolved the catalog graph ``qgn`` (any catalog
        graph when None), and its generic stream — the same scope in
        which the plan cache drops the query's plan.  A replay after a
        catalog change would otherwise serve sizes recorded for the
        graph the name held before.  Returns the memos dropped."""
        stale = [k for k, (_pool, _rec, deps) in self._memo.items()
                 if deps and (qgn is None or qgn in deps)]
        for k in stale:
            del self._memo[k]
            self._generic.pop(k[:2], None)
        return len(stale)

    def export_streams(self, graph) -> Dict[str, Dict[str, Any]]:
        """Warm-path export (relational/plan_store.py): the param-generic
        size streams recorded for ``graph``, keyed by query text —
        ``{query: {"pool_len": n, "entries": [...]}}``.  Only streams
        that would replay now are returned: a pool-stale stream could
        never replay, and a violation-disabled one is known to diverge
        (re-installing it with a fresh count would make the warmed
        process worse than a cold record)."""
        gk = getattr(graph, "_fused_epoch", None)
        out: Dict[str, Dict[str, Any]] = {}
        if gk is None:
            return out
        pool_n = len(self.backend.pool)
        for (g, query), ent in list(self._generic.items()):
            if g != gk or ent[1] is None or ent[0] != pool_n \
                    or ent[2] >= _GENERIC_VIOLATION_LIMIT:
                continue
            out[query] = {"pool_len": ent[0], "entries": list(ent[1])}
        return out

    def generic_state(self, graph, query: str) -> str:
        """``"current"`` — the (graph, query) param-generic stream would
        replay now; ``"stale"`` — a stream exists but the pool moved, so
        the next execution pays a record run (what the warmup
        convergence pass re-executes to pre-pay); ``"absent"`` — no
        usable stream (never recorded, not fuseable, or
        violation-disabled)."""
        gk = getattr(graph, "_fused_epoch", None)
        if gk is None:
            return "absent"
        g = self._generic.get((gk, query))
        if g is None or g[1] is None or g[2] >= _GENERIC_VIOLATION_LIMIT:
            return "absent"
        return ("current" if g[0] == len(self.backend.pool)
                else "stale")

    def seed_generic(self, graph, query: str, pool_len: int,
                     entries: List[Tuple]) -> bool:
        """Warm-path seed (serve/warmup.py): install a persisted
        param-generic size stream for (graph, query) so the FIRST
        execution in this process replays instead of paying a record
        run.  A stream learned in this process is never replaced.
        Soundness does not rest on the store: the pool-size gate
        (:meth:`_generic_entry`) ignores a stream recorded against
        another string pool, and generic replay checks every served
        size on the device — a wrong stream re-records."""
        gk = _graph_key(graph)
        if gk is None:
            return False
        gkey = (gk, query)
        if gkey in self._generic:
            return False
        self._generic[gkey] = [int(pool_len), list(entries), 0]
        while len(self._generic) > max(1, self.max_entries):
            self._generic.pop(next(iter(self._generic)))
        return True

    @contextlib.contextmanager
    def batch(self, n: int):
        """Batched replay for the serving tier (serve/batcher.py): ``n``
        compatible executions dispatched back to back as one
        micro-batch.  Each member replays its own recorded size stream
        with no size read, so with the rows read only after the last
        member (the server does this) the whole batch is one
        uninterrupted stream of launches on the card."""
        self.batches += 1
        self.batch_members += n
        yield self

    def forget(self, graph, query: str) -> int:
        """Drop every size memo — exact and generic — recorded for
        (graph, query), so the next execution re-records from scratch.
        The re-plan loop (relational/session.py ``_maybe_replan``) calls
        it with each retired plan: a re-planned tree may have another
        shape, and replaying the old plan's size stream against it would
        mis-gather.  Returns the number of entries dropped."""
        gk = getattr(graph, "_fused_epoch", None)
        if gk is None:
            return 0
        gkey = (gk, query)
        dropped = 0
        for key in [k for k in self._memo if k[:2] == gkey]:
            del self._memo[key]
            dropped += 1
        if self._generic.pop(gkey, None) is not None:
            dropped += 1
        return dropped

    @contextlib.contextmanager
    def _activate(self, key: Optional[Tuple],
                  state: Optional[Dict[str, Any]] = None,
                  force_record: bool = False):
        if state is None:
            state = {"mode": None}
        backend = self.backend
        # No key, or already inside an outer fused run (a nested
        # _cypher_on_graph): run under the ambient mode.
        if key is None or backend.count_mode is not None:
            yield
            return
        if self._replayable(key) and not force_record:
            state["mode"] = "replay"
            entries = self._memo[key][1]
            cursor = [0]
            backend.count_mode = ("replay", entries, cursor)
            try:
                yield
            finally:
                backend.count_mode = None
            if cursor[0] != len(entries):
                raise FusedReplayMismatch(
                    f"replay consumed {cursor[0]} of {len(entries)} "
                    f"recorded sizes — op sequence diverged from the "
                    f"recording")
            self.replays += 1
            return
        generic = None if force_record else self._generic_entry(key)
        if generic is not None:
            state["mode"] = "replay_gen"
            entries = generic[1]
            cursor = [0]
            backend._replay_viol = None
            backend._obj_unguarded = 0
            backend.count_mode = ("replay_gen", entries, cursor)
            try:
                yield
            finally:
                backend.count_mode = None
            if cursor[0] != len(entries):
                raise FusedReplayMismatch(
                    f"generic replay consumed {cursor[0]} of "
                    f"{len(entries)} merged sizes — op sequence diverged")
            if backend.config.debug_obj_guard and backend._obj_unguarded:
                # consume_obj invariant (table.py): a served host object
                # with no later relation-checked consume could shape
                # results undetected
                raise AssertionError(
                    f"{backend._obj_unguarded} __obj__ entr"
                    f"{'y' if backend._obj_unguarded == 1 else 'ies'} "
                    "served under generic replay without a downstream "
                    "relation-checked consume guarding them")
            viol = backend._replay_viol
            backend._replay_viol = None
            if viol is not None:
                backend.syncs += 1  # the one end-of-query check
                # Batch the flag read with the result table's exact row
                # count (DeviceTable.prime_exact): steady state then
                # pays exactly ONE device->host read per query — a later
                # to_maps reads the pre-paid exact-count cache.
                table = getattr(getattr(state.get("result"), "records",
                                        None), "table", None)
                bad = (table.prime_exact(viol)
                       if isinstance(table, (DeviceTable, ShardedTable))
                       else bool(viol))
                if bad:
                    raise FusedReplayMismatch(
                        "generic replay relation violated (an actual "
                        "size exceeded its served bound) — re-recording")
            self.generic_replays += 1
            generic[2] = 0  # only CONSECUTIVE violations disable the key
            return
        state["mode"] = "record"
        rec: List[Tuple] = []
        backend.count_mode = ("record", rec)
        try:
            yield
        finally:
            backend.count_mode = None
        self._memo.pop(key, None)
        while self._memo and len(self._memo) >= max(1, self.max_entries):
            self._memo.pop(next(iter(self._memo)))
        # Stamp the POST-run pool size: the record run may itself have
        # interned new strings, after which the pool is stable for
        # repeats of this exact query.
        pool_n = len(backend.pool)
        deps = frozenset(q for q, _tok in getattr(
            state.get("result"), "catalog_deps", ()))
        self._memo[key] = (pool_n, rec, deps)
        self.recordings += 1
        gkey = key[:2]
        g = self._generic.get(gkey)
        if g is None or g[0] != pool_n:
            # first recording at this pool size seeds the generic stream
            seeded = list(rec)
            if g is not None and g[1] is not None:
                # pool drift forced this re-record, but the OLD stream's
                # learned magnitudes (widened row caps, merged sizes)
                # are still valid observations of the workload — carry
                # them forward when the op structure still aligns, so a
                # pool change does not reset the convergence headroom
                carried = _merge_streams(list(g[1]), rec,
                                         widen_rows=self.backend.bucket)
                if carried is not None:
                    seeded = carried
            self._generic[gkey] = [pool_n, seeded, 0]
        elif g[1] is not None:
            g[1] = _merge_streams(g[1], rec, widen_rows=backend.bucket)
        while len(self._generic) > max(1, self.max_entries):
            self._generic.pop(next(iter(self._generic)))
