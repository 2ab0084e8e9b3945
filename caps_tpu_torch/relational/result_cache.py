"""Snapshot-keyed result & subplan caching — repeated reads from memory
(the counterpart of ``caps_tpu/relational/result_cache.py``).

Without it every read pays the full device path: even a byte-identical
repeated query against an unchanged snapshot re-executes its operator
stream, so serving QPS on skewed (hot-query-heavy) traffic is capped by
device dwell instead of memory bandwidth.  The immutable per-version
:class:`GraphSnapshot` makes result reuse *provably sound* —
a result keyed by ``(result scope, snapshot version)`` can never be
stale, the same way paged KV-cache reuse is made sound by immutable
prefix blocks (Ragged Paged Attention; PAPERS.md).  Two levels:

* **Result cache** — a bounded LRU of fully materialized result rows
  keyed by ``(result scope, normalized query text, param value
  digest)`` plus the snapshot version checked at lookup.  Admission is
  **cost-aware**: an entry is admitted only when its observed service
  time (``session.op_stats``) times a recency-estimated re-hit
  probability beats its byte footprint — one giant scan can't evict a
  thousand cheap point-reads (the observed-statistics costing line of
  "Premature Dimensional Collapse ..."; PAPERS.md).  Bytes are charged
  to the memory ledger's ``mem.result_cache_bytes`` gauge and bounded
  by :class:`ResultCacheConfig.budget_bytes`.

* **Subplan cache** — deterministic scan→filter *prefixes* of the
  relational operator tree, memoized by structural signature within a
  snapshot.  Different plan families that share a prefix reuse ONE
  materialized intermediate, held where it was computed (on the card
  for a device session): before execution the cached ``(header,
  table)`` is seeded into the prefix root's result memo, so the
  operators above it pull it without recomputing (and without
  re-appending op metrics — the observable proof of reuse).  Only
  param-free prefixes are eligible: a filter whose predicate reads
  ``$param`` computes different rows per binding.  Its bytes are the
  table's ``nbytes`` (device bytes for a device table), under the same
  budget and LRU as the result level.

  A memoized table is shared by reference with every later plan that
  seeds it, and torch tensors are mutable: the soundness of the share
  rests on no operator writing into its input's tensors.  Every
  in-place op of the device backend writes a tensor it has just made
  (a ``searchsorted`` result, a ``zeros`` buffer it scatters into) and
  no kernel takes an input as writable, so an operator's input is read
  only.  A memo is keyed by its placement too (the session's device and
  mesh slots), so it never reaches a session whose tensors live
  elsewhere; and a session that re-shards drops every memo
  (``CUDACypherSession.shrink_and_reshard``).

Consistency is by construction, not invalidation: writes publish a new
snapshot version = a new key space, so a cached entry is *never*
invalidated by a write — it is retired when its version is superseded
(commit/compaction/``install_state``) or its plan family is quarantined
by the serving tier's failure containment.  Recency estimates read
``obs.clock`` (never ``time.*``) so the fake-clock tests can pin the
half-life decay exactly.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Tuple

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock, make_rlock
from caps_tpu_torch.relational.plan_cache import _value_token

_scope_tokens = itertools.count(1)
_scope_token_lock = make_lock("result_cache._scope_token_lock")


def result_scope(graph) -> Optional[int]:
    """A stable identity for the *lineage* a snapshot belongs to.

    Snapshots of one VersionedGraph share a scope (stamped on the
    handle, so retire-by-scope can drop every superseded version in one
    sweep); a plain immutable graph is its own scope.  The first-use
    stamp is locked, mirroring ``graph_plan_token``: concurrent serving
    threads submitting against a fresh graph must agree on ONE scope or
    their cache keys silently diverge.  None = unanchorable."""
    anchor = getattr(graph, "handle", None)
    if anchor is None:
        anchor = graph
    tok = getattr(anchor, "_rescache_scope", None)
    if tok is None:
        with _scope_token_lock:
            tok = getattr(anchor, "_rescache_scope", None)
            if tok is not None:
                return tok
            tok = next(_scope_tokens)
            try:
                anchor._rescache_scope = tok
            except Exception:
                return None
    return tok


def graph_version(graph) -> int:
    """The snapshot version a result read from ``graph`` is keyed by.
    Plain immutable graphs are version 0 forever — their single version
    never flips, so entries simply never retire."""
    try:
        return int(getattr(graph, "snapshot_version", 0) or 0)
    except Exception:
        return 0


def params_digest(params: Mapping[str, Any]) -> Optional[Tuple]:
    """A value-FAITHFUL digest of the parameter bindings, or None when
    one can't be built (an unfaithful token would serve another
    binding's rows — refuse caching instead; same discipline as the
    plan cache's value specializations)."""
    items = []
    for k in sorted(params):
        tok = _value_token(params[k])
        if tok is None:
            return None
        items.append((k, tok))
    return tuple(items)


def result_cache_key(graph, query: str,
                     params: Mapping[str, Any]) -> Optional[Tuple]:
    """The full cache key for one read, or None when the read is
    uncacheable (version-unstable handle that carries no snapshot
    identity, or un-digestable parameter values).  The snapshot VERSION
    is deliberately *not* part of the key: lookup checks it against the
    stored entry so a superseded entry reads as a miss (and is dropped)
    instead of lingering under a dead key."""
    from caps_tpu_torch.frontend.parser import normalize_query
    scope = result_scope(graph)
    if scope is None:
        return None
    if getattr(graph, "plan_token_unstable", False) \
            and not hasattr(graph, "snapshot_version"):
        return None
    digest = params_digest(params or {})
    if digest is None:
        return None
    # the SAME token normal form the plan family uses, so family-scoped
    # eviction (quarantine) matches result keys by key[1]
    return (scope, normalize_query(query), digest)


@dataclasses.dataclass(frozen=True)
class ResultCacheConfig:
    """Knobs for the two-level cache (server-side: ``ServerConfig
    .result_cache``)."""
    #: hard ceiling on resident result+subplan bytes (the
    #: ``mem.result_cache_bytes`` ledger gauge never exceeds it)
    budget_bytes: int = 8 << 20
    #: entry-count cap across both levels (belt to the byte budget)
    max_entries: int = 1024
    #: re-hit probability half-life: an entry last seen ``half_life_s``
    #: ago is half as likely to recur as one seen just now
    half_life_s: float = 30.0
    #: admission floor: expected saved seconds per resident byte
    min_benefit_per_byte: float = 1e-10
    #: no single entry may take more than this fraction of the budget
    max_entry_fraction: float = 0.25
    enabled: bool = True
    #: memoize scan→filter prefixes too (the second level)
    subplan: bool = True


class _ResultEntry:
    __slots__ = ("key", "version", "rows", "nbytes", "service_s",
                 "hits", "stored_t", "last_t")

    def __init__(self, key, version, rows, nbytes, service_s, now_t):
        self.key = key
        self.version = int(version)
        self.rows = rows
        self.nbytes = int(nbytes)
        self.service_s = float(service_s)
        self.hits = 0
        self.stored_t = now_t
        self.last_t = now_t


class _SubplanEntry:
    __slots__ = ("key", "header", "table", "nbytes", "last_t", "mark")

    def __init__(self, key, header, table, nbytes, now_t, mark):
        self.key = key
        self.header = header
        self.table = table
        self.nbytes = int(nbytes)
        self.last_t = now_t
        #: the streams that made the table and an event on each
        #: (``DeviceTable.stream_mark``); None off the card
        self.mark = mark


class CachedRows:
    """The ``result=`` object completed onto a cache-hit handle: exposes
    the same ``to_maps()`` the records object does, so callers that go
    through ``handle.result().to_maps()`` and callers that go through
    ``handle.rows()`` both see the cached rows (fresh copies — a caller
    mutating its rows must never corrupt the cache or a co-hit)."""

    def __init__(self, rows: List[Dict[str, Any]]):
        self._rows = rows

    def to_maps(self) -> List[Dict[str, Any]]:
        return [dict(r) for r in self._rows]

    def __repr__(self):
        return f"CachedRows({len(self._rows)} rows)"


def _rows_nbytes(rows: List[Dict[str, Any]]) -> int:
    """Rough host bytes a materialized row list keeps resident."""
    n = 64 * (len(rows) + 1)
    for r in rows:
        for k, v in r.items():
            n += 48 + len(str(k)) + len(repr(v))
    return n


# -- subplan signatures ----------------------------------------------------

def _expr_has_param(expr) -> bool:
    """Walk a frozen-dataclass expression tree for any ``Param`` node —
    a parameterized predicate computes different rows per binding, so
    the prefix below it is ineligible for structural memoization."""
    from caps_tpu_torch.ir import exprs as E
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, E.Param):
            return True
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                v = getattr(node, f.name, None)
                if isinstance(v, (list, tuple)):
                    stack.extend(v)
                else:
                    stack.append(v)
    return False


def _prefix_signature(op) -> Optional[Tuple]:
    """Structural signature of a deterministic scan→filter prefix, or
    None when ``op`` roots no eligible prefix.  ``repr`` of the frozen
    predicate dataclass is faithful (every field participates), so two
    plan families that planned the same prefix produce the same
    signature — that's the whole point: cross-family reuse."""
    from caps_tpu_torch.relational import ops as R
    if isinstance(op, R.ScanOp):
        return (("scan", op.var, repr(op.entity_type)),)
    if isinstance(op, R.FilterOp) and len(op.children) == 1:
        if _expr_has_param(op.predicate):
            return None
        child_sig = _prefix_signature(op.children[0])
        if child_sig is None:
            return None
        return child_sig + (("filter", repr(op.predicate)),)
    return None


def _prefix_anchor(op):
    """The leaf ScanOp of an eligible prefix — its ``.graph`` anchors
    the (scope, version) the memoized intermediate is sound for."""
    from caps_tpu_torch.relational import ops as R
    while not isinstance(op, R.ScanOp):
        if not op.children:
            return None
        op = op.children[0]
    return op


def _eligible_prefixes(root) -> List[Tuple[Any, Tuple]]:
    """Maximal eligible prefixes under ``root``: walk top-down, stop
    descending at the first op that roots one (a sub-prefix of a
    memoized prefix would be redundant)."""
    out, seen, stack = [], set(), [root]
    while stack:
        op = stack.pop()
        if id(op) in seen:
            continue
        seen.add(id(op))
        sig = _prefix_signature(op)
        if sig is not None:
            out.append((op, sig))
            continue
        stack.extend(op.children)
    return out


def seeded_prefix_ids(root) -> List[int]:
    """The op ids of ``root``'s eligible prefixes that hold a memo — just
    after :meth:`ResultCache.seed_subplans`, the ones it seeded."""
    return sorted(op.op_id for op, _ in _eligible_prefixes(root)
                  if op._result is not None)


def _placement(op) -> Optional[Tuple]:
    """Where the tables of ``op``'s session live: its device and, on a
    mesh, its slots (None for a host session).  Part of a subplan key,
    so a memo on one card or mesh never seeds a session on another."""
    backend = getattr(getattr(op.context, "session", None), "backend",
                      None)
    device = getattr(backend, "device", None)
    if device is None:
        return None
    mesh = getattr(backend, "mesh", None)
    slots = None if mesh is None else tuple(str(s) for s in mesh.slots)
    return (str(device), slots)


class ResultCache:
    """The two-level, byte-budgeted, snapshot-keyed cache.

    One lock guards both levels and the byte ledger (lookups mutate LRU
    order and hit stamps; the serving tier calls in from admission,
    completion, quarantine, and the versioned write path's retirement
    hooks, all on different threads).  Counters live in the session's
    :class:`MetricsRegistry` so ``rescache.*`` shows up in
    ``session.metrics_snapshot()`` and fleet ``merge_snapshots``."""

    def __init__(self, config: Optional[ResultCacheConfig] = None,
                 registry=None):
        from caps_tpu_torch.obs.metrics import MetricsRegistry
        self.config = config if config is not None else ResultCacheConfig()
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._lock = make_rlock("result_cache.ResultCache._lock")
        self._entries: "OrderedDict[Tuple, _ResultEntry]" = OrderedDict()
        self._subplans: "OrderedDict[Tuple, _SubplanEntry]" = OrderedDict()
        self._bytes = 0
        #: recency notebook: key -> (miss_count, last_seen_t), bounded —
        #: the re-hit probability estimator's only state
        self._seen: "OrderedDict[Tuple, Tuple[int, float]]" = OrderedDict()
        self._seen_cap = max(64, 4 * self.config.max_entries)
        self._hits = self.metrics.counter("rescache.hits")
        self._misses = self.metrics.counter("rescache.misses")
        self._insertions = self.metrics.counter("rescache.insertions")
        self._evictions = self.metrics.counter("rescache.evictions")
        self._admission_rejects = self.metrics.counter(
            "rescache.admission_rejects")
        self._stale_rejects = self.metrics.counter("rescache.stale_rejects")
        self._retired = self.metrics.counter("rescache.retired")
        self._subplan_hits = self.metrics.counter("rescache.subplan_hits")
        self._subplan_misses = self.metrics.counter("rescache.subplan_misses")
        self._subplan_insertions = self.metrics.counter(
            "rescache.subplan_insertions")
        self.metrics.gauge("rescache.entries", fn=lambda: len(self._entries))
        self.metrics.gauge("rescache.subplan_entries",
                           fn=lambda: len(self._subplans))
        self.metrics.gauge("rescache.bytes", fn=lambda: self._bytes)
        self.metrics.gauge("rescache.hit_ratio", fn=self._hit_ratio)

    def _hit_ratio(self) -> float:
        h, m = self._hits.value, self._misses.value
        return (h / (h + m)) if (h + m) else 0.0

    # -- result level ------------------------------------------------------

    def _load(self, key: Tuple) -> Optional[_ResultEntry]:
        """The single entry-fetch seam, called under the cache lock —
        ``testing.faults.stale_cache`` patches it to forge wrong-version
        entries, proving the version check downstream of it holds."""
        return self._entries.get(key)

    def lookup(self, key: Tuple,
               version: int) -> Optional[List[Dict[str, Any]]]:
        """Rows for ``key`` at exactly ``version``, or None.  A stored
        entry at any OTHER version is dropped, not served: version-keyed
        consistency is the whole soundness story."""
        if not self.config.enabled or key is None:
            return None
        now_t = clock.now()
        with self._lock:
            entry = self._load(key)
            if entry is None:
                self._note_miss(key, now_t)
                self._misses.inc()
                return None
            if entry.version != int(version):
                self._stale_rejects.inc()
                real = self._entries.pop(key, None)
                if real is not None:
                    self._bytes -= real.nbytes
                    self._evictions.inc()
                self._note_miss(key, now_t)
                self._misses.inc()
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
            entry.last_t = now_t
            self._hits.inc()
            return [dict(r) for r in entry.rows]

    def _note_miss(self, key: Tuple, now_t: float) -> None:
        count, _ = self._seen.get(key, (0, now_t))
        self._seen[key] = (count + 1, now_t)
        self._seen.move_to_end(key)
        while len(self._seen) > self._seen_cap:
            self._seen.popitem(last=False)

    def _rehit_probability(self, key: Tuple, now_t: float) -> float:
        """How likely this key recurs, from its miss history: each prior
        sighting raises the ceiling (count/(count+1)), decayed by how
        long ago the last one was (half-life ``half_life_s``)."""
        count, last_t = self._seen.get(key, (1, now_t))
        base = count / (count + 1.0)
        age = max(0.0, now_t - last_t)
        return base * (0.5 ** (age / max(1e-9, self.config.half_life_s)))

    def offer(self, key: Tuple, version: int, rows: List[Dict[str, Any]],
              nbytes: Optional[int] = None,
              service_s: float = 0.0) -> bool:
        """Cost-aware admission: admit when ``service_s`` (the seconds a
        future hit saves) × re-hit probability beats the byte footprint.
        Returns True when the entry was admitted."""
        cfg = self.config
        if not cfg.enabled or key is None:
            return False
        nbytes = int(nbytes) if nbytes else _rows_nbytes(rows)
        nbytes = max(1, nbytes)
        if nbytes > cfg.budget_bytes * cfg.max_entry_fraction:
            self._admission_rejects.inc()
            return False
        now_t = clock.now()
        with self._lock:
            benefit = float(service_s) * self._rehit_probability(key, now_t)
            if benefit / nbytes < cfg.min_benefit_per_byte:
                self._admission_rejects.inc()
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            entry = _ResultEntry(key, version,
                                 [dict(r) for r in rows],
                                 nbytes, service_s, now_t)
            self._entries[key] = entry
            self._bytes += nbytes
            self._insertions.inc()
            self._evict_over_budget()
        return True

    # -- subplan level -----------------------------------------------------

    def _subplan_key(self, op, sig: Tuple) -> Optional[Tuple]:
        anchor = _prefix_anchor(op)
        if anchor is None:
            return None
        scope = result_scope(anchor.graph)
        if scope is None:
            return None
        return (scope, graph_version(anchor.graph), sig, _placement(op))

    def seed_subplans(self, root) -> int:
        """Before execution: install memoized intermediates into every
        eligible prefix root's result memo, so the ops above pull them
        without recomputing (and without re-appending op metrics — the
        observable proof of reuse).  Returns the number seeded."""
        if not (self.config.enabled and self.config.subplan):
            return 0
        seeded = 0
        now_t = clock.now()
        for op, sig in _eligible_prefixes(root):
            key = self._subplan_key(op, sig)
            if key is None:
                continue
            with self._lock:
                entry = self._subplans.get(key)
                if entry is None:
                    self._subplan_misses.inc()
                    continue
                self._subplans.move_to_end(key)
                entry.last_t = now_t
                if entry.mark is not None:
                    # the memo may have been made on another stream (a
                    # serving replica's, or the default one): the
                    # seeding stream waits for the event recorded where
                    # it was made, and every tensor is recorded on the
                    # seeding stream, so the caching allocator holds its
                    # memory until this stream's reads are done even if
                    # the entry is evicted mid-run.  An event alone would
                    # order the reads but let a freed block be reused
                    # under them; record_stream alone would not order
                    # them after the producer's writes.
                    entry.table.adopt_streams(entry.mark)
                op._result = (entry.header, entry.table)
                self._subplan_hits.inc()
                seeded += 1
        return seeded

    def store_subplans(self, root) -> int:
        """After execution (BEFORE any ``reset_plan``): capture every
        eligible prefix's computed (header, table).  Tables are shared
        by reference — the op tree itself holds the same objects between
        runs, and no operator writes into its input (module
        docstring)."""
        if not (self.config.enabled and self.config.subplan):
            return 0
        stored = 0
        now_t = clock.now()
        for op, sig in _eligible_prefixes(root):
            memo = getattr(op, "_result", None)
            if memo is None:
                continue
            key = self._subplan_key(op, sig)
            if key is None:
                continue
            header, table = memo
            try:
                nbytes = int(table.nbytes)
            except Exception:
                nbytes = 1024
            if nbytes > self.config.budget_bytes \
                    * self.config.max_entry_fraction:
                continue
            with self._lock:
                if key in self._subplans:
                    continue
                mark = getattr(table, "stream_mark", None)
                self._subplans[key] = _SubplanEntry(
                    key, header, table, nbytes, now_t,
                    mark() if mark is not None else None)
                self._bytes += nbytes
                self._subplan_insertions.inc()
                self._evict_over_budget()
                stored += 1
        return stored

    def clear_subplans(self) -> int:
        """Drop every memoized intermediate (a session that re-shards
        calls it: a memo may hold a block on a lost slot's card).
        Returns the number dropped."""
        with self._lock:
            dropped = len(self._subplans)
            for entry in self._subplans.values():
                self._bytes -= entry.nbytes
            self._subplans.clear()
            if dropped:
                self._evictions.inc(dropped)
        return dropped

    # -- eviction / retirement --------------------------------------------

    def _evict_over_budget(self) -> None:
        """Under the lock: pop least-recently-used entries (across BOTH
        levels, by last-touch stamp) until bytes and entry count fit."""
        cfg = self.config
        while self._bytes > cfg.budget_bytes or \
                (len(self._entries) + len(self._subplans)) > cfg.max_entries:
            r_key = next(iter(self._entries), None)
            s_key = next(iter(self._subplans), None)
            if r_key is None and s_key is None:
                break
            r_t = self._entries[r_key].last_t if r_key is not None \
                else float("inf")
            s_t = self._subplans[s_key].last_t if s_key is not None \
                else float("inf")
            if r_t <= s_t:
                entry = self._entries.pop(r_key)
            else:
                entry = self._subplans.pop(s_key)
            self._bytes -= entry.nbytes
            self._evictions.inc()

    def retire_superseded(self, scope: Optional[int],
                          version: int) -> int:
        """Drop every entry of ``scope`` whose version predates
        ``version`` — the versioned write path's hook, called when a
        commit / compaction / ``install_state`` publishes a newer
        snapshot.  New versions never *invalidate* (new key space); this
        only reclaims bytes a dead version can never serve again."""
        if scope is None:
            return 0
        version = int(version)
        dropped = 0
        with self._lock:
            for key in [k for k, e in self._entries.items()
                        if k[0] == scope and e.version < version]:
                self._bytes -= self._entries.pop(key).nbytes
                dropped += 1
            for key in [k for k in self._subplans
                        if k[0] == scope and k[1] < version]:
                self._bytes -= self._subplans.pop(key).nbytes
                dropped += 1
            if dropped:
                self._retired.inc(dropped)
        return dropped

    def evict_family(self, family: str) -> int:
        """Failure containment, mirroring ``PlanCache.quarantine``: a
        plan family the serving tier quarantined may have produced
        poisoned rows, so drop its result entries — and every memoized
        intermediate, since a poisoned prefix can't be attributed to one
        family (prefixes are shared across families by design)."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries if k[1] == family]:
                self._bytes -= self._entries.pop(key).nbytes
                dropped += 1
            for key in list(self._subplans):
                self._bytes -= self._subplans.pop(key).nbytes
                dropped += 1
            if dropped:
                self._evictions.inc(dropped)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._subplans.clear()
            self._seen.clear()
            self._bytes = 0

    # -- introspection -----------------------------------------------------

    @property
    def bytes(self) -> int:
        return self._bytes

    @property
    def entries(self) -> int:
        return len(self._entries)

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "subplan_entries": len(self._subplans),
                "bytes": self._bytes,
                "budget_bytes": self.config.budget_bytes,
                "hits": self._hits.value,
                "misses": self._misses.value,
                "hit_ratio": self._hit_ratio(),
                "insertions": self._insertions.value,
                "evictions": self._evictions.value,
                "admission_rejects": self._admission_rejects.value,
                "stale_rejects": self._stale_rejects.value,
                "retired": self._retired.value,
                "subplan_hits": self._subplan_hits.value,
                "subplan_misses": self._subplan_misses.value,
            }
