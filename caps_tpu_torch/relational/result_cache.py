"""Snapshot-keyed result caching — repeated reads from memory
(the counterpart of ``caps_tpu/relational/result_cache.py``).

Without it every read pays the full device path: even a byte-identical
repeated query against an unchanged snapshot re-executes its operator
stream, so serving QPS on skewed (hot-query-heavy) traffic is capped by
device dwell instead of memory bandwidth.  The immutable per-version
:class:`GraphSnapshot` makes result reuse *provably sound* —
a result keyed by ``(result scope, snapshot version)`` can never be
stale, the same way paged KV-cache reuse is made sound by immutable
prefix blocks (Ragged Paged Attention; PAPERS.md).

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

The port caches host rows only.  The reference's second level, which
memoizes scan→filter prefixes of the operator tree, would hold device
tables; it is not ported.

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
    """Knobs for the result cache (server-side: ``ServerConfig
    .result_cache``)."""
    #: hard ceiling on resident result bytes (the
    #: ``mem.result_cache_bytes`` ledger gauge never exceeds it)
    budget_bytes: int = 8 << 20
    #: entry-count cap (belt to the byte budget)
    max_entries: int = 1024
    #: re-hit probability half-life: an entry last seen ``half_life_s``
    #: ago is half as likely to recur as one seen just now
    half_life_s: float = 30.0
    #: admission floor: expected saved seconds per resident byte
    min_benefit_per_byte: float = 1e-10
    #: no single entry may take more than this fraction of the budget
    max_entry_fraction: float = 0.25
    enabled: bool = True


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


class ResultCache:
    """The byte-budgeted, snapshot-keyed result cache.

    One lock guards the entries and the byte ledger (lookups mutate LRU
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
        self.metrics.gauge("rescache.entries", fn=lambda: len(self._entries))
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

    # -- eviction / retirement --------------------------------------------

    def _evict_over_budget(self) -> None:
        """Under the lock: pop least-recently-used entries until bytes
        and entry count fit."""
        cfg = self.config
        while self._entries and (self._bytes > cfg.budget_bytes
                                 or len(self._entries) > cfg.max_entries):
            _, entry = self._entries.popitem(last=False)
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
            if dropped:
                self._retired.inc(dropped)
        return dropped

    def evict_family(self, family: str) -> int:
        """Failure containment, mirroring ``PlanCache.quarantine``: a
        plan family the serving tier quarantined may have produced
        poisoned rows, so drop its result entries."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries if k[1] == family]:
                self._bytes -= self._entries.pop(key).nbytes
                dropped += 1
            if dropped:
                self._evictions.inc(dropped)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
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
            }
