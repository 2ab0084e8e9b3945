"""Prepared statements and the session-level LRU plan cache.

The counterpart of ``caps_tpu/relational/plan_cache.py``.  Without it
every ``cypher()`` call re-runs the whole scalar front end (parse →
IRBuilder → LogicalPlanner → LogicalOptimizer → RelationalPlanner) even
for identical query text.  This module caches the *planned relational
operator tree* and re-executes it with fresh parameter bindings:

* the cache key is value-independent: (normalized query text, graph plan
  token, parameter *signature* — names + coarse types, never values);
  catalog consistency rides on per-plan dependency tokens, revalidated
  at lookup;
* parameter VALUES are late-bound: relational operators read
  ``context.parameters`` inside ``_compute``, so one cached plan serves
  every binding;
* where planning genuinely DID read a value (:class:`PlanParams` records
  every such read — e.g. the key set of a map parameter used as pattern
  properties), the cached entry is additionally keyed by that value
  aspect, so specialized plans are re-planned rather than served stale;
* a catalog mutation bumps the mutated NAME's dep token — its dependents
  are never served again (lookup revalidation drops them), the session's
  catalog subscription evicts them eagerly, and every unrelated graph's
  plans survive.

Executing a cached plan = clear each operator's memoized ``(header,
table)`` pair, swap the shared runtime context's parameter dict, and pull
``root.result`` again.  Between executions a cached plan retains no
tables or device buffers.

Concurrency: the cache's LRU dict is guarded by one lock, and each
:class:`CachedPlan` carries its own ``exec_lock`` — two threads that hit
the SAME entry take turns re-binding/executing its shared operator tree.
Counters live on the cache itself (:meth:`PlanCache.stats`).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from caps_tpu_torch.obs.lockgraph import make_lock, make_rlock
from caps_tpu_torch.okapi.types import from_python

_plan_tokens = itertools.count(1)
_plan_token_lock = make_lock("plan_cache._plan_token_lock")


def graph_plan_token(graph) -> Optional[int]:
    """A stable identity for a graph object, stamped on first use
    (``id()`` alone can be reused after gc — same technique as the fused
    executor's graph epoch).  None = this graph cannot anchor a cache
    entry.  The first-use stamp is locked: concurrent threads submitting
    against a fresh graph must agree on ONE token, or their cache keys
    silently diverge.  A graph marked ``plan_token_unstable`` (one whose
    data changes in place) refuses a token: a stable token would serve
    stale plans."""
    if getattr(graph, "plan_token_unstable", False):
        return None
    tok = getattr(graph, "_plan_token", None)
    if tok is None:
        with _plan_token_lock:
            tok = getattr(graph, "_plan_token", None)
            if tok is not None:
                return tok
            tok = next(_plan_tokens)
            try:
                graph._plan_token = tok
            except Exception:
                return None
    return tok


def _coarse_type_token(value: Any) -> str:
    """Names + coarse types form the parameter signature: the planner
    only ever consumes a parameter's *type* (SchemaTyper), so plans are
    shared across values of the same shape."""
    try:
        return repr(from_python(value))
    except Exception:
        return f"?{type(value).__name__}"


def param_signature(params: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, _coarse_type_token(v)) for k, v in params.items()))


def _value_token(v: Any) -> Optional[str]:
    """A token that fully identifies a parameter VALUE, or None when no
    faithful token exists.  Only plain primitives and containers of them
    qualify: an arbitrary type's ``repr`` may be content-free or
    truncated (numpy arrays elide elements past a threshold), and a
    collided token would serve a stale value-specialized plan — refuse
    caching instead."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        parts = [_value_token(x) for x in v]
        if any(p is None for p in parts):
            return None
        return f"[{','.join(parts)}]"
    if isinstance(v, (set, frozenset)):
        parts = [_value_token(x) for x in v]
        if any(p is None for p in parts):
            return None
        return f"{{{','.join(sorted(parts))}}}"
    if isinstance(v, dict):
        items = []
        for k, x in v.items():
            kt, xt = _value_token(k), _value_token(x)
            if kt is None or xt is None:
                return None
            items.append(f"{kt}:{xt}")
        return f"{{{','.join(sorted(items))}}}"
    return None


class PlanParams(Mapping):
    """The parameter view handed to the PLANNING phases (IRBuilder /
    LogicalPlanner / SchemaTyper).  It records every read that makes the
    resulting plan depend on a parameter *value* — such reads become
    extra cache-key components (specializations) so a value-specialized
    plan is never served for a different value.

    Reads that only consume the coarse type (:meth:`coarse_type`) record
    nothing: the type is already part of the cache key's parameter
    signature.  :meth:`map_keys` records only the KEY SET of a map
    parameter (pattern-property expansion depends on the keys, not the
    values).  Any other value access (``get``/``[]``/iteration) records
    the full value — sound for any future plan-time read, at the cost of
    value-keying that plan."""

    def __init__(self, params: Mapping[str, Any]):
        self._params = dict(params)
        # ordered, deduped (kind, name) -> token
        self.specializations: "OrderedDict[Tuple[str, str], Any]" = \
            OrderedDict()
        self.cacheable = True

    # -- plan-time accessors -------------------------------------------

    def coarse_type(self, name: str):
        """The parameter's coarse Cypher type (None when unbound).  Not a
        specialization: the signature already keys on it."""
        if name not in self._params:
            return None
        return from_python(self._params[name])

    def map_keys(self, name: str) -> Optional[Tuple[str, ...]]:
        """Sorted key tuple of a map-valued parameter (None otherwise).
        Records a key-set specialization: two bindings with different
        keys plan differently, same keys with different values share the
        plan."""
        v = self._params.get(name)
        keys = tuple(sorted(v)) if isinstance(v, dict) else None
        self._record("mapkeys", name, keys)
        return keys

    def _record(self, kind: str, name: str, token: Any) -> None:
        try:
            hash(token)
        except TypeError:
            token = repr(token)
        self.specializations[(kind, name)] = token

    # -- Mapping protocol (full-value reads record specializations) ----

    def __getitem__(self, name: str) -> Any:
        v = self._params[name]
        tok = _value_token(v)
        if tok is None:
            # no faithful content token: this plan must not be cached at
            # all (a collided token would serve it for a different value)
            self.cacheable = False
            tok = object()  # unmatchable placeholder
        self._record("value", name, tok)
        return v

    def get(self, name: str, default: Any = None) -> Any:
        if name not in self._params:
            return default
        return self[name]

    def __contains__(self, name) -> bool:
        return name in self._params

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)

    # -- key material --------------------------------------------------

    def spec_key(self) -> Tuple:
        return tuple((kind, name, tok) for (kind, name), tok
                     in self.specializations.items())

    @staticmethod
    def recompute_spec_key(spec_key: Tuple,
                           params: Mapping[str, Any]) -> Optional[Tuple]:
        """Re-derive a stored entry's specialization tokens from NEW
        parameter bindings (None = not derivable, treat as mismatch)."""
        out = []
        for kind, name, _ in spec_key:
            if kind == "mapkeys":
                v = params.get(name)
                tok: Any = tuple(sorted(v)) if isinstance(v, dict) else None
            else:  # full value
                if name not in params:
                    return None
                tok = _value_token(params[name])
                if tok is None:
                    return None
            out.append((kind, name, tok))
        return tuple(out)


@dataclasses.dataclass
class CachedPlan:
    """One planned query, ready for re-execution with fresh bindings."""
    root: Any                       # R.RelationalOperator
    result_fields: Tuple[str, ...]
    plans: Dict[str, str]           # pretty ir/logical/relational text
    records_graph: Any              # graph for entity materialization
    context: Any                    # the shared RelationalRuntimeContext
    spec_key: Tuple                 # value specializations (see PlanParams)
    cold_phase_s: float             # parse+ir+plan+relational of the cold run
    nbytes: int                     # rough host-side footprint estimate
    #: catalog graphs this plan resolved at planning time, with the
    #: per-name dep token observed then: ((qgn, token), ...).  Lookup
    #: revalidates against the live catalog, so a mutation of graph X
    #: invalidates exactly X's dependents — never the whole cache.
    catalog_deps: Tuple = ()
    #: the query text as run (the fused executor's memo key), so a
    #: retired plan's recorded size streams go with it
    #: (session._maybe_replan)
    query_text: str = ""
    # Serializes executions of THIS plan: the operator tree and its
    # runtime context are shared mutable state (parameter dict, per-op
    # result memos), so concurrent threads that hit the same entry take
    # turns — per-plan, not cache-wide (see session._run_cached).
    exec_lock: threading.Lock = dataclasses.field(
        default_factory=lambda: make_lock("plan_cache.CachedPlan"
                                          ".exec_lock"),
        repr=False, compare=False)


def reset_plan(root) -> None:
    """Clear every operator's memoized (header, table) pair so the tree
    re-executes (idempotent; handles shared subtrees)."""
    seen = set()
    stack = [root]
    while stack:
        op = stack.pop()
        if id(op) in seen:
            continue
        seen.add(id(op))
        op._result = None
        stack.extend(op.children)


def _plan_nbytes(plan: Dict[str, str], root, context=None,
                 catalog_deps=()) -> int:
    """Approximate host bytes a cached plan entry keeps resident: the
    pretty plan texts, a per-operator object estimate, the runtime
    context's retained parameter bindings (rebind swaps them but the
    LAST run's values stay referenced between executions), and the
    catalog-dependency tuples.  The input to ``plan_cache.stats()
    ["bytes"]``."""
    n_ops, seen, stack = 0, set(), [root]
    while stack:
        op = stack.pop()
        if id(op) in seen:
            continue
        seen.add(id(op))
        n_ops += 1
        stack.extend(op.children)
    n = sum(len(s) for s in plan.values()) + 512 * n_ops
    if context is not None:
        try:
            n += sum(len(str(k)) + len(repr(v))
                     for k, v in context.parameters.items())
        except Exception:  # pragma: no cover — accounting must not fail
            pass
    n += 128 * len(catalog_deps)
    return n


class PlanCache:
    """Session-level LRU cache of :class:`CachedPlan` entries.

    Keyed by (normalized query text, graph plan token, parameter
    signature); each key holds the (usually one) plans that differ only
    in recorded value specializations.  Catalog consistency is per-plan,
    not per-key: each plan carries the dep tokens of the catalog graphs
    it resolved (``catalog_deps``), revalidated on lookup — so a catalog
    mutation invalidates exactly its dependents.  LRU order and the size
    cap count individual plans.

    Counters live in a :class:`caps_tpu_torch.obs.metrics.MetricsRegistry`
    (the session passes its own) under ``plan_cache.*``, so they show up
    in ``session.metrics_snapshot()`` beside every other stat;
    :meth:`stats` and the attribute reads (``.hits`` etc.) read the same
    counters."""

    def __init__(self, max_size: int = 256, enabled: bool = True,
                 registry=None):
        from caps_tpu_torch.obs.metrics import MetricsRegistry
        self.max_size = max(1, int(max_size))
        self.enabled = enabled
        self._entries: "OrderedDict[Tuple, List[CachedPlan]]" = OrderedDict()
        self._count = 0
        # Guards _entries, _count and the counters: lookup's LRU
        # move_to_end, store's append+evict, and the catalog-subscription
        # eviction all mutate the OrderedDict and may run on different
        # threads.
        self._lock = make_rlock("plan_cache.PlanCache._lock")
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._hits = self.metrics.counter("plan_cache.hits")
        self._misses = self.metrics.counter("plan_cache.misses")
        self._evictions = self.metrics.counter("plan_cache.evictions")
        # catalog-driven evictions (CATALOG CREATE/DROP, store/delete)
        self._invalidations = self.metrics.counter("plan_cache.invalidations")
        # plans retired by evict_family (the re-plan loop) and by
        # quarantine (the serving tier's failure containment)
        self._quarantined = self.metrics.counter("plan_cache.quarantined")
        # cold-phase seconds skipped by hits
        self._saved_s = self.metrics.counter("plan_cache.saved_s")
        self.metrics.gauge("plan_cache.entries", fn=lambda: self._count)

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def invalidations(self) -> int:
        return self._invalidations.value

    @property
    def saved_s(self) -> float:
        return self._saved_s.value

    @property
    def quarantined(self) -> int:
        return self._quarantined.value

    def lookup(self, key: Tuple, params: Mapping[str, Any],
               catalog=None) -> Optional[CachedPlan]:
        with self._lock:
            plans = self._entries.get(key)
            if plans:
                for plan in list(plans):
                    if plan.catalog_deps and catalog is not None \
                            and any(catalog.dep_token(q) != tok
                                    for q, tok in plan.catalog_deps):
                        # a referenced catalog graph changed since this
                        # plan was made: scoped invalidation — drop just
                        # this plan, the caller replans
                        plans.remove(plan)
                        self._count -= 1
                        self._invalidations.inc()
                        continue
                    if not plan.spec_key:
                        match = True
                    else:
                        match = PlanParams.recompute_spec_key(
                            plan.spec_key, params) == plan.spec_key
                    if match:
                        self._entries.move_to_end(key)
                        self._hits.inc()
                        self._saved_s.inc(plan.cold_phase_s)
                        return plan
                if not plans:
                    del self._entries[key]
            self._misses.inc()
        return None

    def store(self, key: Tuple, plan: CachedPlan) -> None:
        with self._lock:
            plans = self._entries.setdefault(key, [])
            # replace an entry with the same specialization tokens (e.g. a
            # re-plan after the fused executor re-recorded)
            for i, p in enumerate(plans):
                if p.spec_key == plan.spec_key:
                    plans[i] = plan
                    self._entries.move_to_end(key)
                    return
            plans.append(plan)
            self._count += 1
            self._entries.move_to_end(key)
            while self._count > self.max_size and self._entries:
                _, dropped = self._entries.popitem(last=False)
                self._count -= len(dropped)
                self._evictions.inc(len(dropped))

    def quarantine(self, key: Tuple) -> int:
        """Failure containment (serve/): evict every plan under ``key``
        because executions of it keep failing — a poisoned entry would
        otherwise fail every later hit on its key.  Returns the number
        of plans dropped; the next execution re-plans from scratch."""
        with self._lock:
            plans = self._entries.pop(key, None)
            if not plans:
                return 0
            self._count -= len(plans)
            self._quarantined.inc(len(plans))
            return len(plans)

    def evict_family(self, family: str) -> List[CachedPlan]:
        """Divergence-triggered retirement (relational/session.py
        ``_maybe_replan``): drop every cached plan whose key's
        normalized-query-text component is ``family``, counted under
        ``quarantined``, so the next execution re-plans from scratch
        with fresh statistics.  Returns the dropped plans so the caller
        can also retire their fused recordings (a re-planned tree must
        never replay the retired plan's size stream)."""
        dropped: List[CachedPlan] = []
        with self._lock:
            for k in [k for k in self._entries if k[0] == family]:
                plans = self._entries.pop(k)
                self._count -= len(plans)
                self._quarantined.inc(len(plans))
                dropped.extend(plans)
        return dropped

    def evict_dependents(self, qgn=None) -> int:
        """Scoped catalog eviction (the session's catalog subscription):
        drop exactly the plans that resolved the mutated graph ``qgn``
        at planning time.  ``qgn=None`` (a namespace-level change —
        register/deregister) drops every plan with ANY catalog
        dependency.  Plans that never touched the catalog — the vast
        majority of serving traffic — survive untouched."""
        dropped = 0
        with self._lock:
            for k in list(self._entries):
                plans = self._entries[k]
                for plan in list(plans):
                    deps = plan.catalog_deps
                    if deps and (qgn is None
                                 or any(q == qgn for q, _tok in deps)):
                        plans.remove(plan)
                        self._count -= 1
                        self._invalidations.inc()
                        dropped += 1
                if not plans:
                    del self._entries[k]
        return dropped

    def evict_graph(self, graph_token) -> int:
        """Scoped per-graph eviction: drop every plan anchored on this
        graph plan token (key position 1).  The versioned write path
        (relational/updates.py) frees a superseded snapshot's plans the
        moment the next version publishes — no other graph's entries
        are touched."""
        with self._lock:
            n = 0
            for k in [k for k in self._entries if k[1] == graph_token]:
                n += len(self._entries.pop(k))
            self._count -= n
            if n:
                self._invalidations.inc(n)
            return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._count = 0

    @property
    def size(self) -> int:
        return self._count

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": self._count,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "quarantined": self.quarantined,
                "hit_rate": (self.hits / total) if total else 0.0,
                "bytes": sum(p.nbytes for plans in self._entries.values()
                             for p in plans),
                "saved_s": self.saved_s,
            }


class PreparedQuery:
    """A pre-parsed query bound to a session (and optionally a graph):
    the explicit prepared-statement handle for serving workloads.

    ``prepare()`` pays parse once (populating the session-wide parse
    memo) and validates syntax eagerly; every :meth:`run` goes through
    the session plan cache, so after the first execution per parameter
    *signature* the whole frontend is skipped."""

    def __init__(self, session, query: str, graph=None):
        from caps_tpu_torch.frontend.parser import parse_query
        self._session = session
        self._graph = graph
        self.query = query
        parse_query(query)  # eager syntax validation + parse-memo warm

    def run(self, parameters: Optional[Mapping[str, Any]] = None):
        graph = self._graph if self._graph is not None \
            else self._session._ambient
        return self._session.cypher_on_graph(graph, self.query, parameters)

    def __repr__(self):
        return f"PreparedQuery({self.query!r})"
