"""Fleet router: consistent-hash routing with load-aware spill.

A thin, STATELESS process in front of N fleet backends
(serve/fleet.py).  Routing is a consistent hash of ``(graph,
plan-family key)`` over a virtual-node ring — the same family always
lands on the same process, so plan caches, fused replay memos, and the
warm-path store stay hot per process (the fleet-granularity version of
"compiled state never migrates").  The hash is
``blake2b`` — stable across processes and Python builds, unlike the
per-process-randomized builtin ``hash``.

**Load-aware spill.**  Affinity must not let one hot family serialize
the fleet (the JSPIM skew lesson): every reply piggybacks the
backend's queue depth, and the router keeps a windowed view per
backend.  When the primary's last-known depth crosses
``RouterConfig.spill_queue_depth`` — or its SLO burn rate crosses
``spill_burn_rate`` — overflow traffic walks to the next ring node
instead of queueing behind the hot spot.  Spill is bounded: it walks
the preference order, so a family's traffic concentrates on at most a
few adjacent nodes rather than spraying the fleet cold.

**Failover.**  A transport failure marks the backend dead and retries
the SAME request on the next preference node — the ring segment
degrades, nothing rehashes, and the surviving nodes' cache affinity is
untouched (~1/N keys move is the consistent-hash contract, exercised
in tests/test_fleet.py).  A rejoining process is pinged, waits for its
PlanStore warmup, catches up on snapshots, and only then takes
traffic again.

**Writes** go to the single owner backend; the router then ships the
owner's delta snapshot to every live peer (peers pull from the owner
directly — the router only coordinates) and measures the lag
(``fleet.snapshot_lag_s``): the read-your-writes bound a client
observes across the whole fleet.  On a durable fleet
(caps_tpu_torch/durability) owner death triggers an election instead of
read-only mode: the peer with the longest replayed log claims the
epoch-fenced lease, and every write frame carries the router's epoch so
a stale view (or a zombie owner) is fenced, never split-brained.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock, make_rlock
from caps_tpu_torch.obs.metrics import (MetricsRegistry, global_registry,
                                        merge_snapshots)
from caps_tpu_torch.obs.telemetry import RollingHistogram
from caps_tpu_torch.serve.errors import (DeadlineExceeded, FleetUnavailable,
                                         Overloaded, ServeError, ServerClosed,
                                         StaleEpoch, WireError)
from caps_tpu_torch.serve.wire import WireClient

_UNSET = object()

#: per-family latency windows kept for hedge-delay derivation (LRU —
#: same bound discipline as ServingTelemetry's family windows)
_MAX_LATENCY_FAMILIES = 64


def _ring_hash(key: str) -> int:
    """Position on the 64-bit ring — blake2b, NOT the builtin ``hash``
    (which is salted per process: two fleet members would disagree on
    every placement)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``vnodes`` replicas per node smooth placement so each node owns
    ~1/N of the key space; add/remove moves only the segments adjacent
    to the changed node's vnodes (~1/N of keys)."""

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []
        self._keys: List[int] = []
        self._nodes: List[str] = []
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.append(node)
        for i in range(self.vnodes):
            h = _ring_hash(f"{node}#{i}")
            at = bisect.bisect_left(self._points, (h, node))
            self._points.insert(at, (h, node))
        self._keys = [h for h, _ in self._points]

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.remove(node)
        self._points = [(h, n) for h, n in self._points if n != node]
        self._keys = [h for h, _ in self._points]

    def nodes(self) -> Tuple[str, ...]:
        return tuple(self._nodes)

    def lookup(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        at = bisect.bisect_right(self._keys, _ring_hash(key))
        if at == len(self._points):
            at = 0
        return self._points[at][1]

    def preference(self, key: str, n: Optional[int] = None) -> List[str]:
        """Distinct nodes in ring-walk order from ``key``'s position —
        the failover/spill order.  Stable: removing a node leaves the
        relative order of the others unchanged."""
        if not self._points:
            return []
        want = len(self._nodes) if n is None else min(n, len(self._nodes))
        out: List[str] = []
        at = bisect.bisect_right(self._keys, _ring_hash(key))
        for i in range(len(self._points)):
            _h, node = self._points[(at + i) % len(self._points)]
            if node not in out:
                out.append(node)
                if len(out) == want:
                    break
        return out


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    #: virtual nodes per backend on the ring
    vnodes: int = 64
    #: spill when the primary's last-known queue depth reaches this
    spill_queue_depth: int = 8
    #: spill when the primary's fast SLO burn rate reaches this
    #: (telemetry burn > 1.0 already eats budget faster than allowed)
    spill_burn_rate: float = 4.0
    #: distinct ring nodes tried per request before FleetUnavailable
    max_attempts: int = 3
    #: per-call wire timeout
    timeout_s: float = 60.0
    #: how long a failover election waits for the dead owner's lease
    #: TTL to lapse before giving up (durable fleets only)
    failover_wait_s: float = 10.0
    #: hedge reads: when the primary has not replied after the
    #: per-family p99-derived delay, issue the SAME read to the next
    #: preference node — first reply wins, the loser's reply is
    #: discarded (tail tolerance for one slow backend)
    hedge_reads: bool = False
    #: hard bound on the hedged share of reads — hedges stop once
    #: ``router.hedges`` would exceed this fraction of reads routed
    hedge_max_fraction: float = 0.1
    #: fixed hedge delay override (seconds); None derives the delay
    #: from the family's rolling latency window at ``hedge_quantile``
    hedge_delay_s: Optional[float] = None
    #: quantile of the per-family latency window the hedge fires at
    hedge_quantile: float = 0.99


class FleetRouter:
    """Stateless request router over a set of fleet backends."""

    def __init__(self, backends: Dict[str, Tuple[str, int]],
                 owner: Optional[str] = None,
                 config: Optional[RouterConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        if not backends:
            raise FleetUnavailable("router needs at least one backend")
        self.config = config or RouterConfig()
        self.registry = registry if registry is not None \
            else global_registry()
        self._addrs = dict(backends)
        #: the single write owner (snapshot-shipping source); defaults
        #: to the first backend in insertion order
        self.owner = owner if owner is not None else next(iter(backends))
        if self.owner not in self._addrs:
            raise FleetUnavailable(f"owner {self.owner!r} is not a backend")
        #: the lease epoch writes are stamped with (durable fleets):
        #: learned from write acks and failover elections, fenced by the
        #: backends — a router holding a stale view is told so
        self._owner_epoch: Optional[int] = None
        #: the ROUTER lease epoch (serve/ha.py): when this router runs
        #: replicated, its HA wrapper stamps the held epoch here and
        #: every write-coordination frame carries it — a deposed zombie
        #: router is fenced by the backends exactly like a zombie owner
        self.router_epoch: Optional[int] = None
        #: per-family read-latency windows (hedge-delay source) and the
        #: hedge-rate bound's counters — guarded by their own leaf lock
        #: so the hedge race never contends with routing state
        self._latency: "collections.OrderedDict[str, RollingHistogram]" = \
            collections.OrderedDict()
        self._latency_lock = make_lock("router.FleetRouter._latency_lock")
        self._reads_routed = 0
        self._hedges_issued = 0
        self.ring = HashRing(backends.keys(), vnodes=self.config.vnodes)
        self._clients = {name: WireClient(host, port,
                                          timeout_s=self.config.timeout_s)
                         for name, (host, port) in self._addrs.items()}
        self._state = {name: {"live": True, "depth": 0, "burn": 0.0}
                       for name in self._addrs}
        self._last_ship: Dict[str, Any] = {"version": None, "lag_s": None,
                                           "peers": {}}
        self._lock = make_rlock("router.FleetRouter._lock")
        self._live_gauge = self.registry.gauge("fleet.backends_live")
        self._live_gauge.set(float(len(self._addrs)))

    # -- health bookkeeping --------------------------------------------

    def _live_count(self) -> int:
        return sum(1 for s in self._state.values() if s["live"])

    def mark_dead(self, name: str) -> None:
        with self._lock:
            if not self._state[name]["live"]:
                return
            self._state[name]["live"] = False
        self.registry.counter("router.backend_down").inc()
        self._live_gauge.set(float(self._live_count()))
        self._clients[name].close()

    def rejoin(self, name: str, warm_timeout_s: Optional[float] = 30.0,
               port: Optional[int] = None) -> Dict[str, Any]:
        """Readmit ``name`` to its ring segment — but only after the
        process proves it is actually ready: it answers a ping, its
        PlanStore warmup has finished (a cold rejoin taking traffic
        would compile on the client's clock), and its snapshot is
        caught up with the write owner.  Returns the readiness report."""
        with self._lock:
            if port is not None:
                host = self._addrs[name][0]
                self._addrs[name] = (host, port)
                self._clients[name].close()
                self._clients[name] = WireClient(
                    host, port, timeout_s=self.config.timeout_s)
            client = self._clients[name]
        info = client.call("ping")
        warm = client.call("warmup_wait", timeout=warm_timeout_s)
        synced = None
        if name != self.owner and info.get("snapshot_version") is not None:
            ohost, oport = self._addrs[self.owner]
            try:
                synced = client.call("sync_from", host=ohost, port=oport)
            except ServeError:
                self.registry.counter("fleet.ship_failures").inc()
        with self._lock:
            self._state[name] = {"live": True, "depth": 0, "burn": 0.0}
        self.registry.counter("router.rejoined").inc()
        self._live_gauge.set(float(self._live_count()))
        return {"ping": info, "warmup": warm, "synced": synced}

    def _note_reply(self, name: str, reply: Any) -> None:
        if isinstance(reply, dict) and "queue_depth" in reply:
            with self._lock:
                self._state[name]["depth"] = int(reply["queue_depth"])

    def note_burn(self, name: str, burn: float) -> None:
        """Feed a backend's scraped SLO burn rate into spill decisions
        (a health poller calls this from ``health_report``'s fast-burn
        field)."""
        with self._lock:
            self._state[name]["burn"] = float(burn)

    def _overloaded(self, name: str) -> bool:
        s = self._state[name]
        return (s["depth"] >= self.config.spill_queue_depth
                or s["burn"] >= self.config.spill_burn_rate)

    # -- read path -----------------------------------------------------

    @staticmethod
    def routing_key(graph: str, family: Optional[str], query: str) -> str:
        """(graph, plan-family) — the cache-affinity unit.  ``family``
        defaults to the query text, which IS the plan-family key for a
        parameterized workload (parameters don't change the plan)."""
        return f"{graph}|{family if family is not None else query}"

    def _observe_latency(self, key: str, elapsed_s: float) -> None:
        with self._latency_lock:
            hist = self._latency.get(key)
            if hist is None:
                while len(self._latency) >= _MAX_LATENCY_FAMILIES:
                    self._latency.popitem(last=False)
                hist = self._latency[key] = RollingHistogram()
            else:
                self._latency.move_to_end(key)
            hist.observe(clock.now(), elapsed_s)

    def _hedge_delay(self, key: str) -> Optional[float]:
        """The delay after which a read hedges: the configured override,
        else the family window's p99 — None (never hedge) until the
        window has observations, so a cold family cannot hedge off a
        guessed latency."""
        if self.config.hedge_delay_s is not None:
            return float(self.config.hedge_delay_s)
        with self._latency_lock:
            hist = self._latency.get(key)
            if hist is None:
                return None
            q = hist.quantile(clock.now(), self.config.hedge_quantile)
        return q if q is not None and q > 0.0 else None

    def _hedge_allowed(self) -> bool:
        """Honest rate bound: hedges never exceed the configured share
        of reads routed, so tail tolerance cannot silently double the
        fleet's read load."""
        with self._latency_lock:
            return (self._hedges_issued
                    < self.config.hedge_max_fraction
                    * max(1, self._reads_routed))

    def _hedged_call(self, primary: str, hedge_to: Optional[str],
                     fields: Dict[str, Any], delay_s: float,
                     wait_budget_s: float) -> Tuple[str, Any]:
        """Race one read between ``primary`` and (after ``delay_s``
        without a primary reply) ``hedge_to``.  First successful reply
        wins and is the ONLY reply returned — the loser's is discarded,
        never merged, so results cannot duplicate.  A backend whose leg
        died at the transport level is marked dead here (health is
        honest even when the other leg wins).  Raises the primary leg's
        error when no leg succeeds."""
        results: List[Tuple[str, bool, Any]] = []
        arrived = threading.Event()
        results_lock = make_lock("router.FleetRouter._hedged_call.results_lock")

        def leg(name: str) -> None:
            try:
                item = (name, True, self._clients[name].call(
                    "query", **fields))
            except BaseException as ex:
                item = (name, False, ex)
            with results_lock:
                results.append(item)
                arrived.set()

        threading.Thread(target=leg, args=(primary,), daemon=True,
                         name="caps-router-read").start()
        t0 = clock.now()
        hedged = False
        errors: Dict[str, BaseException] = {}
        legs = 1
        while True:
            with results_lock:
                batch, results[:] = list(results), []
                arrived.clear()
            for name, ok, value in batch:
                if ok:
                    if hedged and name != primary:
                        self.registry.counter("router.hedge_wins").inc()
                    return name, value
                errors[name] = value
                if isinstance(value, (WireError, ServerClosed)):
                    self.mark_dead(name)
            if len(errors) == legs:
                if not hedged and hedge_to is not None \
                        and self._hedge_allowed():
                    # the primary leg FAILED before the hedge delay:
                    # fall through and launch the hedge immediately —
                    # it is now the only leg left
                    pass
                else:
                    raise errors.get(primary,
                                     next(iter(errors.values())))
            elapsed = clock.now() - t0
            if elapsed >= wait_budget_s:
                raise DeadlineExceeded("route", wait_budget_s, elapsed)
            if not hedged and hedge_to is not None \
                    and (elapsed >= delay_s or primary in errors) \
                    and self._hedge_allowed():
                hedged = True
                legs += 1
                with self._latency_lock:
                    self._hedges_issued += 1
                self.registry.counter("router.hedges").inc()
                threading.Thread(target=leg, args=(hedge_to,),
                                 daemon=True,
                                 name="caps-router-hedge").start()
            elif len(errors) == legs:
                raise errors.get(primary, next(iter(errors.values())))
            horizon = wait_budget_s - elapsed
            if not hedged and hedge_to is not None:
                horizon = min(horizon, max(delay_s - elapsed, 0.0))
            clock.wait(arrived, max(horizon, 0.001))

    def query(self, query: str,
              parameters: Optional[Dict[str, Any]] = None, *,
              family: Optional[str] = None, graph: str = "default",
              deadline_s: Any = _UNSET, priority: Optional[int] = None,
              digest: bool = False) -> Dict[str, Any]:
        """Route one read.  The reply dict carries ``rows`` plus the
        backend's ledger/snapshot_version/queue_depth and the name it
        ran on (``backend``).  Raises the backend's typed error
        verbatim, or :class:`FleetUnavailable` when every candidate
        ring node failed at the transport level.

        **Deadline fidelity**: ``deadline_s`` is the caller's TOTAL
        budget, stamped at admission on ``obs.clock``.  Every hop —
        spill, failover retry, hedge — forwards the *remaining* budget
        recomputed from that stamp, never the original figure, so a
        2-hop failover cannot silently double the caller's wall budget.

        **Hedged reads** (``RouterConfig.hedge_reads``): after the
        family's p99-derived delay without a primary reply the read is
        ALSO issued to the next preference node; first reply wins, the
        loser is discarded.  Hedges are rate-bounded
        (``hedge_max_fraction``) and counted (``router.hedges`` /
        ``router.hedge_wins``) — a hedge win is one served request,
        never two."""
        key = self.routing_key(graph, family, query)
        admitted = clock.now()
        budget = (float(deadline_s)
                  if deadline_s is not _UNSET and deadline_s is not None
                  else None)
        prefs = self.ring.preference(key)
        candidates = [n for n in prefs if self._state[n]["live"]]
        if not candidates:
            raise FleetUnavailable("no live backends on the ring")
        if len(candidates) > 1 and self._overloaded(candidates[0]):
            # bounded spill: overflow walks to the NEXT ring node — the
            # hot family warms exactly one extra cache, not the fleet
            self.registry.counter("router.spilled").inc()
            candidates = candidates[1:] + candidates[:1]
        candidates = candidates[:max(1, self.config.max_attempts)]
        fields: Dict[str, Any] = {"query": query,
                                  "params": parameters or {}}
        if deadline_s is not _UNSET:
            fields["deadline_s"] = deadline_s
        if priority is not None:
            fields["priority"] = priority
        if digest:
            fields["digest"] = True
        with self._latency_lock:
            self._reads_routed += 1
        hint = 0.0
        for i, name in enumerate(candidates):
            if i:
                self.registry.counter("router.retries").inc()
            if budget is not None:
                elapsed = clock.now() - admitted
                if budget - elapsed <= 0.0:
                    raise DeadlineExceeded("route", budget, elapsed)
                # forward the REMAINING budget, not the original: the
                # backend's admission clock starts fresh per hop, so a
                # verbatim resend would extend the caller's deadline
                fields["deadline_s"] = budget - elapsed
            started = clock.now()
            hedge_to = None
            if self.config.hedge_reads and i + 1 < len(candidates):
                hedge_to = candidates[i + 1]
            try:
                if hedge_to is not None:
                    delay = self._hedge_delay(key)
                    if delay is None:
                        hedge_to = None
                if hedge_to is not None:
                    wait = (budget - (clock.now() - admitted)
                            if budget is not None
                            else self.config.timeout_s)
                    name, reply = self._hedged_call(
                        name, hedge_to, fields, delay, wait)
                else:
                    reply = self._clients[name].call("query", **fields)
            except (WireError, ServerClosed):
                # the process is gone (or lame-duck draining): degrade
                # its ring segment and retry the request on the next
                # node — in-flight work on a dead backend requeues here
                self.mark_dead(name)
                continue
            except Overloaded as ex:
                self._note_reply(name, {"queue_depth": ex.queue_depth})
                hint = max(hint, ex.retry_after_s)
                self.registry.counter("router.spilled").inc()
                continue
            self._observe_latency(key, clock.now() - started)
            self._note_reply(name, reply)
            self.registry.counter("router.requests").inc()
            if isinstance(reply, dict):
                reply["backend"] = name
            return reply
        raise FleetUnavailable(
            f"all {len(candidates)} candidate backends failed for "
            f"key {key!r}", retry_after_s=hint)

    # -- write path + snapshot shipping --------------------------------

    def write(self, query: str,
              parameters: Optional[Dict[str, Any]] = None, *,
              ship: bool = True,
              deadline_s: Any = _UNSET) -> Dict[str, Any]:
        """Route one write to the owner, then ship its post-commit
        snapshot to every live peer.  The reply carries the committed
        ``version`` and the shipping report (per-peer version + lag).

        **Failover** (durable fleets): when the owner is dead, the
        router elects the live peer with the longest replayed log and
        has it claim the epoch-fenced lease (waiting out the dead
        owner's TTL), then retries the write there.  Every write frame
        carries the router's known epoch, so a stale ownership view is
        fenced by the backend (:class:`StaleEpoch`) and corrected from
        the error's fields.  Non-durable fleets keep the legacy
        behavior: owner death makes the fleet read-only until rejoin.

        ``deadline_s`` is the caller's TOTAL budget (admission-stamped
        here): the failover retry forwards the remaining budget, never
        the original figure.  When this router runs replicated
        (serve/ha.py) every frame also carries its ``router_epoch`` —
        a deposed zombie router's coordination is fenced by the
        backends."""
        admitted = clock.now()
        budget = (float(deadline_s)
                  if deadline_s is not _UNSET and deadline_s is not None
                  else None)
        if not self._state[self.owner]["live"]:
            if not self._failover_owner():
                raise FleetUnavailable(
                    f"write owner {self.owner!r} is down — the fleet is "
                    f"read-only until it rejoins")
        for attempt in (0, 1):
            fields: Dict[str, Any] = {"query": query,
                                      "params": parameters or {}}
            if budget is not None:
                elapsed = clock.now() - admitted
                if budget - elapsed <= 0.0:
                    raise DeadlineExceeded("route", budget, elapsed)
                fields["deadline_s"] = budget - elapsed
            elif deadline_s is not _UNSET:
                fields["deadline_s"] = deadline_s
            if self._owner_epoch is not None:
                fields["epoch"] = self._owner_epoch
            if self.router_epoch is not None:
                fields["router_epoch"] = self.router_epoch
            try:
                reply = self._clients[self.owner].call("write", **fields)
            except WireError:
                dead = self.owner
                self.mark_dead(dead)
                if attempt or not self._failover_owner():
                    raise FleetUnavailable(
                        f"write owner {dead!r} failed mid-write")
                continue
            except StaleEpoch as ex:
                # the lease names the true owner — adopt and retry once
                self.registry.counter("router.stale_epochs").inc()
                if (attempt or ex.owner is None
                        or ex.owner not in self._addrs
                        or not self._state[ex.owner]["live"]):
                    raise
                with self._lock:
                    self.owner = ex.owner
                    self._owner_epoch = ex.lease_epoch
                continue
            if isinstance(reply, dict) and reply.get("epoch") is not None:
                self._owner_epoch = int(reply["epoch"])
            self._note_reply(self.owner, reply)
            self.registry.counter("router.writes").inc()
            if ship:
                reply["ship"] = self.ship_snapshots()
            return reply
        raise FleetUnavailable(  # pragma: no cover — loop always exits
            f"write owner {self.owner!r} failed mid-write")

    def _failover_owner(self) -> bool:
        """Elect a new write owner after owner death (durable fleets):
        the live peer with the longest replayed log wins (max snapshot
        version, ties by name), replays every backend's WAL tail from
        the shared store, and claims the epoch-fenced lease — polling
        until the dead owner's TTL lapses.  False when the fleet has no
        durability (legacy read-only-until-rejoin) or nobody can win."""
        candidates = []
        for name in sorted(self._addrs):
            if name == self.owner or not self._state[name]["live"]:
                continue
            try:
                version = self._clients[name].call(
                    "ping").get("snapshot_version")
            except WireError:
                self.mark_dead(name)
                continue
            if version is not None:
                candidates.append((-int(version), name))
        # deterministic election order: longest replayed log first,
        # equal logs broken LEXICOGRAPHICALLY by backend name — repeated
        # elections under chaos reproduce the same winner (the router
        # takeover in serve/ha.py elects by the same rule)
        candidates.sort()
        for _neg_version, name in candidates:
            try:
                out = self._clients[name].call(
                    "acquire_lease", wait_s=self.config.failover_wait_s)
            except WireError:
                self.mark_dead(name)
                continue
            if not out.get("durable"):
                return False  # no lease machinery anywhere in this fleet
            if out.get("epoch") is None:
                continue  # lost the epoch CAS — try the next-longest log
            with self._lock:
                self.owner = name
                self._owner_epoch = int(out["epoch"])
            self.registry.counter("router.failovers").inc()
            return True
        return False

    def ship_snapshots(self) -> Dict[str, Any]:
        """Bring every live peer current with the owner: each peer
        pulls the owner's delta (peer→owner direct; the router only
        coordinates) and flips its version atomically.  Records the
        measured lag — commit-to-everywhere-visible — in
        ``fleet.snapshot_lag_s``."""
        ohost, oport = self._addrs[self.owner]
        started = clock.now()
        peers: Dict[str, Any] = {}
        for name, state in list(self._state.items()):
            if name == self.owner or not state["live"]:
                continue
            try:
                out = self._clients[name].call("sync_from",
                                               host=ohost, port=oport)
                peers[name] = out.get("version")
            except WireError:
                self.registry.counter("fleet.ship_failures").inc()
                self.mark_dead(name)
            except ServeError:
                # typed refusal (e.g. non-versioned peer) — the peer is
                # alive, it just cannot replicate this graph
                self.registry.counter("fleet.ship_failures").inc()
        lag = clock.now() - started
        self.registry.gauge("fleet.snapshot_lag_s").set(lag)
        self.registry.counter("fleet.snapshots_shipped").inc(len(peers))
        with self._lock:
            self._last_ship = {"lag_s": lag, "peers": peers}
        return {"lag_s": lag, "peers": peers}

    # -- fleet-wide observability --------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            backends = {name: dict(state)
                        for name, state in self._state.items()}
        return {"owner": self.owner,
                "ring_nodes": list(self.ring.nodes()),
                "live": self._live_count(),
                "backends": backends,
                "last_ship": dict(self._last_ship)}

    def snapshot_report(self) -> Dict[str, Any]:
        """Owner + per-peer snapshot versions (a direct ping each) and
        the last measured shipping lag."""
        versions: Dict[str, Any] = {}
        for name, state in self._state.items():
            if not state["live"]:
                continue
            try:
                versions[name] = self._clients[name].call(
                    "ping").get("snapshot_version")
            except WireError:
                self.mark_dead(name)
        return {"owner": self.owner,
                "versions": versions,
                "lag_s": self._last_ship.get("lag_s")}

    def metrics_text(self) -> str:
        """ONE Prometheus scrape for the whole fleet: the router's own
        ``router.*``/``fleet.*`` series, plus every live backend's
        registry snapshot summed across processes
        (:func:`~caps_tpu_torch.obs.metrics.merge_snapshots`)."""
        snaps = []
        for name, state in list(self._state.items()):
            if not state["live"]:
                continue
            try:
                snaps.append(self._clients[name].call("metrics_snapshot"))
            except WireError:
                self.mark_dead(name)
        return self.registry.expose_text(extra=merge_snapshots(snaps))

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
