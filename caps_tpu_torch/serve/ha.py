"""Router high availability: epoch-fenced active/standby replication.

The fleet gives every *backend* a failover story — durable WALs, an
epoch-fenced write lease, election by longest replayed log — but the
router itself stayed a single process: kill it and the fleet goes dark
with every backend healthy.  This module closes that last single point
of failure with the SAME machinery, one layer up:

* **Router lease.**  N :class:`HARouter` processes share the fleet's
  durable directory and contend for a second
  :class:`~caps_tpu_torch.durability.lease.LeaseStore` namespace
  (``lease-router`` — same CAS-through-``O_EXCL``-claim-files epoch
  fence as the write lease, independent epochs).  Exactly one router is
  **active** at a time; the rest are **standbys** polling the lease.

* **Takeover.**  When the active's TTL lapses, the first standby to win
  the epoch CAS becomes active and rebuilds its routing state from
  shared truth, not from the dead peer: the write lease file names the
  current owner and epoch, ``scan_durable_dir`` names the highest
  durable version, and a ``ping`` probe per backend establishes
  liveness — router state is host-only metadata, so
  nothing compiled migrates and takeover costs milliseconds.

* **Zombie fencing.**  The active router stamps its router-lease epoch
  on every write-coordination frame
  (:attr:`FleetRouter.router_epoch`); backends compare it against the
  published router lease and refuse older stamps with the typed
  :class:`~caps_tpu_torch.serve.errors.StaleEpoch` — a deposed active that
  missed its own deposition can coordinate nothing, exactly like a
  zombie write owner.

* **RouterSet.**  The client facade: callers see availability, not
  topology.  It walks the router set, fails over on
  :class:`~caps_tpu_torch.serve.errors.WireError`, retries standby refusals
  until the takeover lands (bounded by its wait budget), and adopts the
  active a :class:`StaleEpoch` names.

Determinism: the control loop is a public :meth:`HARouter.step` — the
background thread just calls it on a ``clock``-disciplined cadence, so
fake-clock tests drive elections one step at a time with zero real
waiting.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

from caps_tpu_torch.durability.lease import ROUTER_LEASE_NAME, LeaseStore
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_rlock
from caps_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from caps_tpu_torch.serve import wire
from caps_tpu_torch.serve.errors import (FleetUnavailable, QueryFailed,
                                         ServeError, ServerClosed,
                                         StaleEpoch, WireError)
from caps_tpu_torch.serve.router import FleetRouter, RouterConfig
from caps_tpu_torch.serve.wire import WireClient

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class RouterSpec:
    """Declarative description of one replicated router — everything a
    fresh process needs to join the router set."""

    #: lease identity (stable across restarts)
    name: str
    #: backend address map: name -> (host, port)
    backends: Dict[str, Tuple[str, int]]
    #: the fleet's shared durable directory — the router lease and the
    #: write lease both live here
    durable_dir: str
    #: initial write owner hint; None defaults to the first backend
    owner: Optional[str] = None
    #: router-lease TTL: how long after the active's last renewal a
    #: standby may take over (the read-availability gap bound)
    lease_ttl_s: float = 2.0
    #: control-loop cadence (renew / poll-for-takeover)
    poll_s: float = 0.25
    #: forwarded into RouterConfig
    failover_wait_s: float = 10.0
    timeout_s: float = 60.0
    hedge_reads: bool = False
    hedge_max_fraction: float = 0.1
    hedge_delay_s: Optional[float] = None
    host: str = "127.0.0.1"
    #: 0 = ephemeral (the listener reports the bound port)
    port: int = 0

    def to_json(self) -> str:
        raw = dataclasses.asdict(self)
        raw["backends"] = {n: list(hp) for n, hp in self.backends.items()}
        return json.dumps(raw, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RouterSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        raw = json.loads(text)
        raw["backends"] = {n: (str(hp[0]), int(hp[1]))
                           for n, hp in raw.get("backends", {}).items()}
        return cls(**{k: v for k, v in raw.items() if k in fields})


class HARouter:
    """One replicated router process: a :class:`FleetRouter` behind a
    wire listener, holding (or contending for) the router lease."""

    def __init__(self, spec: RouterSpec, start: bool = True,
                 control: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        self.spec = spec
        self.registry = registry if registry is not None \
            else global_registry()
        self.lease = LeaseStore(spec.durable_dir, ttl_s=spec.lease_ttl_s,
                                lease_name=ROUTER_LEASE_NAME,
                                registry=self.registry)
        self.router = FleetRouter(
            dict(spec.backends), owner=spec.owner,
            config=RouterConfig(failover_wait_s=spec.failover_wait_s,
                                timeout_s=spec.timeout_s,
                                hedge_reads=spec.hedge_reads,
                                hedge_max_fraction=spec.hedge_max_fraction,
                                hedge_delay_s=spec.hedge_delay_s),
            registry=self.registry)
        #: "active" holds the router lease; "standby" polls it.  The
        #: held epoch mirrors into ``router.router_epoch`` so every
        #: write frame carries it (the zombie fence's stamp).
        self.role = "standby"
        self.epoch: Optional[int] = None
        # re-entrant: step() runs under it and calls _demote/_takeover
        self._lock = make_rlock("ha.HARouter._lock")
        self._active_gauge = self.registry.gauge("router.ha_active")
        self._active_gauge.set(0.0)
        self._shutting_down = threading.Event()
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._control_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        if start:
            self.start(control=control)

    # -- lease control --------------------------------------------------

    def step(self) -> str:
        """ONE control-loop iteration: the active renews (demoting
        itself the moment renewal is refused — a deposed router must
        stop coordinating before its next write), a standby tries the
        epoch CAS and takes over on success.  Returns the role after
        the step; deterministic tests call this directly."""
        with self._lock:
            if self.role == "active":
                if not self.lease.renew(self.spec.name):
                    self.registry.counter("router.ha_renew_failures").inc()
                    self._demote()
                return self.role
            current = self.lease.read()
            if current is not None and not self.lease.expired(current) \
                    and current["owner"] != self.spec.name:
                return self.role
            epoch = self.lease.acquire(self.spec.name)
            if epoch is not None:
                self._takeover(epoch)
            return self.role

    def _demote(self) -> None:
        self.role = "standby"
        self.epoch = None
        self.router.router_epoch = None
        self._active_gauge.set(0.0)
        self.registry.counter("router.ha_demotions").inc()

    def _takeover(self, epoch: int) -> None:
        """Become active at ``epoch`` and rebuild routing state from
        shared truth: the write lease names the current owner (and its
        epoch), and a ping probe per backend establishes liveness and
        snapshot versions — never trust the dead peer's view.  Probe
        results tie-break exactly like the owner election (longest
        replayed log, then lexicographic name), so repeated takeovers
        under chaos are reproducible."""
        self.role = "active"
        self.epoch = int(epoch)
        self.router.router_epoch = self.epoch
        write_lease = LeaseStore(self.spec.durable_dir,
                                 ttl_s=self.spec.lease_ttl_s,
                                 registry=self.registry).read()
        probes: List[Tuple[int, str]] = []
        for name in sorted(self.spec.backends):
            try:
                info = self.router._clients[name].call("ping")
            except (WireError, ServerClosed):
                self.router.mark_dead(name)
                continue
            with self.router._lock:
                self.router._state[name] = {"live": True, "depth": 0,
                                            "burn": 0.0}
            version = info.get("snapshot_version")
            probes.append((-int(version if version is not None else 0),
                           name))
        if write_lease is not None \
                and write_lease["owner"] in self.spec.backends:
            with self.router._lock:
                self.router.owner = write_lease["owner"]
                self.router._owner_epoch = int(write_lease["epoch"])
        elif probes:
            # no published write lease: adopt the deterministic
            # election order's head as the owner hint (the first write
            # will elect for real through acquire_lease)
            probes.sort()
            with self.router._lock:
                self.router.owner = probes[0][1]
        self.registry.counter("router.ha_takeovers").inc()
        self._active_gauge.set(1.0)

    def _control_loop(self) -> None:
        while not self._shutting_down.is_set():
            try:
                self.step()
            except OSError:  # pragma: no cover — shared-store hiccup
                self.registry.counter("router.ha_step_errors").inc()
            clock.wait(self._shutting_down, self.spec.poll_s)

    # -- listener (same shape as FleetBackend's) ------------------------

    def start(self, control: bool = True) -> int:
        with self._lock:
            if self._listener is not None:
                return self.port
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((self.spec.host, self.spec.port))
            listener.listen(64)
            self._listener = listener
            self.port = listener.getsockname()[1]
            t = threading.Thread(target=self._accept_loop,
                                 name=f"caps-harouter-{self.spec.name}",
                                 daemon=True)
            self._accept_thread = t
            t.start()
            if control:
                ct = threading.Thread(
                    target=self._control_loop,
                    name=f"caps-harouter-control-{self.spec.name}",
                    daemon=True)
                self._control_thread = ct
                ct.start()
            return self.port

    def _accept_loop(self) -> None:
        while not self._shutting_down.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed — shutdown
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            t = threading.Thread(
                target=wire.serve_connection,
                args=(conn, self.handle, self._shutting_down),
                name=f"caps-harouter-conn-{self.spec.name}", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def shutdown(self) -> None:
        """Stop the listener, control loop, and backend clients.  Safe
        to call twice.  Does NOT release the lease early — the TTL is
        the failure-detection contract, and a clean shutdown should
        look exactly like a crash to the standbys (one code path)."""
        self._shutting_down.set()
        with self._lock:
            listener, self._listener = self._listener, None
        if listener is not None:
            for fn in (lambda: listener.shutdown(socket.SHUT_RDWR),
                       listener.close):
                try:
                    fn()
                except OSError:  # pragma: no cover — teardown must not raise
                    pass
        for conn in self._conns:
            for fn in (lambda c=conn: c.shutdown(socket.SHUT_RDWR),
                       conn.close):
                try:
                    fn()
                except OSError:  # pragma: no cover — teardown must not raise
                    pass
        for t in (self._accept_thread, self._control_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5.0)
        for t in self._conn_threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        self.router.close()

    # -- op dispatch ----------------------------------------------------

    def handle(self, msg: Dict[str, Any]) -> Any:
        op = msg.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise QueryFailed(f"unknown router op {op!r}")
        return fn(msg)

    def _refuse_standby(self) -> None:
        """A standby refuses traffic — serving reads off a stale
        liveness view would be silent, serving writes would split
        coordination.  The refusal names the takeover horizon so
        clients back off for at most ~1 TTL."""
        self.registry.counter("router.ha_standby_refusals").inc()
        raise FleetUnavailable(
            f"router {self.spec.name!r} is standby — the active router "
            f"holds the lease",
            retry_after_s=min(self.spec.lease_ttl_s, 1.0))

    def _op_ping(self, msg) -> Dict[str, Any]:
        return {"name": self.spec.name, "pid": os.getpid(),
                "role": self.role, "epoch": self.epoch,
                "owner": self.router.owner}

    def _query_kwargs(self, msg) -> Dict[str, Any]:
        kwargs: Dict[str, Any] = {}
        if "deadline_s" in msg:
            kwargs["deadline_s"] = msg["deadline_s"]
        if msg.get("priority") is not None:
            kwargs["priority"] = int(msg["priority"])
        return kwargs

    def _op_query(self, msg) -> Dict[str, Any]:
        if self.role != "active":
            self._refuse_standby()
        kwargs = self._query_kwargs(msg)
        if msg.get("family") is not None:
            kwargs["family"] = str(msg["family"])
        return self.router.query(msg.get("query", ""),
                                 msg.get("params") or {},
                                 graph=str(msg.get("graph", "default")),
                                 digest=bool(msg.get("digest")), **kwargs)

    def _op_write(self, msg) -> Dict[str, Any]:
        if self.role != "active":
            self._refuse_standby()
        kwargs = self._query_kwargs(msg)
        kwargs.pop("priority", None)
        return self.router.write(msg.get("query", ""),
                                 msg.get("params") or {},
                                 ship=bool(msg.get("ship", True)), **kwargs)

    def _op_stats(self, msg) -> Dict[str, Any]:
        out = self.router.stats()
        out["role"] = self.role
        out["epoch"] = self.epoch
        return out

    def _op_metrics_snapshot(self, msg) -> Dict[str, Any]:
        return self.registry.snapshot()

    def _op_metrics_text(self, msg) -> str:
        return self.router.metrics_text()

    def _op_step(self, msg) -> Dict[str, Any]:
        """Drive one control iteration over the wire — a chaos soak
        steers subprocess routers deterministically with this."""
        return {"role": self.step(), "epoch": self.epoch}

    def _op_shutdown(self, msg) -> Dict[str, Any]:
        threading.Thread(target=self.shutdown,
                         name=f"caps-harouter-shutdown-{self.spec.name}",
                         daemon=True).start()
        return {"closing": True}


class RouterSet:
    """The client facade over a replicated router set: callers see one
    endpoint's availability, not the topology behind it.

    Transport failures (:class:`WireError` — the active died) and
    standby refusals (:class:`FleetUnavailable`) rotate to the next
    router and retry until ``wait_s`` lapses — one takeover TTL is
    inside that budget by construction, so a SIGKILLed active costs a
    bounded availability dip, not an outage.  A :class:`StaleEpoch`
    naming a router in the set adopts it as preferred and retries; any
    other typed error propagates verbatim (availability machinery must
    never mask application errors)."""

    def __init__(self, routers: Dict[str, Tuple[str, int]], *,
                 timeout_s: float = 30.0, wait_s: float = 10.0,
                 poll_s: float = 0.05,
                 registry: Optional[MetricsRegistry] = None):
        if not routers:
            raise FleetUnavailable("RouterSet needs at least one router")
        self.registry = registry if registry is not None \
            else global_registry()
        self.wait_s = float(wait_s)
        self.poll_s = float(poll_s)
        self._clients = {name: WireClient(host, port, timeout_s=timeout_s)
                         for name, (host, port) in routers.items()}
        self._order = list(routers)
        self._preferred = self._order[0]

    def _rotation(self) -> List[str]:
        at = self._order.index(self._preferred)
        return self._order[at:] + self._order[:at]

    def _call(self, op: str, fields: Dict[str, Any],
              wait_s: Optional[float] = None) -> Any:
        budget = self.wait_s if wait_s is None else float(wait_s)
        admitted = clock.now()
        last_err: Optional[ServeError] = None
        while True:
            for name in self._rotation():
                try:
                    reply = self._clients[name].call(op, **fields)
                except (WireError, ServerClosed) as ex:
                    # the router process is gone: fail over to the
                    # standby (counted — availability is never free)
                    last_err = ex
                    self.registry.counter(
                        "router.ha_client_failovers").inc()
                    continue
                except FleetUnavailable as ex:
                    # a standby refusing, or a fleet-level outage the
                    # NEXT router may see past — rotate, then wait out
                    # the takeover horizon
                    last_err = ex
                    continue
                except StaleEpoch as ex:
                    if ex.owner is not None and ex.owner in self._clients:
                        self._preferred = ex.owner
                        last_err = ex
                        continue
                    raise
                if self._preferred != name:
                    self._preferred = name
                return reply
            elapsed = clock.now() - admitted
            if elapsed >= budget:
                raise last_err if last_err is not None else \
                    FleetUnavailable("no router answered")
            clock.sleep(min(self.poll_s, max(budget - elapsed, 0.0)))

    def query(self, query: str,
              parameters: Optional[Dict[str, Any]] = None, *,
              family: Optional[str] = None, graph: str = "default",
              deadline_s: Any = _UNSET, priority: Optional[int] = None,
              digest: bool = False,
              wait_s: Optional[float] = None) -> Dict[str, Any]:
        fields: Dict[str, Any] = {"query": query,
                                  "params": parameters or {},
                                  "graph": graph}
        if family is not None:
            fields["family"] = family
        if deadline_s is not _UNSET:
            fields["deadline_s"] = deadline_s
        if priority is not None:
            fields["priority"] = priority
        if digest:
            fields["digest"] = True
        return self._call("query", fields, wait_s)

    def write(self, query: str,
              parameters: Optional[Dict[str, Any]] = None, *,
              ship: bool = True, deadline_s: Any = _UNSET,
              wait_s: Optional[float] = None) -> Dict[str, Any]:
        fields: Dict[str, Any] = {"query": query,
                                  "params": parameters or {},
                                  "ship": ship}
        if deadline_s is not _UNSET:
            fields["deadline_s"] = deadline_s
        return self._call("write", fields, wait_s)

    def active(self) -> Optional[str]:
        """Probe the set: the name of the router reporting active, or
        None when nobody does (mid-takeover)."""
        for name in self._rotation():
            try:
                info = self._clients[name].call("ping")
            except (WireError, ServerClosed):
                continue
            if info.get("role") == "active":
                self._preferred = name
                return name
        return None

    def stats(self) -> Dict[str, Any]:
        return self._call("stats", {})

    def close(self) -> None:
        for client in self._clients.values():
            client.close()


# -- process entry point ------------------------------------------------


def router_main(spec_json: str) -> None:  # pragma: no cover — child
    """Entry point of a spawned router process: build the router,
    report the bound port on stdout, serve until killed."""
    router = HARouter(RouterSpec.from_json(spec_json))
    print(f"CAPS_ROUTER_PORT {router.port}", flush=True)
    try:
        router._shutting_down.wait()
    except KeyboardInterrupt:
        pass
    router.shutdown()


def spawn_router(spec: RouterSpec,
                 env: Optional[Dict[str, str]] = None,
                 timeout_s: float = 120.0):
    """Launch ``python -m caps_tpu_torch.serve.ha`` with ``spec`` and
    wait for its port line.  Returns ``(process, port)``; the caller owns
    the process (terminate/kill/wait) — the chaos soak SIGKILLs the
    active one.  Same child discipline as ``spawn_backend``
    (serve/fleet.py ``spawn_child``: a new interpreter, stderr kept)."""
    from caps_tpu_torch.serve.fleet import spawn_child
    return spawn_child("caps_tpu_torch.serve.ha", spec.to_json(),
                       "CAPS_ROUTER_PORT", f"router {spec.name!r}",
                       env=env, timeout_s=timeout_s)


if __name__ == "__main__":  # pragma: no cover — child process
    router_main(sys.argv[1])
