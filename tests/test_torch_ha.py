"""Router high availability in the port (serve/ha.py): the counterpart
of ``tests/test_ha.py`` with ``backend="cpu"`` backends — epoch-fenced
active/standby routers, end-to-end deadline budgets, and hedged-read
tail tolerance — plus the cross-package checks: a router lease claimed
by one package's ``HARouter`` fences the other's, and the spec's JSON
round-trips between them.

The contracts under test:

* the router lease — a SECOND ``LeaseStore`` namespace
  (``lease-router``) in the fleet's shared durable directory: exactly
  one ``HARouter`` steps to active, a live lease blocks the rival, and
  takeover after the TTL claims a HIGHER epoch;
* takeover rebuilds from shared truth — the new active adopts the
  write-lease owner (and epoch) from the store, never the dead peer's
  view, and with no published write lease the owner hint follows the
  SAME deterministic election order as the owner failover: longest
  replayed log, ties broken lexicographically by name (both insertion
  orders tested);
* zombie fencing — a deposed active's write frames carry its stale
  ``router_epoch`` and die on the backend with :class:`StaleEpoch`
  naming the surviving router, applying nothing; the zombie demotes
  itself at its next ``step()``;
* ``RouterSet`` — the client facade fails over on :class:`WireError`
  and retries standby refusals (:class:`FleetUnavailable`) until the
  takeover lands, within its wait budget;
* deadline fidelity — ``deadline_s`` is admission-stamped on
  ``obs.clock`` and every hop forwards the REMAINING budget; a 2-hop
  failover (read and write paths, on a fake clock) arrives at the
  second hop with the first hop's stall already deducted, and an
  exhausted budget raises the typed :class:`DeadlineExceeded` without
  touching the next backend;
* hedged reads — after the configured (or p99-learned) delay the read
  races the next ring node, the first reply wins and the loser is
  discarded (no duplication: the hedged reply equals the quiet one),
  a cold family never hedges off a guessed latency, and
  ``hedge_max_fraction`` rate-bounds ``router.hedges``.
"""
from __future__ import annotations

import threading
import time

import pytest

from caps_tpu_torch.durability.lease import ROUTER_LEASE_NAME, LeaseStore
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.metrics import MetricsRegistry
from caps_tpu_torch.serve.errors import (DeadlineExceeded, FleetUnavailable,
                                         StaleEpoch, WireError)
from caps_tpu_torch.serve.fleet import BackendSpec, FleetBackend
from caps_tpu_torch.serve.ha import HARouter, RouterSet, RouterSpec
from caps_tpu_torch.serve.router import FleetRouter, RouterConfig
from caps_tpu_torch.serve.wire import WireClient
from caps_tpu_torch.testing.chaos import slow_backend

PEOPLE = """
    CREATE (a:Person {name: 'Alice', age: 33}),
           (b:Person {name: 'Bob', age: 44}),
           (c:Person {name: 'Carol', age: 27})
"""
Q_NAMES = "MATCH (p:Person) RETURN p.name AS n ORDER BY n"
NAMES = ["Alice", "Bob", "Carol"]


class FakeClock:
    """Monotonic fake for caps_tpu_torch.obs.clock (the test_faults idiom):
    ``sleep`` advances ``now`` instantly; ``wait`` honors a fired event
    and otherwise advances like a sleep."""

    def __init__(self, t0: float = 1_000.0):
        self._t = t0
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, s: float) -> None:
        with self._lock:
            self._t += s

    def wait(self, event, timeout: float) -> bool:
        if event.is_set():
            return True
        self.sleep(timeout)
        return event.is_set()

    def advance(self, s: float) -> None:
        with self._lock:
            self._t += s


@pytest.fixture()
def fake_clock(monkeypatch):
    fc = FakeClock()
    monkeypatch.setattr(clock, "now", fc.now)
    monkeypatch.setattr(clock, "sleep", fc.sleep)
    monkeypatch.setattr(clock, "wait", fc.wait)
    return fc


def _backend_spec(name, store=None):
    return BackendSpec(name=name, backend="cpu",
                       graph={"kind": "script", "create": PEOPLE},
                       versioned=True,
                       durable_dir=store, wal_fsync="always",
                       lease_ttl_s=0.3)


def _router_spec(name, backends, store, **kw):
    kw.setdefault("lease_ttl_s", 0.3)
    kw.setdefault("failover_wait_s", 5.0)
    return RouterSpec(name=name, backends=backends, durable_dir=store,
                      owner="b0", **kw)


@pytest.fixture
def ha_fleet(tmp_path):
    """3 durable in-process backends + 2 HARouters on one shared store.
    The routers listen on real sockets but run NO control thread —
    tests drive elections one deterministic ``step()`` at a time."""
    store = str(tmp_path / "store")
    objs, backends = {}, {}
    for name in ("b0", "b1", "b2"):
        b = FleetBackend(_backend_spec(name, store))
        objs[name] = b
        backends[name] = ("127.0.0.1", b.port)
    routers = {}
    for name in ("r0", "r1"):
        routers[name] = HARouter(
            _router_spec(name, backends, store),
            start=True, control=False, registry=MetricsRegistry())
    yield routers, objs, store
    for r in routers.values():
        r.shutdown()
    for b in objs.values():
        b.shutdown(drain=False)


# -- the router lease: election, takeover, demotion --------------------------

def test_first_step_elects_exactly_one_active(ha_fleet):
    routers, _objs, store = ha_fleet
    r0, r1 = routers["r0"], routers["r1"]
    assert r0.step() == "active"
    assert r1.step() == "standby"
    assert (r0.epoch, r1.epoch) == (1, None)
    # the stamp mirrors into the FleetRouter so write frames carry it
    assert r0.router.router_epoch == 1
    assert r1.router.router_epoch is None
    # the router lease is its OWN namespace: the write lease untouched
    assert LeaseStore(store, lease_name=ROUTER_LEASE_NAME).read()[
        "owner"] == "r0"
    assert LeaseStore(store).read() is None
    assert r0.registry.snapshot()["router.ha_takeovers"] == 1
    assert r0.registry.snapshot()["router.ha_active"] == 1.0


def test_takeover_adopts_write_owner_from_shared_lease(ha_fleet):
    routers, _objs, _store = ha_fleet
    r0, r1 = routers["r0"], routers["r1"]
    r0.step()
    out = r0.router.write("CREATE (d:Person {name: 'Dana', age: 9})")
    assert (out["version"], out["epoch"]) == (1, 1)
    # the active dies; the standby takes over after the TTL from the
    # STORE's view of the fleet — write owner, epoch, backend liveness
    r0.shutdown()
    time.sleep(0.35)
    assert r1.step() == "active"
    assert r1.epoch == 2
    assert r1.router.owner == "b0"
    assert r1.router._owner_epoch == 1
    out = r1.router.write("CREATE (e:Person {name: 'Eve', age: 8})")
    # (the write lease's own TTL may have lapsed during the takeover
    # window, in which case b0 re-claims at a higher epoch — owner
    # identity, not epoch value, is the adoption contract here)
    assert out["version"] == 2
    assert r1.router.owner == "b0"


def test_zombie_router_is_fenced_and_demotes_itself(ha_fleet):
    routers, objs, _store = ha_fleet
    r0, r1 = routers["r0"], routers["r1"]
    r0.step()
    r0.router.write("CREATE (d:Person {name: 'Dana', age: 9})")
    # depose r0 behind its back: the router lease now names r1/epoch 2
    r0.lease._write({"owner": "r1", "epoch": 2,
                     "renewed_t": clock.now()})
    r1.step()
    assert (r1.role, r1.epoch) == ("active", 2)
    version_before = objs["b0"].graph.current().snapshot_version
    # the zombie still stamps epoch 1 on its write frames — the BACKEND
    # refuses them, whether or not the zombie's owner epoch is valid
    with pytest.raises(StaleEpoch) as exc_info:
        r0.router.write("CREATE (z:Person {name: 'Zed', age: 1})")
    assert exc_info.value.epoch == 1
    assert exc_info.value.lease_epoch == 2
    assert exc_info.value.owner == "r1"
    assert objs["b0"].graph.current().snapshot_version == version_before
    # deposition is discovered at the next step: renewal fails, demote
    assert r0.step() == "standby"
    assert r0.epoch is None and r0.router.router_epoch is None
    assert r0.registry.snapshot()["router.ha_demotions"] == 1


@pytest.mark.parametrize("order", [("a", "b"), ("b", "a")],
                         ids=["a-first", "b-first"])
def test_takeover_owner_hint_tie_breaks_lexicographically(tmp_path, order):
    """No published write lease + equal snapshot versions: the takeover
    adopts the lexicographically-first backend as owner hint, whatever
    the spec's insertion order — same rule as the owner election."""
    store = str(tmp_path / "store")
    objs = {name: FleetBackend(BackendSpec(
        name=name, backend="cpu",
        graph={"kind": "script", "create": PEOPLE}, versioned=True))
        for name in order}
    backends = {name: ("127.0.0.1", objs[name].port) for name in order}
    r = HARouter(RouterSpec(name="r0", backends=backends,
                            durable_dir=store, lease_ttl_s=0.3),
                 start=False, control=False, registry=MetricsRegistry())
    try:
        assert r.step() == "active"
        assert r.router.owner == "a"
    finally:
        for b in objs.values():
            b.shutdown(drain=False)


@pytest.mark.parametrize("order", [("a", "b"), ("b", "a")],
                         ids=["a-first", "b-first"])
def test_owner_election_tie_breaks_lexicographically(order):
    """Equal replayed logs: ``_failover_owner`` elects the
    lexicographically-first peer in BOTH insertion orders."""
    addrs = {name: ("127.0.0.1", 1) for name in ("z",) + order}
    router = FleetRouter(addrs, owner="z",
                         config=RouterConfig(failover_wait_s=0.1),
                         registry=MetricsRegistry())
    attempts = []

    class _Stub:
        def __init__(self, name):
            self.name = name

        def call(self, op, **fields):
            if op == "ping":
                return {"snapshot_version": 5}
            assert op == "acquire_lease"
            attempts.append(self.name)
            return {"durable": True, "epoch": 2}

        def close(self):
            pass

    router._clients = {n: _Stub(n) for n in addrs}
    router.mark_dead("z")
    assert router._failover_owner() is True
    assert attempts == ["a"]
    assert router.owner == "a" and router._owner_epoch == 2


# -- RouterSet: the client facade --------------------------------------------

def test_routerset_fails_over_to_standby_on_active_death(ha_fleet):
    routers, _objs, _store = ha_fleet
    r0, r1 = routers["r0"], routers["r1"]
    r0.step(), r1.step()
    reg = MetricsRegistry()
    rset = RouterSet({"r0": ("127.0.0.1", r0.port),
                      "r1": ("127.0.0.1", r1.port)},
                     wait_s=5.0, registry=reg)
    try:
        assert [r["n"] for r in rset.query(Q_NAMES)["rows"]] == NAMES
        assert rset.active() == "r0"
        # SIGKILL-equivalent: the active's sockets vanish, the lease is
        # NOT released (clean exit must look like a crash)
        r0.shutdown()
        time.sleep(0.35)
        assert r1.step() == "active"
        assert [r["n"] for r in rset.query(Q_NAMES)["rows"]] == NAMES
        assert rset.active() == "r1"
        assert reg.snapshot()["router.ha_client_failovers"] >= 1
    finally:
        rset.close()


def test_standby_refuses_with_bounded_retry_horizon(ha_fleet):
    routers, _objs, _store = ha_fleet
    r0, r1 = routers["r0"], routers["r1"]
    r0.step(), r1.step()
    with WireClient("127.0.0.1", r1.port) as client:
        with pytest.raises(FleetUnavailable) as exc_info:
            client.call("query", query=Q_NAMES)
    # the refusal names the takeover horizon: ~1 TTL, never unbounded
    assert 0.0 < exc_info.value.retry_after_s <= 1.0
    assert r1.registry.snapshot()["router.ha_standby_refusals"] == 1


def test_router_spec_round_trips_json(tmp_path):
    spec = _router_spec("r9", {"b0": ("127.0.0.1", 4242)},
                        str(tmp_path), hedge_reads=True,
                        hedge_delay_s=0.02)
    assert RouterSpec.from_json(spec.to_json()) == spec


# -- deadline fidelity (satellite: fake-clock 2-hop regression) ---------------

class _StubClient:
    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def call(self, op, **fields):
        self.calls.append((op, dict(fields)))
        return self.fn(op, fields)

    def close(self):
        pass


def _stub_router(fake_clock, stall_s, **cfg):
    """Two stub backends: the ring-preferred one stalls ``stall_s`` on
    the fake clock and dies with WireError; the other answers."""
    addrs = {"a": ("127.0.0.1", 1), "b": ("127.0.0.1", 2)}
    router = FleetRouter(addrs, owner="a",
                         config=RouterConfig(max_attempts=2, **cfg),
                         registry=MetricsRegistry())
    first, second = router.ring.preference(
        FleetRouter.routing_key("default", "fam", "Q"))[:2]

    def die(_op, _fields):
        fake_clock.advance(stall_s)
        raise WireError("stalled, then the socket died")

    def serve(_op, _fields):
        return {"rows": [], "snapshot_version": 0}

    router._clients = {first: _StubClient(die),
                       second: _StubClient(serve)}
    return router, first, second


def test_read_retry_forwards_remaining_budget_not_original(fake_clock):
    router, first, second = _stub_router(fake_clock, stall_s=2.0)
    out = router.query("Q", family="fam", deadline_s=5.0)
    assert out["backend"] == second
    # hop 1 got the full admission budget; hop 2 got what was LEFT
    assert router._clients[first].calls[0][1]["deadline_s"] \
        == pytest.approx(5.0)
    assert router._clients[second].calls[0][1]["deadline_s"] \
        == pytest.approx(3.0)


def test_read_deadline_exhausted_mid_failover_is_typed(fake_clock):
    router, _first, second = _stub_router(fake_clock, stall_s=6.0)
    with pytest.raises(DeadlineExceeded) as exc_info:
        router.query("Q", family="fam", deadline_s=5.0)
    assert exc_info.value.phase == "route"
    # the exhausted budget never reached the second backend
    assert router._clients[second].calls == []


def test_write_failover_forwards_remaining_budget(fake_clock):
    addrs = {"a": ("127.0.0.1", 1), "b": ("127.0.0.1", 2)}
    router = FleetRouter(addrs, owner="a",
                         config=RouterConfig(failover_wait_s=1.0),
                         registry=MetricsRegistry())

    def owner_dies(_op, _fields):
        fake_clock.advance(2.0)
        raise WireError("owner died mid-write")

    def peer(op, _fields):
        if op == "ping":
            return {"snapshot_version": 1}
        if op == "acquire_lease":
            return {"durable": True, "epoch": 2}
        assert op == "write"
        return {"version": 2, "epoch": 2}

    router._clients = {"a": _StubClient(owner_dies),
                       "b": _StubClient(peer)}
    out = router.write("CREATE (x)", ship=False, deadline_s=5.0)
    assert out["version"] == 2
    assert router._clients["a"].calls[0][1]["deadline_s"] \
        == pytest.approx(5.0)
    write_calls = [(op, f) for op, f in router._clients["b"].calls
                   if op == "write"]
    # the elected peer's frame carries the remaining budget AND the
    # freshly-claimed epoch
    assert write_calls[0][1]["deadline_s"] == pytest.approx(3.0)
    assert write_calls[0][1]["epoch"] == 2


# -- hedged reads -------------------------------------------------------------

@pytest.fixture
def plain_fleet():
    objs, backends = {}, {}
    for name in ("b0", "b1", "b2"):
        b = FleetBackend(BackendSpec(
            name=name, backend="cpu",
            graph={"kind": "script", "create": PEOPLE}, versioned=True))
        objs[name] = b
        backends[name] = ("127.0.0.1", b.port)
        # the port's first run of a query records its fused plan (the
        # reference's local backend has no such cold run): warm each
        # backend so the router's latency windows see steady-state reads
        with WireClient("127.0.0.1", b.port) as client:
            client.call("query", query=Q_NAMES)
    yield objs, backends
    for b in objs.values():
        b.shutdown(drain=False)


def _hedge_router(backends, **cfg):
    cfg.setdefault("hedge_reads", True)
    cfg.setdefault("hedge_max_fraction", 1.0)
    return FleetRouter(backends, owner="b0",
                       config=RouterConfig(**cfg),
                       registry=MetricsRegistry())


def test_hedged_read_wins_over_straggler_without_duplication(plain_fleet):
    objs, backends = plain_fleet
    router = _hedge_router(backends, hedge_delay_s=0.05)
    try:
        primary = router.ring.preference(
            FleetRouter.routing_key("default", "fam", Q_NAMES))[0]
        quiet = router.query(Q_NAMES, family="fam")
        assert quiet["backend"] == primary
        with slow_backend(backends[primary][1], 0.3, n_times=1):
            out = router.query(Q_NAMES, family="fam")
        # the hedge leg won — and the reply is ONE reply, identical to
        # the quiet run (first-wins, loser discarded, nothing merged)
        assert out["backend"] != primary
        assert out["rows"] == quiet["rows"]
        snap = router.registry.snapshot()
        assert snap["router.hedges"] == 1
        assert snap["router.hedge_wins"] == 1
        # the straggler is slow, not dead: once its discarded leg has
        # drained off the shared client, it serves the next read
        time.sleep(0.4)
        assert router.query(Q_NAMES,
                            family="fam")["backend"] == primary
    finally:
        router.close()


def test_hedge_rate_bound_zero_never_hedges(plain_fleet):
    _objs, backends = plain_fleet
    router = _hedge_router(backends, hedge_delay_s=0.01,
                           hedge_max_fraction=0.0)
    try:
        primary = router.ring.preference(
            FleetRouter.routing_key("default", "fam", Q_NAMES))[0]
        with slow_backend(backends[primary][1], 0.05, n_times=1):
            out = router.query(Q_NAMES, family="fam")
        # rate-bounded out of existence: the slow primary still serves
        assert out["backend"] == primary
        assert "router.hedges" not in router.registry.snapshot()
    finally:
        router.close()


def test_cold_family_never_hedges_off_a_guessed_latency(plain_fleet):
    _objs, backends = plain_fleet
    router = _hedge_router(backends)  # hedge_delay_s=None: learn p99
    try:
        primary = router.ring.preference(
            FleetRouter.routing_key("default", "cold", Q_NAMES))[0]
        with slow_backend(backends[primary][1], 0.05, n_times=1):
            out = router.query(Q_NAMES, family="cold")
        # no latency window yet — no delay to hedge after
        assert out["backend"] == primary
        assert "router.hedges" not in router.registry.snapshot()
        # once the family has observations, the p99-derived delay kicks
        # in and the same straggler IS hedged around
        for _ in range(4):
            router.query(Q_NAMES, family="cold")
        with slow_backend(backends[primary][1], 0.5, n_times=1):
            out = router.query(Q_NAMES, family="cold")
        assert out["backend"] != primary
        assert router.registry.snapshot()["router.hedges"] == 1
    finally:
        router.close()


# -- against the JAX package -------------------------------------------------

def test_router_spec_json_round_trips_between_packages(tmp_path):
    from caps_tpu.serve import ha as jax_ha
    spec = _router_spec("r9", {"b0": ("127.0.0.1", 4242),
                               "b1": ("127.0.0.1", 4243)},
                        str(tmp_path), hedge_reads=True, hedge_delay_s=0.02)
    ref = jax_ha.RouterSpec.from_json(spec.to_json())
    assert ref.to_json() == spec.to_json()
    assert RouterSpec.from_json(ref.to_json()) == spec


def test_a_jax_router_lease_fences_the_port_router(ha_fleet):
    """The JAX package's router-lease store takes the active's place in
    the shared directory: the port's active demotes at its next step,
    and its write frames die on the port backends with StaleEpoch."""
    from caps_tpu.durability.lease import LeaseStore as JaxLeaseStore
    routers, objs, store = ha_fleet
    r0 = routers["r0"]
    assert r0.step() == "active"
    r0.router.write("CREATE (e:Person {name: 'Eve', age: 61})")
    version = objs["b0"].graph.current().snapshot_version
    jax_lease = JaxLeaseStore(store, ttl_s=30.0,
                              lease_name=ROUTER_LEASE_NAME)
    jax_lease._write({"owner": "jax-router", "epoch": r0.epoch + 1,
                      "renewed_t": clock.now()})
    with pytest.raises(StaleEpoch) as exc_info:
        r0.router.write("CREATE (z:Person {name: 'Zed', age: 1})")
    assert exc_info.value.owner == "jax-router"
    assert exc_info.value.lease_epoch == r0.epoch + 1
    assert objs["b0"].graph.current().snapshot_version == version
    assert r0.step() == "standby"
    # the port's store reads the JAX package's record as the live lease
    assert LeaseStore(store, ttl_s=30.0, lease_name=ROUTER_LEASE_NAME
                      ).holder("jax-router") == r0.lease.read()["epoch"]
