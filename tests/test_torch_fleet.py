"""Fleet serving in the port (serve/wire.py, fleet.py, router.py): the
counterpart of ``tests/test_fleet.py`` with ``backend="cpu"`` backends —
wire-error round-trip fidelity, consistent hashing, load-aware spill,
kill-a-process failover, snapshot shipping, rejoin-warms-from-store —
plus the cross-package checks: the same ring placements, the same wire
bytes, the same replies from a JAX ``FleetBackend(backend="cpu")`` and
a port ``FleetBackend(backend="cpu")``, the column-built ``foaf`` graph
equal to the JAX package's CREATE-built one, and a spawned child.

The in-process fleet fixture runs real sockets and real wire frames —
each backend is a full QueryServer on its own session behind a
listener thread — so every cross-process contract except the GIL is
exercised deterministically."""
from __future__ import annotations

import json
import os
import socket

import pytest

from caps_tpu.serve import fleet as jax_fleet
from caps_tpu.serve import router as jax_router
from caps_tpu.serve import wire as jax_wire
from caps_tpu_torch.obs.metrics import MetricsRegistry, merge_snapshots
from caps_tpu_torch.serve import errors as serve_errors
from caps_tpu_torch.serve import wire as port_wire
from caps_tpu_torch.serve.errors import (Cancelled, CancellationError,
                                         CircuitOpen, CompactionFailed,
                                         DeadlineExceeded, FleetUnavailable,
                                         NotPorted, Overloaded, QueryFailed,
                                         ReplicationUnsupported, ServeError,
                                         ServerClosed, ShardMemberDown,
                                         ShardingUnsupported, StaleEpoch,
                                         WaitTimeout, WalWriteError,
                                         WireError, error_from_payload)
from caps_tpu_torch.serve.fleet import (BackendSpec, FleetBackend,
                                        foaf_create_script, rows_digest,
                                        spawn_backend)
from caps_tpu_torch.serve.router import FleetRouter, HashRing, RouterConfig
from caps_tpu_torch.serve.wire import WireClient
from caps_tpu_torch.testing.faults import drop_connection, slow_network

SOCIAL = """
    CREATE (a:Person {name: 'Alice', age: 33}),
           (b:Person {name: 'Bob', age: 44}),
           (c:Person {name: 'Carol', age: 27}),
           (d:Person {name: 'Dana', age: 51}),
           (a)-[:KNOWS {since: 2011}]->(b),
           (b)-[:KNOWS {since: 2015}]->(c),
           (a)-[:KNOWS {since: 2019}]->(c),
           (c)-[:KNOWS {since: 2021}]->(d)
"""

Q_AGE = ("MATCH (p:Person) WHERE p.age > $min "
         "RETURN p.name AS n ORDER BY n")
Q_KNOWS = ("MATCH (a:Person)-[:KNOWS]->(b) "
           "RETURN a.name AS a, b.name AS b ORDER BY a, b")


# -- satellite: wire-error round-trip parity matrix --------------------------

#: one representative instance per ServeError class — the parity test
#: FAILS when serve/errors.py grows a class with no sample here, so the
#: wire contract can never silently lose a type
ERROR_SAMPLES = (
    ServeError("boom"),
    NotPorted("shard groups: not yet ported, see ROADMAP"),
    ServerClosed("server is shutting down"),
    Overloaded("queue full", retry_after_s=1.5, queue_depth=7, priority=2),
    WaitTimeout("request not complete"),
    QueryFailed("exhausted containment",
                attempts=({"mode": "fused", "error": "XlaRuntimeError",
                           "classification": "TRANSIENT", "backoff_s": 0.25},
                          {"mode": "unfused", "error": "XlaRuntimeError",
                           "classification": "FATAL"}),
                retry_after_s=0.75),
    CircuitOpen("family quarantined", retry_after_s=3.25),
    CompactionFailed("fold failed"),
    ReplicationUnsupported("graph cannot re-ingest"),
    ShardingUnsupported("writes do not shard"),
    ShardMemberDown("member rebuilding", member=3),
    WalWriteError("WAL append failed (version 7): fsync failed"),
    StaleEpoch("zombie owner fenced", epoch=1, lease_epoch=2, owner="b1"),
    CancellationError("cancelled mid-plan", phase="plan"),
    DeadlineExceeded("execute", 0.5, 0.7531),
    DeadlineExceeded("queued", None, 1.25),
    Cancelled(phase="queued"),
    WireError("connection closed mid-frame"),
    FleetUnavailable("all ring nodes down", retry_after_s=2.0),
)


def test_every_serve_error_class_has_a_wire_sample():
    classes = {type(e) for e in ERROR_SAMPLES}
    missing = [name for name, cls in serve_errors._error_classes().items()
               if cls not in classes]
    assert not missing, (
        f"serve/errors.py classes without a wire round-trip sample: "
        f"{missing} — add one to ERROR_SAMPLES")


@pytest.mark.parametrize("err", ERROR_SAMPLES,
                         ids=lambda e: type(e).__name__)
def test_wire_error_round_trip_exact(err):
    payload = json.loads(json.dumps(err.to_payload()))
    back = error_from_payload(payload)
    assert type(back) is type(err)
    assert str(back) == str(err)
    # every machine-usable field survives: the rebuilt error serializes
    # to the identical payload
    assert back.to_payload() == err.to_payload()
    for attr in ("retry_after_s", "queue_depth", "priority", "attempts",
                 "phase", "budget_s", "elapsed_s", "caps_transient"):
        if hasattr(err, attr):
            assert getattr(back, attr) == getattr(err, attr), attr


def test_unknown_error_class_degrades_to_query_failed():
    back = error_from_payload({"error": "FutureError", "message": "hi"})
    assert type(back) is QueryFailed
    assert "FutureError" in str(back)
    assert error_from_payload("garbage").__class__ is QueryFailed


# -- consistent hashing ------------------------------------------------------

def _placements(ring, keys):
    return {k: ring.lookup(k) for k in keys}


def test_hash_ring_add_moves_about_one_over_n():
    keys = [f"graph|family-{i}" for i in range(1000)]
    ring = HashRing([f"b{i}" for i in range(5)])
    before = _placements(ring, keys)
    ring.add("b5")
    after = _placements(ring, keys)
    moved = sum(1 for k in keys if before[k] != after[k])
    # ideal is 1/6 of keys; virtual nodes keep the variance tight
    assert 0 < moved < len(keys) * 0.35
    # every moved key moved TO the new node — nothing reshuffles
    # between survivors
    assert all(after[k] == "b5" for k in keys if before[k] != after[k])


def test_hash_ring_remove_moves_only_the_dead_nodes_keys():
    keys = [f"g|{i}" for i in range(1000)]
    ring = HashRing([f"b{i}" for i in range(5)])
    before = _placements(ring, keys)
    ring.remove("b2")
    after = _placements(ring, keys)
    for k in keys:
        if before[k] == "b2":
            assert after[k] != "b2"
        else:
            assert after[k] == before[k]


def test_hash_ring_is_stable_across_instances():
    # blake2b placement, not the salted builtin hash: two routers built
    # in different processes MUST agree — here: two instances
    a = HashRing(["x", "y", "z"])
    b = HashRing(["z", "y", "x"])  # insertion order must not matter
    for i in range(200):
        assert a.lookup(f"k{i}") == b.lookup(f"k{i}")


def test_preference_walk_is_distinct_and_starts_at_primary():
    ring = HashRing(["a", "b", "c", "d"])
    for i in range(50):
        prefs = ring.preference(f"key-{i}")
        assert sorted(prefs) == ["a", "b", "c", "d"]
        assert prefs[0] == ring.lookup(f"key-{i}")


# -- in-process fleet fixture ------------------------------------------------

@pytest.fixture
def fleet():
    spec = {"kind": "script", "create": SOCIAL}
    backends = {}
    objs = {}
    for name in ("b0", "b1", "b2"):
        b = FleetBackend(BackendSpec(name=name, backend="cpu",
                                     graph=spec, versioned=True))
        objs[name] = b
        backends[name] = ("127.0.0.1", b.port)
    router = FleetRouter(backends, owner="b0",
                         config=RouterConfig(max_attempts=3),
                         registry=MetricsRegistry())
    yield router, objs
    router.close()
    for b in objs.values():
        b.shutdown(drain=False)


def test_routing_affinity_keeps_a_family_on_one_backend(fleet):
    router, _objs = fleet
    ran_on = {router.query(Q_AGE, {"min": 30}, family="age")["backend"]
              for _ in range(8)}
    assert len(ran_on) == 1


def test_reply_carries_ledger_and_snapshot_version(fleet):
    router, _objs = fleet
    out = router.query(Q_AGE, {"min": 30}, family="age")
    assert [r["n"] for r in out["rows"]] == ["Alice", "Bob", "Dana"]
    assert out["snapshot_version"] == 0
    assert set(out["ledger"]) >= {"bytes_in", "bytes_out", "compile_s"}


def test_remote_typed_error_reraises_exactly(fleet):
    router, _objs = fleet
    with pytest.raises(QueryFailed) as exc_info:
        router.query("MATCH (n:Person) RETURN bogus(n.age) AS x",
                     family="bad")
    # the error crossed the wire typed, not as a stringly RuntimeError
    assert type(exc_info.value) is QueryFailed


def test_hot_family_spill_overflows_to_next_ring_node(fleet):
    router, _objs = fleet
    primary = router.query(Q_AGE, {"min": 30}, family="hot")["backend"]
    # simulate a scraped hot-spot signal: the primary's windowed queue
    # depth sits over the spill threshold
    router._state[primary]["depth"] = router.config.spill_queue_depth
    spilled = router.query(Q_AGE, {"min": 30}, family="hot")
    assert spilled["backend"] != primary
    assert router.registry.snapshot()["router.spilled"] >= 1
    # the spill target's reply refreshed its depth; the primary heals
    # once its depth signal drops
    router._state[primary]["depth"] = 0
    assert router.query(Q_AGE, {"min": 30},
                        family="hot")["backend"] == primary


def test_kill_a_backend_soak_availability_one_digest_equal(fleet):
    router, objs = fleet
    families = [f"fam-{i}" for i in range(9)]
    want = {f: router.query(Q_AGE, {"min": 30}, family=f,
                            digest=True)["digest"]
            for f in families}
    # kill one process mid-soak (not the write owner; owner loss makes
    # the fleet read-only, which is its own test below)
    victim = next(n for n in objs if n != router.owner)
    objs[victim].shutdown(drain=False)
    ok = 0
    for _round in range(3):
        for f in families:
            out = router.query(Q_AGE, {"min": 30}, family=f, digest=True)
            assert out["digest"] == want[f], f
            assert out["backend"] != victim
            ok += 1
    assert ok == 27  # availability 1.0: every request served
    stats = router.stats()
    assert stats["backends"][victim]["live"] is False
    assert stats["live"] == 2


def test_owner_down_makes_writes_unavailable_reads_fine(fleet):
    router, objs = fleet
    objs[router.owner].shutdown(drain=False)
    router.query(Q_AGE, {"min": 30}, family="f")  # reads keep serving
    router.mark_dead(router.owner)
    with pytest.raises(FleetUnavailable):
        router.write("CREATE (x:Person {name: 'Zed', age: 1})")


def test_snapshot_shipping_read_your_writes_digest_exact(fleet):
    router, objs = fleet
    out = router.write("CREATE (e:Person {name: 'Eve', age: 61})")
    assert out["version"] == 1
    ship = out["ship"]
    assert set(ship["peers"]) == {"b1", "b2"}
    assert all(v == 1 for v in ship["peers"].values())
    assert ship["lag_s"] >= 0.0
    # read-your-writes on EVERY backend, digest-exact
    digests = set()
    for name in objs:
        rep = router._clients[name].call(
            "query", query=Q_AGE, params={"min": 30}, digest=True)
        assert rep["snapshot_version"] == 1
        assert any(r["n"] == "Eve" for r in rep["rows"])
        digests.add(rep["digest"])
    assert len(digests) == 1
    report = router.snapshot_report()
    assert set(report["versions"].values()) == {1}
    assert report["lag_s"] == ship["lag_s"]


def test_snapshot_install_is_monotonic(fleet):
    router, objs = fleet
    router.write("CREATE (e:Person {name: 'Eve', age: 61})")
    # re-shipping the same version is a no-op, never a rollback
    again = router.ship_snapshots()
    assert all(v == 1 for v in again["peers"].values())
    assert objs["b1"].graph.current().snapshot_version == 1


def test_fleet_metrics_text_aggregates_one_scrape(fleet):
    router, objs = fleet
    for f in ("m0", "m1"):
        router.query(Q_AGE, {"min": 30}, family=f)
    text = router.metrics_text()
    assert "fleet_backends_live 3" in text
    assert "router_requests" in text
    # backend-side serve.* counters summed across processes ride the
    # same scrape
    assert "serve_completed" in text
    merged = merge_snapshots([b.session.metrics_registry.snapshot()
                              for b in objs.values()])
    assert merged["serve.completed"] >= 2


# -- fault injectors (satellite) ---------------------------------------------

def test_drop_connection_fails_over_to_next_ring_node(fleet):
    router, objs = fleet
    primary = router.query(Q_AGE, {"min": 30}, family="drop")["backend"]
    with drop_connection(n_times=1) as budget:
        out = router.query(Q_AGE, {"min": 30}, family="drop")
    assert budget.injected == 1
    # the request survived the drop by retrying the next ring node; the
    # dropped backend's segment degraded
    assert out["backend"] != primary
    snap = router.registry.snapshot()
    assert snap["router.retries"] >= 1
    assert snap["router.backend_down"] >= 1
    assert router.stats()["backends"][primary]["live"] is False
    # the process never actually died: rejoin readmits it
    report = router.rejoin(primary)
    assert report["ping"]["name"] == primary
    assert router.stats()["backends"][primary]["live"] is True
    assert router.query(Q_AGE, {"min": 30},
                        family="drop")["backend"] == primary


def test_slow_network_injects_deterministically(fleet):
    router, _objs = fleet
    with slow_network(0.01, n_times=2) as budget:
        router.query(Q_AGE, {"min": 30}, family="slow")
        router.query(Q_AGE, {"min": 30}, family="slow")
        router.query(Q_AGE, {"min": 30}, family="slow")
    assert budget.injected == 2  # bounded: exactly n_times sends slowed


def test_injector_counters_ride_the_global_registry(fleet):
    from caps_tpu_torch.obs.metrics import global_registry
    router, _objs = fleet
    before = global_registry().snapshot().get(
        "faults.injected.slow_network", 0)
    with slow_network(0.001, n_times=1):
        router.query(Q_AGE, {"min": 30}, family="ctr")
    after = global_registry().snapshot()["faults.injected.slow_network"]
    assert after == before + 1


# -- rejoin warms from the shared store --------------------------------------

def test_rejoin_warms_from_store_zero_compile_charge(tmp_path):
    store = str(tmp_path / "plans.json")
    spec = BackendSpec(name="w0", backend="cpu",
                       graph={"kind": "script", "create": SOCIAL},
                       versioned=False, plan_store_path=store,
                       warm_background=False)
    first = FleetBackend(spec)
    client = WireClient("127.0.0.1", first.port)
    for params in ({"min": 30}, {"min": 40}):
        out = client.call("query", query=Q_AGE, params=params)
        assert out["rows"]
    client.close()
    # shutdown persists the warm state to the shared store
    first.shutdown()

    # a rejoining process warms from the store BEFORE its port opens
    # (inline warmup) — its FIRST client query is a plan-cache hit
    rejoined = FleetBackend(spec)
    client = WireClient("127.0.0.1", rejoined.port)
    try:
        warm = client.call("warmup_wait", timeout=10.0)
        assert warm["done"]
        out = client.call("query", query=Q_AGE, params={"min": 35})
        assert out["ledger"]["compile_s"] == 0.0
        assert [r["n"] for r in out["rows"]] == ["Bob", "Dana"]
    finally:
        client.close()
        rejoined.shutdown(drain=False)


# -- spec / graph determinism ------------------------------------------------

def test_backend_spec_round_trips_json():
    spec = BackendSpec(name="n1", backend="cpu",
                       graph={"kind": "foaf", "n_people": 10,
                              "n_edges": 20, "seed": 7},
                       versioned=True, plan_store_path="/tmp/x.json")
    assert BackendSpec.from_json(spec.to_json()) == spec


def test_foaf_script_is_deterministic_across_calls():
    assert foaf_create_script(20, 40, 3) == foaf_create_script(20, 40, 3)
    assert foaf_create_script(20, 40, 3) != foaf_create_script(20, 40, 4)


def test_rows_digest_is_order_insensitive():
    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
    assert rows_digest(rows) == rows_digest(list(reversed(rows)))
    assert rows_digest(rows) != rows_digest(rows[:1])


def test_local_backend_raises_not_ported():
    with pytest.raises(NotImplementedError, match="backends/local"):
        FleetBackend(BackendSpec(name="l0", backend="local"), start=False)


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("n_nodes", [3, 4])
def test_hash_ring_places_keys_as_the_reference(n_nodes):
    nodes = [f"b{i}" for i in range(n_nodes)]
    port, ref = HashRing(nodes), jax_router.HashRing(nodes)
    keys = [f"default|family-{i}" for i in range(1000)]
    assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
    assert [port.preference(k) for k in keys[:100]] \
        == [ref.preference(k) for k in keys[:100]]


def test_backend_spec_json_round_trips_between_packages():
    spec = BackendSpec(name="n1", backend="cpu",
                       graph={"kind": "foaf", "n_people": 10,
                              "n_edges": 20, "seed": 7},
                       versioned=True, durable_dir="/tmp/d",
                       wal_fsync="rotate", lease_ttl_s=2.0)
    ref = jax_fleet.BackendSpec.from_json(spec.to_json())
    assert ref.to_json() == spec.to_json()
    assert BackendSpec.from_json(ref.to_json()) == spec


@pytest.mark.parametrize("obj", [
    {"op": "query", "query": Q_AGE, "params": {"min": 30}, "digest": True},
    {"ok": False, "error": StaleEpoch("fenced", epoch=1, lease_epoch=2,
                                      owner="b1").to_payload()},
    {"ok": True, "result": {"rows": [{"n": "Zoë", "x": None}]}},
], ids=["request", "error", "reply"])
def test_wire_frames_are_byte_equal(obj):
    frames = {}
    for name, mod in (("jax", jax_wire), ("port", port_wire)):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, obj)
            a.shutdown(socket.SHUT_WR)
            frames[name] = b.recv(1 << 16)
            # and each package decodes the other's frame
        finally:
            a.close()
            b.close()
    assert frames["jax"] == frames["port"]
    for mod in (jax_wire, port_wire):
        a, b = socket.socketpair()
        try:
            a.sendall(frames["jax"])
            assert mod.recv_frame(b) == json.loads(json.dumps(obj))
        finally:
            a.close()
            b.close()


FOAF_QUERY = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
              "WHERE a.age = $age RETURN c.age AS age, count(*) AS n "
              "ORDER BY n DESC, age LIMIT 20")

#: (query, params) frames sent to both packages' backends
PARITY_FRAMES = {
    "social": [(Q_AGE, {"min": 30}), (Q_KNOWS, {}),
               ("MATCH (a:Person)-[k:KNOWS]->(b) WHERE k.since >= $y "
                "RETURN a.name AS a, count(*) AS c ORDER BY a", {"y": 2015}),
               ("MATCH (p:Person) RETURN p.age AS age ORDER BY age DESC "
                "LIMIT 2", {})],
    "foaf": [(FOAF_QUERY, {"age": 27}), (FOAF_QUERY, {"age": 62}),
             ("MATCH (p:Person)-[k:KNOWS]->(q) WHERE k.w < $w "
              "RETURN p.name AS p, q.name AS q, k.w AS w", {"w": 5})],
}
PARITY_GRAPHS = {"social": {"kind": "script", "create": SOCIAL},
                 "foaf": {"kind": "foaf", "n_people": 64, "n_edges": 256,
                          "seed": 11}}


@pytest.mark.parametrize("graph", sorted(PARITY_GRAPHS))
def test_same_frames_same_replies_as_the_jax_backend(graph):
    gspec = PARITY_GRAPHS[graph]
    ref = jax_fleet.FleetBackend(jax_fleet.BackendSpec(
        name="r0", backend="local", graph=gspec, versioned=True))
    port = FleetBackend(BackendSpec(name="p0", backend="cpu", graph=gspec,
                                    versioned=True))
    write = ("MATCH (p:Person) WHERE p.name = $name SET p.age = $age",
             {"name": "Alice" if graph == "social" else "p3", "age": 27})
    try:
        with jax_wire.WireClient("127.0.0.1", ref.port) as rc, \
                WireClient("127.0.0.1", port.port) as pc:
            for phase in ("before", "after"):
                for q, p in PARITY_FRAMES[graph]:
                    want = rc.call("query", query=q, params=p, digest=True)
                    got = pc.call("query", query=q, params=p, digest=True)
                    assert got["digest"] == want["digest"], (phase, q)
                    assert got["rows"] == want["rows"], (phase, q)
                    assert got["digest"] == rows_digest(got["rows"])
                if phase == "before":
                    assert rc.call("write", query=write[0],
                                   params=write[1])["version"] \
                        == pc.call("write", query=write[0],
                                   params=write[1])["version"] == 1
    finally:
        ref.shutdown(drain=False)
        port.shutdown(drain=False)


#: every node and relationship with its id and properties
GRAPH_DUMP = (
    "MATCH (n) RETURN count(*) AS nodes",
    "MATCH (n:Person) RETURN id(n) AS id, n.name AS name, n.age AS age",
    "MATCH (a)-[r]->(b) RETURN id(r) AS id, type(r) AS t, id(a) AS s, "
    "id(b) AS d, r.w AS w",
)


@pytest.mark.parametrize("n_people,n_edges", [(64, 256), (2000, 6000)])
def test_column_built_foaf_equals_the_create_built_one(n_people, n_edges):
    import caps_tpu
    import caps_tpu_torch
    from caps_tpu_torch.serve.fleet import build_graph_from_spec
    gspec = {"kind": "foaf", "n_people": n_people, "n_edges": n_edges,
             "seed": 5}
    js = caps_tpu.local_session(backend="local")
    jg = jax_fleet.build_graph_from_spec(js, gspec, False)
    pg = build_graph_from_spec(caps_tpu_torch.local_session(device="cpu"),
                               gspec, False)
    for q in GRAPH_DUMP:
        want = jg.cypher(q).records.to_maps()
        got = pg.cypher(q).records.to_maps()
        assert len(got) == len(want) > 0
        assert rows_digest(got) == rows_digest(want), q


def test_spawned_child_reports_its_port_and_serves():
    proc, port = spawn_backend(BackendSpec(
        name="c0", backend="cpu", graph={"kind": "script",
                                         "create": SOCIAL}))
    try:
        with WireClient("127.0.0.1", port) as client:
            info = client.call("ping")
            assert info["pid"] == proc.pid and info["name"] == "c0"
            assert set(info["startup"]) == {"session_s", "graph_s",
                                            "recover_s"}
            rows = client.call("query", query=Q_AGE,
                               params={"min": 30})["rows"]
        assert [r["n"] for r in rows] == ["Alice", "Bob", "Dana"]
    finally:
        proc.kill()
        proc.wait()
        os.unlink(proc.caps_stderr_path)


def test_a_child_that_fails_at_start_raises_with_its_stderr():
    with pytest.raises(QueryFailed) as exc_info:
        spawn_backend(BackendSpec(name="c1", backend="cpu",
                                  graph={"kind": "no-such-kind"}))
    msg = str(exc_info.value)
    assert "exited before reporting a port" in msg
    # the tail of the child's stderr names the cause
    assert "unknown graph spec kind 'no-such-kind'" in msg


def test_foaf_without_people_draws_no_edges():
    from caps_tpu_torch.serve.fleet import foaf_arrays
    empty = foaf_arrays(0, 0, 1)
    assert empty["person_id"].shape == empty["src"].shape == (0,)
    # the reference's randrange(0) raises; the port refuses the same spec
    with pytest.raises(QueryFailed, match="needs a person"):
        foaf_arrays(0, 5, 1)
