"""Sharded serving of the port (``caps_tpu_torch/serve/shards.py``):
partitioned graphs behind QueryServer, shard-group fault domains and
host-memory partition paging.

The first tests hold the port to the JAX package on the same graph: the
partitions equal the reference's row for row, ``hash_value`` equals it
on ints, floats, bools, strings and None, and the routing decisions are
the same.  The rest are the counterparts of ``tests/test_shards.py``'s
24 tests, run on the port's own sessions (the pure-Python oracle, as
the reference's run on its local backend; the device backend on the
CPU where the reference uses its device backend, with a 2-shard mesh
cross-shard session).  The long soak is marked ``slow``, as the
reference's is.
"""
from __future__ import annotations

import threading
import time

import pytest

import caps_tpu_torch
from caps_tpu_torch.obs import clock
from caps_tpu_torch.relational.session import result_digest
from caps_tpu_torch.serve import (Overloaded, QueryServer, RetryPolicy,
                            ServerConfig)
from caps_tpu_torch.serve.devices import HEALTHY, ReplicaSet
from caps_tpu_torch.serve.errors import ShardingUnsupported
from caps_tpu_torch.serve.shards import (GROUP_DEGRADED, GROUP_HEALTHY,
                                   GROUP_QUARANTINED, MEMBER_HEALTHY,
                                   MEMBER_QUARANTINED, ShardGroup,
                                   ShardGroupConfig, executing_shard,
                                   hash_value, partition_graph)
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import shard_loss, sick_shard

PEOPLE = """
    CREATE (a:Person {id: 1, name: 'Alice', age: 33}),
           (b:Person {id: 2, name: 'Bob', age: 44}),
           (c:Person {id: 3, name: 'Carol', age: 27}),
           (d:Person {id: 4, name: 'Dana', age: 51}),
           (e:Person {id: 5, name: 'Eve', age: 39}),
           (f:City {id: 6, name: 'Oslo'}),
           (a)-[:KNOWS {since: 2011}]->(b),
           (b)-[:KNOWS {since: 2015}]->(c),
           (a)-[:KNOWS {since: 2019}]->(c),
           (c)-[:KNOWS {since: 2021}]->(d),
           (d)-[:KNOWS {since: 2022}]->(e),
           (a)-[:LIVES_IN]->(f)
"""

Q_SINGLE = "MATCH (n:Person) WHERE n.id = $id RETURN n.name AS name"
Q_SINGLE_MAP = "MATCH (n:Person {id: $id}) RETURN n.age AS age"
Q_EDGE = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
          "RETURN a.name AS a, b.name AS b")
Q_TWOHOP = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
            "WHERE a.id = $id RETURN c.name AS c")
Q_COUNT = ("MATCH (a:Person)-[k:KNOWS]->(b) WHERE k.since >= $y "
           "RETURN count(*) AS c")


def _session():
    return caps_tpu_torch.local_session(backend="local")


def _graph(session):
    return create_graph(session, PEOPLE)


def _bag(rows):
    return sorted(sorted(r.items()) for r in rows)


def _group(session, graph, **over):
    kw = dict(name="g0", members=2, partitions_per_member=2,
              member_cooldown_s=1.0)
    kw.update(over)
    return ShardGroup(session, graph, ShardGroupConfig(**kw),
                      registry=session.metrics_registry)


def _drive(server, replica):
    batch = server.batcher.next_batch(timeout=0)
    if batch:
        server._execute_batch(batch, replica)
    return batch


class FakeClock:
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


# -- partitioning -----------------------------------------------------------

def test_partitioner_covers_every_row_exactly_once():
    session = _session()
    graph = _graph(session)
    parts = partition_graph(graph, 4, "id")
    assert len(parts) == 4
    node_ids = []
    rel_ids = []
    for p in parts:
        for s in p.node_slices:
            node_ids.extend(s.data[s.mapping.id_col])
        for s in p.rel_slices:
            rel_ids.extend(s.data[s.mapping.id_col])
    all_nodes = [nid for nt in graph.node_tables
                 for nid in nt.table.column_values(nt.mapping.id_col)]
    all_rels = [rid for rt in graph.rel_tables
                for rid in rt.table.column_values(rt.mapping.id_col)]
    assert sorted(node_ids) == sorted(all_nodes)
    assert sorted(rel_ids) == sorted(all_rels)
    # every partition keeps the full table structure (schema parity):
    # one slice per source entity table, mappings identical
    for p in parts:
        assert len(p.node_slices) == len(graph.node_tables)
        assert len(p.rel_slices) == len(graph.rel_tables)
        assert {s.mapping.labels for s in p.node_slices} \
            == {nt.mapping.labels for nt in graph.node_tables}


def test_partitioner_edges_follow_source_node():
    session = _session()
    graph = _graph(session)
    parts = partition_graph(graph, 3, "id")
    home = {}
    for p in parts:
        for s in p.node_slices:
            for nid in s.data[s.mapping.id_col]:
                home[nid] = p.index
    for p in parts:
        for s in p.rel_slices:
            for src in s.data[s.mapping.source_col]:
                assert home[src] == p.index


def test_hash_value_stable_and_numeric_coherent():
    # process-independent (crc32, not salted hash()) — these pin the
    # cross-process partitioning contract
    assert hash_value(1) == hash_value(1)
    assert hash_value("x") == hash_value("x")
    # Cypher numeric equality: 5 = 5.0 is TRUE, so a float-typed
    # parameter must route to the shard that stored the int
    # (regression: a type-sensitive hash silently returned empty)
    assert hash_value(5) == hash_value(5.0)
    assert hash_value(5.5) != hash_value(5)
    # booleans are not Cypher numbers; strings never equal numbers
    assert hash_value(True) != hash_value(1)
    assert hash_value("1") != hash_value(1)


def test_float_param_routes_to_int_stored_shard():
    session = _session()
    graph = _graph(session)
    group = _group(session, graph)
    for i in range(1, 6):
        got = group.execute(Q_SINGLE, {"id": float(i)})
        want = graph.cypher(Q_SINGLE, {"id": float(i)})
        assert result_digest(got) == result_digest(want), i
        assert got.to_maps(), i  # non-empty: routed to the right shard


def test_partition_rejects_non_scan_graphs():
    session = _session()
    with pytest.raises(ShardingUnsupported):
        partition_graph(session._ambient, 2)


def test_group_rejects_versioned_graphs():
    session = _session()
    graph = _graph(session)
    from caps_tpu_torch.relational.updates import VersionedGraph
    vg = VersionedGraph(session, graph)
    with pytest.raises(ShardingUnsupported):
        _group(session, vg)


# -- routing ----------------------------------------------------------------

def test_route_detects_single_shard_queries():
    session = _session()
    group = _group(session, _graph(session))
    assert group._route(Q_SINGLE) == ("param", "id")
    assert group._route(Q_SINGLE_MAP) == ("param", "id")
    # reversed equality, extra conjuncts, aggregation, WITH — all still
    # resident (every matched row lives on the owning shard)
    assert group._route("MATCH (n:Person) WHERE $id = n.id "
                        "RETURN n.name AS name") == ("param", "id")
    assert group._route("MATCH (n:Person) WHERE n.id = $id AND "
                        "n.age > 30 RETURN count(*) AS c") \
        == ("param", "id")
    assert group._route("MATCH (n) WHERE n.id = $id WITH n.age AS a "
                        "RETURN a") == ("param", "id")
    assert group._route("MATCH (n:Person) WHERE n.id = 3 "
                        "RETURN n.name AS name") == ("lit", 3)


def test_route_rejects_cross_shard_queries():
    session = _session()
    group = _group(session, _graph(session))
    # relationships, multiple parts, OPTIONAL, other clauses, writes,
    # EXPLAIN, missing/wrong property — all cross-shard
    assert group._route(Q_EDGE) is None
    assert group._route(Q_TWOHOP) is None
    assert group._route("MATCH (n:Person), (m:City) WHERE n.id = $id "
                        "RETURN n.name AS a, m.name AS b") is None
    assert group._route("OPTIONAL MATCH (n:Person) WHERE n.id = $id "
                        "RETURN n.name AS name") is None
    assert group._route("UNWIND [1, 2] AS x MATCH (n) WHERE n.id = $id "
                        "RETURN n.name AS name, x") is None
    assert group._route("MATCH (n:Person) WHERE n.age = $id "
                        "RETURN n.name AS name") is None
    assert group._route("MATCH (n:Person) RETURN n.name AS name") is None
    assert group._route("EXPLAIN " + Q_SINGLE) is None
    assert group._route("CREATE (n:Person {id: 99})") is None


def test_single_and_cross_shard_digest_parity():
    session = _session()
    graph = _graph(session)
    group = _group(session, graph, partitions_per_member=3)
    cases = [(Q_SINGLE, {"id": i}) for i in range(1, 6)] + \
        [(Q_SINGLE_MAP, {"id": 2}),
         ("MATCH (n:Person) WHERE n.id = $id AND n.age > 30 "
          "RETURN count(*) AS c", {"id": 4}),
         (Q_EDGE, {"min": 25}), (Q_TWOHOP, {"id": 1}),
         (Q_COUNT, {"y": 2015}),
         ("MATCH (n) RETURN n.name AS name ORDER BY name", {})]
    for q, params in cases:
        got = group.execute(q, params)
        want = graph.cypher(q, params)
        assert result_digest(got) == result_digest(want), (q, params)
    s = group.summary()
    assert s["requests"]["total"] == 0  # server-side counters only
    reg = session.metrics_snapshot()
    assert reg["shard.requests.single"] >= 7
    assert reg["shard.requests.cross"] >= 4


def test_cross_shard_join_parity_on_meshed_backend():
    """The distributed-join path: the group's cross-shard session rides
    a mesh (2 shards on the CPU here) and its join results are
    digest-equal to the unsharded session's."""
    session = caps_tpu_torch.local_session(device="cpu")
    graph = _graph(session)
    group = _group(session, graph)
    assert group.cross_meshed
    assert group.cross_session.backend.n_shards == 2
    for q, params in [(Q_EDGE, {"min": 25}), (Q_COUNT, {"y": 2011}),
                      (Q_TWOHOP, {"id": 1})]:
        assert result_digest(group.execute(q, params)) \
            == result_digest(graph.cypher(q, params)), q
    # single-shard routing on the device backend too
    assert result_digest(group.execute(Q_SINGLE, {"id": 3})) \
        == result_digest(graph.cypher(Q_SINGLE, {"id": 3}))


# -- the group health ladder ------------------------------------------------

def test_group_ladder_lifecycle_exact(fake_clock):
    """Member loss → group degraded (healthy members keep serving) →
    probe gated by the cooldown → rebuild onto a spare session →
    reinstated → group healthy, with exact counters on the fake
    clock."""
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False, config=ServerConfig(
        shards=2,
        shard_config=ShardGroupConfig(
            name="g0", partitions_per_member=2,
            member_failure_threshold=1, member_cooldown_s=10.0),
        retry=RetryPolicy(max_attempts=1, backoff_base_s=0.0, jitter=0.0),
        breaker_threshold=1000))
    group = server.shard_groups[0]
    # find one id per member so we can target each side
    by_member = {}
    for i in range(1, 6):
        _pidx, m = group.owning_member(i)
        by_member.setdefault(m.index, i)
    assert set(by_member) == {0, 1}
    victim, survivor = by_member[0], by_member[1]
    loss = shard_loss("g0", 0)
    budget = loss.__enter__()
    try:
        h = server.submit(Q_SINGLE, {"id": victim})
        _drive(server, group)
        assert h.exception(timeout=5) is not None   # max_attempts=1
        assert budget.injected == 1
        assert group.member_state(0) == MEMBER_QUARANTINED
        assert group.member_state(1) == MEMBER_HEALTHY
        assert group.health() == GROUP_DEGRADED
        assert server.health() == "degraded"
        # the healthy member keeps serving its shard
        h2 = server.submit(Q_SINGLE, {"id": survivor})
        _drive(server, group)
        assert result_digest(h2.result(timeout=5)) \
            == result_digest(graph.cypher(Q_SINGLE, {"id": survivor}))
        # cooldown not elapsed: the maintenance pass rebuilds nothing
        assert group.maintenance_tick() is False
        assert group.members[0].rebuilds == 0
        # cooldown elapsed, fault still active: the rebuild's canary
        # fails on the member's own stream and buys another cooldown
        fake_clock.advance(10.0)
        assert group.maintenance_tick() is False
        assert group.members[0].probes == 1
        assert group.member_state(0) == MEMBER_QUARANTINED
        assert group.health() == GROUP_DEGRADED
        reg = session.metrics_snapshot()
        assert reg["shard.rebuild_failures"] == 1
    finally:
        loss.__exit__(None, None, None)
    # fault lifted + cooldown elapsed: rebuild onto a spare session
    # succeeds, the canary passes, the member reinstates
    fake_clock.advance(10.0)
    assert group.maintenance_tick() is True
    assert group.member_state(0) == MEMBER_HEALTHY
    assert group.health() == GROUP_HEALTHY
    assert server.health() == "healthy"
    m0 = group.members[0]
    assert m0.rebuilds == 1 and m0.reinstates == 1
    assert m0.incarnation == 1
    assert m0.quarantines == 1 and m0.probes == 2
    # the rebuilt member serves its shard again, digest-equal
    h3 = server.submit(Q_SINGLE, {"id": victim})
    _drive(server, group)
    assert result_digest(h3.result(timeout=5)) \
        == result_digest(graph.cypher(Q_SINGLE, {"id": victim}))
    states = [t["state"] for t in group.summary()["transitions"]]
    assert states == [GROUP_HEALTHY, GROUP_DEGRADED, GROUP_HEALTHY]
    reg = session.metrics_snapshot()
    assert reg["shard.member.quarantined"] == 1
    assert reg["shard.member.reinstated"] == 1
    assert reg["shard.rebuilds"] == 1
    server.shutdown(drain=False)


def test_group_quarantine_sheds_and_requeues(fake_clock):
    """Group-level quarantine: rebuild failures past the group
    threshold open the group — new group traffic sheds at admission
    with the remaining cooldown as the retry hint, claimed batches
    requeue, and recovery re-opens the tap."""
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False, config=ServerConfig(
        shards=2,
        shard_config=ShardGroupConfig(
            name="gq", partitions_per_member=1,
            member_failure_threshold=1, member_cooldown_s=5.0,
            group_failure_threshold=1),
        retry=RetryPolicy(max_attempts=1, backoff_base_s=0.0, jitter=0.0),
        breaker_threshold=1000))
    group = server.shard_groups[0]
    victim_id = next(i for i in range(1, 6)
                     if group.owning_member(i)[1].index == 0)
    loss = shard_loss("gq", 0)
    loss.__enter__()
    try:
        h = server.submit(Q_SINGLE, {"id": victim_id})
        _drive(server, group)
        assert h.exception(timeout=5) is not None
        assert group.health() == GROUP_DEGRADED
        # one failed rebuild cycle >= group threshold: group quarantined
        fake_clock.advance(5.0)
        group.maintenance_tick()
        assert group.health() == GROUP_QUARANTINED
        assert server.devices.is_healthy(group) is False
        # new group-routed traffic sheds with an honest retry hint
        with pytest.raises(Overloaded) as exc_info:
            server.submit(Q_SINGLE, {"id": victim_id})
        assert exc_info.value.retry_after_s > 0
        assert session.metrics_snapshot()["shard.shed"] >= 1
        # a batch claimed toward the quarantined group requeues instead
        # of executing (submit went through BEFORE the quarantine —
        # simulate by injecting the request directly)
        from caps_tpu_torch.serve import batcher as _batcher
        from caps_tpu_torch.serve.deadline import CancelScope
        from caps_tpu_torch.serve.request import Request
        mode, plan_key, key = _batcher.request_keys(
            graph, Q_SINGLE, {"id": victim_id})
        req = Request(Q_SINGLE, {"id": victim_id}, graph, 0,
                      CancelScope(None), key, mode, plan_key=plan_key)
        server.admission.requeue(req)
        depth_before = server.admission.depth()
        _drive(server, server.devices.replicas[0])
        assert not req.handle.done()
        assert server.admission.depth() == depth_before
        assert session.metrics_snapshot()["serve.requeued"] >= 2
    finally:
        loss.__exit__(None, None, None)
    # recovery: rebuild succeeds, member reinstates, group heals, the
    # requeued request drains and new submits are admitted again
    fake_clock.advance(5.0)
    assert group.maintenance_tick() is True
    assert group.health() == GROUP_HEALTHY
    _drive(server, group)
    assert result_digest(req.handle.result(timeout=5)) \
        == result_digest(graph.cypher(Q_SINGLE, {"id": victim_id}))
    h2 = server.submit(Q_SINGLE, {"id": victim_id})
    _drive(server, group)
    assert h2.result(timeout=5) is not None
    states = [t["state"] for t in group.summary()["transitions"]]
    assert states == [GROUP_HEALTHY, GROUP_DEGRADED, GROUP_QUARANTINED,
                      GROUP_HEALTHY]
    server.shutdown(drain=False)


def test_member_failures_are_consecutive_not_lifetime(fake_clock):
    """A served request ends the member's failure streak
    (regression: two member faults days apart — each healed by the
    retry ladder — must not sum to a quarantine)."""
    session = _session()
    graph = _graph(session)
    group = _group(session, graph, member_failure_threshold=2)
    target = next(i for i in range(1, 6)
                  if group.owning_member(i)[1].index == 0)
    for _round in range(3):
        with shard_loss("g0", 0, n_times=1):
            with pytest.raises(Exception) as exc_info:
                group.execute(Q_SINGLE, {"id": target})
        group.record_failure(exc_info.value)  # what the server would do
        assert group.member_state(0) == MEMBER_HEALTHY, _round
        # a successful request in between resets the streak
        group.execute(Q_SINGLE, {"id": target})
    assert group.health() == GROUP_HEALTHY


def test_group_quarantined_by_cross_faults_recovers(fake_clock):
    """A group quarantined by UNATTRIBUTED cross-shard device faults
    has no tripped member to rebuild — the maintenance pass must probe
    the cross-shard session itself and clear the group trip
    (regression: the group was bricked forever)."""
    session = _session()
    graph = _graph(session)
    group = _group(session, graph, group_failure_threshold=2,
                   member_cooldown_s=5.0)
    with sick_shard("g0", error_rate=1.0) as budget:
        for _ in range(2):
            with pytest.raises(Exception) as exc_info:
                group.execute(Q_EDGE, {"min": 25})
            assert getattr(exc_info.value, "caps_shard_member",
                           None) is None
            group.record_failure(exc_info.value)
        assert budget.injected == 2
    assert group.health() == GROUP_QUARANTINED
    assert all(s == MEMBER_HEALTHY
               for s in group.member_health().values())
    assert group.shed_retry_after() is not None
    # cooldown not elapsed: nothing probes yet
    assert group.maintenance_tick() is False
    assert group.health() == GROUP_QUARANTINED
    # cooldown elapsed, fault lifted: the cross canary passes and the
    # group un-quarantines — no member rebuild involved
    fake_clock.advance(5.0)
    assert group.maintenance_tick() is True
    assert group.health() == GROUP_HEALTHY
    assert result_digest(group.execute(Q_EDGE, {"min": 25})) \
        == result_digest(graph.cypher(Q_EDGE, {"min": 25}))


def test_shard_faults_scope_to_their_group():
    """``shard_loss(group, member)`` hits ONLY the targeted member's
    single-shard stream and the group's cross-shard programs — the
    other member and plain (un-bracketed) sessions never see it."""
    session = _session()
    graph = _graph(session)
    group = _group(session, graph)
    by_member = {}
    for i in range(1, 6):
        by_member.setdefault(group.owning_member(i)[1].index, i)
    with shard_loss("g0", 0) as budget:
        # un-bracketed execution (a replica member's stream): untouched
        assert graph.cypher(Q_SINGLE, {"id": by_member[0]}) is not None
        # the other member's stream: untouched
        assert group.execute(Q_SINGLE, {"id": by_member[1]}) is not None
        assert budget.injected == 0
        # the victim's stream: dead
        with pytest.raises(Exception) as exc_info:
            group.execute(Q_SINGLE, {"id": by_member[0]})
        assert "injected shard loss" in str(exc_info.value)
        assert getattr(exc_info.value, "caps_shard_member", None) == 0
        # group-wide cross-shard programs span the dead device: dead
        with pytest.raises(Exception):
            group.execute(Q_EDGE, {"min": 25})
        assert budget.injected == 2
    assert executing_shard() is None


def test_sick_shard_deterministic_rate():
    session = _session()
    graph = _graph(session)
    group = _group(session, graph)
    target = next(i for i in range(1, 6)
                  if group.owning_member(i)[1].index == 1)
    errors = 0
    with sick_shard("g0", member=1, error_rate=0.5) as budget:
        for _ in range(8):
            try:
                group.execute(Q_SINGLE, {"id": target})
            except Exception:
                errors += 1
    assert errors == budget.injected == 4  # every 2nd, exactly


# -- paging -----------------------------------------------------------------

def test_paging_spill_and_fault_in_digest_parity():
    session = _session()
    n = 24
    graph = create_graph(session, "CREATE " + ", ".join(
        f"(p{i}:Person {{id: {i}, name: 'P{i}', age: {20 + i}}})"
        for i in range(1, n + 1)))
    probe = _group(session, graph, partitions_per_member=4)
    # budget ~ half a member's total: partitions must rotate through
    # device residency (spill + fault-in) as routed accesses move
    # across shards — correctness must be residency-independent
    member_sums = [sum(probe.partitions[p].host_nbytes()
                       for p in m.partitions) for m in probe.members]
    budget = min(member_sums) // 2
    assert budget > max(probe.partitions[p].host_nbytes()
                        for m in probe.members for p in m.partitions)
    paged = ShardGroup(
        session, graph,
        ShardGroupConfig(name="paged", members=2, partitions_per_member=4,
                         page_budget_bytes=budget),
        registry=session.metrics_registry)
    for m in paged.members:
        assert m.resident_bytes() <= budget
        assert len(m.resident) < len(m.partitions)  # some stayed cold
    for i in list(range(1, n + 1)) + list(range(1, n + 1)):
        with paged.lock:
            got = paged.execute(Q_SINGLE, {"id": i})
        assert result_digest(got) \
            == result_digest(graph.cypher(Q_SINGLE, {"id": i})), i
    summary = paged.summary()["paging"]
    assert summary["faults"] > 0
    assert summary["spills"] > 0
    assert summary["host_bytes"] > 0
    for m in paged.members:
        assert m.resident_bytes() <= budget
    reg = session.metrics_snapshot()
    assert reg["paging.faults"] == summary["faults"]
    assert reg["paging.spills"] == summary["spills"]
    assert reg["paging.resident_bytes"] > 0
    assert reg["paging.host_bytes"] > 0


def test_no_budget_means_fully_resident():
    session = _session()
    group = _group(session, _graph(session))
    for m in group.members:
        assert sorted(m.resident) == sorted(m.partitions)
    assert group.cold_host_bytes() == 0
    for _ in range(3):
        with group.lock:
            group.execute(Q_SINGLE, {"id": 2})
    assert sum(m.page_faults for m in group.members) == 0


# -- retry_target satellite fix --------------------------------------------

def test_retry_target_excludes_every_failed_index():
    session = _session()
    rs = ReplicaSet(session, n_devices=3,
                    registry=session.metrics_registry)
    # two failed devices: the only healthy survivor must ALWAYS win —
    # before the fix, retry_target(exclude_index=1) could round-robin
    # back onto already-failed device 0
    for _ in range(10):
        assert rs.retry_target([0, 1]).index == 2
    # int form still works (back-compat)
    for _ in range(10):
        assert rs.retry_target(0).index != 0
    # everything failed: fall back to the most recent failure
    assert rs.retry_target([2, 0, 1]).index == 1


def test_writes_served_on_group_graphs():
    """The durable-writes PR lifts the old write rejection: a CREATE
    through a sharded server commits on the group's internal lineage
    and is visible to both the routed and cross-shard read paths."""
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(shards=2))
    h = server.submit("CREATE (n:Person {id: 99, name: 'Zed'})")
    _drive(server, server.shard_groups[0])
    assert h.exception(timeout=5) is None
    h2 = server.submit(Q_SINGLE, graph=graph, parameters={"id": 99})
    _drive(server, server.shard_groups[0])
    assert h2.result(timeout=5).to_maps() == [{"name": "Zed"}]
    server.shutdown(drain=False)


# -- warmup integration -----------------------------------------------------

def test_cold_process_sharded_server_first_query_zero_compile(tmp_path):
    """The cold-start round trip: a sharded server records its warm
    bindings on the GROUP's member sessions, persists them to the plan
    store at shutdown, and a fresh 'process' (fresh template session,
    freshly partitioned graph) warmed from that store serves its first
    single-shard client query with 0.0 compile seconds charged."""
    from caps_tpu_torch.serve import WarmupConfig
    store = str(tmp_path / "plans.json")
    binding = {"id": 3}

    session_a = _session()
    graph_a = _graph(session_a)
    server_a = QueryServer(session_a, graph=graph_a, config=ServerConfig(
        shards=2, warmup=WarmupConfig(store_path=store, background=False)))
    try:
        first = server_a.run(Q_SINGLE, binding)
        assert first.metrics["compile_s_charged"] > 0.0  # cold
        warm = server_a.run(Q_SINGLE, binding)
        assert warm.metrics["compile_s_charged"] == 0.0
        server_a.run(Q_EDGE, {"min": 25})  # a cross-shard family too
    finally:
        assert server_a.shutdown()         # persists the store
    # a family that only compiled on the group is covered in the report
    report_a = server_a.warmup_report(
        families=[f["family"]
                  for f in server_a.shard_groups[0].warmup_bindings()])
    assert report_a["cold_families"] == []

    session_b = _session()
    graph_b = _graph(session_b)
    server_b = QueryServer(session_b, graph=graph_b, config=ServerConfig(
        shards=2, warmup=WarmupConfig(store_path=store, background=False)))
    try:
        wr = server_b.stats()["warmup"]
        assert wr["state"] == "done" and wr["completed"] >= 2, wr
        res = server_b.run(Q_SINGLE, binding)
        assert res.metrics["compile_s_charged"] == 0.0
        assert result_digest(res) \
            == result_digest(graph_b.cypher(Q_SINGLE, binding))
        cross = server_b.run(Q_EDGE, {"min": 25})
        assert cross.metrics["compile_s_charged"] == 0.0
    finally:
        server_b.shutdown()


# -- the acceptance soak ----------------------------------------------------

def _shard_loss_soak(per_thread: int):
    session = _session()
    default_graph = _graph(session)       # replica-served
    big = create_graph(session, PEOPLE)   # the group-served graph
    server = QueryServer(session, graph=default_graph, shard_graph=big,
                         config=ServerConfig(
                             devices=2, shards=2, max_queue=4096,
                             max_batch=4,
                             shard_config=ShardGroupConfig(
                                 name="soak", partitions_per_member=2,
                                 member_failure_threshold=1,
                                 member_cooldown_s=0.02),
                             device_failure_threshold=1000,
                             breaker_threshold=1000,
                             retry=RetryPolicy(max_attempts=40,
                                               backoff_base_s=0.002,
                                               backoff_max_s=0.02)))
    group = server.shard_groups[0]
    flat = [(big, Q_SINGLE, {"id": i}) for i in range(1, 6)] + \
        [(big, Q_EDGE, {"min": m}) for m in (25, 35)] + \
        [(big, Q_COUNT, {"y": 2015})] + \
        [(default_graph, Q_EDGE, {"min": m}) for m in (25, 45)]
    expected = {i: _bag(g.cypher(q, b).records.to_maps())
                for i, (g, q, b) in enumerate(flat)}
    n_threads = 8
    results: dict = {}
    submit_errors: list = []

    def run_phase(phase: int):
        def client(tid: int):
            try:
                for j in range(per_thread):
                    i = (tid * 7 + phase + j) % len(flat)
                    g, q, b = flat[i]
                    results[(phase, tid, j)] = (i, server.submit(
                        q, b, graph=g))
            except Exception as ex:  # pragma: no cover
                submit_errors.append(ex)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for _i, handle in results.values():
            assert handle.wait(timeout=60)

    try:
        run_phase(0)                       # healthy warm-up phase
        assert group.health() == GROUP_HEALTHY
        # member 0 dies mid-run: a bounded loss — the background
        # rebuild's canary consumes the tail of the budget and heals
        # the member (the "recovered device")
        with shard_loss("soak", 0, n_times=6) as budget:
            run_phase(1)
        assert budget.injected >= 1
        # availability 1.0: every request of both phases resolved with
        # digest-equal rows — no typed give-ups, no untyped leaks
        assert not submit_errors, submit_errors
        assert len(results) == 2 * n_threads * per_thread
        for i, handle in results.values():
            ex = handle.exception()
            assert ex is None, (i, ex)
            assert _bag(handle.rows()) == expected[i], i
        # the victim's group degraded and rebuilt; replica members
        # (serving the default graph) were never touched
        summary = group.summary()
        states = [t["state"] for t in summary["transitions"]]
        assert GROUP_DEGRADED in states
        assert summary["members"][0]["quarantines"] >= 1
        assert summary["members"][0]["rebuilds"] >= 1
        deadline = time.time() + 10
        while group.health() != GROUP_HEALTHY and time.time() < deadline:
            time.sleep(0.02)
        assert group.health() == GROUP_HEALTHY
        assert all(h == HEALTHY
                   for h in server.device_health().values())
        snap = session.metrics_snapshot()
        assert snap["serve.completed"] == 2 * n_threads * per_thread
    finally:
        server.shutdown()
    return session.metrics_snapshot()


def test_soak_shard_member_killed_mid_run():
    from caps_tpu_torch.obs.metrics import global_registry
    before = global_registry().snapshot().get(
        "faults.injected.shard_loss", 0)
    _shard_loss_soak(per_thread=4)
    assert global_registry().snapshot()["faults.injected.shard_loss"] \
        > before


@pytest.mark.slow
def test_soak_shard_member_killed_mid_run_long():
    _shard_loss_soak(per_thread=20)


# -- surfaces ---------------------------------------------------------------

def test_stats_and_health_report_expose_shards():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(shards=2))
    try:
        shards = server.stats()["shards"]
        assert len(shards) == 1
        s = shards[0]
        assert s["state"] == GROUP_HEALTHY
        assert {m["health"] for m in s["members"]} == {MEMBER_HEALTHY}
        assert "paging" in s and "transitions" in s
        hr = server.health_report()
        assert hr["shards"][0]["name"] == s["name"]
        # the shard/paging gauges ride the normal exposition
        text = server.metrics_text()
        assert "shard_groups 1" in text
        assert "paging_resident_bytes" in text
    finally:
        server.shutdown(drain=False)


# -- the port against the JAX package ----------------------------------------

def _jax_session():
    import caps_tpu
    return caps_tpu.local_session(backend="local")


def _jax_graph(session):
    from caps_tpu.testing.factory import create_graph as jax_create_graph
    return jax_create_graph(session, PEOPLE)


def _slice_rows(s):
    cols = sorted(s.data)
    data = {c: (s.data[c].tolist() if hasattr(s.data[c], "tolist")
                else list(s.data[c])) for c in cols}
    valid = getattr(s, "valid", {})
    for c, ok in valid.items():
        data[c] = [v if o else None for v, o in zip(data[c], ok.tolist())]
    return [tuple(data[c][i] for c in cols) for i in range(s.rows)], cols


@pytest.mark.parametrize("prop,n", [("id", 4), ("id", 3), ("name", 2),
                                    ("age", 5), ("missing", 3)])
def test_partitions_equal_the_reference_row_for_row(prop, n):
    from caps_tpu.serve.shards import partition_graph as jax_partition
    got = partition_graph(_graph(_session()), n, prop)
    want = jax_partition(_jax_graph(_jax_session()), n, prop)
    assert len(got) == len(want) == n
    for gp, wp in zip(got, want):
        for gs, ws in zip(gp.node_slices + gp.rel_slices,
                          wp.node_slices + wp.rel_slices):
            assert gs.kind == ws.kind and gs.rows == ws.rows
            g_rows, g_cols = _slice_rows(gs)
            w_rows, w_cols = _slice_rows(ws)
            assert g_cols == w_cols
            assert g_rows == w_rows


def test_partition_home_map_equals_the_reference():
    from caps_tpu.serve.shards import partition_graph as jax_partition
    got, want = {}, {}
    partition_graph(_graph(_session()), 3, "name", home_out=got)
    jax_partition(_jax_graph(_jax_session()), 3, "name", home_out=want)
    assert got == want


def test_hash_value_equals_the_reference():
    from caps_tpu.serve.shards import hash_value as jax_hash
    values = [0, 1, -1, 5, 5.0, 5.5, -0.0, 2 ** 62, -(2 ** 63) + 1, True,
              False, "", "x", "Alice", "ü", None, 1e300, float("inf")]
    for v in values:
        assert hash_value(v) == jax_hash(v), v


ROUTE_QUERIES = [
    Q_SINGLE, Q_SINGLE_MAP, Q_EDGE, Q_TWOHOP, Q_COUNT,
    "MATCH (n:Person) WHERE $id = n.id RETURN n.name AS name",
    "MATCH (n:Person) WHERE n.id = $id AND n.age > 30 RETURN count(*) AS c",
    "MATCH (n) WHERE n.id = $id WITH n.age AS a RETURN a",
    "MATCH (n:Person) WHERE n.id = 3 RETURN n.name AS name",
    "MATCH (n:Person), (m:City) WHERE n.id = $id "
    "RETURN n.name AS a, m.name AS b",
    "OPTIONAL MATCH (n:Person) WHERE n.id = $id RETURN n.name AS name",
    "UNWIND [1, 2] AS x MATCH (n) WHERE n.id = $id "
    "RETURN n.name AS name, x",
    "MATCH (n:Person) WHERE n.age = $id RETURN n.name AS name",
    "MATCH (n:Person) RETURN n.name AS name",
    "EXPLAIN " + Q_SINGLE, "CREATE (n:Person {id: 99})",
    "MATCH (n:Person) WHERE n.id = $id AND EXISTS { (n)-->() } "
    "RETURN n.name AS name",
    "MATCH (n:Person) WHERE n.id = $id WITH n RETURN n.name AS name "
    "ORDER BY name",
]


def test_routing_decisions_equal_the_reference():
    from caps_tpu.serve.shards import ShardGroup as JaxGroup
    from caps_tpu.serve.shards import ShardGroupConfig as JaxConfig
    s, js = _session(), _jax_session()
    group = _group(s, _graph(s))
    jgroup = JaxGroup(js, _jax_graph(js),
                      JaxConfig(name="g0", members=2,
                                partitions_per_member=2),
                      registry=js.metrics_registry)
    for q in ROUTE_QUERIES:
        assert group._route(q) == jgroup._route(q), q
    for v in list(range(1, 6)) + [2.0, "x", True, None]:
        assert group.owning_member(v)[0] == jgroup.owning_member(v)[0]
        assert group.owning_member(v)[1].index == \
            jgroup.owning_member(v)[1].index


def test_device_group_digest_parity_and_streams():
    """A group over a device session on the CPU: members are device
    sessions (mesh-free), the cross-shard session a 2-shard mesh
    session, and every query digest-equal to the unsharded graph."""
    session = caps_tpu_torch.local_session(device="cpu")
    graph = _graph(session)
    group = _group(session, graph, partitions_per_member=3)
    assert group.cross_meshed and group.cross_session.backend.n_shards == 2
    for m in group.members:
        assert m.session.backend.mesh is None and m.stream is None
    for q, params in [(Q_SINGLE, {"id": i}) for i in range(1, 6)] + [
            (Q_EDGE, {"min": 25}), (Q_TWOHOP, {"id": 1}),
            (Q_COUNT, {"y": 2015})]:
        assert result_digest(group.execute(q, params)) \
            == result_digest(graph.cypher(q, params)), (q, params)
