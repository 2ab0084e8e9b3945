"""Durable writes in the port (caps_tpu_torch/durability/): the WAL, the
epoch-fenced lease, crash recovery and owner failover — the counterpart
of ``tests/test_wal.py`` on ``device="cpu"`` sessions and
``backend="cpu"`` fleet backends, plus the cross-package checks: a log,
a frame or a lease written by one package is read the same way by the
other.

The contracts under test:

* the commit log — append/recover round-trips the exact cumulative
  delta payload; recovery takes the single highest intact entry;
  a torn or CRC-bad tail is dropped WHOLE and counted
  (``wal.torn_entries``), then truncated physically so the retried
  append lands where the last intact frame ended; duplicate versions
  skip (idempotent peer installs); segments rotate and checkpoints
  truncate them; an unreadable checkpoint refuses loudly instead of
  silently forgetting acked writes;
* failure honesty — a failed fsync raises the typed transient
  :class:`WalWriteError` (``caps_transient`` + ``caps_wal_fault``) and
  the commit rolls back through the string-pool mark: never a silent
  ack, and the graph is bit-for-bit untouched;
* the lease — epoch-fenced ownership through the shared store: a live
  lease blocks rivals, expiry allows a steal at a HIGHER epoch, the
  O_EXCL claim file makes the epoch a compare-and-swap;
* fleet failover — kill the write owner, the router elects the peer
  with the longest replayed log, every acknowledged write survives,
  and a zombie owner's stale-epoch frame is fenced with
  :class:`StaleEpoch` naming the true owner;
* the formats — equal payloads give byte-equal frames in both
  packages, a log written by either recovers in the other to the same
  version and state, a torn tail drops the same way, and a lease one
  package claims is seen and fenced by the other.

* sharded commits — a shard group's writes (``serve/shards.py``) go
  through its group WAL as one atomic commit: digests equal the JAX
  package's unsharded ``VersionedGraph``'s, a fresh group recovers from
  the group WAL, a failed WAL append or a member's failed prepare rolls
  every member back, and routed point reads see the writes (the
  reference's sharded-commit tests, on both of the port's backends).
"""
from __future__ import annotations

import os
import time

import pytest

import caps_tpu
import caps_tpu.durability as jax_durability
import caps_tpu_torch
from caps_tpu.testing import faults as jax_faults
from caps_tpu.testing.factory import create_graph as jax_create_graph
from caps_tpu.relational.updates import VersionedGraph as JaxVersionedGraph
from caps_tpu.relational.updates import (
    delta_state_to_payload as jax_delta_state_to_payload)
from caps_tpu_torch.durability import (CommitLog, LeaseStore,
                                       compose_delta_payloads, empty_payload,
                                       scan_durable_dir)
from caps_tpu_torch.durability import wal as port_wal
from caps_tpu_torch.obs.metrics import MetricsRegistry
from caps_tpu_torch.relational.session import result_digest
from caps_tpu_torch.relational.updates import (VersionedGraph,
                                               delta_state_from_payload,
                                               delta_state_to_payload)
from caps_tpu_torch.serve.errors import StaleEpoch, WalWriteError
from caps_tpu_torch.serve.fleet import BackendSpec, FleetBackend
from caps_tpu_torch.serve.router import FleetRouter, RouterConfig
from caps_tpu_torch.serve.shards import ShardGroup, ShardGroupConfig
from caps_tpu_torch.serve.wire import WireClient
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import failing_fsync, torn_wal

PEOPLE = """
    CREATE (a:Person {id: 1, name: 'Alice', age: 33}),
           (b:Person {id: 2, name: 'Bob', age: 44}),
           (c:Person {id: 3, name: 'Carol', age: 27}),
           (a)-[:KNOWS {since: 2011}]->(b),
           (b)-[:KNOWS {since: 2015}]->(c)
"""

WRITES = (
    ("CREATE (n:Person {id: 9, name: 'Zed', age: 20})", {}),
    ("MATCH (p:Person {id: 2}) SET p.age = 45", {}),
    ("MATCH (p:Person {id: 9}) "
     "CREATE (p)-[:KNOWS {since: 2026}]->(q:Person {id: 10, name: 'Yan'})",
     {}),
    ("MATCH (p:Person {id: 3}) DETACH DELETE p", {}),
)

READS = (
    ("MATCH (n:Person) RETURN n.id AS id, n.name AS name, n.age AS age",
     {}),
    ("MATCH (a:Person)-[k:KNOWS]->(b) "
     "RETURN a.id AS a, b.id AS b, k.since AS s", {}),
    ("MATCH (n:Person) WHERE n.id = $id RETURN n.name AS name", {"id": 9}),
    ("MATCH (n:Person) WHERE n.id = $id RETURN n.name AS name", {"id": 3}),
    ("MATCH (n:Person) WHERE n.id = $id RETURN n.age AS age", {"id": 2}),
)


def _payload(node_id: int):
    """A minimal cumulative delta payload: one appended node."""
    p = empty_payload()
    p["nodes"] = [[node_id, ["Person"], [["name", f"n{node_id}"]]]]
    return p


def _digests(run):
    return [result_digest(run(q, p)) for q, p in READS]


# -- commit log: append / recover --------------------------------------------

def test_empty_log_recovers_to_version_zero(tmp_path):
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == 0
    assert rec.entries == 0
    assert rec.torn_entries == 0
    assert rec.state == empty_payload()


def test_append_recover_round_trips_the_exact_payload(tmp_path):
    log = CommitLog(str(tmp_path))
    assert log.append(1, _payload(1)) is True
    log.close()
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == 1
    assert rec.entries == 1
    assert rec.state == _payload(1)


def test_recovery_takes_the_highest_intact_entry(tmp_path):
    log = CommitLog(str(tmp_path))
    for v in (1, 2, 3):
        log.append(v, _payload(v))
    log.close()
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == 3
    assert rec.entries == 3
    assert rec.state == _payload(3)


def test_duplicate_version_append_skips_idempotently(tmp_path):
    reg = MetricsRegistry()
    log = CommitLog(str(tmp_path), registry=reg)
    assert log.append(1, _payload(1)) is True
    # an idempotent re-install (peer catch-up replay) must not
    # double-log or regress the version
    assert log.append(1, _payload(1)) is False
    assert reg.snapshot()["wal.skipped_appends"] == 1
    log.close()
    assert CommitLog(str(tmp_path)).recover().entries == 1


def test_segments_rotate_under_the_byte_budget(tmp_path):
    reg = MetricsRegistry()
    log = CommitLog(str(tmp_path), segment_max_bytes=1, registry=reg)
    for v in (1, 2, 3):
        log.append(v, _payload(v))
    log.close()
    assert reg.snapshot()["wal.rotations"] == 2
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.segments == 3
    assert rec.version == 3


def test_checkpoint_only_store_recovers(tmp_path):
    log = CommitLog(str(tmp_path))
    log.checkpoint(5, _payload(5))
    log.close()
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == 5
    assert rec.checkpoint_version == 5
    assert rec.entries == 0
    assert rec.state == _payload(5)


def test_checkpoint_truncates_covered_segments(tmp_path):
    log = CommitLog(str(tmp_path), segment_max_bytes=1)
    for v in (1, 2, 3):
        log.append(v, _payload(v))
    assert log.checkpoint(3, _payload(3)) == 3
    # appends keep landing after the truncation, in fresh segments
    assert log.append(4, _payload(4)) is True
    log.close()
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == 4
    assert rec.checkpoint_version == 3
    assert rec.segments == 1


def test_replay_is_idempotent(tmp_path):
    log = CommitLog(str(tmp_path))
    for v in (1, 2):
        log.append(v, _payload(v))
    first = log.recover()
    second = log.recover()
    assert (first.version, first.state) == (second.version, second.state)
    log.close()


def test_unreadable_checkpoint_refuses_loudly(tmp_path):
    log = CommitLog(str(tmp_path))
    log.append(1, _payload(1))
    log.close()
    # older entries may have been truncated against the checkpoint, so
    # pretending a damaged one was empty would silently lose acked
    # writes — recovery must refuse instead
    with open(os.path.join(str(tmp_path), "checkpoint.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(WalWriteError):
        CommitLog(str(tmp_path)).recover()


def test_compose_delta_payloads_overrides_and_unions():
    a = {"hidden_nodes": [1], "hidden_rels": [],
         "nodes": [[2, ["P"], [["k", "a"]]], [3, ["P"], []]], "rels": []}
    b = {"hidden_nodes": [3], "hidden_rels": [4],
         "nodes": [[2, ["P"], [["k", "b"]]]], "rels": []}
    out = compose_delta_payloads(a, b)
    assert out["hidden_nodes"] == [1, 3]
    assert out["hidden_rels"] == [4]
    # b's record overrides a's; a's record deleted by b drops out
    assert out["nodes"] == [[2, ["P"], [["k", "b"]]]]


# -- commit log: torn tails and fsync faults ---------------------------------

def test_torn_tail_is_dropped_whole_and_counted(tmp_path):
    reg = MetricsRegistry()
    log = CommitLog(str(tmp_path), registry=reg)
    log.append(1, _payload(1))
    with torn_wal(n_bytes=6) as budget:
        with pytest.raises(RuntimeError) as exc_info:
            log.append(2, _payload(2))
    assert budget.injected == 1
    assert getattr(exc_info.value, "caps_wal_fault", None) is True
    log.close()
    rec = CommitLog(str(tmp_path), registry=reg).recover()
    assert rec.version == 1
    assert rec.torn_entries == 1
    assert rec.state == _payload(1)
    assert reg.snapshot()["wal.torn_entries"] == 1


def test_torn_tail_truncated_so_retried_append_lands(tmp_path):
    log = CommitLog(str(tmp_path))
    log.append(1, _payload(1))
    with torn_wal(n_bytes=6):
        with pytest.raises(RuntimeError):
            log.append(2, _payload(2))
    log.close()
    healed = CommitLog(str(tmp_path))
    assert healed.recover().torn_entries == 1
    # recovery truncated the garbage PHYSICALLY: the retried append
    # must land where the last intact frame ended, or it would sit
    # unreachable behind the torn bytes and be silently lost
    assert healed.append(2, _payload(2)) is True
    healed.close()
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == 2
    assert rec.torn_entries == 0


def test_failover_scan_never_truncates_a_peer_log(tmp_path):
    peer_dir = str(tmp_path / "wal-b0")
    log = CommitLog(peer_dir)
    log.append(1, _payload(1))
    with torn_wal(n_bytes=6):
        with pytest.raises(RuntimeError):
            log.append(2, _payload(2))
    log.close()
    seg = os.path.join(peer_dir, "wal-00000000.log")
    size_before = os.path.getsize(seg)
    best = scan_durable_dir(str(tmp_path))
    assert best is not None and best.version == 1
    # reading a peer's store must never write to it
    assert os.path.getsize(seg) == size_before


def test_fsync_failure_is_typed_transient_never_silent(tmp_path):
    log = CommitLog(str(tmp_path))
    with failing_fsync() as budget:
        with pytest.raises(WalWriteError) as exc_info:
            log.append(1, _payload(1))
    assert budget.injected == 1
    assert exc_info.value.caps_transient is True
    assert getattr(exc_info.value, "caps_wal_fault", None) is True
    # the partial frame was truncated away: the retried append lands
    assert log.append(1, _payload(1)) is True
    log.close()
    assert CommitLog(str(tmp_path)).recover().version == 1


# -- the lease ---------------------------------------------------------------

def test_lease_acquire_renew_and_conflict(tmp_path):
    reg = MetricsRegistry()
    store = LeaseStore(str(tmp_path), ttl_s=30.0, registry=reg)
    assert store.acquire("a") == 1
    assert store.holder("a") == 1
    assert store.holder("b") is None
    # a live lease blocks rivals and survives renewal at the SAME epoch
    assert store.acquire("b") is None
    assert store.renew("a") is True
    assert store.renew("b") is False
    assert store.acquire("a") == 1
    assert reg.snapshot()["wal.lease_conflicts"] >= 1


def test_expired_lease_steals_at_a_higher_epoch(tmp_path):
    store = LeaseStore(str(tmp_path), ttl_s=0.05)
    assert store.acquire("a") == 1
    time.sleep(0.12)
    # the epoch is the fence: ownership NEVER changes at the same epoch
    assert store.acquire("b") == 2
    assert store.holder("a") is None
    assert store.holder("b") == 2


def test_epoch_claim_is_a_compare_and_swap(tmp_path):
    store = LeaseStore(str(tmp_path), ttl_s=0.05)
    assert store.acquire("a") == 1
    time.sleep(0.12)
    # a rival already holds the O_EXCL claim for the next epoch: the
    # CAS loses and nobody publishes a second epoch-2 lease
    rival_claim = store._claim_path(2)
    with open(rival_claim, "w"):
        pass
    assert store.acquire("b") is None
    # a claim older than the TTL with no published lease is a crashed
    # claimant — it is broken and the next acquire goes through
    time.sleep(0.12)
    assert store.acquire("b") is None  # this call unlinks the wedge
    assert store.acquire("b") == 2


# -- lease edges (ISSUE 20 satellite): fake-clock TTL arithmetic, wedge
#    vs live renewal, and the same-epoch CAS race ----------------------------

class _LeaseClock:
    """Fake for ``clock.now`` only: lease expiry is monotonic
    arithmetic on the renewal stamp; ``clock.wall`` stays real because
    the wedged-claim sweep ages claim FILES (mtime is wall time)."""

    def __init__(self, t0: float = 1_000.0):
        self.t = t0

    def now(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture()
def lease_clock(monkeypatch):
    from caps_tpu_torch.obs import clock
    lc = _LeaseClock()
    monkeypatch.setattr(clock, "now", lc.now)
    return lc


def test_renewal_stamp_governs_expiry_not_acquisition_time(tmp_path,
                                                           lease_clock):
    store = LeaseStore(str(tmp_path), ttl_s=5.0)
    rival = LeaseStore(str(tmp_path), ttl_s=5.0)
    assert store.acquire("a") == 1
    lease_clock.advance(4.0)
    assert rival.acquire("b") is None
    assert store.renew("a") is True        # the stamp moves to NOW
    lease_clock.advance(4.0)
    # 8s since acquisition but only 4s since the renewal stamp: the
    # TTL is measured from the stamp on the monotonic clock, so a
    # renewing owner can never be deposed by clock arithmetic that
    # reaches back to its original claim (skew-free by construction)
    assert rival.acquire("b") is None
    assert store.holder("a") == 1
    lease_clock.advance(1.1)               # NOW the renewal is stale
    assert store.holder("a") is None
    assert rival.acquire("b") == 2


def test_wedged_claim_waits_out_a_live_renewal(tmp_path, lease_clock):
    """A claimant that crashed between winning the O_EXCL claim and
    publishing the lease leaves a wedge — but while the OWNER's lease
    is live, the wedge is unreachable (the conflict path returns before
    the claim CAS, and renewals never sweep).  Only after the owner
    expires does the steal path break the wedge and go through."""
    store = LeaseStore(str(tmp_path), ttl_s=5.0)
    rival = LeaseStore(str(tmp_path), ttl_s=5.0)
    assert store.acquire("a") == 1
    wedge = rival._claim_path(2)
    with open(wedge, "w"):
        pass
    past = time.time() - 60.0              # older than any TTL
    os.utime(wedge, (past, past))
    assert rival.acquire("b") is None      # live lease: conflict, no CAS
    assert store.renew("a") is True
    assert os.path.exists(wedge)           # renewal swept NOTHING
    lease_clock.advance(6.0)               # the owner dies
    assert rival.acquire("b") is None      # first attempt breaks the wedge
    assert not os.path.exists(wedge)
    assert rival.acquire("b") == 2


def test_two_claimants_cas_the_same_epoch_one_wins(tmp_path, lease_clock):
    """Both claimants read the expired lease and compute next_epoch=2;
    the O_EXCL claim file is the CAS.  Interleave the loser BETWEEN the
    winner's claim and its publish — the worst-case window — and
    exactly one epoch-2 lease exists afterwards."""
    store_b = LeaseStore(str(tmp_path), ttl_s=5.0)
    store_c = LeaseStore(str(tmp_path), ttl_s=5.0)
    assert store_b.acquire("a") == 1
    lease_clock.advance(6.0)
    results = {}
    orig_write = store_b._write

    def publish_hook(record):
        if record["owner"] == "b" and "c" not in results:
            # c races in AFTER b won the O_EXCL claim for epoch 2 but
            # BEFORE b published lease.json: c sees the expired epoch-1
            # lease, computes the SAME next epoch, and loses the CAS
            results["c"] = store_c.acquire("c")
        orig_write(record)

    store_b._write = publish_hook
    results["b"] = store_b.acquire("b")
    assert results == {"b": 2, "c": None}
    lease = store_c.read()
    assert (lease["owner"], lease["epoch"]) == ("b", 2)
    # the loser retries against the now-live epoch-2 lease: conflict,
    # never a second epoch-2 publication
    assert store_c.acquire("c") is None


# -- commit integration: append-before-acknowledge ---------------------------

@pytest.fixture
def versioned():
    session = caps_tpu_torch.local_session(device="cpu")
    graph = create_graph(session, PEOPLE)
    return session, VersionedGraph(session, graph)


def test_commit_rolls_back_when_the_wal_append_fails(tmp_path, versioned):
    session, vg = versioned
    log = CommitLog(str(tmp_path))
    vg.pre_publish = lambda snap: log.append(
        snap.snapshot_version, delta_state_to_payload(snap.state))
    before = _digests(lambda q, p: session.cypher_on_graph(vg, q, p))
    with failing_fsync():
        with pytest.raises(WalWriteError):
            session.cypher_on_graph(vg, *WRITES[0])
    # never a silent ack: the graph is untouched, the version did not
    # move, and nothing leaked into the string pool
    assert vg.current().snapshot_version == 0
    assert _digests(lambda q, p: session.cypher_on_graph(vg, q, p)) \
        == before
    assert session.metrics_snapshot()["updates.rolled_back"] >= 1
    # the SAME write retried lands exactly once
    session.cypher_on_graph(vg, *WRITES[0])
    assert vg.current().snapshot_version == 1
    assert CommitLog(str(tmp_path)).recover().version == 1


def test_wal_recovery_rebuilds_the_graph_exactly(tmp_path, versioned):
    session, vg = versioned
    log = CommitLog(str(tmp_path))
    vg.pre_publish = lambda snap: log.append(
        snap.snapshot_version, delta_state_to_payload(snap.state))
    for q, p in WRITES:
        session.cypher_on_graph(vg, q, p)
    want = _digests(lambda q, p: session.cypher_on_graph(vg, q, p))
    log.close()

    # a fresh process: spec-build the base graph, replay the log
    s2 = caps_tpu_torch.local_session(device="cpu")
    vg2 = VersionedGraph(s2, create_graph(s2, PEOPLE))
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == len(WRITES)
    vg2.install_state(delta_state_from_payload(rec.state), rec.version)
    assert _digests(lambda q, p: s2.cypher_on_graph(vg2, q, p)) == want


# -- fleet failover ----------------------------------------------------------

FLEET_CREATE = """
    CREATE (a:Person {name: 'Alice', age: 33}),
           (b:Person {name: 'Bob', age: 44})
"""
Q_NAMES = "MATCH (p:Person) RETURN p.name AS n ORDER BY n"


def _durable_spec(name, store):
    return BackendSpec(name=name, backend="cpu",
                       graph={"kind": "script", "create": FLEET_CREATE},
                       versioned=True, durable_dir=store,
                       wal_fsync="always", lease_ttl_s=0.4)


@pytest.fixture
def durable_fleet(tmp_path):
    store = str(tmp_path / "store")
    objs = {}
    backends = {}
    for name in ("b0", "b1", "b2"):
        b = FleetBackend(_durable_spec(name, store))
        objs[name] = b
        backends[name] = ("127.0.0.1", b.port)
    router = FleetRouter(backends, owner="b0",
                         config=RouterConfig(max_attempts=3,
                                             failover_wait_s=5.0),
                         registry=MetricsRegistry())
    yield router, objs, store
    router.close()
    for b in objs.values():
        b.shutdown(drain=False)


def test_acked_write_survives_backend_crash(durable_fleet, tmp_path):
    router, objs, store = durable_fleet
    out = router.write("CREATE (e:Person {name: 'Eve', age: 61})")
    assert out["version"] == 1
    assert out["epoch"] == 1  # first write claimed the lease
    # crash everything; a fresh owner process recovers from ITS log
    router.close()
    for b in objs.values():
        b.shutdown(drain=False)
    objs.clear()
    reborn = FleetBackend(_durable_spec("b0", store))
    try:
        assert reborn.graph.current().snapshot_version == 1
        with WireClient("127.0.0.1", reborn.port) as client:
            rows = client.call("query", query=Q_NAMES)["rows"]
        assert [r["n"] for r in rows] == ["Alice", "Bob", "Eve"]
    finally:
        reborn.shutdown(drain=False)


def test_owner_failover_elects_peer_and_keeps_acked_writes(durable_fleet):
    router, objs, _store = durable_fleet
    router.write("CREATE (e:Person {name: 'Eve', age: 61})")
    # SIGKILL-equivalent: the owner vanishes without drain
    objs["b0"].shutdown(drain=False)
    router.mark_dead("b0")
    out = router.write("CREATE (f:Person {name: 'Fay', age: 22})")
    # the peer with the longest replayed log won the epoch-fenced lease
    assert router.owner in ("b1", "b2")
    assert out["version"] == 2
    assert out["epoch"] == 2
    assert router.registry.snapshot()["router.failovers"] == 1
    # zero acked-write loss: both writes visible on the new owner
    rep = router._clients[router.owner].call("query", query=Q_NAMES)
    assert [r["n"] for r in rep["rows"]] == ["Alice", "Bob", "Eve", "Fay"]


def test_zombie_owner_is_fenced_by_epoch(durable_fleet):
    from caps_tpu_torch.obs import clock
    router, objs, store = durable_fleet
    router.write("CREATE (e:Person {name: 'Eve', age: 61})")
    # depose b0 behind its back: the shared lease now names b1/epoch 2
    LeaseStore(store)._write({"owner": "b1", "epoch": 2,
                              "renewed_t": clock.now()})
    with WireClient("127.0.0.1", objs["b0"].port) as client:
        with pytest.raises(StaleEpoch) as exc_info:
            client.call("write", epoch=1,
                        query="CREATE (z:Person {name: 'Zed', age: 1})")
    # the fence names the true owner so the router can adopt it
    assert exc_info.value.epoch == 1
    assert exc_info.value.lease_epoch == 2
    assert exc_info.value.owner == "b1"
    # the zombie's write never executed OR logged
    assert objs["b0"].graph.current().snapshot_version == 1
    assert objs["b0"].wal.recover().version == 1


# -- the formats against the JAX package -------------------------------------

PACKAGES = {"jax": jax_durability, "port": caps_tpu_torch.durability}


def _segment_bytes(dir_path):
    return {name: open(os.path.join(dir_path, name), "rb").read()
            for name in sorted(os.listdir(dir_path))}


@pytest.mark.parametrize("body", [b"", b"{}", "é∂ unicode".encode("utf-8"),
                                  bytes(range(256)) * 40])
def test_frame_bytes_equal_the_reference(body):
    from caps_tpu.durability import wal as jax_wal
    assert port_wal.frame_bytes(body) == jax_wal.frame_bytes(body)


def test_equal_appends_give_byte_equal_segments(tmp_path):
    dirs = {}
    for name, pkg in PACKAGES.items():
        dirs[name] = str(tmp_path / name)
        log = pkg.CommitLog(dirs[name], segment_max_bytes=200)
        for v in (1, 2, 3, 4):
            log.append(v, _payload(v), epoch=v // 2 or None)
        log.checkpoint(2, _payload(2), epoch=1)
        log.append(5, _payload(5), epoch=3)
        log.close()
    assert _segment_bytes(dirs["jax"]) == _segment_bytes(dirs["port"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_log_recovers_the_same_in_both_packages(tmp_path, writer, reader):
    d = str(tmp_path / "wal")
    log = PACKAGES[writer].CommitLog(d, segment_max_bytes=120)
    for v in (1, 2, 3):
        log.append(v, _payload(v), epoch=7)
    log.checkpoint(3, _payload(3), epoch=7)
    log.append(4, _payload(4), epoch=8)
    log.close()
    got = PACKAGES[reader].CommitLog(d).recover(truncate_torn=False)
    want = PACKAGES[writer].CommitLog(d).recover(truncate_torn=False)
    assert (got.version, got.epoch, got.state, got.entries,
            got.torn_entries, got.segments, got.checkpoint_version) \
        == (want.version, want.epoch, want.state, want.entries,
            want.torn_entries, want.segments, want.checkpoint_version) \
        == (4, 8, _payload(4), 1, 0, 1, 3)


@pytest.mark.parametrize("n_bytes", [0, 6, 11])
def test_a_torn_tail_drops_the_same_way(tmp_path, n_bytes):
    """The JAX package's ``torn_wal`` tears a frame; both packages drop
    it whole, count it once, and truncate it to the same length."""
    sizes = {}
    for reader in ("jax", "port"):
        d = str(tmp_path / reader)
        log = jax_durability.CommitLog(d)
        log.append(1, _payload(1))
        with jax_faults.torn_wal(n_bytes=n_bytes):
            with pytest.raises(RuntimeError):
                log.append(2, _payload(2))
        log.close()
        rec = PACKAGES[reader].CommitLog(d).recover()
        assert (rec.version, rec.state, rec.entries) == (1, _payload(1), 1)
        assert rec.torn_entries == (1 if n_bytes else 0)
        sizes[reader] = _segment_bytes(d)
    assert sizes["jax"] == sizes["port"]


def test_port_torn_wal_tears_like_the_reference(tmp_path):
    images = {}
    for name, tear in (("jax", jax_faults.torn_wal),
                       ("port", torn_wal)):
        d = str(tmp_path / name)
        log = PACKAGES[name].CommitLog(d)
        log.append(1, _payload(1))
        with tear(n_bytes=9):
            with pytest.raises(RuntimeError) as exc_info:
                log.append(2, _payload(2))
        assert exc_info.value.caps_wal_fault is True
        log.close()
        images[name] = _segment_bytes(d)
    assert images["jax"] == images["port"]


def test_scan_durable_dir_picks_the_same_log(tmp_path):
    for i, (name, v) in enumerate((("b0", 2), ("b1", 5), ("b2", 3))):
        pkg = PACKAGES["jax" if i % 2 else "port"]
        log = pkg.CommitLog(str(tmp_path / f"wal-{name}"))
        for k in range(1, v + 1):
            log.append(k, _payload(k))
        log.close()
    a = scan_durable_dir(str(tmp_path))
    b = jax_durability.scan_durable_dir(str(tmp_path))
    assert (a.version, a.state, a.path) == (b.version, b.state, b.path)
    assert a.version == 5 and a.path.endswith("wal-b1")


def test_jax_versioned_log_replays_onto_a_port_graph(tmp_path):
    """Writes committed through the JAX package's versioned graph with
    its WAL hooked recover in the port's log and install onto the port's
    spec-built graph: every read answers as the JAX graph does."""
    js = caps_tpu.local_session(backend="local")
    jvg = JaxVersionedGraph(js, jax_create_graph(js, PEOPLE))
    jlog = jax_durability.CommitLog(str(tmp_path))
    jvg.pre_publish = lambda snap: jlog.append(
        snap.snapshot_version, jax_delta_state_to_payload(snap.state))
    for q, p in WRITES:
        js.cypher_on_graph(jvg, q, p)
    jlog.close()

    ps = caps_tpu_torch.local_session(device="cpu")
    pvg = VersionedGraph(ps, create_graph(ps, PEOPLE))
    rec = CommitLog(str(tmp_path)).recover()
    assert rec.version == len(WRITES)
    pvg.install_state(delta_state_from_payload(rec.state), rec.version)

    def rows(session, graph, q, p):
        return sorted(repr(sorted(r.items())) for r in
                      session.cypher_on_graph(graph, q, p).records.to_maps())
    for q, p in READS:
        assert rows(ps, pvg, q, p) == rows(js, jvg, q, p), q


@pytest.mark.parametrize("claimer,rival", [("jax", "port"), ("port", "jax")])
def test_a_lease_is_seen_and_fenced_across_packages(tmp_path, claimer, rival):
    a = PACKAGES[claimer].LeaseStore(str(tmp_path), ttl_s=30.0)
    b = PACKAGES[rival].LeaseStore(str(tmp_path), ttl_s=30.0)
    assert a.acquire("a") == 1
    assert b.read() == a.read()
    assert b.holder("a") == 1
    # a live lease written by one package blocks the other's claim
    assert b.acquire("b") is None
    assert b.renew("b") is False
    # the router namespace is independent in both
    ra = PACKAGES[claimer].LeaseStore(str(tmp_path), ttl_s=30.0,
                                      lease_name="lease-router")
    rb = PACKAGES[rival].LeaseStore(str(tmp_path), ttl_s=30.0,
                                    lease_name="lease-router")
    assert ra.lease_path == rb.lease_path
    assert rb.acquire("r0") == 1 and ra.holder("r0") == 1


@pytest.mark.parametrize("claimer,rival", [("jax", "port"), ("port", "jax")])
def test_an_expired_lease_is_stolen_across_packages(tmp_path, claimer,
                                                    rival):
    a = PACKAGES[claimer].LeaseStore(str(tmp_path), ttl_s=0.05)
    b = PACKAGES[rival].LeaseStore(str(tmp_path), ttl_s=0.05)
    assert a.acquire("a") == 1
    # the claim file one package would race on has the other's name
    assert os.path.basename(a._claim_path(2)) \
        == os.path.basename(b._claim_path(2))
    time.sleep(0.12)
    assert b.acquire("b") == 2
    # the deposed owner learns it from the other package's lease file
    assert a.holder("a") is None and a.renew("a") is False
    assert a.holder("b") == 2


# -- sharded commits ---------------------------------------------------------

#: the port's two backends: the device one on the CPU, and its oracle
BACKENDS = {"cuda": dict(device="cpu"), "local": dict(backend="local")}


def _sharded(backend, tmp_path=None):
    session = caps_tpu_torch.local_session(**BACKENDS[backend])
    graph = create_graph(session, PEOPLE)
    cfg = ShardGroupConfig(name="g0", members=2, partitions_per_member=2,
                           wal_dir=None if tmp_path is None
                           else str(tmp_path), wal_fsync="always")
    return session, ShardGroup(session, graph, cfg,
                               registry=session.metrics_registry)


_ORACLE: list = []


def _oracle_digests():
    """The READS' digests on the JAX package's unsharded VersionedGraph
    after the WRITES (computed once)."""
    if not _ORACLE:
        js = caps_tpu.local_session(backend="local")
        vg = JaxVersionedGraph(js, jax_create_graph(js, PEOPLE))
        for q, p in WRITES:
            js.cypher_on_graph(vg, q, p)
        _ORACLE.extend(_digests(lambda q, p: js.cypher_on_graph(vg, q, p)))
    return list(_ORACLE)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_writes_digest_parity_with_unsharded(tmp_path, backend):
    session, group = _sharded(backend, tmp_path)
    try:
        for q, p in WRITES:
            group.execute(q, p)
        assert _digests(group.execute) == _oracle_digests()
        snap = session.metrics_registry.snapshot()
        assert snap["shard.requests.write"] == len(WRITES)
        assert snap["shard.commits"] == len(WRITES)
        assert snap["wal.appends"] == len(WRITES)
        # the point lookups above routed to owning members, overlays on
        assert snap["shard.requests.single"] >= 3
        assert group.summary()["version"] == len(WRITES)
        assert group.summary()["durable"] is True
    finally:
        group.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_group_recovers_from_the_group_wal(tmp_path, backend):
    _session, group = _sharded(backend, tmp_path)
    try:
        for q, p in WRITES:
            group.execute(q, p)
    finally:
        group.close()
    # a fresh process: new session, spec-built graph, same group WAL
    _s2, reborn = _sharded(backend, tmp_path)
    try:
        assert reborn.summary()["version"] == len(WRITES)
        assert _digests(reborn.execute) == _oracle_digests()
    finally:
        reborn.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_commit_atomic_on_wal_failure(tmp_path, backend):
    session, group = _sharded(backend, tmp_path)
    try:
        group.execute(*WRITES[0])
        before = _digests(group.execute)
        with failing_fsync():
            with pytest.raises(WalWriteError):
                group.execute("CREATE (x:Person {id: 11, name: 'X'})")
        # the group WAL append is the commit point: its failure rolled
        # EVERY member back — no shard partially applied, version held
        assert group.summary()["version"] == 1
        assert _digests(group.execute) == before
        snap = session.metrics_registry.snapshot()
        assert snap["shard.commit_rollbacks"] == 1
        # the SAME write retried commits exactly once
        group.execute("CREATE (x:Person {id: 11, name: 'X'})")
        assert group.summary()["version"] == 2
        rows = group.execute(
            "MATCH (n:Person {id: 11}) RETURN count(*) AS c").to_maps()
        assert rows == [{"c": 1}]
    finally:
        group.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_commit_atomic_on_member_prepare_failure(monkeypatch,
                                                         backend):
    session, group = _sharded(backend)
    orig = ShardGroup.__dict__["_overlay_graph"].__func__
    state = {"armed": False, "injected": 0}

    def poisoned(sess, base, st, version):
        if state["armed"]:
            state["armed"] = False
            state["injected"] += 1
            raise RuntimeError("injected member prepare fault")
        return orig(sess, base, st, version)

    monkeypatch.setattr(ShardGroup, "_overlay_graph",
                        staticmethod(poisoned))
    try:
        group.execute(*WRITES[0])
        before = _digests(group.execute)
        state["armed"] = True
        with pytest.raises(Exception):
            group.execute(*WRITES[1])
        assert state["injected"] == 1
        # one member's prepare died mid-round: every member's pool mark
        # rolled back, no shard shows a half-applied overlay
        assert group.summary()["version"] == 1
        assert _digests(group.execute) == before
        assert session.metrics_registry.snapshot()[
            "shard.commit_rollbacks"] == 1
        group.execute(*WRITES[1])  # the retry lands
        assert group.summary()["version"] == 2
    finally:
        group.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_routed_single_shard_reads_see_writes(backend):
    session, group = _sharded(backend)
    try:
        for q, p in WRITES:
            group.execute(q, p)
        snap0 = session.metrics_registry.snapshot()
        routed0 = snap0.get("shard.requests.single", 0)
        # a created delta node, a SET node, and a deleted node — all
        # answered by the owning member's overlay, not the cross session
        q = "MATCH (n:Person) WHERE n.id = $id RETURN n.name AS name"
        assert group.execute(q, {"id": 9}).to_maps() == [{"name": "Zed"}]
        assert group.execute(q, {"id": 3}).to_maps() == []
        q_age = "MATCH (n:Person) WHERE n.id = $id RETURN n.age AS age"
        assert group.execute(q_age, {"id": 2}).to_maps() == [{"age": 45}]
        snap1 = session.metrics_registry.snapshot()
        assert snap1["shard.requests.single"] == routed0 + 3
    finally:
        group.close()
