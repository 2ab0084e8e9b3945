"""Live updates of the port (relational/updates.py, DeviceTable.drop_in,
the session's write path) against the JAX package.

Each scenario of ``tests/test_updates.py`` (the cases that need neither
the server nor several devices) runs once on the JAX package's device
session and once on a CPU session of the port, from the same CREATE
text: every read gives the same bag of rows, every write the same
``UpdateResult`` counts and snapshot version, and every failure the same
error class.  The port's own transcript is then held to the reference
test's assertions.  Two cases are new: a JAX ``delta_state_to_payload``
installed into the port reads the same answers, and a new snapshot
never replays the previous snapshot's recorded sizes.
"""
from __future__ import annotations

import threading
import types

import numpy as np

import caps_tpu_torch

SOCIAL = ("CREATE (a:Person {name:'Alice', age:30})-[:KNOWS {since:2018}]->"
          "(b:Person {name:'Bob', age:25}), "
          "(b)-[:KNOWS {since:2020}]->(c:Person {name:'Carol', age:41})")


def jax_pkg():
    from caps_tpu.backends.tpu.session import TPUCypherSession
    from caps_tpu.relational import updates
    from caps_tpu.relational.session import result_digest
    from caps_tpu.testing import factory, faults
    return types.SimpleNamespace(
        name="jax", session=TPUCypherSession, U=updates,
        create_graph=factory.create_graph, digest=result_digest,
        faults=faults, fold_step="build_node_tables")


def port_pkg():
    from caps_tpu_torch.relational import updates
    from caps_tpu_torch.relational.session import result_digest
    from caps_tpu_torch.testing import factory, faults
    return types.SimpleNamespace(
        name="port",
        session=lambda: caps_tpu_torch.local_session(device="cpu"),
        U=updates, create_graph=factory.create_graph, digest=result_digest,
        # compaction folds the tables on the card (``_fold_tables``)
        # where the reference re-ingests the live entities
        faults=faults, fold_step="_fold_tables")


def bag(result):
    if result.records is None:
        return []
    return sorted(repr(sorted(r.items()))
                  for r in result.records.to_maps())


def rows(result):
    return result.records.to_maps() if result.records is not None else []


class Log:
    """A scenario's transcript: reads as bags of rows, writes as their
    counts and snapshot version, failures as the error's class."""

    def __init__(self):
        self.entries = []

    def read(self, graph, query, params=None):
        res = graph.cypher(query, params or {})
        self.entries.append(("read", query, bag(res)))
        return res

    def write(self, graph, query, params=None):
        res = graph.cypher(query, params or {})
        self.entries.append(("write", query, res.metrics["updates"],
                             res.metrics["snapshot_version"]))
        return res

    def apply(self, vg, ops):
        info = vg.apply(ops)
        self.entries.append(("apply", info.counts(), info.version))
        return info

    def fails(self, fn, label):
        try:
            fn()
        except Exception as ex:
            # an injected device fault is jaxlib's XlaRuntimeError in the
            # JAX package and a RuntimeError in the port
            name = type(ex).__name__.replace("XlaRuntimeError",
                                              "RuntimeError")
            self.entries.append(("error", label, name))
            return ex
        raise AssertionError(f"{label}: no error raised")

    def note(self, label, value):
        self.entries.append(("note", label, value))


def both(scenario):
    """Run ``scenario(pkg, log)`` on both packages; the transcripts must
    be equal.  Returns the port's (log, scenario value)."""
    out = {}
    for pkg in (jax_pkg(), port_pkg()):
        log = Log()
        value = scenario(pkg, log)
        out[pkg.name] = (log, value)
    assert out["port"][0].entries == out["jax"][0].entries
    return out["port"]


def vgraph(pkg, session, create=SOCIAL):
    return pkg.U.versioned(session, pkg.create_graph(session, create))


def names(log, graph):
    return [r["n"] for r in rows(log.read(
        graph, "MATCH (p:Person) RETURN p.name AS n ORDER BY n"))]


# -- Cypher write semantics --------------------------------------------------

def test_create_nodes_and_rels():
    def scenario(pkg, log):
        vg = vgraph(pkg, pkg.session())
        r = log.write(vg, "CREATE (:Person {name:'Dave', age:$a})",
                      {"a": 52})
        assert r.metrics["updates"]["created_nodes"] == 1
        assert r.metrics["snapshot_version"] == 1
        assert names(log, vg) == ["Alice", "Bob", "Carol", "Dave"]
        log.write(vg, "MATCH (a:Person {name:'Alice'}), "
                      "(d:Person {name:'Dave'}) "
                      "CREATE (a)-[:KNOWS {since:$y}]->(d)", {"y": 2024})
        got = rows(log.read(vg, "MATCH (:Person {name:'Alice'})-[r:KNOWS]->"
                                "(t) RETURN t.name AS t, r.since AS y "
                                "ORDER BY y"))
        assert got == [{"t": "Bob", "y": 2018}, {"t": "Dave", "y": 2024}]
        log.write(vg, "CREATE (:City {name:'Zurich'})<-[:LIVES_IN]-"
                      "(:Person {name:'Erin', age:29})")
        assert rows(log.read(vg, "MATCH (p:Person)-[:LIVES_IN]->(c:City) "
                                 "RETURN p.name AS p, c.name AS c")) == \
            [{"p": "Erin", "c": "Zurich"}]
    both(scenario)


def test_create_per_matched_row():
    def scenario(pkg, log):
        vg = vgraph(pkg, pkg.session())
        r = log.write(vg, "MATCH (p:Person) CREATE (:Shadow {of: p.name})")
        assert r.metrics["updates"]["created_nodes"] == 3
        assert rows(log.read(vg, "MATCH (s:Shadow) RETURN count(*) AS c")) \
            == [{"c": 3}]
        log.read(vg, "MATCH (s:Shadow) RETURN s.of AS o")
    both(scenario)


def test_set_properties():
    def scenario(pkg, log):
        vg = vgraph(pkg, pkg.session())
        log.write(vg, "MATCH (p:Person {name:'Bob'}) "
                      "SET p.age = p.age + 1, p.nick = 'bobby'")
        assert rows(log.read(vg, "MATCH (p:Person {name:'Bob'}) "
                                 "RETURN p.age AS a, p.nick AS k")) == \
            [{"a": 26, "k": "bobby"}]
        log.write(vg, "MATCH (p:Person {name:'Bob'}) SET p += $m",
                  {"m": {"nick": None, "city": "Bern"}})
        assert rows(log.read(vg, "MATCH (p:Person {name:'Bob'}) "
                                 "RETURN p.nick AS k, p.city AS c")) == \
            [{"k": None, "c": "Bern"}]
        log.write(vg, "MATCH (p:Person {name:'Bob'}) SET p = $m",
                  {"m": {"name": "Bob", "age": 30}})
        assert rows(log.read(vg, "MATCH (p:Person {name:'Bob'}) "
                                 "RETURN p.age AS a, p.city AS c")) == \
            [{"a": 30, "c": None}]
    both(scenario)


def test_delete_semantics():
    def scenario(pkg, log):
        vg = vgraph(pkg, pkg.session())
        v_before = vg.current().snapshot_version
        ex = log.fails(lambda: vg.cypher(
            "MATCH (p:Person {name:'Bob'}) DELETE p"), "delete connected")
        assert isinstance(ex, pkg.U.UpdateError)
        assert vg.current().snapshot_version == v_before
        assert names(log, vg) == ["Alice", "Bob", "Carol"]
        r = log.write(vg, "MATCH (p:Person {name:'Bob'}) DETACH DELETE p")
        assert r.metrics["updates"]["deleted_nodes"] == 1
        assert r.metrics["updates"]["deleted_rels"] == 2
        assert names(log, vg) == ["Alice", "Carol"]
        assert rows(log.read(vg, "MATCH ()-[r:KNOWS]->() "
                                 "RETURN count(*) AS c")) == [{"c": 0}]
        log.write(vg, "MATCH (a:Person {name:'Alice'}), "
                      "(c:Person {name:'Carol'}) "
                      "CREATE (a)-[:KNOWS {since:2025}]->(c)")
        log.write(vg, "MATCH (:Person {name:'Alice'})-[r:KNOWS]->() "
                      "DELETE r")
        assert names(log, vg) == ["Alice", "Carol"]
        log.read(vg, "MATCH ()-[r:KNOWS]->() RETURN count(*) AS c")
    both(scenario)


def test_update_rejections():
    def scenario(pkg, log):
        s = pkg.session()
        vg = vgraph(pkg, s)
        plain = pkg.create_graph(s, "CREATE (:Person {name:'X'})")
        for label, fn in (
                ("plain graph",
                 lambda: plain.cypher("CREATE (:Person {name:'Y'})")),
                ("pinned snapshot",
                 lambda: vg.current().cypher("CREATE (:Person {name:'Y'})")),
                ("RETURN after CREATE",
                 lambda: vg.cypher("CREATE (n:Person) RETURN n")),
                ("SET label", lambda: vg.cypher(
                    "MATCH (n:Person) SET n:Admin"))):
            assert isinstance(log.fails(fn, label), pkg.U.UpdateError)
        assert vg.current().snapshot_version == 0
    both(scenario)


def test_explain_update_commits_nothing():
    def scenario(pkg, log):
        s = pkg.session()
        vg = vgraph(pkg, s)
        res = s.cypher_on_graph(vg, "EXPLAIN MATCH (p:Person {name:'Alice'}) "
                                    "CREATE (p)-[:LIKES]->(:Thing)")
        assert res.records is None
        assert "CreateNode" in res.plans["updates"]
        assert "CreateRel" in res.plans["updates"]
        assert "relational" in res.plans
        assert vg.current().snapshot_version == 0
        log.note("updates plan", res.plans["updates"])
        log.read(vg, "MATCH (n) RETURN count(*) AS c")
    both(scenario)


# -- programmatic apply ------------------------------------------------------

def test_programmatic_apply():
    def scenario(pkg, log):
        U = pkg.U
        vg = vgraph(pkg, pkg.session())
        a = U.CreateNode(labels=("Person",),
                         properties={"name": "Zed", "age": 7})
        info = log.apply(vg, [a, U.CreateRel("KNOWS", a, 0,
                                             {"since": 2030})])
        assert info.created_nodes == 1 and info.created_rels == 1
        assert rows(log.read(vg, "MATCH (z:Person {name:'Zed'})-[r:KNOWS]->"
                                 "(t) RETURN t.name AS t, r.since AS y")) \
            == [{"t": "Alice", "y": 2030}]
        log.apply(vg, [U.SetNodeProps(a, {"age": 8})])
        assert rows(log.read(vg, "MATCH (z:Person {name:'Zed'}) "
                                 "RETURN z.age AS a")) == [{"a": 8}]
        v = vg.current().snapshot_version
        for label, ops in (("missing rel", [U.DeleteRel(999_999)]),
                           ("missing endpoint",
                            [U.CreateRel("KNOWS", 0, 999_999)])):
            ex = log.fails(lambda ops=ops: vg.apply(ops), label)
            assert isinstance(ex, U.UpdateError)
        assert vg.current().snapshot_version == v
        log.apply(vg, [U.DeleteNode(a, detach=True)])
        assert rows(log.read(vg, "MATCH (z:Person {name:'Zed'}) "
                                 "RETURN count(*) AS c")) == [{"c": 0}]
    both(scenario)


# -- snapshot isolation ------------------------------------------------------

def test_snapshot_isolation_unit():
    q = "MATCH (p:Person) RETURN p.name AS n, p.age AS a"

    def scenario(pkg, log):
        vg = vgraph(pkg, pkg.session())
        snap = vg.current()
        before = log.read(snap, q)
        log.write(vg, "CREATE (:Person {name:'New', age:1})")
        log.write(vg, "MATCH (p:Person {name:'Alice'}) SET p.age = 99")
        log.write(vg, "MATCH (p:Person {name:'Carol'}) DETACH DELETE p")
        assert pkg.digest(log.read(snap, q)) == pkg.digest(before)
        assert names(log, vg) == ["Alice", "Bob", "New"]
        assert rows(log.read(vg, "MATCH (p:Person {name:'Alice'}) "
                                 "RETURN p.age AS a")) == [{"a": 99}]
    both(scenario)


# -- failure atomicity -------------------------------------------------------

def test_abort_write_rolls_back_completely():
    q = "MATCH (p:Person) RETURN p.name AS n, p.age AS a"

    def scenario(pkg, log):
        s = pkg.session()
        vg = vgraph(pkg, s)
        pool_before = len(s.backend.pool)
        v_before = vg.current().snapshot_version
        digest_before = pkg.digest(log.read(vg, q))
        with pkg.faults.abort_write(s, after_n_columns=1,
                                    n_times=1) as budget:
            log.fails(lambda: vg.cypher(
                "CREATE (:Person {name:'Torn', age:1})"), "aborted write")
        assert budget.injected == 1
        # nothing committed, nothing leaked: version, data AND the
        # string pool are exactly as before
        assert vg.current().snapshot_version == v_before
        assert len(s.backend.pool) == pool_before
        assert pkg.digest(log.read(vg, q)) == digest_before
        assert s.metrics_snapshot()["updates.rolled_back"] >= 1
        log.write(vg, "CREATE (:Person {name:'Torn', age:1})")
        assert rows(log.read(vg, "MATCH (p:Person {name:'Torn'}) "
                                 "RETURN count(*) AS c")) == [{"c": 1}]
    both(scenario)


def test_abort_between_delta_columns():
    def scenario(pkg, log):
        s = pkg.session()
        vg = vgraph(pkg, s)
        with pkg.faults.abort_write(s, after_n_columns=2, n_times=1):
            log.fails(lambda: vg.cypher(
                "CREATE (:Person {name:'A1', age:1}), "
                "(:Person {name:'A2', age:2})"), "aborted write")
        assert names(log, vg) == ["Alice", "Bob", "Carol"]
        log.write(vg, "CREATE (:Person {name:'A1', age:1})")
        assert "A1" in names(log, vg)
    both(scenario)


# -- compaction --------------------------------------------------------------

def test_compaction_digest_parity():
    q_nodes = "MATCH (p:Person) RETURN p.name AS n, p.age AS a"
    q_edges = ("MATCH (a:Person)-[r:KNOWS]->(b:Person) "
               "RETURN a.name AS a, r.since AS y, b.name AS b, b.age AS age")

    def scenario(pkg, log):
        vg = vgraph(pkg, pkg.session())
        log.write(vg, "CREATE (:Person {name:'Dave', age:52})")
        log.write(vg, "MATCH (p:Person {name:'Alice'}) SET p.age = 31")
        log.write(vg, "MATCH (p:Person {name:'Carol'}) DETACH DELETE p")
        log.write(vg, "MATCH (a:Person {name:'Alice'}), "
                      "(d:Person {name:'Dave'}) "
                      "CREATE (a)-[:KNOWS {since:2025}]->(d)")
        before_nodes = pkg.digest(log.read(vg, q_nodes))
        before_edges = pkg.digest(log.read(vg, q_edges))
        log.note("delta rows", vg.delta_rows())
        assert vg.delta_rows() > 0
        assert vg.compact() is True
        assert vg.delta_rows() == 0
        assert pkg.digest(log.read(vg, q_nodes)) == before_nodes
        assert pkg.digest(log.read(vg, q_edges)) == before_edges
        log.write(vg, "MATCH (p:Person {name:'Dave'}) SET p.age = 53")
        assert rows(log.read(vg, "MATCH (p:Person {name:'Dave'}) "
                                 "RETURN p.age AS a")) == [{"a": 53}]
        log.note("version", vg.current().snapshot_version)
    both(scenario)


def test_flaky_compaction_contained():
    q = "MATCH (p:Person) RETURN p.name AS n"

    def scenario(pkg, log):
        s = pkg.session()
        vg = vgraph(pkg, s)
        log.write(vg, "CREATE (:Person {name:'Dave', age:52})")
        digest = pkg.digest(log.read(vg, q))
        pool_before = len(s.backend.pool)
        with pkg.faults.flaky_compaction(s, error_rate=1.0,
                                         n_times=1) as budget:
            log.fails(vg.compact, "failed fold")
        assert budget.injected == 1
        assert len(s.backend.pool) == pool_before
        assert pkg.digest(log.read(vg, q)) == digest
        log.write(vg, "CREATE (:Person {name:'Erin', age:29})")
        assert vg.compact() is True
        assert vg.delta_rows() == 0
        assert "Erin" in names(log, vg)
    both(scenario)


# -- scoped plan-cache eviction ----------------------------------------------

def test_unrelated_graph_plans_survive_a_write():
    q2 = "MATCH (w:Widget) RETURN count(*) AS c"
    q3 = "MATCH (g:Gadget) RETURN count(*) AS c"

    def scenario(pkg, log):
        s = pkg.session()
        vg1 = vgraph(pkg, s)
        vg2 = vgraph(pkg, s, "CREATE (:Widget {sku:1}), (:Widget {sku:2})")
        other = pkg.create_graph(s, "CREATE (:Gadget {sn:7})")
        assert rows(log.read(vg2, q2)) == [{"c": 2}]
        assert rows(log.read(other, q3)) == [{"c": 1}]
        assert log.read(vg2, q2).metrics["plan_cache"] == "hit"
        assert log.read(other, q3).metrics["plan_cache"] == "hit"
        hits_before = s.plan_cache.stats()["hits"]
        log.write(vg1, "CREATE (:Person {name:'New'})")
        assert log.read(vg2, q2).metrics["plan_cache"] == "hit"
        assert log.read(other, q3).metrics["plan_cache"] == "hit"
        assert s.plan_cache.stats()["hits"] == hits_before + 2
        res = log.read(vg1, "MATCH (p:Person) RETURN count(*) AS c")
        assert res.metrics["plan_cache"] == "miss"
    both(scenario)


def test_snapshot_reads_use_plan_cache_and_fuse():
    q = "MATCH (p:Person) WHERE p.age > $min RETURN p.name AS n ORDER BY n"

    def scenario(pkg, log):
        s = pkg.session()
        vg = vgraph(pkg, s)
        assert log.read(vg, q, {"min": 20}).metrics["plan_cache"] == "miss"
        assert log.read(vg, q, {"min": 28}).metrics["plan_cache"] == "hit"
        assert s.plan_cache.stats()["entries"] >= 1
        log.write(vg, "CREATE (:Person {name:'New', age:50})")
        res = log.read(vg, q, {"min": 20})
        assert res.metrics["plan_cache"] == "miss"
        assert [r["n"] for r in rows(res)] == ["Alice", "Bob", "Carol", "New"]
        # an unchanged snapshot replays, with no size read
        again = log.read(vg, q, {"min": 20})
        assert again.metrics["plan_cache"] == "hit"
        assert s.fused.last_mode == "replay"
        return again.metrics["size_syncs"]

    _log, syncs = both(scenario)
    assert syncs == 0


def test_new_snapshot_never_replays_the_previous_snapshots_sizes():
    """Every commit publishes a new snapshot with its own fused-memo
    key: a read after a commit re-records its sizes (it must not serve
    the previous snapshot's row counts), and a replay of the new
    snapshot serves the new counts."""
    q = "MATCH (p:Person)-[:KNOWS]->(q) RETURN p.name AS p, q.name AS q"
    s = caps_tpu_torch.local_session(device="cpu")
    pkg = port_pkg()
    vg = vgraph(pkg, s)
    for _ in range(2):
        assert len(rows(vg.cypher(q))) == 2
    assert s.fused.last_mode == "replay"
    vg.cypher("MATCH (a:Person {name:'Carol'}), (b:Person {name:'Alice'}) "
              "CREATE (a)-[:KNOWS]->(b)")
    res = vg.cypher(q)
    assert s.fused.last_mode == "record"
    assert len(rows(res)) == 3
    res = vg.cypher(q)
    assert s.fused.last_mode == "replay" and res.metrics["size_syncs"] == 0
    assert len(rows(res)) == 3
    vg.cypher("MATCH (p:Person {name:'Bob'}) DETACH DELETE p")
    res = vg.cypher(q)
    assert s.fused.last_mode == "record"
    assert bag(res) == bag(vg.current().cypher(q)) and len(rows(res)) == 1


# -- review regressions ------------------------------------------------------

def test_recreating_a_deleted_base_id_does_not_resurrect_it():
    q = ("MATCH (p:Person) WHERE p.name STARTS WITH 'Alice' "
         "RETURN p.name AS n")

    def scenario(pkg, log):
        U = pkg.U
        vg = vgraph(pkg, pkg.session())
        log.apply(vg, [U.DeleteNode(0, detach=True)])
        log.apply(vg, [U.CreateNode(labels=("Person",),
                                    properties={"name": "Alice2", "age": 1},
                                    id=0)])
        assert [r["n"] for r in rows(log.read(vg, q))] == ["Alice2"]
        assert vg.compact() is True
        assert [r["n"] for r in rows(log.read(vg, q))] == ["Alice2"]
    both(scenario)


def test_explicit_ids_advance_the_allocator():
    def scenario(pkg, log):
        U = pkg.U
        vg = vgraph(pkg, pkg.session())
        hi = vg._next_id + 5
        log.apply(vg, [U.CreateNode(labels=("Marker",), id=hi)])
        for _ in range(7):
            log.apply(vg, [U.CreateNode(labels=("Marker",))])
        assert rows(log.read(vg, "MATCH (m:Marker) RETURN count(*) AS c")) \
            == [{"c": 8}]
        log.read(vg, "MATCH (m:Marker) RETURN id(m) AS i")
    both(scenario)


def test_failed_compaction_never_clobbers_a_concurrent_commit(monkeypatch):
    def scenario(pkg, log):
        U = pkg.U
        vg = vgraph(pkg, pkg.session())
        log.write(vg, "CREATE (:Person {name:'Delta', age:1})")
        orig = getattr(U, pkg.fold_step)
        state = {"fired": False}

        def sabotage(*args):
            if U.in_compaction() and not state["fired"]:
                state["fired"] = True
                # a write lands mid-fold (the commit lock is free),
                # interning a fresh string past the fold's pool mark ...
                vg.apply([U.CreateNode(labels=("Person",),
                                       properties={"name": "RacerUnique",
                                                   "age": 2})])
                # ... then the fold fails
                raise RuntimeError("injected fold failure")
            return orig(*args)

        monkeypatch.setattr(U, pkg.fold_step, sabotage)
        log.fails(vg.compact, "failed fold")
        monkeypatch.setattr(U, pkg.fold_step, orig)
        assert state["fired"]
        q = "MATCH (p:Person {name:'RacerUnique'}) RETURN p.name AS n"
        assert rows(log.read(vg, q)) == [{"n": "RacerUnique"}]
        assert vg.compact() is True
        assert rows(log.read(vg, q)) == [{"n": "RacerUnique"}]
    both(scenario)


# -- lock ordering of the scoped-eviction paths ------------------------------

def test_catalog_dep_validation_no_lock_cycle(monkeypatch):
    """Plan-cache lookup validates catalog dep tokens while holding the
    cache lock, and catalog mutations fan out into the cache while
    holding the catalog lock: with the port's locks named through
    ``lockgraph`` (strict mode) a cycle would raise mid-run."""
    monkeypatch.setenv("CAPS_TPU_LOCK_GRAPH", "1")
    from caps_tpu_torch.obs import lockgraph
    from caps_tpu_torch.obs.lockgraph import TrackedLock
    from caps_tpu_torch.testing.factory import create_graph
    lockgraph.reset()
    s = caps_tpu_torch.local_session(device="cpu")  # locks made strict
    assert isinstance(s.plan_cache._lock, TrackedLock)
    assert isinstance(s.catalog._lock, TrackedLock)
    g = create_graph(s, "CREATE (:A {x:1})")
    s.catalog.store("dep_cycle_probe", g)
    q = "FROM GRAPH session.dep_cycle_probe MATCH (n:A) RETURN count(*) AS c"
    errors = []

    def mutator():
        try:
            for i in range(60):
                s.catalog.store(f"other{i % 3}", g)
        except Exception as ex:  # pragma: no cover
            errors.append(ex)

    def querier():
        try:
            for _ in range(60):
                assert rows(s.cypher(q)) == [{"c": 1}]
        except Exception as ex:  # pragma: no cover
            errors.append(ex)

    threads = [threading.Thread(target=mutator),
               threading.Thread(target=querier)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert lockgraph.find_cycle() is None
    assert lockgraph.lock_graph_snapshot()["nodes"]


# -- drop_in (the tombstone-mask primitive) ----------------------------------

def test_table_drop_in():
    from caps_tpu.backends.tpu.session import TPUCypherSession
    from caps_tpu.okapi.types import CTInteger as JCTInteger
    from caps_tpu_torch.okapi.types import CTInteger
    data = {"id": [0, 1, 2, 3, None, 5], "x": [10, 11, 12, 13, 14, 15]}
    got = {}
    for name, s, ct in (("jax", TPUCypherSession(), JCTInteger),
                        ("port", caps_tpu_torch.local_session(device="cpu"),
                         CTInteger)):
        t = s.table_factory.from_columns(dict(data),
                                         {"id": ct.nullable, "x": ct})
        out = t.drop_in("id", {1, 3, 5})
        pairs = list(zip(out.column_values("id"), out.column_values("x")))
        got[name] = sorted(pairs, key=lambda p: (p[0] is None, p[0] or 0))
        assert t.drop_in("id", set()) is t
    # matching ids drop; nulls are kept (null never matches)
    assert got["port"] == got["jax"] == [(0, 10), (2, 12), (None, 14)]


def test_drop_in_pads_to_a_bucket_and_copies_each_id_set_once():
    from caps_tpu_torch.okapi.types import CTInteger
    s = caps_tpu_torch.local_session(device="cpu")
    t = s.table_factory.from_columns({"id": list(range(600))},
                                     {"id": CTInteger})
    hidden = frozenset(range(0, 600, 2))
    out = t.drop_in("id", hidden)
    assert out.column_values("id") == list(range(1, 600, 2))
    ids = s.backend.tombstone_tensor(hidden, t._cols["id"].data.dtype)
    assert ids.shape[0] == s.backend.bucket(len(hidden)) == 1024
    assert set(ids.tolist()) == set(hidden)
    assert ids.tolist() == sorted(ids.tolist())  # padded with the largest
    # the same set is not copied again
    assert s.backend.tombstone_tensor(hidden, ids.dtype) is ids


def test_drop_in_keeps_what_torch_isin_keeps():
    """The binary-search membership of ``drop_in`` against
    ``torch.isin`` on seeded ids: negative and repeated ids, nulls, id
    sets of 1 to 700 entries."""
    import torch
    from caps_tpu_torch.okapi.types import CTInteger
    rng = np.random.RandomState(11)
    s = caps_tpu_torch.local_session(device="cpu")
    for n_hidden in (1, 2, 37, 700):
        vals = rng.randint(-50, 400, 1500)
        nulls = rng.rand(1500) < 0.1
        col = [None if z else int(v) for v, z in zip(vals, nulls)]
        t = s.table_factory.from_columns(
            {"id": col, "row": list(range(1500))},
            {"id": CTInteger.nullable, "row": CTInteger})
        hidden = frozenset(int(v) for v in rng.randint(-60, 420, n_hidden))
        keep = ~torch.isin(torch.tensor(vals), torch.tensor(sorted(hidden)))
        keep |= torch.tensor(nulls)
        out = t.drop_in("id", hidden)
        assert out.column_values("row") == \
            torch.nonzero(keep).flatten().tolist()


# -- replication seam --------------------------------------------------------

def test_jax_delta_payload_installs_into_the_port():
    """A delta state the JAX package committed travels as its
    ``delta_state_to_payload`` and installs into the port unchanged:
    the port's snapshot reads what the JAX snapshot reads, at the JAX
    snapshot's version."""
    from caps_tpu_torch.relational.updates import delta_state_from_payload
    jax = jax_pkg()
    js = jax.session()
    jvg = vgraph(jax, js)
    jvg.cypher("CREATE (:Person {name:'Dave', age:52})")
    jvg.cypher("MATCH (p:Person {name:'Alice'}) SET p.age = 31, p.k = 'x'")
    jvg.cypher("MATCH (p:Person {name:'Bob'}) DETACH DELETE p")
    jvg.cypher("MATCH (a:Person {name:'Carol'}), (d:Person {name:'Dave'}) "
               "CREATE (a)-[:KNOWS {since:2026}]->(d)")
    payload = jax.U.delta_state_to_payload(jvg.current().state)
    version = jvg.current().snapshot_version

    port = port_pkg()
    ps = port.session()
    pvg = vgraph(port, ps)
    snap = pvg.install_state(delta_state_from_payload(payload), version)
    assert snap is pvg.current() and snap.snapshot_version == version == 4
    assert pvg._next_id == jvg._next_id
    for q in ("MATCH (p:Person) RETURN p.name AS n, p.age AS a, p.k AS k",
              "MATCH (a)-[r:KNOWS]->(b) RETURN a.name AS a, r.since AS y, "
              "b.name AS b",
              "MATCH (n) RETURN count(*) AS c"):
        assert bag(pvg.cypher(q)) == bag(jvg.cypher(q))
    # re-shipping an old version is ignored
    assert pvg.install_state(delta_state_from_payload(payload), 2) is snap
    assert port.U.delta_state_to_payload(snap.state) == payload


def test_max_entity_id_matches_the_reference():
    """``_max_entity_id`` (the allocator's start) over a seeded graph
    with a sparse id space equals the reference's answer."""
    from caps_tpu.relational.updates import _max_entity_id as jax_max
    from caps_tpu.backends.tpu.session import TPUCypherSession
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.relational.updates import _max_entity_id
    from tests.test_torch_count_pushdown import jax_graph
    rng = np.random.RandomState(3)
    nodes = {"P": {"_id": np.sort(rng.choice(10_000, 50, replace=False))
                   .astype(np.int64)}}
    src = rng.choice(nodes["P"]["_id"], 80)
    tgt = rng.choice(nodes["P"]["_id"], 80)
    rels = {"K": {"_id": np.arange(20_000, 20_080, dtype=np.int64),
                  "_src": src, "_tgt": tgt}}
    port = graph_from_numpy(caps_tpu_torch.local_session(device="cpu"),
                            nodes, rels)
    ref = jax_graph(TPUCypherSession(), nodes, rels)
    assert _max_entity_id(port) == jax_max(ref) == 20_079


# -- the write path's host structures, on the card ---------------------------

def _seeded_pair():
    """The same seeded graph in both packages: persons with an int and
    a string property, two relationship types with self-loops and
    parallel edges."""
    from caps_tpu.backends.tpu.session import TPUCypherSession
    from caps_tpu_torch.interop import graph_from_numpy
    from tests.test_torch_count_pushdown import jax_graph
    rng = np.random.RandomState(5)
    n, e = 60, 240
    nodes = {"P": {"_id": np.arange(n, dtype=np.int64),
                   "age": rng.randint(18, 30, n).astype(np.int64),
                   "city": [f"c{i % 7}" for i in range(n)]}}
    k = rng.randint(0, n, (e, 2)).astype(np.int64)
    k[:5, 1] = k[:5, 0]               # self-loops
    k = np.concatenate([k, k[:10]])   # parallel edges
    rels = {"K": {"_id": np.arange(1000, 1000 + len(k), dtype=np.int64),
                  "_src": k[:, 0].copy(), "_tgt": k[:, 1].copy()},
            "L": {"_id": np.arange(5000, 5000 + 30, dtype=np.int64),
                  "_src": k[:30, 1].copy(), "_tgt": k[:30, 0].copy()}}
    port = graph_from_numpy(caps_tpu_torch.local_session(device="cpu"),
                            nodes, rels)
    ref = jax_graph(TPUCypherSession(), nodes, rels)
    return port, ref


def test_base_lookups_give_the_reference_dicts_answers():
    """The fold's point lookups (``_BaseNodes``, ``_BaseRels``,
    ``_BaseIncidence``) answer what the reference's dicts over the
    whole base answer, for ids present and absent."""
    from caps_tpu.relational.updates import _base_incidence as jax_incidence
    from caps_tpu_torch.relational import updates as U
    port, ref = _seeded_pair()
    nodes, rels = U._BaseNodes(port), U._BaseRels(port)
    inc = U._BaseIncidence(port)
    ref_nodes, ref_rels = ref.node_lookup(), ref.rel_lookup()
    ref_inc = jax_incidence(ref)
    for nid in list(range(-2, 64)) + [1000, 5000]:
        assert (nid in nodes) == (nid in ref_nodes)
        if nid in ref_nodes:
            assert nodes[nid] == ref_nodes[nid]
        assert sorted(inc.get(nid, ())) == sorted(ref_inc.get(nid, ()))
    for rid in list(range(995, 1260)) + list(range(4998, 5032)) + [3]:
        assert (rid in rels) == (rid in ref_rels)
        if rid in ref_rels:
            assert rels[rid] == ref_rels[rid]
    assert U._max_entity_id(port) == 5029


def test_compaction_on_the_card_matches_the_reference():
    """Seeded writes on both packages, then a compaction: every node and
    relationship with its properties, and the grouped counts, read the
    same as the JAX package's compacted graph."""
    port, ref = _seeded_pair()
    pvg = port_pkg().U.versioned(port._session, port)
    jvg = jax_pkg().U.versioned(ref._session, ref)
    writes = [
        ("MATCH (a:P) WHERE id(a) = $id DETACH DELETE a", {"id": 7}),
        ("MATCH ()-[r:K]->() WHERE id(r) = $id DELETE r", {"id": 1003}),
        ("MATCH (a:P) WHERE id(a) = $id SET a.age = $age, a.nick = 'n'",
         {"id": 11, "age": 99}),
        ("CREATE (:P {age: $age, city: 'c_new'})", {"age": 40}),
        ("CREATE (:Q {w: 1.5})", {}),
        ("MATCH (a:P), (b:P) WHERE id(a) = 3 AND id(b) = 4 "
         "CREATE (a)-[:K {x: 1}]->(b)", {}),
        ("MATCH (a:P) WHERE id(a) = $id SET a.age = null", {"id": 12}),
    ]
    for q, p in writes:
        assert pvg.cypher(q, p).metrics["updates"] == \
            jvg.cypher(q, p).metrics["updates"]
    for vg in (pvg, jvg):
        assert vg.compact() is True and vg.delta_rows() == 0
    for q in ("MATCH (a)-[r]->(b) RETURN id(r) AS i, type(r) AS t, "
              "id(a) AS s, id(b) AS d, r.x AS x",
              "MATCH (a:P)-[:K]->(b) RETURN b.city AS c, count(*) AS n",
              "MATCH (n:P) RETURN id(n) AS i, n.age AS a, n.city AS c, "
              "n.nick AS k",
              "MATCH (n:Q) RETURN id(n) AS i, n.w AS w"):
        assert bag(pvg.cypher(q)) == bag(jvg.cypher(q))
