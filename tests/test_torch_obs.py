"""Observability of the port (obs/: tracer, metrics registry, PROFILE,
exporters, compile and memory ledgers, lock graph) against the JAX
package.

The cases of ``tests/test_obs.py`` (EXPLAIN executes nothing, PROFILE
rows, plan-cache hits under PROFILE, the disabled tracer, the registry,
the exporters) and the compile- and memory-ledger cases of
``tests/test_ledger.py`` run on a CPU session of the port; where a
query runs, the same CREATE text and parameters go through the JAX
package's device session too, and each operator's PROFILE rows must
equal the reference's exactly.
"""
from __future__ import annotations

import json
import threading

import pytest

import caps_tpu_torch
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.compile import (CompileLedger, attributed, charge,
                                        charged, global_compile_ledger)
from caps_tpu_torch.obs.ledger import device_memory, snapshot_footprint
from caps_tpu_torch.obs.metrics import MetricsRegistry, diff_snapshots
from caps_tpu_torch.obs.tracer import NULL_SPAN, Tracer
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.testing.factory import create_graph

CREATE = """
    CREATE (a:Person {name: 'Ada', age: 30}),
           (b:Person {name: 'Bo', age: 40}),
           (c:Person {name: 'Cy', age: 50}),
           (a)-[:KNOWS]->(b), (b)-[:KNOWS]->(c), (a)-[:KNOWS]->(c)
"""
Q = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
     "RETURN a.name AS a, b.name AS b ORDER BY a, b")
SOCIAL = ("CREATE (a:Person {name:'Alice', age:30})-[:KNOWS]->"
          "(b:Person {name:'Bob', age:25}), "
          "(b)-[:KNOWS]->(c:Person {name:'Carol', age:41})")
Q_AGE = "MATCH (p:Person) WHERE p.age < $min RETURN p.name AS n ORDER BY n"


def port_session(config=None):
    return caps_tpu_torch.local_session(device="cpu", config=config)


def jax_session(config=None):
    from caps_tpu.backends.tpu.session import TPUCypherSession
    return TPUCypherSession(config=config)


def jax_graph(session, create=CREATE):
    from caps_tpu.testing.factory import create_graph as jax_create
    return jax_create(session, create)


def walk(node):
    yield node
    for c in node["children"]:
        yield from walk(c)


def profile_rows(tree):
    """(operator, executed, rows) of every node, depth first."""
    return [(n["op"], n["executed"], n.get("rows")) for n in walk(tree)]


# -- EXPLAIN ----------------------------------------------------------------

def test_explain_executes_nothing(monkeypatch):
    graph = create_graph(port_session(), CREATE)
    from caps_tpu_torch.relational import ops as R

    def poisoned(self):
        raise AssertionError("EXPLAIN must not execute operators")

    monkeypatch.setattr(R.ScanOp, "_compute", poisoned)
    monkeypatch.setattr(R.StartOp, "_compute", poisoned)
    res = graph.cypher("EXPLAIN " + Q, {"min": 0})
    assert res.records is None
    assert res.metrics["mode"] == "explain"
    for phase in ("ir", "logical", "relational"):
        assert phase in res.plans and res.plans[phase]
    assert "Scan" in res.plans["relational"]
    assert "=== RELATIONAL ===" in res.explain()


def test_explain_catalog_statements_do_not_mutate():
    """EXPLAIN of CATALOG CREATE GRAPH (its inner query a CONSTRUCT)
    plans and stores nothing, as in the JAX package
    (``tests/test_obs.py``)."""
    session = port_session()
    graph = create_graph(session, CREATE)
    version0 = session.catalog.version
    res = graph.cypher(
        "EXPLAIN CATALOG CREATE GRAPH session.obs_explain { "
        "MATCH (n:Person) CONSTRUCT CLONE n RETURN GRAPH }")
    assert res.records is None
    assert "Construct" in res.plans["relational"]
    # nothing stored, nothing evicted: the catalog fingerprint is unchanged
    assert session.catalog.version == version0
    with pytest.raises(Exception):
        session.cypher("FROM GRAPH session.obs_explain MATCH (n) "
                       "RETURN count(*) AS c")


# -- PROFILE ----------------------------------------------------------------

@pytest.mark.parametrize("min_age", [0, 35, 45, 60])
def test_profile_rows_match_the_reference(min_age):
    """Each operator's PROFILE rows equal the JAX package's exactly, on
    a cold run and on a plan-cache hit."""
    port = create_graph(port_session(), CREATE)
    ref = jax_graph(jax_session())
    for _ in range(2):
        got = port.cypher("PROFILE " + Q, {"min": min_age})
        want = ref.cypher("PROFILE " + Q, {"min": min_age})
        assert got.records.to_maps() == want.records.to_maps()
        assert got.metrics["mode"] == "profile"
        assert profile_rows(got.profile) == profile_rows(want.profile)
        assert got.profile["rows"] == len(got.records.to_maps())
        for n in walk(got.profile):
            if n["executed"]:
                assert n["seconds"] >= 0.0 and n["rows"] >= 0
                assert n["device_s"] >= 0.0  # per-op sync is on
        assert got.profile["timing"] == "device"
        assert "rows=" in got.plans["profile"]
        assert "=== PROFILE ===" in got.explain()
    assert got.metrics["plan_cache"] == "hit"


def test_profile_fused_replay_rows_exact():
    """PROFILE through fused replay (exact and generic) still reports
    the actual result cardinality, and labels the run mode."""
    session = port_session()
    graph = create_graph(session, CREATE)
    for min_age in (35, 25, 35):  # converge recordings / generic stream
        graph.cypher(Q, {"min": min_age})
    res = graph.cypher("PROFILE " + Q, {"min": 25})
    rows = res.records.to_maps()
    assert len(rows) == 3
    assert res.profile["rows"] == len(rows)
    assert res.metrics["fused_mode"] in ("record", "replay", "replay_gen")
    assert res.profile.get("timing") == "device"


def test_profile_aggregate_replay_span():
    """With per-op sync off, a replayed PROFILE reports device time as
    ONE per-replay aggregate and tags per-op numbers as dispatch-only;
    its rows still equal the reference's."""
    cfg = EngineConfig(profile_sync_each_op=False)
    session = port_session(cfg)
    graph = create_graph(session, CREATE)
    from caps_tpu.okapi.config import EngineConfig as JaxConfig
    ref = jax_graph(jax_session(JaxConfig(profile_sync_each_op=False)))
    for _ in range(2):
        graph.cypher(Q, {"min": 25})
        ref.cypher(Q, {"min": 25})
    res = graph.cypher("PROFILE " + Q, {"min": 25})
    want = ref.cypher("PROFILE " + Q, {"min": 25})
    assert res.metrics["fused_mode"] == want.metrics["fused_mode"] == "replay"
    assert res.profile["timing"] == "dispatch"
    assert res.metrics["replay_device_s"] >= 0.0
    assert res.profile["rows"] == len(res.records.to_maps())
    assert profile_rows(res.profile) == profile_rows(want.profile)
    assert "aggregate device=" in res.plans["profile"]
    assert "dispatch=" in res.plans["profile"]


def test_degraded_profile_is_eager_not_the_last_fused_mode():
    """A PROFILE run under ``degraded_execution(no_fused=True)`` after
    a replay is eager: its timings are not tagged as dispatch of a
    replay and no aggregate replay span is reported.  (The JAX
    package's ``_annotate_profile`` reads the fused executor's last
    mode here and reports ``replay``.)"""
    from caps_tpu_torch.relational.session import degraded_execution
    session = port_session(EngineConfig(profile_sync_each_op=False))
    graph = create_graph(session, CREATE)
    for _ in range(2):
        graph.cypher(Q, {"min": 25})
    assert session.fused.last_mode == "replay"
    with degraded_execution(no_plan_cache=True, no_fused=True):
        res = graph.cypher("PROFILE " + Q, {"min": 25})
    assert res.metrics["fused_mode"] == "eager"
    assert res.profile["timing"] == "host"
    assert "replay_device_s" not in res.metrics
    assert res.profile["rows"] == len(res.records.to_maps()) == 3


def test_profile_plan_cache_hit_not_poisoned():
    session = port_session()
    graph = create_graph(session, CREATE)
    r1 = graph.cypher(Q, {"min": 35})
    assert r1.metrics["plan_cache"] == "miss"
    entries = session.plan_cache.stats()["entries"]
    res = graph.cypher("PROFILE " + Q, {"min": 45})
    assert res.metrics["plan_cache"] == "hit"
    assert res.metrics["parse_s"] == 0.0
    assert res.metrics["plan_s"] == 0.0
    assert res.metrics["relational_s"] == 0.0
    assert res.profile["rows"] == len(res.records.to_maps())
    assert session.plan_cache.stats()["entries"] == entries
    r3 = graph.cypher(Q, {"min": 35})
    assert r3.metrics["plan_cache"] == "hit"
    assert "profile" not in r3.plans and r3.profile is None
    # and the fused memo was not poisoned: the plain run replays exactly
    assert session.fused.last_mode == "replay"
    assert r3.metrics["size_syncs"] == 0
    assert r3.records.to_maps() == [{"a": "Bo", "b": "Cy"}]


def test_profile_and_plain_queries_agree():
    graph = create_graph(port_session(), CREATE)
    plain = graph.cypher(Q, {"min": 0}).records.to_maps()
    profiled = graph.cypher("PROFILE " + Q, {"min": 0}).records.to_maps()
    assert plain == profiled


def test_query_mode_stripping():
    from caps_tpu_torch.frontend.parser import parse_query, query_mode
    assert query_mode("MATCH (n) RETURN n") == (None, "MATCH (n) RETURN n")
    mode, body = query_mode("  explain MATCH (n) RETURN n")
    assert mode == "explain" and body == "MATCH (n) RETURN n"
    mode, body = query_mode("/* c */ PROFILE\nMATCH (n) RETURN n")
    assert mode == "profile" and body == "MATCH (n) RETURN n"
    parse_query("PROFILE MATCH (n) RETURN n")
    parse_query("EXPLAIN MATCH (n) RETURN n")
    assert query_mode("MATCH 'unterminated")[0] is None


def test_prepared_profile():
    graph = create_graph(port_session(), CREATE)
    res = graph.prepare("PROFILE " + Q).run({"min": 35})
    assert res.metrics["mode"] == "profile"
    assert res.profile["rows"] == len(res.records.to_maps())


# -- overhead ---------------------------------------------------------------

def test_disabled_tracer_overhead_bounded():
    """The disabled path is a shared no-op span and records nothing
    across repeated queries; the operators open no profiler range."""
    tr = Tracer(enabled=False)
    assert tr.span("x") is NULL_SPAN
    assert tr.span("y", kind="operator") is NULL_SPAN
    t0 = clock.now()
    for _ in range(100_000):
        with tr.span("hot"):
            pass
    assert clock.now() - t0 < 1.0
    assert tr.spans == [] and tr.dropped == 0
    session = port_session()
    graph = create_graph(session, CREATE)
    for _ in range(5):
        graph.cypher(Q, {"min": 25})
    assert session.tracer.enabled is False
    assert session.tracer.spans == []
    assert session.metrics_snapshot()["tracer.spans"] == 0


def test_trace_config_records_phase_and_operator_spans():
    session = port_session(EngineConfig(trace=True))
    graph = create_graph(session, CREATE)
    graph.cypher(Q, {"min": 25})
    names = {sp.name for sp in session.tracer.spans}
    assert {"parse", "ir", "logical", "relational", "execute"} <= names
    execute = [sp for sp in session.tracer.spans if sp.name == "execute"][0]
    ops = [c.name for c in execute.children]
    assert ops and all(n.startswith("op.") for n in ops)
    assert session.metrics_snapshot()["tracer.spans"] == len(
        session.tracer.spans)


def test_operator_failure_is_reported_once():
    session = port_session(EngineConfig(trace=True))
    graph = create_graph(session, CREATE)
    with pytest.raises(Exception) as info:
        graph.cypher("MATCH (a:Person) RETURN a.age / $z AS x", {"z": 0})
    assert info.value.caps_failed_op
    assert session.metrics_snapshot()["ops.errors"] == 1
    events = [c for sp in session.tracer.spans for c in _all(sp)
              if c.name == "op.error"]
    assert len(events) == 1


def _all(span):
    yield span
    for c in span.children:
        yield from _all(c)


# -- metrics registry / snapshots -------------------------------------------

def test_metrics_registry_instruments():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(2)
    reg.gauge("g").set(7)
    reg.gauge("live", fn=lambda: 42)
    reg.observe("h", 0.5)
    reg.observe("h", 1.5)
    snap = reg.snapshot()
    assert snap["c"] == 3 and snap["g"] == 7 and snap["live"] == 42
    assert snap["h.count"] == 2 and snap["h.sum"] == 2.0
    assert snap["h.min"] == 0.5 and snap["h.max"] == 1.5
    d = diff_snapshots({"c": 1, "x": 5}, {"c": 3, "y": 2, "s": "str"})
    assert d["c"] == 2 and d["y"] == 2 and d["s"] == "str"


def test_session_metrics_snapshot_absorbs_scattered_stats():
    session = port_session()
    graph = create_graph(session, CREATE)
    snap0 = session.metrics_snapshot()
    graph.cypher(Q, {"min": 25})
    graph.cypher(Q, {"min": 35})
    delta = diff_snapshots(snap0, session.metrics_snapshot())
    assert delta["plan_cache.misses"] == 1
    assert delta["plan_cache.hits"] == 1
    assert delta["query.execute_s.count"] == 2
    for key in ("backend.syncs", "fused.recordings", "fused.replays",
                "fused.count_builds", "tracer.spans", "tracer.dropped",
                "compile.events", "mem.plan_cache_bytes"):
        assert key in delta, sorted(delta)


def test_plan_cache_invalidations_in_snapshot():
    session = port_session()
    graph = create_graph(session, CREATE)
    session.catalog.store("obs_snap", graph)
    session.cypher("FROM GRAPH session.obs_snap MATCH (n:Person) "
                   "RETURN count(*) AS c")
    snap0 = session.metrics_snapshot()
    session.catalog.store("obs_snap", create_graph(session, CREATE))
    delta = diff_snapshots(snap0, session.metrics_snapshot())
    assert delta["plan_cache.invalidations"] >= 1


# -- exporters ---------------------------------------------------------------

def test_exporters(tmp_path):
    session = port_session()
    graph = create_graph(session, CREATE)
    graph.cypher("PROFILE " + Q, {"min": 25})
    assert session.tracer.spans, "PROFILE must collect spans"
    chrome = session.export_trace(str(tmp_path / "trace.json"))
    events = json.load(open(chrome))["traceEvents"]
    assert events
    names = {e["name"] for e in events}
    assert "query" in names and any(n.startswith("op.") for n in names)
    for e in events:
        assert e["ph"] in ("X", "i")
        assert e["ts"] >= 0
    jsonl = session.export_trace(str(tmp_path / "trace.jsonl"), fmt="jsonl")
    lines = [json.loads(line) for line in open(jsonl) if line.strip()]
    assert len(lines) == len(events)
    roots = [line for line in lines if line["parent_id"] == -1]
    assert roots and roots[0]["name"] == "query"
    ids = {line["span_id"] for line in lines}
    assert all(line["parent_id"] in ids or line["parent_id"] == -1
               for line in lines)
    with pytest.raises(ValueError):
        session.export_trace(str(tmp_path / "x"), fmt="bogus")


def test_span_nesting_and_events():
    tr = Tracer(enabled=True)
    with tr.span("outer", kind="query") as outer:
        with tr.span("inner", kind="phase"):
            tr.event("tick", bytes=10)
        outer.annotate(rows=5)
    assert len(tr.spans) == 1
    root = tr.spans[0]
    assert root.name == "outer" and root.rows == 5
    assert [c.name for c in root.children] == ["inner"]
    assert [c.name for c in root.children[0].children] == ["tick"]
    assert root.children[0].children[0].bytes == 10
    assert root.wall_s >= root.children[0].wall_s >= 0.0


# -- compile ledger ----------------------------------------------------------

def test_compile_ledger_first_seen_vs_recompile():
    reg = MetricsRegistry()
    led = CompileLedger(registry=reg)
    c1 = led.charge("famA", "plan", 0.5, shape="sig1")
    assert c1["first_seen"] and not c1["recompile"]
    c2 = led.charge("famA", "plan", 0.25, shape="sig2")
    assert not c2["recompile"]
    c3 = led.charge("famA", "plan", 0.25, shape="sig1")
    assert c3["recompile"] and not c3["first_seen"]
    st = led.stats("famA")
    assert st["compiles"] == 3 and st["recompiles"] == 1
    assert st["total_s"] == pytest.approx(1.0)
    assert st["by_kind"]["plan"]["count"] == 3
    snap = reg.snapshot()
    assert snap["compile.events"] == 3
    assert snap["compile.recompiles"] == 1
    assert snap["compile.seconds"] == pytest.approx(1.0)
    assert snap["compile.families"] == 1
    summary = led.summary()
    assert summary["families"] == 1 and summary["events"] == 3
    assert "famA" in summary["by_family"]


def test_compile_ledger_lru_bound():
    led = CompileLedger(max_families=3)
    for i in range(5):
        led.charge(f"f{i}", "plan", 0.01)
    assert led.family_count() == 3
    assert led.families() == ["f2", "f3", "f4"]
    led.charge("f2", "plan", 0.01)
    led.charge("f9", "plan", 0.01)
    assert "f2" in led.families() and "f3" not in led.families()


def test_attributed_scope_collects_and_nests():
    led = CompileLedger()
    with attributed(led, "outer") as charges:
        charge("plan", 0.5)
        with attributed(led, "inner"):
            charge("count_fused", 0.25)
    assert [c["family"] for c in charges] == ["outer", "inner"]
    assert sum(c["seconds"] for c in charges) == pytest.approx(0.75)
    assert led.seconds_for("outer") == pytest.approx(0.5)


def test_unattributed_charge_lands_in_global_ledger():
    g = global_compile_ledger()
    before = g.seconds_for("(unattributed)")
    charge("wcoj", 0.125)
    assert g.seconds_for("(unattributed)") - before == pytest.approx(0.125)


def test_charged_context_times_the_region():
    led = CompileLedger()
    with attributed(led, "f") as charges:
        with charged("count_fused", shape="s"):
            pass
    assert len(charges) == 1 and charges[0]["kind"] == "count_fused"
    assert charges[0]["seconds"] >= 0.0


def test_shape_eviction_is_flagged_not_silent():
    led = CompileLedger(max_shapes=2)
    for i in range(3):
        led.charge("fam", "plan", 0.01, shape=f"s{i}")
    assert led.stats("fam")["shapes_evicted"] is True
    assert led.charge("fam", "plan", 0.01, shape="s0")["recompile"] is False
    assert led.summary()["recompiles_lower_bound"] is True
    led2 = CompileLedger()
    led2.charge("f", "plan", 0.01, shape="x")
    assert led2.summary()["recompiles_lower_bound"] is False


def test_cold_plan_charges_and_cache_hit_charges_zero():
    """As in the JAX package: a cold run charges ``plan`` and
    ``fused_record``; an exact replay of the cached plan charges
    nothing; a new binding of the same bucketed shape re-records, and
    that charge is a re-compile of the family's one shape."""
    kinds = {}
    for name, s, g in (("port", *_pair(port_session)),
                       ("jax", *_pair(jax_session, jax_graph))):
        r1 = s.cypher_on_graph(g, Q_AGE, {"min": 30})
        r2 = s.cypher_on_graph(g, Q_AGE, {"min": 30})
        r3 = s.cypher_on_graph(g, Q_AGE, {"min": 40})
        assert r1.metrics["compile_s_charged"] > 0.0
        assert r2.metrics["plan_cache"] == r3.metrics["plan_cache"] == "hit"
        assert r2.metrics["compile_s_charged"] == 0.0
        assert "compile_charges" not in r2.metrics
        assert len(s.compile_ledger.families()) == 1
        kinds[name] = [[(c["kind"], c["recompile"])
                        for c in r.metrics.get("compile_charges", ())]
                       for r in (r1, r2, r3)]
        kinds[name + " rows"] = [r.records.to_maps() for r in (r1, r3)]
    assert kinds["port"] == kinds["jax"] == [
        [("plan", False), ("fused_record", False)], [],
        [("fused_record", True)]]
    assert kinds["port rows"] == kinds["jax rows"]


def _pair(make, make_graph=None):
    s = make()
    g = (make_graph or (lambda s, c: create_graph(s, c)))(s, SOCIAL)
    return s, g


def test_fused_replay_zero_charge_and_retired_rerecord_is_recompile():
    """A replayed execution charges nothing; after the family's plans
    and fused recordings are retired (``evict_family`` + ``forget``, the
    re-plan loop's retirement), the re-execution re-plans and
    re-records, and both charges count as re-compiles."""
    s, g = _pair(port_session)
    params = {"min": 30}
    r1 = s.cypher_on_graph(g, Q_AGE, params)
    assert any(c["kind"] == "fused_record"
               for c in r1.metrics["compile_charges"])
    replays0 = s.fused.replays
    r2 = s.cypher_on_graph(g, Q_AGE, params)
    assert s.fused.replays == replays0 + 1
    assert r2.metrics["compile_s_charged"] == 0.0
    family = s.compile_ledger.families()[0]
    assert s.compile_ledger.stats(family)["recompiles"] == 0
    assert len(s.plan_cache.evict_family(family)) >= 1
    assert s.fused.forget(g, Q_AGE) >= 1
    r3 = s.cypher_on_graph(g, Q_AGE, params)
    charges = {c["kind"]: c for c in r3.metrics["compile_charges"]}
    assert charges["plan"]["recompile"]
    assert charges["fused_record"]["recompile"]
    assert s.compile_ledger.stats(family)["recompiles"] >= 2


def test_fused_record_charge_excludes_nested_build_charges():
    """Compile seconds sum the wall clock once: the count-closure build
    charged inside a record run is subtracted from the fused_record
    charge, so the non-plan charges never exceed the execute phase."""
    s, g = _pair(port_session)
    r = s.cypher_on_graph(
        g, "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN count(*) AS c")
    assert r.to_maps() == [{"c": 2}]
    kinds = {c["kind"] for c in r.metrics["compile_charges"]}
    assert {"fused_record", "count_fused"} <= kinds
    non_plan = sum(c["seconds"] for c in r.metrics["compile_charges"]
                   if c["kind"] != "plan")
    assert non_plan <= r.metrics["execute_s"] + 1e-6


# -- memory ledger -----------------------------------------------------------

def test_memory_ledger_gauges_and_report():
    s, g = _pair(port_session)
    s.cypher_on_graph(g, Q_AGE, {"min": 30})
    snap = s.metrics_snapshot()
    assert snap["mem.plan_cache_bytes"] > 0
    assert snap["mem.string_pool_bytes"] > 0
    assert snap["mem.plan_cache_bytes"] == s.plan_cache.stats()["bytes"]
    # the CPU cannot report allocator bytes: 0 in the gauge, and the
    # report says the device is not measurable (never a fake zero)
    assert snap["mem.device_bytes_in_use"] == 0
    s.memory_ledger.track("g", g)
    rep = s.memory_ledger.report()
    assert rep["graphs"]["g"]["bytes"] > 0
    assert rep["tracked_graph_bytes"] == rep["graphs"]["g"]["bytes"]
    assert rep["devices"] == {"cpu": {"available": False}}
    s.memory_ledger.untrack("g")
    assert s.memory_ledger.report()["graphs"] == {}


def test_device_memory_graceful_fallback():
    mem = device_memory()
    assert isinstance(mem, dict) and mem
    for entry in mem.values():
        if not entry["available"]:
            assert "bytes_in_use" not in entry
    assert device_memory("cpu") == {"cpu": {"available": False}}


def test_snapshot_footprint_versioned_base_delta_split():
    from caps_tpu_torch.relational.updates import versioned
    s = port_session()
    vg = versioned(s, create_graph(s, SOCIAL))
    base = snapshot_footprint(vg)
    assert base["base_bytes"] > 0 and base["delta_bytes"] == 0
    assert base["snapshot_version"] == 0
    vg.cypher("CREATE (:Person {name:'Dave', age:52})")
    vg.cypher("MATCH (p:Person {name:'Carol'}) DETACH DELETE p")
    after = snapshot_footprint(vg)
    assert after["snapshot_version"] == 2
    assert after["base_bytes"] == base["base_bytes"]
    assert after["delta_bytes"] > 0 and after["delta_rows"] >= 2
    assert after["bytes"] == after["base_bytes"] + after["delta_bytes"]
    assert vg.compact() is True
    folded = snapshot_footprint(vg)
    assert folded["delta_bytes"] == 0 and folded["delta_rows"] == 0


# -- lock graph ---------------------------------------------------------------

def test_lock_order_inversion_raises_and_find_cycle_names_it(monkeypatch):
    monkeypatch.setenv("CAPS_TPU_LOCK_GRAPH", "1")
    from caps_tpu_torch.obs import lockgraph
    lockgraph.reset()
    a = lockgraph.make_lock("unit.A._lock")
    b = lockgraph.make_rlock("unit.B._lock")
    assert isinstance(a, lockgraph.TrackedLock)
    with a:
        with b:
            pass
    done = []

    def inverted():
        with b:
            with pytest.raises(lockgraph.LockOrderViolation) as info:
                with a:
                    pass
            done.append(info.value.cycle)

    t = threading.Thread(target=inverted)
    t.start()
    t.join()
    assert done and set(done[0]) == {"unit.A._lock", "unit.B._lock"}
    cycle = lockgraph.find_cycle()
    assert cycle[0] == cycle[-1]
    assert set(cycle) == {"unit.A._lock", "unit.B._lock"}
    # the violating acquisition released the lock it had taken
    assert not a.locked()
    lockgraph.reset()
    assert lockgraph.find_cycle() is None
    # record mode keeps the edge and never raises
    monkeypatch.setenv("CAPS_TPU_LOCK_GRAPH", "record")
    c = lockgraph.make_lock("unit.C._lock")
    d = lockgraph.make_lock("unit.D._lock")
    with c, d:
        pass
    with d, c:
        pass
    assert lockgraph.find_cycle() is not None
    lockgraph.reset()
    monkeypatch.delenv("CAPS_TPU_LOCK_GRAPH")
    assert not isinstance(lockgraph.make_lock("unit.E._lock"),
                          lockgraph.TrackedLock)
