"""The serving tier (caps_tpu_torch/serve/) and the thread-safety audit,
on the port's CPU session: the cases of ``tests/test_serve.py`` (its two
long stress runs excepted), with the served rows held against the JAX
package's QueryServer on the same CREATE text, plus the port's own
cases (a WCOJ fault under the server, a CPU replica's activation).

Contract under test: a stress run with >= 8 client
threads and >= 200 mixed prepared queries completes with zero errors and
results identical to sequential execution (order-insensitive bags); the
micro-batcher demonstrably coalesces (batch-size histogram max > 1); an
over-capacity burst sheds with typed ``Overloaded``; a deadline-injected
query fails with a phase-attributed error and trace span.  Plus the
satellite audit: PlanCache LRU mutation, catalog-subscription eviction,
and MetricsRegistry updates are safe under concurrent threads.
"""
from __future__ import annotations

import sys
import threading

import pytest

import caps_tpu_torch
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.serve import (BATCH, INTERACTIVE, Cancelled, CancelScope,
                            DeadlineExceeded, Overloaded, QueryServer,
                            ServerConfig, ServerClosed)
from caps_tpu_torch.serve.admission import AdmissionController
from caps_tpu_torch.serve.request import Request
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import slow_operator

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

# The "mixed prepared queries" of the stress run: three distinct plan
# families, each with rotating bindings.
QUERIES = [
    ("MATCH (p:Person) WHERE p.age > $min RETURN p.name AS n ORDER BY n",
     [{"min": m} for m in (20, 30, 40, 50)]),
    ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
     "RETURN a.name AS a, b.name AS b",
     [{"min": m} for m in (25, 35, 45)]),
    ("MATCH (a:Person)-[k:KNOWS]->(b) WHERE k.since >= $y "
     "RETURN count(*) AS c", [{"y": y} for y in (2011, 2015, 2020)]),
]


def _session(**cfg):
    return caps_tpu_torch.local_session(device="cpu",
                                  config=EngineConfig(**cfg) if cfg else None)


def _bag(rows):
    return sorted(sorted(r.items()) for r in rows)


def _graph(session):
    return create_graph(session, SOCIAL)


def _expected(graph):
    """Sequential execution of every (query, binding) on the port, held
    to the JAX package's QueryServer serving the same CREATE text."""
    out = {(q, i): _bag(graph.cypher(q, b).records.to_maps())
           for q, bindings in QUERIES for i, b in enumerate(bindings)}
    assert out == _jax_served()
    return out


def _jax_served():
    """Every (query, binding) through the JAX package's QueryServer on
    its device session."""
    import caps_tpu
    from caps_tpu.serve import QueryServer as JaxServer
    from caps_tpu.testing.factory import create_graph as jax_create
    ref = caps_tpu.local_session(backend="tpu")
    with JaxServer(ref, graph=jax_create(ref, SOCIAL)) as server:
        handles = {(q, i): server.submit(q, b)
                   for q, bindings in QUERIES for i, b in enumerate(bindings)}
        return {k: _bag(h.rows(timeout=60)) for k, h in handles.items()}


# -- basic serving ---------------------------------------------------------

def test_submit_and_rows():
    session = _session()
    graph = _graph(session)
    with QueryServer(session, graph=graph) as server:
        h = server.submit(QUERIES[0][0], {"min": 30})
        assert [r["n"] for r in h.rows(timeout=30)] == ["Alice", "Bob",
                                                        "Dana"]
        assert h.done() and h.exception() is None
        assert h.info["batch_size"] >= 1 and "latency_s" in h.info
        # blocking convenience call
        res = server.run(QUERIES[2][0], {"y": 2015})
        assert res.to_maps() == [{"c": 3}]


def test_submit_after_shutdown_raises():
    session = _session()
    server = QueryServer(session, graph=_graph(session))
    server.shutdown()
    with pytest.raises(ServerClosed):
        server.submit("MATCH (n) RETURN n")


def test_explain_and_profile_through_server_never_batched():
    session = _session()
    graph = _graph(session)
    q = QUERIES[0][0]
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=1, max_batch=8))
    plain = [server.submit(q, {"min": 20}) for _ in range(3)]
    prof = server.submit("PROFILE " + q, {"min": 20})
    expl = server.submit("EXPLAIN " + q, {"min": 20})
    server.start()
    server.shutdown()  # drain completes everything queued
    assert plain[0].info["batch_size"] == 3  # compatible plain ones coalesce
    assert prof.info["batch_size"] == 1      # PROFILE executes alone
    assert expl.info["batch_size"] == 1
    assert prof.result().profile is not None
    assert "relational" in expl.result().plans
    assert expl.result().records is None


# -- micro-batching --------------------------------------------------------

def test_batch_coalesces_compatible_only():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=1, max_batch=16))
    same = [server.submit(QUERIES[0][0], {"min": m})
            for m in (20, 30, 40, 50)]
    other = server.submit(QUERIES[2][0], {"y": 2015})
    # same normalized text but different param SIGNATURE: incompatible
    diverged = server.submit(QUERIES[0][0], {"min": 30.5})
    server.start()
    server.shutdown()
    assert [h.info["batch_size"] for h in same] == [4, 4, 4, 4]
    assert other.info["batch_size"] == 1
    assert diverged.info["batch_size"] == 1
    assert [r["n"] for r in diverged.rows()] == ["Alice", "Bob", "Dana"]
    batch_max = session.metrics_registry.histogram("serve.batch_size").max
    assert batch_max == 4


def test_cypher_batch_isolates_member_failures():
    session = _session()
    graph = _graph(session)
    q = QUERIES[0][0]
    graph.cypher(q, {"min": 20})  # warm the plan cache
    expired = CancelScope(budget_s=0.0)
    live = CancelScope(budget_s=None)
    out = session.cypher_batch(graph, [(q, {"min": 20}), (q, {"min": 30})],
                               scopes=[expired, live])
    assert isinstance(out[0], DeadlineExceeded)
    assert [r["n"] for r in out[1].records.to_maps()] == ["Alice", "Bob",
                                                          "Dana"]


# -- admission control -----------------------------------------------------

def _mk_request(priority=INTERACTIVE, key=None, query="q"):
    return Request(query, {}, None, priority, CancelScope(), key, None)


def test_admission_priority_order_and_shed():
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    adm = AdmissionController(reg, max_queue=3,
                              per_priority_limits={BATCH: 1})
    lo = _mk_request(priority=BATCH)
    adm.offer(lo)
    with pytest.raises(Overloaded) as ex:  # per-priority cap, queue not full
        adm.offer(_mk_request(priority=BATCH))
    assert ex.value.retry_after_s > 0 and ex.value.priority == BATCH
    hi1, hi2 = _mk_request(), _mk_request()
    adm.offer(hi1)
    adm.offer(hi2)
    with pytest.raises(Overloaded):        # global bound
        adm.offer(_mk_request())
    assert reg.counter("serve.shed").value == 2
    # strict priority order, FIFO within a class
    assert adm.take(0) is hi1 and adm.take(0) is hi2 and adm.take(0) is lo
    assert adm.take(0) is None


def test_overload_burst_sheds_and_recovers():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=2, max_queue=4))
    handles, sheds = [], []

    def client():
        try:
            handles.append(server.submit(QUERIES[0][0], {"min": 20}))
        except Overloaded as ex:
            sheds.append(ex)

    threads = [threading.Thread(target=client) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(handles) == 4 and len(sheds) == 8
    assert all(ex.retry_after_s > 0 for ex in sheds)
    server.start()
    server.shutdown()  # graceful drain: admitted work still completes
    for h in handles:
        assert [r["n"] for r in h.rows()] == ["Alice", "Bob", "Carol",
                                              "Dana"]
    snap = session.metrics_snapshot()
    assert snap["serve.shed"] == 8 and snap["serve.completed"] == 4


def test_shutdown_drains_never_started_server():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False)
    h = server.submit(QUERIES[0][0], {"min": 30})
    server.shutdown()  # drain=True must still complete the backlog
    assert [r["n"] for r in h.rows(timeout=30)] == ["Alice", "Bob", "Dana"]


def test_two_servers_share_one_session_exec_lock():
    session = _session()
    graph = _graph(session)
    a = QueryServer(session, graph=graph)
    b = QueryServer(session, graph=graph)
    # per-session, not per-server: both servers' replica 0 serializes
    # through the one lock attached to the shared session
    assert a.devices.replicas[0].lock is b.devices.replicas[0].lock
    ha = a.submit(QUERIES[0][0], {"min": 30})
    hb = b.submit(QUERIES[0][0], {"min": 40})
    assert [r["n"] for r in ha.rows(timeout=30)] == ["Alice", "Bob",
                                                     "Dana"]
    assert [r["n"] for r in hb.rows(timeout=30)] == ["Bob", "Dana"]
    a.shutdown()
    # closing a controller releases the queue-depth gauge unless the
    # other server's controller took it over
    b.shutdown()
    assert session.metrics_snapshot()["serve.queue_depth"] == 0


def test_shutdown_without_drain_cancels_queued():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=1))
    h = server.submit(QUERIES[0][0], {"min": 20})
    server.shutdown(drain=False)
    with pytest.raises(Cancelled):
        h.result(timeout=5)


# -- deadlines and cancellation --------------------------------------------

def test_deadline_expired_in_queue():
    session = _session()
    graph = _graph(session)
    with QueryServer(session, graph=graph) as server:
        h = server.submit(QUERIES[0][0], {"min": 20}, deadline_s=0.0)
        with pytest.raises(DeadlineExceeded) as ex:
            h.result(timeout=10)
        assert ex.value.phase == "queued"
        assert session.metrics_snapshot()["serve.deadline_exceeded"] == 1


def test_deadline_in_execute_phase_with_trace_span():
    session = _session(trace=True)
    graph = _graph(session)
    q = QUERIES[0][0]
    graph.cypher(q, {"min": 20})  # warm: expiry hits the cached-plan path
    with QueryServer(session, graph=graph) as server:
        with slow_operator("Filter", 0.2):
            h = server.submit(q, {"min": 20}, deadline_s=0.05)
            with pytest.raises(DeadlineExceeded) as ex:
                h.result(timeout=10)
    assert ex.value.phase == "execute"
    assert ex.value.budget_s == 0.05 and ex.value.elapsed_s >= 0.05

    def walk(spans):
        for sp in spans:
            yield sp
            yield from walk(sp.children)

    spans = list(walk(session.tracer.spans))
    events = [sp for sp in spans if sp.name == "deadline.exceeded"]
    assert events and events[0].attrs["phase"] == "execute"
    assert any(sp.attrs.get("error") == "DeadlineExceeded" for sp in spans)


def test_cancel_queued_request():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False)
    h = server.submit(QUERIES[0][0], {"min": 20})
    assert h.cancel() is True
    server.start()
    with pytest.raises(Cancelled):
        h.result(timeout=10)
    server.shutdown()
    assert h.cancel() is False  # nothing left to cancel


def test_cancel_running_request_cooperatively():
    session = _session()
    graph = _graph(session)
    with QueryServer(session, graph=graph) as server:
        with slow_operator("Scan", 0.5):
            h = server.submit(QUERIES[0][0], {"min": 20})
            h.wait(timeout=0.1)  # let it reach the slow operator
            h.cancel()
            with pytest.raises(Cancelled) as ex:
                h.result(timeout=10)
    assert ex.value.phase == "execute"


def test_aborted_cached_execution_leaves_no_pinned_results():
    from caps_tpu_torch.serve import cancel_scope
    session = _session()
    graph = _graph(session)
    q = QUERIES[0][0]
    graph.cypher(q, {"min": 20})  # warm: park a cached plan
    key = session._plan_cache_key(graph, q, {"min": 20})
    plan = session.plan_cache.lookup(key, {"min": 20})
    assert plan is not None
    with slow_operator("Filter", 0.05):
        with cancel_scope(CancelScope(budget_s=0.01)):
            with pytest.raises(DeadlineExceeded):
                graph.cypher(q, {"min": 20})
    # the abort unwound mid-tree, but the parked plan must retain no
    # operator result memos (they pin device tables between runs)
    stack, seen = [plan.root], set()
    while stack:
        op = stack.pop()
        if id(op) in seen:
            continue
        seen.add(id(op))
        assert op._result is None
        stack.extend(op.children)
    # and the plan still executes correctly afterwards
    assert [r["n"] for r in graph.cypher(q, {"min": 30}).records.to_maps()
            ] == ["Alice", "Bob", "Dana"]


def test_slow_operator_validates_and_restores():
    from caps_tpu_torch.relational import ops as R
    orig = R.FilterOp._compute
    with pytest.raises(ValueError):
        with slow_operator("NoSuchOp", 0.1):
            pass
    with slow_operator("FilterOp", 0.0):
        assert R.FilterOp._compute is not orig
    assert R.FilterOp._compute is orig


# -- the acceptance stress run ---------------------------------------------

def _stress(n_threads: int, per_thread: int, workers: int = 4) -> None:
    session = _session()
    graph = _graph(session)
    expected = _expected(graph)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=workers,
                                             max_queue=4096, max_batch=8))
    results: dict = {}
    failures: list = []

    def client(tid: int):
        try:
            flat = [(q, i, b) for q, bindings in QUERIES
                    for i, b in enumerate(bindings)]
            for j in range(per_thread):
                q, i, b = flat[(tid + j) % len(flat)]
                h = server.submit(q, b)
                results[(tid, j)] = ((q, i), h)
        except Exception as ex:  # pragma: no cover — the test must fail
            failures.append(ex)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    # start mid-burst: some requests are served while others still queue
    server.start()
    for t in threads:
        t.join()
    server.shutdown()  # graceful drain
    assert not failures, failures
    assert len(results) == n_threads * per_thread
    for (q_i), handle in results.values():
        assert _bag(handle.rows(timeout=60)) == expected[q_i], q_i
    snap = session.metrics_snapshot()
    assert snap["serve.completed"] == n_threads * per_thread
    assert snap["serve.failed"] == 0 and snap["serve.shed"] == 0
    # the micro-batcher demonstrably coalesced
    assert snap["serve.batch_size.max"] > 1
    # served plans really came from the shared cache
    assert snap["plan_cache.hits"] > 0


def test_stress_eight_threads_two_hundred_queries():
    # >= 8 client threads, >= 200 mixed prepared queries, zero errors,
    # results == sequential == the JAX package's server, batch max > 1.
    _stress(n_threads=8, per_thread=25)


@pytest.fixture()
def fast_switching():
    """Shrink the bytecode switch interval so read-modify-write races
    manifest reliably within a short test."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


def _hammer(fn, n_threads=2, iters=20_000):
    threads = [threading.Thread(target=lambda: [fn() for _ in range(iters)])
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return n_threads * iters


def test_counter_concurrent_increments_exact(fast_switching):
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    c = reg.counter("t.c")
    total = _hammer(c.inc)
    assert c.value == total  # an unlocked counter loses updates (naked +=)


def test_histogram_concurrent_observes_exact(fast_switching):
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    h = reg.histogram("t.h")
    total = _hammer(lambda: h.observe(0.5), iters=10_000)
    snap = h.snapshot()
    assert snap["count"] == total and snap["sum"] == pytest.approx(
        0.5 * total)


def test_registry_get_or_create_race(fast_switching):
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    seen = []

    def one(i):
        def run():
            for j in range(2_000):
                reg.counter(f"t.{j % 97}").inc()
            seen.append(i)
        return run

    threads = [threading.Thread(target=one(i)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == 4
    # every name resolved to ONE instrument; totals are exact
    total = sum(reg.counter(f"t.{k}").value for k in range(97))
    assert total == 4 * 2_000


def test_plan_cache_concurrent_store_lookup_invariant(fast_switching):
    from caps_tpu_torch.relational.plan_cache import CachedPlan, PlanCache

    class _Op:
        children = ()
        _result = None

    def entry():
        return CachedPlan(root=_Op(), result_fields=("x",), plans={},
                          records_graph=None, context=None, spec_key=(),
                          cold_phase_s=0.0, nbytes=64)

    # Without the cache lock this fails in two ways: a KeyError out
    # of store()'s move_to_end racing another thread's LRU popitem, and
    # a _count that drifts from the real entry total (store's
    # append/count/evict sequence interleaves).
    cache = PlanCache(max_size=50)
    errors = []

    def writer(base):
        try:
            for j in range(2_000):
                key = (f"q{base}-{j % 120}", 1, 0, ())
                cache.store(key, entry())
                cache.lookup(key, {})
        except Exception as ex:  # pragma: no cover
            errors.append(ex)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # the LRU bookkeeping stayed consistent under concurrent mutation
    assert cache.size == sum(len(v) for v in cache._entries.values())
    assert cache.size <= cache.max_size


def test_catalog_mutation_concurrent_with_subscription_eviction(
        fast_switching):
    session = _session()
    graph = _graph(session)
    q = QUERIES[0][0]
    errors = []
    stop = threading.Event()

    def mutator():
        try:
            for i in range(200):
                session.catalog.store(f"session.g{i % 5}", graph)
                session.catalog.delete(f"session.g{i % 5}")
        except Exception as ex:  # pragma: no cover
            errors.append(ex)
        finally:
            stop.set()

    def querier():
        try:
            # at least one query even if the mutator wins every
            # timeslice (single-core schedulers can finish all 200
            # mutations before this thread first runs)
            ran_once = False
            while not ran_once or not stop.is_set():
                ran_once = True
                graph.cypher(q, {"min": 20}).records.to_maps()
        except Exception as ex:  # pragma: no cover
            errors.append(ex)

    threads = [threading.Thread(target=mutator),
               threading.Thread(target=querier)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # Scoped eviction: the querier's plan has NO catalog dependencies
    # (it runs on the graph object, not FROM GRAPH), so 400 interleaved
    # catalog mutations must not have evicted it — and any entry that
    # DOES carry catalog deps validates against the live catalog
    # (stale-dep entries are dropped at lookup, never served).
    cache = session.plan_cache
    with cache._lock:
        plans = [p for ps in cache._entries.values() for p in ps]
    assert plans, "the hot query's plan should still be cached"
    for p in plans:
        for qgn, tok in p.catalog_deps:
            assert session.catalog.dep_token(qgn) == tok
    # and the cached plan still serves correct results afterwards
    res = graph.cypher(q, {"min": 20})
    assert res.metrics["plan_cache"] == "hit"
    assert [r["n"] for r in res.records.to_maps()
            ] == ["Alice", "Bob", "Carol", "Dana"]


# -- the port's own cases ----------------------------------------------------

TRIANGLES = """
    CREATE (a:Person {name: 'a', age: 1}), (b:Person {name: 'b', age: 2}),
           (c:Person {name: 'c', age: 3}), (d:Person {name: 'd', age: 4}),
           (a)-[:KNOWS]->(b), (b)-[:KNOWS]->(c), (c)-[:KNOWS]->(a),
           (b)-[:KNOWS]->(d), (d)-[:KNOWS]->(c), (a)-[:KNOWS]->(d)
"""
Q_TRIANGLE = ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)"
              "-[:KNOWS]->(a) WHERE a.age >= $min "
              "RETURN a.name AS a, b.name AS b, c.name AS c")


def test_wcoj_fault_under_the_server_is_retried_and_answered():
    """The port's multiway join does not answer a fault from its cascade
    (it propagates — ROADMAP "Differences"); under the server the retry
    ladder contains it and the request still gets the right rows, equal
    to the JAX package's."""
    from caps_tpu_torch.serve import RetryPolicy
    from caps_tpu_torch.testing.faults import failing_wcoj
    session = _session()
    graph = create_graph(session, TRIANGLES)
    assert "MultiwayJoin" in graph.cypher(
        "EXPLAIN " + Q_TRIANGLE, {"min": 0}).plans["relational"]
    import caps_tpu
    from caps_tpu.testing.factory import create_graph as jax_create
    ref = caps_tpu.local_session(backend="tpu")
    want = _bag(jax_create(ref, TRIANGLES).cypher(
        Q_TRIANGLE, {"min": 0}).records.to_maps())
    assert len(want) == 6
    with QueryServer(session, graph=graph, config=ServerConfig(
            workers=1, retry=RetryPolicy(backoff_base_s=0.0,
                                         jitter=0.0))) as server:
        with failing_wcoj(n_times=1) as budget:
            h = server.submit(Q_TRIANGLE, {"min": 0})
            rows = h.rows(timeout=60)
    assert budget.injected == 1
    assert _bag(rows) == want
    attempts = h.info["attempts"]
    assert attempts[0]["classified"] == "transient"
    assert attempts[0]["error"] == "OutOfMemoryError"
    assert attempts[-1]["ok"] is True
    assert session.metrics_snapshot()["serve.retries"] >= 1


def test_cpu_replica_activation_changes_no_device():
    """A replica of a CPU session is a CPU session with no stream, and
    its execution bracket stamps the replica index and enters nothing
    else (the current card and stream stay as they were)."""
    import torch
    from caps_tpu_torch.serve.devices import (ReplicaSet,
                                              executing_device_index)
    session = _session()
    replicas = ReplicaSet(session, graph=_graph(session), n_devices=2,
                          registry=session.metrics_registry)
    for r in replicas.replicas:
        assert r.device == torch.device("cpu") and r.stream is None
        assert r.session.device == torch.device("cpu")
    seen = []
    r1 = replicas.replicas[1]
    assert executing_device_index() is None
    with r1.activate():
        seen.append(executing_device_index())
        if torch.cuda.is_available():  # pragma: no cover — a card
            seen.append(torch.cuda.current_stream()
                        == torch.cuda.default_stream())
    assert seen[0] == 1 and all(seen[1:])
    assert executing_device_index() is None
    assert r1.session is not session and r1.session.device.type == "cpu"


def test_cypher_batch_of_exact_replays_reads_no_size():
    """A micro-batch of exact replays: one fused batch of 8 members,
    each replaying with no size read, with rows equal to the JAX
    package's; ``fused.batches`` / ``fused.batch_members`` count it."""
    session = _session()
    graph = _graph(session)
    q, binding = QUERIES[1][0], QUERIES[1][1][0]
    graph.cypher(q, binding)  # record
    snap0 = session.metrics_snapshot()
    out = session.cypher_batch(graph, [(q, dict(binding))] * 8)
    snap1 = session.metrics_snapshot()
    assert [r.metrics["size_syncs"] for r in out] == [0] * 8
    assert snap1["fused.batches"] - snap0["fused.batches"] == 1
    assert snap1["fused.batch_members"] - snap0["fused.batch_members"] == 8
    assert snap1["fused.replays"] - snap0["fused.replays"] == 8
    want = _jax_served()[(q, 0)]
    assert all(_bag(r.to_maps()) == want for r in out)


def test_a_deadline_in_a_replay_keeps_the_recording():
    """An expired budget stops a fused replay at an operator boundary;
    the recording stays (no mismatch, no re-record run after the budget
    is spent) and the next run replays it."""
    session = _session()
    graph = _graph(session)
    q, b = QUERIES[0][0], {"min": 20}
    graph.cypher(q, b)  # record
    fused = session.fused
    before = (fused.recordings, fused.mismatches)
    with slow_operator("Filter", 0.05):
        with cancel_scope_for(0.01):
            with pytest.raises(DeadlineExceeded) as ex:
                graph.cypher(q, b)
    assert ex.value.phase == "execute"
    assert (fused.recordings, fused.mismatches) == before
    res = graph.cypher(q, b)
    assert fused.last_mode == "replay" and res.metrics["size_syncs"] == 0
    assert [r["n"] for r in res.to_maps()] == ["Alice", "Bob", "Carol",
                                              "Dana"]


def cancel_scope_for(budget_s):
    from caps_tpu_torch.serve import cancel_scope
    return cancel_scope(CancelScope(budget_s=budget_s))
