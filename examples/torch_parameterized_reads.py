"""Parameterized-workload example — steady-state latency on a remote
device (ref: the reference's Spark/Tungsten whole-stage-codegen plan
reuse across parameter values; SURVEY.md §3.1).

An interactive service runs the SAME query text with rotating
parameters (the LDBC short-read shape).  Two session caches amortize
that shape end to end:

* the **plan cache** (``session.prepare``): parse → IR → logical →
  relational planning runs once; every later ``.run(params)`` re-binds
  parameter values into the cached operator tree (keys are
  value-independent — names + coarse types);
* the **fused executor** (CUDA backend): device→host size syncs converge
  to ~1 per query regardless of parameter value, while keeping results
  exact (device-checked served sizes; a parameter whose sizes exceed
  every recorded bound transparently re-records).

The port's counterpart of ``examples/parameterized_reads.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_parameterized_reads.py
"""
import caps_tpu_torch
from caps_tpu_torch.testing.factory import create_graph


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))
    graph = create_graph(session, """
        CREATE (ana:Person {name: 'Ana', age: 34}),
               (bo:Person {name: 'Bo', age: 51}),
               (cleo:Person {name: 'Cleo', age: 27}),
               (dev:Person {name: 'Dev', age: 45}),
               (ana)-[:KNOWS]->(bo), (bo)-[:KNOWS]->(cleo),
               (cleo)-[:KNOWS]->(dev), (dev)-[:KNOWS]->(ana),
               (ana)-[:KNOWS]->(cleo)
    """)
    prepared = graph.prepare(
        "MATCH (a:Person)-[:KNOWS]->(b:Person) "
        "WHERE a.age > $min_age "
        "RETURN a.name AS person, b.name AS knows ORDER BY person, knows")
    out = []
    for min_age in (30, 40, 25, 50, 30):
        result = prepared.run({"min_age": min_age})
        rows = result.records.to_maps()
        metrics = result.metrics or {}
        syncs = metrics.get("size_syncs")
        out.append((min_age, len(rows), syncs))
        print(f"min_age={min_age}: {len(rows)} rows, "
              f"plan_cache={metrics.get('plan_cache')}"
              + (f", {syncs} host syncs" if syncs is not None else ""))
    stats = session.plan_cache.stats()
    print(f"plan cache: {stats['hits']} hits / {stats['misses']} misses, "
          f"{stats['saved_s'] * 1e3:.2f} ms of planning skipped")
    return out


if __name__ == "__main__":
    main()
