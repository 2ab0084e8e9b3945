"""Observability example — EXPLAIN, PROFILE, and trace export.

``EXPLAIN <query>`` plans without executing (the rendered IR / logical /
relational trees); ``PROFILE <query>`` executes and annotates every
relational operator with its measured span — rows, wall time, bytes
pulled through memory, and device time.  Both are plain query prefixes,
so they work through every API that takes query text, on every backend.
``session.metrics_snapshot()`` exposes the session's counters (plan
cache, device backend, fused executor) as one flat dict, and
``session.export_trace(path)`` writes the collected spans as a
``chrome://tracing``-loadable file.

The port's counterpart of ``examples/profile_query.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_profile_query.py
"""
import json
import os
import tempfile

import caps_tpu_torch
from caps_tpu_torch.testing.factory import create_graph


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))
    graph = create_graph(session, """
        CREATE (ana:Person {name: 'Ana', age: 34}),
               (bo:Person {name: 'Bo', age: 51}),
               (cleo:Person {name: 'Cleo', age: 27}),
               (ana)-[:KNOWS]->(bo), (bo)-[:KNOWS]->(cleo),
               (ana)-[:KNOWS]->(cleo)
    """)
    query = ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
             "WHERE a.age > $min_age "
             "RETURN a.name AS person, b.name AS knows "
             "ORDER BY person, knows")

    # EXPLAIN: the plan, nothing executed (records is None)
    explained = graph.cypher("EXPLAIN " + query, {"min_age": 30})
    print("=== EXPLAIN ===")
    print(explained.plans["relational"])

    # PROFILE: execute + per-operator measurements
    profiled = graph.cypher("PROFILE " + query, {"min_age": 30})
    rows = profiled.records.to_maps()
    print("\n=== PROFILE ===")
    print(profiled.plans["profile"])

    # the spans PROFILE collected export to chrome://tracing
    trace_path = os.path.join(tempfile.mkdtemp(), "caps_tpu_trace.json")
    session.export_trace(trace_path)
    n_events = len(json.load(open(trace_path))["traceEvents"])
    print(f"\nwrote {n_events} trace events to {trace_path} "
          "(open in chrome://tracing)")

    snapshot = session.metrics_snapshot()
    print(f"plan_cache.hits={snapshot['plan_cache.hits']} "
          f"plan_cache.misses={snapshot['plan_cache.misses']}")
    return rows, explained, profiled, n_events


if __name__ == "__main__":
    main()
